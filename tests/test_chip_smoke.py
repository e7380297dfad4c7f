"""chip_smoke.py: refuses to run without a GPU, and its phases rehearsed at
tiny widths on the CPU (the card runs them at the KITTI widths)."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke
from test_pipeline import small_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_script(cwd):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_refuses_cpu():
    out = _run_script(REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "needs a GPU" in out.stderr


def test_refuses_outside_checkout(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run_script(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_bench_refuses_cpu():
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "bench.py"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"metric"' not in out.stdout
    assert "measures the GPU" in out.stderr


def test_phase_precision():
    r = chip_smoke.phase_precision(n=64)
    assert r["matmul_precision"] == "float32"
    assert r["rel_err"] < chip_smoke.MATMUL_REL_MAX


def test_phase_cli(tmp_path):
    """The KITTI profile with its device section cut to test size."""
    text = open(os.path.join(REPO, "configs", "kitti_tpu.yaml")).read()
    text = text[:text.index("tpu:")] + (
        "tpu:\n  max_points_per_scan: 4096\n  map_capacity: 65536\n"
        "  map_points_per_voxel: 2\n  imu_batch: 32\n")
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(text)
    r = chip_smoke.phase_cli(scans=4, config=str(cfg))
    assert r["scans"] == 4
    assert np.isfinite(r["ate_m"])


def test_phase_odometry():
    r = chip_smoke.phase_odometry(small_cfg(), n_scans=6, points=4096)
    assert r["scans"] == 6
    assert r["ate_m"] < chip_smoke.ATE_MAX_M
    # the CPU backend is deterministic: two replays agree bit for bit
    assert r["replay_max_pos_diff_m"] == 0.0
    assert r["ms_per_scan_p95"] >= r["ms_per_scan_p50"] > 0
    assert isinstance(r["custom_calls_per_scan"], dict)
    json.dumps(r)


def test_phase_slam():
    import bench

    r = bench.soak_band(8, cfg=small_cfg(), points_per_scan=2048)
    assert r["scans"] == 8
    assert r["keyframes"] >= 1
    assert np.isfinite(r["kf_rmse"])


def test_phase_oracle():
    cfg = chip_smoke.oracle_cfg(small_cfg())
    r = chip_smoke.phase_oracle(cfg, n_scans=6, points=4096)
    assert r["pos_err_scan1_m"] < chip_smoke.ORACLE_SCAN1_MAX_M
    assert r["pos_err_max_m"] < chip_smoke.oracle_budget_m(cfg)
    assert r["pos_err_mean_m"] < chip_smoke.ORACLE_MEAN_MAX_M
    assert r["quat_err_max"] < chip_smoke.ORACLE_QUAT_MAX


@pytest.mark.gpu
def test_precision_on_gpu(gpu_device):
    """On the card, float32 matmuls must not run in TF32."""
    import jax

    with jax.default_device(gpu_device):
        r = chip_smoke.phase_precision()
    assert r["rel_err"] < chip_smoke.MATMUL_REL_MAX
