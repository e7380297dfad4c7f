#!/usr/bin/env python
"""Smoke run of the LIO/SLAM main path on the GPU, in one process.

    python chip_smoke.py            # every phase below, one card
    python chip_smoke.py --stages   # per-stage plain-XLA timings only

Phases (each fails loudly: an exception or a broken bound exits non-zero):

* device     — refuse anything but a GPU; print its kind, the JAX version
               and the card's name and power limit (nvidia-smi, read by a
               child process that does not import JAX).
* precision  — the matmul precision in force, and a 512×512 float32
               product against NumPy float64 (TF32 would miss 1e-5).
* cli        — `cli.main` on the KITTI profile, 20 synthetic scans.
* odometry   — `SLAM` (the README quick start) at the KITTI HDL-64 shapes
               of `bench.kitti_like_cfg()`: 64 scans of 32,768 points,
               replayed twice; compile time, p50/p95 ms per scan, peak
               device memory, the replay difference and the solver custom
               calls of the scan step are printed as information.
* slam       — the soak circuit of `bench.soak_band` for 96 scans
               (ScanContext, ICP, pose-graph solve, map rebuild).
* oracle     — 12 scans at KITTI widths recorded through
               `Localizer.on_dispatch` and replayed through the float64
               pipeline oracle (tests/pipeline_oracle.py), held to the
               budgets of tests/test_e2e_oracle.py.

Details go to earlier lines and to ``chiprun_out/chip_smoke.json``; the
last line of standard output is the JSON result
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time
from collections import Counter

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out")

# bounds of the phases (tests/test_e2e_oracle.py, tests/test_soak.py)
ATE_MAX_M = 0.15
SOAK_KF_RMSE_MAX_M = 0.3
MATMUL_REL_MAX = 1e-5
ORACLE_SCAN1_MAX_M = 1e-4
ORACLE_MEAN_MAX_M = 8e-3
ORACLE_QUAT_MAX = 2e-3


def _log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    """``name, power.limit`` of the cards, from a child without JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def phase_precision(n: int = 512, seed: int = 0) -> dict:
    """float32 matmul vs NumPy float64: relative Frobenius error."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)).astype(np.float32)
    b = rng.standard_normal((n, n)).astype(np.float32)
    got = np.asarray(jax.jit(jnp.matmul)(jnp.asarray(a), jnp.asarray(b)),
                     np.float64)
    want = a.astype(np.float64) @ b.astype(np.float64)
    rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    return {"matmul_precision": str(jax.config.jax_default_matmul_precision),
            "n": n, "rel_err": rel}


def phase_cli(scans: int = 20,
              config: str = os.path.join(REPO, "configs", "kitti_tpu.yaml")
              ) -> dict:
    """The CLI entry point in-process; returns its JSON result line."""
    from fast_limo_tpu import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--config", config, "synthetic", "--scans", str(scans)])
    text = buf.getvalue()
    if rc:
        raise RuntimeError(f"cli exited {rc}:\n{text}")
    for line in text.splitlines():
        if line.startswith("device:"):
            _log(f"cli {line}")
    return json.loads([ln for ln in text.splitlines()
                       if ln.startswith("{")][-1])


def _stream(feed, seq, n_scans: int) -> None:
    """Feed a synthetic sequence in arrival order (IMU ticks, then every
    scan the IMU has covered)."""
    stamps, acc, gyro = seq.imu_stream()
    scans = [seq.scan(i) for i in range(n_scans)]
    si = 0
    for k in range(len(stamps)):
        feed.update_imu(stamps[k], acc[k], gyro[k])
        while si < n_scans and scans[si][0] <= stamps[k]:
            st_, pts, traw = scans[si]
            feed.update_pointcloud(pts, traw, st_)
            si += 1
    feed.flush()


def custom_calls(jitted, *args) -> dict:
    """Custom-call targets (eigh, LU, … that leave the fused XLA graph) in
    the compiled program, with how often each appears in it."""
    text = jitted.lower(*args).compile().as_text()
    return dict(Counter(re.findall(r'custom_call_target="([^"]+)"', text)))


def phase_odometry(cfg, n_scans: int = 64, points: int = 32768,
                   seed: int = 7) -> dict:
    """SLAM on the straight bench corridor, replayed twice."""
    import jax
    import jax.numpy as jnp

    from fast_limo_tpu.io import synthetic
    from fast_limo_tpu.models.slam import SLAM

    seq = synthetic.SyntheticSequence(
        seed=seed, n_scans=n_scans, points_per_scan=points,
        noise_pt=0.01, noise_gyro=5e-4, noise_acc=5e-3,
        traj=synthetic.Trajectory(v_forward=15.0, yaw_amp=0.5))
    runs = []
    packs = []
    for _ in range(2):
        slam = SLAM(cfg)
        slam.loc.sync_timing = True          # per-scan ms on the host clock
        if not packs:
            slam.loc.on_dispatch = lambda sp, ip: packs.append(
                (np.array(sp, copy=True), np.array(ip, copy=True)))
        t0 = time.perf_counter()
        _stream(slam, seq, n_scans)
        jax.block_until_ready(slam.loc.state)
        wall = time.perf_counter() - t0
        runs.append((slam, np.asarray(slam.positions()),
                     np.asarray(slam.loc.telemetry.scan_ms.buf), wall))
    slam, pos, ms, wall = runs[0]
    gt = seq.traj.pos(slam.stamps())
    warm = np.concatenate([r[2][1:] for r in runs])
    dev = jax.devices()[0]
    stats = dev.memory_stats() or {}
    sp, ip = packs[-1]
    return {
        "scans": int(len(pos)),
        "points_per_scan": points,
        "ate_m": float(synthetic.ate_rmse(pos, gt)),
        "compile_s": float((ms[0] - np.median(ms[1:])) / 1e3),
        "ms_per_scan_p50": float(np.percentile(warm, 50)),
        "ms_per_scan_p95": float(np.percentile(warm, 95)),
        "wall_s_first_replay": float(wall),
        "peak_bytes_in_use": int(stats.get("peak_bytes_in_use", -1)),
        "replay_max_pos_diff_m": float(np.max(np.abs(pos - runs[1][1]))),
        "custom_calls_per_scan": custom_calls(
            slam.loc.scan_step, slam.loc.state, jnp.asarray(sp),
            jnp.asarray(ip)),
        "keyframes": len(slam.keyframes),
    }


def oracle_cfg(cfg):
    """Reference-exact matching for the float64 replay (the
    tests/test_e2e_oracle.py settings): unquantized transfer, no dynamic
    gate (an additive divergence the oracle does not model)."""
    cfg.tpu.knn_refresh = "always"
    cfg.tpu.quantize_transfer = 0.0
    cfg.ikfom.mapping.DYNAMIC_GATE = 0.0
    return cfg


def phase_oracle(cfg, n_scans: int = 12, points: int = 32768,
                 seed: int = 3) -> dict:
    """Per-scan pose error of the device run against the float64 pipeline
    oracle replayed on the exact dispatched packs."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import pipeline_oracle as po

    from fast_limo_tpu.io import synthetic
    from fast_limo_tpu.models.localizer import Localizer

    class Recording(Localizer):
        def __init__(self, c):
            super().__init__(c)
            self.records = []
            self.init_snap = None
            self.on_dispatch = lambda sp, ip: self.records.append(
                (np.array(sp, copy=True), np.array(ip, copy=True)))

        def _init_device_state(self, first_stamp):
            super()._init_device_state(first_stamp)
            x = self.state.x
            self.init_snap = (
                {f: np.asarray(getattr(x, f), np.float64)
                 for f in ("pos", "rot", "rot_LI", "t_LI", "vel", "bg",
                           "ba", "grav")},
                np.asarray(self.state.P, np.float64),
                float(self.state.last_prop_time))

    seq = synthetic.SyntheticSequence(
        seed=seed, n_scans=n_scans, points_per_scan=points,
        noise_pt=0.01, noise_gyro=5e-4, noise_acc=5e-3)
    loc = Recording(cfg)
    _stream(loc, seq, n_scans)
    if len(loc.records) != n_scans:
        raise RuntimeError(f"on_dispatch recorded {len(loc.records)} of "
                           f"{n_scans} scans")
    t0 = time.perf_counter()
    orc = po.OracleLIO(cfg, *loc.init_snap)
    oout = [orc.scan_step(sp, ip) for sp, ip in loc.records]
    traj = loc.trajectory
    pos_err = np.array([np.linalg.norm(t["pos"] - o["pos"])
                        for t, o in zip(traj, oout)])
    quat_err = np.array([min(np.abs(t["quat"] - o["quat"]).max(),
                             np.abs(t["quat"] + o["quat"]).max())
                         for t, o in zip(traj, oout)])
    return {"scans": n_scans, "points_per_scan": points,
            "estimate_extrinsics": bool(cfg.ikfom.estimate_extrinsics),
            "pos_err_scan1_m": float(pos_err[1]),
            "pos_err_max_m": float(pos_err.max()),
            "pos_err_mean_m": float(pos_err.mean()),
            "quat_err_max": float(quat_err.max()),
            "oracle_s": time.perf_counter() - t0}


def oracle_budget_m(cfg) -> float:
    """Max per-scan position budget (tests/test_e2e_oracle.py)."""
    return 3e-2 if cfg.ikfom.estimate_extrinsics else 2e-2


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def run_stages(cfg, n_warm_scans: int = 16, reps: int = 50) -> dict:
    """Median host-clock ms (ending in block_until_ready, after warm-up) of
    each stage that once had a hand-written kernel, as a standalone jitted
    function at the configuration's widths, on a map built by
    ``n_warm_scans`` scans of the bench corridor."""
    import jax
    import jax.numpy as jnp

    from fast_limo_tpu.io import synthetic
    from fast_limo_tpu.models import deskew as dsk
    from fast_limo_tpu.models import iekf, mapper, measurement
    from fast_limo_tpu.models.localizer import Localizer
    from fast_limo_tpu.ops import gain, plane, so3, voxel
    from fast_limo_tpu.ops import sort as psort

    seq = synthetic.SyntheticSequence(
        seed=7, n_scans=n_warm_scans,
        points_per_scan=cfg.tpu.max_points_per_scan, noise_pt=0.01,
        noise_gyro=5e-4, noise_acc=5e-3,
        traj=synthetic.Trajectory(v_forward=15.0, yaw_amp=0.5))
    loc = Localizer(cfg)
    _stream(loc, seq, n_warm_scans)
    jax.block_until_ready(loc.state)
    s, out = loc.state, loc.last_output
    mp_cfg = cfg.ikfom.mapping
    k, Q = mp_cfg.NUM_MATCH_POINTS, mp_cfg.MAX_NUM_PC2MATCH
    W = measurement.window_size(k)
    vs = cfg.map_voxel_size
    pc, pc_valid = out.scan_body[:Q], out.final_valid[:Q]
    x, P, m = s.x, s.P, s.map

    def update(m, pc, pc_valid, x, P):
        _h_rows, h_stats = measurement.make_h_model(
            m, pc, pc_valid, voxel_size=vs, k=k, probes=0,
            max_dist_plane=mp_cfg.MAX_DIST_PLANE,
            plane_threshold=mp_cfg.PLANE_THRESHOLD,
            max_num_matches=mp_cfg.MAX_NUM_MATCHES,
            estimate_extrinsics=cfg.ikfom.estimate_extrinsics, x0=x,
            dynamic_gate=mp_cfg.DYNAMIC_GATE)
        return iekf.update_iterated(
            x, P, h_stats, R=cfg.ikfom.lidar_noise,
            D=cfg.ikfom.degeneracy_thresh, max_iters=cfg.ikfom.MAX_NUM_ITERS,
            limit=cfg.ikfom.LIMITS)

    glob = so3.quat_rotate(x.rot, pc) + x.pos
    rows = mapper.gather_rows(m, glob, voxel_size=vs)

    def decode_topk(rows, ncb, glob):
        c, cv = mapper.cands_from_rows(rows, ncb, None, m.bucket)
        return mapper.topk_from_candidates(c, cv, glob, k=W)

    nbrs_w, sq_w, vld_w = decode_topk(rows[0], rows[1], glob)
    win = measurement.freeze_window(glob, nbrs_w, sq_w, vld_w, vs)
    sel, sel_sq = measurement.window_rank(win, glob, k)
    n_abcd, good = plane.fit_planes(
        sel, sel_sq, jnp.isfinite(sel_sq), num_match_points=k,
        max_dist_plane=mp_cfg.MAX_DIST_PLANE,
        plane_threshold=mp_cfg.PLANE_THRESHOLD)
    HTH, HTh = measurement.h_statistics(pc, n_abcd, good, x, True)

    rng = np.random.default_rng(0)
    N, K = cfg.tpu.max_points_per_scan, cfg.tpu.imu_batch + 1
    q = rng.standard_normal((K, 4)).astype(np.float32)
    frames = dsk.Frames(
        time=jnp.asarray(np.sort(rng.uniform(0, 0.1, K)), jnp.float32),
        pos=jnp.asarray(rng.uniform(-5, 5, (K, 3)), jnp.float32),
        rot=jnp.asarray(q / np.linalg.norm(q, axis=1, keepdims=True)),
        vel=jnp.asarray(rng.uniform(-2, 2, (K, 3)), jnp.float32),
        bg=jnp.zeros((K, 3), jnp.float32), ba=jnp.zeros((K, 3), jnp.float32),
        grav=jnp.broadcast_to(jnp.asarray([0, 0, -9.81], jnp.float32), (K, 3)),
        w=jnp.asarray(rng.normal(0, 0.3, (K, 3)), jnp.float32),
        a=jnp.asarray(rng.normal(0, 1, (K, 3)), jnp.float32),
        valid=jnp.ones(K, bool))
    raw = jnp.asarray(rng.uniform(-40, 40, (N, 3)), jnp.float32)
    t_pts = jnp.asarray(rng.uniform(0, 0.1, N), jnp.float32)
    keyN = jnp.asarray(rng.integers(0, 1 << 30, N), jnp.int32)
    ins = jnp.asarray(rng.uniform(-40, 40, (cfg.tpu.max_insert_points or N, 3)),
                      jnp.float32)
    keyI = jnp.asarray(rng.integers(0, 8192, ins.shape[0]), jnp.int32)

    stages = {
        "iterated_update": (update, (m, pc, pc_valid, x, P)),
        "knn_gather_rows": (lambda m, g: mapper.gather_rows(m, g, voxel_size=vs),
                            (m, glob)),
        "knn_decode_topk": (decode_topk, (rows[0], rows[1], glob)),
        "window_select_topk": (lambda w, g: measurement.window_rank(w, g, k),
                               (win, glob)),
        "plane_fit": (lambda a, b: plane.fit_planes(
            a, b, jnp.isfinite(b), num_match_points=k,
            max_dist_plane=mp_cfg.MAX_DIST_PLANE,
            plane_threshold=mp_cfg.PLANE_THRESHOLD), (sel, sel_sq)),
        "h_statistics": (lambda a, b, c, d: measurement.h_statistics(
            a, b, c, d, True), (pc, n_abcd, good, x)),
        "gain": (lambda a, b, c: gain.gain_reference(
            a, b, c, cfg.ikfom.lidar_noise), (HTH, HTh, P)),
        "deskew": (dsk.deskew, (raw, t_pts, jnp.ones(N, bool), frames, x,
                                x.rot_LI, x.t_LI)),
        "voxel_downsample_sort": (psort.sort_key_val,
                                  (keyN, jnp.arange(N, dtype=jnp.int32))),
        "voxel_downsample": (lambda p, v: voxel.voxel_downsample(
            p, v, float(cfg.filters.leafSize[0])), (raw, jnp.ones(N, bool))),
        "insert_sort": (psort.sort3, (keyI, keyI, jnp.arange(
            ins.shape[0], dtype=jnp.int32))),
        "map_insert": (lambda mm, p: mapper.insert(
            mm, p, jnp.ones(p.shape[0], bool), voxel_size=vs), (m, ins)),
    }
    res = {}
    for name, (fn, args) in stages.items():
        f = jax.jit(fn)
        jax.block_until_ready(f(*args))                  # compile
        for _ in range(3):
            jax.block_until_ready(f(*args))
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(f(*args))
            ts.append(time.perf_counter() - t0)
        res[name] = {"ms_median": float(np.median(ts) * 1e3),
                     "ms_min": float(np.min(ts) * 1e3),
                     **device_kernels(f, args)}
        _log(f"stage {name}: median {res[name]['ms_median']:.4f} ms "
             f"(min {res[name]['ms_min']:.4f} ms, {reps} calls); "
             f"{res[name]['kernels']} device ops, "
             f"{res[name]['device_ms']:.4f} ms device time per call")
    res["iterated_update"]["custom_calls"] = custom_calls(
        jax.jit(update), m, pc, pc_valid, x, P)
    res["widths"] = {"points": N, "pc2match": int(Q), "k": k, "window": W,
                     "imu_frames": K, "insert": int(ins.shape[0]),
                     "map_groups": int(m.groups)}
    return res


def device_kernels(f, args) -> dict:
    """Device operations (kernels, copies, memsets) one call runs on the
    GPU and their summed device time, from a profiler trace of that call."""
    import glob
    import shutil
    import tempfile

    import jax

    d = tempfile.mkdtemp()
    try:
        jax.profiler.start_trace(d)
        jax.block_until_ready(f(*args))
        jax.profiler.stop_trace()
        path = glob.glob(os.path.join(d, "**", "*.xplane.pb"),
                         recursive=True)[0]
        n, ns = 0, 0
        for plane in jax.profiler.ProfileData.from_file(path).planes:
            if not plane.name.startswith("/device:GPU"):
                continue
            for line in plane.lines:
                if line.name.startswith("Stream"):
                    for ev in line.events:
                        n += 1
                        ns += ev.duration_ns
        return {"kernels": n, "device_ms": ns / 1e6}
    finally:
        shutil.rmtree(d, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stages", action="store_true",
                    help="time the standalone stages instead of the phases")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {devs[0].platform}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import bench  # noqa: F401  (fails outside a checkout of the repo)
    from fast_limo_tpu import CACHE_DIR

    t_all = time.perf_counter()
    report = {"device_kind": devs[0].device_kind, "jax": jax.__version__,
              "nvidia_smi": nvidia_smi(), "compile_cache": CACHE_DIR
              or os.environ.get("JAX_COMPILATION_CACHE_DIR")}
    _log(f"device: {devs[0].platform} {devs[0].device_kind} "
         f"x{len(devs)}; jax {jax.__version__}")
    _log(f"nvidia-smi: {report['nvidia_smi']}")

    if args.stages:
        report["stages"] = run_stages(bench.kitti_like_cfg())
    else:
        report["precision"] = r = phase_precision()
        _log(f"precision: {r}")
        _require(r["rel_err"] < MATMUL_REL_MAX,
                 f"float32 matmul rel err {r['rel_err']:.2e} (TF32 on?)")

        report["cli"] = r = phase_cli()
        _log(f"cli: {r}")
        _require(r["ate_m"] < ATE_MAX_M, f"cli ATE {r['ate_m']} m")

        report["odometry"] = r = phase_odometry(bench.kitti_like_cfg())
        _log(f"odometry: {json.dumps(r)}")
        _require(r["ate_m"] < ATE_MAX_M, f"odometry ATE {r['ate_m']} m")

        report["slam"] = r = bench.soak_band(96)
        _log(f"slam: {r}")
        _require(r["loops"] >= 1, "soak closed no loop")
        _require(r["kf_rmse"] < SOAK_KF_RMSE_MAX_M,
                 f"soak keyframe RMSE {r['kf_rmse']} m")

        cfg = oracle_cfg(bench.kitti_like_cfg())
        report["oracle"] = r = phase_oracle(cfg)
        _log(f"oracle: {r}")
        _require(r["pos_err_scan1_m"] < ORACLE_SCAN1_MAX_M,
                 f"scan-1 pos err {r['pos_err_scan1_m']:.2e} m")
        _require(r["pos_err_max_m"] < oracle_budget_m(cfg),
                 f"max pos err {r['pos_err_max_m']:.2e} m")
        _require(r["pos_err_mean_m"] < ORACLE_MEAN_MAX_M,
                 f"mean pos err {r['pos_err_mean_m']:.2e} m")
        _require(r["quat_err_max"] < ORACLE_QUAT_MAX,
                 f"quat err {r['quat_err_max']:.2e}")

    report["wall_s"] = time.perf_counter() - t_all
    _log(f"wall: {report['wall_s']:.1f} s")
    os.makedirs(OUT_DIR, exist_ok=True)
    name = "chip_stages.json" if args.stages else "chip_smoke.json"
    with open(os.path.join(OUT_DIR, name), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
