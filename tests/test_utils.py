"""Telemetry, checkpoint/resume, config loading."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from fast_limo_tpu.models import pipeline as pl
from fast_limo_tpu.utils import checkpoint as ckpt
from fast_limo_tpu.utils.config import Config
from fast_limo_tpu.utils import yamlsubset
from fast_limo_tpu.utils.telemetry import Telemetry

import __graft_entry__ as ge

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "configs")
PROFILES = ("kitti", "cat", "ona", "utbm")


class TestConfig:
    def test_defaults_match_reference_loader(self):
        # defaults from src/main.cpp:101-168
        cfg = Config()
        assert cfg.ikfom.MAX_NUM_ITERS == 3
        assert cfg.ikfom.mapping.NUM_MATCH_POINTS == 5
        assert cfg.ikfom.mapping.octree.bucket_size == 2
        assert cfg.ikfom.LIMITS == 1e-3
        assert cfg.sensor_type == 1

    def test_loads_reference_kitti_yaml(self):
        cfg = Config.from_yaml(os.path.join(CONFIGS, "kitti_tpu.yaml"))
        assert cfg.sensor_type == 1
        assert cfg.filters.voxel_active
        assert cfg.filters.leafSize[0] == 1.0
        assert cfg.ikfom.mapping.MAX_NUM_MATCHES == 5000
        assert cfg.ikfom.mapping.MAX_NUM_PC2MATCH == 10000
        assert cfg.ikfom.cov_gyro == pytest.approx(6.01e-4)
        assert cfg.ikfom.mapping.octree.min_extent == pytest.approx(0.2)
        assert not cfg.gravity_align
        assert cfg.time_offset
        # half-FoV conversion (main.cpp:143-146)
        assert cfg.filters.fov_angle == pytest.approx(180 * np.pi / 360.0)
        # lidar extrinsics parsed (a flow list spanning three lines)
        assert cfg.extrinsics.lidar2baselink_t[0] == pytest.approx(8.086759e-01)
        assert cfg.extrinsics.lidar2baselink_R[8] == pytest.approx(9.998881e-01)
        # the device section
        assert cfg.tpu.map_capacity == 131072
        assert cfg.tpu.knn_refresh == "first"

    def test_all_reference_yamls_parse(self):
        for name in PROFILES:
            cfg = Config.from_yaml(os.path.join(CONFIGS, f"{name}_tpu.yaml"))
            assert 0 <= cfg.sensor_type <= 4
            assert cfg.tpu.max_points_per_scan > 0

    @pytest.mark.parametrize("name", PROFILES)
    def test_yaml_reader_matches_pyyaml(self, name):
        """The in-repo YAML-subset reader parses every profile exactly as
        PyYAML's safe_load does."""
        yaml = pytest.importorskip("yaml")
        with open(os.path.join(CONFIGS, f"{name}_tpu.yaml")) as f:
            text = f.read()
        assert yamlsubset.load(text) == yaml.safe_load(text)

    def test_yaml_reader_subset_features(self):
        text = (
            "# comment\n"
            "a: 1          # trailing comment\n"
            "b: 'x # y'\n"
            "c:\n"
            "  - 1.e+4\n"
            "  - {k: [1, 2], m: null}\n"
            "  -\n"
            "d: [ 1.5,\n"
            "     -2 ]\n"
            "e:\n"
            "- f: yes\n"
            "  g: 5.0e-2\n"
            "h: 1e-4\n")
        assert yamlsubset.load(text) == {
            "a": 1, "b": "x # y", "c": [1e4, {"k": [1, 2], "m": None}, None],
            "d": [1.5, -2], "e": [{"f": True, "g": 0.05}], "h": "1e-4"}
        with pytest.raises(ValueError):
            yamlsubset.load("a: [1, 2\n")
        with pytest.raises(ValueError):
            yamlsubset.load("a: &anchor 1\n")

    def test_derived_map_geometry(self):
        cfg = Config()
        cfg.ikfom.mapping.octree.min_extent = 0.3
        assert cfg.map_voxel_size == pytest.approx(0.6)
        cfg.tpu.map_voxel_size = 1.0
        assert cfg.map_voxel_size == 1.0


class TestCompileCache:
    """The package's persistent compilation cache: an explicit
    JAX_COMPILATION_CACHE_DIR is left to JAX; otherwise the cache lives at
    <repo>/build/jax_cache.  Each case runs a fresh CPU process, since the
    choice is made at import."""

    @staticmethod
    def _probe(env_cache):
        import subprocess
        import sys

        env = {k: v for k, v in os.environ.items()
               if k != "JAX_COMPILATION_CACHE_DIR"}
        env["JAX_PLATFORMS"] = "cpu"
        if env_cache is not None:
            env["JAX_COMPILATION_CACHE_DIR"] = env_cache
        code = ("import jax, fast_limo_tpu as f; "
                "print(f.CACHE_DIR); print(jax.config.jax_compilation_cache_dir)")
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=120,
                             check=True)
        return out.stdout.strip().splitlines()[-2:]

    def test_env_dir_wins(self, tmp_path):
        own, used = self._probe(str(tmp_path / "cc"))
        assert own == "None"
        assert used == str(tmp_path / "cc")

    def test_default_dir_in_checkout(self):
        own, used = self._probe(None)
        want = os.path.join(REPO, "build", "jax_cache")
        assert own == want
        assert used == want


class TestTelemetry:
    def test_rates_and_board(self):
        t = Telemetry()
        for i in range(10):
            t.imu_tick(i * 0.01)
        t.scan_begin()
        t.scan_end(0.1)
        t.scan_begin()
        t.scan_end(0.2)
        s = t.stats()
        assert s["imu_hz"] == pytest.approx(100.0, rel=1e-6)
        assert s["lidar_hz"] == pytest.approx(10.0, rel=1e-6)
        board = t.board({"pos": np.zeros(3), "map_points": 42})
        assert "Map points: 42" in board
        assert "scans/s" in board


class TestCheckpoint:
    def test_roundtrip_liostate(self, tmp_path):
        cfg = ge._tiny_cfg()
        state = pl.init_state(cfg)
        state = state._replace(prev_scan_stamp=jnp.asarray(3.25, jnp.float32))
        p = str(tmp_path / "ck.npz")
        ckpt.save_state(p, state, extra={"epoch": 123.0})
        state2 = ckpt.load_state(p, pl.init_state(cfg))
        assert float(state2.prev_scan_stamp) == pytest.approx(3.25)
        np.testing.assert_array_equal(np.asarray(state2.map.counts),
                                      np.asarray(state.map.counts))
        assert ckpt.load_extra(p)["epoch"] == 123.0

    def test_shape_mismatch_rejected(self, tmp_path):
        cfg = ge._tiny_cfg()
        p = str(tmp_path / "ck.npz")
        ckpt.save_state(p, pl.init_state(cfg))
        cfg2 = ge._tiny_cfg(map_cap=8192)
        with pytest.raises(ValueError):
            ckpt.load_state(p, pl.init_state(cfg2))

    def test_localizer_restore_rebuilds_planar_mirror(self, tmp_path):
        """load_checkpoint must (a) rebuild the kNN planar mirror from the
        entry-major table — a checkpoint whose stored ptable has a stale
        lane layout (e.g. pre-round-4 E/SUB ordering, same shapes) must
        resume with a CORRECT mirror — and (b) reject checkpoints whose
        layout stamp disagrees (ADVICE r4, medium)."""
        from fast_limo_tpu.models import mapper
        from fast_limo_tpu.models.localizer import Localizer

        cfg = ge._tiny_cfg()
        loc = Localizer(cfg)
        loc.state = pl.init_state(cfg)
        rngl = np.random.default_rng(1)
        pts = jnp.asarray(rngl.uniform(-5, 5, (200, 3)).astype(np.float32))
        loc.state = loc.state._replace(map=mapper.insert(
            loc.state.map, pts, jnp.ones(200, bool),
            voxel_size=cfg.map_voxel_size))
        loc.epoch = 5.0
        p = str(tmp_path / "ck.npz")
        loc.save_checkpoint(p)

        # simulate an old-layout mirror: scramble the stored ptable lanes
        # (shape-preserving, like the round-4 E/SUB reorder)
        import json
        d = dict(np.load(p, allow_pickle=False))
        key = [k for k in d if k.endswith("ptable")][0]
        d[key] = d[key][:, ::-1].copy()
        np.savez_compressed(p, **d)

        loc2 = Localizer(cfg)
        loc2.load_checkpoint(p)
        want = mapper._planarize(loc2.state.map.table, loc2.state.map.bucket)
        np.testing.assert_array_equal(np.asarray(loc2.state.map.ptable),
                                      np.asarray(want))

        # stamp mismatch → loud rejection
        meta = json.loads(str(d["__meta__"]))
        meta["extra"]["map_layout"] = "block2x2x2/E8/SUB2/B2"
        d["__meta__"] = json.dumps(meta)
        np.savez_compressed(p, **d)
        with pytest.raises(ValueError, match="map layout"):
            Localizer(cfg).load_checkpoint(p)

    def test_pcd_roundtrip(self, tmp_path):
        from fast_limo_tpu.models import mapper

        m = mapper.create(1024, 2)
        rngl = np.random.default_rng(0)
        pts = rngl.uniform(-5, 5, (100, 3)).astype(np.float32)
        m = mapper.insert(m, jnp.asarray(pts), jnp.ones(100, bool), voxel_size=0.4)
        p = str(tmp_path / "map.pcd")
        n = ckpt.save_map_pcd(p, m)
        assert n == int(m.num_points)
        loaded = ckpt.load_map_pcd(p)
        assert loaded.shape == (n, 3)
        got = ckpt.map_points(m)
        np.testing.assert_allclose(np.sort(loaded, 0), np.sort(got, 0), atol=1e-5)
