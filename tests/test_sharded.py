"""Multi-chip sharded scan step on the virtual 8-device CPU mesh.

Checks the map-sharded pipeline compiles, runs, and — the crucial property —
produces the SAME state estimate as the single-chip pipeline (shard-boundary
kNN must not change results; SURVEY.md §7 'hard parts')."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import __graft_entry__ as ge
from fast_limo_tpu.models import pipeline as pl
from fast_limo_tpu.parallel import sharded


needs_devices = pytest.mark.skipif(
    len(jax.devices()) < 4, reason="needs >=4 virtual devices")


@needs_devices
class TestSharded:
    def test_dryrun_multichip(self):
        ge.dryrun_multichip(4)

    def test_matches_single_chip(self):
        n_dev = 4
        cfg_s = ge._tiny_cfg(n_pts=512, map_cap=1024, n_shards=n_dev)
        mesh = sharded.make_mesh(n_dev)
        step_sh, state_sh = sharded.build_sharded_scan_step(cfg_s, mesh)

        # single-chip with the same GLOBAL capacity
        cfg_1 = ge._tiny_cfg(n_pts=512, map_cap=1024 * n_dev, n_shards=1)
        step_1 = pl.build_scan_step(cfg_1, donate=False)
        state_1 = pl.init_state(cfg_1)

        for i in range(3):
            batch = ge._example_batch(cfg_s, seed=i)
            state_sh, out_sh = step_sh(state_sh, batch)
            state_1, out_1 = step_1(state_1, batch)

        np.testing.assert_allclose(np.asarray(out_sh.pos), np.asarray(out_1.pos),
                                   atol=1e-4)
        np.testing.assert_allclose(np.asarray(out_sh.quat), np.asarray(out_1.quat),
                                   atol=1e-4)
        # same number of map points (hash layout differs, content equivalent)
        assert int(state_sh.map.num_points) == int(state_1.map.num_points)
        np.testing.assert_allclose(np.asarray(state_sh.P), np.asarray(state_1.P),
                                   atol=1e-4)

    def test_eight_device_mesh(self):
        ge.dryrun_multichip(8)


@needs_devices
class TestMesh2D:
    def test_2d_mesh_matches_single_chip(self):
        from fast_limo_tpu.parallel import sharded as sh

        cfg_s = ge._tiny_cfg(n_pts=512, map_cap=1024, n_shards=2)
        mesh = sh.make_mesh_2d(2, 2)
        step_sh, state_sh = sh.build_sharded_scan_step(cfg_s, mesh)

        cfg_1 = ge._tiny_cfg(n_pts=512, map_cap=1024 * 2, n_shards=1)
        step_1 = pl.build_scan_step(cfg_1, donate=False)
        state_1 = pl.init_state(cfg_1)

        for i in range(3):
            batch = ge._example_batch(cfg_s, seed=i)
            state_sh, out_sh = step_sh(state_sh, batch)
            state_1, out_1 = step_1(state_1, batch)

        np.testing.assert_allclose(np.asarray(out_sh.pos), np.asarray(out_1.pos),
                                   atol=1e-4)
        # probe chains wrap within shards vs across the global table, so at
        # high load the stored-point counts differ slightly (layout detail)
        n_s, n_1 = int(state_sh.map.num_points), int(state_1.map.num_points)
        assert abs(n_s - n_1) <= 0.05 * max(n_s, n_1)
        np.testing.assert_allclose(np.asarray(state_sh.P), np.asarray(state_1.P),
                                   atol=1e-3)

    def test_2d_mesh_debug_leaves_full_query_axis(self):
        """cfg.debug on a 2-D mesh: the match debug leaves must cover the
        FULL query axis (ADVICE r2: before the all_gather fix they silently
        contained only one 'data' shard's slice)."""
        from fast_limo_tpu.parallel import sharded as sh

        cfg_s = ge._tiny_cfg(n_pts=512, map_cap=1024, n_shards=2)
        cfg_s.debug = True
        mesh = sh.make_mesh_2d(2, 2)
        step_sh, state_sh = sh.build_sharded_scan_step(cfg_s, mesh)

        cfg_1 = ge._tiny_cfg(n_pts=512, map_cap=1024 * 2, n_shards=1)
        cfg_1.debug = True
        step_1 = pl.build_scan_step(cfg_1, donate=False)
        state_1 = pl.init_state(cfg_1)

        for i in range(2):
            batch = ge._example_batch(cfg_s, seed=i)
            state_sh, out_sh = step_sh(state_sh, batch)
            state_1, out_1 = step_1(state_1, batch)

        dbg_s, dbg_1 = out_sh.debug, out_1.debug
        assert dbg_s.match_planes.shape == dbg_1.match_planes.shape
        assert dbg_s.match_keep.shape == dbg_1.match_keep.shape
        assert dbg_s.match_dist.shape == dbg_1.match_dist.shape
        keep_s = np.asarray(dbg_s.match_keep)
        keep_1 = np.asarray(dbg_1.match_keep)
        # gates may flip on borderline FP ties; the populations must agree
        assert np.mean(keep_s == keep_1) > 0.98
        both = keep_s & keep_1
        np.testing.assert_allclose(np.asarray(dbg_s.match_dist)[both],
                                   np.asarray(dbg_1.match_dist)[both],
                                   atol=1e-3)


@needs_devices
class TestShardedLifecycle:
    """Eviction and checkpoint/resume under map sharding (round-2 verdict
    item 10): the lifecycle ops are elementwise/collective-free on the
    sharded table, so they must compose with the mesh without gathering."""

    def _run(self, step, state, cfg, n=3):
        for i in range(n):
            state, out = step(state, ge._example_batch(cfg, seed=i))
        return state, out

    def test_evict_far_under_sharding(self):
        import jax

        from fast_limo_tpu.models import mapper

        n_dev = 4
        cfg = ge._tiny_cfg(n_pts=512, map_cap=1024, n_shards=n_dev)
        mesh = sharded.make_mesh(n_dev)
        step, state = sharded.build_sharded_scan_step(cfg, mesh)
        state, out = self._run(step, state, cfg)
        n_before = int(state.map.num_points)
        assert n_before > 0

        # evict everything beyond 5 m of the current pose; the jitted call
        # sees sharded table arrays — the op is elementwise, so XLA keeps
        # the sharding (no resharding collectives needed)
        evict = jax.jit(lambda m, c: mapper.evict_far(
            m, c, 5.0, voxel_size=cfg.map_voxel_size))
        new_map = evict(state.map, out.pos)
        n_after = int(new_map.num_points)
        assert 0 <= n_after < n_before
        assert new_map.table.sharding == state.map.table.sharding

        # pipeline continues on the evicted (still-sharded) map
        state = state._replace(map=new_map)
        state, out2 = self._run(step, state, cfg, n=1)
        assert np.isfinite(np.asarray(out2.pos)).all()

    def test_checkpoint_roundtrip_under_sharding(self, tmp_path):
        import jax
        from jax.sharding import NamedSharding

        from fast_limo_tpu.utils import checkpoint as ckpt

        n_dev = 4
        cfg = ge._tiny_cfg(n_pts=512, map_cap=1024, n_shards=n_dev)
        mesh = sharded.make_mesh(n_dev)
        step, state = sharded.build_sharded_scan_step(cfg, mesh)
        state, _ = self._run(step, state, cfg)

        path = str(tmp_path / "sharded.npz")
        ckpt.save_state(path, state)               # device_get gathers shards

        # restore and re-place with the mesh shardings
        restored = ckpt.load_state(path, state)
        shardings = jax.tree_util.tree_map(
            lambda spec: NamedSharding(mesh, spec),
            sharded._state_specs(cfg),
            is_leaf=lambda x: isinstance(x, sharded.P))
        restored = jax.device_put(restored, shardings)

        # bitwise-identical continuation: one more step from the restored
        # state matches one more step from the live state
        batch = ge._example_batch(cfg, seed=99)
        s_live, out_live = step(state, batch)
        s_rest, out_rest = step(restored, batch)
        np.testing.assert_array_equal(np.asarray(out_live.pos),
                                      np.asarray(out_rest.pos))
        np.testing.assert_array_equal(np.asarray(s_live.map.num_points),
                                      np.asarray(s_rest.map.num_points))

    def test_comm_volume_model(self):
        cfg = ge._tiny_cfg(n_pts=512, map_cap=1024, n_shards=4)
        v1 = sharded.comm_volume(cfg, 1, 1)
        v4 = sharded.comm_volume(cfg, 4, 1)
        v42 = sharded.comm_volume(cfg, 4, 2)
        assert v1["knn_allgather_bytes"] == 0       # single device: no collective
        assert v4["knn_allgather_bytes"] > 0
        # query sharding halves the per-device gather payload of the
        # n_q-proportional terms; the stale-patch branch's fixed
        # per-device budget does not scale with 'data'
        from fast_limo_tpu.models.measurement import STALE_BUDGET
        k = cfg.ikfom.mapping.NUM_MATCH_POINTS
        evals = cfg.ikfom.MAX_NUM_ITERS + 1
        patched = 3 * STALE_BUDGET * k * 4 * 4 * evals   # (n_map−1)=3
        assert v42["knn_allgather_bytes"] == \
            (v4["knn_allgather_bytes"] - patched) // 2 + patched
        assert v42["hstats_psum_bytes"] > 0

    def test_comm_model_matches_compiled_hlo_1d(self):
        """The analytic comm model must equal the ACTUAL collectives in the
        compiled program — a kNN-layout change that alters collective traffic
        breaks this test instead of silently invalidating the scaling
        tables (round-2 weak #6)."""
        cfg = ge._tiny_cfg(n_pts=512, map_cap=1024, n_shards=4)
        mesh = sharded.make_mesh(4)
        step, state = sharded.build_sharded_scan_step(cfg, mesh)
        txt = step.lower(state, ge._example_batch(cfg)).compile().as_text()
        got = sharded.hlo_comm_volume(txt)
        model = sharded.comm_volume(cfg, 4, 1)
        assert got["allgather_bytes"] == (
            model["knn_allgather_bytes"] + model["cap_allgather_bytes"])
        assert got["allreduce_bytes"] == (
            model["hstats_psum_bytes"] + model["gate_psum_bytes"]
            + model["cert_psum_bytes"] + model["num_points_psum_bytes"])

    def test_comm_model_matches_compiled_hlo_2d(self):
        cfg = ge._tiny_cfg(n_pts=512, map_cap=1024, n_shards=2)
        mesh = sharded.make_mesh_2d(2, 2)
        step, state = sharded.build_sharded_scan_step(cfg, mesh)
        txt = step.lower(state, ge._example_batch(cfg)).compile().as_text()
        got = sharded.hlo_comm_volume(txt)
        model = sharded.comm_volume(cfg, 2, 2)
        assert got["allgather_bytes"] == (
            model["knn_allgather_bytes"] + model["cap_allgather_bytes"])
        assert got["allreduce_bytes"] == (
            model["hstats_psum_bytes"] + model["gate_psum_bytes"]
            + model["cert_psum_bytes"] + model["num_points_psum_bytes"])
