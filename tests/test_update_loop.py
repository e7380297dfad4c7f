"""The whole iterated update (models/iekf.update_iterated) in float32 over
point-to-plane measurements — fixed correspondences and the per-iteration
window re-match (models/measurement: window_rank, stale_mask) — vs the
NumPy float64 oracle of the reference loop (tests/oracle.update_iterated),
plus the degeneracy guard vs a float64 spectral projector."""

import jax.numpy as jnp
import numpy as np
import pytest

from fast_limo_tpu.models import iekf, measurement
from fast_limo_tpu.models import state as st
from fast_limo_tpu.ops import plane as plane_op
from fast_limo_tpu.ops import s2, so3

import oracle
import pipeline_oracle as po

FIELDS = ("pos", "rot", "rot_LI", "t_LI", "vel", "bg", "ba", "grav")


@pytest.fixture
def rng():
    return np.random.default_rng(5)


def _rand_state(rng, dtype=jnp.float32):
    q = so3.quat_normalize(jnp.asarray(rng.standard_normal(4), dtype))
    qe = so3.quat_normalize(
        jnp.asarray([1.0, *(rng.standard_normal(3) * 0.01)], dtype))
    return st.NavState(
        pos=jnp.asarray(rng.standard_normal(3) * 5, dtype), rot=q, rot_LI=qe,
        t_LI=jnp.asarray(rng.standard_normal(3) * 0.1, dtype),
        vel=jnp.asarray(rng.standard_normal(3), dtype),
        bg=jnp.asarray(rng.standard_normal(3) * 0.01, dtype),
        ba=jnp.asarray(rng.standard_normal(3) * 0.05, dtype),
        grav=s2.project(jnp.asarray([0.1, 0.2, -9.7], dtype)))


def _to_dict(x: st.NavState) -> dict:
    return {f: np.asarray(getattr(x, f), np.float64) for f in FIELDS}


def _plane_case(rng, n_pts=384, resid=0.05, keep_frac=0.9):
    """Realistic point-to-plane measurement set at the prior pose."""
    x_prop = _rand_state(rng)
    pc = jnp.asarray(rng.uniform(-20, 20, (n_pts, 3)), jnp.float32)
    glob = so3.quat_rotate(x_prop.rot, pc) + x_prop.pos
    n = rng.standard_normal((n_pts, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    d = -np.sum(n * np.asarray(glob), axis=1) \
        + rng.standard_normal(n_pts) * resid
    n_abcd = jnp.asarray(np.concatenate([n, d[:, None]], axis=1), jnp.float32)
    keep = jnp.asarray(rng.random(n_pts) < keep_frac)
    Q = rng.standard_normal((23, 23)) * 0.02
    P = jnp.asarray(Q @ Q.T + np.eye(23) * 0.01, jnp.float32)
    return x_prop, P, pc, n_abcd, keep


def _rows_np(pc, n_abcd, keep, s: dict, ee: bool):
    """f64 calculate_H rows (Localizer.cpp:537-577) at oracle state ``s``."""
    pc = np.asarray(pc, np.float64)
    n_abcd = np.asarray(n_abcd, np.float64)
    R = oracle.qmat(s["rot"])
    glob = pc @ R.T + s["pos"]
    n = n_abcd[:, :3]
    dist = np.sum(n * glob, axis=-1) + n_abcd[:, 3]
    C = n @ R
    A = np.cross(pc, C)
    if ee:
        RLI = oracle.qmat(s["rot_LI"])
        B = np.cross((pc - s["t_LI"]) @ RLI, C @ RLI)
        H = np.concatenate([n, A, B, C], axis=1)
    else:
        H = np.concatenate([n, A, np.zeros_like(n), np.zeros_like(n)], axis=1)
    keep = np.asarray(keep)
    return np.where(keep[:, None], H, 0.0), np.where(keep, -dist, 0.0)


R_, D_, LIMIT, MAX_ITERS = 1e-3, 5.0, 1e-3, 3


def _assert_tracks_oracle(x_prop, P, h_model, h_oracle, *, x_tol, P_tol):
    x_j, P_j, n_j = iekf.update_iterated(
        x_prop, P, h_model, R=R_, D=D_, max_iters=MAX_ITERS, limit=LIMIT)
    x_o, P_o, n_o = oracle.update_iterated(
        _to_dict(x_prop), np.asarray(P, np.float64), h_oracle, R=R_, D=D_,
        max_iters=MAX_ITERS, limit=LIMIT)
    assert x_j.pos.dtype == jnp.float32
    # same stopping iteration: the engine counts h-model evaluations
    # (i = -1 … stop), the oracle returns its final loop index + 1
    assert int(n_j) == int(n_o) + 1
    for f in FIELDS:
        np.testing.assert_allclose(np.asarray(getattr(x_j, f)), x_o[f],
                                   rtol=x_tol, atol=x_tol, err_msg=f)
    np.testing.assert_allclose(np.asarray(P_j), P_o, rtol=P_tol, atol=P_tol)
    return x_j


class TestWholeLoopKernel:
    """Fixed correspondences: the float32 loop over measurement.h_statistics
    tracks the float64 reference loop."""

    def _run(self, x_prop, P, pc, n_abcd, keep, ee, **tol):
        _assert_tracks_oracle(
            x_prop, P,
            lambda x: measurement.h_statistics(pc, n_abcd, keep, x, ee),
            lambda s: _rows_np(pc, n_abcd, keep, s, ee), **tol)

    def test_matches_jnp_loop(self, rng):
        self._run(*_plane_case(rng), ee=True, x_tol=2e-4, P_tol=2e-4)

    def test_matches_without_extrinsics(self, rng):
        self._run(*_plane_case(rng), ee=False, x_tol=2e-4, P_tol=2e-4)

    def test_degenerate_geometry_matches_eigh_guard_loop(self, rng):
        """Nearly all planes share one normal → pose-block eigenvalues
        below D but well above FP noise: the float32 eigh guard must
        reproduce the float64 reference guard on a genuinely degenerate
        problem (both compute the spectral projector)."""
        x_prop, P, pc, n_abcd, keep = _plane_case(rng)
        pc = pc * 0.1                      # small lever arms keep the weak
        n_pts = pc.shape[0]                # directions below D
        one_n = np.tile(np.array([0.0, 0.0, 1.0], np.float32), (n_pts, 1))
        mixed = rng.standard_normal((n_pts, 3)).astype(np.float32)
        mixed /= np.linalg.norm(mixed, axis=1, keepdims=True)
        use_mixed = (rng.random(n_pts) < 0.03)[:, None]
        n = np.where(use_mixed, mixed, one_n)
        glob = so3.quat_rotate(x_prop.rot, pc) + x_prop.pos
        d = -np.sum(n * np.asarray(glob), axis=1) \
            + rng.standard_normal(n_pts) * 0.02
        n_abcd = jnp.asarray(np.concatenate([n, d[:, None]], axis=1),
                             jnp.float32)

        # scenario sanity: degenerate (min eig < D) but far from FP noise
        HTH0, _ = measurement.h_statistics(pc, n_abcd, keep, x_prop, True)
        w0 = np.linalg.eigvalsh(np.asarray(HTH0, np.float64)[:6, :6])
        assert 0.05 < w0.min() < D_, w0
        self._run(x_prop, P, pc, n_abcd, keep, ee=True, x_tol=1e-3,
                  P_tol=2e-4)


class TestWindowRematchKernel:
    """Window re-match: every iteration re-ranks the frozen top-W window
    at the iterate, refits, re-gates and re-caps (measurement.window_rank
    + fit_planes), and the staleness certificates (measurement.stale_mask)
    flag queries whose window cannot prove set stability."""

    K, W, VOXEL = 5, 8, 1.2
    FIT = dict(max_dist_plane=2.0, plane_threshold=0.1)
    CAP = 300

    def _window_fixture(self, rng, n_q=384, partial_frac=0.33):
        """Queries + per-query top-W candidate windows from a planar world."""
        x_prop, P, pc, _n, _keep = _plane_case(rng, n_pts=n_q)
        pc = pc * 0.3                      # keep queries near the surfaces
        glob0 = so3.quat_rotate(x_prop.rot, pc) + x_prop.pos
        # world surface points: local planar patches around each query
        world = []
        nrm = rng.standard_normal((n_q, 3))
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
        for _ in range(12):
            t1 = np.cross(nrm, [0.1, 0.7, 0.2])
            t1 /= np.linalg.norm(t1, axis=1, keepdims=True)
            t2 = np.cross(nrm, t1)
            a, b = rng.uniform(-0.5, 0.5, (2, n_q, 1))
            world.append(np.asarray(glob0) + a * t1 + b * t2
                         + 0.02 * rng.standard_normal((n_q, 3)))
        world = np.concatenate(world).astype(np.float32)
        d2 = (np.sum(np.asarray(glob0) ** 2, 1)[:, None]
              + np.sum(world ** 2, 1)[None, :]
              - 2.0 * np.asarray(glob0) @ world.T)
        idx = np.argsort(d2, axis=1)[:, :self.W]
        nbrs_w = np.asarray(world[idx])
        # PARTIAL windows for a third of the queries (sparse/frontier
        # regime: cnt < W, some cnt < k)
        cnt_w = np.full(n_q, self.W)
        cut = rng.integers(0, self.W + 1, n_q)
        partial = rng.random(n_q) < partial_frac
        cnt_w = np.where(partial, cut, cnt_w)
        vld_w = np.arange(self.W)[None, :] < cnt_w[:, None]
        nbrs_w = np.where(vld_w[..., None], nbrs_w, 0.0).astype(np.float32)
        pc_valid = jnp.asarray(rng.random(n_q) < 0.95)
        return x_prop, P, pc, pc_valid, glob0, nbrs_w, vld_w

    def _freeze(self, glob0, nbrs_w, vld_w):
        g0 = np.asarray(glob0, np.float64)
        sq = np.where(vld_w, np.sum((nbrs_w - g0[:, None, :]) ** 2, -1),
                      np.inf)
        return measurement.freeze_window(
            glob0, jnp.asarray(nbrs_w), jnp.asarray(sq, jnp.float32),
            jnp.asarray(vld_w), self.VOXEL)

    def _jnp_h_model(self, pc, pc_valid, win):
        def h_model(x):
            glob = so3.quat_rotate(x.rot, pc) + x.pos
            sel, sel_sq = measurement.window_rank(win, glob, self.K)
            n_abcd, good = plane_op.fit_planes(
                sel, sel_sq, jnp.isfinite(sel_sq), num_match_points=self.K,
                **self.FIT)
            good = good & pc_valid
            keep = good & (jnp.cumsum(good.astype(jnp.int32)) <= self.CAP)
            return measurement.h_statistics(pc, n_abcd, keep, x, True)
        return h_model

    def _np_h_model(self, pc, pc_valid, nbrs_w, vld_w):
        """float64 twin: re-rank by argsort, np.linalg.eigh plane fit."""
        pc64 = np.asarray(pc, np.float64)
        nb = np.asarray(nbrs_w, np.float64)

        def h_model(s):
            glob = pc64 @ oracle.qmat(s["rot"]).T + s["pos"]
            d2 = np.where(vld_w, np.sum((nb - glob[:, None, :]) ** 2, -1),
                          np.inf)
            order = np.argsort(d2, axis=1, kind="stable")[:, :self.K]
            sq = np.take_along_axis(d2, order, axis=1)
            sel = np.take_along_axis(nb, order[..., None], axis=1)
            n_abcd, good = po.fit_planes(sel, sq, np.isfinite(sq), k=self.K,
                                         **self.FIT)
            good = good & np.asarray(pc_valid)
            keep = good & (np.cumsum(good) <= self.CAP)
            return _rows_np(pc, n_abcd, keep, s, True)
        return h_model

    def test_matches_jnp_window_loop(self, rng):
        x_prop, P, pc, pc_valid, glob0, nbrs_w, vld_w = \
            self._window_fixture(rng)
        win = self._freeze(glob0, nbrs_w, vld_w)
        _assert_tracks_oracle(
            x_prop, P, self._jnp_h_model(pc, pc_valid, win),
            self._np_h_model(pc, pc_valid, nbrs_w, vld_w),
            x_tol=2e-4, P_tol=2e-4)

    def test_clean_geometry_passes_certificates(self, rng):
        """Wide windows + small corrections → every staleness certificate
        holds at the posterior (nothing needs a re-gather)."""
        x_prop, P, pc, pc_valid, glob0, nbrs_w, vld_w = \
            self._window_fixture(rng, partial_frac=0.0)
        # make every window WIDE-gapped: push the 3 farthest candidates far
        # out so d_W − d_k is metres
        nw = np.array(nbrs_w, copy=True)
        g0 = np.asarray(glob0)
        for j in range(self.K, self.W):
            d = nw[:, j] - g0
            nw[:, j] = g0 + d / np.maximum(
                np.linalg.norm(d, axis=1, keepdims=True), 1e-9) * 3.0
        win = self._freeze(glob0, nw, np.ones_like(vld_w))
        x_u, _P, _n = iekf.update_iterated(
            x_prop, P, self._jnp_h_model(pc, pc_valid, win), R=R_, D=D_,
            max_iters=MAX_ITERS, limit=LIMIT)
        glob = so3.quat_rotate(x_u.rot, pc) + x_u.pos
        _sel, sel_sq = measurement.window_rank(win, glob, self.K)
        stale = measurement.stale_mask(win, glob, sel_sq, pc_valid, self.K,
                                       self.VOXEL)
        assert float(jnp.max(jnp.linalg.norm(glob - glob0, axis=-1))) > 0
        assert not bool(jnp.any(stale))

    def test_tight_window_flags_staleness(self, rng):
        """All W candidates equidistant from the query → d_W − d_k ≈ 0, so
        ANY displacement defeats cert_a; an invalid query is never
        flagged."""
        x_prop, P, pc, pc_valid, glob0, _nbrs_w, _vld_w = \
            self._window_fixture(rng)
        # shell windows: full candidate sets on a sphere around each query
        dirs = rng.standard_normal((pc.shape[0], self.W, 3))
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        shell = (np.asarray(glob0)[:, None, :] + 0.5 * dirs).astype(np.float32)
        win = self._freeze(glob0, shell, np.ones(shell.shape[:2], bool))
        glob = glob0 + jnp.asarray([0.01, -0.02, 0.015], jnp.float32)
        _sel, sel_sq = measurement.window_rank(win, glob, self.K)
        stale = np.asarray(measurement.stale_mask(
            win, glob, sel_sq, pc_valid, self.K, self.VOXEL))
        assert stale.any()
        assert not stale[~np.asarray(pc_valid)].any()


class TestJacobiGuard:
    def test_guard_matches_jnp_eigh_guard(self, rng):
        """iekf._degeneracy_guard (float32 eigh) equals the float64
        spectral projector V·diag(m)·Vᵀ, and that projector is invariant to
        eigenvector signs — the property the reference's row-zeroing quirk
        lacks (why the engine documents a divergence; see
        iekf._degeneracy_guard)."""
        for _ in range(5):
            # eigenvalues {0.5, 0.5, 0.5, big…}: three guarded directions,
            # well away from both D and FP noise
            B = rng.standard_normal((6, 3))
            H6 = jnp.asarray(B @ B.T * 100 + 0.5 * np.eye(6), jnp.float32)
            HTH = jnp.zeros((12, 12), jnp.float32).at[:6, :6].set(H6)
            dx = jnp.asarray(rng.standard_normal(23), jnp.float32)
            got, min_eig = iekf._degeneracy_guard(HTH, dx, 5.0)
            dx6 = np.asarray(dx, np.float64)[:6]
            w_np, V_np = np.linalg.eigh(np.asarray(H6, np.float64))
            m = (w_np >= 5.0).astype(float)
            for sgn in (np.ones(6), np.array([1, -1, 1, -1, -1, 1.0])):
                Vs = V_np * sgn[None, :]
                np.testing.assert_allclose(
                    np.asarray(got, np.float64)[:6],
                    (Vs * m[None, :]) @ (Vs.T @ dx6), rtol=1e-3, atol=1e-4)
            # the non-pose components pass through untouched
            np.testing.assert_array_equal(np.asarray(got)[6:],
                                          np.asarray(dx)[6:])
            assert float(min_eig) == pytest.approx(w_np.min(), rel=1e-3)
