"""models/iekf._body_jnp — one update-iteration body (chart projection,
gain, degeneracy guard, boxplus, terminal covariance) in float32 vs the
same algebra in float64."""

import jax.numpy as jnp
import numpy as np
import pytest

from fast_limo_tpu.models import iekf
from fast_limo_tpu.models import state as st
from fast_limo_tpu.ops import gain as gain_op
from fast_limo_tpu.ops import s2, so3


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def _rand_state(rng, dtype):
    q = so3.quat_normalize(jnp.asarray(rng.standard_normal(4), dtype))
    qe = so3.quat_normalize(
        jnp.asarray([1.0, *(rng.standard_normal(3) * 0.01)], dtype))
    return st.NavState(
        pos=jnp.asarray(rng.standard_normal(3) * 10, dtype), rot=q, rot_LI=qe,
        t_LI=jnp.asarray(rng.standard_normal(3) * 0.1, dtype),
        vel=jnp.asarray(rng.standard_normal(3), dtype),
        bg=jnp.asarray(rng.standard_normal(3) * 0.01, dtype),
        ba=jnp.asarray(rng.standard_normal(3) * 0.05, dtype),
        grav=s2.project(jnp.asarray(rng.standard_normal(3), dtype)))


def _fastpath_body(HTH, HTh, P, x, x_prop, R):
    """The jnp body with the degeneracy guard forced to identity (the
    kernel's fast-path contract), in the caller's dtype."""
    dtype = x.dtype
    dx = st.boxminus(x, x_prop)
    dx_new, P_it = iekf._chart_project_P(dx, x, x_prop, P, dx)
    K_x12, K_h, K = gain_op.gain_reference(HTH, HTh, P_it, R)
    K_x = jnp.zeros((23, 23), dtype).at[:, :12].set(K_x12)
    dx_ = K_h + (K_x - jnp.eye(23, dtype=dtype)) @ dx_new
    x_next = st.boxplus(x, dx_)
    P_fin = iekf._final_P(x_next, x_prop, dx_, P_it, K_x12, K, R)
    return x_next, P_fin, dx_


def _case(rng, pert_scale, zero_dims=()):
    x_prop = _rand_state(rng, jnp.float32)
    pert = jnp.asarray(rng.standard_normal(23) * pert_scale, jnp.float32)
    x = st.boxplus(x_prop, pert)
    H = rng.standard_normal((300, 12)) * np.geomspace(1, 200, 12)
    for z in zero_dims:
        H[:, z] = 0.0
    HTH = jnp.asarray(H.T @ H, jnp.float32)
    HTh = jnp.asarray(H.T @ (rng.standard_normal(300) * 0.1), jnp.float32)
    Q = rng.standard_normal((23, 23)) * 0.05
    P = jnp.asarray(Q @ Q.T + np.eye(23) * 0.01, jnp.float32)
    return HTH, HTh, P, x, x_prop, 1e-3


def _to64(a):
    return jnp.asarray(np.asarray(a), jnp.float64)


def _compare(case, err_ratio=12.0, floor=5e-5):
    HTH, HTh, P, x, x_prop, R = case
    x64 = st.NavState(*[_to64(v) for v in x])
    xp64 = st.NavState(*[_to64(v) for v in x_prop])
    ref64 = _fastpath_body(_to64(HTH), _to64(HTh), _to64(P), x64, xp64, R)
    ref32 = _fastpath_body(HTH, HTh, P, x, x_prop, R)
    # D = -inf: the Gershgorin certificate holds, the eigh is skipped and
    # the guard is the identity — isolates the body algebra against the
    # guard-free reference
    xk, Pk, dxk, me = iekf._body_jnp(x, x_prop, P, HTH, HTh, R, -1e30)
    assert xk.pos.dtype == jnp.float32
    assert np.isinf(float(me))          # the certificate skipped the eigh
    kern = (xk, Pk, dxk)

    names = ("x_next", "P_fin", "dx_")
    for name, t64, t32, tk in zip(names, ref64, ref32, kern):
        if name == "x_next":
            t64, t32, tk = (st.as_vector(t64), st.as_vector(t32),
                            st.as_vector(tk))
        t64, t32, tk = map(np.asarray, (t64, t32, tk))
        s = np.max(np.abs(t64)) + 1e-12
        e32 = np.max(np.abs(t32 - t64)) / s
        ek = np.max(np.abs(tk - t64)) / s
        assert ek <= err_ratio * e32 + floor, \
            f"{name}: body err {ek:.2e} vs fast-path-f32 err {e32:.2e}"


def test_small_iterate_delta(rng):
    """Millimetric iterate offsets — the common per-iteration regime."""
    _compare(_case(rng, 1e-3))


def test_large_iterate_delta(rng):
    """Large deltas exercise the trig branches of the charts."""
    _compare(_case(rng, 0.5))


def test_zero_extrinsic_dims(rng):
    """estimate_extrinsics=False: measurement columns 6..12 exactly zero."""
    _compare(_case(rng, 1e-2, zero_dims=range(6, 12)))


def test_guarded_body_matches_jnp_body(rng):
    """With a real D on a degenerate problem, the float32 body (eigh guard
    engaged) must match the same body in float64."""
    x_prop = _rand_state(rng, jnp.float32)
    pert = jnp.asarray(rng.standard_normal(23) * 1e-3, jnp.float32)
    x = st.boxplus(x_prop, pert)
    # pose block with three ~0.5 eigenvalues (guarded) and three large
    B = rng.standard_normal((6, 3))
    H6 = B @ B.T * 100 + 0.5 * np.eye(6)
    H = np.zeros((12, 12))
    H[:6, :6] = H6
    H[6:, 6:] = np.eye(6) * 50
    HTH = jnp.asarray(H, jnp.float32)
    HTh = jnp.asarray(rng.standard_normal(12) * 10, jnp.float32)
    Q = rng.standard_normal((23, 23)) * 0.05
    P = jnp.asarray(Q @ Q.T + np.eye(23) * 0.01, jnp.float32)
    R, D = 1e-3, 5.0

    want = iekf._body_jnp(st.NavState(*[_to64(v) for v in x]),
                          st.NavState(*[_to64(v) for v in x_prop]),
                          _to64(P), _to64(HTH), _to64(HTh), R, D)
    got = iekf._body_jnp(x, x_prop, P, HTH, HTh, R, D)
    assert got[0].pos.dtype == jnp.float32
    # the guard fired: three pose-block eigenvalues ~0.5 < D
    assert float(got[3]) < D and float(want[3]) < D
    for name, g, w in (("x_next", st.as_vector(got[0]), st.as_vector(want[0])),
                       ("P_fin", got[1], want[1]), ("dx_", got[2], want[2])):
        g, w = np.asarray(g, np.float64), np.asarray(w)
        err = np.max(np.abs(g - w)) / (np.max(np.abs(w)) + 1e-12)
        assert err < 2e-4, f"{name}: float32 body err {err:.2e} vs float64"


def test_update_iterated_parity_cpu(rng):
    """update_iterated matches a manually-iterated fast-path body on a
    non-degenerate problem."""
    HTH, HTh, P, x, x_prop, R = _case(rng, 1e-3)

    def h_model(_x):
        return HTH, HTh

    x_u, P_u, n = iekf.update_iterated(
        x_prop, P, h_model, R=R, D=5.0, max_iters=3, limit=1e-9)
    # reference loop semantics: i = -1 … max_iters-1 → max_iters+1 bodies
    assert int(n) == 4

    # manual loop: same body applied 4 times from x_prop
    xi = x_prop
    for _ in range(4):
        xi, P_fin, dx_ = _fastpath_body(HTH, HTh, P, xi, x_prop, R)
    np.testing.assert_allclose(
        np.asarray(st.as_vector(x_u)), np.asarray(st.as_vector(xi)),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(P_u), np.asarray(P_fin), rtol=1e-4, atol=1e-5)
