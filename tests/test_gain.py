"""ops/gain.gain_reference — the iEKF gain in covariance form on compressed
measurements — vs the reference's own n×n information form
(esekfom.hpp:1701-1709: K = (P⁻¹/R + HᵀH)⁻¹·Hᵀ), computed in NumPy float64.
The two are Woodbury-equal, so in float64 they agree to rounding; in float32
the covariance form's error is pinned per case."""

import jax.numpy as jnp
import numpy as np
import pytest

from fast_limo_tpu.ops import gain as gain_op


def _case(rng, n_rows=400, zero_dims=(), scale_decades=3.0, R=1e-3):
    """Build realistic sufficient statistics + a filter-like covariance."""
    col_scale = np.geomspace(1.0, 10.0 ** scale_decades, gain_op.M)
    H = rng.standard_normal((n_rows, gain_op.M)) * col_scale[None, :]
    for z in zero_dims:
        H[:, z] = 0.0
    r = rng.standard_normal(n_rows) * 0.1
    HTH = H.T @ H
    HTh = H.T @ r
    # covariance: SPD with decades of spread + slight asymmetry (like f32 P)
    Q = rng.standard_normal((gain_op.NS, gain_op.NS))
    P = Q @ Q.T * 1e-4 + np.diag(
        np.geomspace(1e-6, 1.0, gain_op.NS))
    P = P + rng.standard_normal((gain_op.NS, gain_op.NS)) * 1e-9
    return (jnp.asarray(HTH, jnp.float32), jnp.asarray(HTh, jnp.float32),
            jnp.asarray(P, jnp.float32), R)


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def _information_form(HTH, HTh, P, R):
    """(K_x (23,12), K_h (23,)) from the reference's n×n path in float64."""
    HTH, HTh, P = (np.asarray(a, np.float64) for a in (HTH, HTh, P))
    P_temp = np.linalg.inv(P / R)
    P_temp[:12, :12] += HTH
    P_inv = np.linalg.inv(P_temp)
    return P_inv[:, :12] @ HTH, P_inv[:, :12] @ HTh


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-30)


def _compare(case, tol_x, tol_h):
    """float64 gain_reference equals the information form to rounding;
    float32 gain_reference stays within the pinned budget of it."""
    HTH, HTh, P, R = case
    want_x, want_h = _information_form(HTH, HTh, P, R)
    K64 = gain_op.gain_reference(*(jnp.asarray(a, jnp.float64)
                                   for a in (HTH, HTh, P)), R)
    assert _rel(K64[0], want_x) < 1e-7
    assert _rel(K64[1], want_h) < 1e-7
    Kx, Kh, K = gain_op.gain_reference(HTH, HTh, P, R)
    assert Kx.dtype == jnp.float32
    assert _rel(Kx, want_x) < tol_x, _rel(Kx, want_x)
    assert _rel(Kh, want_h) < tol_h, _rel(Kh, want_h)
    assert _rel(K, K64[2]) < tol_x


def test_full_rank(rng):
    # measured on the CPU: 4.8e-4 / 4.7e-4
    _compare(_case(rng), tol_x=2e-3, tol_h=2e-3)


def test_zero_extrinsic_dims(rng):
    """estimate_extrinsics=False: columns 6..12 exactly zero."""
    # measured on the CPU: 3.6e-7 / 4.3e-7
    _compare(_case(rng, zero_dims=range(6, 12)), tol_x=1e-5, tol_h=1e-5)


def test_all_zero_measurements(rng):
    HTH = jnp.zeros((gain_op.M, gain_op.M), jnp.float32)
    HTh = jnp.zeros((gain_op.M,), jnp.float32)
    P = jnp.asarray(np.diag(np.geomspace(1e-6, 1.0, gain_op.NS)), jnp.float32)
    Kx, Kh, K = gain_op.gain_reference(HTH, HTh, P, 1e-3)
    assert np.all(np.asarray(Kx) == 0)
    assert np.all(np.asarray(Kh) == 0)
    assert np.all(np.asarray(K) == 0)


def test_wide_dynamic_range(rng):
    # 4.5 decades of column scale (HᵀH condition ~1e9): float32 keeps only
    # the leading digits here — measured on the CPU: 0.23 (K_x) / 0.058
    # (K_h); the budget pins that, and the float64 algebra stays exact
    _compare(_case(rng, scale_decades=4.5), tol_x=0.5, tol_h=0.15)


def test_dispatch_runs(rng):
    """gain_reference returns finite values of the documented shapes."""
    HTH, HTh, P, R = _case(rng)
    Kx, Kh, K = gain_op.gain_reference(HTH, HTh, P, R)
    assert Kx.shape == (gain_op.NS, gain_op.M)
    assert Kh.shape == (gain_op.NS,)
    assert K.shape == (gain_op.NS, gain_op.M)
    assert np.all(np.isfinite(np.asarray(Kx)))
    assert np.all(np.isfinite(np.asarray(Kh)))
    assert np.all(np.isfinite(np.asarray(K)))


def test_e2e_trajectory_with_kernel_math():
    """Full 25-scan odometry through the float32 gain with extrinsic
    estimation on (the numerically hardest config): the gain's rounding
    must not drift the filter."""
    from test_pipeline import small_cfg, run_odometry
    from fast_limo_tpu.io import synthetic

    seq = synthetic.SyntheticSequence(
        seed=3, n_scans=25, points_per_scan=4096,
        noise_pt=0.01, noise_gyro=5e-4, noise_acc=5e-3)
    cfg = small_cfg()
    cfg.ikfom.estimate_extrinsics = True
    loc = run_odometry(cfg, seq, 20)
    est = loc.positions()
    gt = seq.traj.pos(loc.stamps())
    err = np.linalg.norm(est - gt, axis=1)
    assert err[-1] < 0.3, f"final error {err[-1]:.3f} m (errs={err.round(3)})"
