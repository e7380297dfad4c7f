"""The measurement module's H statistics (measurement.h_statistics /
jacobian_rows) vs NumPy float64 rows built independently from the
reference's calculate_H (Localizer.cpp:537-577)."""

import jax.numpy as jnp
import numpy as np
import pytest

from fast_limo_tpu.models import measurement
from fast_limo_tpu.models import state as st
from fast_limo_tpu.ops import s2, so3

import oracle


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def _case(rng, N=1000, keep_frac=0.7):
    f32 = jnp.float32
    pc = jnp.asarray(rng.standard_normal((N, 3)) * 20, f32)
    n = rng.standard_normal((N, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    n_abcd = jnp.asarray(
        np.concatenate([n, rng.standard_normal((N, 1))], 1), f32)
    keep = jnp.asarray(rng.random(N) < keep_frac)
    x = st.NavState(
        pos=jnp.asarray(rng.standard_normal(3) * 5, f32),
        rot=so3.quat_normalize(jnp.asarray(rng.standard_normal(4), f32)),
        rot_LI=so3.quat_normalize(
            jnp.asarray([1.0, 0.01, -0.02, 0.005], f32)),
        t_LI=jnp.asarray([0.1, -0.05, 0.2], f32),
        vel=jnp.zeros(3, f32), bg=jnp.zeros(3, f32), ba=jnp.zeros(3, f32),
        grav=s2.project(jnp.asarray([0.0, 0.0, -9.81], f32)))
    return pc, n_abcd, keep, x


def _rows64(pc, n_abcd, keep, x, ee):
    """f64 H rows / residuals (the calculate_H transcription of
    tests/pipeline_oracle.OracleLIO._h_model)."""
    pc, n_abcd, keep = (np.asarray(pc, np.float64),
                        np.asarray(n_abcd, np.float64), np.asarray(keep))
    R = oracle.qmat(np.asarray(x.rot, np.float64))
    glob = pc @ R.T + np.asarray(x.pos, np.float64)
    n = n_abcd[:, :3]
    dist = np.sum(n * glob, axis=-1) + n_abcd[:, 3]
    C = n @ R
    A = np.cross(pc, C)
    if ee:
        RLI = oracle.qmat(np.asarray(x.rot_LI, np.float64))
        p_lidar = (pc - np.asarray(x.t_LI, np.float64)) @ RLI
        B = np.cross(p_lidar, C @ RLI)
        H = np.concatenate([n, A, B, C], axis=1)
    else:
        H = np.concatenate([n, A, np.zeros_like(n), np.zeros_like(n)], axis=1)
    return np.where(keep[:, None], H, 0.0), np.where(keep, -dist, 0.0)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / (np.abs(a).max() + 1e-12)


@pytest.mark.parametrize("ee", [True, False])
def test_kernel_matches_reference(rng, ee):
    pc, n_abcd, keep, x = _case(rng)
    H, h = _rows64(pc, n_abcd, keep, x, ee)
    HTH, HTh = measurement.h_statistics(pc, n_abcd, keep, x, ee)
    assert HTH.dtype == jnp.float32
    assert _rel(H.T @ H, HTH) < 2e-5
    assert _rel(H.T @ h, HTh) < 2e-5
    if not ee:
        # extrinsic blocks exactly zero
        assert np.all(np.asarray(HTH)[6:, :] == 0)
        assert np.all(np.asarray(HTh)[6:] == 0)


def test_padding_inert(rng):
    """Rows with keep=False contribute nothing, whatever their contents."""
    pc, n_abcd, keep, x = _case(rng, N=1000)
    pc2 = jnp.concatenate([pc, jnp.ones((24, 3), jnp.float32) * 1e3])
    n2 = jnp.concatenate([n_abcd, jnp.ones((24, 4), jnp.float32)])
    k2 = jnp.concatenate([keep, jnp.zeros(24, bool)])
    a = measurement.h_statistics(pc, n_abcd, keep, x, True)
    b = measurement.h_statistics(pc2, n2, k2, x, True)
    np.testing.assert_allclose(np.asarray(a[0]), np.asarray(b[0]), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(a[1]), np.asarray(b[1]), rtol=1e-6)


def test_reference_matches_measurement_module(rng):
    """jacobian_rows row for row equals the f64 calculate_H rows."""
    pc, n_abcd, keep, x = _case(rng, N=500)
    H, h = measurement.jacobian_rows(pc, n_abcd, keep, x, True)
    H64, h64 = _rows64(pc, n_abcd, keep, x, True)
    np.testing.assert_allclose(np.asarray(H), H64, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(h), h64, rtol=1e-4, atol=1e-4)
