"""models/deskew.deskew vs a NumPy float64 brute force of the same chain
(frame selection by searchsorted — rightmost frame at ties, left clip —
forward integration, extrinsic/world/Xt2 transforms)."""

import jax.numpy as jnp
import numpy as np
import pytest

from fast_limo_tpu.models import deskew as dsk
from fast_limo_tpu.models import state as st
from fast_limo_tpu.ops import s2, so3

from pipeline_oracle import exp_quat_b, qmul_b, qrot_b


@pytest.fixture
def rng():
    return np.random.default_rng(9)


def _frames(rng, K=17, n_valid=None):
    n_valid = K if n_valid is None else n_valid
    times = np.sort(rng.uniform(0.0, 0.1, K)).astype(np.float32)
    q = rng.standard_normal((K, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    valid = np.arange(K) < n_valid
    return dsk.Frames(
        time=jnp.asarray(times),
        pos=jnp.asarray(rng.uniform(-5, 5, (K, 3)), jnp.float32),
        rot=jnp.asarray(q),
        vel=jnp.asarray(rng.uniform(-2, 2, (K, 3)), jnp.float32),
        bg=jnp.asarray(rng.normal(0, 0.01, (K, 3)), jnp.float32),
        ba=jnp.asarray(rng.normal(0, 0.05, (K, 3)), jnp.float32),
        grav=jnp.broadcast_to(jnp.asarray([0, 0, -9.81], jnp.float32), (K, 3)),
        w=jnp.asarray(rng.normal(0, 0.3, (K, 3)), jnp.float32),
        a=jnp.asarray(rng.normal(0, 1.0, (K, 3)) + [0, 0, 9.81], jnp.float32),
        valid=jnp.asarray(valid),
    )


def _case(rng, N=1000, K=17, n_valid=None):
    frames = _frames(rng, K, n_valid)
    pts = jnp.asarray(rng.uniform(-30, 30, (N, 3)), jnp.float32)
    # point times spanning before/inside/after the frame window, plus exact
    # frame-time ties (the searchsorted rightmost-of-equal edge)
    t = rng.uniform(-0.01, 0.12, N).astype(np.float32)
    t[:K] = np.asarray(frames.time)        # exact ties
    valid = jnp.asarray(rng.random(N) < 0.9)
    q_ext = so3.quat_normalize(jnp.asarray([1.0, 0.02, -0.01, 0.03], jnp.float32))
    t_ext = jnp.asarray([0.1, -0.05, 0.2], jnp.float32)
    x_last = st.identity(jnp.float32)._replace(
        rot=so3.quat_normalize(jnp.asarray(rng.standard_normal(4), jnp.float32)),
        pos=jnp.asarray(rng.uniform(-5, 5, 3), jnp.float32),
        grav=s2.project(jnp.asarray([0, 0, -9.81], jnp.float32)))
    return pts, jnp.asarray(t), valid, frames, x_last, q_ext, t_ext


def _np64(a):
    return np.asarray(a, np.float64)


def _oracle_at(idx, pts, t, frames, x_last, q_ext, t_ext):
    """f64 deskew of every point through frame ``idx`` (per point)."""
    f = {k: _np64(getattr(frames, k)) for k in
         ("time", "pos", "rot", "vel", "bg", "ba", "grav", "w", "a")}
    pts, t = _np64(pts), _np64(t)
    dt = (t - f["time"][idx])[:, None]
    q0 = f["rot"][idx]
    a0 = qrot_b(q0, f["a"][idx] - f["ba"][idx]) + f["grav"][idx]
    q_i = qmul_b(q0, exp_quat_b((f["w"][idx] - f["bg"][idx]) * dt))
    p_i = f["pos"][idx] + f["vel"][idx] * dt + 0.5 * a0 * dt * dt
    pb = qrot_b(np.broadcast_to(_np64(q_ext), q_i.shape), pts) + _np64(t_ext)
    pw = qrot_b(q_i, pb) + p_i
    q_inv = _np64(x_last.rot) * np.array([1.0, -1.0, -1.0, -1.0])
    p2 = qrot_b(np.broadcast_to(q_inv, pw.shape[:-1] + (4,)),
                pw - _np64(x_last.pos))
    return p2, pw


def _oracle(pts, t, valid, frames, x_last, q_ext, t_ext):
    ftime = np.where(np.asarray(frames.valid), _np64(frames.time), np.inf)
    idx = np.clip(np.searchsorted(ftime, _np64(t), side="right") - 1, 0, None)
    p2, pw = _oracle_at(idx, pts, t, frames, x_last, q_ext, t_ext)
    m = np.asarray(valid)[:, None]
    return np.where(m, p2, 0.0), np.where(m, pw, 0.0)


def _compare(case):
    got_xt2, got_w = dsk.deskew(*case)
    want_xt2, want_w = _oracle(*case)
    np.testing.assert_allclose(np.asarray(got_w), want_w, rtol=1e-4, atol=2e-4)
    np.testing.assert_allclose(np.asarray(got_xt2), want_xt2,
                               rtol=1e-4, atol=2e-4)


def test_matches_jnp_deskew(rng):
    _compare(_case(rng))


def test_matches_with_invalid_frame_tail(rng):
    _compare(_case(rng, K=33, n_valid=12))


def test_matches_unpadded_lane_multiple(rng):
    _compare(_case(rng, N=1280))


def test_regressed_frame_time_no_double_select(rng):
    """A regressed IMU stamp (imu_to_baselink's dt clamp anticipates them)
    must not blend frames: every point is still integrated from exactly ONE
    frame of the buffer, and stays finite."""
    pts, t, valid, frames, x_last, q_ext, t_ext = _case(rng, N=512, K=17)
    times = np.array(frames.time)
    times[5] = times[2] - 0.005        # regression mid-buffer
    frames_bad = frames._replace(time=jnp.asarray(times))
    got_xt2, _ = dsk.deskew(pts, t, valid, frames_bad, x_last, q_ext, t_ext)
    got = np.asarray(got_xt2)
    assert np.isfinite(got).all()
    K = times.shape[0]
    per_frame = np.stack([
        _oracle_at(np.full(len(t), i), pts, t, frames_bad, x_last, q_ext,
                   t_ext)[0] for i in range(K)])               # (K,N,3)
    err = np.max(np.abs(per_frame - got[None]), axis=-1)       # (K,N)
    best = np.min(err, axis=0)
    v = np.asarray(valid)
    assert np.all(best[v] < 2e-4 * (1.0 + np.abs(got[v]).max(-1))), best[v].max()
    assert np.all(got[~v] == 0.0)


def test_nan_inputs_on_invalid_lanes_stay_masked(rng):
    """Raw sensor NaN points are masked invalid (not removed) by
    preprocess; deskew must not leak NaN through its masking."""
    pts, t, valid, frames, x_last, q_ext, t_ext = _case(rng)
    pts = np.array(pts)
    valid = np.array(valid)
    bad = np.zeros(len(pts), bool)
    bad[::17] = True
    pts[bad] = np.nan
    t = np.array(t)
    t[bad[: len(t)]] = np.nan
    valid = valid & ~bad
    case = (jnp.asarray(pts), jnp.asarray(t), jnp.asarray(valid), frames,
            x_last, q_ext, t_ext)
    got_xt2, got_w = dsk.deskew(*case)
    assert np.isfinite(np.asarray(got_xt2)).all()
    assert np.isfinite(np.asarray(got_w)).all()
    want_xt2, _ = _oracle(np.where(bad[:, None], 0.0, pts),
                          np.where(bad, 0.0, t), valid, frames, x_last,
                          q_ext, t_ext)
    np.testing.assert_allclose(np.asarray(got_xt2), want_xt2,
                               rtol=1e-4, atol=2e-4)
