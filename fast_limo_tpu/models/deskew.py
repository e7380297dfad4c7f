"""Motion-compensated scan deskewing.

Counterpart of `Localizer::deskewPointCloud` + `State::update`
(Localizer.cpp:733-853, Objects/State.cpp:76-119): for every point, find the
latest propagated state at-or-before its timestamp (binary search →
``searchsorted``), forward-integrate that state to the point time (Rodrigues
rotation + constant-acceleration translation), map the point through the
LiDAR→baselink extrinsics into the world frame, then express it in the
last-propagated-state (Xt2) frame.

All of it is one batched gather + vectorized integration under jit — the
reference's OpenMP hot loop #1 (Localizer.cpp:822-843).

Parity note: `State::update` subtracts the filter biases from the *already
bias-corrected* stored IMU measurement (State.cpp:87,106 after
Localizer.cpp:514-518) — replicated here.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from fast_limo_tpu.models import state as st
from fast_limo_tpu.ops import so3


class Frames(NamedTuple):
    """Stacked propagated states (the propagated_buffer slice for this scan)."""

    time: jnp.ndarray   # (K,)
    pos: jnp.ndarray    # (K,3)
    rot: jnp.ndarray    # (K,4)
    vel: jnp.ndarray    # (K,3)
    bg: jnp.ndarray     # (K,3)
    ba: jnp.ndarray     # (K,3)
    grav: jnp.ndarray   # (K,3)
    w: jnp.ndarray      # (K,3) bias-corrected gyro input at that tick
    a: jnp.ndarray      # (K,3) bias-corrected accel input
    valid: jnp.ndarray  # (K,)


def forward_state(frames: Frames, idx, t):
    """Integrate frame[idx] forward to time t (State::update, State.cpp:76-119).

    Returns (q (…,4), p (…,3)) world pose of the baselink at t.
    """
    dt = (t - frames.time[idx])[..., None]
    w_eff = frames.w[idx] - frames.bg[idx]
    a_body = frames.a[idx] - frames.ba[idx]
    q0 = frames.rot[idx]
    a0 = so3.quat_rotate(q0, a_body) + frames.grav[idx]
    q = so3.quat_mul(q0, so3.exp_quat(w_eff * dt))
    p = frames.pos[idx] + frames.vel[idx] * dt + 0.5 * a0 * dt * dt
    return q, p


def deskew(points, t_pts, valid, frames: Frames, x_last: st.NavState,
           q_ext, t_ext):
    """Deskew a time-sorted scan.

    points: (N,3) LiDAR-frame; t_pts: (N,) absolute seconds (offset applied);
    frames: ascending-time propagated states (invalid slots padded with +inf
    time at the tail); x_last: the last propagated filter state (Xt2);
    (q_ext, t_ext): baselink←lidar extrinsics — the *estimated* extrinsics,
    as the reference refreshes lidar2baselink_T from the state
    (Localizer.cpp:356).

    Returns (pts_xt2 (N,3), pts_world (N,3)).
    """
    ftime = jnp.where(frames.valid, frames.time, jnp.inf)
    idx = jnp.clip(jnp.searchsorted(ftime, t_pts, side="right") - 1, 0, None)

    q_i, p_i = forward_state(frames, idx, t_pts)

    # lidar → baselink → world
    pb = so3.quat_rotate(jnp.broadcast_to(q_ext, q_i.shape[:-1] + (4,)), points) + t_ext
    pw = so3.quat_rotate(q_i, pb) + p_i

    # world → Xt2 (last propagated state) frame
    q_inv = so3.quat_conj(x_last.rot)
    p2 = so3.quat_rotate(jnp.broadcast_to(q_inv, pw.shape[:-1] + (4,)), pw - x_last.pos)

    z = jnp.zeros_like(p2)
    return jnp.where(valid[:, None], p2, z), jnp.where(valid[:, None], pw, z)


def frames_from_scan(x0: st.NavState, t0, w0, a0, xs: st.NavState, imu) -> Frames:
    """Build the deskew frame buffer: carry-in state + per-IMU propagated states.

    ``xs`` is the stacked NavState from `iekf.predict_scan`; ``imu`` the same
    padded IMU batch (fields stamp/acc/gyro/valid). The carry-in frame plays
    the role of the propagated-buffer entry just before the scan window
    (Localizer.cpp:900-912).
    """
    def cat(a, b):
        return jnp.concatenate([a[None], b], axis=0)

    return Frames(
        time=cat(jnp.asarray(t0, imu["stamp"].dtype), imu["stamp"]),
        pos=cat(x0.pos, xs.pos),
        rot=cat(x0.rot, xs.rot),
        vel=cat(x0.vel, xs.vel),
        bg=cat(x0.bg, xs.bg),
        ba=cat(x0.ba, xs.ba),
        grav=cat(x0.grav, xs.grav),
        w=cat(w0, imu["gyro"]),
        a=cat(a0, imu["acc"]),
        valid=cat(jnp.asarray(True), imu["valid"]),
    )
