"""Scan & IMU preprocessing as fixed-shape masked array ops.

Covers the reference's preprocessing chain (Localizer.cpp:262-321) — NaN
removal, negative crop box, min-distance / rate-sampling / FoV filters — and
the per-sensor point-time extraction + time sorting + auto time-offset of
`deskewPointCloud` (Localizer.cpp:740-805), plus the IMU→baselink lever-arm
transform (Localizer.cpp:696-731).
"""

from __future__ import annotations

import jax.numpy as jnp

from fast_limo_tpu.ops import so3

# SensorType enum (Common.hpp:82)
OUSTER, VELODYNE, HESAI, LIVOX = 0, 1, 2, 3


def extract_point_times(t_raw, sweep_ref_time, sensor_type: int, end_of_sweep: bool):
    """Absolute per-point seconds (Localizer.cpp:747-783)."""
    if sensor_type == OUSTER:          # nanoseconds relative
        rel = t_raw * 1e-9
        return sweep_ref_time - rel if end_of_sweep else sweep_ref_time + rel
    if sensor_type == VELODYNE:        # seconds relative
        return sweep_ref_time - t_raw if end_of_sweep else sweep_ref_time + t_raw
    if sensor_type == HESAI:           # absolute seconds
        return t_raw
    if sensor_type == LIVOX:           # absolute nanoseconds
        return t_raw * 1e-9
    raise ValueError(f"unknown sensor type {sensor_type}")


def preprocess_scan(points, t_raw, valid, scan_stamp, imu_stamp, *,
                    sensor_type: int, end_of_sweep: bool,
                    crop_active: bool, crop_min, crop_max,
                    dist_active: bool, min_dist: float,
                    rate_active: bool, rate_value: int,
                    fov_active: bool, fov_angle: float,
                    time_offset: bool, time_sort: bool = True):
    """Filter (+ optionally time-sort) a raw scan; all shapes static.

    Returns (points (N,3), t_abs (N,) with offset applied, valid (N,),
    scan_end_stamp ()).  With ``time_sort`` invalid points carry +inf time
    and sort to the tail (the reference's layout, Localizer.cpp — its
    sequential deskew loop NEEDS time order).

    ``time_sort=False`` keeps the original point order: every consumer
    here is order-invariant — deskew selects each point's frame by
    per-point time masks, the voxel downsample re-sorts by voxel key and
    averages (so the pc2match/insert SETS are unchanged), and the
    jnp-deskew ``searchsorted`` needs sorted FRAME times, not points.
    The 32k argsort + permute is an artifact of the reference's sequential loop, not of its semantics;
    results differ only in f32 summation association inside voxel
    centroids.  ``last_t`` comes from a masked max instead of the sorted
    tail (identical value).
    """
    N = points.shape[0]
    valid = valid & jnp.all(jnp.isfinite(points), axis=-1)

    if crop_active:  # negative crop: REMOVE points inside the box (Localizer.cpp:57)
        inside = jnp.all((points >= jnp.asarray(crop_min, points.dtype))
                         & (points <= jnp.asarray(crop_max, points.dtype)), axis=-1)
        valid = valid & ~inside
    if dist_active:  # (Localizer.cpp:278-287)
        valid = valid & (jnp.linalg.norm(points, axis=-1) > min_dist)
    if rate_active:  # index-stride subsample (Localizer.cpp:281,290)
        valid = valid & (jnp.arange(N) % rate_value == 0)
    if fov_active:   # |atan2(y,x)| < half-FoV (Localizer.cpp:873-876)
        valid = valid & (jnp.abs(jnp.arctan2(points[:, 1], points[:, 0])) < fov_angle)

    t_abs = extract_point_times(t_raw, scan_stamp, sensor_type, end_of_sweep)
    if time_sort:
        t_key = jnp.where(valid, t_abs, jnp.inf)
        order = jnp.argsort(t_key)
        points_s = points[order]
        t_s = t_abs[order]
        valid_s = valid[order]
        n_valid = jnp.sum(valid_s)
        last_t = jnp.where(n_valid > 0, t_s[jnp.maximum(n_valid - 1, 0)],
                           scan_stamp)
    else:
        points_s, t_s, valid_s = points, t_abs, valid
        n_valid = jnp.sum(valid_s)
        last_t = jnp.where(
            n_valid > 0,
            jnp.max(jnp.where(valid_s, t_s, -jnp.inf)), scan_stamp)

    # automatic IMU/LiDAR sync offset, clamped ≤ 0 (Localizer.cpp:798-802)
    if time_offset:
        offset = imu_stamp - last_t - 1e-4
        offset = jnp.minimum(offset, 0.0)
    else:
        offset = jnp.asarray(0.0, t_s.dtype)

    scan_end = last_t + offset             # new scan_stamp (Localizer.cpp:805)
    t_out = jnp.where(valid_s, t_s + offset, jnp.inf)
    return points_s, t_out, valid_s, scan_end


def imu_to_baselink(acc, gyro, stamp, prev_stamp, prev_w_bl, *,
                    R_imu2bl, t_imu2bl):
    """Batched IMU→baselink transform with lever-arm terms (Localizer.cpp:696-731).

    acc/gyro: (K,3) raw; stamp: (K,); prev_stamp: () stamp of the sample
    before this batch; prev_w_bl: (3,) its baselink-frame angular velocity.
    Returns (acc_bl (K,3), gyro_bl (K,3), dt (K,)).
    """
    dt = stamp - jnp.concatenate([prev_stamp[None], stamp[:-1]])
    # clamp (cpp:702); dt ≤ 0 also clamped (covers the first-ever sample,
    # where the reference's prev_imu_stamp=0 forces the >0.1 branch)
    dt = jnp.where((dt <= 0.0) | (dt > 0.1), 1.0 / 200.0, dt)

    w_bl = gyro @ R_imu2bl.T
    w_prev = jnp.concatenate([prev_w_bl[None], w_bl[:-1]], axis=0)
    a_bl = acc @ R_imu2bl.T
    lever = -t_imu2bl
    a_bl = (a_bl
            + jnp.cross((w_bl - w_prev) / dt[:, None], jnp.broadcast_to(lever, a_bl.shape))
            + jnp.cross(w_bl, jnp.cross(w_bl, jnp.broadcast_to(lever, a_bl.shape))))
    return a_bl, w_bl, dt


def apply_intrinsics(acc, gyro, sm, accel_bias, gyro_bias):
    """Static calibration correction (Localizer.cpp:513-518): sm·a − ba, ω − bg."""
    return acc @ sm.T - accel_bias, gyro - gyro_bias
