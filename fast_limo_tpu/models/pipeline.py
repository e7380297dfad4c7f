"""The fused per-scan LIO pipeline.

Where the reference splits work across ROS callback threads with mutexes
(`Localizer::updateIMU` / `Localizer::updatePointCloud`,
Modules/Localizer.cpp:245-531), this design compiles the entire
measurement path into ONE XLA program per scan:

    (LIOState, ScanBatch) → (LIOState', outputs)

* IMU batch → `lax.scan` of covariant EKF predicts (prediction path,
  Localizer.cpp:583-608) producing the propagated frame buffer,
* preprocessing filters + per-sensor time handling (Localizer.cpp:262-321),
* vectorized deskew (Localizer.cpp:733-853),
* voxel-grid downsample → pc2match,
* iterated manifold update with re-matching per iteration
  (esekfom.hpp:1620-1823 + Mapper::match + calculate_H),
* map insertion (Mapper::add).

The host merely accumulates sensor data between scans and feeds padded,
fixed-shape arrays — the "IMU must cover the scan end" condition-variable
dance (Localizer.cpp:878-915) becomes a host-side dispatch rule.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from fast_limo_tpu.models import deskew as dsk
from fast_limo_tpu.models import iekf, mapper, measurement, preprocess
from fast_limo_tpu.models import scancontext as sc
from fast_limo_tpu.models import process as proc
from fast_limo_tpu.models import state as st
from fast_limo_tpu.ops import so3, voxel
from fast_limo_tpu.utils.config import Config


class LIOState(NamedTuple):
    """Full device-resident SLAM state (one pytree)."""

    x: st.NavState            # filter mean
    P: jnp.ndarray            # (23,23) filter covariance
    map: mapper.VoxelHashMap  # incremental world map
    prev_scan_stamp: jnp.ndarray   # ()
    last_prop_time: jnp.ndarray    # () stamp of the last integrated IMU
    last_w_raw_bl: jnp.ndarray     # (3,) last raw baselink gyro (lever-arm chain)
    last_w: jnp.ndarray            # (3,) last corrected gyro (frame carry-in)
    last_a: jnp.ndarray            # (3,) last corrected accel
    bias_gyro_corr: jnp.ndarray    # (3,) pre-correction gyro bias (this->state.b.gyro)
    bias_accel_corr: jnp.ndarray   # (3,) pre-correction accel bias
    pinned_grav: jnp.ndarray       # (3,) gravity pin when gravity_align


class ScanBatch(NamedTuple):
    """Padded per-scan input arrays.

    Time convention (float32-safe): every time in the batch is
    RELATIVE to this scan's header stamp (the "epoch"); the host keeps the
    absolute float64 epoch and supplies ``epoch_shift`` = this epoch minus
    the previous scan's epoch so the carried device state rebases itself.
    For absolute-stamp sensors (HESAI/LIVOX) the host must rebase ``t_raw``
    to the epoch as well (in the sensor's native units).
    """

    points: jnp.ndarray     # (N,3) raw LiDAR-frame points
    t_raw: jnp.ndarray      # (N,) per-point time field (sensor units, epoch-relative)
    valid: jnp.ndarray      # (N,)
    stamp: jnp.ndarray      # () sweep reference time, epoch-relative (usually 0.0)
    epoch_shift: jnp.ndarray  # () this epoch − previous epoch, seconds
    imu_acc: jnp.ndarray    # (K,3) raw accel
    imu_gyro: jnp.ndarray   # (K,3) raw gyro
    imu_stamp: jnp.ndarray  # (K,) epoch-relative seconds
    imu_valid: jnp.ndarray  # (K,)


class DebugOutput(NamedTuple):
    """``cfg.debug``-gated intermediates, mirroring the reference's debug
    publishers (src/main.cpp:198-203, ROSutils.hpp:216-252): the original
    (filtered, pre-deskew) cloud, the deskewed cloud, and the per-match
    plane data behind the match-marker visualizer."""

    orig_points: jnp.ndarray       # (N,3) filtered scan, sensor frame, pre-deskew
    orig_valid: jnp.ndarray        # (N,)
    deskewed: jnp.ndarray          # (N,3) deskewed full-res cloud, Xt2 frame
    deskewed_valid: jnp.ndarray    # (N,)
    match_planes: jnp.ndarray      # (Q,4) fitted plane [n, d] per pc2match point
    match_keep: jnp.ndarray        # (Q,) final gate mask (these formed H)
    match_dist: jnp.ndarray        # (Q,) signed point-to-plane distance at x⁺
    gersh_min: jnp.ndarray         # () min Gershgorin bound on eig(HᵀH[:6,:6])
                                   # (conditioning telemetry; hugely negative
                                   # on ordinary geometry — not a guard signal)
    min_eig: jnp.ndarray           # () exact min eig of HᵀH[:6,:6] over
                                   # iterations (+inf if certified ≥ D)
    guard_fired: jnp.ndarray       # () bool: the degeneracy guard actually
                                   # zeroed directions (min_eig < D)
    n_stale: jnp.ndarray           # () int32: queries whose window re-match
                                   # certificate fails at the posterior
                                   # (each forces the exact re-gather —
                                   # see measurement.stale_mask)


class ScanOutput(NamedTuple):
    pos: jnp.ndarray
    quat: jnp.ndarray
    vel: jnp.ndarray
    final_scan: jnp.ndarray        # (M,3) world-frame registered scan
    final_valid: jnp.ndarray       # (M,)
    scan_body: jnp.ndarray         # (M,3) body(Xt2)-frame pc2match (for loop closure)
    n_iters: jnp.ndarray
    n_deskewed: jnp.ndarray
    n_pc2match: jnp.ndarray
    scan_stamp: jnp.ndarray
    debug: object = None           # DebugOutput when cfg.debug, else None


def init_state(cfg: Config, dtype=None) -> LIOState:
    dtype = dtype or jnp.dtype(cfg.tpu.dtype)
    x = st.identity(dtype, gravity=cfg.gravity)
    R_l2b = jnp.asarray(np.array(cfg.extrinsics.lidar2baselink_R, np.float64)
                        .reshape(3, 3).T, dtype)  # stored transposed (Localizer.cpp:82)
    x = x._replace(
        rot_LI=so3.mat_to_quat(R_l2b),
        t_LI=jnp.asarray(cfg.extrinsics.lidar2baselink_t, dtype),
        bg=jnp.asarray(cfg.intrinsics.gyro_bias, dtype),
        ba=jnp.asarray(cfg.intrinsics.accel_bias, dtype),
    )
    m = mapper.create(cfg.tpu.map_capacity, cfg.map_points_per_voxel, dtype)
    return LIOState(
        x=x,
        P=iekf.init_P(dtype),
        map=m,
        prev_scan_stamp=jnp.asarray(0.0, jnp.float32),
        last_prop_time=jnp.asarray(0.0, jnp.float32),
        last_w_raw_bl=jnp.zeros(3, dtype),
        last_w=jnp.zeros(3, dtype),
        last_a=jnp.zeros(3, dtype),
        bias_gyro_corr=jnp.array(x.bg, copy=True),
        bias_accel_corr=jnp.array(x.ba, copy=True),
        pinned_grav=jnp.array(x.grav, copy=True),
    )


def build_scan_step(cfg: Config, *, donate: bool = True, jit: bool = True,
                    shard_axis: str = None, num_shards: int = 1,
                    query_axis: str = None, num_query_shards: int = 1):
    """Compile the per-scan step for a static config.

    With ``shard_axis`` set, the body is written for `jax.shard_map` over a
    device mesh: the voxel-hash map lives sharded by hash-ownership, kNN
    candidates merge across devices (all_gather in the measurement model), map
    insertion is owner-filtered, and everything else is replicated.
    ``query_axis`` additionally shards the matching work over a second mesh
    axis (HᵀH psum) for throughput scaling; both compose on a 2-D mesh.
    """
    mp_cfg = cfg.ikfom.mapping
    voxel_size = cfg.map_voxel_size
    probes = cfg.tpu.hash_probes
    k = mp_cfg.NUM_MATCH_POINTS
    n_pc2match = mp_cfg.MAX_NUM_PC2MATCH
    dtype = jnp.dtype(cfg.tpu.dtype)

    R_imu2bl = jnp.asarray(
        np.array(cfg.extrinsics.imu2baselink_R, np.float64).reshape(3, 3).T, dtype)
    t_imu2bl = jnp.asarray(cfg.extrinsics.imu2baselink_t, dtype)
    sm = jnp.asarray(np.array(cfg.intrinsics.imu_sm, np.float64).reshape(3, 3), dtype)
    Q = proc.process_noise_Q(cfg.ikfom.cov_gyro, cfg.ikfom.cov_acc,
                             cfg.ikfom.cov_bias_gyro, cfg.ikfom.cov_bias_acc, dtype)

    def scan_step(s: LIOState, b: ScanBatch) -> Tuple[LIOState, ScanOutput]:
        # ---- rebase carried times onto this scan's epoch ----
        s = s._replace(
            prev_scan_stamp=s.prev_scan_stamp - b.epoch_shift,
            last_prop_time=s.last_prop_time - b.epoch_shift,
        )

        # ---- IMU path: baselink transform, intrinsics, batched predict ----
        acc_bl, gyro_bl, dt = preprocess.imu_to_baselink(
            b.imu_acc, b.imu_gyro, b.imu_stamp, s.last_prop_time, s.last_w_raw_bl,
            R_imu2bl=R_imu2bl, t_imu2bl=t_imu2bl)
        acc_c, gyro_c = preprocess.apply_intrinsics(
            acc_bl, gyro_bl, sm, s.bias_accel_corr, s.bias_gyro_corr)

        imu = {"acc": acc_c, "gyro": gyro_c, "dt": dt.astype(dtype),
               "stamp": b.imu_stamp, "valid": b.imu_valid}
        x_t2, P_t2, xs = iekf.predict_scan(s.x, s.P, imu, Q)

        n_imu = jnp.sum(b.imu_valid)
        last_i = jnp.maximum(n_imu - 1, 0)
        imu_stamp_now = jnp.where(n_imu > 0, b.imu_stamp[last_i], s.last_prop_time)

        # ---- scan path: filters, time sort, offset ----
        pts, t_abs, pvalid, scan_end = preprocess.preprocess_scan(
            b.points, b.t_raw, b.valid, b.stamp, imu_stamp_now,
            sensor_type=cfg.sensor_type, end_of_sweep=cfg.end_of_sweep,
            crop_active=cfg.filters.crop_active,
            crop_min=cfg.filters.cropBoxMin, crop_max=cfg.filters.cropBoxMax,
            dist_active=cfg.filters.dist_active, min_dist=cfg.filters.min_dist,
            rate_active=cfg.filters.rate_active, rate_value=cfg.filters.rate_value,
            fov_active=cfg.filters.fov_active, fov_angle=cfg.filters.fov_angle,
            time_offset=cfg.time_offset, time_sort=cfg.tpu.time_sort)

        # ---- deskew into the Xt2 frame ----
        frames = dsk.frames_from_scan(
            s.x, s.last_prop_time, s.last_w, s.last_a, xs, imu)
        p_xt2, _p_world = dsk.deskew(
            pts, t_abs, pvalid, frames, x_t2, x_t2.rot_LI, x_t2.t_LI)

        # ---- voxel-grid downsample (Localizer.cpp:313-321) ----
        if cfg.filters.voxel_active:
            pc_ds, ds_valid = voxel.voxel_downsample(
                p_xt2, pvalid, float(cfg.filters.leafSize[0]))
        else:
            pc_ds, ds_valid = p_xt2, pvalid
        if cfg.tpu.insert_population == "full" and cfg.tpu.max_insert_points:
            pc_ds = pc_ds[:cfg.tpu.max_insert_points]
            ds_valid = ds_valid[:cfg.tpu.max_insert_points]
        # matching reads only the first MAX_NUM_PC2MATCH points — the
        # reference caps MATCHING only (Mapper.cpp:63-69)
        pc2match = pc_ds[:n_pc2match]
        pc2_valid = ds_valid[:n_pc2match]

        # ---- iterated manifold update (re-matching per iteration) ----
        h_closures = measurement.make_h_model(
            s.map, pc2match, pc2_valid,
            voxel_size=voxel_size, k=k, probes=probes,
            max_dist_plane=mp_cfg.MAX_DIST_PLANE,
            plane_threshold=mp_cfg.PLANE_THRESHOLD,
            max_num_matches=mp_cfg.MAX_NUM_MATCHES,
            estimate_extrinsics=cfg.ikfom.estimate_extrinsics,
            shard_axis=shard_axis, num_shards=num_shards,
            query_axis=query_axis, num_query_shards=num_query_shards,
            knn_refresh=cfg.tpu.knn_refresh, x0=x_t2,
            neighborhood=cfg.tpu.knn_neighborhood, with_debug=cfg.debug,
            dynamic_gate=mp_cfg.DYNAMIC_GATE)
        h_stats = h_closures[1]
        upd = iekf.update_iterated(
            x_t2, P_t2, h_stats,
            R=cfg.ikfom.lidar_noise, D=cfg.ikfom.degeneracy_thresh,
            max_iters=cfg.ikfom.MAX_NUM_ITERS, limit=cfg.ikfom.LIMITS,
            with_diag=cfg.debug)
        x_u, P_u, n_iters = upd[:3]
        udiag = upd[3] if cfg.debug else None

        # skip the update entirely when the scan is degenerate/empty
        # (NULL ITERATION, Localizer.cpp:323,379-380)
        do_update = jnp.sum(pc2_valid) > 1
        x_u = jax.tree_util.tree_map(
            lambda a, b_: jnp.where(do_update, a, b_), x_u, x_t2)
        P_u = jnp.where(do_update, P_u, P_t2)

        # ---- register scan & grow the map (Mapper::add) ----
        # "full" (reference-exact): the ENTIRE downsampled cloud is
        # registered and inserted (Localizer.cpp:358-374 transforms pc2match
        # = the full downsampled scan; MAX_NUM_PC2MATCH binds matching only,
        # Mapper.cpp:63-69). "pc2match" caps insertion too — a speed knob.
        if cfg.tpu.insert_population == "full":
            ins_pts, ins_valid = pc_ds, ds_valid
        else:
            ins_pts, ins_valid = pc2match, pc2_valid
        w_scan = so3.quat_rotate(x_u.rot, ins_pts) + x_u.pos
        if shard_axis is None:
            shard_index = 0
        else:
            shard_index = jax.lax.axis_index(shard_axis)
        insert_probes = cfg.tpu.insert_probes or probes
        new_map = mapper.insert(
            s.map, w_scan, ins_valid & do_update,
            voxel_size=voxel_size, probes=insert_probes,
            num_shards=num_shards, shard_index=shard_index)
        if shard_axis is not None:
            # keep num_points a replicated GLOBAL count (psum of shard deltas)
            delta = new_map.num_points - s.map.num_points
            new_map = new_map._replace(
                num_points=s.map.num_points + jax.lax.psum(delta, shard_axis))
        new_map = new_map._replace(last_time=scan_end.astype(jnp.float32))

        # ---- mirror-state bias/gravity pinning (Localizer.cpp:344-346) ----
        bg_corr = s.bias_gyro_corr if cfg.calibrate_gyro else x_u.bg
        ba_corr = s.bias_accel_corr if cfg.calibrate_accel else x_u.ba

        # carry-in data for the next scan's frames
        last_valid = lambda arr, prev: jnp.where(n_imu > 0, arr[last_i], prev)
        s_next = LIOState(
            x=x_u, P=P_u, map=new_map,
            prev_scan_stamp=scan_end,
            last_prop_time=jnp.where(n_imu > 0, b.imu_stamp[last_i],
                                     s.last_prop_time),
            last_w_raw_bl=last_valid(gyro_bl, s.last_w_raw_bl),
            last_w=last_valid(gyro_c, s.last_w),
            last_a=last_valid(acc_c, s.last_a),
            bias_gyro_corr=bg_corr,
            bias_accel_corr=ba_corr,
            pinned_grav=s.pinned_grav,
        )

        # NOTE: the ScanContext descriptor is deliberately NOT computed here
        # — it is only consumed at keyframe ACCEPTANCE (every ~2 m); SLAM
        # computes it on demand from the retained scan_body
        # (build_descriptor_step)
        out = ScanOutput(
            pos=x_u.pos, quat=x_u.rot, vel=x_u.vel,
            final_scan=w_scan, final_valid=ins_valid & do_update,
            scan_body=ins_pts,
            n_iters=n_iters, n_deskewed=jnp.sum(pvalid),
            n_pc2match=jnp.sum(pc2_valid), scan_stamp=scan_end,
        )
        if cfg.debug:
            # gated at trace time: with cfg.debug False none of this is in
            # the program (tests/test_debug.py asserts zero added cost)
            n_abcd, keep, dist, n_stale = h_closures[2](x_u)
            out = out._replace(debug=DebugOutput(
                orig_points=pts, orig_valid=pvalid,
                deskewed=p_xt2, deskewed_valid=pvalid,
                match_planes=n_abcd, match_keep=keep & do_update,
                match_dist=dist,
                gersh_min=udiag["gersh_min"],
                min_eig=udiag["min_eig"],
                guard_fired=udiag["guard_fired"] & do_update,
                n_stale=n_stale))
        return s_next, out

    if jit:
        return jax.jit(scan_step, donate_argnums=(0,) if donate else ())
    return scan_step


def fuse_packs(scan_pack: np.ndarray, imu_pack: np.ndarray) -> np.ndarray:
    """Fuse the per-scan host arrays into ONE flat transfer buffer.

    Every host→device transfer pays a fixed per-call cost regardless of
    size, so the scan rows and the IMU rows ride one buffer: in int16 mode the f32 IMU rows are BIT-CAST onto int16
    pairs (lossless — the device bit-casts them back); in f32 mode it is a
    plain concatenation.  ~130 KB memcpy on the host (~10 µs) buys one
    fewer round-trip per scan.
    """
    if scan_pack.dtype == np.int16:
        out = np.empty(scan_pack.size + imu_pack.size * 2, np.int16)
        out[: scan_pack.size] = scan_pack.ravel()
        out[scan_pack.size:] = np.ascontiguousarray(
            imu_pack, np.float32).ravel().view(np.int16)
        return out
    out = np.empty(scan_pack.size + imu_pack.size, np.float32)
    out[: scan_pack.size] = scan_pack.ravel()
    out[scan_pack.size:] = imu_pack.astype(np.float32).ravel()
    return out


def build_scan_step_packed(cfg: Config, *, donate: bool = True):
    """Transfer-minimal entry point for streaming hosts.

    Every host→device transfer pays a fixed per-call cost regardless of
    size, so the 9 arrays of ``ScanBatch`` ride
    ONE flat buffer (`fuse_packs`) carrying two sections:

    * ``scan_pack`` (N,4) f32 — ``[x, y, z, t_raw]`` rows, zero-padded;
      with ``cfg.tpu.quantize_transfer > 0`` it is (N,4) int16 instead:
      xyz in units of ``quantize_transfer`` metres and t_raw in units of
      ``aux[3]`` (a per-scan scale chosen by the host) — half the payload;
    * ``imu_pack``  (K,8) f32 — ``[acc(3), gyro(3), stamp, aux]`` rows, where
      the ``aux`` column carries the scalars: ``aux[0]=n_pts``,
      ``aux[1]=n_imu``, ``aux[2]=epoch_shift``, ``aux[3]=t_raw scale``
      (counts are exact in f32 — they are bounded by the static shapes,
      far below 2²⁴); bit-cast onto int16 pairs in quantized mode.

    The unfuse/unpack runs inside the jit (free: slices + bitcasts of
    resident buffers).  Semantics are identical to ``build_scan_step`` —
    see ``tests/test_pipeline.py::test_packed_step_matches_unpacked``.
    """
    inner = build_scan_step(cfg, donate=False, jit=False)
    N = cfg.tpu.max_points_per_scan
    K = cfg.tpu.imu_batch
    assert K >= 4, "imu_batch must be >= 4 (aux column carries 4 scalars)"
    quant = float(cfg.tpu.quantize_transfer)

    def packed_step(s: LIOState, pack):
        scan_pack = pack[: N * 4].reshape(N, 4)
        if quant > 0:
            imu_pack = jax.lax.bitcast_convert_type(
                pack[N * 4:].reshape(K, 8, 2), jnp.float32)
        else:
            imu_pack = pack[N * 4:].reshape(K, 8)
        n_pts = imu_pack[0, 7].astype(jnp.int32)
        n_imu = imu_pack[1, 7].astype(jnp.int32)
        epoch_shift = imu_pack[2, 7]
        if quant > 0:
            points = scan_pack[:, :3].astype(jnp.float32) * quant
            t_raw = scan_pack[:, 3].astype(jnp.float32) * imu_pack[3, 7]
        else:
            points = scan_pack[:, :3]
            t_raw = scan_pack[:, 3]
        b = ScanBatch(
            points=points,
            t_raw=t_raw,
            valid=jnp.arange(N) < n_pts,
            stamp=jnp.zeros((), jnp.float32),
            epoch_shift=epoch_shift,
            imu_acc=imu_pack[:, 0:3],
            imu_gyro=imu_pack[:, 3:6],
            imu_stamp=imu_pack[:, 6],
            imu_valid=jnp.arange(K) < n_imu,
        )
        return inner(s, b)

    return jax.jit(packed_step, donate_argnums=(0,) if donate else ())


def build_scan_step_split(cfg: Config, *, donate: bool = True):
    """Two-buffer streaming entry point: scan payload and IMU pack ride
    SEPARATE device arrays.

    Rationale: the scan payload (≥128 KB)
    does not depend on IMU coverage, so the host can start its H2D copy
    the moment the scan ARRIVES — overlapping the transfer with the
    previous scan's device compute — while the tiny (K,8) IMU pack (the
    only coverage-dependent part) uploads at dispatch.  A transfer issued
    right before its dispatch can serialize with the in-flight step; split
    buffers hide the big half in ALL regimes, including strict real-time arrival order where whole-scan
    prefetch never fires (the next scan is not yet covered at dispatch).

    Bit-identical semantics to `build_scan_step_packed` (same unpack; the
    IMU rows skip the int16 bit-cast round-trip, which is lossless) — see
    tests/test_pipeline.py::test_split_step_matches_packed.
    """
    inner = build_scan_step(cfg, donate=False, jit=False)
    N = cfg.tpu.max_points_per_scan
    K = cfg.tpu.imu_batch
    assert K >= 4, "imu_batch must be >= 4 (aux column carries 4 scalars)"
    quant = float(cfg.tpu.quantize_transfer)

    def split_step(s: LIOState, scan_pack, imu_pack):
        scan_pack = scan_pack.reshape(N, 4)
        imu_pack = imu_pack.reshape(K, 8)
        n_pts = imu_pack[0, 7].astype(jnp.int32)
        n_imu = imu_pack[1, 7].astype(jnp.int32)
        epoch_shift = imu_pack[2, 7]
        if quant > 0:
            points = scan_pack[:, :3].astype(jnp.float32) * quant
            t_raw = scan_pack[:, 3].astype(jnp.float32) * imu_pack[3, 7]
        else:
            points = scan_pack[:, :3]
            t_raw = scan_pack[:, 3]
        b = ScanBatch(
            points=points,
            t_raw=t_raw,
            valid=jnp.arange(N) < n_pts,
            stamp=jnp.zeros((), jnp.float32),
            epoch_shift=epoch_shift,
            imu_acc=imu_pack[:, 0:3],
            imu_gyro=imu_pack[:, 3:6],
            imu_stamp=imu_pack[:, 6],
            imu_valid=jnp.arange(K) < n_imu,
        )
        return inner(s, b)

    return jax.jit(split_step, donate_argnums=(0,) if donate else ())


def build_scan_chunk_step(cfg: Config, *, donate: bool = True):
    """Chunked streaming entry point: C scans per jitted dispatch.

    Every dispatch pays a fixed host cost on top of device compute;
    batching ``cfg.tpu.scan_chunk`` scans into
    ONE program amortizes it C-fold at the price of C scan periods of
    latency — an offline/replay-mode knob (real-time deployments keep C=1).

    Inputs are the packed per-scan arrays stacked on a leading chunk axis:
    ``scan_packs (C,N,4)``, ``imu_packs (C,K,8)`` (layout of
    `build_scan_step_packed`), plus one extra aux scalar ``imu_pack[4,7] =
    active`` — inactive padding elements leave the carried state EXACTLY
    unchanged (end-of-stream flush dispatches a partial chunk).

    Returns ``(LIOState', ScanOutput)`` with every output leaf carrying the
    leading chunk axis.  Semantics per element are identical to
    `build_scan_step_packed` — see tests/test_pipeline.py.
    """
    inner = build_scan_step(cfg, donate=False, jit=False)
    N = cfg.tpu.max_points_per_scan
    K = cfg.tpu.imu_batch
    assert K >= 5, "imu_batch must be >= 5 (aux column carries 5 scalars)"
    quant = float(cfg.tpu.quantize_transfer)

    def element(s: LIOState, scan_pack, imu_pack):
        n_pts = imu_pack[0, 7].astype(jnp.int32)
        n_imu = imu_pack[1, 7].astype(jnp.int32)
        epoch_shift = imu_pack[2, 7]
        active = imu_pack[4, 7] > 0
        if quant > 0:
            points = scan_pack[:, :3].astype(jnp.float32) * quant
            t_raw = scan_pack[:, 3].astype(jnp.float32) * imu_pack[3, 7]
        else:
            points = scan_pack[:, :3]
            t_raw = scan_pack[:, 3]
        b = ScanBatch(
            points=points,
            t_raw=t_raw,
            valid=jnp.arange(N) < n_pts,
            stamp=jnp.zeros((), jnp.float32),
            epoch_shift=epoch_shift,
            imu_acc=imu_pack[:, 0:3],
            imu_gyro=imu_pack[:, 3:6],
            imu_stamp=imu_pack[:, 6],
            imu_valid=jnp.arange(K) < n_imu,
        )
        s2, out = inner(s, b)
        # padding elements are a strict no-op on the carry
        s2 = jax.tree_util.tree_map(
            lambda a, b_: jnp.where(active, a, b_), s2, s)
        out = out._replace(
            n_pc2match=jnp.where(active, out.n_pc2match, 0),
            final_valid=out.final_valid & active,
        )
        return s2, out

    def chunk_step(s: LIOState, scan_packs, imu_packs):
        # unrolled: a rolled lax.scan carry blocks in-place buffer reuse of
        # the map table and defeats cross-element fusion; unrolling keeps
        # the one-program-per-chunk dispatch while compiling each element
        # as well as the standalone step
        return jax.lax.scan(
            lambda c, packs: element(c, packs[0], packs[1]),
            s, (scan_packs, imu_packs), unroll=True)

    return jax.jit(chunk_step, donate_argnums=(0,) if donate else ())


def build_descriptor_step(cfg: Config):
    """Jitted ScanContext descriptor of a body-frame scan — called by SLAM
    only at keyframe ACCEPTANCE (sparse), not per scan."""

    @jax.jit
    def descriptor_step(pts, valid):
        return sc.descriptor(
            pts, valid, n_ring=cfg.sc.n_ring, n_sector=cfg.sc.n_sector,
            max_radius=cfg.sc.max_radius, height_shift=cfg.sc.height_shift)

    return descriptor_step


def build_prop_step(cfg: Config):
    """IMU-rate odometry propagation (updateIMU path, Localizer.cpp:401-531).

    The reference publishes world/body odometry + covariances on EVERY IMU
    tick from its predict-only thread (src/main.cpp:78-94); the
    equivalent is this pure jitted function: it reads the scan pipeline's
    carried posterior plus the IMU samples received since, and returns the
    propagated (x, P, stamp, w_raw_bl) WITHOUT touching the carried state —
    the same samples are re-consumed by the next scan_step, so querying
    between scans never perturbs the trajectory.

    ``imu_pack`` has the (K,8) layout of `build_scan_step_packed`
    ([acc(3), gyro(3), stamp, aux]; aux[0] = n_imu); stamps are relative to
    the CURRENT epoch (no rebase — epochs only advance at scan dispatch).
    Batches longer than K chain through repeated calls via the returned
    carries (stamp, w_raw_bl).
    """
    dtype = jnp.dtype(cfg.tpu.dtype)
    K = cfg.tpu.imu_batch
    R_imu2bl = jnp.asarray(
        np.array(cfg.extrinsics.imu2baselink_R, np.float64).reshape(3, 3).T, dtype)
    t_imu2bl = jnp.asarray(cfg.extrinsics.imu2baselink_t, dtype)
    sm = jnp.asarray(np.array(cfg.intrinsics.imu_sm, np.float64).reshape(3, 3), dtype)
    Q = proc.process_noise_Q(cfg.ikfom.cov_gyro, cfg.ikfom.cov_acc,
                             cfg.ikfom.cov_bias_gyro, cfg.ikfom.cov_bias_acc, dtype)

    def prop_step(x, P, last_prop_time, last_w_raw_bl, ba_corr, bg_corr,
                  imu_pack):
        n_imu = imu_pack[0, 7].astype(jnp.int32)
        stamp = imu_pack[:, 6]
        acc_bl, gyro_bl, dt = preprocess.imu_to_baselink(
            imu_pack[:, 0:3], imu_pack[:, 3:6], stamp,
            last_prop_time, last_w_raw_bl,
            R_imu2bl=R_imu2bl, t_imu2bl=t_imu2bl)
        acc_c, gyro_c = preprocess.apply_intrinsics(
            acc_bl, gyro_bl, sm, ba_corr, bg_corr)
        imu = {"acc": acc_c, "gyro": gyro_c, "dt": dt.astype(dtype),
               "stamp": stamp, "valid": jnp.arange(K) < n_imu}
        x2, P2, _xs = iekf.predict_scan(x, P, imu, Q)
        last_i = jnp.maximum(n_imu - 1, 0)
        t2 = jnp.where(n_imu > 0, stamp[last_i], last_prop_time)
        w2 = jnp.where(n_imu > 0, gyro_bl[last_i], last_w_raw_bl)
        # corrected-measurement carries (deskew frame w0/a0 for the next scan)
        wc2 = gyro_c[last_i]
        ac2 = acc_c[last_i]
        return x2, P2, t2, w2, wc2, ac2

    return jax.jit(prop_step)
