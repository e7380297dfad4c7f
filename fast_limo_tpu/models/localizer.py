"""Host-side streaming orchestrator.

The counterpart of `fast_limo::Localizer`'s public surface
(Modules/Localizer.hpp:138-201) minus the ROS glue: it buffers IMU samples,
runs the stand-still IMU calibration procedure (Localizer.cpp:411-509),
decides when a scan is dispatchable (the condition-variable "IMU must cover
the scan end" rule, Localizer.cpp:878-915, turned into a queue check), pads
everything to static shapes, and feeds the jitted `scan_step`.

No singletons — construct as many as you like.  Absolute time lives here in
float64; the device only ever sees float32 offsets from the current scan
epoch (see models/pipeline.py ScanBatch).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from fast_limo_tpu.models import pipeline as pl
from fast_limo_tpu.models import preprocess
from fast_limo_tpu.utils import checkpoint as ckpt
from fast_limo_tpu.utils.config import Config
from fast_limo_tpu.utils.telemetry import Telemetry


@dataclass
class _PendingScan:
    stamp: float
    points: np.ndarray
    t_raw: np.ndarray
    last_pt_time: float
    # split-transfer stash (chunk==1): the scan payload is packed and its
    # H2D copy STARTED at arrival — it has no IMU dependency, so the copy
    # overlaps the previous scan's device compute (build_scan_step_split)
    scan_buf: object = None     # device array (N,4) i16/f32
    t_scale: float = 1.0
    npts: int = 0


class Localizer:
    def __init__(self, cfg: Config, sync_timing: bool = False):
        self.cfg = cfg
        self.sync_timing = sync_timing     # block per scan for exact ms/scan
        self.telemetry = Telemetry()
        self.chunk = max(1, int(cfg.tpu.scan_chunk))
        if self.chunk > 1:
            self.scan_step = pl.build_scan_chunk_step(cfg)
        else:
            self.scan_step = pl.build_scan_step_split(cfg)
        self.state: Optional[pl.LIOState] = None          # device state (after calib)
        self.epoch: Optional[float] = None                # absolute epoch (f64)

        # Stable capture hook (the ONE supported way to observe the exact
        # per-scan device payload): when set, called as
        # ``on_dispatch(scan_pack, imu_pack)`` with the host (N,4) scan rows
        # and (K,8) IMU rows (layout of `pipeline.build_scan_step_packed`)
        # in dispatch order, on EVERY dispatch path — split (chunk==1) and
        # chunked.  Internal refactors of the transfer scheme MUST keep this
        # firing: tests/test_e2e_oracle.py (the f64 oracle) and
        # tests/test_batched.py (fleet equivalence) replay these packs.
        # Consumers must copy arrays they retain.
        self.on_dispatch = None

        self._imu_queue: deque = deque()                  # (stamp, acc, gyro) pending
        self._scan_queue: deque = deque()
        self._newest_imu_stamp: float = -np.inf
        self._last_consumed_stamp: float = -np.inf        # host mirror of last_prop_time
        self._imu_period_est: float = 1.0 / 200.0

        # calibration (Localizer.cpp:411-509)
        self.imu_calibrated = not (cfg.gravity_align or cfg.calibrate_accel
                                   or cfg.calibrate_gyro)
        self._first_imu_stamp: Optional[float] = None
        self._calib_gyro_sum = np.zeros(3)
        self._calib_accel_sum = np.zeros(3)
        self._calib_n = 0
        self.init_quat = np.array([1.0, 0, 0, 0])
        self.init_bg = np.asarray(cfg.intrinsics.gyro_bias, float)
        self.init_ba = np.asarray(cfg.intrinsics.accel_bias, float)

        self._prop_step = None                            # IMU-rate propagate (lazy)
        self._prop_cache: Optional[tuple] = None          # (key, (x, P, abs_t))
        self._raw_outputs: List[tuple] = []               # (epoch|tuple, ScanOutput) device-side
        self._materialized: List[dict] = []               # lazily converted
        self._materialized_entries = 0                    # raw entries converted
        self.last_output = None                           # last ScanOutput (device)
        self.last_output_scans = 0        # active scans in last_output (chunk)
        self._structure_checked = False
        self._scans_since_evict = 0
        self._evict_probe = None          # lagged device num_points scalar
        # rolling-origin eviction policy for bounded map capacity:
        # evict when occupancy crosses the threshold (0 disables)
        self.evict_radius: float = 0.0
        self.evict_occupancy: float = 0.7
        self._R_imu2bl = np.array(cfg.extrinsics.imu2baselink_R, float).reshape(3, 3).T

    # ------------------------------------------------------------------ IMU
    def update_imu(self, stamp: float, acc, gyro) -> None:
        acc = np.asarray(acc, float)
        gyro = np.asarray(gyro, float)
        self.telemetry.imu_tick(stamp)
        if self._first_imu_stamp is None:
            self._first_imu_stamp = stamp
        if self._newest_imu_stamp > -np.inf:
            dtp = stamp - self._newest_imu_stamp
            if 0 < dtp < 0.1:
                self._imu_period_est = dtp
        self._newest_imu_stamp = stamp

        if not self.imu_calibrated:
            if (stamp - self._first_imu_stamp) < self.cfg.imu_calib_time:
                # accumulate in the baselink frame (imu2baselink then average)
                self._calib_gyro_sum += self._R_imu2bl @ gyro
                self._calib_accel_sum += self._R_imu2bl @ acc
                self._calib_n += 1
                return
            self._finish_calibration()

        self._imu_queue.append((stamp, acc, gyro))
        self._drain()

    def _finish_calibration(self) -> None:
        """Gravity alignment & bias averaging (Localizer.cpp:437-509)."""
        n = max(self._calib_n, 1)
        gyro_avg = self._calib_gyro_sum / n
        accel_avg = self._calib_accel_sum / n
        grav_vec = np.array([0.0, 0.0, self.cfg.gravity])

        if self.cfg.gravity_align:
            gv = accel_avg - self.init_ba
            grav_vec = gv / np.linalg.norm(gv) * abs(self.cfg.gravity)
            # quaternion rotating measured gravity onto +z·g (FromTwoVectors)
            a, b = grav_vec, np.array([0.0, 0.0, self.cfg.gravity])
            v = np.cross(a, b)
            w = np.linalg.norm(a) * np.linalg.norm(b) + a @ b
            q = np.concatenate([[w], v])
            self.init_quat = q / np.linalg.norm(q)
        if self.cfg.calibrate_accel:
            self.init_ba = accel_avg - grav_vec
        if self.cfg.calibrate_gyro:
            self.init_bg = gyro_avg

        self.imu_calibrated = True

    # ------------------------------------------------------------------ scan
    def update_pointcloud(self, points, t_raw, stamp: float) -> None:
        """Queue a scan; dispatched once IMU coverage reaches its end time."""
        if not self.imu_calibrated:
            return
        if not self._structure_checked:  # once, like ROSutils.hpp:152 static
            from fast_limo_tpu.utils import validation
            validation.check_pointcloud(points, t_raw, self.cfg.sensor_type, stamp)
            self._structure_checked = True
        points = np.ascontiguousarray(points, np.float32)
        t64 = np.asarray(t_raw, np.float64)
        t_abs = preprocess.extract_point_times(
            t64, stamp, self.cfg.sensor_type, self.cfg.end_of_sweep)
        last_pt = float(np.max(t_abs)) if len(t_abs) else stamp
        # Absolute-time sensors (HESAI abs-s / LIVOX abs-ns) must be rebased
        # to this scan's epoch IN f64, BEFORE the f32 cast: the device sees
        # only epoch-relative times (ScanBatch docstring), and f32 cannot
        # even represent epoch-scale stamps (eps(1.7e9 s) ≈ 256 s).
        if self.cfg.sensor_type == preprocess.HESAI:
            t64 = t64 - stamp
        elif self.cfg.sensor_type == preprocess.LIVOX:
            t64 = t64 - stamp * 1e9
        t_raw32 = np.ascontiguousarray(t64, np.float32)
        scan = _PendingScan(stamp, points, t_raw32, last_pt)
        if self.chunk == 1:
            # start the payload H2D copy NOW (async): it overlaps whatever
            # scan is currently in flight on the device — a copy issued at
            # dispatch time instead can serialize with it
            sp, scan.t_scale, scan.npts = self._pack_points(scan)
            scan.scan_buf = jnp.asarray(sp)
        self._scan_queue.append(scan)
        self._drain()

    # ------------------------------------------------------------------ core
    def _drain(self) -> None:
        while self._scan_queue:
            scan = self._scan_queue[0]
            cover = scan.last_pt_time  # need an IMU sample at/after scan end
            if self._newest_imu_stamp < cover:
                return
            if self.chunk > 1:
                # chunked mode: dispatch only once a FULL chunk is covered
                # (flush() handles end-of-stream partials)
                if len(self._scan_queue) < self.chunk:
                    return
                if self._newest_imu_stamp < self._scan_queue[self.chunk - 1].last_pt_time:
                    return
                scans = [self._scan_queue.popleft() for _ in range(self.chunk)]
                self._dispatch_chunk(scans)
                continue
            self._scan_queue.popleft()
            self._dispatch(scan)

    def flush(self) -> None:
        """Dispatch any covered-but-unchunked scans (end of stream)."""
        while self._scan_queue and self.chunk > 1:
            scans = []
            while (self._scan_queue and len(scans) < self.chunk
                   and self._newest_imu_stamp >= self._scan_queue[0].last_pt_time):
                scans.append(self._scan_queue.popleft())
            if not scans:
                return
            self._dispatch_chunk(scans)

    def _pack_points(self, scan: _PendingScan):
        """Scan payload half of the pack: no IMU/epoch dependency, so it
        can run (and its H2D copy start) the moment the scan arrives.
        Returns (scan_pack (N,4) host array, t_scale, npts)."""
        cfg = self.cfg
        N = cfg.tpu.max_points_per_scan
        npts = len(scan.points)
        if npts > N:
            # uniform stride-downsample overflowing scans (static-shape cap)
            sel = np.linspace(0, npts - 1, N).astype(np.int64)
            pts, traw = scan.points[sel], scan.t_raw[sel]
            npts = N
        else:
            pts, traw = scan.points, scan.t_raw

        quant = float(cfg.tpu.quantize_transfer)
        t_scale = 1.0
        if quant > 0:
            # native one-pass quantizer (csrc/fastlimo_host.cpp) — the NumPy
            # chain below is several passes over the scan; the C path one
            from fast_limo_tpu.io import native

            packed = native.pack_scan_i16(
                np.ascontiguousarray(pts, np.float32),
                np.ascontiguousarray(traw, np.float32), N, quant)
            if packed is not None:
                scan_pack, t_scale, _n = packed
            else:
                # bit-identical NumPy twin (cross-host deterministic replay)
                scan_pack, t_scale, _n = native.pack_scan_i16_numpy(
                    np.ascontiguousarray(pts, np.float32),
                    np.ascontiguousarray(traw, np.float32), N, quant)
        else:
            scan_pack = np.zeros((N, 4), np.float32)
            scan_pack[:npts, :3] = pts
            scan_pack[:npts, 3] = traw
        return scan_pack, t_scale, npts

    def _pack_imu(self, scan: _PendingScan, t_scale: float, npts: int):
        """IMU half of the pack: consumes the IMU queue and advances the
        epoch — must run in dispatch order.  Returns imu_pack (K,8)."""
        cfg = self.cfg
        # IMU batch: every pending sample up to (incl.) the first one ≥ scan end
        batch = []
        while self._imu_queue:
            batch.append(self._imu_queue.popleft())
            if batch[-1][0] >= scan.last_pt_time:
                break
        if batch:
            self._last_consumed_stamp = batch[-1][0]

        K = cfg.tpu.imu_batch
        if len(batch) > K:
            # Overflow (e.g. the post-calibration backlog lands entirely in
            # the first scan): pre-integrate the oldest samples into the
            # carried state via the prop step. Correct as long as the scan's
            # SWEEP window is covered by the last K samples — points only
            # deskew against frames inside the sweep (~0.1 s), while the
            # overflow precedes it.
            overflow, batch = batch[:-K], batch[-K:]
            if batch[0][0] < scan.stamp - 0.5:
                print(f"[fast_limo_tpu] IMU overflow: {len(overflow)} samples "
                      f"pre-integrated; sweep coverage starts {scan.stamp - batch[0][0]:.2f}s "
                      "before the scan stamp — consider raising tpu.imu_batch")
            self._consume_imu_overflow(overflow)

        new_epoch = scan.stamp
        epoch_shift = 0.0 if self.epoch is None else new_epoch - self.epoch
        self.epoch = new_epoch

        imu_pack = np.zeros((K, 8), np.float32)
        for i, (s, a, g) in enumerate(batch):
            imu_pack[i, 0:3] = a
            imu_pack[i, 3:6] = g
            imu_pack[i, 6] = s - new_epoch
        imu_pack[0, 7] = npts
        imu_pack[1, 7] = len(batch)
        imu_pack[2, 7] = epoch_shift
        imu_pack[3, 7] = t_scale
        imu_pack[4, 7] = 1.0    # active (only read by the chunked step)
        return imu_pack

    def _pack_scan(self, scan: _PendingScan):
        """(scan_pack (N,4), imu_pack (K,8)) for one scan; advances queues
        and the epoch (see build_scan_step_packed for the layout).  The
        chunked path and replay probes use this fused form; the chunk==1
        streaming path splits it (`_pack_points` at arrival,
        `_pack_imu` at dispatch)."""
        scan_pack, t_scale, npts = self._pack_points(scan)
        imu_pack = self._pack_imu(scan, t_scale, npts)
        return scan_pack, imu_pack

    def _consume_imu_overflow(self, samples) -> None:
        """Fold IMU samples into the carried device state (predict-only).

        Uses the same jitted prop step as IMU-rate odometry, but COMMITS the
        result into ``self.state`` (stamps relative to the CURRENT epoch —
        call before the epoch advances)."""
        if not samples:
            return
        if self._prop_step is None:
            self._prop_step = pl.build_prop_step(self.cfg)
        K = self.cfg.tpu.imu_batch
        s = self.state
        x, P = s.x, s.P
        t_rel, w_raw = s.last_prop_time, s.last_w_raw_bl
        wc, ac = s.last_w, s.last_a
        for i0 in range(0, len(samples), K):
            chunk = samples[i0:i0 + K]
            pack = np.zeros((K, 8), np.float32)
            for i, (ts, a, g) in enumerate(chunk):
                pack[i, 0:3] = a
                pack[i, 3:6] = g
                pack[i, 6] = ts - self.epoch
            pack[0, 7] = len(chunk)
            x, P, t_rel, w_raw, wc, ac = self._prop_step(
                x, P, t_rel, w_raw, s.bias_accel_corr, s.bias_gyro_corr,
                jnp.asarray(pack))
        self.state = s._replace(x=x, P=P, last_prop_time=t_rel,
                                last_w_raw_bl=w_raw, last_w=wc, last_a=ac)
        self._last_consumed_stamp = samples[-1][0]
        self._prop_cache = None

    def _dispatch(self, scan: _PendingScan) -> None:
        if self.state is None:
            self._init_device_state(scan.stamp)
        elif self.epoch is None:   # loaded session with a fresh clock
            self._anchor_epoch(scan.stamp)

        # split transfer: the payload buffer has been copying since the
        # scan ARRIVED (update_pointcloud); only the tiny coverage-
        # dependent (K,8) IMU pack uploads here
        if scan.scan_buf is None:      # e.g. scans queued before a reset
            sp, scan.t_scale, scan.npts = self._pack_points(scan)
            scan.scan_buf = jnp.asarray(sp)
        imu_pack = self._pack_imu(scan, scan.t_scale, scan.npts)
        if self.on_dispatch is not None:
            # host copy of the payload buffer: exactly what the device sees
            self.on_dispatch(np.asarray(scan.scan_buf), imu_pack)

        self.telemetry.scan_begin()
        self.state, out = self.scan_step(
            self.state, scan.scan_buf, jnp.asarray(imu_pack))
        self._maybe_evict(out.pos)
        if self.sync_timing:
            import jax
            jax.block_until_ready(out)
        self.telemetry.scan_end(scan.stamp)
        self.last_output = out
        self.last_output_scans = 1
        # defer device→host transfer: forcing out.* here would sync the
        # host with the device every scan
        self._raw_outputs.append((self.epoch, out))
        self._bound_retention()

    def _dispatch_chunk(self, scans: List[_PendingScan]) -> None:
        """One jitted dispatch covering len(scans) ≤ chunk scans."""
        cfg = self.cfg
        if self.state is None:
            self._init_device_state(scans[0].stamp)
        elif self.epoch is None:
            self._anchor_epoch(scans[0].stamp)

        C = self.chunk
        N = cfg.tpu.max_points_per_scan
        K = cfg.tpu.imu_batch
        sdtype = np.int16 if cfg.tpu.quantize_transfer > 0 else np.float32
        scan_packs = np.zeros((C, N, 4), sdtype)
        imu_packs = np.zeros((C, K, 8), np.float32)
        epochs = []
        for i, scan in enumerate(scans):
            scan_packs[i], imu_packs[i] = self._pack_scan(scan)
            epochs.append(self.epoch)
            if self.on_dispatch is not None:
                self.on_dispatch(scan_packs[i], imu_packs[i])

        self.telemetry.scan_begin()
        self.state, out = self.scan_step(
            self.state, jnp.asarray(scan_packs), jnp.asarray(imu_packs))
        self._maybe_evict(out.pos[len(scans) - 1])
        if self.sync_timing:
            import jax
            jax.block_until_ready(out)
        for scan in scans:
            self.telemetry.scan_end(scan.stamp)
        self.last_output = out
        self.last_output_scans = len(scans)
        # chunked entry: (tuple of epochs, stacked outputs)
        self._raw_outputs.append((tuple(epochs), out))
        self._bound_retention()

    def _bound_retention(self) -> None:
        # bound device-side retention: scans further back than the window are
        # long computed, so materializing them is a pure transfer, no stall
        if len(self._raw_outputs) - self._materialized_entries > 64:
            self._materialize_upto(len(self._raw_outputs) - 32)

    def _maybe_evict(self, pos) -> None:
        """Rolling-origin map eviction for long sequences (UTBM-scale runs).

        When the hash table fills past ``evict_occupancy``, voxels beyond
        ``evict_radius`` of the current position are freed (the octree in
        the reference simply grows unboundedly)."""
        if self.evict_radius <= 0:
            return
        self._scans_since_evict += 1
        if self._scans_since_evict < 16:   # cheap cadence: check every 16 scans
            return
        self._scans_since_evict = 0
        # Read the occupancy PROBE saved at the previous cadence mark (16
        # scans back): that scalar is long computed, so int() is a cheap
        # transfer — reading the CURRENT num_points here would block on the
        # scan step just dispatched (a hot-path device sync, the same stall
        # class _bound_retention avoids). The decision lags one cadence
        # (16 scans ≈ 1.6 s); evict_occupancy leaves headroom for that.
        # jnp.copy: the state pytree is DONATED to the next scan step, so a
        # bare reference to its num_points leaf would be a deleted buffer
        # by the time the next cadence mark reads it (async copy, no sync)
        probe, self._evict_probe = self._evict_probe, jnp.copy(
            self.state.map.num_points)
        if probe is None:
            return
        cap = self.cfg.tpu.map_capacity * self.cfg.map_points_per_voxel
        if int(probe) < self.evict_occupancy * cap:
            return
        from fast_limo_tpu.models import mapper
        new_map = mapper.evict_far(self.state.map, pos, self.evict_radius,
                                   voxel_size=self.cfg.map_voxel_size)
        self.state = self.state._replace(map=new_map)
        # the snapshot above predates the eviction — drop it so the next
        # cadence check probes POST-eviction occupancy (ADVICE r2)
        self._evict_probe = None

    def _init_device_state(self, first_stamp: float) -> None:
        cfg = self.cfg
        s = pl.init_state(cfg)
        dtype = s.x.pos.dtype
        x = s.x._replace(
            rot=jnp.asarray(self.init_quat, dtype),
            bg=jnp.asarray(self.init_bg, dtype),
            ba=jnp.asarray(self.init_ba, dtype),
        )
        # carried times are epoch-relative; first epoch == first scan stamp
        prev_time = (self._imu_queue[0][0] - first_stamp - self._imu_period_est
                     if self._imu_queue else -self._imu_period_est)
        self.state = s._replace(
            x=x,
            last_prop_time=jnp.asarray(prev_time, jnp.float32),
            bias_gyro_corr=jnp.array(x.bg, copy=True),
            bias_accel_corr=jnp.array(x.ba, copy=True),
            pinned_grav=jnp.array(x.grav, copy=True),
        )
        self.epoch = first_stamp

    # ------------------------------------------------------------------ query
    def _materialize_upto(self, n: int) -> None:
        start = self._materialized_entries
        if start >= n:
            return
        # ONE batched device→host fetch for the whole backlog: per-field
        # np.asarray pays one device round trip EACH.  jax.device_get of the
        # collected pytree drains everything in a single request.
        pend = self._raw_outputs[start:n]
        fetched = jax.device_get(
            [(o.scan_stamp, o.pos, o.quat, o.vel, o.n_iters, o.n_pc2match)
             for (_, o) in pend])
        for (epoch, _), (sstamp, pos, quat, vel, n_it, n_pc) in zip(pend, fetched):
            if isinstance(epoch, tuple):   # chunked entry: one dict per element
                for i, ep in enumerate(epoch):
                    self._materialized.append({
                        "stamp": ep + float(sstamp[i]),
                        "pos": np.asarray(pos[i]),
                        "quat": np.asarray(quat[i]),
                        "vel": np.asarray(vel[i]),
                        "n_iters": int(n_it[i]),
                        "n_pc2match": int(n_pc[i]),
                    })
            else:
                self._materialized.append({
                    "stamp": epoch + float(sstamp),
                    "pos": np.asarray(pos),
                    "quat": np.asarray(quat),
                    "vel": np.asarray(vel),
                    "n_iters": int(n_it),
                    "n_pc2match": int(n_pc),
                })
        for idx in range(start, n):
            epoch, _ = self._raw_outputs[idx]
            self._raw_outputs[idx] = (epoch, None)  # release device arrays
        self._materialized_entries = n

    @property
    def trajectory(self) -> List[dict]:
        """Per-scan outputs as host dicts (materialized on first access)."""
        self._materialize_upto(len(self._raw_outputs))
        return self._materialized

    def positions(self) -> np.ndarray:
        return np.array([t["pos"] for t in self.trajectory])

    def stamps(self) -> np.ndarray:
        return np.array([t["stamp"] for t in self.trajectory])

    def _propagated(self):
        """(x, P, abs_time) propagated through every IMU sample received
        since the last scan dispatch — the IMU-rate odometry state the
        reference's predict thread publishes per tick (updateIMU →
        propagateImu → getWorldState, Localizer.cpp:401-531, main.cpp:78-94).

        Pure read: the queued samples stay queued (the next scan_step
        re-consumes them), so querying never perturbs the trajectory.
        Returns None when there is nothing fresher than the carried state.
        One small jitted dispatch per (new-data) query; cached otherwise."""
        if self.state is None or self.epoch is None or not self._imu_queue:
            return None
        key = (len(self._raw_outputs), len(self._imu_queue),
               self._newest_imu_stamp)
        if self._prop_cache is not None and self._prop_cache[0] == key:
            return self._prop_cache[1]
        if self._prop_step is None:
            self._prop_step = pl.build_prop_step(self.cfg)

        K = self.cfg.tpu.imu_batch
        s = self.state
        x, P = s.x, s.P
        t_rel, w_raw = s.last_prop_time, s.last_w_raw_bl
        # host mirror of last_prop_time avoids forcing the (possibly still
        # computing) carried device scalar
        pend = [p for p in self._imu_queue if p[0] > self._last_consumed_stamp]
        if not pend:
            return None
        for i0 in range(0, len(pend), K):
            chunk = pend[i0:i0 + K]
            pack = np.zeros((K, 8), np.float32)
            for i, (ts, a, g) in enumerate(chunk):
                pack[i, 0:3] = a
                pack[i, 3:6] = g
                pack[i, 6] = ts - self.epoch
            pack[0, 7] = len(chunk)
            x, P, t_rel, w_raw, _wc, _ac = self._prop_step(
                x, P, t_rel, w_raw, s.bias_accel_corr, s.bias_gyro_corr,
                jnp.asarray(pack))
        result = (x, P, self.epoch + float(t_rel))
        self._prop_cache = (key, result)
        return result

    def _query_xP(self):
        """(x, P, abs_time) — IMU-rate fresh when post-scan samples exist."""
        prop = self._propagated()
        if prop is not None:
            return prop
        return (self.state.x, self.state.P,
                (self.epoch or 0.0) + float(self.state.last_prop_time))

    def get_world_state(self) -> dict:
        """World-frame state (getWorldState, Localizer.cpp:175-189):
        velocity expressed in the body frame, like the reference. Fresh at
        IMU rate — propagated through samples received since the last scan."""
        if self.state is None:
            return {}
        from fast_limo_tpu.ops import so3
        x, _P, t = self._query_xP()
        v_body = so3.quat_rotate(so3.quat_conj(x.rot), x.vel)
        return {
            "pos": np.asarray(x.pos), "quat": np.asarray(x.rot),
            "vel_body": np.asarray(v_body),
            "bg": np.asarray(x.bg), "ba": np.asarray(x.ba),
            "grav": np.asarray(x.grav),
            "time": t,
        }

    def get_body_state(self) -> dict:
        """Body(LiDAR)-frame state (getBodyState, Localizer.cpp:158-173):
        pose composed with the estimated extrinsics."""
        out = self.get_world_state()
        if not out:
            return out
        from fast_limo_tpu.ops import so3
        x, _P, _t = self._query_xP()
        out["pos"] = np.asarray(x.pos + x.t_LI)
        out["quat"] = np.asarray(so3.quat_mul(x.rot, x.rot_LI))
        return out

    def get_pose_covariance(self) -> np.ndarray:
        """6×6 pose covariance, position-first like ROS odometry
        (getPoseCovariance, Localizer.cpp:209-224 swaps the rot/pos blocks)."""
        if self.state is None:
            return np.zeros((6, 6))
        P = np.asarray(self._query_xP()[1])
        out = np.zeros((6, 6))
        out[0:3, 0:3] = P[0:3, 0:3]       # filter layout: pos first already
        out[0:3, 3:6] = P[0:3, 3:6]
        out[3:6, 0:3] = P[3:6, 0:3]
        out[3:6, 3:6] = P[3:6, 3:6]
        return out

    def get_twist_covariance(self) -> np.ndarray:
        """6×6 twist covariance (getTwistCovariance, Localizer.cpp:226-239):
        linear block from the filter, angular block = gyro noise."""
        if self.state is None:
            return np.zeros((6, 6))
        P = np.asarray(self._query_xP()[1])
        out = np.zeros((6, 6))
        out[0:3, 0:3] = P[12:15, 12:15]
        out[3:6, 3:6] = np.eye(3) * self.cfg.ikfom.cov_gyro
        return out

    def board(self) -> str:
        info = {}
        if self.trajectory:
            t = self.trajectory[-1]
            info = {"pos": t["pos"], "quat": t["quat"], "vel": t["vel"],
                    "n_pc2match": t["n_pc2match"]}
        if self.state is not None:
            x = self.state.x
            info.update(bg=np.asarray(x.bg), ba=np.asarray(x.ba),
                        grav=np.asarray(x.grav),
                        map_points=int(self.state.map.num_points))
        return self.telemetry.board(info)

    # ------------------------------------------------------------------ persistence
    def save_checkpoint(self, path: str) -> None:
        """Persist the full SLAM state (filter + map + carries)."""
        if self.state is None:
            raise RuntimeError("nothing to checkpoint yet")
        from fast_limo_tpu.models import mapper
        ckpt.save_state(path, self.state, extra={
            "map_layout": mapper.layout_version(self.cfg.map_points_per_voxel),
            "epoch": self.epoch,
            "imu_calibrated": self.imu_calibrated,
            "init_bg": self.init_bg.tolist(),
            "init_ba": self.init_ba.tolist(),
            "init_quat": self.init_quat.tolist(),
        })

    def load_checkpoint(self, path: str, reset_clock: bool = False) -> None:
        """Resume from a checkpoint (continues mapping/localizing in it).

        ``reset_clock=True`` for multi-session use: the new run's timestamps
        are unrelated to the saved ones, so the carried device times and
        epoch restart from the next incoming scan."""
        template = self.state if self.state is not None else pl.init_state(self.cfg)
        self.state = ckpt.load_state(path, template)
        extra = ckpt.load_extra(path)
        from fast_limo_tpu.models import mapper
        want = mapper.layout_version(self.cfg.map_points_per_voxel)
        got = extra.get("map_layout")
        if got is not None and got != want:
            raise ValueError(
                f"checkpoint map layout {got!r} != current {want!r} — "
                "this checkpoint was written by an incompatible table layout")
        # The planar mirror is a pure derivation of the entry-major table:
        # rebuild it unconditionally so even a stamp-less (pre-round-5)
        # checkpoint from an older lane layout resumes with a correct kNN
        # mirror instead of a lane-scrambled one (ADVICE r4, medium).
        m = self.state.map
        self.state = self.state._replace(map=m._replace(
            ptable=mapper._planarize(m.table, m.bucket)))
        self.epoch = extra.get("epoch")
        self.imu_calibrated = bool(extra.get("imu_calibrated", True))
        self.init_bg = np.asarray(extra.get("init_bg", self.init_bg))
        self.init_ba = np.asarray(extra.get("init_ba", self.init_ba))
        self.init_quat = np.asarray(extra.get("init_quat", self.init_quat))
        if reset_clock:
            self.reset_clock()

    def reset_clock(self) -> None:
        """Restart the time base (new session): epoch re-anchors on the next
        scan; device time carries and sensor queues are cleared."""
        import jax.numpy as jnp

        self.epoch = None
        self._imu_queue.clear()
        self._scan_queue.clear()
        self._newest_imu_stamp = -np.inf
        self._last_consumed_stamp = -np.inf
        self._prop_cache = None
        self._first_imu_stamp = None
        if self.state is not None:
            self.state = self.state._replace(
                prev_scan_stamp=jnp.asarray(0.0, jnp.float32),
                last_prop_time=jnp.asarray(0.0, jnp.float32),
            )

    def _anchor_epoch(self, first_stamp: float) -> None:
        """Re-anchor the epoch for a loaded session (first scan of a new run)."""
        import jax.numpy as jnp

        prev_time = (self._imu_queue[0][0] - first_stamp - self._imu_period_est
                     if self._imu_queue else -self._imu_period_est)
        self.state = self.state._replace(
            last_prop_time=jnp.asarray(prev_time, jnp.float32))
        self.epoch = first_stamp
