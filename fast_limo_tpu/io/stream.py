"""Reference-style asynchronous sensor ingestion.

The reference runs its two sensor callbacks on a ROS ``AsyncSpinner(0)``
thread pool with mutex/condvar handoff into the filter (src/main.cpp:209,
Localizer.cpp:326,596-605,882-889): an IMU callback must NEVER block on a
scan update.  The counterpart here is this ingestion layer: producer
threads ``push_imu``/``push_scan`` and return immediately — IMU records ride
the lock-free C SPSC ring (csrc/fastlimo_host.cpp, 56-byte records), scans a
thread-safe queue — while ONE dispatch thread drains both into the engine in
stamp order.

Because the engine's scan dispatch is gated purely on IMU time coverage
("IMU must cover the scan end", models/localizer.py:_drain), the replay is
independent of producer/consumer interleaving: the async trajectory equals
the synchronous one exactly (tests/test_stream.py).
"""

from __future__ import annotations

import queue
import struct
import threading
from collections import deque
from typing import Optional

import numpy as np

_IMU_FMT = "<7d"                      # stamp, acc[3], gyro[3]
_IMU_SIZE = struct.calcsize(_IMU_FMT)


class AsyncIngest:
    """Non-blocking sensor intake feeding a Localizer/SLAM engine.

    ``engine`` needs ``update_imu(stamp, acc, gyro)`` and
    ``update_pointcloud(points, t_raw, stamp)`` — both `Localizer` and
    `SLAM` qualify.  Call ``push_*`` from any single producer thread
    (one producer per stream, like one ROS callback queue per topic);
    ``close()`` drains everything and joins the dispatch thread.
    """

    def __init__(self, engine, imu_capacity: int = 8192):
        self.engine = engine
        self._imu_ring = None
        self._imu_fallback: deque = deque()   # lock-free enough: single producer
        try:
            from fast_limo_tpu.io.native import SPSCRing

            self._imu_ring = SPSCRing(imu_capacity, _IMU_SIZE)
        except RuntimeError:
            pass                               # no toolchain: deque fallback
        self._scans: queue.Queue = queue.Queue()
        self._gps: queue.Queue = queue.Queue()
        # serializes engine access: dispatch-thread updates vs caller-thread
        # queries (the reference's mtx_ikfom, Modules/Localizer.hpp:41)
        self._engine_lock = threading.RLock()
        self._stop = threading.Event()
        self._wake = threading.Event()
        self.imu_dropped = 0                   # ring-full events (overrun)
        self.error: Optional[BaseException] = None  # engine failure in _run
        self._idle = threading.Event()         # dispatch thread between drains
        self._idle.set()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="fast_limo_tpu-dispatch")
        self._thread.start()

    # ------------------------------------------------------------- producers
    def push_imu(self, stamp: float, acc, gyro) -> None:
        """IMU callback: O(56-byte copy), never blocks on the filter."""
        if self._imu_ring is not None:
            rec = struct.pack(_IMU_FMT, float(stamp), *map(float, acc),
                              *map(float, gyro))
            if not self._imu_ring.push(rec):
                self.imu_dropped += 1          # overrun: consumer stalled
        else:
            self._imu_fallback.append(
                (float(stamp), np.asarray(acc, float), np.asarray(gyro, float)))
        self._wake.set()

    def push_scan(self, points, t_raw, stamp: float) -> None:
        """LiDAR callback: hands the arrays off, never blocks on the filter."""
        self._scans.put((np.asarray(points), np.asarray(t_raw), float(stamp)))
        self._wake.set()

    def push_gps(self, stamp: float, pos, weight=None) -> None:
        """GPS callback: queued; dispatched to ``engine.update_gps`` when the
        engine has one (SLAM), silently dropped otherwise (odometry) — the
        same contract as io/generic.run_sequence."""
        self._gps.put((float(stamp), np.asarray(pos, float), weight))
        self._wake.set()

    # engine-facade aliases: an AsyncIngest can stand in anywhere a
    # Localizer/SLAM is fed (e.g. generic.run_sequence(AsyncIngest(slam), …))
    update_imu = push_imu
    update_pointcloud = push_scan
    update_gps = push_gps

    def get_world_state(self) -> dict:
        """IMU-rate odometry query from ANY thread, serialized against the
        dispatch thread's engine updates (getWorldState at IMU rate — the
        reference publishes it per tick under mtx_ikfom, main.cpp:78-94)."""
        with self._engine_lock:
            return self.engine.get_world_state()

    def get_body_state(self) -> dict:
        with self._engine_lock:
            return self.engine.get_body_state()

    def flush(self) -> None:
        """Block until every queued record has been dispatched AND the
        dispatch thread is idle, then flush the engine (end-of-stream
        partial chunks).  The dispatch thread stays alive — unlike close().

        Records are popped BEFORE their engine call runs, so an empty
        queue alone does not mean the engine is quiescent — the idle flag
        closes that window, and the engine lock serializes engine.flush()
        against any dispatch that slips in after it."""
        while ((len(self) or not self._idle.is_set())
               and self._thread.is_alive()):
            self._wake.set()
            self._thread.join(timeout=0.01)
        if self.error is not None:
            raise RuntimeError("AsyncIngest dispatch thread failed") \
                from self.error
        flush = getattr(self.engine, "flush", None)
        if flush is not None:
            with self._engine_lock:
                flush()

    # -------------------------------------------------------------- consumer
    def _drain_imu(self) -> bool:
        got = False
        if self._imu_ring is not None:
            while True:
                rec = self._imu_ring.pop()
                if rec is None:
                    break
                v = struct.unpack(_IMU_FMT, rec)
                with self._engine_lock:
                    self.engine.update_imu(v[0], np.asarray(v[1:4]),
                                           np.asarray(v[4:7]))
                got = True
        else:
            while self._imu_fallback:
                s, a, g = self._imu_fallback.popleft()
                with self._engine_lock:
                    self.engine.update_imu(s, a, g)
                got = True
        return got

    def _drain_scans(self) -> bool:
        got = False
        while True:
            try:
                pts, traw, stamp = self._scans.get_nowait()
            except queue.Empty:
                break
            with self._engine_lock:
                self.engine.update_pointcloud(pts, traw, stamp)
            got = True
        return got

    def _drain_gps(self) -> bool:
        got = False
        gps_fn = getattr(self.engine, "update_gps", None)
        while True:
            try:
                stamp, pos, w = self._gps.get_nowait()
            except queue.Empty:
                break
            got = True
            if gps_fn is not None:
                with self._engine_lock:
                    gps_fn(stamp, pos, weight=w)
        return got

    def _run(self) -> None:
        while not self._stop.is_set():
            # IMU first each cycle: scans dispatch only once covered anyway,
            # and fresher IMU lets a queued scan go out this cycle
            try:
                self._idle.clear()
                any_work = self._drain_imu()
                any_work |= self._drain_gps()
                any_work |= self._drain_scans()
            except BaseException as e:   # record engine failure, stop draining
                self.error = e
                self._idle.set()
                return
            if not any_work:
                self._idle.set()
                self._wake.wait(timeout=0.002)
                self._wake.clear()

    def close(self) -> None:
        """Drain outstanding records, stop the dispatch thread.

        Raises the engine exception if the dispatch thread died on one
        (otherwise a failed run would silently return a truncated
        trajectory), and refuses the caller-thread final drain while the
        dispatch thread is still alive — two concurrent consumers would
        corrupt the single-consumer SPSC ring (ADVICE r2)."""
        while len(self) and self._thread.is_alive():
            self._wake.set()
            self._thread.join(timeout=0.01)
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=5.0)
        if self._thread.is_alive():
            raise RuntimeError(
                "AsyncIngest dispatch thread did not stop within 5 s; "
                f"{len(self)} records left undrained (engine wedged?)")
        if self.error is not None:
            raise RuntimeError("AsyncIngest dispatch thread failed") \
                from self.error
        # final drain on the caller's thread (thread exited mid-queue)
        self._drain_imu()
        self._drain_gps()
        self._drain_scans()

    def __len__(self) -> int:
        n = len(self._scans.queue) + len(self._gps.queue)
        n += len(self._imu_ring) if self._imu_ring is not None \
            else len(self._imu_fallback)
        return n

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
