#!/usr/bin/env python
"""How often does the window re-match certificate fail?

Replays a bench-like synthetic sequence with cfg.debug=True and reports the
per-scan ``n_stale`` telemetry (queries whose staleness certificate fails
at the posterior — each such query forces the per-query re-gather, and
more than the budget a full re-gather).

Usage: python tools/probe_stale_rate.py [n_scans] [n_points]
(runs on the CPU unless STALE_PROBE_DEVICE=1 — staleness is geometry and
motion, not hardware)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

if os.environ.get("STALE_PROBE_DEVICE", "") != "1":
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from fast_limo_tpu.io import synthetic  # noqa: E402
from fast_limo_tpu.models.localizer import Localizer  # noqa: E402
from fast_limo_tpu.utils.config import Config  # noqa: E402


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 25
    npts = int(sys.argv[2]) if len(sys.argv) > 2 else 8192

    cfg = Config()
    cfg.sensor_type = 1
    cfg.gravity_align = cfg.calibrate_accel = cfg.calibrate_gyro = False
    cfg.time_offset = False
    cfg.debug = True
    cfg.verbose = False
    cfg.intrinsics.accel_bias = [0.0] * 3
    cfg.intrinsics.gyro_bias = [0.0] * 3
    cfg.filters.crop_active = True
    cfg.filters.dist_active = True
    cfg.filters.min_dist = 2.0
    cfg.filters.voxel_active = True
    cfg.filters.leafSize = [1.0, 1.0, 1.0]
    cfg.ikfom.MAX_NUM_ITERS = 3
    cfg.ikfom.mapping.MAX_NUM_MATCHES = 5000
    cfg.ikfom.mapping.MAX_NUM_PC2MATCH = min(npts, 10000)
    cfg.ikfom.mapping.octree.min_extent = 0.2
    cfg.ikfom.estimate_extrinsics = True
    cfg.tpu.max_points_per_scan = npts
    cfg.tpu.map_capacity = 2 ** 17
    cfg.tpu.map_voxel_size = 1.2
    cfg.tpu.map_points_per_voxel = 6
    cfg.tpu.imu_batch = 32
    cfg.tpu.hash_probes = 4
    cfg.tpu.insert_probes = 2
    cfg.tpu.max_insert_points = min(npts, 10000)

    seq = synthetic.SyntheticSequence(
        seed=7, n_scans=n, points_per_scan=npts,
        noise_pt=0.01, noise_gyro=5e-4, noise_acc=5e-3,
        traj=synthetic.Trajectory(v_forward=15.0, yaw_amp=0.5))
    loc = Localizer(cfg)
    stamps, acc, gyro = seq.imu_stream()
    scans = [seq.scan(i) for i in range(n)]
    si = 0
    stales = []
    while si < n:
        for k in range(len(stamps)):
            loc.update_imu(stamps[k], acc[k], gyro[k])
            while si < n and scans[si][0] <= stamps[k]:
                st_, pts, traw = scans[si]
                loc.update_pointcloud(pts, traw, st_)
                if loc.last_output is not None and \
                        loc.last_output.debug is not None:
                    stales.append(int(loc.last_output.debug.n_stale))
                si += 1
        break
    s = np.asarray(stales)
    print(f"scans={len(s)}  n_stale per scan: "
          f"zero-frac={np.mean(s == 0):.2f}  mean={s.mean():.2f}  "
          f"p50={np.median(s):.0f}  p90={np.quantile(s, 0.9):.0f}  "
          f"max={s.max()}")
    print("per-scan:", s.tolist())


if __name__ == "__main__":
    main()
