"""Command-line entry point — the counterpart of the reference's ROS node
(`src/main.cpp`): wire a data source to the engine, print the performance
board, write the trajectory.

Usage:
    python -m fast_limo_tpu.cli synthetic --scans 50 --out traj.tum
    python -m fast_limo_tpu.cli kitti --drive /path/to/drive --config configs/kitti_tpu.yaml
"""

from __future__ import annotations

import argparse
import json
import sys


def _build(args, tweak=None):
    from fast_limo_tpu.models.slam import SLAM
    from fast_limo_tpu.utils.config import Config

    cfg = Config.from_yaml(args.config) if args.config else Config()
    if tweak is not None:
        tweak(cfg)  # must run before SLAM(): Localizer snapshots flags at init
    if getattr(args, "debug_dump", None):
        cfg.debug = True
    if args.chunk and args.chunk > 1:
        cfg.tpu.scan_chunk = args.chunk   # chunked replay is odometry-only
    if args.no_loop or cfg.tpu.scan_chunk > 1:
        return cfg, SLAM(cfg, enable_loop_closure=False)
    return cfg, SLAM(cfg)


def _print_device():
    """The platform this run computed on, on its own line (the JSON result
    line that follows stays unchanged)."""
    import jax

    devs = jax.devices()
    print(f"device: platform={devs[0].platform} "
          f"kind={devs[0].device_kind} count={len(devs)}")


def _dump_debug(args, slam):
    """Write the final scan's DebugOutput to --debug-dump (.npz)."""
    path = getattr(args, "debug_dump", None)
    if not path:
        return
    import numpy as np

    out = slam.loc.last_output
    dbg = getattr(out, "debug", None)
    if dbg is None:
        print("debug dump requested but no scan produced debug output")
        return
    # chunked replay stacks outputs on a leading chunk axis, and inactive
    # padding elements of a partial last chunk carry unmasked garbage debug
    # lanes — slice the last ACTIVE element so the dump is always one scan
    if np.asarray(dbg.match_planes).ndim == 3:
        i = max(0, slam.loc.last_output_scans - 1)
        pick = lambda a: np.asarray(a)[i]
    else:
        pick = np.asarray
    np.savez_compressed(
        path,
        orig_points=pick(dbg.orig_points),
        orig_valid=pick(dbg.orig_valid),
        deskewed=pick(dbg.deskewed),
        deskewed_valid=pick(dbg.deskewed_valid),
        match_planes=pick(dbg.match_planes),
        match_keep=pick(dbg.match_keep),
        match_dist=pick(dbg.match_dist),
        gersh_min=pick(dbg.gersh_min),
        min_eig=pick(dbg.min_eig),
        guard_fired=pick(dbg.guard_fired),
        n_stale=pick(dbg.n_stale),
        pos=pick(out.pos), quat=pick(out.quat))
    print(f"debug scan → {path}")


def _feeder(args, slam):
    """The engine to feed events into: the SLAM itself, or — with --async —
    an AsyncIngest facade over it (lock-free ring + dispatch thread, the
    reference's AsyncSpinner runtime)."""
    if not args.async_mode:
        return slam, None
    from fast_limo_tpu.io.stream import AsyncIngest

    ing = AsyncIngest(slam)
    return ing, ing


def _reloc_bootstrap(args, slam, scan_a, scan_b):
    """--relocalize: localize two consecutive scans of the new run inside
    the loaded session and push pose+velocity into the filter (the ONA
    multi-session workflow, reference relocation branch README.md:201-215).
    Returns the stamp up to which sensor data belongs to the past, or
    raises SystemExit on failure."""
    import numpy as np

    (sa, pa, _ta), (sb, pb, _tb) = scan_a, scan_b
    res, _vel = slam.relocalize_bootstrap(
        pa, np.ones(len(pa), bool), sa, pb, np.ones(len(pb), bool), sb)
    if not res.success:
        print(json.dumps({"error": "relocalization failed",
                          "sc_dist": float(res.sc_dist)}))
        raise SystemExit(1)
    print(f"relocalized at keyframe {res.keyframe_index} "
          f"(sc={res.sc_dist:.3f}, icp_rmse={res.icp_rmse:.3f})")
    return sb


def cmd_synthetic(args):
    import numpy as np

    from fast_limo_tpu.io import synthetic
    from fast_limo_tpu.utils import evaluation

    def tweak(cfg):
        # the synthetic world emits bias-free, gravity-aligned IMU
        cfg.gravity_align = cfg.calibrate_accel = cfg.calibrate_gyro = False
        cfg.intrinsics.accel_bias = [0.0] * 3
        cfg.intrinsics.gyro_bias = [0.0] * 3

    cfg, slam = _build(args, tweak)
    if args.load_session:
        slam.load_session(args.load_session)
    feed, ing = _feeder(args, slam)

    seq = synthetic.SyntheticSequence(
        seed=args.seed, n_scans=args.scans,
        points_per_scan=min(cfg.tpu.max_points_per_scan, 16384))
    stamps, acc, gyro = seq.imu_stream()
    scans = [seq.scan(i) for i in range(args.scans)]
    si = max(0, args.start_scan)
    need = si + 2 if (args.load_session and args.relocalize) else si + 1
    if need > args.scans:
        print(json.dumps({"error": f"--start-scan {args.start_scan} needs "
                          f">= {need} scans, have {args.scans}"}))
        return 1
    t_floor = -np.inf if si == 0 else scans[si - 1][0]
    if args.load_session and args.relocalize:
        t_floor = _reloc_bootstrap(args, slam, scans[si], scans[si + 1])
        si += 2
    for k in range(len(stamps)):
        if stamps[k] <= t_floor:
            continue
        feed.update_imu(stamps[k], acc[k], gyro[k])
        while si < args.scans and scans[si][0] <= stamps[k]:
            st, pts, traw = scans[si]
            feed.update_pointcloud(pts, traw, st)
            si += 1
    feed.flush()
    if ing is not None:
        ing.close()

    est = slam.positions()
    gt = seq.traj.pos(slam.stamps())
    ate = evaluation.ate_rmse(est, gt)
    print(slam.loc.board())
    _print_device()
    print(json.dumps({"scans": len(est), "ate_m": round(ate, 4),
                      "loops": slam.n_loops_closed}))
    if args.out:
        traj = slam.trajectory
        evaluation.save_tum(args.out, [t["stamp"] for t in traj],
                            [t["pos"] for t in traj], [t["quat"] for t in traj])
        print(f"trajectory → {args.out}")
    if args.save_session:
        slam.save_session(args.save_session)
        print(f"session → {args.save_session}.*")
    _dump_debug(args, slam)


def cmd_sequence(args):
    """Run an extracted sequence directory (io/generic.py layout) — the
    counterpart of the reference's `roslaunch … + rosbag play` workflow for
    the UTBM/CAT/ONA profiles."""
    from fast_limo_tpu.io import generic
    from fast_limo_tpu.utils import evaluation

    cfg, slam = _build(args)
    if args.load_session:
        slam.load_session(args.load_session)
    feed, ing = _feeder(args, slam)
    seq = generic.GenericSequence(args.data)
    start_scan, t_floor = 0, None
    if args.load_session and args.relocalize:
        t_floor = _reloc_bootstrap(args, slam, seq.scan(0), seq.scan(1))
        start_scan = 2
    generic.run_sequence(feed, seq, n_scans=args.scans,
                         start_scan=start_scan, start_time=t_floor)
    if ing is not None:
        ing.close()
    print(slam.loc.board())
    traj = slam.trajectory
    out = {"scans": len(traj)}
    if hasattr(slam, "n_loops_closed"):
        out["loops"] = slam.n_loops_closed
    _print_device()
    print(json.dumps(out))
    if args.out:
        evaluation.save_tum(args.out, [t["stamp"] for t in traj],
                            [t["pos"] for t in traj], [t["quat"] for t in traj])
        print(f"trajectory → {args.out}")
    if args.save_session:
        slam.save_session(args.save_session)
        print(f"session → {args.save_session}.*")
    _dump_debug(args, slam)


def cmd_make_synthetic(args):
    """Export the synthetic world as an extracted sequence in any sensor
    time convention, so every profile config runs end-to-end without data."""
    from fast_limo_tpu.io import generic, synthetic

    seq = synthetic.SyntheticSequence(seed=args.seed, n_scans=args.scans,
                                      points_per_scan=args.points)
    generic.export_synthetic(
        args.dir, seq, args.sensor_type, end_of_sweep=args.end_of_sweep,
        standstill=args.standstill, gps_every=args.gps_every,
        gps_noise=args.gps_noise, seed=args.seed)
    print(json.dumps({"dir": args.dir, "scans": args.scans,
                      "sensor_type": args.sensor_type}))


def cmd_kitti(args):
    from fast_limo_tpu.io import kitti
    from fast_limo_tpu.utils import evaluation

    cfg, slam = _build(args)
    feed, ing = _feeder(args, slam)      # honor --async like the other cmds
    drive = kitti.KittiDrive(args.drive)
    kitti.run_drive(feed, drive, n_scans=args.scans)
    if ing is not None:
        ing.close()
    print(slam.loc.board())
    _print_device()
    if args.out:
        traj = slam.trajectory
        evaluation.save_tum(args.out, [t["stamp"] for t in traj],
                            [t["pos"] for t in traj], [t["quat"] for t in traj])
        print(f"trajectory → {args.out}")
    if args.save_session:
        slam.save_session(args.save_session)


def main(argv=None):
    # Shared options accepted both before and after the subcommand. They
    # default to SUPPRESS so the subparser pass never clobbers a value the
    # main parser already read (argparse `parents=` shares action objects,
    # so a set_defaults on any parser would rewrite all of them — real
    # defaults are therefore filled in after parse_args instead).
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--config", default=argparse.SUPPRESS,
                        help="YAML profile (reference format ok)")
    common.add_argument("--out", default=argparse.SUPPRESS,
                        help="write TUM trajectory here")
    common.add_argument("--save-session", default=argparse.SUPPRESS,
                        help="session prefix to save")
    common.add_argument("--load-session", default=argparse.SUPPRESS,
                        help="session prefix to load before running "
                             "(multi-session: continue mapping in the "
                             "saved map/keyframe database)")
    common.add_argument("--relocalize", action="store_true",
                        default=argparse.SUPPRESS,
                        help="with --load-session: globally relocalize the "
                             "run's first two scans against the session's "
                             "keyframes and start tracking in its world "
                             "frame (ONA multi-session workflow)")
    common.add_argument("--no-loop", action="store_true",
                        default=argparse.SUPPRESS, help="odometry only")
    common.add_argument("--chunk", type=int, default=argparse.SUPPRESS,
                        help="scans per jitted dispatch (replay throughput "
                             "mode; >1 implies --no-loop)")
    common.add_argument("--platform", default=argparse.SUPPRESS,
                        help="jax platform override, e.g. 'cpu' for a run "
                             "without the GPU (same as JAX_PLATFORMS=cpu)")
    common.add_argument("--debug-dump", default=argparse.SUPPRESS,
                        help="enable cfg.debug and write the final scan's "
                             "DebugOutput (original/deskewed clouds, match "
                             "planes/distances) to this .npz — the "
                             "reference's debug publishers, main.cpp:198-203")
    common.add_argument("--async", dest="async_mode", action="store_true",
                        default=argparse.SUPPRESS,
                        help="feed sensors through the AsyncIngest layer "
                             "(lock-free IMU ring + dispatch thread) — the "
                             "reference's AsyncSpinner callback runtime, "
                             "src/main.cpp:209-212; each scan consumes the "
                             "same IMU batch as in a sync replay, so the "
                             "trajectories are equal on the CPU and on a "
                             "GPU agree to its run-to-run difference "
                             "(atomic scatter-adds: about 2 cm over 64 "
                             "KITTI-shaped scans on an H100)")

    p = argparse.ArgumentParser(prog="fast_limo_tpu", parents=[common])
    sub = p.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("synthetic", parents=[common],
                        help="run the synthetic benchmark world")
    ps.add_argument("--scans", type=int, default=50)
    ps.add_argument("--seed", type=int, default=0)
    ps.add_argument("--start-scan", type=int, default=0,
                    help="resume mid-route at this scan index (with "
                         "--load-session --relocalize: the two scans at "
                         "this index seed the global relocalization)")
    ps.set_defaults(fn=cmd_synthetic)

    pk = sub.add_parser("kitti", parents=[common],
                        help="run a KITTI raw-sync drive")
    pk.add_argument("--drive", required=True)
    pk.add_argument("--scans", type=int, default=None)
    pk.set_defaults(fn=cmd_kitti)

    pq = sub.add_parser("sequence", parents=[common],
                        help="run an extracted sequence dir (io/generic.py)")
    pq.add_argument("--data", required=True)
    pq.add_argument("--scans", type=int, default=None)
    pq.set_defaults(fn=cmd_sequence)

    pm = sub.add_parser("make-synthetic",
                        help="export the synthetic world as a sequence dir")
    pm.add_argument("--dir", required=True)
    pm.add_argument("--scans", type=int, default=30)
    pm.add_argument("--points", type=int, default=16384)
    pm.add_argument("--sensor-type", type=int, default=1,
                    help="0 OUSTER / 1 VELODYNE / 2 HESAI / 3 LIVOX")
    pm.add_argument("--end-of-sweep", action="store_true")
    pm.add_argument("--standstill", type=float, default=0.0,
                    help="seconds of stationary IMU prepended (calibration)")
    pm.add_argument("--gps-every", type=int, default=0)
    pm.add_argument("--gps-noise", type=float, default=0.1)
    pm.add_argument("--seed", type=int, default=0)
    pm.set_defaults(fn=cmd_make_synthetic)

    args = p.parse_args(argv)
    for dest, dflt in (("config", None), ("out", None),
                       ("save_session", None), ("load_session", None),
                       ("relocalize", False), ("no_loop", False),
                       ("chunk", 0), ("platform", None),
                       ("debug_dump", None), ("async_mode", False)):
        if not hasattr(args, dest):
            setattr(args, dest, dflt)
    if args.platform:
        import jax
        jax.config.update("jax_platforms", args.platform)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
