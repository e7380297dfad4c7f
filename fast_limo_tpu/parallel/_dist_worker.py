"""Subprocess worker for the multi-process (multi-host) mesh tests/dryrun.

Each worker is one "host": it owns ``--local-devices`` virtual CPU devices
and joins the others through `jax.distributed` (Gloo collectives), forming
ONE global mesh — the CI stand-in for a multi-host deployment.  The scenario exercises exactly the surface single-process
meshes cannot: cross-process collectives inside the sharded scan step, and
sharded checkpoint save/restore across the process boundary.

Run BY FILE PATH (not ``-m``): the ``-m`` form imports the package before
``main`` can pin the backend to the CPU, and a backend that initializes
first makes ``jax.distributed.initialize`` refuse to run.  Invoke as:

    python fast_limo_tpu/parallel/_dist_worker.py \
        --process-id 0 --num-processes 2 --port 12345 \
        --local-devices 4 --scans 3 --out /tmp/w.npz

Process 0 writes ``--out`` with the per-scan fetched positions, the final
map point count, and the checkpoint-roundtrip equality flag; every process
exits 0 on success.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--local-devices", type=int, default=4)
    ap.add_argument("--scans", type=int, default=3)
    ap.add_argument("--out", default=None)
    ap.add_argument("--skip-2d", action="store_true")
    args = ap.parse_args(argv)

    # backend env must be pinned before jax initializes; replace only the
    # device-count flag, preserving any unrelated inherited XLA flags
    kept = [f for f in os.environ.get("XLA_FLAGS", "").split()
            if not f.startswith("--xla_force_host_platform_device_count")]
    os.environ["XLA_FLAGS"] = " ".join(
        kept + [f"--xla_force_host_platform_device_count={args.local_devices}"])
    os.environ["JAX_PLATFORMS"] = "cpu"

    import jax

    jax.config.update("jax_platforms", "cpu")
    # distributed init MUST precede any backend-touching import (the
    # fast_limo_tpu package import chain may otherwise initialize a backend)
    jax.distributed.initialize(coordinator_address=f"localhost:{args.port}",
                               num_processes=args.num_processes,
                               process_id=args.process_id)

    import numpy as np
    from jax.sharding import Mesh

    # __graft_entry__ lives at the repo root (two levels up from parallel/)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    if repo not in sys.path:
        sys.path.insert(0, repo)
    import __graft_entry__ as ge  # noqa: E402
    from fast_limo_tpu.parallel import distributed as dist  # noqa: E402
    from fast_limo_tpu.parallel import sharded  # noqa: E402

    n_total = args.num_processes * args.local_devices
    assert len(jax.devices()) == n_total, (len(jax.devices()), n_total)
    assert jax.process_count() == args.num_processes

    # ---- 1-D ('map',) global mesh: scan steps + cross-process checkpoint ----
    mesh = Mesh(np.asarray(jax.devices()), (sharded.AXIS,))
    cfg = ge._tiny_cfg(n_pts=512, map_cap=1024, n_shards=n_total)
    step, state = sharded.build_sharded_scan_step(cfg, mesh)

    positions = []
    for i in range(args.scans):
        state, out = step(state, ge._example_batch(cfg, seed=i))
        positions.append(dist.fetch(out.pos))

    ckpt_path = os.path.join(
        os.path.dirname(os.path.abspath(args.out)) if args.out else "/tmp",
        f"dist_ckpt_{args.port}.npz")
    dist.save_checkpoint(ckpt_path, state)
    template = sharded.init_global_state(cfg, n_total)
    restored = dist.load_checkpoint(
        ckpt_path, template, mesh, sharded._state_specs(cfg))

    # live vs restored continuation must agree bitwise (step donates arg 0,
    # so each state feeds exactly one call)
    batch = ge._example_batch(cfg, seed=999)
    s_live, out_live = step(state, batch)
    s_rest, out_rest = step(restored, batch)
    pos_live = dist.fetch(out_live.pos)
    pos_rest = dist.fetch(out_rest.pos)
    np_live = int(dist.fetch(s_live.map.num_points))
    np_rest = int(dist.fetch(s_rest.map.num_points))
    roundtrip_ok = bool(np.array_equal(pos_live, pos_rest)
                        and np_live == np_rest)

    # ---- 2-D ('map','data') process-spanning mesh: compile + one step ----
    ok_2d = True
    if not args.skip_2d and n_total >= 4 and n_total % 2 == 0:
        n_map = n_total // 2
        mesh2 = Mesh(np.asarray(jax.devices()).reshape(n_map, 2),
                     (sharded.AXIS, sharded.QUERY_AXIS))
        cfg2 = ge._tiny_cfg(n_pts=512, map_cap=1024, n_shards=n_map)
        step2, state2 = sharded.build_sharded_scan_step(cfg2, mesh2)
        state2, out2 = step2(state2, ge._example_batch(cfg2, seed=0))
        ok_2d = bool(np.isfinite(dist.fetch(out2.pos)).all())

    if args.out and jax.process_index() == 0:
        np.savez(args.out,
                 positions=np.stack(positions),
                 final_pos=pos_live,
                 num_points=np_live,
                 roundtrip_ok=roundtrip_ok,
                 ok_2d=ok_2d,
                 n_processes=args.num_processes,
                 n_devices=n_total)
    dist.barrier("worker_done")
    if os.path.exists(ckpt_path) and jax.process_index() == 0:
        try:
            os.remove(ckpt_path)
        except OSError:
            pass
    print(f"[dist-worker p{args.process_id}] ok: {args.num_processes} procs × "
          f"{args.local_devices} devices, roundtrip_ok={roundtrip_ok}, "
          f"ok_2d={ok_2d}", flush=True)
    return 0 if (roundtrip_ok and ok_2d) else 1


if __name__ == "__main__":
    sys.exit(main())
