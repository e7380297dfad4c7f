#!/usr/bin/env python
"""Fleet (multi-session) throughput on the attached accelerator.

Measures aggregate scans/s of the vmapped scan step at fleet sizes 1..S —
the single-card serving-scale story: if the per-scan program is
latency-bound, batching sessions multiplies throughput at near-constant
wall time until the card's compute saturates.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import importlib.util

spec = importlib.util.spec_from_file_location(
    "bench", os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "bench.py"))
bench = importlib.util.module_from_spec(spec)
sys.modules["bench"] = bench
spec.loader.exec_module(bench)

import jax
import jax.numpy as jnp
import numpy as np

from fast_limo_tpu.models import pipeline as pl
from fast_limo_tpu.parallel import batched


def make_batch(cfg, rng, shift):
    N = cfg.tpu.max_points_per_scan
    K = cfg.tpu.imu_batch
    return pl.ScanBatch(
        points=jnp.asarray(rng.uniform(-40, 40, (N, 3)).astype(np.float32)),
        t_raw=jnp.asarray(np.linspace(0, 0.1, N, dtype=np.float32)),
        valid=jnp.ones(N, bool),
        stamp=jnp.asarray(0.0, jnp.float32),
        epoch_shift=jnp.asarray(shift, jnp.float32),
        imu_acc=jnp.asarray(np.tile([0, 0, 9.81], (K, 1)).astype(np.float32)),
        imu_gyro=jnp.zeros((K, 3), jnp.float32),
        imu_stamp=jnp.asarray(np.linspace(0, 0.105, K, dtype=np.float32)),
        imu_valid=jnp.ones(K, bool))


def main():
    cfg = bench.kitti_like_cfg()
    rng = np.random.default_rng(0)
    R = 20
    print(f"device: {jax.devices()[0]}")
    for S in (1, 2, 4, 8, 16):
        step = batched.build_batched_scan_step(cfg, donate=False)
        states = batched.init_batched_state(cfg, S)
        bb = batched.stack_batches(
            [make_batch(cfg, np.random.default_rng(i), 0.1) for i in range(S)])
        active = jnp.ones(S, bool)

        @jax.jit
        def loop(s):
            def body(c, _):
                s2, out = step(c, bb, active)
                return s2, out.pos
            return jax.lax.scan(body, s, None, length=R)

        out = loop(states)
        jax.block_until_ready(out)
        ts = []
        for _ in range(4):
            t0 = time.perf_counter()
            out = loop(states)
            jax.block_until_ready(out)
            ts.append(time.perf_counter() - t0)
        t = float(np.median(ts)) / R
        print(f"S={S:3d}: {t*1e3:7.2f} ms/step  → {S/t:8.1f} scans/s aggregate"
              f"  ({S/t/10:.1f}x realtime)")


if __name__ == "__main__":
    main()
