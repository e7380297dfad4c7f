"""Batched multi-session LIO: one chip, many concurrent odometry sessions.

The reference binds one process to one robot (singletons —
Modules/Localizer.hpp:206-209).  Here the ENTIRE scan step is ``jax.vmap``-ed
over a fleet axis: S independent (state, batch) pairs — S robots, or S
map-reprocessing jobs — run as ONE XLA program with one dispatch, one
host↔device round-trip, and S maps resident in HBM.

Whether batching raises aggregate scans/s on the GPU is not measured yet
(tools/bench_fleet.py measures it).  The value of fleet mode is at least
multi-tenancy: shared compilation, one dispatch stream, bounded
per-session memory.  For map capacity, shard the MAP across devices
instead (parallel/sharded.py).

Semantics: each session's (LIOState, ScanBatch) evolves exactly as in the
single-session pipeline (verified element-wise vs per-session runs in
tests/test_batched.py).  Sessions advance in lockstep; a session with no
scan ready this tick feeds a placeholder batch (`noop_batch`) and
``active=False``, which carries its state over exactly.

This composes with the mesh parallelism in `parallel/sharded.py`: vmap for
throughput within a chip, shard_map for map capacity across chips.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from fast_limo_tpu.models import pipeline as pl
from fast_limo_tpu.utils.config import Config


def build_batched_scan_step(cfg: Config, *, donate: bool = True):
    """Vmapped scan step with a per-session activity mask.

    Returns ``step(states, batches, active) -> (states', outs)`` where every
    array carries a leading fleet axis and ``active (S,) bool`` selects, per
    session, the stepped state (True) or an exact carry-over of the previous
    state (False) — so idle sessions lose nothing, not even carried clocks.
    """
    inner = pl.build_scan_step(cfg, donate=False, jit=False)

    def masked(s, b, active):
        s_new, out = inner(s, b)
        s_sel = jax.tree_util.tree_map(
            lambda n, o: jnp.where(active, n, o), s_new, s)
        return s_sel, out

    step = jax.vmap(masked)
    if donate:
        return jax.jit(step, donate_argnums=(0,))
    return jax.jit(step)


def init_batched_state(cfg: Config, n_sessions: int) -> pl.LIOState:
    """S independent initial states stacked on a leading fleet axis."""
    s = pl.init_state(cfg)
    return jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a[None], (n_sessions,) + a.shape), s)


def stack_batches(batches) -> pl.ScanBatch:
    """Stack per-session ScanBatches along the fleet axis."""
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *batches)


def noop_batch(cfg: Config) -> pl.ScanBatch:
    """A batch that leaves a session's state unchanged (idle tick).

    All validity masks are false: the predict consumes no IMU (dt=0
    passthrough), the update is skipped by the NULL-ITERATION guard
    (pipeline.py: ``do_update``), nothing is inserted, and
    ``epoch_shift=0`` keeps the carried clocks fixed.
    """
    N = cfg.tpu.max_points_per_scan
    K = cfg.tpu.imu_batch
    return pl.ScanBatch(
        points=jnp.zeros((N, 3), jnp.float32),
        t_raw=jnp.zeros(N, jnp.float32),
        valid=jnp.zeros(N, bool),
        stamp=jnp.asarray(0.0, jnp.float32),
        epoch_shift=jnp.asarray(0.0, jnp.float32),
        imu_acc=jnp.zeros((K, 3), jnp.float32),
        imu_gyro=jnp.zeros((K, 3), jnp.float32),
        imu_stamp=jnp.zeros(K, jnp.float32),
        imu_valid=jnp.zeros(K, bool),
    )


def select_session(tree, i: int):
    """Extract session ``i``'s pytree slice (e.g. to hand to a Localizer)."""
    return jax.tree_util.tree_map(lambda a: a[i], tree)
