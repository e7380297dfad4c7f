"""Process-spanning (multi-host) runtime on top of `jax.distributed`.

The reference is a single-process CPU program (SURVEY.md §2: "no distributed
computing of any kind"); the north star asks for a multi-host pod slice.  The
sharded scan step (parallel/sharded.py) is already written against a
`jax.sharding.Mesh` and compiles unchanged when that mesh spans processes —
XLA lowers the kNN all_gather / HᵀH psum to cross-host collectives (Gloo on
the CPU backend, NCCL between GPUs).  What multi-process JAX *additionally*
needs, and what this module provides, is the runtime around it:

* distributed initialization (`initialize`),
* reading non-fully-addressable outputs back to every host (`fetch`),
* sharded checkpoint save/restore ACROSS the process boundary
  (`save_checkpoint` gathers every shard to host and writes once from
  process 0; `load_checkpoint` re-places host arrays onto the global mesh —
  each process materializes only the shards it owns).

Tested with 2 CPU-backend processes × 4 virtual devices forming one 8-device
mesh (tests/test_distributed.py), per SURVEY.md §4's prescription for running
N≥2-host logic in CI without a pod.
"""

from __future__ import annotations

import numpy as np

import jax


def initialize(coordinator_address: str, num_processes: int, process_id: int,
               **kw) -> None:
    """`jax.distributed.initialize` with the CPU-mesh test topology defaults.

    Call BEFORE any other jax API touches the backend.  On a real pod slice
    the arguments come from the cluster environment; the explicit form
    here serves the
    multi-process CPU CI topology.
    """
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id, **kw)


def fetch(tree):
    """Host (numpy) value of a global pytree on EVERY process.

    Fully-addressable leaves (single-process meshes) transfer directly;
    non-fully-addressable leaves (process-spanning meshes) go through a
    `process_allgather` so each host receives the shards it does not own.
    """
    from jax.experimental import multihost_utils as mhu

    def one(x):
        if not isinstance(x, jax.Array) or x.is_fully_addressable:
            return np.asarray(x)
        return np.asarray(mhu.process_allgather(x, tiled=True))

    return jax.tree_util.tree_map(one, tree)


def barrier(name: str = "fast_limo_tpu") -> None:
    """Cross-process sync point (e.g. after process 0 wrote a checkpoint)."""
    from jax.experimental import multihost_utils as mhu

    mhu.sync_global_devices(name)


def save_checkpoint(path: str, state, extra: dict = None) -> None:
    """Write a sharded LIOState npz from a process-spanning mesh.

    Every process gathers the full (global) value of each leaf; process 0
    writes the same on-disk format as utils/checkpoint.save_state, so a
    checkpoint taken on an 8-device 2-host mesh restores on a single chip
    (or any other topology) unchanged.  Returns after a barrier, so the
    file is complete on return for every process.
    """
    from fast_limo_tpu.utils import checkpoint as ckpt

    host_state = fetch(state)
    if jax.process_index() == 0:
        ckpt.save_state(path, host_state, extra=extra or {})
    barrier("checkpoint_save:" + path)


def load_checkpoint(path: str, template, mesh, specs):
    """Restore a checkpoint onto a (possibly process-spanning) mesh.

    ``template`` supplies the pytree structure/dtypes (e.g. the live state
    or `pipeline.init_state(cfg)` blown up to global map capacity); ``specs``
    is the PartitionSpec pytree (parallel/sharded._state_specs).  Every
    process reads the full host arrays and `device_put` materializes only
    the locally-addressable shards.
    """
    from jax.sharding import NamedSharding, PartitionSpec

    from fast_limo_tpu.utils import checkpoint as ckpt

    host = ckpt.load_host_arrays(path, template)
    shardings = jax.tree_util.tree_map(
        lambda spec: NamedSharding(mesh, spec), specs,
        is_leaf=lambda x: isinstance(x, PartitionSpec))
    return jax.device_put(host, shardings)
