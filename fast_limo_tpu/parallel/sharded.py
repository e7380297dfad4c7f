"""Multi-chip scan step over a `jax.sharding.Mesh`.

The reference has no distributed layer at all (SURVEY.md §2); this is the new
design surface mandated by the north star: the voxel-hash map is partitioned
over the mesh axis ``"map"`` by hash ownership (each device owns the slots
whose global-hash high bits equal its index, so probe chains never cross
devices), queries are replicated, per-shard kNN top-k candidates are merged
with an ``all_gather`` across devices, and the tiny iEKF algebra runs replicated.

Memory scaling: a D-device mesh holds a D× larger map at the same per-chip
HBM.  Compute scaling: the kNN gather work per chip drops ~D× (each chip only
probes voxels it owns).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from fast_limo_tpu.models import pipeline as pl
from fast_limo_tpu.utils.config import Config

AXIS = "map"
QUERY_AXIS = "data"


def make_mesh(n_devices: int, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()[:n_devices]
    assert len(devices) >= n_devices, (
        f"need {n_devices} devices, have {len(devices)}")
    import numpy as np

    return Mesh(np.asarray(devices[:n_devices]), (AXIS,))


def make_mesh_2d(n_map: int, n_data: int, devices=None) -> Mesh:
    """2-D mesh: 'map' (hash-sharded map memory) × 'data' (query throughput).

    The per-scan kNN all_gather runs over 'map'; 'data' only moves 12×12
    psums.
    """
    n = n_map * n_data
    devices = devices if devices is not None else jax.devices()[:n]
    assert len(devices) >= n
    import numpy as np

    return Mesh(np.asarray(devices[:n]).reshape(n_map, n_data),
                (AXIS, QUERY_AXIS))


def _state_specs(cfg: Config) -> pl.LIOState:
    """PartitionSpecs: map arrays sharded on slot axis, rest replicated."""
    from fast_limo_tpu.models import mapper, state as st

    map_spec = mapper.VoxelHashMap(
        table=P(AXIS), ptable=P(AXIS), num_points=P(), last_time=P())
    nav = st.NavState(*([P()] * 8))
    return pl.LIOState(
        x=nav, P=P(), map=map_spec,
        prev_scan_stamp=P(), last_prop_time=P(),
        last_w_raw_bl=P(), last_w=P(), last_a=P(),
        bias_gyro_corr=P(), bias_accel_corr=P(), pinned_grav=P())


def _batch_specs() -> pl.ScanBatch:
    return pl.ScanBatch(*([P()] * len(pl.ScanBatch._fields)))


def _out_specs(cfg: Config) -> pl.ScanOutput:
    # the debug subtree must mirror the output structure: a DebugOutput of
    # replicated specs when cfg.debug, the empty pytree (None) otherwise
    dbg = (pl.DebugOutput(*([P()] * len(pl.DebugOutput._fields)))
           if cfg.debug else None)
    out = pl.ScanOutput(*([P()] * len(pl.ScanOutput._fields)))
    return out._replace(debug=dbg)


def comm_volume(cfg: Config, n_map: int, n_data: int = 1) -> dict:
    """Analytic per-scan, per-device collective payloads (bytes).

    The sharded step's collective traffic is fully determined by the config, so
    scaling efficiency on real multi-chip hardware is predictable without
    the hardware: the only large collective is the kNN top-k ``all_gather``
    over the 'map' axis; the 'data' axis moves just 12×12 sufficient
    statistics.  Ring accounting: all_gather receives (D−1)/D of the global
    payload; all_reduce moves 2(D−1)/D of it.

    The model is ASSERTED against the compiled HLO's actual collectives in
    tests/test_sharded.py (``hlo_comm_volume``), so a layout change that
    alters the traffic breaks a test instead of silently invalidating the
    scaling story.
    """
    k = cfg.ikfom.mapping.NUM_MATCH_POINTS
    n_q = cfg.ikfom.mapping.MAX_NUM_PC2MATCH // max(n_data, 1)
    itemsize = jnp.dtype(cfg.tpu.dtype).itemsize
    # the unrolled masked update executes MAX_NUM_ITERS+1 body evaluations
    # (reference loop i = −1 … max−1, esekfom.hpp:1637).  Since round 5 the
    # measurement model is the CERTIFIED exact re-match (measurement.py):
    # ONE frozen top-W window resolve at the predicted pose, and per
    # evaluation a `lax.cond` whose certificate-failure branch re-gathers
    # at size k.  This model counts the STATIC collectives of the compiled
    # program (asserted against HLO below); the traffic that actually
    # EXECUTES on a certificate-clean scan is only the frozen resolve plus
    # the per-eval scalar reductions — reported as executed_typical_bytes.
    evals = cfg.ikfom.MAX_NUM_ITERS + 1
    # per resolve: nbrs (Nq,kk,3) + sq (Nq,kk) from D_m−1 peers
    per_resolve = lambda kk, nq: (n_map - 1) * nq * kk * 4 * itemsize
    # ONE frozen top-W window resolve, plus per evaluation the two
    # certificate-failure branches: the budgeted stale-patch re-resolve
    # (STALE_BUDGET queries/device) and the full re-gather
    from fast_limo_tpu.models.measurement import STALE_BUDGET, window_size
    knn_gather = (per_resolve(window_size(k), n_q)
                  + (per_resolve(k, n_q)
                     + per_resolve(k, STALE_BUDGET)) * evals)
    # per body evaluation: HᵀH (12,12) + Hᵀh (12,) psum over 'data'
    stats_psum = (2 * (n_data - 1) / max(n_data, 1)) * 156 * itemsize * evals
    # MAX_NUM_MATCHES cap prefix: the per-shard keep-counts (one i32
    # scalar) all_gathered over 'data' — statically present in all THREE
    # cond branches of every evaluation (window / patched / full)
    cap_gather = (n_data - 1) * 4 * 3 * evals if n_data > 1 else 0
    # re-match certificate: violation-count psum + worst-shard pmax (two
    # i32 scalar all-reduces over 'data' per eval)
    cert_psum = (2 * (n_data - 1) / n_data * 4 * 2 * evals
                 if n_data > 1 else 0)
    # replicated global num_points: one scalar (i32) psum over 'map'
    count_psum = 2 * (n_map - 1) / n_map * 4 if n_map > 1 else 0
    # dynamic-object residual gate (MappingConfig.DYNAMIC_GATE): its
    # two-pass robust mean needs 2 rounds × (Σ|r|, Σw) scalar psums over
    # 'data' — 4 f32 scalars, in all THREE cond branches of every eval
    gate = cfg.ikfom.mapping.DYNAMIC_GATE
    gate_psum = (2 * (n_data - 1) / n_data * 4 * itemsize * 3 * evals
                 if (gate > 0 and n_data > 1) else 0)
    executed = (per_resolve(window_size(k), n_q) + stats_psum + cert_psum
                + count_psum
                + (cap_gather + gate_psum) / 3)
    return {
        "knn_allgather_bytes": int(knn_gather),
        "cap_allgather_bytes": int(cap_gather),
        "hstats_psum_bytes": int(stats_psum),
        "gate_psum_bytes": int(gate_psum),
        "cert_psum_bytes": int(cert_psum),
        "num_points_psum_bytes": int(count_psum),
        "total_bytes": int(knn_gather + cap_gather + stats_psum + gate_psum
                           + cert_psum + count_psum),
        # what a certificate-clean scan actually moves (one branch of each
        # cond: the frozen path — no re-gather)
        "executed_typical_bytes": int(executed),
    }


_HLO_DTYPE_BYTES = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s64": 8,
                    "s32": 4, "u64": 8, "u32": 4, "s16": 2, "u16": 2,
                    "s8": 1, "u8": 1, "pred": 1}


def hlo_comm_volume(compiled_text: str) -> dict:
    """Per-device received bytes of every collective in a compiled HLO.

    Ring accounting (matches `comm_volume`): an all-gather receives
    (D−1)/D of its output; an all-reduce moves 2(D−1)/D of its operand.
    Returns ``{"allgather_bytes", "allreduce_bytes"}``.
    """
    import re

    ag, ar = 0.0, 0.0
    for line in compiled_text.splitlines():
        m = re.search(r"=\s*(.*?)\s*\b(all-gather|all-reduce)\(", line)
        g = re.search(r"replica_groups=\{\{([0-9,]*)\}", line)
        if not m or not g:
            continue
        types, kind = m.group(1), m.group(2)
        D = g.group(1).count(",") + 1
        if D <= 1:
            continue
        size = 0
        # result type may be a tuple: sum every dtype[shape] component
        for dt, shape in re.findall(r"(\w+)\[([\d,]*)\]", types):
            s = _HLO_DTYPE_BYTES[dt]
            for d in shape.split(","):
                if d:
                    s *= int(d)
            size += s
        if kind == "all-gather":
            ag += size * (D - 1) / D
        else:
            ar += 2.0 * size * (D - 1) / D
    return {"allgather_bytes": int(ag), "allreduce_bytes": int(ar)}


def init_global_state(cfg: Config, n_map_shards: int) -> pl.LIOState:
    """Initial LIOState with the map blown up to the GLOBAL (sharded)
    capacity — ``cfg.tpu.map_capacity`` slots per 'map' shard.  Host-side
    (unplaced); also serves as the restore template for sharded/distributed
    checkpoints."""
    from fast_limo_tpu.models import mapper

    s = pl.init_state(cfg)
    m = mapper.create(cfg.tpu.map_capacity * n_map_shards,
                      cfg.map_points_per_voxel, jnp.dtype(cfg.tpu.dtype))
    return s._replace(map=m)


def build_sharded_scan_step(cfg: Config, mesh: Mesh) -> Tuple:
    """Returns (jitted sharded scan_step, initial sharded LIOState).

    ``cfg.tpu.map_capacity`` is the PER-DEVICE shard capacity; the global
    table has ``map_capacity * n_map_shards`` slots.  Works on a 1-D
    ('map',) or 2-D ('map','data') mesh — the 'data' axis additionally
    shards the matching work (query slices + HᵀH psum).
    """
    n = mesh.shape[AXIS]
    has_query = QUERY_AXIS in mesh.shape
    n_q = mesh.shape.get(QUERY_AXIS, 1) if has_query else 1
    inner = pl.build_scan_step(
        cfg, donate=False, jit=False,
        shard_axis=AXIS, num_shards=n,
        query_axis=QUERY_AXIS if has_query else None, num_query_shards=n_q)

    step = jax.jit(
        jax.shard_map(
            inner, mesh=mesh,
            in_specs=(_state_specs(cfg), _batch_specs()),
            out_specs=(_state_specs(cfg), _out_specs(cfg)),
            check_vma=False,
        ),
        donate_argnums=(0,),
    )

    state = init_global_state(cfg, n)
    # place with the right shardings
    shardings = jax.tree_util.tree_map(
        lambda spec: NamedSharding(mesh, spec), _state_specs(cfg),
        is_leaf=lambda x: isinstance(x, P))
    state = jax.device_put(state, shardings)
    return step, state
