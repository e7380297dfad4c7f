"""Incremental voxel-hash map — the array-program equivalent of the
reference's incremental octree (`include/fast_limo/Objects/Octree.hpp`).

The octree's pointer-chasing kNN does not map to fixed-shape array code;
instead the map is a
fixed-capacity **block-addressed** hash table of voxel entries, laid out so
the entire lookup is ONE wide-row gather and the entire insert is ONE gather
+ ONE scatter:

* the hash key is the 2×2×2-voxel **block** coordinate (``vc >> 1``), and a
  hash group holds ``ROW_E = 16`` voxel entries shared by every block that
  hashes there (free-entry election, exactly like a set-associative cache
  with fully-flexible ways);
* the same data lives in TWO mirrored group-row layouts (see the
  VoxelHashMap docstring): ``table`` is entry-major — ROW_E contiguous ENTRY
  blocks of width ``EW = 4 + 4B`` (``W = ROW_E·EW``)::

      [ entry0: (vx,vy,vz as exact f32, count f32, B×4 points) | entry1 … ]

  so an insert writes ONE entry-block row per distinct voxel in the batch —
  meta and all merged bucket points together — in the flat ``(G·ROW_E, EW)``
  view: a single scatter with one index per input point (only voxel-run
  leaders actually land); and ``ptable`` is the planar mirror the kNN
  lookup decodes with contiguous lane slices.

Why block addressing: the 27-voxel cube the reference's kNN must cover
(Octree.hpp:527-598) spans exactly TWO consecutive 2-voxel blocks per axis,
so EIGHT gathered group rows give full 27-cube coverage — in fact the whole
4³-voxel superset around the query — versus 27 rows when voxels hash
individually.  Every gathered entry is a spatial neighbor (useful payload),
where a voxel-hashed group spends 7/8 of its row on hash-arbitrary voxels.
This retires the round-1..3 ``knn_neighborhood`` speed/accuracy knob: the
exact path IS the fast path (the 4/8/27 values are accepted and ignored).

Wide rows were chosen because gather/scatter cost on the accelerator the
design was first tuned for was per *operation* + per *row* and nearly
independent of row width; whether the layout suits coalesced GPU loads is
an open question (ROADMAP).  Collision handling is soft: a group
overflowing ROW_E distinct voxels (i.e. the blocks hashing there hold more
than 16 occupied voxels TOTAL — surfaces occupy ~4 of a block's 8 voxels,
so one group comfortably fits two colliding blocks) rejects newcomers,
analogous to the octree's bounded leaves (Octree.hpp:399-405).  At the
bench shapes the measured overflow is ~1e-4 of voxels
(`tools/probe_block_occupancy.py`).

The per-entry capacity B mirrors the octree's leaf-level downsampling rule —
a full bucket rejects new points (Octree.hpp:399-405) — and the voxel edge
defaults to ``2*min_extent`` (the finest octree leaf is in
``(min_extent, 2*min_extent]``, Octree.hpp:310,385).

kNN = gather the 8 neighbor-block rows of each query, keep every entry whose
stored voxel lies in a wanted block, and take the k smallest squared
distances (Octree.hpp:527-598 contract: ascending sq-dists; coverage
guarantee radius = ``voxel_size``, same as the 27-cube, from a 4³ superset).
It is split into `gather_rows` (block-row gather — depends only on the
query VOXELS) and `topk_from_candidates` so the iterated update can hoist
the gather out of its re-match loop.

Sharded mode (num_shards > 1): a block's owner device is the high bits of
its global group hash; groups are device-local by construction.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from fast_limo_tpu.ops import sort as psort

E = 16       # entries per PLANAR subgroup (planarize / decode unit)
SUB = 1      # planar subgroups per hash-group row: plane-major across the
             # WHOLE row, so the kNN decode reads 16-lane meta / 96-lane
             # coordinate planes
ROW_E = E * SUB  # voxel entries per hash group (free-election associativity)

_BLOCK_CORNERS = jnp.array(
    [[dx, dy, dz] for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)],
    dtype=jnp.int32,
)  # (8, 3)

_BLOCK_OFFSETS27 = jnp.array(
    [[dx, dy, dz] for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)],
    dtype=jnp.int32,
)  # (27, 3) — wide neighborhood for radius_search (radius ≤ 2·voxel_size)


def _entry_width(bucket: int) -> int:
    """Entry block: [vx, vy, vz, count | B points padded to 4 lanes]."""
    return 4 + 4 * bucket


def _row_width(bucket: int) -> int:
    return ROW_E * _entry_width(bucket)


def _sub_width(bucket: int) -> int:
    """Planar SUBGROUP row: [vx×E | vy×E | vz×E | cnt×E | x slot-major E·B | y | z]."""
    return 4 * E + 3 * E * bucket


def _planar_width(bucket: int) -> int:
    return SUB * _sub_width(bucket)


class VoxelHashMap(NamedTuple):
    """Twin-layout block-addressed voxel-hash map.

    ``table`` is ENTRY-MAJOR (ROW_E contiguous entry blocks per group row) —
    the layout inserts want: one voxel's whole update is one contiguous row
    in the flat (G·ROW_E, EW) view, so the insert is a single row scatter
    with no write collisions between voxels of one group.

    ``ptable`` is the PLANAR mirror of the same data — the layout kNN wants:
    per planar subgroup of E entries, the voxel coords / counts / per-slot
    point coordinates each occupy contiguous lane planes, so the lookup
    (`cands_from_rows`) decodes a gathered row with static contiguous
    slices.  The mirror is plane-major across the WHOLE row (SUB=1: one
    planar subgroup of E=ROW_E entries); the planarize permutation is one
    (E·EW → sub_width) matmul, applied at (G·SUB) rows.
    """

    table: jnp.ndarray       # (G, W) float32 entry-major rows
    ptable: jnp.ndarray      # (G, WP) float32 planar rows (see _planar_width)
    num_points: jnp.ndarray  # () int32  (Mapper::size, Mapper.cpp:51-53)
    last_time: jnp.ndarray   # () float32 (Mapper::last_time)

    @property
    def groups(self):
        return self.table.shape[0]

    @property
    def bucket(self):
        return (self.table.shape[1] // ROW_E - 4) // 4

    @property
    def capacity(self):
        """Total entry count (the public 'slots' knob = G·ROW_E)."""
        return self.groups * ROW_E

    @property
    def _entries(self):
        """(G·ROW_E, EW) flat entry-block view."""
        return self.table.reshape(self.groups * ROW_E, _entry_width(self.bucket))

    @property
    def coords(self):
        """(G·ROW_E, 3) int32 voxel coords per entry (garbage where count==0)."""
        return self._entries[:, :3].astype(jnp.int32)

    @property
    def counts(self):
        """(G·ROW_E,) int32 stored-point count per entry (0 = free)."""
        return self._entries[:, 3].astype(jnp.int32)

    @property
    def points(self):
        """(G·ROW_E, B, 3) stored points per entry."""
        return self._entries[:, 4:].reshape(
            self.groups * ROW_E, self.bucket, 4)[:, :, :3]

    @property
    def meta(self):
        """(G·ROW_E, 4) int32 [vx, vy, vz, count] compatibility view."""
        return jnp.concatenate([self.coords, self.counts[:, None]], axis=1)


def layout_version(bucket: int) -> str:
    """Stamp identifying the on-device table layouts.

    Stored in checkpoint ``extra``; `Localizer.load_checkpoint` rejects
    mismatches and ALWAYS rebuilds the planar mirror, so a layout-only
    revision (e.g. the round-4 E/SUB lane reorder, which kept the exact
    array shapes) can never resume with a lane-scrambled kNN mirror
    (ADVICE r4)."""
    return f"block2x2x2/E{E}/SUB{SUB}/B{int(bucket)}"


def create(capacity: int, bucket: int, dtype=jnp.float32) -> VoxelHashMap:
    assert capacity & (capacity - 1) == 0, "capacity must be a power of two"
    assert capacity >= ROW_E
    # the fused f32 permute round-trips group ids through float32 — exact
    # only below 2^24 (ADVICE r3: enforce, don't just document)
    assert capacity // ROW_E <= 1 << 24, "group ids must be f32-exact"
    del dtype  # fused table is always f32 (integer coords are exact in f32)
    return VoxelHashMap(
        table=jnp.zeros((capacity // ROW_E, _row_width(bucket)), jnp.float32),
        ptable=jnp.zeros((capacity // ROW_E, _planar_width(bucket)), jnp.float32),
        num_points=jnp.asarray(0, jnp.int32),
        last_time=jnp.asarray(-1.0, jnp.float32),
    )


def _planarize(table, bucket: int):
    """Rebuild the planar mirror from the entry-major table.

    A pure lane permutation per planar subgroup, done as ONE one-hot matmul
    (G·SUB, E·EW)·(E·EW, sub_width) — exact (each output lane is a single
    1.0·value MAC, at the float32 matmul precision the package pins),
    scatter-free, and immune to the write-collision / stale-lane
    subtleties an incremental mirror would have.  Runs once per insert
    batch; cost is O(G).
    """
    B = bucket
    EW = _entry_width(B)
    W0 = E * EW
    WP0 = _sub_width(B)
    G = table.shape[0]
    r = jax.lax.broadcasted_iota(jnp.int32, (W0, WP0), 0)
    t = jax.lax.broadcasted_iota(jnp.int32, (W0, WP0), 1)
    # planar lane t → entry-major lane src(t)
    plane = t // E                 # 0..3 meta planes, then coordinate planes
    e_of_t = t % E
    meta_src = e_of_t * EW + plane                       # vx/vy/vz/cnt planes
    pt = t - 4 * E                                       # index into xyz planes
    c_of_t = pt // (E * B)                               # 0=x 1=y 2=z
    s_of_t = (pt % (E * B)) // E
    e2_of_t = pt % E
    pt_src = e2_of_t * EW + 4 + 4 * s_of_t + c_of_t
    src = jnp.where(t < 4 * E, meta_src, pt_src)
    P = (r == src).astype(jnp.float32)                   # (W0, WP0) one-hot
    sub = jax.lax.dot_general(table.reshape(G * SUB, W0), P,
                              (((1,), (0,)), ((), ())),
                              preferred_element_type=jnp.float32)
    return sub.reshape(G, SUB * WP0)


def _hash(coords, groups: int):
    """Spatial hash of integer BLOCK coords → group in [0, groups)."""
    h = (
        coords[..., 0] * jnp.int32(73856093)
        ^ coords[..., 1] * jnp.int32(19349669)
        ^ coords[..., 2] * jnp.int32(83492791)
    )
    return (h & jnp.int32(groups - 1)).astype(jnp.int32)


def voxel_coords(pts, voxel_size: float):
    return jnp.floor(pts / voxel_size).astype(jnp.int32)


def block_coords(vc):
    """2×2×2-voxel block coordinate (arithmetic shift = floor for int32)."""
    return vc >> 1


def _shard_split(h_full, groups, num_shards, shard_index):
    owner = h_full // jnp.int32(groups)
    local = (h_full % jnp.int32(groups)).astype(jnp.int32)
    return owner == shard_index, local


def _group_rows(m: VoxelHashMap, g, nc):
    """Gather full group rows and resolve ``nc`` against the ROW_E entries.

    g (...,) group ids, nc (...,3) voxel coords →
    (entries (...,ROW_E,EW), match (...,ROW_E) bool, counts (...,ROW_E) f32)
    from ONE row gather.  Gathers FULL rows and slices afterwards: one
    row gather instead of a mixed-index sub-row gather.
    """
    ent = m.table[g].reshape(*g.shape, ROW_E, _entry_width(m.bucket))
    coords = ent[..., :3]                                # (...,ROW_E,3) f32
    counts = ent[..., 3]                                 # (...,ROW_E) f32
    match = (counts > 0) & jnp.all(
        coords == nc[..., None, :].astype(jnp.float32), axis=-1)
    return ent, match, counts


# ---------------------------------------------------------------------------
# insert
# ---------------------------------------------------------------------------

def _seg_sum(flags, reset):
    """Inclusive segmented sum of ``flags`` with restart where ``reset``.

    Two NATIVE scans instead of a pair-carry associative_scan: the inclusive
    sum within a segment starting at s is pre[i] − (pre[s] − flags[s]), and
    since pre is nondecreasing the per-segment base (pre − flags at segment
    starts) is recoverable with a running max.  ``reset[0]`` must be True
    (callers pass the first-group flag).
    """
    f = flags.astype(jnp.int32)
    pre = jnp.cumsum(f)
    base = jax.lax.cummax(jnp.where(reset, pre - f, jnp.int32(-(2 ** 30))))
    return pre - base


@functools.partial(jax.jit, static_argnames=("voxel_size", "probes", "num_shards"))
def insert(m: VoxelHashMap, pts, valid, *, voxel_size: float, probes: int = 0,
           num_shards: int = 1, shard_index=0) -> VoxelHashMap:
    """Insert a masked batch of world-frame points (Mapper::add / Octree::update).

    One full-row gather + ONE entry-block scatter: points of the same voxel
    are grouped by a sort, matched against their BLOCK's hash group's ROW_E
    entries, and new voxels are assigned distinct free entries by rank
    election.  Each voxel run's LEADER (first point) writes the whole entry
    block — coords, final count, and the merged bucket (existing points ∪
    the run's new points, capacity-capped) — so the scatter has exactly N
    indices, one per input point, with only leaders landing.  A group whose
    ROW_E entries are all taken rejects further voxels (see module
    docstring); a full entry rejects further points (octree leaf
    downsampling, Octree.hpp:399-405).

    ``probes`` is accepted for API compatibility and ignored (the fused
    layout has no probe chains).
    """
    del probes
    G = m.groups
    B = m.bucket
    EW = _entry_width(B)
    N = pts.shape[0]

    pts = pts.astype(jnp.float32)
    vc0 = voxel_coords(pts, voxel_size)                      # (N,3)
    bc0 = block_coords(vc0)
    if num_shards > 1:
        owned, g0 = _shard_split(_hash(bc0, G * num_shards),
                                 G, num_shards, shard_index)
        valid = valid & owned
    else:
        g0 = _hash(bc0, G)

    # ---- group-major sort: points of one voxel contiguous, voxels of one
    # hash group contiguous (invalids last); EVERYTHING below runs in the
    # sorted domain so no un-permute scatters are needed ----
    # The voxel sub-key packs 10 bits/axis: two distinct voxels of one batch
    # only collide at Δ=1024 voxels (≥1.2 km inside ONE scan/keyframe cloud
    # — beyond any sensor range), and run membership is still verified on
    # exact coords below (same_voxel).
    key_g = jnp.where(valid, g0, jnp.int32(0x7FFFFFFF))
    packed = (((vc0[:, 0] & 0x3FF) << 20)
              | ((vc0[:, 1] & 0x3FF) << 10)
              | (vc0[:, 2] & 0x3FF))
    # stable 2-key sort; the arange operand carries the permutation
    _, _, order = psort.sort3(key_g, packed, jnp.arange(N, dtype=jnp.int32))
    # apply the permutation with ONE row gather instead of five separate
    # [order] gathers.  All packed lanes are exactly
    # representable in f32 (|voxel coord| < 2²⁴, g0 < G ≤ 2²⁴ asserted in
    # create(), valid ∈ {0,1}).
    fused = jnp.concatenate(
        [vc0.astype(jnp.float32), pts,
         g0.astype(jnp.float32)[:, None],
         valid.astype(jnp.float32)[:, None]], axis=1)        # (N,8)
    perm = fused[order]
    vc = perm[:, 0:3].astype(jnp.int32)
    pts = perm[:, 3:6]
    valid = perm[:, 7] > 0
    g = jnp.where(valid, perm[:, 6].astype(jnp.int32), 0)
    g_s = jnp.where(valid, perm[:, 6].astype(jnp.int32),
                    jnp.int32(0x7FFFFFFF))

    # ---- resolve each point's voxel against its group (pre-insert state) ----
    ent, match_e, counts_e = _group_rows(m, g, vc)        # (N,ROW_E,EW),(N,ROW_E)
    has_match = jnp.any(match_e, axis=-1)
    entry_m = jnp.argmax(match_e, axis=-1).astype(jnp.int32)
    base_m = jnp.sum(jnp.where(match_e, counts_e, 0.0), axis=-1).astype(jnp.int32)
    free_e = counts_e == 0                                   # (N,ROW_E)

    # voxel-run structure: same_voxel marks continuation points
    same_voxel = jnp.concatenate(
        [jnp.array([False]),
         jnp.all(vc[1:] == vc[:-1], axis=-1) & valid[1:] & valid[:-1]])
    is_leader = valid & ~same_voxel

    # rank of each NEW voxel among the new voxels of its group: segmented
    # count of voxel-run leaders that found no existing entry.
    new_group = jnp.concatenate([jnp.array([True]), g_s[1:] != g_s[:-1]])
    is_new_start = is_leader & ~has_match
    r_new = _seg_sum(is_new_start, new_group) - 1            # valid where new

    # ---- free-entry election: new voxel with group-rank r takes the
    # (r+1)-th free entry of its group ----
    freecum = jnp.cumsum(free_e.astype(jnp.int32), axis=-1)  # (N,ROW_E)
    want = free_e & (freecum == (r_new + 1)[:, None])
    assigned = jnp.any(want, axis=-1)
    entry_n = jnp.argmax(want, axis=-1).astype(jnp.int32)

    resolved = valid & (has_match | assigned)
    entry = jnp.where(has_match, entry_m, entry_n)
    base = jnp.where(has_match, jnp.minimum(base_m, B), 0)   # existing fill

    # ---- leader-row merge: existing bucket ∪ this run's new points ----
    # run continuation flags: cont[:, j] ⇔ point i+j belongs to i's run
    # (prefix-AND of shifted same_voxel; j < B because the bucket caps fills)
    pts4 = jnp.concatenate([pts, jnp.zeros((N, 1), jnp.float32)], axis=1)
    shifted = []    # shifted[j][i] = pts4[i+j]
    conts = []
    cont = jnp.ones(N, bool)
    for j in range(B):
        if j > 0:
            sv_j = jnp.concatenate(
                [same_voxel[j:], jnp.zeros(j, bool)])        # same_voxel[i+j]
            cont = cont & sv_j
        shifted.append(jnp.concatenate(
            [pts4[j:], jnp.zeros((j, 4), jnp.float32)], axis=0))
        conts.append(cont)
    new_stack = jnp.stack(shifted, axis=1)                   # (N,B,4)
    new_ok = jnp.stack(conts, axis=1)                        # (N,B)

    # slot s takes new point (s - base) when that run point exists.  Select
    # chains, NOT einsums: the one-hot contractions here would be N batched
    # (B,B)x(B,4) / (ROW_E)x(ROW_E,4B) matmuls; B selects on (N,B,4) are
    # plain elementwise work.
    s_idx = jnp.arange(B, dtype=jnp.int32)
    j_of_s = s_idx[None, :] - base[:, None]                  # (N,B) offsets
    use_new = jnp.zeros((N, B), bool)
    new_part = jnp.zeros((N, B, 4), jnp.float32)
    for j in range(B):
        pick = (j_of_s == j) & new_ok[:, j:j + 1]            # (N,B)
        use_new = use_new | pick
        new_part = jnp.where(pick[..., None],
                             new_stack[:, j][:, None, :], new_part)

    # existing bucket of the matched entry (zero rows when no match)
    exist = jnp.zeros((N, B, 4), jnp.float32)
    ebuckets = ent[..., 4:].reshape(N, ROW_E, B, 4)
    for e in range(ROW_E):
        exist = jnp.where(match_e[:, e][:, None, None], ebuckets[:, e], exist)
    merged = jnp.where(use_new[..., None], new_part, exist)  # (N,B,4)

    n_placed = jnp.sum(use_new, axis=-1).astype(jnp.int32)   # new points stored
    final_count = (base + n_placed).astype(jnp.float32)

    # ---- ONE entry-block scatter (leaders only; coords stored as exact f32
    # VALUES, never bitcast: XLA does not preserve int bit patterns through
    # f32 ops — denormal flush / NaN canonicalization) ----
    writer = is_leader & resolved
    # non-writers get DISTINCT out-of-bounds rows (dropped) so every index
    # is unique and XLA can take the no-collision scatter lowering
    lane = jnp.arange(N, dtype=jnp.int32)
    erow = jnp.where(writer, g * ROW_E + entry, G * ROW_E + lane)
    evals = jnp.concatenate(
        [vc.astype(jnp.float32), final_count[:, None],
         merged.reshape(N, 4 * B)], axis=1)                  # (N,EW)
    flatE = m.table.reshape(G * ROW_E, EW)
    flatE = flatE.at[erow].set(evals, mode="drop", unique_indices=True)
    table = flatE.reshape(G, ROW_E * EW)

    # dtype pinned: under x64 jnp.sum would promote the int32 count to int64
    total = jnp.sum(jnp.where(writer, n_placed, 0), dtype=jnp.int32)
    return VoxelHashMap(table, _planarize(table, B), m.num_points + total,
                        m.last_time)


# ---------------------------------------------------------------------------
# kNN
# ---------------------------------------------------------------------------

def gather_rows(m: VoxelHashMap, queries, *, voxel_size: float,
                num_shards: int = 1, shard_index=0, neighborhood: int = 8):
    """The raw kNN gather: neighbor BLOCK coords + their full group rows.

    Returns ``(rows (N,V,WP) f32, ncb (N,V,3) int32 block coords,
    owned (N,V) bool|None)``.  This is the only HBM-heavy part of the
    lookup; block matching / distances / top-k run in
    ``cands_from_rows`` + ``topk_from_candidates``.

    ``neighborhood``: values 4/8/27 — the retired voxel-hashed knobs — all
    resolve to the exact 8-block gather (full 27-voxel-cube coverage; the
    knob split is a documented no-op since round 4).  The private value -27
    gathers the WIDE 27-block neighborhood (coverage radius 2·voxel_size)
    for `radius_search`.
    """
    assert neighborhood in (4, 8, 27, -27)
    G = m.groups
    qc = voxel_coords(queries, voxel_size)                     # (N,3)
    if neighborhood == -27:
        qb = block_coords(qc)
        ncb = qb[:, None, :] + _BLOCK_OFFSETS27[None, :, :]    # (N,27,3)
    else:
        # base block b0 = floor((v-1)/2): blocks {b0, b0+1} per axis span
        # voxels [2·b0, 2·b0+3] ⊇ the 27-cube [v-1, v+1]
        b0 = (qc - 1) >> 1
        ncb = b0[:, None, :] + _BLOCK_CORNERS[None, :, :]      # (N,8,3)
    if num_shards > 1:
        owned, g = _shard_split(_hash(ncb, G * num_shards),
                                G, num_shards, shard_index)
    else:
        owned = None
        g = _hash(ncb, G)
    rows = m.ptable[g]                                         # (N,V,WP) — THE gather
    return rows, ncb, owned


def cands_from_rows(rows, ncb, owned, bucket: int):
    """jnp block-match + bucket extraction from PLANAR rows.

    rows (N,V,WP), ncb (N,V,3) block coords →
    (cand_pts (N,V·SUB,B,E,3), cand_valid (N,V·SUB,B,E)): every entry whose
    stored voxel lies in the wanted block contributes its whole bucket.
    All reads are contiguous lane-plane slices (see VoxelHashMap docstring).
    """
    N, V, WP = rows.shape
    B = bucket
    WP0 = _sub_width(B)
    sub = rows.reshape(N, V * SUB, WP0)
    # block coords broadcast to the SUB planar subgroups of each row
    ncf = jnp.repeat(ncb.astype(jnp.float32), SUB, axis=1)     # (N,V·SUB,3)
    vx = sub[..., 0:E]                                         # (N,VS,E)
    vy = sub[..., E:2 * E]
    vz = sub[..., 2 * E:3 * E]
    cnt = sub[..., 3 * E:4 * E]
    # stored voxel → block: floor(v/2) is exact in f32 for |v| < 2^24
    sel = ((cnt > 0)
           & (jnp.floor(vx * 0.5) == ncf[..., 0:1])
           & (jnp.floor(vy * 0.5) == ncf[..., 1:2])
           & (jnp.floor(vz * 0.5) == ncf[..., 2:3]))           # (N,VS,E)
    if owned is not None:
        sel = sel & jnp.repeat(owned, SUB, axis=1)[..., None]

    EB = E * B
    xs = sub[..., 4 * E:4 * E + EB].reshape(N, V * SUB, B, E)  # slot-major
    ys = sub[..., 4 * E + EB:4 * E + 2 * EB].reshape(N, V * SUB, B, E)
    zs = sub[..., 4 * E + 2 * EB:4 * E + 3 * EB].reshape(N, V * SUB, B, E)
    cand_pts = jnp.stack([xs, ys, zs], axis=-1)                # (N,VS,B,E,3)
    slot = jnp.arange(B, dtype=jnp.float32)[None, None, :, None]
    cand_valid = sel[:, :, None, :] & (slot < cnt[:, :, None, :])
    return cand_pts, cand_valid


@functools.partial(jax.jit, static_argnames=("voxel_size", "probes",
                                             "num_shards", "neighborhood"))
def gather_neighborhood(m: VoxelHashMap, queries, *, voxel_size: float,
                        probes: int = 0, num_shards: int = 1, shard_index=0,
                        neighborhood: int = 8):
    """Resolve each query's block neighborhood and gather the buckets.

    EIGHT wide-row gathers fetch the 2×2×2 blocks spanning the query's
    27-voxel cube (full coverage radius = voxel_size, from a 4³-voxel
    superset of candidates); every stored entry of a wanted block is a
    candidate.  Depends only on each query's VOXEL, so it can be computed
    once per scan and reused across update iterations (pose shifts are
    millimetric).

    ``probes`` is accepted for API compatibility and ignored;
    ``neighborhood`` 4/8/27 are accepted no-ops (see `gather_rows`).
    Returns (cand_pts (N,VS,B,E,3), cand_valid (N,VS,B,E)).
    """
    del probes
    rows, ncb, owned = gather_rows(
        m, queries, voxel_size=voxel_size, num_shards=num_shards,
        shard_index=shard_index, neighborhood=neighborhood)
    return cands_from_rows(rows, ncb, owned, m.bucket)


@functools.partial(jax.jit, static_argnames=("k",))
def topk_from_candidates(cand_pts, cand_valid, queries, *, k: int):
    """k smallest squared distances among the candidate buckets.

    Returns ``(nbrs (N,k,3), sq (N,k) ascending with +inf pads,
    valid (N,k))``.
    """
    N = queries.shape[0]
    flat_pts = cand_pts.reshape(N, -1, 3)
    flat_valid = cand_valid.reshape(N, -1)
    diff = flat_pts - queries[:, None, :]
    d2 = jnp.sum(diff * diff, axis=-1)
    d2 = jnp.where(flat_valid, d2, jnp.inf)
    neg_top, top_idx = jax.lax.top_k(-d2, k)
    sq = -neg_top
    nbrs = jnp.take_along_axis(flat_pts, top_idx[..., None], axis=1)
    valid = jnp.isfinite(sq)
    return nbrs, jnp.where(valid, sq, jnp.inf), valid


@functools.partial(jax.jit, static_argnames=("voxel_size",))
def evict_far(m: VoxelHashMap, center, radius: float, *, voxel_size: float) -> VoxelHashMap:
    """Rolling-origin eviction: free every voxel farther than ``radius`` from
    ``center`` (world frame).

    The reference's octree grows without bound (no eviction; UTBM-length
    sequences rely on RAM); a fixed-capacity hash table needs to recycle
    slots.  Purely elementwise on the fused table: zero the count of far
    entries (a zero count IS the free state; coords/points become dead).
    """
    G = m.groups
    EW = _entry_width(m.bucket)
    ent = m.table.reshape(G * ROW_E, EW)
    coords = ent[:, :3]                                        # f32 values
    counts = ent[:, 3]                                         # (G·ROW_E,)
    cvox = jnp.asarray(center) / voxel_size
    d2 = jnp.sum((coords + 0.5 - cvox) ** 2, axis=-1)
    keep = (d2 * (voxel_size * voxel_size)) <= radius * radius
    occupied = counts > 0
    removed = jnp.sum(jnp.where(occupied & ~keep, counts, 0.0)).astype(jnp.int32)
    ent = ent.at[:, 3].set(jnp.where(keep, counts, 0.0))
    # planar mirror: same count zeroing on each subgroup's count plane
    WP0 = _sub_width(m.bucket)
    keep_sub = keep.reshape(G * SUB, E)
    psub = m.ptable.reshape(G * SUB, WP0)
    pcnt = jnp.where(keep_sub, psub[:, 3 * E:4 * E], 0.0)
    psub = jnp.concatenate([psub[:, :3 * E], pcnt, psub[:, 4 * E:]], axis=1)
    return m._replace(table=ent.reshape(G, ROW_E * EW),
                      ptable=psub.reshape(G, SUB * WP0),
                      num_points=m.num_points - removed)


@functools.partial(jax.jit,
                   static_argnames=("radius", "voxel_size", "max_results"))
def radius_search(m: VoxelHashMap, queries, radius: float, *,
                  voxel_size: float, max_results: int = 16
                  ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """All stored points within ``radius`` of each query, ascending by
    distance, capped at ``max_results`` per query (API parity with
    `Octree::radiusSearch`, Octree.hpp:454-526 — unused by the reference's
    own pipeline but part of its public map surface).

    Coverage: ``radius <= voxel_size`` uses the standard 8-block gather;
    ``radius <= 2*voxel_size`` the 27-block neighborhood; LARGER radii
    (arbitrary, like Octree::radiusSearch — VERDICT r4 missing #3) gather a
    (2mb+1)³-block neighborhood with ``mb = ceil(radius/(2*voxel_size))``,
    processed in query chunks to bound the gathered-row working set.  An
    offline/aux API — the hot kNN path never takes the wide branches.

    Returns ``(pts (N,R,3), sq_dists (N,R) ascending, valid (N,R))`` where
    invalid lanes carry ``inf`` distance.
    """
    if radius <= 2 * voxel_size + 1e-6:
        nbh = 8 if radius <= voxel_size + 1e-6 else -27
        nbrs, sq, valid = knn(m, queries, voxel_size=voxel_size,
                              k=max_results, neighborhood=nbh)
        inside = valid & (sq <= radius * radius)
        return nbrs, jnp.where(inside, sq, jnp.inf), inside

    import numpy as _np

    mb = int(_np.ceil(radius / (2 * voxel_size) - 1e-9))
    assert mb <= 6, (f"radius {radius} needs a {2 * mb + 1}³-block gather — "
                     "beyond any sane map query (raise if genuinely needed)")
    offs = jnp.asarray([[dx, dy, dz]
                        for dx in range(-mb, mb + 1)
                        for dy in range(-mb, mb + 1)
                        for dz in range(-mb, mb + 1)], jnp.int32)
    N = queries.shape[0]
    V = offs.shape[0]
    G = m.groups
    # chunk so rows working set stays bounded: V rows × row width per query
    chunk = max(8, min(N, (1 << 24) // max(1, V * m.ptable.shape[1])))
    pad = (-N) % chunk
    q_all = jnp.concatenate(
        [queries, jnp.zeros((pad, 3), queries.dtype)]) if pad else queries

    def one_chunk(q):
        qb = block_coords(voxel_coords(q, voxel_size))
        ncb = qb[:, None, :] + offs[None, :, :]
        rows = m.ptable[_hash(ncb, G)]
        cand_pts, cand_valid = cands_from_rows(rows, ncb, None, m.bucket)
        return topk_from_candidates(cand_pts, cand_valid, q, k=max_results)

    nbrs, sq, valid = jax.lax.map(one_chunk, q_all.reshape(-1, chunk, 3))
    nbrs = nbrs.reshape(-1, max_results, 3)[:N]
    sq = sq.reshape(-1, max_results)[:N]
    valid = valid.reshape(-1, max_results)[:N]
    inside = valid & (sq <= radius * radius)
    return nbrs, jnp.where(inside, sq, jnp.inf), inside


def knn(m: VoxelHashMap, queries, *, voxel_size: float, k: int, probes: int = 0,
        num_shards: int = 1, shard_index=0, neighborhood: int = 8
        ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Bounded kNN over the block neighborhood (gather + select/top-k)."""
    rows, ncb, owned = gather_rows(
        m, queries, voxel_size=voxel_size, num_shards=num_shards,
        shard_index=shard_index, neighborhood=neighborhood)
    cand_pts, cand_valid = cands_from_rows(rows, ncb, owned, m.bucket)
    return topk_from_candidates(cand_pts, cand_valid, queries, k=k)
