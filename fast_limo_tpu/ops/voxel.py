"""Fixed-shape voxel-grid centroid downsampling.

Counterpart of the PCL `VoxelGrid` filter the reference applies to the
deskewed scan before matching (Localizer.cpp:313-321).  PCL replaces the
points of each occupied leaf with their centroid; here that is a sort +
segmented mean under jit with a validity mask.

Quirk preserved: the reference sets all three leaf dimensions from
``leafSize[0]`` (Localizer.cpp:61) — callers should pass a scalar leaf.

The voxel id is packed into ONE 31-bit sort key (10 bits per axis +
validity top bit) so grouping costs a single ``sort_key_val`` pass instead
of a 4-key lexsort, and the centroid accumulation is one (N,4) row
scatter-add of ``[x, y, z, 1]`` instead of separate sum/count scatters.
On a GPU that scatter-add runs with atomics, so the summation order (and
the last bits of a centroid) can differ from run to run.  The 10-bit axis
packing aliases voxels
exactly 1024 leaves apart INSIDE one scan batch — at the 0.5-1 m leaves
used everywhere that is a ≥512 m in-scan extent, beyond any supported
sensor range (and an alias would merely merge two centroids of one scan).
"""

from __future__ import annotations

import jax.numpy as jnp

from fast_limo_tpu.ops import sort as psort


def voxel_downsample(pts, valid, leaf: float):
    """Centroid-per-voxel downsample at fixed shape.

    pts: (N,3), valid: (N,). Returns (out_pts (N,3), out_valid (N,)) where
    out_valid marks one centroid per occupied voxel, compacted to the front
    in voxel-sorted order.
    """
    N = pts.shape[0]
    vc = jnp.floor(pts / leaf).astype(jnp.int32)

    key = (((vc[:, 0] & 0x3FF) << 20)
           | ((vc[:, 1] & 0x3FF) << 10)
           | (vc[:, 2] & 0x3FF))
    key = jnp.where(valid, key, jnp.int32(0x7FFFFFFF))  # invalids sort last
    key_s, order = psort.sort_key_val(key, jnp.arange(N, dtype=jnp.int32))

    # ONE row gather applies the permutation to points+validity together
    # (row-gather cost is per-row, width-independent)
    fused = jnp.concatenate(
        [pts, valid.astype(pts.dtype)[:, None]], axis=1)    # (N,4)
    perm = fused[order]
    valid_s = perm[:, 3] > 0
    pts_s = jnp.where(valid_s[:, None], perm[:, :3], 0.0)

    new_seg = jnp.concatenate(
        [jnp.array([True]), key_s[1:] != key_s[:-1]]) & valid_s

    # segment ids: 0..S-1 for valid segments (invalid tail gets garbage ids, masked)
    seg_id = jnp.cumsum(new_seg.astype(jnp.int32)) - 1
    seg_id = jnp.where(valid_s, seg_id, N - 1)

    acc = jnp.concatenate(
        [pts_s, valid_s[:, None].astype(pts.dtype)], axis=1)   # (N,4)
    sums = jnp.zeros((N, 4), pts.dtype).at[seg_id].add(acc)

    n_seg = jnp.sum(new_seg)
    out_valid = jnp.arange(N) < n_seg
    centroids = sums[:, :3] / jnp.maximum(sums[:, 3], 1)[:, None]
    return jnp.where(out_valid[:, None], centroids, 0.0), out_valid
