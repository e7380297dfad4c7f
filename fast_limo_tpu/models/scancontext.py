"""ScanContext place-recognition descriptors (Kim & Kim, IROS 2018).

The reference advertises ScanContext loop closure on its `loop/scancontext`
branch (README.md:34, 152-159) — not present in the snapshot — so this is a
from-paper array-program implementation: descriptors are polar
occupancy-height images built with scatter-max, and matching is correlation
over sector shifts expressed as batched matmuls rather than per-shift loops.

Descriptor: R rings × S sectors; cell = max z of points in the cell.
Ring-key: per-ring occupancy ratio (rotation invariant) for fast candidate
retrieval; full distance = 1 − max over sector shifts of the mean column-wise
cosine similarity.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

N_RING = 20
N_SECTOR = 60
MAX_RADIUS = 80.0


@functools.partial(jax.jit, static_argnames=("n_ring", "n_sector", "max_radius",
                                             "height_shift"))
def descriptor(points, valid, *, n_ring: int = N_RING, n_sector: int = N_SECTOR,
               max_radius: float = MAX_RADIUS, height_shift: float = 2.0):
    """(R,S) scan-context of a body-frame scan; empty cells = 0.

    Heights are shifted by ``height_shift`` (≈ sensor height above ground)
    so ground returns contribute positive occupancy, as in the original
    implementation.  All geometry knobs live in ``Config.sc`` — per-profile
    (low-mounted Hesai vs roof-mounted HDL-64) tuning.
    """
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    r = jnp.sqrt(x * x + y * y)
    theta = jnp.arctan2(y, x)  # [-pi, pi]
    ring = jnp.clip((r / max_radius * n_ring).astype(jnp.int32), 0, n_ring - 1)
    sector = jnp.clip(((theta + jnp.pi) / (2 * jnp.pi) * n_sector).astype(jnp.int32),
                      0, n_sector - 1)
    ok = valid & (r < max_radius) & (r > 1e-3)
    cell = ring * n_sector + sector
    cell = jnp.where(ok, cell, n_ring * n_sector)
    h = jnp.where(ok, z + height_shift, -jnp.inf)
    flat = jnp.full((n_ring * n_sector + 1,), -jnp.inf, points.dtype)
    flat = flat.at[cell].max(h)
    desc = flat[:-1].reshape(n_ring, n_sector)
    return jnp.where(jnp.isfinite(desc), desc, 0.0)


def ring_key(desc):
    """(R,) rotation-invariant key: per-ring occupancy ratio."""
    return jnp.mean((desc != 0.0).astype(desc.dtype), axis=-1)


def _colwise_cos(d1, d2):
    """Mean column-wise cosine similarity of two (R,S) descriptors.

    Columns where only ONE side is occupied score 0 and still count in the
    mean — averaging over the overlap alone lets a wrong shift with two
    accidentally-matching columns score 1.0 (sparse scenes alias badly).
    """
    num = jnp.sum(d1 * d2, axis=0)
    n1 = jnp.linalg.norm(d1, axis=0)
    n2 = jnp.linalg.norm(d2, axis=0)
    both = (n1 > 1e-9) & (n2 > 1e-9)
    either = (n1 > 1e-9) | (n2 > 1e-9)
    sim = jnp.where(both, num / jnp.where(both, n1 * n2, 1.0), 0.0)
    n_cols = jnp.maximum(jnp.sum(either.astype(d1.dtype)), 1.0)
    return jnp.sum(sim) / n_cols


@jax.jit
def distance(d1, d2):
    """ScanContext distance: min over all sector shifts of 1 − colwise cos.

    Returns (dist, best_shift). Vectorized over shifts with vmap; the inner
    products batch into matmuls.
    """
    S = d1.shape[1]

    def at_shift(s):
        return _colwise_cos(d1, jnp.roll(d2, s, axis=1))

    sims = jax.vmap(at_shift)(jnp.arange(S))
    best = jnp.argmax(sims)
    return 1.0 - sims[best], best


@jax.jit
def retrieve(query_key, keys, key_valid):
    """Ring-key L1 distances to all stored keyframes ((K,) with inf at invalid)."""
    d = jnp.sum(jnp.abs(keys - query_key[None, :]), axis=-1)
    return jnp.where(key_valid, d, jnp.inf)


def shift_to_yaw(shift, n_sector: int = N_SECTOR):
    """Sector shift → approximate relative yaw (rad)."""
    half = n_sector // 2
    signed = jnp.where(shift > half, shift - n_sector, shift)
    return -2.0 * jnp.pi * signed / n_sector
