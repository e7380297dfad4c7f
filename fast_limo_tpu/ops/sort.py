"""Stable integer sorts of the pipeline's key/payload passes.

`sort_key_val` groups voxel downsampling (ops/voxel.py) and `sort3` orders
a map-insert batch by (hash group, packed voxel key) (models/mapper.py).
Both are XLA's stable sort: ties keep their original order, so with an
``arange`` payload the order is total and reproducible.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def sort_key_val(key, val):
    """Stable single-key sort of int32 ``key`` carrying ``val``."""
    return jax.lax.sort_key_val(key.astype(jnp.int32), val.astype(jnp.int32))


def sort3(k1, k2, v):
    """Stable ascending sort by ``(k1, k2)``, carrying ``v``; ties keep
    their original order.  Returns the sorted ``(k1, k2, v)``."""
    return jax.lax.sort((k1.astype(jnp.int32), k2.astype(jnp.int32),
                         v.astype(jnp.int32)), num_keys=2)
