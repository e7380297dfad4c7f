"""ops/sort — the pipeline's stable integer sorts vs a stable NumPy lexsort."""

import jax.numpy as jnp
import numpy as np
import pytest

from fast_limo_tpu.ops import sort as psort


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def _ref(k1, k2, v):
    """Stable NumPy sort by (k1, k2): ties keep their original order."""
    order = np.lexsort((np.arange(len(k1)), k2, k1))
    return k1[order], k2[order], v[order]


@pytest.mark.parametrize("n", [128, 256, 1000, 2048])
def test_matches_stable_xla_sort(rng, n):
    """sort3 equals the stable 2-key NumPy lexsort element for element, with
    many duplicate keys and a NON-unique payload (stability alone decides
    the order of equal keys)."""
    k1 = rng.integers(0, 50, n).astype(np.int32)      # many duplicate keys
    k2 = rng.integers(0, 7, n).astype(np.int32)
    v = rng.integers(0, 5, n).astype(np.int32)
    got = psort.sort3(jnp.asarray(k1), jnp.asarray(k2), jnp.asarray(v))
    for g, w in zip(got, _ref(k1, k2, v)):
        np.testing.assert_array_equal(np.asarray(g), w)


def test_invalid_sentinel_sorts_last(rng):
    n = 700
    k1 = rng.integers(0, 100, n).astype(np.int32)
    bad = rng.random(n) < 0.3
    k1[bad] = np.int32(0x7FFFFFFF)                     # invalid convention
    k2 = rng.integers(0, 1 << 20, n).astype(np.int32)
    v = np.arange(n, dtype=np.int32)
    got = psort.sort3(jnp.asarray(k1), jnp.asarray(k2), jnp.asarray(v))
    for g, w in zip(got, _ref(k1, k2, v)):
        np.testing.assert_array_equal(np.asarray(g), w)
    assert got[0].shape == (n,)
    assert np.all(np.asarray(got[0])[n - bad.sum():] == 0x7FFFFFFF)


def test_dispatch_fallback_matches(rng):
    """sort_key_val (the voxel-downsample sort) is a stable single-key sort:
    equal keys keep their original order, negative keys included."""
    n = 512
    key = rng.integers(-1000, 1000, n).astype(np.int32)
    key[::7] = key[0]                                  # a long tie run
    val = np.arange(n, dtype=np.int32)
    got_k, got_v = psort.sort_key_val(jnp.asarray(key), jnp.asarray(val))
    order = np.argsort(key, kind="stable")
    np.testing.assert_array_equal(np.asarray(got_k), key[order])
    np.testing.assert_array_equal(np.asarray(got_v), val[order])
