"""Masked k-nearest selection (mapper.topk_from_candidates) vs NumPy brute
force."""

import jax.numpy as jnp
import numpy as np

from fast_limo_tpu.models import mapper


def make_case(rng, N=100, C=81):
    cand = rng.normal(size=(N, C, 3)).astype(np.float32) * 5
    valid = rng.random((N, C)) > 0.3
    q = rng.normal(size=(N, 3)).astype(np.float32) * 5
    return cand, valid, q


def brute_force(cand, valid, q, k):
    """Per-query ascending squared distances over the valid candidates."""
    d2 = np.sum((cand.astype(np.float64) - q[:, None, :]) ** 2, axis=-1)
    d2 = np.where(valid, d2, np.inf)
    idx = np.argsort(d2, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(d2, idx, axis=1)


def topk(cand, valid, q, k):
    # candidate buckets are (N, V, B, E); one flat bucket axis is enough here
    return mapper.topk_from_candidates(
        jnp.asarray(cand)[:, :, None, None, :], jnp.asarray(valid)[:, :, None, None],
        jnp.asarray(q), k=k)


class TestMaskedTopK:
    def test_matches_reference(self, rng):
        cand, valid, q = make_case(rng)
        n1, s1, v1 = topk(cand, valid, q, k=5)
        want = brute_force(cand, valid, q, 5)
        np.testing.assert_allclose(np.asarray(s1), want, rtol=1e-5)
        np.testing.assert_array_equal(np.asarray(v1), np.isfinite(want))
        # each returned neighbour is a valid candidate at the returned distance
        m = np.asarray(v1)
        d2 = np.sum((np.asarray(n1) - q[:, None, :]) ** 2, axis=-1)
        np.testing.assert_allclose(d2[m], np.asarray(s1)[m], rtol=1e-5)

    def test_all_invalid(self, rng):
        cand, _, q = make_case(rng, N=8)
        valid = np.zeros((8, 81), bool)
        _n1, s1, v1 = topk(cand, valid, q, k=5)
        assert not bool(jnp.any(v1))
        assert np.all(np.isinf(np.asarray(s1)))

    def test_fewer_than_k_valid(self, rng):
        cand, _, q = make_case(rng, N=4)
        valid = np.zeros((4, 81), bool)
        valid[:, :3] = True
        _n1, s1, v1 = topk(cand, valid, q, k=5)
        assert int(jnp.sum(v1)) == 4 * 3
        s = np.asarray(s1)
        np.testing.assert_allclose(s[:, :3], brute_force(cand, valid, q, 3),
                                   rtol=1e-5)
        for row in s:                                  # ascending, +inf pads
            fin = row[np.isfinite(row)]
            assert np.all(np.diff(fin) >= 0)
            assert np.all(np.isinf(row[3:]))
