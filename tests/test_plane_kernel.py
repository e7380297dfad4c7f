"""ops/plane.fit_planes vs the float64 NumPy plane-fit oracle
(tests/pipeline_oracle.fit_planes: np.linalg.eigh, an independent method
from the closed-form trigonometric eigensolver), including gate agreement
and NaN/inf padding."""

import jax.numpy as jnp
import numpy as np
import pytest

from fast_limo_tpu.ops import plane

import pipeline_oracle as po


@pytest.fixture
def rng():
    return np.random.default_rng(21)


def _case(rng, N=1000, k=5, planar_frac=0.7):
    """Neighbor sets: mostly near-planar patches, some volumetric/degenerate."""
    c = rng.uniform(-20, 20, (N, 3))
    n = rng.standard_normal((N, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    u = np.cross(n, [0.0, 0.0, 1.0])
    u[np.linalg.norm(u, axis=1) < 1e-3] = [1.0, 0, 0]
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    v = np.cross(n, u)
    ab = rng.uniform(-0.5, 0.5, (N, k, 2))
    pts = (c[:, None] + ab[..., :1] * u[:, None] + ab[..., 1:] * v[:, None])
    # off-plane noise; a fraction gets big noise (fails residual gate)
    noise = rng.normal(0, 0.02, (N, k, 1))
    big = rng.random(N) > planar_frac
    noise[big] *= 20
    pts = pts + noise * n[:, None]
    sq = np.sort(rng.uniform(0.01, 6.0, (N, k)), axis=1)
    valid = rng.random((N, k)) < 0.95
    return (jnp.asarray(pts, jnp.float32), jnp.asarray(sq, jnp.float32),
            jnp.asarray(valid))


KW = dict(max_dist_plane=5.0, plane_threshold=0.1)


def _oracle(nbrs, sq, valid):
    return po.fit_planes(np.asarray(nbrs, np.float64),
                         np.asarray(sq, np.float64), np.asarray(valid),
                         k=5, **KW)


def _compare(nbrs, sq, valid):
    got_n, got_g = plane.fit_planes(nbrs, sq, valid, num_match_points=5, **KW)
    want_n, want_g = _oracle(nbrs, sq, valid)
    gg = np.asarray(got_g)
    # gates flip only on at-threshold f32-vs-f64 ties
    agree = np.mean(want_g == gg)
    assert agree > 0.995, agree
    both = want_g & gg
    np.testing.assert_allclose(np.asarray(got_n)[both], want_n[both],
                               rtol=5e-3, atol=5e-4)
    assert np.isfinite(np.asarray(got_n)[gg]).all()


def test_matches_jnp_fit(rng):
    _compare(*_case(rng))


def test_degenerate_and_padded_rows(rng):
    nbrs, sq, valid = _case(rng, N=512)
    nbrs = np.array(nbrs)
    valid = np.array(valid)
    # collinear neighbor sets (spread gate), all-invalid rows, inf padding
    nbrs[:40] = np.linspace(0, 1, 5)[None, :, None] * np.array([1.0, 2.0, 3.0])
    valid[40:60] = False
    nbrs[60:80] = np.inf
    valid[60:80] = False
    nbrs[80:100, 3:] = np.nan
    valid[80:100, 3:] = False
    got_n, got_g = plane.fit_planes(
        jnp.asarray(nbrs, jnp.float32), sq, jnp.asarray(valid),
        num_match_points=5, **KW)
    g = np.asarray(got_g)
    assert not g[:40].any()      # collinear → spread gate
    assert not g[40:60].any()    # not enough points
    assert not g[60:100].any()   # non-finite padding never passes
    assert np.isfinite(np.asarray(got_n)[g]).all()

    # the oracle agrees wherever its f64 eigh is defined (finite rows)
    fin = np.r_[0:60, 100:512]
    want_n, want_g = _oracle(nbrs[fin], np.asarray(sq)[fin], valid[fin])
    np.testing.assert_array_equal(want_g[:60], g[:60])
    assert np.mean(want_g == g[fin]) > 0.995
