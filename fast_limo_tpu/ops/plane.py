"""Batched plane fitting with the reference's validity gates.

Counterpart of `fast_limo::Plane` (Objects/Plane.cpp:23-121): fit a plane
through each query's k neighbors and gate on

* enough neighbors (Plane.cpp:41-43),
* kth-neighbor *squared* distance < MAX_DIST_PLANE (Plane.cpp:45-48 — the
  octree returns squared distances, Octree.hpp:571-575),
* all neighbor residuals within PLANE_THRESHOLD (Plane.cpp:107-114).

Deliberate divergence from the reference's ESTIMATOR (gates preserved):
the reference solves ``A·n = -1`` on raw world coordinates
(Plane.cpp:84-95), an estimator that is

* origin-DEPENDENT — its normal-equation system has condition
  ~(|p|/spread)², so a naive f32 solve is cancellation noise 30 m from the
  origin (measured: ~2/3 of early-scan gate decisions flipped vs f64), and
* DEGENERATE for planes passing near the origin — the plane offset is
  ``d = 1/|n_raw|``, so ``d → 0`` needs ``|n_raw| → ∞``; for a ground
  plane through the start pose the LSQ returns an ill-determined normal
  that still passes the residual gate (points fit many planes), feeding
  garbage rows into H.  (Verified: with a backward-stable QR solve of the
  reference system, a z≈0 ground plane makes tracking diverge.)

Here the fit is the translation-invariant centroid-PCA plane: normal =
eigenvector of the smallest eigenvalue of the centered neighbor scatter
``M = Σ (p−c)(p−c)ᵀ``, offset ``D = −n·c``.  Residuals are identical in
form (``n·p + D = n·(p−c)``), all arithmetic is conditioned on the
neighbor SPREAD (f32 matches f64 to rounding — tests/test_e2e_oracle.py),
and the fit is well-defined for every plane pose.  The 3×3 symmetric
eigenproblem is solved in closed form (trigonometric) and fully
vectorized — elementwise work that XLA fuses, with no solver calls.

One additional gate the reference lacks: the MIDDLE eigenvalue must exceed
``n_valid · PLANE_THRESHOLD²`` — a genuine planar patch must extend beyond
the residual threshold in its second principal direction.  Near-collinear
neighbor sets (whose normal is unconstrained yet residual-gate-clean) are
rejected instead of contributing random normals.
"""

from __future__ import annotations

import jax.numpy as jnp


def _eigvals_sym3(M):
    """Closed-form ascending eigenvalues of batched symmetric 3×3 matrices.

    Trigonometric method (stable for the PSD scatter matrices here: the
    matrix is first shifted/scaled by its own trace/deviator norm, so all
    intermediates are O(1) regardless of point scale).
    Returns (lmin, lmid, lmax).
    """
    dtype = M.dtype
    m01, m02, m12 = M[..., 0, 1], M[..., 0, 2], M[..., 1, 2]
    m00, m11, m22 = M[..., 0, 0], M[..., 1, 1], M[..., 2, 2]
    p1 = m01 * m01 + m02 * m02 + m12 * m12
    q = (m00 + m11 + m22) / 3.0
    p2 = ((m00 - q) ** 2 + (m11 - q) ** 2 + (m22 - q) ** 2) + 2.0 * p1
    p = jnp.sqrt(jnp.maximum(p2 / 6.0, 0.0))
    psafe = jnp.where(p > 0, p, 1.0)
    b00, b11, b22 = (m00 - q) / psafe, (m11 - q) / psafe, (m22 - q) / psafe
    c01, c02, c12 = m01 / psafe, m02 / psafe, m12 / psafe
    detB = (b00 * (b11 * b22 - c12 * c12)
            - c01 * (c01 * b22 - c12 * c02)
            + c02 * (c01 * c12 - b11 * c02))
    r = jnp.clip(detB / 2.0, -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    two_pi_3 = jnp.asarray(2.0943951023931953, dtype)
    lmax = q + 2.0 * p * jnp.cos(phi)
    lmin = q + 2.0 * p * jnp.cos(phi + two_pi_3)
    lmid = 3.0 * q - lmax - lmin
    # p == 0: all eigenvalues equal q
    iso = p2 <= 0
    lmax = jnp.where(iso, q, lmax)
    lmid = jnp.where(iso, q, lmid)
    lmin = jnp.where(iso, q, lmin)
    return lmin, lmid, lmax


def _null_vector(M, lam):
    """Unit vector spanning the (near-)null space of ``M − lam·I``.

    The null vector is orthogonal to every row; take the largest-norm cross
    product of row pairs (robust rank-2 null-space extraction).
    """
    A = M - lam[..., None, None] * jnp.eye(3, dtype=M.dtype)
    r0, r1, r2 = A[..., 0, :], A[..., 1, :], A[..., 2, :]
    c01 = jnp.cross(r0, r1)
    c02 = jnp.cross(r0, r2)
    c12 = jnp.cross(r1, r2)
    n01 = jnp.sum(c01 * c01, axis=-1)
    n02 = jnp.sum(c02 * c02, axis=-1)
    n12 = jnp.sum(c12 * c12, axis=-1)
    best = jnp.where((n01 >= n02)[..., None] & (n01 >= n12)[..., None], c01,
                     jnp.where((n02 >= n12)[..., None], c02, c12))
    bestn = jnp.maximum(jnp.max(jnp.stack([n01, n02, n12], -1), -1), 0.0)
    norm = jnp.sqrt(bestn)
    ok = norm > 1e-20
    return best / jnp.where(ok, norm, 1.0)[..., None], ok


def fit_planes(nbrs, sq_dists, nbr_valid, *, num_match_points: int,
               max_dist_plane: float, plane_threshold: float):
    """Fit planes through each query's k neighbors (see module docstring).

    nbrs: (N,k,3); sq_dists: (N,k) ascending; nbr_valid: (N,k).
    Returns (n_abcd (N,4), good (N,)) with the plane as ``n·p + d ≈ 0``,
    ``|n| = 1``, ``d ≥ 0`` (the reference's sign convention — the filter is
    invariant to the per-row sign anyway: flipping (n, d) flips both the H
    row and the residual h).
    """
    N, k, _ = nbrs.shape
    n_valid = jnp.sum(nbr_valid, axis=-1)

    enough = n_valid >= num_match_points
    kth = sq_dists[:, num_match_points - 1] if num_match_points <= k else jnp.full(N, jnp.inf)
    close = kth < max_dist_plane

    # centered scatter over valid neighbors
    w = nbr_valid[..., None].astype(nbrs.dtype)
    nw = jnp.maximum(jnp.sum(w, axis=1), 1.0)                  # (N,1)
    c = jnp.sum(nbrs * w, axis=1) / nw                         # (N,3)
    qv = (nbrs - c[:, None, :]) * w                            # (N,k,3)
    M = jnp.einsum("nki,nkj->nij", qv, qv)                     # (N,3,3)

    lmin, lmid, _lmax = _eigvals_sym3(M)
    n_unit, ok = _null_vector(M, lmin)

    # d ≥ 0 sign convention (Plane.cpp d = 1/|n| > 0)
    d = -jnp.sum(n_unit * c, axis=-1)
    flip = jnp.where(d < 0, -1.0, 1.0).astype(nbrs.dtype)
    n_unit = n_unit * flip[..., None]
    d = d * flip
    n_abcd = jnp.concatenate([n_unit, d[..., None]], axis=-1)  # (N,4)

    # residual gate (centered form — exact): |n·(p − c)| within threshold
    res = jnp.einsum("nki,ni->nk", qv, n_unit)
    res_ok = jnp.all(jnp.where(nbr_valid, jnp.abs(res) <= plane_threshold, True), axis=-1)

    # planarity gate: the patch must extend beyond the residual threshold
    # in its second principal direction (rejects collinear neighbor sets)
    spread_ok = lmid > nw[:, 0] * (plane_threshold * plane_threshold)

    good = enough & close & ok & res_ok & spread_ok & jnp.all(
        jnp.isfinite(n_abcd), axis=-1)
    return n_abcd, good


def point_to_plane(n_abcd, pts):
    """Signed distance n·p + d (Plane.cpp:50-56)."""
    return jnp.sum(n_abcd[..., :3] * pts, axis=-1) + n_abcd[..., 3]
