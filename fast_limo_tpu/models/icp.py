"""Small-cloud rigid registration for loop-closure verification.

Array-program ICP: correspondence search is a dense (M,N) squared-distance
matrix — one big matmul — followed by a weighted Kabsch/Umeyama
solve per iteration inside `lax.scan`.  Used to turn a ScanContext hit into
a verified relative-pose constraint (and for KISS-Matcher-style
relocalization refinement).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from fast_limo_tpu.ops import so3


class ICPResult(NamedTuple):
    quat: jnp.ndarray       # (4,) target←source rotation
    trans: jnp.ndarray      # (3,)
    rmse: jnp.ndarray       # () inlier RMSE
    n_inliers: jnp.ndarray  # () int32
    converged: jnp.ndarray  # () bool


def _sq_dists(a, b):
    """(M,N) squared distances via the |a|²+|b|²−2a·b expansion (a matmul)."""
    return (jnp.sum(a * a, axis=-1)[:, None]
            + jnp.sum(b * b, axis=-1)[None, :]
            - 2.0 * a @ b.T)


def _kabsch(src, dst, w):
    """Weighted rigid alignment src→dst: returns (R, t)."""
    wsum = jnp.maximum(jnp.sum(w), 1e-9)
    mu_s = jnp.sum(src * w[:, None], axis=0) / wsum
    mu_d = jnp.sum(dst * w[:, None], axis=0) / wsum
    S = ((src - mu_s) * w[:, None]).T @ (dst - mu_d)
    U, _, Vt = jnp.linalg.svd(S)
    d = jnp.sign(jnp.linalg.det(Vt.T @ U.T))
    D = jnp.diag(jnp.asarray([1.0, 1.0, 1.0]).astype(src.dtype)).at[2, 2].set(d)
    R = Vt.T @ D @ U.T
    t = mu_d - R @ mu_s
    return R, t


@functools.partial(jax.jit, static_argnames=("iters", "coarse_mult"))
def icp(src, src_valid, dst, dst_valid, *, init_quat=None, init_trans=None,
        max_corr_dist: float = 2.0, iters: int = 10,
        coarse_mult: float = 4.0) -> ICPResult:
    """Point-to-point ICP aligning ``src`` onto ``dst``.

    src (M,3) / dst (N,3) with validity masks; init transform optional.
    The correspondence gate anneals from ``coarse_mult*max_corr_dist`` down
    to ``max_corr_dist`` (coarse-to-fine) so far, rotation-informative points
    aren't rejected before the pose is roughly right.
    """
    dtype = src.dtype
    q0 = init_quat if init_quat is not None else so3.quat_identity(dtype)
    t0 = init_trans if init_trans is not None else jnp.zeros(3, dtype)

    big = jnp.asarray(1e9, dtype)
    dst_masked = jnp.where(dst_valid[:, None], dst, big)
    gates = jnp.linspace(coarse_mult, 1.0, iters) * max_corr_dist

    def step(carry, gate):
        q, t = carry
        moved = so3.quat_rotate(q, src) + t
        d2 = _sq_dists(jnp.where(src_valid[:, None], moved, -big), dst_masked)
        nn = jnp.argmin(d2, axis=1)
        # the |a|²+|b|²−2a·b expansion can go slightly negative in f32
        nn_d2 = jnp.maximum(jnp.take_along_axis(d2, nn[:, None], axis=1)[:, 0], 0.0)
        w = (src_valid & (nn_d2 < gate * gate)).astype(dtype)
        R_d, t_d = _kabsch(moved, dst[nn], w)
        q_new = so3.quat_mul(so3.mat_to_quat(R_d), q)
        t_new = R_d @ t + t_d
        rmse = jnp.sqrt(jnp.sum(nn_d2 * w) / jnp.maximum(jnp.sum(w), 1.0))
        return (q_new, t_new), (rmse, jnp.sum(w))

    (q, t), (rmses, ws) = jax.lax.scan(step, (q0, t0), gates.astype(dtype))
    return ICPResult(quat=q, trans=t, rmse=rmses[-1],
                     n_inliers=ws[-1].astype(jnp.int32),
                     converged=rmses[-1] < max_corr_dist)


@functools.partial(jax.jit, static_argnames=("k", "chunk"))
def estimate_normals(pts, valid, *, k: int = 12, chunk: int = 1024):
    """Per-point unit normals from k-NN centered PCA (batched, chunked).

    The (chunk,N) distance tiles keep memory bounded for rebuild-density
    clouds (8192² f32 would be 268 MB; 8×(1024×8192) streams at 32 MB).
    Returns ``(normals (N,3), ok (N,))`` — ``ok`` is False where the
    neighborhood is rank-deficient or the point is invalid.  Orientation is
    arbitrary (point-to-plane residuals are sign-invariant through GN).
    """
    from fast_limo_tpu.ops import plane as plane_op

    dtype = pts.dtype
    N = pts.shape[0]
    big = jnp.asarray(1e9, dtype)
    masked = jnp.where(valid[:, None], pts, big)

    pad = (-N) % chunk
    q_all = jnp.concatenate([masked, jnp.full((pad, 3), -big, dtype)]) \
        if pad else masked

    def one_chunk(q):
        d2 = _sq_dists(q, masked)                       # (chunk, N)
        neg, idx = jax.lax.top_k(-d2, k)                # ascending distance
        nbrs = pts[idx]                                 # (chunk, k, 3)
        nvalid = valid[idx] & (-neg < big)
        c = jnp.sum(nbrs * nvalid[..., None], axis=1) \
            / jnp.maximum(jnp.sum(nvalid, axis=1), 1.0)[:, None]
        qv = (nbrs - c[:, None, :]) * nvalid[..., None]
        M = jnp.einsum("nki,nkj->nij", qv, qv)
        lmin, lmid, _ = plane_op._eigvals_sym3(M)
        n_unit, ok = plane_op._null_vector(M, lmin)
        # surface-ness: the patch must be anisotropic (planar, not volumetric
        # noise) and populated
        ok = ok & (jnp.sum(nvalid, axis=1) >= 5) & (lmid > 4.0 * lmin)
        return n_unit, ok

    nrm, ok = jax.lax.map(one_chunk,
                          q_all.reshape(-1, chunk, 3))
    nrm = nrm.reshape(-1, 3)[:N]
    ok = ok.reshape(-1)[:N] & valid
    return nrm, ok


@functools.partial(jax.jit, static_argnames=("iters",))
def icp_point_to_plane(src, src_valid, dst, dst_valid, dst_normals, nrm_ok,
                       *, init_quat, init_trans, max_corr_dist: float = 1.0,
                       iters: int = 8, huber: float = 0.3) -> ICPResult:
    """Point-to-plane refinement (GICP-class accuracy on structured scenes).

    Minimizes ``Σ w·(n_j·(R·p_i + t − q_j))²`` by Gauss-Newton with Huber
    IRLS weights — the residual is the distance to the matched SURFACE, so
    convergence is quadratic along the constraint directions instead of
    stalling at the point-sampling density like point-to-point Kabsch
    (which plateaus at ~half the cloud's sampling distance).  Run AFTER a
    coarse point-to-point alignment; the reference's relocation branch uses
    GICP the same way (README.md:201-215).
    """
    dtype = src.dtype
    big = jnp.asarray(1e9, dtype)
    dst_masked = jnp.where((dst_valid & nrm_ok)[:, None], dst, big)

    def step(carry, _):
        q, t = carry
        moved = so3.quat_rotate(q, src) + t
        d2 = _sq_dists(jnp.where(src_valid[:, None], moved, -big), dst_masked)
        nn = jnp.argmin(d2, axis=1)
        nn_d2 = jnp.maximum(
            jnp.take_along_axis(d2, nn[:, None], axis=1)[:, 0], 0.0)
        n = dst_normals[nn]                              # (M,3)
        r = jnp.sum(n * (moved - dst[nn]), axis=-1)      # (M,)
        w = (src_valid & (nn_d2 < max_corr_dist * max_corr_dist)
             ).astype(dtype)
        # Huber IRLS on the plane residual
        w = w * jnp.minimum(1.0, huber / jnp.maximum(jnp.abs(r), 1e-9))
        J = jnp.concatenate([jnp.cross(moved, n), n], axis=-1)   # (M,6)
        Jw = J * w[:, None]
        A = Jw.T @ J + 1e-6 * jnp.eye(6, dtype=dtype)
        b = -Jw.T @ r
        xi = jnp.linalg.solve(A, b)                      # [ω, δt]
        dq = so3.exp_quat(xi[:3])
        q_new = so3.quat_normalize(so3.quat_mul(dq, q))
        t_new = so3.quat_rotate(dq, t) + xi[3:]
        wsum = jnp.maximum(jnp.sum(w), 1.0)
        rmse = jnp.sqrt(jnp.sum(w * r * r) / wsum)
        n_in = jnp.sum((w > 0).astype(jnp.int32))
        return (q_new, t_new), (rmse, n_in)

    (q, t), (rmses, n_ins) = jax.lax.scan(
        step, (init_quat.astype(dtype), init_trans.astype(dtype)),
        jnp.arange(iters))
    return ICPResult(quat=q, trans=t, rmse=rmses[-1], n_inliers=n_ins[-1],
                     converged=rmses[-1] < max_corr_dist)
