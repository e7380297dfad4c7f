"""Unrolled small-matrix factorizations that fuse into the XLA graph.

`jnp.linalg.{eigh, cholesky, solve, inv}` lower to solver-library custom
calls (LAPACK on the CPU, cuSOLVER/cuBLAS on a GPU), each a separate
launch outside XLA's fusions whatever the size.  For the fixed tiny sizes
here (12×12 factorizations, ≤23 RHS) a Python-unrolled Cholesky /
triangular solve is a few dozen elementwise ops that XLA fuses.

Also provides the measurement-compression trick used by the update
(models/iekf.py): a MASKED Cholesky that factors HᵀH with exactly-zero
rows/columns (unobserved dimensions, e.g. extrinsics with
estimate_extrinsics=false) by planting unit pivots on the zero diagonals
and zeroing the corresponding compressed-measurement rows afterwards — the
planted column of L is exactly e_k, so removing it reproduces HᵀH exactly
(no ridge, no bias).
"""

from __future__ import annotations

import jax.numpy as jnp


def chol(A, *, dead_thresh=0.0):
    """Lower-triangular Cholesky of a small SPD matrix, fully unrolled.

    A pivot ≤ ``dead_thresh`` marks a numerically dead direction: its whole
    column becomes zero (instead of NaN/explosion), i.e. that rank-1 piece
    is dropped from the factorization — the same graceful degradation as an
    eigendecomposition discarding tiny eigenvalues.  ``dead_thresh`` may be
    a traced scalar (e.g. ``1e-12 * max(diag)``).
    """
    n = A.shape[0]
    dtype = A.dtype
    cols = []
    for j in range(n):
        a_j = A[:, j]
        for L_k in cols:
            a_j = a_j - L_k * L_k[j]
        d = a_j[j]
        alive = d > dead_thresh
        safe = jnp.sqrt(jnp.clip(d, 1e-30, None))
        inv = jnp.where(alive, 1.0 / safe, 0.0)
        col = a_j * inv
        # zero the strictly-upper part of this column
        mask = (jnp.arange(n) >= j).astype(dtype)
        cols.append(col * mask)
    return jnp.stack(cols, axis=1)


def solve_lower(L, B):
    """x with L x = B (L lower-triangular), unrolled forward substitution.

    B may be (n,) or (n, m).
    """
    n = L.shape[0]
    vec = B.ndim == 1
    if vec:
        B = B[:, None]
    X = jnp.zeros_like(B)
    rows = []
    for i in range(n):
        acc = B[i]
        for k, r in enumerate(rows):
            acc = acc - L[i, k] * r
        d = L[i, i]
        inv = jnp.where(d != 0, 1.0 / jnp.where(d != 0, d, 1.0), 0.0)
        rows.append(acc * inv)
    X = jnp.stack(rows, axis=0)
    return X[:, 0] if vec else X


def solve_upper(U, B):
    """x with U x = B (U upper-triangular), unrolled back substitution."""
    n = U.shape[0]
    vec = B.ndim == 1
    if vec:
        B = B[:, None]
    rows = [None] * n
    for i in reversed(range(n)):
        acc = B[i]
        for k in range(i + 1, n):
            acc = acc - U[i, k] * rows[k]
        d = U[i, i]
        inv = jnp.where(d != 0, 1.0 / jnp.where(d != 0, d, 1.0), 0.0)
        rows[i] = acc * inv
    X = jnp.stack(rows, axis=0)
    return X[:, 0] if vec else X


def chol_solve(L, B):
    """x with (L Lᵀ) x = B given the Cholesky factor."""
    return solve_upper(L.T, solve_lower(L, B))


def spd_solve(A, B):
    """x with A x = B for small SPD A — one fused unrolled factor+solve.

    Jacobi-preconditioned: the diagonal is rescaled to 1 before factoring
    (A = D^½ Ã D^½), which keeps f32 Cholesky accurate when the diagonal
    spans many decades (the iEKF innovation matrix mixes unit rows with
    ~1e9 information rows).
    """
    d = jnp.sqrt(jnp.clip(jnp.abs(jnp.diagonal(A)), 1e-30, None))
    As = A / d[:, None] / d[None, :]
    vec = B.ndim == 1
    Bs = (B / d) if vec else (B / d[:, None])
    L = chol(As)
    x = chol_solve(L, Bs)
    # two rounds of iterative refinement: the unpivoted factor alone loses
    # accuracy at high condition numbers; refreshing against the exact
    # residual recovers it (all fused ops, no custom calls)
    for _ in range(2):
        r = Bs - As @ x
        x = x + chol_solve(L, r)
    return (x / d) if vec else (x / d[:, None])


def qr_solve(A, B):
    """x with A x = B via fully-unrolled Householder QR (small square A).

    Unconditionally backward stable WITHOUT pivoting — unlike Cholesky it
    tolerates the slight indefiniteness/asymmetry that f32 covariance
    round-off induces (the iEKF innovation matrix), and unlike
    ``jnp.linalg.solve`` it fuses into the XLA graph instead of lowering to
    a solver custom call per invocation.

    Jacobi row/column pre-scaling keeps reflector norms well-ranged when the
    diagonal spans many decades.  B may be (n,) or (n, m).
    """
    n = A.shape[0]
    dtype = A.dtype
    vec = B.ndim == 1
    if vec:
        B = B[:, None]

    # symmetric Jacobi scaling (A need not be symmetric; this just ranges it)
    d = jnp.sqrt(jnp.clip(jnp.abs(jnp.diagonal(A)), 1e-30, None))
    R_ = A / d[:, None] / d[None, :]
    Qt_B = B / d[:, None]

    idx = jnp.arange(n)
    for k in range(n):
        mask = (idx >= k).astype(dtype)                  # rows k..n-1
        x = R_[:, k] * mask
        nrm = jnp.sqrt(jnp.sum(x * x))
        xk = x[k]
        alpha = -jnp.sign(jnp.where(xk == 0, 1.0, xk)) * nrm
        v = x - alpha * (idx == k).astype(dtype)
        vtv = jnp.sum(v * v)
        beta = jnp.where(vtv > 0, 2.0 / jnp.where(vtv > 0, vtv, 1.0), 0.0)
        R_ = R_ - beta * jnp.outer(v, v @ R_)
        Qt_B = Qt_B - beta * jnp.outer(v, v @ Qt_B)

    X = solve_upper(R_, Qt_B) / d[:, None]
    return X[:, 0] if vec else X


def masked_chol_compress(HTH, HTh):
    """Exact 12-row compression of (HᵀH, Hᵀh) with unobserved dims.

    Returns (Ht (n,n) compressed measurement matrix H̃, h (n,) compressed
    innovation h̃) with H̃ᵀH̃ == HᵀH and H̃ᵀh̃ == Hᵀh exactly (up to
    rounding), including when HᵀH has exactly-zero rows/columns.
    """
    n = HTH.shape[0]
    diag = jnp.diagonal(HTH)
    iszero = diag == 0
    A = HTH + jnp.diag(iszero.astype(HTH.dtype))
    # rank threshold matched to the eigh path it replaces (λ > 1e-12·λmax)
    L = chol(A, dead_thresh=1e-12 * jnp.max(diag, initial=0.0))
    Ht = L.T * (~iszero).astype(HTH.dtype)[:, None]   # zero filler rows
    h = solve_lower(L, HTh)
    h = jnp.where(iszero, 0.0, h)
    return Ht, h
