"""Iterated error-state Kalman filter on the 23-DOF manifold.

Behavioral counterpart of `esekfom::esekf<state_ikfom, 12, input_ikfom>` —
specifically `predict` (esekfom.hpp:279-384) and
`update_iterated_dyn_share_modified` (esekfom.hpp:1620-1823) — specialized to
the fixed fast-LIMO state layout and written as pure fixed-shape JAX
functions.  All covariance algebra is tiny dense linear algebra (23×23,
12×12) that XLA fuses into a handful of ops.

Parity quirks deliberately replicated from the reference:

* esekfom.hpp:312/344 call ``MTK::exp(…, scalar_type(1/2))`` — **C++ integer
  division**, so the SO3/S2 "res" rotations in predict are identity.  The
  F_x1 SO3 diagonal blocks are therefore I, and the S2 block is ``Nx·Mx``.
* The degeneracy guard (esekfom.hpp:1736-1744) zeroes *rows* of the
  eigenvector matrix whose eigenvalue is below D, then applies
  ``V⁻¹·V_sel``.  We use ``eigh`` (HᵀH is symmetric) with ascending
  eigenvalue order.
* Convergence is tested on the *pre-degeneracy* update ``dx_``
  (esekfom.hpp:1749-1756); the boxplus uses the degeneracy-guarded vector.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from fast_limo_tpu.models import process
from fast_limo_tpu.models import state as st
from fast_limo_tpu.ops import gain as gain_op
from fast_limo_tpu.ops import s2, so3

N = st.ERR_DIM  # 23
M_OBS = 12      # columns of the measurement Jacobian (esekfom.hpp:1647)


class FilterState(NamedTuple):
    x: st.NavState
    P: jnp.ndarray  # (23, 23)


def init_P(dtype=jnp.float32):
    """Initial covariance (Localizer.cpp:685-693)."""
    d = jnp.ones(N, dtype=dtype)
    d = d.at[6:9].set(1e-6)      # offset_R_L_I
    d = d.at[9:12].set(1e-6)     # offset_T_L_I
    d = d.at[15:18].set(1e-5)    # bg
    d = d.at[18:21].set(1e-4)    # ba
    d = d.at[21:23].set(1e-6)    # grav
    return jnp.diag(d)


# ---------------------------------------------------------------------------
# predict
# ---------------------------------------------------------------------------

def predict(x: st.NavState, P, acc, gyro, dt, Q):
    """One covariant EKF prediction step (esekfom.hpp:279-384).

    acc/gyro are bias-*uncorrected* baselink-frame IMU measurements (the
    state's bg/ba handle biases); dt is the IMU sample period.
    """
    x_new, F, GQG = _predict_mats(x, acc, gyro, dt, Q)
    P_new = F @ P @ F.T + GQG
    return x_new, 0.5 * (P_new + P_new.T)


def _predict_mats(x: st.NavState, acc, gyro, dt, Q):
    """(x_new, F (23,23), Gw·Q·Gwᵀ (23,23)) of one prediction step."""
    dtype = x.dtype
    f_ = process.f(x, acc, gyro)          # (24,)
    fx = process.df_dx(x, acc, gyro)      # (24, 23)
    fw = process.df_dw(x, acc, gyro)      # (24, 12)

    x_new = st.oplus_flat(x, f_, dt)

    # --- assemble f_x_final / f_w_final with per-block chart corrections ---
    # vect rows (idx == dim for all blocks before grav): straight copy
    f_x_final = jnp.zeros((N, N), dtype=dtype).at[0:21].set(fx[0:21])
    f_w_final = jnp.zeros((N, st.NOISE_DIM), dtype=dtype).at[0:21].set(fw[0:21])
    F_x1 = jnp.eye(N, dtype=dtype)

    # SO3 rows (rot, offset_R): res_temp = A_matrix(-f*dt)
    for idx in st.SO3_IDXS:
        seg = -f_[idx:idx + 3] * dt
        # reference F_x1 block = exp(seg, scale=0) == identity (parity quirk);
        # nothing to set.
        A = so3.A_matrix(seg)
        f_x_final = f_x_final.at[idx:idx + 3].set(A @ fx[idx:idx + 3])
        f_w_final = f_w_final.at[idx:idx + 3].set(A @ fw[idx:idx + 3])

    # S2 rows (grav): Nx on the *updated* state, Mx on the prior state
    g_idx = st.GRAV
    seg = f_[g_idx:g_idx + 3] * dt
    Nx = s2.Nx_yy(x_new.grav)                                   # (2,3)
    Mx = s2.Mx(x.grav, jnp.zeros(2, dtype=dtype))               # (3,2)
    F_x1 = F_x1.at[g_idx:g_idx + 2, g_idx:g_idx + 2].set(Nx @ Mx)
    res2 = -Nx @ so3.hat(x.grav) @ so3.A_matrix(seg).T          # (2,3)
    f_x_final = f_x_final.at[g_idx:g_idx + 2].set(res2 @ fx[g_idx:g_idx + 3])
    f_w_final = f_w_final.at[g_idx:g_idx + 2].set(res2 @ fw[g_idx:g_idx + 3])

    F = F_x1 + f_x_final * dt
    Gw = dt * f_w_final
    return x_new, F, Gw @ Q @ Gw.T


def predict_scan(x: st.NavState, P, imu_stack, Q):
    """Batched prediction over a padded IMU window with a validity mask.

    imu_stack: dict-like pytree with ``acc (K,3)``, ``gyro (K,3)``,
    ``dt (K,)``, ``valid (K,) bool``.  Invalid samples pass through.
    Returns final (x, P) plus the stacked propagated states (for deskew),
    mirroring the propagated_buffer the reference fills per IMU tick
    (Localizer.cpp:600-605).

    Parallel structure — the K-step chain has NO sequential part at all:
    1. the mean chain is preintegration in disguise: the orientation is a
       prefix product of per-step exponential quaternions (associative →
       ``lax.associative_scan``, log₂K depth), and velocity/position are
       cumsums of the world-frame accelerations / pre-step velocities
       (``d(pos)=vel``, ``d(vel)=R(a−ba)+g`` — process.f, use-ikfom.cpp:43),
    2. all K Jacobians (F_k, G_k Q G_kᵀ) are computed in one vmap batch
       from the propagated means,
    3. the covariance map P ↦ F P Fᵀ + GQG is affine, so the K maps fold
       into one in log₂K levels of batched 23×23 compositions:
       (A₂,B₂)∘(A₁,B₁) = (A₂A₁, A₂B₁A₂ᵀ + B₂), then P_f = A P Aᵀ + B.
    Algebraically identical to the sequential chain (f32 rounding differs
    only in association order).  Invalid samples get dt=0, which is an
    exact passthrough (exp(0)=identity, zero increments).
    """
    dtype = x.dtype
    valid = imu_stack["valid"]
    K = valid.shape[0]

    dt_m = jnp.where(valid, imu_stack["dt"], 0).astype(dtype)       # (K,)
    omega = (imu_stack["gyro"] - x.bg[None]) * dt_m[:, None]        # (K,3)
    chain = jnp.concatenate([x.rot[None], so3.exp_quat(omega)], axis=0)
    q_incl = jax.lax.associative_scan(so3.quat_mul, chain, axis=0)  # (K+1,4)
    q_after = q_incl[1:]
    a_world = so3.quat_rotate(
        q_incl[:-1], imu_stack["acc"] - x.ba[None]) + x.grav[None]  # at pre-step q
    v_after = x.vel[None] + jnp.cumsum(a_world * dt_m[:, None], axis=0)
    v_before = jnp.concatenate([x.vel[None], v_after[:-1]], axis=0)
    p_after = x.pos[None] + jnp.cumsum(v_before * dt_m[:, None], axis=0)

    const = lambda a: jnp.broadcast_to(a[None], (K,) + a.shape)
    xs = st.NavState(
        pos=p_after, rot=q_after, rot_LI=const(x.rot_LI),
        t_LI=const(x.t_LI), vel=v_after, bg=const(x.bg), ba=const(x.ba),
        grav=const(x.grav))
    x_f = jax.tree_util.tree_map(lambda a: a[-1], xs)

    # each step's Jacobians are functions of its PREVIOUS state
    x_prev = jax.tree_util.tree_map(
        lambda a, b: jnp.concatenate([a[None], b[:-1]], axis=0), x, xs)
    _, F_k, GQG_k = jax.vmap(
        lambda xp, a, g, dt: _predict_mats(xp, a, g, dt, Q))(
        x_prev, imu_stack["acc"], imu_stack["gyro"], imu_stack["dt"])

    eye = jnp.eye(N, dtype=dtype)
    F_k = jnp.where(valid[:, None, None], F_k, eye)
    GQG_k = jnp.where(valid[:, None, None], GQG_k, jnp.zeros_like(GQG_k))

    # tree-fold the affine maps (time order: index 0 first)
    A, B = F_k, GQG_k
    while A.shape[0] > 1:
        if A.shape[0] % 2:
            A = jnp.concatenate([A, eye[None]], axis=0)
            B = jnp.concatenate([B, jnp.zeros((1, N, N), dtype)], axis=0)
        A1, B1 = A[0::2], B[0::2]     # earlier
        A2, B2 = A[1::2], B[1::2]     # later
        A = jnp.einsum("kij,kjl->kil", A2, A1)
        B = jnp.einsum("kij,kjl,kml->kim", A2, B1, A2) + B2
    P_f = A[0] @ P @ A[0].T + B[0]
    return x_f, 0.5 * (P_f + P_f.T), xs


# ---------------------------------------------------------------------------
# iterated update
# ---------------------------------------------------------------------------

def _chart_project_P(dx, x: st.NavState, x_prop: st.NavState, P, dx_new):
    """Project dx_new and P through the manifold charts (esekfom.hpp:1657-1697).

    Returns (dx_new', P').
    """
    for idx in st.SO3_IDXS:
        res = so3.A_matrix(dx[idx:idx + 3]).T                       # (3,3)
        dx_new = dx_new.at[idx:idx + 3].set(res @ dx_new[idx:idx + 3])
        P = P.at[idx:idx + 3, :].set(res @ P[idx:idx + 3, :])
        P = P.at[:, idx:idx + 3].set(P[:, idx:idx + 3] @ res.T)

    g = st.GRAV
    Nx = s2.Nx_yy(x.grav)                                           # (2,3)
    Mx = s2.Mx(x_prop.grav, dx[g:g + 2])                            # (3,2)
    res2 = Nx @ Mx                                                  # (2,2)
    dx_new = dx_new.at[g:g + 2].set(res2 @ dx_new[g:g + 2])
    P = P.at[g:g + 2, :].set(res2 @ P[g:g + 2, :])
    P = P.at[:, g:g + 2].set(P[:, g:g + 2] @ res2.T)
    return dx_new, P


def _degeneracy_guard(HTH, dx_, D):
    """Zero degenerate pose-update directions (esekfom.hpp:1736-1744).

    Fast path: when Gershgorin certifies every eigenvalue of the 6×6 pose
    block is ≥ D the guard is the identity and the ``eigh`` is skipped via
    ``lax.cond``.  NOTE (measured, tools/oracle_corridor.py): on real bench
    geometry the bound is hugely negative on every scan (strong pos↔rot
    coupling at 20 m lever arms) while the true eigenvalues are fine, so
    this certificate rarely engages and the ``eigh`` runs on most
    iterations.

    DELIBERATE DIVERGENCE from the reference's literal code: the reference
    zeroes ROWS of the eigenvector matrix and applies ``V⁻¹·(sel·dx)``
    (esekfom.hpp:1736-1744) — but that expression depends on the
    eigensolver's arbitrary column SIGNS and (for repeated eigenvalues)
    basis choice, i.e. it is not a well-defined function of the problem
    (verified numerically: flipping one eigh column sign changes the
    result).  The evident intent — zero the update's components ALONG
    eigendirections with eigenvalue < D — is the spectral projector
    ``V·diag(m)·Vᵀ``, which is sign- and basis-invariant; both this path
    and the f64 test oracle implement it.  The reference's near-singular fallback
    (prod(w) < 1e-20 → V = I: zero components by ascending-eigenvalue
    index) is kept as-is.

    Returns ``(guarded_dx (N,), min_eig ())`` — min_eig is the exact
    smallest pose-block eigenvalue when the eigh ran, +inf when the
    Gershgorin certificate skipped it (then min_eig ≥ D is known, so
    guard_fired = min_eig < D stays correct either way).
    """
    dtype = dx_.dtype
    H6 = HTH[0:6, 0:6]
    diag = jnp.diagonal(H6)
    radii = jnp.sum(jnp.abs(H6), axis=1) - jnp.abs(diag)
    gersh_min = jnp.min(diag - radii)            # lower bound on min eigenvalue

    def exact(dx6):
        w, V = jnp.linalg.eigh(H6)               # ascending eigenvalues, V columns
        Vr = jnp.real(V).astype(dtype)
        wr = jnp.real(w).astype(dtype)
        m = (wr >= D).astype(dtype)
        proj = (Vr * m[None, :]) @ Vr.T @ dx6    # V·diag(m)·Vᵀ·dx
        use_I = jnp.prod(wr) < 1e-20
        return jnp.where(use_I, m * dx6, proj), jnp.min(wr).astype(dtype)

    head, min_eig = jax.lax.cond(
        gersh_min >= D,
        lambda dx6: (dx6, jnp.asarray(jnp.inf, dtype)), exact, dx_[0:6])
    return dx_.at[0:6].set(head), min_eig


def _final_P(x: st.NavState, x_prop: st.NavState, dx_, P, K_x, K, R):
    """Terminal covariance update in JOSEPH form, then chart projection.

    The reference computes ``P = L − K_x·P`` (esekfom.hpp:1764-1817) — the
    optimal-gain shortcut of the Joseph update, valid only for the EXACT
    Kalman gain.  In f32 the computed gain carries rounding error and the
    shortcut loses positive-definiteness a little every scan; over long
    runs P drifts indefinite and the filter destabilizes (measured:
    velocity blow-ups after ~70 updates on the synthetic benchmark).  The
    Joseph form ``A·P·Aᵀ + R·K·Kᵀ`` (A = I − K·H̃) is the exact covariance
    of the estimator for ANY gain — first-order identical to the
    reference, PSD by construction — and is symmetrized before returning.
    The manifold chart projection J·(...)·Jᵀ is unchanged
    (esekfom.hpp:1766-1817).
    """
    dtype = P.dtype
    A = jnp.eye(N, dtype=dtype).at[:, 0:M_OBS].add(-K_x)
    M0 = A @ P @ A.T + R * (K @ K.T)

    for idx in st.SO3_IDXS:
        res = so3.A_matrix(dx_[idx:idx + 3]).T
        M0 = M0.at[idx:idx + 3, :].set(res @ M0[idx:idx + 3, :])
        M0 = M0.at[:, idx:idx + 3].set(M0[:, idx:idx + 3] @ res.T)

    g = st.GRAV
    Nx = s2.Nx_yy(x.grav)
    Mx = s2.Mx(x_prop.grav, dx_[g:g + 2])
    res2 = Nx @ Mx
    M0 = M0.at[g:g + 2, :].set(res2 @ M0[g:g + 2, :])
    M0 = M0.at[:, g:g + 2].set(M0[:, g:g + 2] @ res2.T)

    return 0.5 * (M0 + M0.T)


def _body_jnp(x: st.NavState, x_prop: st.NavState, P_prop, HTH, HTh, R, D):
    """One update-iteration body in plain jnp (exact reference semantics,
    including the eigh degeneracy guard).  Returns (x_next, P_fin, dx_)
    where dx_ is the PRE-guard update vector (convergence is tested on it,
    esekfom.hpp:1749-1756) and P_fin is the terminal covariance as if this
    were the final iteration.
    """
    dtype = x.pos.dtype
    dx = st.boxminus(x, x_prop)
    dx_new, P_it = _chart_project_P(dx, x, x_prop, P_prop, dx)

    # Gain in covariance form on measurements COMPRESSED to 12 dims:
    # HᵀH = L Lᵀ ⇒ an exactly equivalent 12-row problem H̃ = Lᵀ,
    # h̃ = L⁻¹(Hᵀh) (masked Cholesky — exact for unobserved dims); then
    # the reference's own m×m path (esekfom.hpp:1701-1709,
    # K = PHᵀ(HPHᵀ/R + I)⁻¹/R) — Woodbury-equal to its n×n information
    # path but f32-stable: no P⁻¹ is ever formed (the double inversion
    # spans ~9 decades and breaks in single precision; the reference
    # sidesteps it by running in double).  The pivoting in the solve is
    # load-bearing (ops/gain.py): unpivoted Cholesky variants drift the
    # filter, and the non-normal push-through form diverges with
    # estimate_extrinsics.
    K_x12, K_h, K = gain_op.gain_reference(HTH, HTh, P_it, R)
    K_x = jnp.zeros((N, N), dtype=dtype).at[:, 0:M_OBS].set(
        K_x12.astype(dtype))
    K_h = K_h.astype(dtype)

    dx_ = K_h + (K_x - jnp.eye(N, dtype=dtype)) @ dx_new
    dx_guarded, min_eig = _degeneracy_guard(HTH, dx_, D)

    x_next = st.boxplus(x, dx_guarded)
    P_fin = _final_P(x_next, x_prop, dx_, P_it, K_x12.astype(dtype),
                     K.astype(dtype), R)
    return x_next, P_fin, dx_, min_eig


def update_iterated(
    x: st.NavState,
    P,
    h_model: Callable[[st.NavState], Tuple[jnp.ndarray, jnp.ndarray]],
    R: float,
    D: float,
    max_iters: int,
    limit: float,
    unroll: bool = None,
    with_diag: bool = False,
):
    """Iterated dynamic-share update (esekfom.hpp:1620-1823).

    ``h_model(x)`` recomputes matches at the current iterate and returns the
    measurement sufficient statistics ``(HᵀH (12,12), Hᵀh (12,))`` — the
    filter equations only touch H through these (esekfom.hpp:1722-1729), so
    a device-sharded matcher just psums its partial products.
    R is the scalar LiDAR noise, D the degeneracy eigenvalue threshold,
    ``limit`` the per-dimension convergence limit (LIMITS broadcast,
    main.cpp:164-166).

    Returns (x', P', n_iters); with ``with_diag=True`` additionally a dict
    ``{"gersh_min": (), "min_eig": (), "guard_fired": ()}`` — the minimum
    Gershgorin lower bound on the 6×6 pose block of HᵀH across iterations
    (conditioning telemetry), the exact minimum pose-block eigenvalue
    (+inf when a Gershgorin certificate skipped the eigh), and
    whether the degeneracy guard actually zeroed directions
    (min_eig < D).  The telemetry behind DebugOutput's degeneracy fields
    (the reference prints nothing when its guard zeroes directions,
    esekfom.hpp:1736-1744 — drift in degenerate corridors is otherwise
    undiagnosable).
    """
    dtype = x.pos.dtype
    x_prop, P_prop = x, P

    def cond(carry):
        return ~carry["done"]

    def body(carry):
        i = carry["i"]
        x = carry["x"]

        HTH, HTh = h_model(x)
        HTH = HTH.astype(dtype)                # (12,12); zero rows are no-ops
        HTh = HTh.astype(dtype)                # (12,)

        H6 = HTH[0:6, 0:6]
        hd = jnp.diagonal(H6)
        gm = jnp.min(hd - (jnp.sum(jnp.abs(H6), axis=1) - jnp.abs(hd)))
        x_next, P_fin, dx_, me = _body_jnp(x, x_prop, P_prop, HTH, HTh, R, D)

        converged = jnp.all(jnp.abs(dx_) <= limit)
        t_next = carry["t"] + converged.astype(jnp.int32)

        done = (t_next > 1) | (i == max_iters - 1)
        # the terminal covariance only lands on the final iteration
        P_next = jnp.where(done, P_fin, carry["P"])

        return {
            "x": x_next,
            "P": P_next,
            "t": t_next,
            "i": i + 1,
            "done": done,
            "g": jnp.minimum(carry["g"], gm.astype(dtype)),
            "me": jnp.minimum(carry["me"], me.astype(dtype)),
        }

    carry0 = {
        "x": x,
        "P": P,
        "t": jnp.asarray(0, jnp.int32),
        "i": jnp.asarray(-1, jnp.int32),  # reference loop runs i = -1 … max-1
        "done": jnp.asarray(False),
        "g": jnp.asarray(jnp.inf, dtype),
        "me": jnp.asarray(jnp.inf, dtype),
    }
    if unroll is None:
        unroll = max_iters <= 8

    if unroll:
        # Unrolled masked iterations: the same math as the while_loop
        # (tests/test_iekf.py: equal iteration counts, states to f64
        # reassociation noise), but XLA schedules the whole chain as
        # straight-line code — no per-iteration loop bookkeeping.  With
        # MAX_NUM_ITERS=3 and the two-converged-iterations stop rule the
        # loop almost always runs to max anyway, so the masked extra work
        # is ~zero.  The reference loop index runs i = -1 … max_iters-1
        # (done fires on incoming i == max_iters-1), i.e. max_iters+1
        # evaluations.
        out = carry0
        for _ in range(max_iters + 1):
            new = body(out)
            was_done = out["done"]
            out = jax.tree_util.tree_map(
                lambda a, b: jnp.where(was_done, a, b), out, new)
            out["done"] = was_done | new["done"]
    else:
        out = jax.lax.while_loop(cond, body, carry0)

    x_o, P_o, n_o = out["x"], out["P"], out["i"] + 1
    if with_diag:
        me_o = out["me"]
        return x_o, P_o, n_o, {"gersh_min": out["g"], "min_eig": me_o,
                               "guard_fired": me_o < D}
    return x_o, P_o, n_o
