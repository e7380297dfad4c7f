"""SO(3) quaternion/rotation primitives.

Quaternions are stored as ``(w, x, y, z)`` 4-vectors (scalar first).  The
semantics mirror the MTK manifold toolkit used by the reference
(`include/IKFoM/IKFoM_toolkit/mtk/types/SOn.hpp`,
`mtk/src/mtkmath.hpp:143-256`), but are implemented as branch-free JAX
functions (``jnp.where`` instead of data-dependent control flow) so they
vectorize under ``vmap``/``jit`` into fused elementwise code.

All functions are dtype-polymorphic: pass float32 arrays on the device,
float64 on the CPU for high-precision validation.
"""

from __future__ import annotations

import jax.numpy as jnp


def _tol(dtype) -> float:
    # mirrors MTK::tolerance (mtkmath.hpp:121-122)
    return 1e-5 if jnp.dtype(dtype) == jnp.float32 else 1e-11


def hat(v):
    """Skew-symmetric matrix of a 3-vector (mtkmath.hpp:177-183)."""
    z = jnp.zeros_like(v[..., 0])
    return jnp.stack(
        [
            jnp.stack([z, -v[..., 2], v[..., 1]], axis=-1),
            jnp.stack([v[..., 2], z, -v[..., 0]], axis=-1),
            jnp.stack([-v[..., 1], v[..., 0], z], axis=-1),
        ],
        axis=-2,
    )


def quat_identity(dtype=jnp.float32):
    return jnp.array([1.0, 0.0, 0.0, 0.0], dtype=dtype)


def quat_mul(q, p):
    """Hamilton product q*p, both (…,4) wxyz."""
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    pw, px, py, pz = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    return jnp.stack(
        [
            qw * pw - qx * px - qy * py - qz * pz,
            qw * px + qx * pw + qy * pz - qz * py,
            qw * py - qx * pz + qy * pw + qz * px,
            qw * pz + qx * py - qy * px + qz * pw,
        ],
        axis=-1,
    )


def quat_conj(q):
    return q * jnp.asarray([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def quat_normalize(q):
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def quat_rotate(q, v):
    """Rotate 3-vector(s) v by quaternion(s) q (R(q) @ v)."""
    qv = q[..., 1:]
    t = 2.0 * jnp.cross(qv, v)
    return v + q[..., :1] * t + jnp.cross(qv, t)


def quat_to_mat(q):
    """Rotation matrix from quaternion, (…,4) -> (…,3,3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return jnp.stack(
        [
            jnp.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], axis=-1),
            jnp.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], axis=-1),
            jnp.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], axis=-1),
        ],
        axis=-2,
    )


def mat_to_quat(R):
    """Quaternion (wxyz) from rotation matrix — branch-free Shepperd method."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    # four candidate constructions; pick the numerically best via where-chains
    qw0 = jnp.sqrt(jnp.maximum(1.0 + tr, 0.0)) / 2
    q0 = jnp.stack(
        [qw0, (m21 - m12) / (4 * qw0 + 1e-30), (m02 - m20) / (4 * qw0 + 1e-30),
         (m10 - m01) / (4 * qw0 + 1e-30)], axis=-1)

    qx1 = jnp.sqrt(jnp.maximum(1.0 + m00 - m11 - m22, 0.0)) / 2
    q1 = jnp.stack(
        [(m21 - m12) / (4 * qx1 + 1e-30), qx1, (m01 + m10) / (4 * qx1 + 1e-30),
         (m02 + m20) / (4 * qx1 + 1e-30)], axis=-1)

    qy2 = jnp.sqrt(jnp.maximum(1.0 - m00 + m11 - m22, 0.0)) / 2
    q2 = jnp.stack(
        [(m02 - m20) / (4 * qy2 + 1e-30), (m01 + m10) / (4 * qy2 + 1e-30), qy2,
         (m12 + m21) / (4 * qy2 + 1e-30)], axis=-1)

    qz3 = jnp.sqrt(jnp.maximum(1.0 - m00 - m11 + m22, 0.0)) / 2
    q3 = jnp.stack(
        [(m10 - m01) / (4 * qz3 + 1e-30), (m02 + m20) / (4 * qz3 + 1e-30),
         (m12 + m21) / (4 * qz3 + 1e-30), qz3], axis=-1)

    cond0 = (tr > 0.0)[..., None]
    cond1 = ((m00 >= m11) & (m00 >= m22))[..., None]
    cond2 = (m11 >= m22)[..., None]
    q = jnp.where(cond0, q0, jnp.where(cond1, q1, jnp.where(cond2, q2, q3)))
    return quat_normalize(q)


def _cos_sinc_sqrt(x2):
    """(cos(sqrt(x2)), sinc(sqrt(x2))) with a Taylor branch near zero.

    Mirrors MTK::cos_sinc_sqrt (mtkmath.hpp:143-174) but branch-free.
    """
    eps = jnp.finfo(x2.dtype).eps
    taylor_bound = jnp.sqrt(jnp.sqrt(eps))  # taylor_n_bound
    x2s = jnp.maximum(x2, 0.0)
    x = jnp.sqrt(x2s)
    safe_x = jnp.where(x2s >= taylor_bound, x, 1.0)
    cos_big = jnp.cos(safe_x)
    sinc_big = jnp.sin(safe_x) / safe_x

    # 3-term Taylor (same truncation as the reference)
    inv = [1 / 3.0, 1 / 4.0, 1 / 5.0, 1 / 6.0, 1 / 7.0, 1 / 8.0]
    cosi = jnp.ones_like(x2s)
    sinc = jnp.ones_like(x2s)
    term = -0.5 * x2s
    for i in range(3):
        cosi = cosi + term
        term = term * inv[2 * i]
        sinc = sinc + term
        term = term * (-inv[2 * i + 1]) * x2s

    use_big = x2s >= taylor_bound
    return jnp.where(use_big, cos_big, cosi), jnp.where(use_big, sinc_big, sinc)


def exp_quat(v, scale=0.5):
    """MTK::exp — quaternion of rotation by ``2*scale*|v|`` about v.

    With the default ``scale=0.5`` this is the standard exponential map:
    ``exp_quat(v) == (cos(|v|/2), sin(|v|/2) * v/|v|)``
    (mtkmath.hpp:249-256; SOn.hpp uses scale=1/2 everywhere).
    """
    v = jnp.asarray(v)
    norm2 = jnp.sum(v * v, axis=-1)
    c, sinc = _cos_sinc_sqrt(scale * scale * norm2)
    w = c[..., None]
    xyz = (sinc * scale)[..., None] * v
    return jnp.concatenate([w, xyz], axis=-1)


def log_quat(q):
    """Rotation vector of quaternion (inverse of exp_quat, |out| <= pi)."""
    w = q[..., 0]
    vec = q[..., 1:]
    n = jnp.linalg.norm(vec, axis=-1)
    # angle in [0, pi] when w>=0; flip sign for w<0 (q and -q equal rotation)
    angle = 2.0 * jnp.arctan2(n, jnp.abs(w))
    sgn = jnp.where(w < 0, -1.0, 1.0)
    # near zero rotation: log ~= 2*vec/w
    small = n <= _tol(q.dtype)
    safe_w = jnp.where(jnp.abs(w) > 1e-30, w, 1.0)
    out_small = 2.0 * vec / safe_w[..., None]
    out_big = (sgn * angle / jnp.maximum(n, 1e-30))[..., None] * vec
    return jnp.where(small[..., None], out_small, out_big)


def exp_mat(v):
    """Rotation matrix exp via Rodrigues (matches State::update, State.cpp:87-103)."""
    return quat_to_mat(exp_quat(v))


def A_matrix(v):
    """MTK::A_matrix — the (transposed-right-Jacobian-style) chart matrix.

    ``A(v) = I + (1-cos|v|)/|v|^2 hat(v) + (1 - sin|v|/|v|)/|v|^2 hat(v)^2``
    (mtkmath.hpp:236-247). Near |v| -> 0 returns identity, like the reference.
    """
    v = jnp.asarray(v)
    n2 = jnp.sum(v * v, axis=-1)
    n = jnp.sqrt(n2)
    tol = _tol(v.dtype)
    safe_n2 = jnp.where(n2 > tol * tol, n2, 1.0)
    K = hat(v)
    K2 = K @ K
    c1 = jnp.where(n >= tol, (1.0 - jnp.cos(n)) / safe_n2, 0.5)
    c2 = jnp.where(n >= tol, (1.0 - jnp.sin(n) / jnp.where(n > 0, n, 1.0)) / safe_n2, 1.0 / 6.0)
    I = jnp.broadcast_to(jnp.eye(3, dtype=v.dtype), K.shape)
    out = I + c1[..., None, None] * K + c2[..., None, None] * K2
    # exact-identity branch for tiny norms to match reference bitwise-ish
    return jnp.where((n < tol)[..., None, None], I, out)


def boxplus(q, delta, scale=1.0):
    """SO3 boxplus: q * exp(scale*delta) (SOn.hpp semantics)."""
    return quat_mul(q, exp_quat(delta * scale))


def boxminus(q, p):
    """SO3 boxminus: log(p^{-1} * q)."""
    return log_quat(quat_mul(quat_conj(p), q))
