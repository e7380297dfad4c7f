"""iEKF gain from the measurement sufficient statistics.

Computes, from (HᵀH, Hᵀh), the chart-projected covariance P (23×23) and the
scalar noise R, the algebra of models/iekf.py's update body (reference
esekfom.hpp:1701-1709):

    L    = masked-Cholesky(HᵀH)        (unit pivots on zero diagonals)
    H̃    = Lᵀ (zero filler rows)       ;  h̃ = L⁻¹(Hᵀh), fillers zeroed
    PH̃ᵀ  = P[:, :12]·H̃ᵀ
    S    = H̃·PH̃ᵀ[:12]/R + I
    K    = PH̃ᵀ·S⁻¹/R    via a PIVOTED solve (pivoting is load-bearing:
                         f32 P's slight asymmetry makes S slightly
                         indefinite and unpivoted factorizations drift the
                         filter)
    K_x  = K·H̃  (23×12)  ;  K_h = K·h̃  (23,)
"""

from __future__ import annotations

import jax.numpy as jnp

from fast_limo_tpu.ops import linalg

M = 12   # observed dims (measurement Jacobian columns)
NS = 23  # error-state dims


def gain_reference(HTH, HTh, P, R):
    """The gain, in the caller's dtype.

    Returns ``(K_x (23,12), K_h (23,), K (23,12))`` — K is the raw gain for
    the COMPRESSED 12-row measurement (needed by the Joseph-form terminal
    covariance, models/iekf.py:_final_P).
    """
    dtype = P.dtype
    Ht12, h_c = linalg.masked_chol_compress(HTH, HTh)
    PHt = P[:, 0:M] @ Ht12.T
    S = (Ht12 @ PHt[0:M]) / R + jnp.eye(M, dtype=dtype)
    K_ = jnp.linalg.solve(S.T, PHt.T).T / R
    return K_ @ Ht12, K_ @ h_c, K_        # K_x (23,12), K_h (23,), K (23,12)
