"""Explicit-inverse Schur-complement backend (counterpart of
``osqp_tpu/linsys/dense_inv.py``).

At factorization time the inverse operator is materialized:

    Minv = M^-1  (B, n, n)   and   AMinvT = M^-1 A'  (B, n, m),

with M = P + sigma I + A' diag(rho) A, so a KKT solve is two matrix-
vector products: x~ = Minv t and z~ = (A Minv) t with
t = rhs_x + A'(rho * rhs_z).

* :func:`init` inverts M through K2 (:mod:`..ops.spd_inverse`) and
  guards the result per instance.
* :func:`fused_step` is the plain loop body: one masked ADMM iteration
  through K1 (:mod:`..ops.admm_iter`).
* :func:`refined_step` is the refined loop body, for ill-conditioned
  batches: one masked iteration with residual-corrected solves through
  K1r (:func:`..ops.admm_iter.admm_iter_refined`).
"""

from __future__ import annotations

import torch

from ..ops import spd_inverse as k2
from ..ops.admm_iter import admm_iter, admm_iter_refined
from .dense_chol import form_schur

# Refinement gate: an explicit-inverse solve has forward error
# ~ ||I - M Minv||, and beyond ~1e-6 relative it puts a floor under the
# dual residual.  Instances whose inverse residual exceeds the gate run
# the refined loop body (osqp_tpu/linsys/dense_inv.py:73-86).
_REFINE_TOL_F32 = 3e-6
_REFINE_TOL_F64 = 1e-12
# Residual guard: K2's instances above this go through Cholesky.
_GUARD_TOL_F32 = 1e-3
_GUARD_TOL_F64 = 1e-8


def _chol_inverse(M: torch.Tensor) -> torch.Tensor:
    """Inverse through torch's Cholesky; NaN where M is not PD."""
    L, info = torch.linalg.cholesky_ex(M)
    X = torch.cholesky_inverse(L)
    return torch.where((info == 0)[:, None, None], X, float("nan"))


def _inverse_residual(M: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    return (eye - torch.bmm(M, X)).abs().amax((-2, -1))


def init(P, A, sigma, rho_vec, **_):
    """Factorize: Minv, AMinvT and the per-instance refinement flag.

    The inverse is chosen by n alone: up to K2's shared-memory bound
    (``spd_inverse.max_n``) the K2 kernel with a residual guard; above
    it, torch's Cholesky and Cholesky inverse.  Both take a Newton-Schulz
    step.
    """
    M = form_schur(P, A, sigma, rho_vec)
    B, n = P.shape[0], P.shape[-1]
    if 0 < n <= k2.max_n(M.dtype):
        X = k2.spd_inverse(M)
        # Residual guard: instances whose inverse is inaccurate are
        # recomputed through Cholesky, each on its own; the rest keep
        # their inverse bit for bit.  NaN (non-PD) does not trigger it:
        # NaN is the convexity signal, and Cholesky would give it too.
        resid = _inverse_residual(M, X)
        bad = resid > (_GUARD_TOL_F32 if M.dtype == torch.float32 else _GUARD_TOL_F64)
        Minv = X
        if bool(bad.any()):
            eye = torch.eye(n, dtype=M.dtype, device=M.device)
            Mb = torch.where(bad[:, None, None], M, eye)
            Minv = torch.where(bad[:, None, None], _chol_inverse(Mb), X)
    else:
        # Newton-Schulz on the Cholesky inverse as on K2's, so that both
        # routes polish their inverse as the JAX package does at every n.
        Minv = k2.newton_schulz(M, _chol_inverse(M))
        resid = _inverse_residual(M, Minv)
    if A.shape[-2]:
        # (A M^-1)' = M^-1 A', stored transposed (B, n, m) so that both
        # per-iteration products read rows of a row-major matrix.
        AMinvT = torch.bmm(Minv, A.transpose(1, 2))
    else:
        AMinvT = torch.zeros((B, n, 0), dtype=P.dtype, device=P.device)
    tol = _REFINE_TOL_F32 if M.dtype == torch.float32 else _REFINE_TOL_F64
    return {
        "Minv": Minv,
        "AMinvT": AMinvT,
        "refine": resid > tol,
        "P": P,
        "sigma": torch.as_tensor(sigma, dtype=M.dtype),
    }


def refine_signal(factor) -> torch.Tensor:
    """Does some instance of the batch need refined solves?  Read once
    per segment to choose the loop body."""
    return factor["refine"].any()


def fused_step(factor, data, dyn, rs, it, delta_x, delta_y, active):
    """The plain loop body: one masked ADMM iteration through K1.
    Returns (x, z, y, delta_x, delta_y)."""
    return admm_iter(
        factor["Minv"], factor["AMinvT"], data.A, data.q, data.l, data.u,
        rs.rho_vec, rs.rho_inv_vec, dyn.sigma, dyn.alpha, active,
        it.x, it.z, it.y, delta_x, delta_y,
    )


def refined_step(factor, data, dyn, rs, it, delta_x, delta_y, y_lo, active):
    """The refined loop body: one masked ADMM iteration through K1r, with
    the TwoSum dual carry ``y_lo`` in float32 (None in float64).
    Returns (x, z, y, delta_x, delta_y, y_lo)."""
    return admm_iter_refined(
        factor["Minv"], data.A, factor["P"], data.q, data.l, data.u,
        rs.rho_vec, rs.rho_inv_vec, dyn.sigma, dyn.alpha, active,
        it.x, it.z, it.y, delta_x, delta_y, y_lo,
    )
