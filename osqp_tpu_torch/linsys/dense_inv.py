"""Explicit-inverse Schur-complement backend (counterpart of
``osqp_tpu/linsys/dense_inv.py``).

At factorization time the inverse operator is materialized:

    Minv = M^-1  (B, n, n)   and   AMinvT = M^-1 A'  (B, n, m),

with M = P + sigma I + A' diag(rho) A, so a KKT solve is two matrix-
vector products: x~ = Minv t and z~ = (A Minv) t with
t = rhs_x + A'(rho * rhs_z).

* :func:`init` inverts M through K2 (:mod:`..ops.spd_inverse`) at every
  n and guards the result per instance (:func:`guarded_inverse`).
* :func:`fused_step` is the plain loop body: one masked ADMM iteration
  through K1 (:mod:`..ops.admm_iter`).
* :func:`refined_step` is the refined loop body, for ill-conditioned
  batches: one masked iteration with residual-corrected solves through
  K1r (:func:`..ops.admm_iter.admm_iter_refined`).
"""

from __future__ import annotations

import torch

from .. import flow
from ..linalg import host_read
from ..ops import spd_inverse as k2
from ..ops.admm_iter import admm_iter, admm_iter_refined
from .dense_chol import form_schur

# Refinement gate: an explicit-inverse solve has forward error
# ~ ||I - M Minv||, and beyond ~1e-6 relative it puts a floor under the
# dual residual.  Instances whose inverse residual exceeds the gate run
# the refined loop body (osqp_tpu/linsys/dense_inv.py:73-86).
_REFINE_TOL_F32 = 3e-6
_REFINE_TOL_F64 = 1e-12
# Residual guard: K2's instances above this are inverted again through
# Cholesky, and keep whichever inverse has the lower residual.  In
# float32 every route's rounding floor on the repo's cells is at most
# ~2e-3 (n = 550, the portfolio leg), so the guard sits well above it:
# below the floor the library inverse cannot do better.
_GUARD_TOL_F32 = 1e-2
_GUARD_TOL_F64 = 1e-8
# Instances the residual guard has sent to Cholesky, over all calls of
# init (the count costs no further host read: the guard reads it anyway).
guard_rescued = 0


def _chol_inverse(M: torch.Tensor) -> torch.Tensor:
    """Inverse through torch's Cholesky; NaN where M is not PD.  The
    residual guard's rescue of the instances K2 inverts badly."""
    L, info = torch.linalg.cholesky_ex(M)
    X = torch.cholesky_inverse(L)
    return torch.where((info == 0)[:, None, None], X, float("nan"))


def _inverse_residual(M: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    return (eye - torch.bmm(M, X)).abs().amax((-2, -1))


def guarded_inverse(M: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """M^-1 of each instance and the residual |I - M X|max of the inverse
    kept: K2 at every n (``spd_inverse.spd_inverse``: the kernel up to
    ``spd_inverse.max_n``, its blocked recursion above, each with a
    Newton-Schulz step), then the residual guard, as the JAX package's
    init (``osqp_tpu/linsys/dense_inv.py:93-131``).

    The guard inverts the instances above its tolerance again through
    Cholesky, those alone, and keeps per instance whichever inverse has
    the lower residual (the JAX package takes Cholesky's unconditionally);
    the rest keep K2's inverse bit for bit.  NaN (non-PD) does not
    trigger it: NaN is the convexity signal, and Cholesky would give it
    too.

    In the traced program (:mod:`osqp_tpu_torch.program`) the count is
    not read: a :func:`flow.cond` on ``bad.any()`` inverts the whole
    batch through Cholesky and keeps the better inverse where ``bad`` is
    set (:func:`_rescue_batch`).  A batched Cholesky need not give the
    bits of one over the flagged instances alone."""
    global guard_rescued
    X = k2.spd_inverse(M)
    resid = _inverse_residual(M, X)
    bad = resid > (_GUARD_TOL_F32 if M.dtype == torch.float32 else _GUARD_TOL_F64)
    if flow.in_program():
        return flow.cond(bad.any(), _rescue_batch, lambda M, X, resid, bad: (X, resid), (M, X, resid, bad))
    rescued = int(host_read(bad.sum()))
    if rescued:
        guard_rescued += rescued
        # the flagged instances first, without a further host read
        idx = torch.argsort(bad.to(torch.int8), descending=True, stable=True)[:rescued]
        Mb = M[idx]
        Xr = _chol_inverse(Mb)
        rr = _inverse_residual(Mb, Xr)
        better = rr < resid[idx]  # NaN compares False: K2's is kept
        # index_copy into X keeps it row-major, as the kernels take Minv
        # (the library's batched inverse comes back column-major)
        X = X.index_copy(0, idx, torch.where(better[:, None, None], Xr, X[idx]))
        resid = resid.index_copy(0, idx, torch.where(better, rr, resid[idx]))
    return X, resid


def _rescue_batch(M, X, resid, bad):
    """The residual guard over the whole batch: Cholesky's inverse where
    ``bad`` is set and its residual is the lower."""
    Xr = _chol_inverse(M)
    rr = _inverse_residual(M, Xr)
    better = bad & (rr < resid)  # NaN compares False: K2's is kept
    # row-major, as the kernels take Minv (the library's inverse is column-major)
    return torch.where(better[:, None, None], Xr, X).contiguous(), torch.where(better, rr, resid)


def init(P, A, sigma, rho_vec, **_):
    """Factorize: Minv (:func:`guarded_inverse`), AMinvT and the
    per-instance refinement flag, from the residual of the inverse kept."""
    M = form_schur(P, A, sigma, rho_vec)
    B, n = P.shape[0], P.shape[-1]
    if n:
        Minv, resid = guarded_inverse(M)
    else:
        Minv, resid = M, torch.zeros(B, dtype=M.dtype, device=M.device)
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
