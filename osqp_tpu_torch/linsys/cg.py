"""Matrix-free preconditioned conjugate-gradient backend (counterpart of
``osqp_tpu/linsys/cg.py``).

Solves

    (P + sigma I + A' diag(rho) A) x~ = rhs_x + A' (rho * rhs_z)

without forming the Schur complement, with the Jacobi preconditioner
diag(M) = diag(P) + sigma + sum_i rho_i A_ij^2, warm-started from the
previous ADMM iterate.  ``init`` factors nothing, so a rho update costs
one O(nnz) pass.  The operands may be dense (B, ·, ·) tensors or
:class:`~osqp_tpu_torch.sparse_ops.ELLMatrix` (the sparse path of
:func:`osqp_tpu_torch.solve_sparse`); the loop is K6
(:mod:`osqp_tpu_torch.ops.cg`), the sparse products K5.

The inner tolerance follows the inexact-ADMM schedule of
:func:`update_tolerance`: loose while the outer iteration is far from
its tolerances, tighter as it closes in.

In the traced program (:mod:`osqp_tpu_torch.program`) the step cap and
the tolerance fraction are static numbers of the factor, not 0-d host
tensors, so that no solve or schedule reads a value of the trace on the
host; the arithmetic and its bits are the same.
"""

from __future__ import annotations

import torch

from .. import flow
from ..linalg import mat_tvec, mat_vec
from ..ops import ell
from ..ops.cg import cg_solve
from ..parallel.rows import RowSharded
from ..sparse_ops import ELLMatrix

# Caps of the inexact schedule's relative tolerance, by dtype (the JAX
# package's, osqp_tpu/linsys/cg.py:64-82): near-exact solves in float64,
# where a loose schedule can deadlock on ill-conditioned problems (the
# inexactness floors the dual residual, which keeps the solves loose);
# 1e-2 in float32, whose precision floor makes tighter solves burn their
# whole inner budget.
_TOL_REL_CAP_F32 = 1e-2
_TOL_REL_CAP_F64 = 1e-8


def _cap_for(dtype) -> float:
    return _TOL_REL_CAP_F32 if dtype == torch.float32 else _TOL_REL_CAP_F64


def init(P, A, sigma, rho_vec, cg_max_iter: int = 0, cg_tol_fraction: float = 1e-7, **_):
    """The Jacobi diagonal's inverse, the step cap (``cg_max_iter``, 0
    for n + m) and the tolerances.  ``max_iter`` and ``tol_frac`` are
    0-d host tensors (in the program a Python int and float); ``tol_rel``
    is (B,) on the device."""
    n = P.shape[-1]
    m = A.shape[-2]
    dtype = P.dtype
    if isinstance(P, ELLMatrix):
        # diag(P) and the column sums in one K5 launch (of a row-sharded A,
        # on its replicated transpose)
        At = A.t if isinstance(A, RowSharded) else A
        diagP, colsums = ell.ell_products((ell.ell_diagonal, P), (ell.ell_sq_colsums, At, rho_vec))
        diagM = diagP + sigma
        if m:
            diagM = diagM + colsums
    else:
        diagM = torch.diagonal(P, dim1=-2, dim2=-1) + sigma
        if m:
            diagM = diagM + (A.cg_colsums(rho_vec) if isinstance(A, RowSharded)
                             else torch.einsum("bm,bmn->bn", rho_vec, A * A))
    max_iter = int(cg_max_iter) if cg_max_iter else (n + m)
    B = diagM.shape[0]
    static = flow.in_program()
    return {
        "P": P,
        "sigma": torch.as_tensor(sigma, dtype=dtype),
        "dinv": 1.0 / diagM,
        "max_iter": max_iter if static else torch.tensor(max_iter, dtype=torch.int32),
        "tol_frac": float(cg_tol_fraction) if static else torch.tensor(cg_tol_fraction, dtype=dtype),
        # The inexact schedule's relative tolerance, set at every check
        # by update_tolerance; until then the static fraction under the
        # dtype's cap.
        "tol_rel": torch.full((B,), min(float(cg_tol_fraction), _cap_for(dtype)), dtype=dtype,
                              device=diagM.device),
    }


def link_cg_floor(settings) -> float:
    """The cg_tol_fraction that lets the requested outer eps be reached:
    the inexact-solve floor must sit below the outer tolerance, or the
    subproblem error caps outer convergence (the JAX package measured a
    stall at pri_res ~0.3 at eps 1e-8 with the 1e-7 default).  Zero
    tolerances are allowed one at a time; only positive ones bind."""
    eps_pos = [e for e in (settings.eps_abs, settings.eps_rel) if e > 0]
    floor = min(eps_pos) if eps_pos else 1.0
    ctf = float(settings.cg_tol_fraction)
    if floor < 1e-5:
        ctf = min(ctf, max(1e-2 * floor, 1e-12))
    return ctf


def update_tolerance(factor, tol_ratio, dyn):
    """The inexact-ADMM schedule, from the check's scale-free
    ``tol_ratio`` = max(pri/eps_pri, dua/eps_dua):

        tol_rel = clip(tol_frac * tol_ratio, min(tol_frac, cap), cap)

    exactly tol_frac at convergence, up to the cap far from it.  The
    bounds are host numbers, which the clamp rounds to the dtype: the
    bits of bounds rounded first."""
    tf = factor["tol_frac"]
    dtype = factor["dinv"].dtype
    cap = _cap_for(dtype)
    lo = min(float(tf), cap)  # tf a 0-d host tensor, or the program's static number
    if not isinstance(tf, torch.Tensor):
        tf = torch.full((), tf, dtype=dtype)
    tol = torch.clamp(tf * tol_ratio.to(dtype), min=lo, max=cap)
    return {**factor, "tol_rel": tol}


def solve(factor, A, rho_vec, rhs_x, rhs_z, x0=None):
    """One KKT solve through K6, warm-started from ``x0``: returns
    (x_tilde, z_tilde = A x_tilde).  On ELL operands with constraints the
    right-hand side b = rhs_x + A'(rho * rhs_z) and the CG's start from
    x0 come from K5's fused start (two launches), with the bits of the
    composition below.  A row-sharded A takes the composition: its rows'
    products cannot see the other ranks' rows."""
    P, sigma, dinv = factor["P"], factor["sigma"], factor["dinv"]
    start = None
    if isinstance(A, ELLMatrix) and A.shape[0] and x0 is not None:
        b, r, z = ell.ell_cg_start(P, A, rho_vec, x0, dinv, sigma, rhs_x, rhs_z, rho_vec)
        start = (r, z)
    elif A.shape[-2]:
        b = rhs_x + (ell.ell_tmatvec(A, rhs_z, rho_vec) if isinstance(A, ELLMatrix) else mat_tvec(A, rho_vec * rhs_z))
    else:
        b = rhs_x
    x, _ = cg_solve(P, A, sigma, rho_vec, dinv, b, x0, factor["tol_rel"], int(factor["max_iter"]), start)
    return x, mat_vec(A, x)
