"""Block-tridiagonal Schur-complement backend for stage-ordered problems
(MPC and other optimal control; counterpart of
``osqp_tpu/linsys/block_tridiag.py``).

With the decision vector ordered by stage, ``v = (x_0, u_0, x_1, ...)``
(:func:`osqp_tpu_torch.models.build_mpc_qp`), the reduced matrix

    M = P + sigma I + A' diag(rho) A

is block tridiagonal with block size ``b = nx + nu``.  The reference
handles such structure through sparse LDL' with AMD ordering
(qdldl_interface.c:177-323); here, as in the JAX package, the stages are
factored by the block Cholesky recursion of K7
(:mod:`osqp_tpu_torch.ops.block_tridiag`): O(Nb b^3) per instance where
the dense backends take O((Nb b)^3).  :func:`solve` forms
t = rhs_x + A'(rho rhs_z), runs K7's forward and backward block
substitution, and returns z~ = A x~ (the split-solution equivalence of
qdldl_interface.c:359-370).  The two products with A are plain batched
GEMVs, as the JAX package leaves them to XLA.

``block_size`` must divide n, and M must be block tridiagonal: entries
outside the band are ignored.  :func:`validate_structure` rejects such a
problem at setup (``Solver`` and ``solve_batch`` call it);
:func:`check_block_structure` measures the largest out-of-band entry.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from ..constants import ErrorCode, OSQPError
from ..linalg import mat_tvec, mat_vec
from ..ops.block_tridiag import band_blocks, bt_factor, bt_solve
from .dense_chol import form_schur


def _extract_blocks(M: torch.Tensor, b: int):
    """Diagonal blocks D (Nb, B, b, b) and sub-diagonal blocks O
    (Nb-1, B, b, b) with O_i = M[block i, block i-1], stage-leading as the
    JAX package lays them out."""
    D, O = band_blocks(M, b)
    return D.transpose(0, 1), O.transpose(0, 1)


def check_block_structure(P, A, sigma, rho_vec, block_size) -> float:
    """Largest |entry| of M outside the block-tridiagonal band (0.0 means
    the backend is exact for this problem)."""
    M = form_schur(torch.as_tensor(P), torch.as_tensor(A), sigma, torch.as_tensor(rho_vec))
    n = M.shape[-1]
    b = int(block_size)
    if b <= 0 or n % b:
        raise ValueError(f"block_size {b} must divide n = {n}")
    if not n:
        return 0.0
    blk = torch.arange(n, device=M.device) // b
    inband = (blk[:, None] - blk[None, :]).abs() <= 1
    return float(torch.where(inband, 0.0, M.abs()).max())


def _host_pattern(M):
    """|M| as numpy; a batched tensor is reduced to its union over the
    batch on its own device first, so that only one matrix comes back."""
    if isinstance(M, torch.Tensor):
        M = M.abs()
        if M.ndim == 3:
            M = M.amax(0)
        return M.cpu().numpy()
    M = np.abs(np.asarray(M))
    return M.max(axis=0) if M.ndim == 3 else M


def validate_structure(P, A, block_size: int, tol: float = 0.0) -> None:
    """Reject at setup a problem whose reduced matrix is not block
    tridiagonal: ``init`` would drop its out-of-band entries and report
    a wrong answer as solved.  The check is on the pattern of
    |P| + |A|'|A|, so it holds for every rho and sigma.  Host-side numpy
    and scipy; raises the reference's data-validation error (osqp.c:82,
    auxil.c:791)."""
    b = int(block_size)

    if sp.issparse(P) or sp.issparse(A):
        Pp = abs(sp.csc_matrix(P))
        Pp = Pp + Pp.T  # accept triu or full storage
        Ap = abs(sp.csc_matrix(A))
        S = (Pp + Ap.T @ Ap).tocoo()
        n = S.shape[0]
        if b <= 0 or (n and n % b):
            raise OSQPError(ErrorCode.DATA_VALIDATION_ERROR, f"block_size {b} must divide n = {n}")
        off = np.abs(S.row // b - S.col // b) > 1
        worst = float(np.max(S.data[off])) if off.any() else 0.0
    else:
        P, A = _host_pattern(P), _host_pattern(A)
        n = P.shape[-1]
        if b <= 0 or (n and n % b):
            raise OSQPError(ErrorCode.DATA_VALIDATION_ERROR, f"block_size {b} must divide n = {n}")
        S = P + A.T @ A
        blk = np.arange(n) // b
        off = np.abs(blk[:, None] - blk[None, :]) > 1
        worst = float(np.max(np.where(off, S, 0.0))) if n else 0.0

    if worst > tol:
        raise OSQPError(
            ErrorCode.DATA_VALIDATION_ERROR,
            "block_tridiag: P + A'A has entries outside the "
            f"block-tridiagonal band (block_size={b}, worst out-of-band "
            f"magnitude {worst:.3e}); this backend would silently drop "
            "them — use dense_inv/dense_chol/cg, or fix block_size",
        )


def init(P, A, sigma, rho_vec, block_size: int = 0, **_):
    """Factorize: ``{"C": (B, Nb, b, b), "G": (B, Nb-1, b, b)}``,
    batch-leading, so that a rho update of some instances merges the
    factors per instance (``admm._select_factor``)."""
    n = P.shape[-1]
    b = int(block_size)
    if b <= 0 or (n and n % b):
        raise ValueError(
            f"block_tridiag backend needs block_size dividing n (got "
            f"block_size={b}, n={n}); set Settings(block_size=...)"
        )
    C, G = bt_factor(form_schur(P, A, sigma, rho_vec), b)
    return {"C": C, "G": G}


def solve(factor, A, rho_vec, rhs_x, rhs_z, x0=None):
    """One KKT solve: returns (x_tilde, z_tilde = A x_tilde)."""
    t = rhs_x
    if A.shape[-2]:
        t = t + mat_tvec(A, rho_vec * rhs_z)
    x_t = bt_solve(factor["C"], factor["G"], t.contiguous())
    return x_t, mat_vec(A, x_t)
