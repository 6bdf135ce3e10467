"""Dense Schur-complement Cholesky backend, and the reduced KKT matrix it
shares with ``dense_inv`` (counterpart of ``osqp_tpu/linsys/dense_chol.py``).

Eliminating nu from the reference KKT system (qdldl_interface.c:350-376)

    [P + sigma I   A'          ] [x~]   [rhs_x]
    [A            -diag(1/rho) ] [nu] = [rhs_z]

gives  M x~ = rhs_x + A' (rho * rhs_z)  with  M = P + sigma I + A' diag(rho) A,
and the recovered z~ equals A x~.  :func:`init` keeps the batched lower
Cholesky factor of M and :func:`solve` runs two triangular solves and
two matrix-vector products per iteration; the factorization and the
triangular solves are torch's, as the JAX package leaves them to its
library outside any of its own routines.
"""

from __future__ import annotations

import torch

from ..linalg import mat_tvec, mat_vec


def form_schur(P: torch.Tensor, A: torch.Tensor, sigma, rho_vec: torch.Tensor) -> torch.Tensor:
    """M = P + sigma I + A' diag(rho) A, batched (B, n, n)."""
    n = P.shape[-1]
    M = P + sigma * torch.eye(n, dtype=P.dtype, device=P.device)
    if A.shape[-2]:
        M = M + torch.bmm(A.transpose(1, 2), rho_vec[:, :, None] * A)
    return M


def init(P, A, sigma, rho_vec, **_):
    """Factorize: the batched lower Cholesky factor of M.  A non-PD M
    gives NaN in that instance's factor; like the reference's D-sign count
    (qdldl_interface.c:93-99) this signals non-convexity, surfaced by the
    setup-time convexity check."""
    L, info = torch.linalg.cholesky_ex(form_schur(P, A, sigma, rho_vec))
    return {"L": torch.where((info == 0)[:, None, None], L, float("nan"))}


def solve(factor, A, rho_vec, rhs_x, rhs_z, x0=None):
    """One KKT solve: returns (x_tilde, z_tilde = A x_tilde)."""
    b = rhs_x
    if A.shape[-2]:
        b = b + mat_tvec(A, rho_vec * rhs_z)
    x_t = torch.cholesky_solve(b[:, :, None], factor["L"])[:, :, 0]
    return x_t, mat_vec(A, x_t)
