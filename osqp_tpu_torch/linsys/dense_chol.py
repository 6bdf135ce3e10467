"""The reduced KKT matrix shared by the dense backends (counterpart of
``osqp_tpu/linsys/dense_chol.py:30-44``).

Eliminating nu from the reference KKT system (qdldl_interface.c:350-376)

    [P + sigma I   A'          ] [x~]   [rhs_x]
    [A            -diag(1/rho) ] [nu] = [rhs_z]

gives  M x~ = rhs_x + A' (rho * rhs_z)  with  M = P + sigma I + A' diag(rho) A,
and the recovered z~ equals A x~.  The Cholesky backend itself is not
ported yet (ROADMAP queue 1, item 11).
"""

from __future__ import annotations

import torch


def form_schur(P: torch.Tensor, A: torch.Tensor, sigma, rho_vec: torch.Tensor) -> torch.Tensor:
    """M = P + sigma I + A' diag(rho) A, batched (B, n, n)."""
    n = P.shape[-1]
    M = P + sigma * torch.eye(n, dtype=P.dtype, device=P.device)
    if A.shape[-2]:
        M = M + torch.bmm(A.transpose(1, 2), rho_vec[:, :, None] * A)
    return M
