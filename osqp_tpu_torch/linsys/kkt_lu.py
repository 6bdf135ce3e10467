"""Dense full-KKT LU backend (counterpart of ``osqp_tpu/linsys/kkt_lu.py``).

Factors the (n+m) quasi-definite KKT matrix

    K = [P + sigma I    A'          ]
        [A             -diag(1/rho) ]

with the batched partially pivoted LU of K8 (:mod:`..ops.kkt_lu`).  It is
the structural analogue of the reference's second backend (MKL Pardiso on
the full KKT, pardiso_interface.c:73-300, hence the alias
``"mkl pardiso"``), and it is robust for P that is PSD but singular,
where the Schur complement can be marginal.  Polish reuses
:func:`factor_blocks` and :func:`solve_raw` with param1 = param2 = delta
(polish.c:232-272).

The JAX package refuses KKT dimensions above 6144 because the TPU's
batched-LU call exceeds its scoped fast memory there; K8 works in device
memory by panels, so no size is refused here.
"""

from __future__ import annotations

import torch

from ..ops.kkt_lu import kkt_lu_factor_blocks, kkt_lu_solve


def factor_blocks(P, A, shift, d):
    """The factor dict of K = [[P + shift I, A'], [A, -diag(d)]] from its
    blocks (K is not formed on the card)."""
    lu, perm = kkt_lu_factor_blocks(P, A, shift, d)
    return {"lu": lu, "perm": perm}


def init(P, A, sigma, rho_vec, **_):
    """Factorize K; a singular K leaves Inf/NaN in the factor."""
    return factor_blocks(P, A, sigma, 1.0 / rho_vec)


def solve(factor, A, rho_vec, rhs_x, rhs_z, x0=None):
    """KKT solve and split-solution recovery (qdldl_interface.c:359-370):
    solves K [x~; nu] = [rhs_x; rhs_z], returns x~ and
    z~ = rhs_z + nu / rho  (== A x~)."""
    sol = solve_raw(factor, torch.cat([rhs_x, rhs_z], dim=-1))
    n = rhs_x.shape[-1]
    return sol[:, :n], rhs_z + sol[:, n:] / rho_vec


def solve_raw(factor, rhs):
    """Raw KKT solve without the z~ recovery: the polish path
    (qdldl_interface.c:354-357, ``polish=1``)."""
    return kkt_lu_solve(factor["lu"], factor["perm"], rhs)
