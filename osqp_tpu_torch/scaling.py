"""Modified Ruiz equilibration, dense branch (counterpart of
``osqp_tpu/scaling.py``; reference src/scaling.c:44-156).

Each sweep takes the column norms of the scaled KKT matrix and the row
norms of the scaled A, limits and square-roots them into the running
D and E, then normalizes the cost by c.  The sweeps and the final
scaling run in K4 (:mod:`osqp_tpu_torch.ops.ruiz`).
"""

from __future__ import annotations

import torch

from .ops.ruiz import ruiz
from .types import QPData, ScalingData


def scale_data(data: QPData, n_iters: int) -> tuple[QPData, ScalingData]:
    """Run ``n_iters`` Ruiz sweeps; returns the scaled data and scaling."""
    c, D, E, P, q, A, l, u = ruiz(data.P, data.q, data.A, data.l, data.u, n_iters)
    scl = ScalingData(c=c, cinv=1.0 / c, D=D, Dinv=1.0 / D, E=E, Einv=1.0 / E)
    return QPData(P=P, q=q, A=A, l=l, u=u), scl


def unscale_solution(x: torch.Tensor, y: torch.Tensor, scl: ScalingData):
    """scaling.c:177-192: x <- D x, y <- cinv E y."""
    return scl.D * x, scl.cinv[:, None] * (scl.E * y)
