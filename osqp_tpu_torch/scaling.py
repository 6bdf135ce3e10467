"""Modified Ruiz equilibration, dense branch (counterpart of
``osqp_tpu/scaling.py``; reference src/scaling.c:44-156).

Each sweep takes the column norms of the scaled KKT matrix and the row
norms of the scaled A, limits and square-roots them into the running
D and E, then normalizes the cost by c.  The sweeps only *read* P and
A: the accumulated (c, D, E) are folded into the norms and applied to
the matrices once at the end.
"""

from __future__ import annotations

import torch

from .constants import MAX_SCALING, MIN_SCALING
from .types import QPData, ScalingData


def limit_scaling(v: torch.Tensor) -> torch.Tensor:
    """scaling.c:7-14: values below MIN_SCALING -> 1, above MAX_SCALING -> MAX."""
    v = torch.where(v < MIN_SCALING, torch.ones_like(v), v)
    return torch.clamp(v, max=MAX_SCALING)


def scale_data(data: QPData, n_iters: int) -> tuple[QPData, ScalingData]:
    """Run ``n_iters`` Ruiz sweeps; returns the scaled data and scaling."""
    B, n = data.q.shape
    m = data.l.shape[-1]
    dtype, dev = data.q.dtype, data.q.device
    absP = data.P.abs()
    absA = data.A.abs()
    q0 = data.q
    zeros = lambda *s: torch.zeros(s, dtype=dtype, device=dev)
    ones = lambda *s: torch.ones(s, dtype=dtype, device=dev)

    def p_colmax(D):
        """colmax_j(D_i |P_ij|) * D_j — the c-free column norm of DPD."""
        return (absP * D[:, :, None]).amax(-2) * D

    c, D, E = ones(B), ones(B, n), ones(B, m)
    # The cost-normalization norm of sweep k and the d-norm of sweep k+1
    # read the same reduction over P (D does not change between them and
    # c factors out), so one P pass per sweep is carried.
    Pcol = p_colmax(D) if n else zeros(B, n)
    for _ in range(n_iters):
        Pn = Pcol * c[:, None] if n else zeros(B, n)
        if m:
            An_col = (absA * E[:, :, None]).amax(-2) * D
            e_norm = (absA * D[:, None, :]).amax(-1) * E
            d_norm = torch.maximum(Pn, An_col)
        else:
            e_norm = zeros(B, m)
            d_norm = Pn
        D = D * (1.0 / torch.sqrt(limit_scaling(d_norm)))
        E = E * (1.0 / torch.sqrt(limit_scaling(e_norm)))

        # Cost normalization (scaling.c:110-141) on the scaled P, q.
        if n:
            Pcol = p_colmax(D)
        col_norm_P = Pcol * c[:, None] if n else zeros(B, n)
        c_temp = col_norm_P.mean(-1)
        inf_norm_q = limit_scaling((q0.abs() * D).amax(-1) * c)
        c_temp = limit_scaling(torch.maximum(c_temp, inf_norm_q))
        c = c / c_temp

    scl = ScalingData(c=c, cinv=1.0 / c, D=D, Dinv=1.0 / D, E=E, Einv=1.0 / E)
    scaled = QPData(
        P=c[:, None, None] * (D[:, :, None] * data.P * D[:, None, :]),
        q=c[:, None] * (D * q0),
        A=E[:, :, None] * data.A * D[:, None, :],
        l=E * data.l,
        u=E * data.u,
    )
    return scaled, scl


def unscale_solution(x: torch.Tensor, y: torch.Tensor, scl: ScalingData):
    """scaling.c:177-192: x <- D x, y <- cinv E y."""
    return scl.D * x, scl.cinv[:, None] * (scl.E * y)
