"""Modified Ruiz equilibration (counterpart of ``osqp_tpu/scaling.py``;
reference src/scaling.c:44-156).

Each sweep takes the column norms of the scaled KKT matrix and the row
norms of the scaled A, limits and square-roots them into the running
D and E, then normalizes the cost by c.  Dense operands run the sweeps
and the final scaling in K4 (:mod:`osqp_tpu_torch.ops.ruiz`); ELL
operands run the same sweeps matrix-free on K5's norms
(:mod:`osqp_tpu_torch.ops.ell`), as the reference does over CSC
(scaling.c:28-42).  An A whose rows are spread over processes
(:class:`~osqp_tpu_torch.parallel.rows.RowSharded`) runs the same sweeps
with its maxima merged over the ranks: K4 step by step when dense, K5's
norms on its rows and its replicated transpose when ELL.
"""

from __future__ import annotations

import torch

from .ops.ell import ell_col_norms, ell_products, ell_row_norms, ell_scale
from .ops.ruiz import limit_scaling, ruiz
from .parallel.rows import RowSharded
from .sparse_ops import ELLMatrix
from .types import QPData, ScalingData


def scale_data(data: QPData, n_iters: int) -> tuple[QPData, ScalingData]:
    """Run ``n_iters`` Ruiz sweeps; returns the scaled data and scaling."""
    if isinstance(data.A, ELLMatrix) or isinstance(data.P, ELLMatrix):
        return _scale_data_ell(data, n_iters)
    if isinstance(data.A, RowSharded):
        c, D, E, P, q, A, l, u = data.A.ruiz(data.P, data.q, data.l, data.u, n_iters)
    else:
        c, D, E, P, q, A, l, u = ruiz(data.P, data.q, data.A, data.l, data.u, n_iters)
    scl = ScalingData(c=c, cinv=1.0 / c, D=D, Dinv=1.0 / D, E=E, Einv=1.0 / E)
    return QPData(P=P, q=q, A=A, l=l, u=u), scl


def _scale_data_ell(data: QPData, n_iters: int) -> tuple[QPData, ScalingData]:
    """The sweeps on ELL operands (osqp_tpu/scaling.py:133-185): P and A
    are only read, the accumulated (c, D, E) folded into K5's weighted
    norms, and applied once at the end by ``ell_scale``.  The
    cost-normalization norm of one sweep is the P norm of the next, and
    it shares a launch with the next sweep's norms of A."""
    P, A, q0 = data.P, data.A, data.q
    B, n = q0.shape
    m = data.l.shape[-1]
    dtype, dev = q0.dtype, q0.device
    ones = lambda *s: torch.ones(s, dtype=dtype, device=dev)
    zeros = lambda *s: torch.zeros(s, dtype=dtype, device=dev)

    def norms(D, E, sweep: bool):
        """P's column norms under D and, for a sweep to come, A's column
        norms under E and row norms under D: one K5 launch."""
        if isinstance(A, RowSharded):
            return A.ell_norms(P, D, E, sweep)
        calls = [(ell_col_norms, P, D)] + ([(ell_col_norms, A, E), (ell_row_norms, A, D)] if sweep else [])
        return ell_products(*calls) + [None] * (3 - len(calls))

    c, D, E = ones(B), ones(B, n), ones(B, m)
    P_norm, A_col, A_row = norms(D, E, n_iters > 0)
    Pcol = P_norm * D if n else zeros(B, n)
    for i in range(n_iters):
        Pn = Pcol * c[:, None] if n else zeros(B, n)
        if m:
            An_col = A_col * D
            e_norm = A_row * E
            d_norm = torch.maximum(Pn, An_col)
        else:
            e_norm = zeros(B, m)
            d_norm = Pn
        D = D * (1.0 / torch.sqrt(limit_scaling(d_norm)))
        E = E * (1.0 / torch.sqrt(limit_scaling(e_norm)))

        # this sweep's P norm and the next sweep's A norms share D and E
        P_norm, A_col, A_row = norms(D, E, i + 1 < n_iters)
        Pcol = P_norm * D if n else Pcol
        col_norm_P = Pcol * c[:, None] if n else zeros(B, n)
        c_temp = col_norm_P.mean(-1)
        inf_norm_q = limit_scaling((q0.abs() * D).amax(-1) * c)
        c_temp = limit_scaling(torch.maximum(c_temp, inf_norm_q))
        c = c / c_temp

    scl = ScalingData(c=c, cinv=1.0 / c, D=D, Dinv=1.0 / D, E=E, Einv=1.0 / E)
    scaled = QPData(
        P=ell_scale(P, D, D, c),
        q=c[:, None] * (D * q0),
        A=A.ell_scale(E, D) if isinstance(A, RowSharded) else ell_scale(A, E, D),
        l=E * data.l,
        u=E * data.u,
    )
    return scaled, scl


def unscale_solution(x: torch.Tensor, y: torch.Tensor, scl: ScalingData):
    """scaling.c:177-192: x <- D x, y <- cinv E y."""
    return scl.D * x, scl.cinv[:, None] * (scl.E * y)
