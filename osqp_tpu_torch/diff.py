"""Differentiable QP layer: implicit differentiation through the KKT
conditions (counterpart of ``osqp_tpu/diff.py``).

Forward is the batched solve; backward is one linear solve against the
same masked, regularized KKT matrix that polish factors
(:mod:`osqp_tpu_torch.polish`), so on the card the backward pass runs
K8 (the LU of the KKT blocks and its solve) and K3 (the products of its
refinement steps), and on the CPU their plain versions.

With the active rows A_a treated as equalities A_a x = b_a, the optimum
satisfies

    [P    A_a'] [x ]   [-q ]
    [A_a  0   ] [y_a] = [b_a]

For a loss L(x*), the (symmetric) adjoint system

    [P    A_a'] [u]   [g]            g = dL/dx*
    [A_a  0   ] [v] = [0]

gives   dL/dq = -u
        dL/dP = -(u x*' + x* u')/2          (symmetrized)
        dL/dA = -(y* u' + v x*')
        dL/dl_i = v_i (lower-active rows),  dL/du_i = v_i (upper-active)

Degenerate problems (weakly active constraints) have nonunique
derivatives; like other QP layers this returns the one induced by the
regularized masked KKT.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from .batch import solve_batch
from .linsys import kkt_lu
from .ops.term_products import term_products


def _adjoint_solve(P, A, active_mask, g, delta, refine_iter=3):
    """Solve [P, (MA)'; MA, 0] [u; v] = [g; 0] by the delta-regularized
    masked KKT K_delta = [P + delta I, (MA)'; MA, -delta I] (K8) and
    ``refine_iter`` steps of iterative refinement against the
    unregularized system, their residual products on K3.  Returns u and
    v masked to the active rows."""
    B, n = g.shape
    m = A.shape[1]
    MA = (active_mask[:, :, None] * A).contiguous()
    P = P.contiguous()
    g = g.contiguous()
    factor = kkt_lu.factor_blocks(P, MA, float(delta), torch.full((B, m), float(delta), dtype=g.dtype,
                                                                   device=g.device))
    sol = kkt_lu.solve_raw(factor, torch.cat([g, torch.zeros((B, m), dtype=g.dtype, device=g.device)], dim=-1))
    for _ in range(refine_iter):
        tp = term_products(P, MA, sol[:, :n].contiguous(), sol[:, n:].contiguous())  # MA su, P su, (MA)' sv
        r_u = g - (tp.Px + tp.Aty)
        r_v = -tp.Ax
        sol = sol + kkt_lu.solve_raw(factor, torch.cat([r_u, r_v], dim=-1))
    return sol[:, :n], active_mask * sol[:, n:]


class _QPLayer(torch.autograd.Function):
    """x* = argmin of the batch of QPs; backward by :func:`_adjoint_solve`."""

    @staticmethod
    def forward(ctx, P, q, A, l, u, active_tol, settings):
        res = solve_batch(P, q, A, l, u, device=q.device, **settings)
        dtype = res.x.dtype
        ctx.saved = (P.to(dtype), A.to(dtype), res.x, res.y)
        ctx.active_tol = active_tol
        return res.x

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        P, A, x, y = ctx.saved
        dtype = x.dtype
        lower = y < -ctx.active_tol
        upper = y > ctx.active_tol
        mask = (lower | upper).to(dtype)
        delta = 1e-6 if dtype == torch.float32 else 1e-9
        u_adj, v = _adjoint_solve(P, A, mask, g.to(dtype), delta)
        need = ctx.needs_input_grad
        dP = dq = dA = dl = du = None
        if need[0]:
            outer = u_adj[:, :, None] * x[:, None, :]
            dP = -0.5 * (outer + outer.transpose(1, 2))
        if need[1]:
            dq = -u_adj
        if need[2]:
            dA = -(y[:, :, None] * u_adj[:, None, :] + v[:, :, None] * x[:, None, :])
        zero = torch.zeros((), dtype=dtype, device=x.device)
        if need[3]:
            dl = torch.where(lower, v, zero)
        if need[4]:
            du = torch.where(upper, v, zero)
        return dP, dq, dA, dl, du, None, None


def make_qp_layer(active_tol: float = 1e-8, **settings):
    """Build a differentiable batched QP layer.

        layer = make_qp_layer(eps_abs=1e-8, eps_rel=1e-8)
        x_star = layer(P, q, A, l, u)        # (B, n), differentiable

    P (B, n, n), q (B, n), A (B, m, n), l and u (B, m) are tensors; the
    solve runs on q's device in the ``dtype`` setting, q's dtype by
    default.  Solve settings should be tight (the gradient assumes an
    accurate optimum); polish defaults on.  Returns only the primal
    solution.

    The gradient is first order only: the backward pass is
    ``once_differentiable``, so a gradient of the gradient raises a
    RuntimeError.  The JAX package's layer is first order only too: a
    gradient of its gradient differentiates the backward pass's x* and
    y*, which come out of the solve's while loop, and reverse mode refuses
    a while loop (``jax.grad`` of a ``jax.grad`` raises a ValueError).
    """
    settings.setdefault("polish", True)
    settings.setdefault("verbose", False)

    def layer(P, q, A, l, u):
        args = [v if isinstance(v, torch.Tensor) else torch.as_tensor(v) for v in (P, q, A, l, u)]
        kw = settings if "dtype" in settings else {**settings, "dtype": args[1].dtype}
        return _QPLayer.apply(*args, active_tol, kw)

    return layer
