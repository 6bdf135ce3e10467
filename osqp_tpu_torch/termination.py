"""Residuals, tolerances, infeasibility certificates and status
decisions (counterpart of ``osqp_tpu/termination.py``; reference
src/auxil.c:13-52, 240-512, 681-786).

All functions take and return tensors with a leading batch axis B, on
scaled problem data; unscaling through D, E and c happens where the
reference does it.  Every matrix product of dense operands goes through
K3 (:mod:`osqp_tpu_torch.ops.term_products`), one call per check, rho
estimate or verbose row; ELL operands take K5
(:mod:`osqp_tpu_torch.ops.ell`), one grouped launch per call.  The rest is
O(B(n+m)) plain PyTorch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .constants import (
    MIN_SCALING,
    OSQP_DIVISION_TOL,
    OSQP_DUAL_INFEASIBLE,
    OSQP_DUAL_INFEASIBLE_INACCURATE,
    OSQP_INFTY,
    OSQP_NON_CVX,
    OSQP_PRIMAL_INFEASIBLE,
    OSQP_PRIMAL_INFEASIBLE_INACCURATE,
    OSQP_SOLVED,
    OSQP_SOLVED_INACCURATE,
    RHO_MAX,
    RHO_MIN,
)
from .linalg import norm_inf, scaled_norm_inf, vec_dot
from .ops.ell import ell_matvec, ell_products, ell_tmatvec
from .ops.term_products import TermProducts, term_products
from .parallel.rows import RowSharded
from .sparse_ops import ELLMatrix
from .types import DynSettings, QPData, ScalingData, StaticConfig


class Products(NamedTuple):
    """The matrix products update_info needs (auxil.c:240-318), and
    those of the certificate checks when asked for."""

    Ax: torch.Tensor  # (B, m)
    Px: torch.Tensor  # (B, n)
    Aty: torch.Tensor  # (B, n)
    pri_vec: torch.Tensor  # (B, m) scaled primal residual  A x - z
    dua_vec: torch.Tensor  # (B, n) scaled dual residual    q + P x + A' y
    Atdy: torch.Tensor | None = None  # (B, n) A' dy, dy the projected delta_y
    Pdx: torch.Tensor | None = None  # (B, n) P delta_x
    Adx: torch.Tensor | None = None  # (B, m) A delta_x


def compute_products(data: QPData, x, z, y, delta_x=None, dy_proj=None) -> Products:
    """A x, P x, A'y and, given the certificate directions delta_x and
    dy_proj (see project_delta_y), A'dy, P delta_x, A delta_x: one K3
    call on dense operands, one K5 launch on ELL operands (on a
    row-sharded A, the same on its rows and the collectives after them)."""
    P, A = data.P, data.A
    if isinstance(A, RowSharded):
        tp = A.term_products(P, x, y, delta_x, dy_proj)
    elif isinstance(P, ELLMatrix):
        calls = [(ell_matvec, A, x), (ell_matvec, P, x), (ell_tmatvec, A, y)]
        if delta_x is not None:
            calls += [(ell_tmatvec, A, dy_proj), (ell_matvec, P, delta_x), (ell_matvec, A, delta_x)]
        tp = TermProducts(*ell_products(*calls), *[None] * (6 - len(calls)))
    else:
        tp = term_products(P, A, x, y, delta_x, dy_proj)
    return Products(
        Ax=tp.Ax, Px=tp.Px, Aty=tp.Aty, pri_vec=tp.Ax - z, dua_vec=data.q + tp.Px + tp.Aty,
        Atdy=tp.Atdy, Pdx=tp.Pdx, Adx=tp.Adx,
    )


def residual_norms(cfg: StaticConfig, scl: ScalingData, pr: Products):
    """info->pri_res / dua_res (auxil.c:240-318); m == 0 gives pri_res = 0."""
    if cfg.scaled_termination:
        return norm_inf(pr.pri_vec), norm_inf(pr.dua_vec)
    pri = scaled_norm_inf(scl.Einv, pr.pri_vec)
    dua = scl.cinv * scaled_norm_inf(scl.Dinv, pr.dua_vec)
    return pri, dua


def tolerances(cfg: StaticConfig, data: QPData, scl: ScalingData, pr: Products, z, eps_abs, eps_rel):
    """eps_pri (auxil.c:256-285) and eps_dua (auxil.c:320-359)."""
    if cfg.scaled_termination:
        rel_pri = torch.maximum(norm_inf(z), norm_inf(pr.Ax))
        rel_dua = torch.maximum(
            torch.maximum(norm_inf(data.q), norm_inf(pr.Aty)), norm_inf(pr.Px)
        )
    else:
        rel_pri = torch.maximum(
            scaled_norm_inf(scl.Einv, z), scaled_norm_inf(scl.Einv, pr.Ax)
        )
        rel_dua = scl.cinv * torch.maximum(
            torch.maximum(
                scaled_norm_inf(scl.Dinv, data.q), scaled_norm_inf(scl.Dinv, pr.Aty)
            ),
            scaled_norm_inf(scl.Dinv, pr.Px),
        )
    return eps_abs + eps_rel * rel_pri, eps_abs + eps_rel * rel_dua


def project_delta_y(data: QPData, delta_y):
    """delta_y projected onto the polar of the recession cone of [l, u]
    (auxil.c:374-387), which becomes the primal certificate."""
    inf_u = data.u > OSQP_INFTY * MIN_SCALING
    inf_l = data.l < -OSQP_INFTY * MIN_SCALING
    zero = torch.zeros((), dtype=delta_y.dtype, device=delta_y.device)
    return torch.where(
        inf_u & inf_l,
        zero,
        torch.where(
            inf_u,
            torch.minimum(delta_y, zero),
            torch.where(inf_l, torch.maximum(delta_y, zero), delta_y),
        ),
    )


def primal_infeasibility(cfg: StaticConfig, data: QPData, scl: ScalingData, dy, Atdy, eps_prim_inf):
    """is_primal_infeasible (auxil.c:361-424) on the projected delta_y
    ``dy`` and its product ``Atdy`` = A'dy; returns (B,) bool."""
    if cfg.m == 0:
        return torch.zeros(dy.shape[0], dtype=torch.bool, device=dy.device)
    norm_dy = norm_inf(dy) if cfg.scaled_termination else scaled_norm_inf(scl.E, dy)

    # u' max(dy, 0) + l' min(dy, 0) on scaled data (auxil.c:400-403).
    ineq_lhs = vec_dot(data.u, torch.clamp(dy, min=0.0)) + vec_dot(data.l, torch.clamp(dy, max=0.0))

    if not cfg.scaled_termination:
        Atdy = scl.Dinv * Atdy

    return (
        (norm_dy > OSQP_DIVISION_TOL)
        & (ineq_lhs < eps_prim_inf * norm_dy)
        & (norm_inf(Atdy) < eps_prim_inf * norm_dy)
    )


def dual_infeasibility(cfg: StaticConfig, data: QPData, scl: ScalingData, delta_x, Pdx, Adx, eps_dual_inf):
    """is_dual_infeasible (auxil.c:426-512) on delta_x and its products
    ``Pdx`` = P delta_x and ``Adx`` = A delta_x; returns (B,) bool."""
    if cfg.scaled_termination:
        norm_dx = norm_inf(delta_x)
        cost_scaling = torch.ones_like(norm_dx)
    else:
        norm_dx = scaled_norm_inf(scl.D, delta_x)
        cost_scaling = scl.c

    thresh = cost_scaling * eps_dual_inf * norm_dx
    cond_q = vec_dot(data.q, delta_x) < thresh

    if not cfg.scaled_termination:
        Pdx = scl.Dinv * Pdx
    cond_P = norm_inf(Pdx) < thresh

    if cfg.m:
        if not cfg.scaled_termination:
            Adx = scl.Einv * Adx
        # De Morgan over constraints (auxil.c:491-502); eps * norm_dx is
        # not cost-scaled here, as in the reference.
        t = (eps_dual_inf * norm_dx)[:, None]
        bad = ((data.u < OSQP_INFTY * MIN_SCALING) & (Adx > t)) | (
            (data.l > -OSQP_INFTY * MIN_SCALING) & (Adx < -t)
        )
        cond_A = ~bad.any(-1)
    else:
        cond_A = torch.ones_like(cond_q)

    return (norm_dx > OSQP_DIVISION_TOL) & cond_q & cond_P & cond_A


class TermResult(NamedTuple):
    terminated: torch.Tensor  # (B,) bool
    status: torch.Tensor  # (B,) int32 (valid only where terminated)
    pri_res: torch.Tensor  # (B,)
    dua_res: torch.Tensor  # (B,)
    obj_at_term: torch.Tensor  # (B,) objective for infeasible/noncvx statuses
    dy_cert: torch.Tensor  # (B, m) certificate (projected, unscaled at term)
    dx_cert: torch.Tensor  # (B, n) certificate (unscaled at term)
    tol_ratio: torch.Tensor  # (B,) max(pri/eps_pri, dua/eps_dua)


def check_termination(
    cfg: StaticConfig,
    data: QPData,
    scl: ScalingData,
    dyn: DynSettings,
    x,
    z,
    y,
    delta_x,
    delta_y,
    approximate: bool,
) -> TermResult:
    """Batched check_termination (auxil.c:681-786); ``approximate``
    multiplies all four tolerances by 10 (auxil.c:709-714)."""
    dy_proj = project_delta_y(data, delta_y) if cfg.m else delta_y
    pr = compute_products(data, x, z, y, delta_x, dy_proj)
    pri_res, dua_res = residual_norms(cfg, scl, pr)

    mult = 10.0 if approximate else 1.0
    eps_abs = dyn.eps_abs * mult
    eps_rel = dyn.eps_rel * mult
    eps_pinf = dyn.eps_prim_inf * mult
    eps_dinf = dyn.eps_dual_inf * mult

    # Divergence => non-convex (auxil.c:699-706)
    non_cvx = (pri_res > OSQP_INFTY) | (dua_res > OSQP_INFTY)

    eps_pri, eps_dua = tolerances(cfg, data, scl, pr, z, eps_abs, eps_rel)

    if cfg.m == 0:
        prim_ok = torch.ones_like(non_cvx)
        prim_inf = torch.zeros_like(non_cvx)
    else:
        prim_ok = pri_res < eps_pri
        prim_inf = ~prim_ok & primal_infeasibility(cfg, data, scl, dy_proj, pr.Atdy, eps_pinf)

    dual_ok = dua_res < eps_dua
    dual_inf = ~dual_ok & dual_infeasibility(cfg, data, scl, delta_x, pr.Pdx, pr.Adx, eps_dinf)
    solved = prim_ok & dual_ok

    if approximate:
        s_solved, s_pinf, s_dinf = (
            OSQP_SOLVED_INACCURATE,
            OSQP_PRIMAL_INFEASIBLE_INACCURATE,
            OSQP_DUAL_INFEASIBLE_INACCURATE,
        )
    else:
        s_solved, s_pinf, s_dinf = OSQP_SOLVED, OSQP_PRIMAL_INFEASIBLE, OSQP_DUAL_INFEASIBLE

    dev = pri_res.device
    # torch.full, not torch.tensor: inside the traced program's loop a
    # tensor made from data is a constant that torch.export.save refuses
    i32 = lambda v: torch.full((), v, dtype=torch.int32, device=dev)
    status = torch.where(
        non_cvx,
        i32(OSQP_NON_CVX),
        torch.where(solved, i32(s_solved), torch.where(prim_inf, i32(s_pinf), i32(s_dinf))),
    )
    terminated = non_cvx | solved | prim_inf | (~prim_inf & dual_inf)

    # Objective value at a terminal status (auxil.c:704, 766, 781)
    f = lambda v: torch.full((), v, dtype=pri_res.dtype, device=dev)
    obj_at_term = torch.where(
        non_cvx, f(float("nan")), torch.where(prim_inf, f(OSQP_INFTY), f(-OSQP_INFTY))
    )

    # Certificate unscaling at termination (auxil.c:762-781); a no-op
    # with identity scaling, so applied unconditionally.
    if cfg.scaled_termination:
        dy_cert, dx_cert = dy_proj, delta_x
    else:
        dy_cert, dx_cert = scl.E * dy_proj, scl.D * delta_x

    tol_ratio = torch.maximum(
        pri_res / torch.clamp(eps_pri, min=OSQP_DIVISION_TOL),
        dua_res / torch.clamp(eps_dua, min=OSQP_DIVISION_TOL),
    )
    return TermResult(
        terminated=terminated,
        status=status,
        pri_res=pri_res,
        dua_res=dua_res,
        obj_at_term=obj_at_term,
        dy_cert=dy_cert,
        dx_cert=dx_cert,
        tol_ratio=tol_ratio,
    )


def compute_rho_estimate(data: QPData, x, z, y, rho, pr: Products | None = None):
    """compute_rho_estimate (auxil.c:13-52), in scaled space; ``pr``, the
    products at (x, z, y) when the caller has them."""
    if pr is None:
        pr = compute_products(data, x, z, y)
    pri_res = norm_inf(pr.pri_vec)
    dua_res = norm_inf(pr.dua_vec)
    pri_norm = torch.maximum(norm_inf(z), norm_inf(pr.Ax))
    dua_norm = torch.maximum(
        torch.maximum(norm_inf(data.q), norm_inf(pr.Aty)), norm_inf(pr.Px)
    )
    pri = pri_res / (pri_norm + OSQP_DIVISION_TOL)
    dua = dua_res / (dua_norm + OSQP_DIVISION_TOL)
    return torch.clamp(rho * torch.sqrt(pri / dua), RHO_MIN, RHO_MAX)
