"""The batched ADMM solve core (counterpart of ``osqp_tpu/admm.py``;
reference osqp.c:288-654, auxil.c:161-225).

The JAX package runs the loop as one ``lax.while_loop`` with
``lax.cond`` branches.  Here the loop runs on the host over a Python
int ``k``, and each iteration enqueues device work without waiting:

* the termination check runs where ``k % check_termination == 0`` and
  the rho adaptation where ``k % adaptive_rho_interval == 0``, so both
  keep the reference's whole-loop iteration numbering;
* the host reads the device only at those iterations: ``active.any()``
  after a check and ``upd.any()`` at a rho iteration, plus the
  backend's refinement signal once per segment.

Per-instance termination freezes instances by masked selects; the loop
ends when every instance has terminated or ``k`` passes the segment end.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any

import torch

from . import linsys as linsys_registry
from .constants import (
    MIN_SCALING,
    OSQP_DUAL_INFEASIBLE,
    OSQP_DUAL_INFEASIBLE_INACCURATE,
    OSQP_INFTY,
    OSQP_MAX_ITER_REACHED,
    OSQP_NON_CVX,
    OSQP_PRIMAL_INFEASIBLE,
    OSQP_PRIMAL_INFEASIBLE_INACCURATE,
    OSQP_SOLVED,
    OSQP_SOLVED_INACCURATE,
    RHO_EQ_OVER_RHO_INEQ,
    RHO_MAX,
    RHO_MIN,
    RHO_TOL,
)
from .linalg import bwhere, vec_dot
from .termination import check_termination, compute_products, compute_rho_estimate, residual_norms
from .types import (
    DynSettings,
    InfoState,
    Iterates,
    QPData,
    RhoState,
    ScalingData,
    SolveResult,
    StaticConfig,
)


# ---------------------------------------------------------------------------
# rho vector classification (auxil.c:76-142)
# ---------------------------------------------------------------------------
def classify_constraints(l, u):
    """-1 loose / 1 equality / 0 inequality per row (auxil.c:81-95)."""
    loose = (l < -OSQP_INFTY * MIN_SCALING) & (u > OSQP_INFTY * MIN_SCALING)
    eq = u - l < RHO_TOL
    ct = torch.zeros(l.shape, dtype=torch.int8, device=l.device)
    return ct.masked_fill(eq, 1).masked_fill(loose, -1)


def rho_vec_from_type(constr_type, rho):
    """rho_vec entries by class (auxil.c:84-95): loose -> RHO_MIN,
    eq -> 1e3 rho, ineq -> rho."""
    rho_b = rho[:, None]
    return torch.where(
        constr_type == -1,
        torch.full_like(rho_b, RHO_MIN),
        torch.where(constr_type == 1, RHO_EQ_OVER_RHO_INEQ * rho_b, rho_b),
    )


def set_rho_state(data: QPData, rho) -> RhoState:
    """set_rho_vec (auxil.c:76-98); ``rho`` is (B,)."""
    rho = torch.clamp(rho, RHO_MIN, RHO_MAX)
    ct = classify_constraints(data.l, data.u)
    rv = rho_vec_from_type(ct, rho)
    return RhoState(rho=rho, rho_vec=rv, rho_inv_vec=1.0 / rv, constr_type=ct)


def update_rho_state(data: QPData, rs: RhoState) -> tuple[RhoState, torch.Tensor]:
    """update_rho_vec after a bounds change (auxil.c:100-142).  Returns the
    new state and a (B,) mask of instances whose classification changed."""
    ct = classify_constraints(data.l, data.u)
    changed = (ct != rs.constr_type).any(-1)
    rv = rho_vec_from_type(ct, rs.rho)
    return RhoState(rho=rs.rho, rho_vec=rv, rho_inv_vec=1.0 / rv, constr_type=ct), changed


# ---------------------------------------------------------------------------
# One ADMM iteration (auxil.c:161-225), refined loop body
# ---------------------------------------------------------------------------
def admm_step(solve, factor, data: QPData, dyn: DynSettings, rs: RhoState, it: Iterates, y_lo=None):
    """x~/z~ solve + relaxed x/z/y updates; returns
    (Iterates, delta_x, delta_y, y_lo).

    ``y_lo`` is the compensated-accumulation carry of the dual ascent
    (float32 only; None disables it): with equality rows at 1e3 rho,
    |y| grows large enough that float32 addition swallows small
    increments, and Knuth's TwoSum keeps the lost low bits.
    """
    x_prev, z_prev, y = it.x, it.z, it.y
    alpha = dyn.alpha

    # compute_rhs (auxil.c:161-175)
    rhs_x = dyn.sigma * x_prev - data.q
    rhs_z = z_prev - rs.rho_inv_vec * y

    # update_xz_tilde (auxil.c:177-183): z~ comes back as A x~
    x_t, z_t = solve(factor, data.A, rs.rho_vec, rhs_x, rhs_z)

    # update_x (auxil.c:185-198)
    x = alpha * x_t + (1.0 - alpha) * x_prev
    delta_x = x - x_prev

    # update_z (auxil.c:200-212) + projection (proj.c:4-14)
    z_relaxed = alpha * z_t + (1.0 - alpha) * z_prev
    z = torch.clamp(z_relaxed + rs.rho_inv_vec * y, data.l, data.u)

    # update_y (auxil.c:214-225)
    delta_y = rs.rho_vec * (z_relaxed - z)
    if y_lo is None:
        y = y + delta_y
    else:
        # TwoSum(y, delta_y + y_lo): the exact sum split into (hi, lo).
        b = delta_y + y_lo
        s = y + b
        bb = s - y
        y_lo = (y - (s - bb)) + (b - bb)
        y = s
    return Iterates(x=x, z=z, y=y), delta_x, delta_y, y_lo


# ---------------------------------------------------------------------------
# Solve core
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Carry:
    k: int  # global iteration counter
    it: Iterates
    delta_x: torch.Tensor
    delta_y: torch.Tensor
    rho_state: RhoState
    factor: Any
    info: InfoState
    active: torch.Tensor  # (B,) bool
    any_active: bool  # host copy of active.any(), refreshed at each check
    y_lo: Any = None  # (B, m) compensated dual-ascent carry (float32 only)


def _apply_check(cfg, data, scl, dyn, c: Carry, iter_number: int, approximate=False) -> Carry:
    """update_info + check_termination for active instances (osqp.c:420-449)."""
    tr = check_termination(
        cfg, data, scl, dyn, c.it.x, c.it.z, c.it.y, c.delta_x, c.delta_y, approximate
    )
    newly = c.active & tr.terminated
    solved_like = (tr.status == OSQP_SOLVED) | (tr.status == OSQP_SOLVED_INACCURATE)
    info = replace(
        c.info,
        iter=c.info.iter.masked_fill(c.active, iter_number),
        status_val=torch.where(newly, tr.status, c.info.status_val),
        obj_val=torch.where(newly & ~solved_like, tr.obj_at_term, c.info.obj_val),
        pri_res=torch.where(c.active, tr.pri_res, c.info.pri_res),
        dua_res=torch.where(c.active, tr.dua_res, c.info.dua_res),
    )
    # Certificates of instances terminating infeasible, unscaled at that
    # moment (auxil.c:762-781).
    pinf = newly & (
        (tr.status == OSQP_PRIMAL_INFEASIBLE) | (tr.status == OSQP_PRIMAL_INFEASIBLE_INACCURATE)
    )
    dinf = newly & (
        (tr.status == OSQP_DUAL_INFEASIBLE) | (tr.status == OSQP_DUAL_INFEASIBLE_INACCURATE)
    )
    active = c.active & ~tr.terminated
    return replace(
        c,
        info=info,
        active=active,
        any_active=bool(active.any()),
        delta_x=bwhere(dinf, tr.dx_cert, c.delta_x),
        delta_y=bwhere(pinf, tr.dy_cert, c.delta_y),
    )


def _apply_rho_adaptation(cfg, data, dyn, c: Carry) -> Carry:
    """adapt_rho (auxil.c:54-74) + osqp_update_rho (osqp.c:1281-1332).

    Updates rho where the estimate is more than adaptive_rho_tolerance
    off and refactors; the refactorization is skipped when no instance
    needs it.
    """
    rs = c.rho_state
    est = compute_rho_estimate(data, c.it.x, c.it.z, c.it.y, rs.rho)
    info = replace(c.info, rho_estimate=torch.where(c.active, est, c.info.rho_estimate))
    tol = dyn.adaptive_rho_tolerance
    upd = c.active & ((est > rs.rho * tol) | (est < rs.rho / tol))
    if not bool(upd.any()):
        return replace(c, info=info)

    new_rho = torch.where(upd, torch.clamp(est, RHO_MIN, RHO_MAX), rs.rho)
    new_rv = rho_vec_from_type(rs.constr_type, new_rho)
    new_rs = RhoState(rho=new_rho, rho_vec=new_rv, rho_inv_vec=1.0 / new_rv, constr_type=rs.constr_type)
    new_factor = linsys_registry.init_factor(cfg, data.P, data.A, dyn.sigma, new_rv)
    # Leaves shared with the old factor (P) and scalars pass through.
    factor = {
        key: new if new is c.factor[key] or new.ndim == 0 else bwhere(upd, new, c.factor[key])
        for key, new in new_factor.items()
    }
    info = replace(info, rho_updates=info.rho_updates + upd.to(torch.int32))
    return replace(c, rho_state=new_rs, factor=factor, info=info)


def init_carry(cfg: StaticConfig, data: QPData, rho_state: RhoState, factor: Any, iterates: Iterates) -> Carry:
    B, n = data.q.shape
    dtype, dev = data.q.dtype, data.q.device
    return Carry(
        k=1,
        it=iterates,
        delta_x=torch.zeros((B, n), dtype=dtype, device=dev),
        delta_y=torch.zeros((B, cfg.m), dtype=dtype, device=dev),
        rho_state=rho_state,
        factor=factor,
        info=InfoState.fresh(B, dtype, rho_state.rho),
        active=torch.ones(B, dtype=torch.bool, device=dev),
        any_active=B > 0,
        # Compensated dual accumulation (see admm_step): float32 only.
        y_lo=torch.zeros((B, cfg.m), dtype=dtype, device=dev) if dtype == torch.float32 else None,
    )


def run_segment(cfg: StaticConfig, data: QPData, scl: ScalingData, dyn: DynSettings, c: Carry, end_iter: int) -> Carry:
    """Run ADMM iterations while ``k <= end_iter`` and an instance is active.

    The loop body is chosen once per segment from the backend's
    refinement signal: ill-conditioned batches run the refined body
    (K1r, with the TwoSum dual carry), the rest the fused K1 body.  A
    rho refactor inside the segment that flips the signal is picked up
    at the next segment, as in the JAX package.
    """
    backend = linsys_registry.get(cfg.linsys_solver)
    check = int(cfg.check_termination)
    interval = int(cfg.adaptive_rho_interval) if cfg.adaptive_rho else 0
    end_iter = min(int(end_iter), cfg.max_iter)
    if c.k > end_iter or not c.any_active:
        return c
    refine = bool(backend.refine_signal(c.factor))

    while c.k <= end_iter and c.any_active:
        if refine:
            x, z, y, dx, dy, y_lo = backend.refined_step(
                c.factor, data, dyn, c.rho_state, c.it, c.delta_x, c.delta_y, c.y_lo, c.active
            )
            c = replace(c, it=Iterates(x=x, z=z, y=y), delta_x=dx, delta_y=dy, y_lo=y_lo)
        else:
            x, z, y, dx, dy = backend.fused_step(
                c.factor, data, dyn, c.rho_state, c.it, c.delta_x, c.delta_y, c.active
            )
            c = replace(c, it=Iterates(x=x, z=z, y=y), delta_x=dx, delta_y=dy)

        if check > 0 and c.k % check == 0:
            c = _apply_check(cfg, data, scl, dyn, c, c.k)
        if interval > 0 and c.k % interval == 0:
            c = _apply_rho_adaptation(cfg, data, dyn, c)
        c = replace(c, k=c.k + 1)
    return c


def finalize(
    cfg: StaticConfig,
    data: QPData,
    scl: ScalingData,
    dyn: DynSettings,
    c: Carry,
    fallback_status: int = OSQP_MAX_ITER_REACHED,
    run_checks: bool = True,
) -> SolveResult:
    """Post-loop logic (osqp.c:537-640): final plain check, the
    approximate-tolerance pass, the fallback status for the rest, the
    objective and the final rho estimate.  ``run_checks=False`` is the
    SIGINT path (osqp.c:377-385)."""
    last_iter = min(c.k - 1, cfg.max_iter)
    if run_checks:
        c = _apply_check(cfg, data, scl, dyn, c, last_iter, approximate=False)
        # Approximate-tolerance pass for instances still UNSOLVED
        # (osqp.c:576-581: check_termination(work, 1)).
        c = _apply_check(cfg, data, scl, dyn, c, last_iter, approximate=True)
    else:
        c = replace(c, info=replace(c.info, iter=c.info.iter.masked_fill(c.active, last_iter)))
    info = replace(c.info, status_val=c.info.status_val.masked_fill(c.active, fallback_status))

    # Objective where an instance has a solution (osqp.c:564-566,
    # auxil.c:227-238): obj = (0.5 x'Px + q'x) * cinv.
    sv = info.status_val
    has_sol = (
        (sv != OSQP_PRIMAL_INFEASIBLE)
        & (sv != OSQP_PRIMAL_INFEASIBLE_INACCURATE)
        & (sv != OSQP_DUAL_INFEASIBLE)
        & (sv != OSQP_DUAL_INFEASIBLE_INACCURATE)
        & (sv != OSQP_NON_CVX)
    )
    pr = compute_products(data, c.it.x, c.it.z, c.it.y)
    obj = scl.cinv * (0.5 * vec_dot(c.it.x, pr.Px) + vec_dot(data.q, c.it.x))
    info = replace(
        info,
        obj_val=torch.where(has_sol, obj, info.obj_val),
        # Final rho estimate (osqp.c:595)
        rho_estimate=compute_rho_estimate(data, c.it.x, c.it.z, c.it.y, c.rho_state.rho, pr),
    )
    return SolveResult(
        iterates=c.it,
        info=info,
        rho_state=c.rho_state,
        factor=c.factor,
        delta_x=c.delta_x,
        delta_y=c.delta_y,
    )


def solve_core(cfg, data, scl, dyn, rho_state, factor, iterates) -> SolveResult:
    """The full ADMM solve (osqp.c:354-640, minus host-side concerns):
    init, one whole-range segment, finalize.  Everything is scaled."""
    c = init_carry(cfg, data, rho_state, factor, iterates)
    c = run_segment(cfg, data, scl, dyn, c, cfg.max_iter)
    return finalize(cfg, data, scl, dyn, c)


def segment_row_info(cfg, data, scl, dyn, c: Carry):
    """Objective, residuals and rho at the current iterates, for the
    verbose rows (print_summary columns, util.c:152-175)."""
    pr = compute_products(data, c.it.x, c.it.z, c.it.y)
    pri, dua = residual_norms(cfg, scl, pr)
    obj = scl.cinv * (0.5 * vec_dot(c.it.x, pr.Px) + vec_dot(data.q, c.it.x))
    return obj, pri, dua, c.rho_state.rho
