"""Batched multi-QP solving (counterpart of ``osqp_tpu/batch.py``).

B problems of one shape (n, m) are solved together: every operation is
batched over the leading axis, finished instances are frozen by masked
selects, and statuses, iteration counts, residuals and certificates are
per instance.  The pipeline is Ruiz scaling, rho classification,
factorization (K2 for ``dense_inv``, K7 for ``block_tridiag``), the ADMM
loop (K1, or the backend's solve), optional polish (K8, K3), then
unscaling and certificate normalization.

The host drives the loop in segments so that it can poll the clock for
``time_limit`` and catch Ctrl-C between them (osqp.c:374-407).  The
global counter ``k`` keeps the check and rho schedules on the
reference's numbering, so segment lengths change no iterate; they only
decide where the refinement signal is re-read (see admm.run_segment),
exactly where the JAX package's driver re-reads it.

Instance compaction (``compact=True``, no reference analogue): finished
instances are frozen by masked selects but still share the batch's
launches until the slowest one ends.  The compacting driver, whenever
at most half of the working set is still active, finalizes the finished
instances into full-size accumulators and gathers the active ones into
a power-of-two sub-batch.  Per-instance arithmetic is unchanged; on the
card a kernel's split over blocks may depend on the batch size, so the
last bits of a sum can differ from the full batch's.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, NamedTuple

import numpy as np
import torch

from . import admm as admm_mod
from . import constants as con
from . import linsys as linsys_registry
from .admm import set_rho_state
from .linalg import bwhere, host_array, mat_vec, norm_inf
from .linsys import block_tridiag
from .polish import polish as polish_fn
from .scaling import scale_data, unscale_solution
from .solver import Settings, make_config, reject_time_based_rho, resolve_device, torch_dtype, validate_settings
from .sparse_ops import ELLMatrix
from .types import DynSettings, Iterates, QPData, ScalingData, SolveResult


class BatchSolveResults(NamedTuple):
    x: Any  # (B, n)
    y: Any  # (B, m)
    status_val: Any  # (B,) int32
    iter: Any  # (B,) int32
    obj_val: Any  # (B,)
    pri_res: Any  # (B,)
    dua_res: Any  # (B,)
    rho_updates: Any  # (B,) int32
    rho_estimate: Any  # (B,)
    status_polish: Any  # (B,) int32 (0 = not run)
    prim_inf_cert: Any  # (B, m) (rows valid where status is primal infeasible)
    dual_inf_cert: Any  # (B, n)


def _prepare(cfg, scaling_iters, P, q, A, l, u, rho0, dyn, x0, y0):
    """Scale, classify rho, factorize, warm or cold start
    (osqp.c:192-215, 942-965)."""
    B, n = q.shape
    m = cfg.m
    data = QPData(P=P, q=q, A=A, l=l, u=u)
    if scaling_iters > 0:
        scaled, scl = scale_data(data, scaling_iters)
    else:
        scaled, scl = data, ScalingData.identity(B, n, m, q.dtype, q.device)
    rho_state = set_rho_state(scaled, rho0)
    factor = linsys_registry.init_factor(cfg, scaled.P, scaled.A, dyn.sigma, rho_state.rho_vec)
    if x0 is None:
        it = Iterates.cold(B, n, m, q.dtype, q.device)
    else:
        xs = x0 * scl.Dinv
        ys = y0 * scl.Einv * scl.c[:, None]
        it = Iterates(x=xs, z=mat_vec(scaled.A, xs), y=ys)
    return scaled, scl, rho_state, factor, it


def _postprocess(cfg, do_polish, refine_iter, scaled, scl, dyn, result):
    """Polish, store_solution and certificate normalization
    (osqp.c:604-640, auxil.c:524-562)."""
    B = scaled.q.shape[0]
    info, it = result.info, result.iterates
    sv = info.status_val
    status_polish = torch.zeros(B, dtype=torch.int32, device=sv.device)
    obj_val, pri_res, dua_res = info.obj_val, info.pri_res, info.dua_res
    if do_polish:
        # Polish runs on every instance and is taken where the instance
        # is solved and its residuals improved.
        solved = sv == con.OSQP_SOLVED
        pol = polish_fn(cfg, scaled, scl, dyn, it.x, it.z, it.y, pri_res, dua_res, refine_iter)
        ok = solved & pol.success
        it = Iterates(x=bwhere(ok, pol.x, it.x), z=bwhere(ok, pol.z, it.z), y=bwhere(ok, pol.y, it.y))
        obj_val = torch.where(ok, pol.obj_val, obj_val)
        pri_res = torch.where(ok, pol.pri_res, pri_res)
        dua_res = torch.where(ok, pol.dua_res, dua_res)
        status_polish = torch.where(solved, torch.where(ok, 1, -1), 0).to(torch.int32)
    has_sol = (
        (sv != con.OSQP_PRIMAL_INFEASIBLE)
        & (sv != con.OSQP_PRIMAL_INFEASIBLE_INACCURATE)
        & (sv != con.OSQP_DUAL_INFEASIBLE)
        & (sv != con.OSQP_DUAL_INFEASIBLE_INACCURATE)
        & (sv != con.OSQP_NON_CVX)
    )
    x_u, y_u = unscale_solution(it.x, it.y, scl)
    nan = torch.full_like(x_u[:1], float("nan"))
    x_out = bwhere(has_sol, x_u, nan)
    y_out = bwhere(has_sol, y_u, torch.full_like(y_u[:1], float("nan"))) if cfg.m else y_u

    def _normalize(v):
        nrm = norm_inf(v)
        return v / torch.where(nrm > 0, nrm, 1.0)[:, None]

    return BatchSolveResults(
        x=x_out,
        y=y_out,
        status_val=sv,
        iter=info.iter,
        obj_val=obj_val,
        pri_res=pri_res,
        dua_res=dua_res,
        rho_updates=info.rho_updates,
        rho_estimate=info.rho_estimate,
        status_polish=status_polish,
        prim_inf_cert=_normalize(result.delta_y) if cfg.m else result.delta_y,
        dual_inf_cert=_normalize(result.delta_x),
    )


def _solve_segmented(cfg, scaling_iters, do_polish, refine_iter, P, q, A, l, u, rho0, dyn, x0, y0,
                     time_limit=0.0, verbose=False, stop=None):
    """The non-compact segmented driver (osqp_tpu/batch.py:304-502).

    Without verbose output, time limit and ``stop`` the first segment
    spans the whole iteration range; otherwise segments are ``check``
    iterations long with verbose output and ``max(4 check, 100)``
    without.  ``stop()``, where given, is polled where the clock is, from
    the second segment's end on, and returns None or the status to stop
    with (``OSQP_TIME_LIMIT_REACHED``, or ``OSQP_SIGINT``, which
    finalizes as Ctrl-C does): the row-sharded entries' agreed stop.
    """
    t0 = time.perf_counter()
    check = cfg.check_termination if cfg.check_termination > 0 else 25
    seg = check if verbose else max(4 * check, 100)
    polled = verbose or time_limit > 0 or stop is not None
    first_end = min(seg, cfg.max_iter) if polled else cfg.max_iter
    fallback = con.OSQP_MAX_ITER_REACHED
    run_checks = True

    if verbose:
        from .utils.printing import IterRowPrinter

        rows = IterRowPrinter(t0)

        def _row(c, end):
            rows.maybe(end, lambda: admm_mod.segment_row_info(cfg, scaled, scl, dyn, c))
    else:

        def _row(c, end):
            pass

    prep = (cfg, scaling_iters, P, q, A, l, u, rho0, dyn, x0, y0)
    try:
        scaled, scl, rho_state, factor, it = _prepare(*prep)
    except KeyboardInterrupt:
        # Interrupted before any usable state: prepare again for a
        # well-formed all-SIGINT result.
        scaled, scl, rho_state, factor, it = _prepare(*prep)
        c = admm_mod.init_carry(cfg, scaled, rho_state, factor, it)
        fin = admm_mod.finalize(cfg, scaled, scl, dyn, c, fallback_status=con.OSQP_SIGINT, run_checks=False)
        return _postprocess(cfg, do_polish, refine_iter, scaled, scl, dyn, fin)

    c = admm_mod.init_carry(cfg, scaled, rho_state, factor, it)
    try:
        c = admm_mod.run_segment(cfg, scaled, scl, dyn, c, first_end)
        _row(c, first_end)
        end = first_end
        if end < cfg.max_iter and c.any_active:
            # The JAX driver always queues the second segment before its
            # first clock poll; the same iterates come out of this order.
            end = min(end + seg, cfg.max_iter)
            c = admm_mod.run_segment(cfg, scaled, scl, dyn, c, end)
            while end < cfg.max_iter:
                _row(c, end)
                if not c.any_active:
                    break
                if time_limit > 0 and time.perf_counter() - t0 >= time_limit:
                    fallback = con.OSQP_TIME_LIMIT_REACHED
                    break
                status = stop() if stop is not None else None
                if status is not None:
                    fallback = status
                    if status == con.OSQP_SIGINT:
                        run_checks = False
                        print("Solver interrupted")
                    break
                end = min(end + seg, cfg.max_iter)
                c = admm_mod.run_segment(cfg, scaled, scl, dyn, c, end)
    except KeyboardInterrupt:
        # osqp.c:374-385: SIGINT exits at once, with no further checks.
        fallback = con.OSQP_SIGINT
        run_checks = False
        print("Solver interrupted")
    fin = admm_mod.finalize(cfg, scaled, scl, dyn, c, fallback_status=fallback, run_checks=run_checks)
    return _postprocess(cfg, do_polish, refine_iter, scaled, scl, dyn, fin)


def _next_pow2(v: int) -> int:
    return 1 << (int(v) - 1).bit_length() if v > 1 else 1


def _gather(obj, idx, memo):
    """Rows ``idx`` of every batched tensor in ``obj`` (a tensor, a dict or
    a dataclass of them): dim 0 of each tensor that has one; 0-d tensors
    and host values (``Carry.k``, ``any_active``, None) pass through.
    ``memo`` maps a tensor's id to its gathered copy, so that a tensor two
    fields share (dense_inv's factor keeps the scaled P) is gathered once
    and stays shared."""
    if isinstance(obj, torch.Tensor):
        if obj.ndim == 0:
            return obj
        if id(obj) not in memo:
            memo[id(obj)] = obj.index_select(0, idx)
        return memo[id(obj)]
    if isinstance(obj, dict):
        return {key: _gather(v, idx, memo) for key, v in obj.items()}
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(
            obj, **{f.name: _gather(getattr(obj, f.name), idx, memo) for f in dataclasses.fields(obj)}
        )
    return obj


def _scatter(acc, sub, rows):
    """``acc`` (full size) with rows ``rows`` replaced by the first
    ``len(rows)`` rows of ``sub``: a cohort's real rows, never its
    padding lanes."""
    if isinstance(acc, torch.Tensor):
        return acc.index_copy(0, rows, sub[: rows.numel()])
    if isinstance(acc, dict):
        return {key: _scatter(acc[key], sub[key], rows) for key in acc}
    return dataclasses.replace(
        acc, **{f.name: _scatter(getattr(acc, f.name), getattr(sub, f.name), rows) for f in dataclasses.fields(acc)}
    )


def _result_parts(r: SolveResult) -> dict:
    """What _postprocess reads of a finalized cohort, per instance."""
    return {"it": r.iterates, "info": r.info, "dx": r.delta_x, "dy": r.delta_y}


def _solve_compact(cfg, scaling_iters, do_polish, refine_iter, P, q, A, l, u, rho0, dyn, x0, y0,
                   min_batch=256, time_limit=0.0):
    """The compacting segmented driver (osqp_tpu/batch.py:504-606).

    Segments are ``check`` iterations long.  After each one the host reads
    the active mask once; once ``target = max(next_pow2(active),
    min_batch)`` is at most half the working batch, the finished cohort
    (padded to a power of two, capped at the working batch) is finalized
    and its real rows scattered into full-size accumulators, and the
    active cohort is gathered into a sub-batch of ``target`` lanes, the
    padding lanes inactive.  A host array maps the working batch's rows
    to global rows; the real rows are always its first ones.
    """
    t0 = time.perf_counter()
    B = q.shape[0]
    dev = q.device
    seg = cfg.check_termination if cfg.check_termination > 0 else 25
    fallback = con.OSQP_MAX_ITER_REACHED
    run_checks = True
    scaled, scl, rho_state, factor, it = _prepare(cfg, scaling_iters, P, q, A, l, u, rho0, dyn, x0, y0)
    c = admm_mod.init_carry(cfg, scaled, rho_state, factor, it)
    acc = {"it": c.it, "info": c.info, "dx": c.delta_x, "dy": c.delta_y}
    data, sclc = scaled, scl
    gidx = np.arange(B)  # working row -> global row; B marks a padding lane
    rows = lambda r: torch.as_tensor(r, dtype=torch.int64, device=dev)

    k = 1
    try:
        while k <= cfg.max_iter:
            end = min(k + seg - 1, cfg.max_iter)
            c = admm_mod.run_segment(cfg, data, sclc, dyn, c, end)
            k = end + 1
            act = host_array(c.active)
            na = int(act.sum())
            if na == 0 or k > cfg.max_iter:
                break
            if time_limit > 0 and time.perf_counter() - t0 >= time_limit:
                fallback = con.OSQP_TIME_LIMIT_REACHED
                break
            Bs = act.shape[0]
            target = max(_next_pow2(na), int(min_batch))
            if target > Bs // 2:
                continue

            keep = np.nonzero(act)[0]
            drop = np.nonzero(~act & (gidx < B))[0]
            # Finalize and scatter the finished cohort.
            dsize = min(max(_next_pow2(len(drop)), int(min_batch)), Bs)
            didx = np.zeros(dsize, np.int64)
            didx[: len(drop)] = drop
            memo = {}
            sub = [_gather(v, rows(didx), memo) for v in (data, sclc, c)]
            fin = admm_mod.finalize(cfg, *sub[:2], dyn, sub[2])
            acc = _scatter(acc, _result_parts(fin), rows(gidx[drop]))

            # Gather the active cohort; its padding lanes are inactive.
            kidx = np.zeros(target, np.int64)
            kidx[:na] = keep
            memo = {}
            data, sclc, c = (_gather(v, rows(kidx), memo) for v in (data, sclc, c))
            lanes = torch.as_tensor(np.arange(target) < na, device=dev)
            c = dataclasses.replace(c, active=c.active & lanes, any_active=True)
            new_gidx = np.full(target, B)
            new_gidx[:na] = gidx[keep]
            gidx = new_gidx
    except KeyboardInterrupt:
        # osqp.c:374-385: SIGINT exits at once, with no further checks.
        fallback = con.OSQP_SIGINT
        run_checks = False
        print("Solver interrupted")

    # The last cohort: a normal finalize, the fallback status for the rest.
    fin = admm_mod.finalize(cfg, data, sclc, dyn, c, fallback_status=fallback, run_checks=run_checks)
    acc = _scatter(acc, _result_parts(fin), rows(gidx[gidx < B]))
    result = SolveResult(
        iterates=acc["it"], info=acc["info"], rho_state=rho_state, factor=factor,
        delta_x=acc["dx"], delta_y=acc["dy"],
    )
    return _postprocess(cfg, do_polish, refine_iter, scaled, scl, dyn, result)


def solve_batch(
    P, q, A, l, u, x0=None, y0=None, compact=False, min_compact_batch=256, segmented=True, device=None,
    **settings,
) -> BatchSolveResults:
    """Solve B same-shape QPs together.

    Args:
      P: (B, n, n) dense symmetric cost matrices.
      q: (B, n); A: (B, m, n); l, u: (B, m) (entries beyond +-1e30 are
         clamped to the reference's finite infinity, constants.h:98-100).
         Tensors or arrays.
      x0, y0: optional warm starts (unscaled); either alone is allowed.
      compact: shrink the working batch as instances terminate (saves
         the launches' work on frozen instances when iteration counts
         are dispersed; per-instance arithmetic unchanged).  Dense
         operands only.  ``min_compact_batch`` floors the sub-batch size.
         Verbose output prints the header and footer only.
      segmented: run in host-polled segments (default), which honors
         ``time_limit``, Ctrl-C and verbose rows; False runs the whole
         range with no polling (``compact=True`` segments regardless).
      device: where to solve; default: P's device if P is a tensor,
         else the CUDA card (raises without one: pass ``device="cpu"``
         for the CPU).  CUDA tensors run the hand-written kernels.
      **settings: reference setting names (see :class:`Settings`);
         ``dtype`` defaults to torch's default dtype.

    Returns a :class:`BatchSolveResults` of tensors on ``device``.
    """
    s = Settings(**settings)
    validate_settings(s)
    reject_time_based_rho(s)
    if compact and (isinstance(P, ELLMatrix) or isinstance(A, ELLMatrix)):
        # Compaction gathers every batched leaf by instance row; the ELL
        # pattern (idx, t_idx) is unbatched and would be corrupted.
        raise con.OSQPError(
            con.ErrorCode.DATA_VALIDATION_ERROR,
            "instance compaction is not supported with ELL (sparse) operands",
        )

    dtype = torch_dtype(s.dtype)
    if device is None:
        device = P.device if isinstance(P, torch.Tensor) else resolve_device(None)
    as_t = lambda v: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v,
                                     dtype=dtype, device=device).contiguous()
    q = as_t(q)
    if q.ndim != 2:
        raise ValueError("q must be (B, n)")
    B, n = q.shape
    P = as_t(P)
    A = as_t(A)
    m = A.shape[1]
    l = torch.clamp(as_t(l), -con.OSQP_INFTY, con.OSQP_INFTY)
    u = torch.clamp(as_t(u), -con.OSQP_INFTY, con.OSQP_INFTY)

    cfg = make_config(n, m, s, dtype)
    if s.linsys_solver == "block_tridiag":
        block_tridiag.validate_structure(P, A, s.block_size)
    dyn = DynSettings.make(
        dtype,
        sigma=s.sigma,
        alpha=s.alpha,
        eps_abs=s.eps_abs,
        eps_rel=s.eps_rel,
        eps_prim_inf=s.eps_prim_inf,
        eps_dual_inf=s.eps_dual_inf,
        adaptive_rho_tolerance=s.adaptive_rho_tolerance,
        delta=s.delta,
    )
    rho0 = torch.full((B,), s.rho, dtype=dtype, device=device)
    if x0 is not None or y0 is not None:
        # reference osqp_warm_start: either side alone is allowed, the
        # other defaults to zero (osqp.c:967-1010)
        x0 = as_t(x0) if x0 is not None else torch.zeros((B, n), dtype=dtype, device=device)
        y0 = as_t(y0) if y0 is not None else torch.zeros((B, m), dtype=dtype, device=device)

    do_polish, refine_iter = bool(s.polish), int(s.polish_refine_iter)
    if not (segmented or compact):
        scaled, scl, rho_state, factor, it = _prepare(cfg, int(s.scaling), P, q, A, l, u, rho0, dyn, x0, y0)
        fin = admm_mod.solve_core(cfg, scaled, scl, dyn, rho_state, factor, it)
        return _postprocess(cfg, do_polish, refine_iter, scaled, scl, dyn, fin)

    verbose = bool(s.verbose)
    if verbose:
        from .utils.printing import print_setup_header_vals

        nnz = int(torch.count_nonzero(torch.triu(P[0]))) + int(torch.count_nonzero(A[0]))
        print_setup_header_vals(s, n, m, nnz, B=B)
    t0 = time.perf_counter()
    args = (cfg, int(s.scaling), do_polish, refine_iter, P, q, A, l, u, rho0, dyn, x0, y0)
    if compact:
        res = _solve_compact(*args, min_batch=int(min_compact_batch), time_limit=float(s.time_limit))
    else:
        res = _solve_segmented(*args, time_limit=float(s.time_limit), verbose=verbose)
    if verbose:
        from .utils.printing import print_batch_footer

        print_batch_footer(res, s, time.perf_counter() - t0)
    return res
