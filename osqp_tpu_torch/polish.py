"""Solution polishing: active-set refinement with iterative refinement
(counterpart of ``osqp_tpu/polish.py``, dense operands; reference
src/polish.c:19-350).

The reference builds a smaller ``Ared`` of the rows guessed active
(polish.c:19-97).  Here, as in the JAX package, the shape stays fixed:
all m rows are kept and the inactive ones are zeroed, M = diag(mask).
The embedded KKT

    K_delta = [P + delta I      (M A)'   ]
              [M A              -delta I ]

is block-equivalent to the reference's reduced KKT (kkt.c:6-177 with
param1 = param2 = delta): an inactive row i contributes the decoupled
equation ``-delta nu_i = 0``, and its zero column leaves x untouched.
Iterative refinement (polish.c:134-181) targets the unregularized masked
KKT ``[P, (MA)'; MA, 0]``.

On dense operands K_delta is factored by K8's partially pivoted LU
(:mod:`osqp_tpu_torch.ops.kkt_lu`) at every KKT dimension, in float32 and
float64, at the reference delta, and the products of a refinement step
go through K3 (:mod:`osqp_tpu_torch.ops.term_products`).

On ELL operands (``solve_sparse``, ``SparseSolver``) K_delta is
block-eliminated, as in the JAX package, to

    S sx = r_x + (1/d) (MA)' r_z,   snu = ((MA) sx - r_z) / d,
    S = P + d I + (1/d) (MA)'(MA),

and S, never formed, is solved by Jacobi-preconditioned CG from zero
(:func:`osqp_tpu_torch.ops.cg.pcg_solve`: on the card one launch of
K6's device loop per solve, which computes K5's products itself) to a
relative tolerance of 1e-12 (float64) or 1e-7 (float32),
at most min(4 (n + m), 40000) steps or ``OSQP_TPU_POLISH_CG_CAP``.  The
rows are masked by scaling them (K5's scale kernel), and every product
goes through the linalg dispatch, which is K5 there.  In float32 d is
max(delta, 1e-4): S squares the conditioning of K_delta, and at the
reference delta a float32 S cannot be solved.  A sparse polish runs one
active-set pass by default.

On a row-sharded A (:class:`~osqp_tpu_torch.parallel.rows.RowSharded`,
the entries of :mod:`osqp_tpu_torch.parallel.intra`) no rank holds
K_delta, and A is never gathered.  A dense A takes the JAX package's
Schur branch (``osqp_tpu/polish.py:156-204``): S = P + (MA)'(MA)/d + d I,
its (MA)'(MA) the blocks' products summed by one all-reduce, inverted
by K2's route (:func:`osqp_tpu_torch.ops.spd_inverse.spd_inverse`) at
d = max(delta, 1e-4) in both dtypes, since S squares K_delta's
conditioning and at the reference delta even a float64 inverse of S
loses the polish; the refinement, which targets the unregularized KKT,
recovers the accuracy.  An ELL A runs the PCG above on the sharded
rows, its operator a function of the rows, the all-gather and the
replicated transpose, so on the card K6's step kernels.  Either way a
rank holds its block, the transpose (ELL) and n x n values (dense),
where gathering A would cost it m n values and, for K8, (n + m)^2.

Not carried over from the JAX package, each for its reason: the switch
of unsharded dense operands to the Schur branch above KKT dimension
2048, ``prefer_schur``, which the ``cg`` backend sets, and the rule that
keeps float64 LU off the accelerator.  All three exist because the TPU's
batched-LU call serialises, exceeds its fast memory and has no float64
form; K8 takes any N in both dtypes.

The passes and refinement steps are Python loops that enqueue device
work; only the caller's read of ``success`` waits on the device (the
CG's stop test is the device loop's own).
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple

import torch

from .linalg import bwhere, mat_tvec, mat_vec, vec_dot
from .linsys import kkt_lu
from .ops.cg import EllOperator, pcg_solve
from .ops.ell import ell_diagonal, ell_matvec, ell_products, ell_scale, ell_sq_colsums, ell_tmatvec
from .ops.spd_inverse import spd_inverse
from .ops.term_products import term_products
from .parallel.rows import RowSharded
from .sparse_ops import ELLMatrix
from .termination import compute_products, residual_norms
from .types import DynSettings, QPData, ScalingData, StaticConfig


class PolishResult(NamedTuple):
    success: torch.Tensor  # (B,) bool: residuals improved (polish.c:301-314)
    x: torch.Tensor  # (B, n)
    z: torch.Tensor  # (B, m)
    y: torch.Tensor  # (B, m)
    obj_val: torch.Tensor  # (B,) unscaled
    pri_res: torch.Tensor  # (B,)
    dua_res: torch.Tensor  # (B,)


def _cast_leaf(v, dtype: torch.dtype):
    if isinstance(v, RowSharded):
        return v.to(dtype)
    if isinstance(v, ELLMatrix):
        return dataclasses.replace(v, val=v.val.to(dtype), t_val=v.t_val.to(dtype))
    return v.to(dtype) if v.is_floating_point() else v


def _cast(obj, dtype: torch.dtype):
    """A dataclass of tensors (or ELL operands) with its floating fields
    cast to ``dtype``."""
    return dataclasses.replace(
        obj, **{f.name: _cast_leaf(getattr(obj, f.name), dtype) for f in dataclasses.fields(obj)}
    )


def polish_cg_cap(n: int, m: int) -> int:
    """The step cap of the sparse polish's CG: ``OSQP_TPU_POLISH_CG_CAP``
    where set, else min(4 (n + m), 40000), as in the JAX package (its
    earlier cap of 4000 under-converged DTOC3's reduced KKT).  A traced
    program reads it once, when it is traced, and keeps that cap."""
    return int(os.environ.get("OSQP_TPU_POLISH_CG_CAP", "0")) or min(4 * (n + m), 40_000)


def _ell_kkt_solver(n: int, m: int, P: ELLMatrix, MA, delta, dtype):
    """rhs (B, n+m) -> K_delta^-1 rhs by the Schur complement S, solved
    matrix-free (JAX: polish.py:114-155); MA an :class:`ELLMatrix` or a
    row-sharded one.  Also returns the CG's steps of each solve in a
    list."""
    d = delta if dtype == torch.float64 else torch.clamp(delta.to(dtype), min=1e-4)
    sharded = isinstance(MA, RowSharded)
    B = MA.B if sharded else MA.batch
    ones_m = torch.ones((B, m), dtype=dtype, device=MA.device)
    # column sums over the transpose, which a row-sharded MA keeps whole
    diagP, colsums = ell_products((ell_diagonal, P), (ell_sq_colsums, MA.t if sharded else MA, ones_m))
    dinv = 1.0 / (diagP + d + colsums / d)
    tol_rel = torch.full((B,), 1e-12 if dtype == torch.float64 else 1e-7, dtype=dtype, device=MA.device)
    cap = polish_cg_cap(n, m)

    # (P v, (MA)'((MA) v) / d), rounded as the JAX package's matvec_S: on
    # the card pcg_solve runs it in K6's device loop, or on sharded rows
    # step by step (each step waits on an all-gather)
    products = MA.schur_products(P, d) if sharded else EllOperator(P, MA, div=d)
    steps = []

    def solve(rhs):
        r_x, r_z = rhs[:, :n], rhs[:, n:].contiguous()
        t = (r_x + mat_tvec(MA, r_z) / d) if m else r_x.contiguous()
        sx, k = pcg_solve(products, d, dinv, t.contiguous(), tol_rel, cap)
        steps.append(k)
        snu = (mat_vec(MA, sx) - r_z) / d
        return torch.cat([sx, snu], dim=-1)

    return solve, steps


def _schur_kkt_solver(n: int, m: int, P: torch.Tensor, MA, delta, dtype):
    """rhs (B, n+m) -> K_delta^-1 rhs on dense operands by the Schur
    complement (JAX: polish.py:156-204): S = P + (MA)'(MA)/d + d I with
    d = max(delta, 1e-4), X = S^-1 by K2's route, then sx = X t with t =
    r_x + (MA)' r_z / d and snu = ((MA) sx - r_z) / d.  MA is (B, m, n)
    or row-sharded; its (MA)'(MA) is one ``torch.bmm``, of a row-sharded
    MA the block's and one all-reduce."""
    d = torch.clamp(delta.to(dtype), min=1e-4)
    gram = MA.gram() if isinstance(MA, RowSharded) else torch.bmm(MA.mT, MA)
    eye = torch.eye(n, dtype=dtype, device=P.device)
    X = spd_inverse(P + gram / d + d * eye)

    def solve(rhs):
        r_x, r_z = rhs[:, :n], rhs[:, n:].contiguous()
        t = r_x + mat_tvec(MA, r_z) / d
        sx = torch.bmm(X, t.unsqueeze(-1)).squeeze(-1)
        snu = (mat_vec(MA, sx) - r_z) / d
        return torch.cat([sx, snu], dim=-1)

    return solve


def polish(
    cfg: StaticConfig,
    data: QPData,
    scl: ScalingData,
    dyn: DynSettings,
    x,
    z,
    y,
    admm_pri_res,
    admm_dua_res,
    refine_iter: int,
    passes: int | None = None,
    schur: bool | None = None,
) -> PolishResult:
    """Batched polish (polish.c:212-350).  All inputs scaled.

    Runs up to ``passes`` active-set passes (default ``cfg.polish_passes``)
    where the reference runs one: the set is guessed again at the
    polished point and the system solved again, and the best pass of
    each instance is kept.  Pass 0 is the reference's behaviour and is
    always among the candidates.

    With ``cfg.polish_dtype`` different from the solve dtype (typically
    a float64 polish over a float32 solve) everything is cast, polished
    in that dtype and cast back: float64 is native on the card.

    ``schur`` sends dense operands to the Schur branch
    (:func:`_schur_kkt_solver`) or to K8; by default a row-sharded A
    takes the first, any other the second.
    """
    native = x.dtype
    sharded = isinstance(data.A, RowSharded)
    sparse = data.A.ell if sharded else isinstance(data.A, ELLMatrix)
    if schur is None:
        schur = sharded and not sparse
    if passes is None and sparse:
        # One pass on ELL operands, as in the JAX package: re-guessing has
        # rescued no problem of the sparse path there, and every pass costs
        # a full set of CG solves.
        passes = 1
    if cfg.polish_dtype is not None and getattr(torch, cfg.polish_dtype) != native:
        tgt = getattr(torch, cfg.polish_dtype)
        res = polish(
            dataclasses.replace(cfg, polish_dtype=None),
            _cast(data, tgt), _cast(scl, tgt), _cast(dyn, tgt),
            x.to(tgt), z.to(tgt), y.to(tgt), admm_pri_res.to(tgt), admm_dua_res.to(tgt),
            refine_iter, passes, schur,
        )
        return PolishResult(*(v.to(native) if v.is_floating_point() else v for v in res))
    if passes is None:
        passes = cfg.polish_passes
    B, n = x.shape
    m = cfg.m
    dtype = native
    if not (sparse or schur):
        delta_vec = torch.full((B, m), float(dyn.delta), dtype=dtype, device=x.device)

    def one_pass(x, z, y):
        # Guess the active sets (polish.c:33-49); lower and upper are
        # disjoint, since both would imply u < l.
        lower = z - data.l < -y
        upper = data.u - z < y
        mask = (lower | upper).to(dtype)  # (B, m)

        # K_delta = [P + delta I, (MA)'; MA, -delta I]
        # (qdldl_interface.c:261-267): factored by K8 on dense operands,
        # eliminated to S and solved by CG on ELL ones, whose rows are
        # masked by scaling them, and by S's inverse on row-sharded dense
        # ones.
        if sharded:
            MA = data.A.masked(mask)
        elif sparse:
            MA = ell_scale(data.A, mask, torch.ones((B, n), dtype=dtype, device=x.device))
        else:
            MA = mask[:, :, None] * data.A
        if sparse:
            solve_kkt, _ = _ell_kkt_solver(n, m, data.P, MA, dyn.delta, dtype)
        elif schur:
            solve_kkt = _schur_kkt_solver(n, m, data.P, MA, dyn.delta, dtype)
        else:
            factor = kkt_lu.factor_blocks(data.P, MA, dyn.delta, delta_vec)
            solve_kkt = lambda rhs: kkt_lu.solve_raw(factor, rhs)

        # rhs_red = [-q; l_low, u_upp], masked at fixed shape (polish.c:105-121)
        zero = torch.zeros((), dtype=dtype, device=x.device)
        rhs_z = mask * torch.where(lower, data.l, torch.where(upper, data.u, zero))
        sol = solve_kkt(torch.cat([-data.q, rhs_z], dim=-1))

        def eval_point(sol):
            """Recover (x, z, y), project, and measure the true residuals
            (get_ypol_from_yred polish.c:188-210, project_normalcone
            proj.c:16-29, update_info with polish=1)."""
            x_pol = sol[:, :n].contiguous()
            y_pol = mask * sol[:, n:]
            zy = mat_vec(data.A, x_pol) + y_pol  # polish.c:291
            z_pol = torch.clamp(zy, data.l, data.u)
            y_pol = zy - z_pol
            pr = compute_products(data, x_pol, z_pol, y_pol)
            pri_res, dua_res = residual_norms(cfg, scl, pr)
            finite = (
                torch.isfinite(x_pol).all(-1)
                & torch.isfinite(y_pol).all(-1)
                & torch.isfinite(pri_res)
                & torch.isfinite(dua_res)
            )
            return x_pol, z_pol, y_pol, pri_res, dua_res, finite

        # Iterative refinement against the unregularized KKT
        # (polish.c:134-181), keeping the best step of each instance,
        # step 0 included: where the guessed active rows are dependent
        # the unregularized target is singular and refinement diverges,
        # while the regularized step 0 already has residuals of order
        # delta.
        best = eval_point(sol)
        for _ in range(refine_iter):
            sx, snu = sol[:, :n].contiguous(), sol[:, n:].contiguous()
            if sharded:
                # K3 or K5 on the block, then the collectives
                Ax, Px, Aty = MA.term_products(data.P, sx, snu)[:3]
            elif sparse:
                Px, Aty, Ax = ell_products((ell_matvec, data.P, sx), (ell_tmatvec, MA, snu), (ell_matvec, MA, sx))
            else:
                Ax, Px, Aty = term_products(data.P, MA, sx, snu)[:3]  # MA sx, P sx, (MA)' snu
            r_x = -data.q - (Px + Aty)
            r_z = rhs_z - Ax
            sol = sol + solve_kkt(torch.cat([r_x, r_z], dim=-1))
            cand = eval_point(sol)
            better = cand[5] & (torch.maximum(cand[3], cand[4]) < torch.maximum(best[3], best[4]))
            best = tuple(bwhere(better, c, b) for c, b in zip(cand, best))
        return best

    inf = torch.full((B,), float("inf"), dtype=dtype, device=x.device)
    # The best (x, z, y, pri, dua) so far, and the point the next pass
    # guesses from: the last finite polished point, at first the ADMM point.
    bx, bz, by, bpri, bdua = x, z, y, inf, inf
    cx, cz, cy = x, z, y
    for _ in range(passes):
        px, pz, py, pri, dua, finite = one_pass(cx, cz, cy)
        # A pass that is not finite (singular masked KKT,
        # polish.c:334-339) never wins and is not guessed from.
        better = finite & (torch.maximum(pri, dua) < torch.maximum(bpri, bdua))
        bx, bz, by = bwhere(better, px, bx), bwhere(better, pz, bz), bwhere(better, py, by)
        bpri = torch.where(better, pri, bpri)
        bdua = torch.where(better, dua, bdua)
        cx, cz, cy = bwhere(finite, px, cx), bwhere(finite, pz, cz), bwhere(finite, py, cy)

    obj = scl.cinv * (0.5 * vec_dot(bx, mat_vec(data.P, bx)) + vec_dot(data.q, bx))

    # Acceptance test (polish.c:301-314)
    success = (
        ((bpri < admm_pri_res) & (bdua < admm_dua_res))
        | ((bpri < admm_pri_res) & (admm_dua_res < 1e-10))
        | ((bdua < admm_dua_res) & (admm_pri_res < 1e-10))
    )
    success = success & torch.isfinite(bpri) & torch.isfinite(bdua)
    return PolishResult(success=success, x=bx, z=bz, y=by, obj_val=obj, pri_res=bpri, dua_res=bdua)
