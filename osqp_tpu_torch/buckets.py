"""Heterogeneous-shape QP batching by shape-bucketed padding (counterpart
of ``osqp_tpu/buckets.py``).

A batched solve takes B problems of one shape, so QPs of different
(n, m) cannot share one directly.  This module rounds shapes up to
buckets (powers of two, then multiples of 512), embeds each QP in the
padded shape, solves each bucket as one :func:`osqp_tpu_torch.solve_batch`
on the device, and scatters the results back.

The padding is *exact*, not approximate:

* extra variables get P = I, q = 0 and appear in no constraint row, so
  their optimum is exactly 0 with zero objective/residual contribution;
* extra constraint rows are all-zero with (-inf, +inf) bounds, which the
  rho classifier treats as loose (auxil.c:82-86) and whose residuals are
  identically zero.

Note: padding changes Ruiz scaling slightly (the cost scalar averages
over padded columns), so iteration counts may differ from an unpadded
solve — solutions agree within tolerances.
"""

from __future__ import annotations

import contextlib
import sys
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np
import scipy.sparse as sp
import torch

from .batch import solve_batch
from .constants import (
    OSQP_DUAL_INFEASIBLE,
    OSQP_DUAL_INFEASIBLE_INACCURATE,
    OSQP_INFTY,
    OSQP_PRIMAL_INFEASIBLE,
    OSQP_PRIMAL_INFEASIBLE_INACCURATE,
)
from .solver import resolve_device, torch_dtype
from .sparse import to_upper_csc, triu_to_full


def fallback_context(dtype_str):
    """A context that changes nothing, kept for the JAX package's callers.

    There it enables x64 and moves a float64 re-solve to the CPU backend,
    because the TPU has no native float64.  The card computes float64
    natively, so a fallback re-solve runs where the first solve ran, in
    the dtype it names (ROADMAP, "Not ported": ``fallback_context``'s CPU
    route)."""
    return contextlib.nullcontext()


def _next_bucket(v: int, minimum: int = 8) -> int:
    """Powers of two up to 1024, then multiples of 512: doubling a
    n=4224 problem to 8192 wastes ~2x memory and ~4-8x factor FLOPs at
    sizes where both actually matter; fine steps cost only an extra
    solve for shapes that are rare to begin with."""
    b = minimum
    while b < v and b < 1024:
        b *= 2
    if b >= v:
        return b
    return -(-v // 512) * 512


# Device bytes budgeted for one bucket chunk: a quarter of the card's
# memory (the JAX package's 4e9 is a quarter of a 16 GB TPU v5e); on the
# CPU the JAX package's 4e9.
_HBM_BUDGET = float(4e9)


def _max_chunk(N: int, M: int, dtype_bytes: int = 4, total_memory: float | None = None) -> int:
    """Instances of a padded (N, M) QP per solve: the per-instance dense
    footprint, P + Minv (N^2 each), A + A Minv' + scaled copies (~4 N M)
    and transient factor/polish temporaries of the same order, in the
    solve dtype's bytes, within a quarter of ``total_memory`` (the JAX
    package's 4e9 when None)."""
    budget = _HBM_BUDGET if total_memory is None else 0.25 * float(total_memory)
    per = (3 * N * N + 5 * N * M) * dtype_bytes
    return max(1, int(budget / max(per, 1)))


def _device_memory(device) -> float | None:
    """Total bytes of a CUDA ``device``; None for the CPU."""
    if device.type != "cuda":
        return None
    return float(torch.cuda.get_device_properties(device).total_memory)


@dataclass
class ProblemResult:
    name: str
    status_val: int
    iter: int
    obj_val: float
    pri_res: float
    dua_res: float
    x: np.ndarray
    y: np.ndarray
    n: int
    m: int
    prim_inf_cert: np.ndarray | None = None  # set on primal-infeasible exits
    dual_inf_cert: np.ndarray | None = None  # set on dual-infeasible exits
    status_polish: int = 0  # polish.c outcome: 0 not run, 1 success, -1 failed
    bucket: tuple[int, int, int] | None = None  # (N, M, B) of the solve that took it
    seconds: float = float("nan")  # wall time of that solve, results on the host


def pad_problem(P, q, A, l, u, N: int, M: int):
    """Embed an (n, m) dense QP into padded (N, M) arrays."""
    n, m = q.shape[0], l.shape[0]
    Pp = np.eye(N)
    Pp[:n, :n] = P
    qp_ = np.zeros(N)
    qp_[:n] = q
    Ap = np.zeros((M, N))
    Ap[:m, :n] = A
    lp = np.full(M, -OSQP_INFTY)
    up = np.full(M, OSQP_INFTY)
    lp[:m] = np.clip(l, -OSQP_INFTY, OSQP_INFTY)
    up[:m] = np.clip(u, -OSQP_INFTY, OSQP_INFTY)
    return Pp, qp_, Ap, lp, up


def solve_problems(
    problems: Sequence[tuple[str, Any, Any, Any, Any, Any]],
    progress: bool = False,
    device=None,
    **settings,
) -> list[ProblemResult]:
    """Solve a list of (name, P, q, A, l, u) QPs of arbitrary shapes.

    P may be scipy sparse upper-triangular or dense symmetric; A scipy
    sparse or dense.  Problems are grouped into shape buckets; each
    bucket chunk is one batched solve on ``device`` (the CUDA card by
    default; ``device="cpu"`` for the CPU).  Returns results in input
    order.  ``progress`` prints one stderr line per chunk.
    """
    device = resolve_device(device)
    dtype_bytes = torch.finfo(torch_dtype(settings.get("dtype"))).bits // 8
    total_memory = _device_memory(device)

    prepared = []
    for idx, (name, P, q, A, l, u) in enumerate(problems):
        q = np.asarray(q, np.float64).ravel()
        n = q.shape[0]
        Pd = triu_to_full(to_upper_csc(P, n))
        Ad = np.asarray(A.todense(), np.float64) if sp.issparse(A) else np.asarray(A, np.float64)
        l = np.asarray(l, np.float64).ravel()
        u = np.asarray(u, np.float64).ravel()
        prepared.append((idx, name, Pd, q, Ad, l, u))

    buckets: dict[tuple[int, int], list] = defaultdict(list)
    for item in prepared:
        _, _, Pd, q, Ad, l, u = item
        key = (_next_bucket(q.shape[0]), _next_bucket(max(l.shape[0], 1)))
        buckets[key].append(item)

    results: list[ProblemResult | None] = [None] * len(prepared)
    for (N, M), all_items in buckets.items():
        chunk = _max_chunk(N, M, dtype_bytes, total_memory)
        chunks = [all_items[i : i + chunk] for i in range(0, len(all_items), chunk)]
        for ci, items in enumerate(chunks):
            if progress:
                print(f"[buckets] ({N}, {M}) chunk {ci + 1}/{len(chunks)} B={len(items)} ...",
                      file=sys.stderr, flush=True)
            _solve_bucket(N, M, items, results, settings, device)
            if progress:
                print(f"[buckets] ({N}, {M}) chunk {ci + 1}/{len(chunks)} done in "
                      f"{results[items[0][0]].seconds:.1f}s", file=sys.stderr, flush=True)
    return results  # type: ignore[return-value]


def _solve_bucket(N, M, items, results, settings, device):
    """One batched solve of a (memory-capped) bucket chunk on ``device``;
    scatters ProblemResults into ``results`` at the items' indices."""
    t0 = time.perf_counter()
    padded = [pad_problem(Pd, q, Ad, l, u, N, M) for _, _, Pd, q, Ad, l, u in items]
    res = solve_batch(*(np.stack(parts) for parts in zip(*padded)), device=device, **settings)
    host = lambda t: t.cpu().numpy()  # noqa: E731
    x, y = host(res.x), host(res.y)
    sv, it, spol = host(res.status_val), host(res.iter), host(res.status_polish)
    obj, pri, dua = host(res.obj_val), host(res.pri_res), host(res.dua_res)
    pic, dic = host(res.prim_inf_cert), host(res.dual_inf_cert)
    seconds = time.perf_counter() - t0
    _PINF = (OSQP_PRIMAL_INFEASIBLE, OSQP_PRIMAL_INFEASIBLE_INACCURATE)
    _DINF = (OSQP_DUAL_INFEASIBLE, OSQP_DUAL_INFEASIBLE_INACCURATE)
    for b, (idx, name, Pd, q, Ad, l, u) in enumerate(items):
        n, m = q.shape[0], l.shape[0]
        results[idx] = ProblemResult(
            name=name,
            status_val=int(sv[b]),
            iter=int(it[b]),
            obj_val=float(obj[b]),
            pri_res=float(pri[b]),
            dua_res=float(dua[b]),
            x=x[b, :n],
            y=y[b, :m],
            n=n,
            m=m,
            prim_inf_cert=pic[b, :m] if int(sv[b]) in _PINF else None,
            dual_inf_cert=dic[b, :n] if int(sv[b]) in _DINF else None,
            status_polish=int(spol[b]),
            bucket=(N, M, len(items)),
            seconds=seconds,
        )
