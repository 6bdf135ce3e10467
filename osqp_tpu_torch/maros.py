"""Maros-Meszaros benchmark harness (counterpart of ``osqp_tpu/maros.py``).

The reference defers its accuracy benchmark to the external
osqp_benchmarks repo (README.md:42-43); this harness plays that role:
parse QPS files, solve each at eps_abs = eps_rel = 1e-3 (reference
defaults) with polish and infeasibility detection, and report the pass
rate.

Usage:
    python -m osqp_tpu_torch.maros DIR_OR_FILES... [--eps 1e-3] [--no-polish]
        [--single] [--shard i/k] [--max-iter 4000] [--dtype float64]
        [--fallback-dtype float64]

The CLI runs on the CUDA card, as every entry point of the package does,
and raises without one; :func:`run_maros` takes ``device="cpu"`` for the
CPU.  ``--shard i/k`` partitions the problem list across k hosts (sorted
by size, round-robin).  ``--single`` solves one by one through
:class:`osqp_tpu_torch.Solver`; by default same-bucket problems share one
batched solve (:func:`osqp_tpu_torch.buckets.solve_problems`).  Problems
that are large or structurally sparse go through
:func:`osqp_tpu_torch.solve_sparse` in float64 and polish on the device.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

import scipy.sparse as sp

from . import constants as con
from .buckets import solve_problems
from .io.qps import load_qps
from .solver import resolve_device, torch_dtype


def collect_paths(args_paths):
    paths = []
    for p in args_paths:
        if os.path.isdir(p):
            paths += sorted(
                glob.glob(os.path.join(p, "*.qps"))
                + glob.glob(os.path.join(p, "*.QPS"))
                + glob.glob(os.path.join(p, "*.qps.gz"))
            )
        else:
            paths.append(p)
    return paths


# Problems whose n or m exceeds this go through solve_sparse (ELL
# operands, cg) instead of the dense bucketed batch: the dense embedding
# is wasteful past a few thousand and impossible at 1e4+.
SPARSE_N_CUTOFF = 4096
# Mid-size problems that are STRUCTURALLY sparse also route through the
# sparse path above this size (AUG3D: the dense embedding wastes memory
# and its diagonal P with zero weights on boundary faces is hostile to a
# dense float32 factor).
SPARSE_MIN_N = 2048
SPARSE_DENSITY = 5e-3


# Strict terminal statuses: a definitive answer at full accuracy.
_STRICT_FINAL = (
    con.OSQP_SOLVED,
    con.OSQP_PRIMAL_INFEASIBLE,
    con.OSQP_DUAL_INFEASIBLE,
)


def _row_rank(status_val, status_polish):
    """Orders outcomes so a fallback retry can never DEMOTE a row:
    strict statuses and certificates above inaccurate, above non-final;
    polish success breaks ties.  On equal rank the retry wins — the f64
    trajectory is the one that matches the reference oracle's iteration
    counts (PARITY.md)."""
    if status_val in _STRICT_FINAL:
        s = 2
    elif status_val in (
        con.OSQP_SOLVED_INACCURATE,
        con.OSQP_PRIMAL_INFEASIBLE_INACCURATE,
        con.OSQP_DUAL_INFEASIBLE_INACCURATE,
    ):
        s = 1
    else:
        s = 0
    return (s, 1 if status_polish == 1 else 0)


def _retry_replaces(row, status_val, status_polish) -> bool:
    """Whether a fallback retry with this outcome replaces ``row``.

    Never a lower :func:`_row_rank`.  A row that was escalated only for a
    failed polish (it was strictly solved) is replaced only by a retry
    that is solved too: ``_row_rank`` ranks certificates equal to solved,
    and a tie goes to the retry, so without this a solved row could turn
    infeasible (the JAX package's ``maros.py:350-356`` lets it)."""
    if row["status_val"] == con.OSQP_SOLVED and status_val != con.OSQP_SOLVED:
        return False
    return _row_rank(status_val, status_polish) >= _row_rank(row["status_val"], row.get("status_polish"))


def _dtype_name(d) -> str:
    """'float32' or 'float64' for a name, a numpy or a torch dtype."""
    return str(torch_dtype(d)).removeprefix("torch.")


def _route_sparse(qp) -> bool:
    if max(qp.n, qp.m) > SPARSE_N_CUTOFF:
        return True
    if max(qp.n, qp.m) <= SPARSE_MIN_N:
        return False
    nnz = sp.csc_matrix(qp.P).nnz + sp.csc_matrix(qp.A).nnz
    return nnz <= SPARSE_DENSITY * (qp.n * qp.n + qp.m * qp.n)


def _solve_one_sparse(qp, settings, device=None):
    """One large problem through the never-densifying path, in float64
    (the cg backend's subproblem accuracy bounds the trajectory: CVXQP1_L
    needs ~1e-8-relative KKT solves to follow the reference's
    650-iteration one), with polish, when on, on the device: the
    matrix-free reduced-KKT PCG of :mod:`osqp_tpu_torch.polish`."""
    from .large import solve_sparse

    settings = dict(settings)
    settings["dtype"] = "float64"
    settings.pop("polish_dtype", None)  # same dtype already

    t = time.perf_counter()
    res = solve_sparse(qp.P, qp.q, qp.A, qp.l, qp.u, device=device, **settings)
    host = lambda v: v.cpu().numpy()[0]  # noqa: E731
    sv = int(host(res.status_val))
    return dict(
        name=qp.name,
        n=qp.n,
        m=qp.m,
        status=con.STATUS_MESSAGE.get(sv, "?"),
        status_val=sv,
        iter=int(host(res.iter)),
        obj=float(host(res.obj_val)) + qp.obj_constant,
        pri_res=float(host(res.pri_res)),
        dua_res=float(host(res.dua_res)),
        status_polish=int(host(res.status_polish)),
        time=time.perf_counter() - t,
        sparse=True,
        x=host(res.x),
        y=host(res.y),
    )


def run_maros(
    paths,
    eps: float = 1e-3,
    polish: bool = True,
    single: bool = False,
    max_iter: int = 4000,
    dtype=None,
    fallback_dtype=None,
    shard: tuple[int, int] | None = None,
    verbose: bool = True,
    keep_solutions: bool = False,
    cg_max_iter: int = 0,
    polish_dtype=None,
    device=None,
):
    """Solve a QPS file list; returns (per-problem rows, summary).

    ``fallback_dtype``: problems that fail to solve in the primary dtype
    (``dtype``, else the :class:`~osqp_tpu_torch.Settings` default) are
    retried in this dtype, re-bucketed as batches; the row gains
    ``fallback=True``.  Dense rows whose device polish failed are polished
    again on the host (:func:`osqp_tpu_torch.polish_host.polish_host`);
    the row gains ``host_polish=True``.  Every first solve runs on
    ``device`` (the CUDA card by default; ``device="cpu"`` for the CPU),
    and so do the retries.
    """
    device = resolve_device(device)
    problems = []
    for p in paths:
        qp = load_qps(p)
        problems.append(qp)

    if shard is not None:
        i, k = shard
        order = sorted(range(len(problems)), key=lambda j: -problems[j].n)
        keep = set(order[i::k])
        problems = [p for j, p in enumerate(problems) if j in keep]

    settings = dict(
        eps_abs=eps,
        eps_rel=eps,
        polish=polish,
        max_iter=max_iter,
        verbose=False,
    )
    if polish_dtype is not None:
        # precision-upgraded polish (f64 over an f32 solve), polish.polish
        settings["polish_dtype"] = polish_dtype
    if dtype is not None:
        settings["dtype"] = dtype
    if cg_max_iter:
        # bounds the cg backend's inner loop
        settings["cg_max_iter"] = int(cg_max_iter)

    t0 = time.perf_counter()
    rows = []
    if single:
        from .solver import Solver

        for qp in problems:
            if _route_sparse(qp):
                # densifying these would be multi-GB; same routing as
                # the batched branch
                rows.append(_solve_one_sparse(qp, settings, device))
                continue
            t = time.perf_counter()
            s = Solver(P=qp.P, q=qp.q, A=qp.A, l=qp.l, u=qp.u, device=device, **settings)
            r = s.solve()
            rows.append(
                dict(
                    name=qp.name,
                    n=qp.n,
                    m=qp.m,
                    status=r.info.status,
                    status_val=r.info.status_val,
                    iter=r.info.iter,
                    obj=r.info.obj_val + qp.obj_constant,
                    pri_res=r.info.pri_res,
                    dua_res=r.info.dua_res,
                    status_polish=r.info.status_polish,
                    time=time.perf_counter() - t,
                    x=r.x,
                    y=r.y,
                )
            )
    else:
        # Problems beyond the dense cutoff (and the structurally sparse
        # mid-size ones) route through the never-densifying sparse path;
        # the rest go through the bucketed dense batch.  Rows stay in
        # input order.
        dense_idx = [i for i, qp in enumerate(problems) if not _route_sparse(qp)]
        dense_res = solve_problems(
            [
                (problems[i].name, problems[i].P, problems[i].q,
                 problems[i].A, problems[i].l, problems[i].u)
                for i in dense_idx
            ],
            device=device,
            **settings,
        )
        by_idx = dict(zip(dense_idx, dense_res))
        for i, qp in enumerate(problems):
            if i in by_idx:
                r = by_idx[i]
                rows.append(
                    dict(
                        name=r.name,
                        n=r.n,
                        m=r.m,
                        status=con.STATUS_MESSAGE.get(r.status_val, "?"),
                        status_val=r.status_val,
                        iter=r.iter,
                        obj=r.obj_val + qp.obj_constant,
                        pri_res=r.pri_res,
                        dua_res=r.dua_res,
                        status_polish=r.status_polish,
                        time=r.seconds,
                        bucket=r.bucket,
                        x=r.x,
                        y=r.y,
                    )
                )
            else:
                rows.append(_solve_one_sparse(qp, settings, device))
    # Fallback for problems that failed *numerically*: anything short of
    # a STRICT status (the inaccurate variants miss the eps criterion by
    # definition).  Infeasibility verdicts carry certificates and are
    # final.  A strictly solved dense row whose polish failed escalates
    # too when the fallback dtype differs from the primary one: a float32
    # solve cannot follow the float64 trajectory on stiff equality-heavy
    # problems (the CVXQP class), and the reference polishes every solve
    # (polish.c:212).  Failures are re-bucketed and re-solved as batches.
    if fallback_dtype is not None:
        fb_settings = dict(settings)
        fb_settings["dtype"] = fallback_dtype
        # The effective primary dtype: ``dtype``, else the Settings
        # default.  Polish-failure escalation would only repeat the
        # identical solve when the primary already ran in the fallback
        # dtype; names are compared, so np.float64 equals "float64".
        _polish_escalates = _dtype_name(fallback_dtype) != _dtype_name(dtype)

        def _escalate(r):
            if r["status_val"] not in _STRICT_FINAL:
                return True
            # Dense-path polish failures only: sparse rows already ran
            # at f64 (see _solve_one_sparse), so a retry would repeat
            # the identical solve.
            return (
                _polish_escalates
                and bool(settings.get("polish", True))
                and not r.get("sparse")
                and r["status_val"] == con.OSQP_SOLVED
                and r.get("status_polish") == -1
            )

        retry = [(i, qp) for i, (r, qp) in enumerate(zip(rows, problems)) if _escalate(r)]
        # Large problems retry through the sparse path too (densifying
        # them in the fallback would defeat the routing).
        retry_sp = [t for t in retry if _route_sparse(t[1])]
        retry = [t for t in retry if not _route_sparse(t[1])]
        for i, qp in retry_sp:
            row = _solve_one_sparse(qp, fb_settings, device)
            row["fallback"] = True
            if _retry_replaces(rows[i], row["status_val"], row.get("status_polish")):
                rows[i] = row
        if retry:
            fb_results = solve_problems(
                [(qp.name, qp.P, qp.q, qp.A, qp.l, qp.u) for _, qp in retry],
                device=device,
                **fb_settings,
            )
            for (i, qp), rr in zip(retry, fb_results):
                if not _retry_replaces(rows[i], rr.status_val, rr.status_polish):
                    continue  # the retry came back worse: keep the original row
                rows[i].update(
                    status=con.STATUS_MESSAGE.get(rr.status_val, "?"),
                    status_val=rr.status_val,
                    iter=rr.iter,
                    obj=rr.obj_val + qp.obj_constant,
                    pri_res=rr.pri_res,
                    dua_res=rr.dua_res,
                    status_polish=rr.status_polish,
                    fallback=True,
                    x=rr.x,
                    y=rr.y,
                )

    if polish:
        # Host-exact polish rescue for dense rows whose device polish
        # failed: polish_host is the reference's dynamic-shape reduced KKT
        # at delta = 1e-6 (polish.c:212-350), four passes of an exact
        # sparse LU on the host.  Sparse rows polish on the device and are
        # not rescued.  The rescue runs AFTER the fallback re-solve, not
        # instead of it: the f64 re-solve is what restores the reference
        # oracle's iteration trajectory on the CVXQP class.  Rows pair
        # with problems by position, not by QPS NAME, which need not be
        # unique.
        from .polish_host import polish_host

        for r, qp in zip(rows, problems):
            if (
                r["status_val"] == con.OSQP_SOLVED
                and r.get("status_polish") == -1
                and not r.get("sparse")
                and r.get("x") is not None
            ):
                ok, x_p, y_p, obj, pri, dua = polish_host(
                    qp.P, qp.A, qp.q, qp.l, qp.u, r["x"], r["y"],
                    float(r["pri_res"]), float(r["dua_res"]),
                )
                if ok:
                    r.update(
                        status_polish=1,
                        host_polish=True,
                        obj=obj + qp.obj_constant,
                        pri_res=pri,
                        dua_res=dua,
                        x=x_p,
                        y=y_p,
                    )

    if not keep_solutions:
        for r in rows:
            r.pop("x", None)
            r.pop("y", None)

    total_time = time.perf_counter() - t0

    # "final" = a definitive answer: solved, or a correctly-certified
    # infeasibility status (infeasible instances whose DETECTION is the
    # pass criterion).
    final = (
        con.OSQP_SOLVED,
        con.OSQP_SOLVED_INACCURATE,
        con.OSQP_PRIMAL_INFEASIBLE,
        con.OSQP_PRIMAL_INFEASIBLE_INACCURATE,
        con.OSQP_DUAL_INFEASIBLE,
        con.OSQP_DUAL_INFEASIBLE_INACCURATE,
    )
    solved = sum(1 for r in rows if r["status_val"] in (con.OSQP_SOLVED, con.OSQP_SOLVED_INACCURATE))
    finished = sum(1 for r in rows if r["status_val"] in final)
    summary = dict(
        problems=len(rows),
        solved=solved,
        final=finished,
        pass_rate=finished / max(len(rows), 1),
        # polish observability (src/polish.c outcomes across the corpus)
        polish_success=sum(1 for r in rows if r.get("status_polish") == 1),
        polish_fail=sum(1 for r in rows if r.get("status_polish") == -1),
        total_time=total_time,
    )
    if verbose:
        for r in rows:
            print(
                f"{r['name']:<16} n={r['n']:<6} m={r['m']:<6} "
                f"{r['status']:<28} iter={r['iter']:<5} obj={r['obj']:+.6e} "
                f"pri={r['pri_res']:.2e} dua={r['dua_res']:.2e}"
            )
        print(json.dumps(summary))
    return rows, summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("paths", nargs="+")
    ap.add_argument("--eps", type=float, default=1e-3)
    ap.add_argument("--no-polish", action="store_true")
    ap.add_argument("--single", action="store_true")
    ap.add_argument("--max-iter", type=int, default=4000)
    ap.add_argument("--dtype", default=None)
    ap.add_argument("--fallback-dtype", default=None)
    ap.add_argument("--shard", default=None, help="i/k host shard")
    args = ap.parse_args(argv)

    shard = None
    if args.shard:
        i, k = args.shard.split("/")
        shard = (int(i), int(k))

    paths = collect_paths(args.paths)
    if not paths:
        print("no QPS files found", file=sys.stderr)
        return 1
    _, summary = run_maros(
        paths,
        eps=args.eps,
        polish=not args.no_polish,
        single=args.single,
        max_iter=args.max_iter,
        dtype=args.dtype,
        fallback_dtype=args.fallback_dtype,
        shard=shard,
    )
    return 0 if summary["pass_rate"] == 1.0 else 2


if __name__ == "__main__":
    sys.exit(main())
