"""OSQP-paper benchmark families, swept over size and verified.

The reference's headline accuracy benchmark lives in the external
osqp_benchmarks repo / OSQP paper (README.md:42-43, CITATION.cff:19-41):
seven problem classes solved at eps_abs = eps_rel = 1e-3 with polish and
infeasibility detection.  This module regenerates those classes
(Random QP, Equality-constrained QP, Optimal control, Portfolio, Lasso,
Huber fitting, SVM — plus the docs' bounded least-squares), sweeps the
dimension, solves every instance through the batched bucketed harness,
and **verifies each returned solution independently** with the f64 KKT
checker (:mod:`osqp_tpu_torch.verify`) on the original unscaled data — a
solver-external pass criterion, stronger than comparing objectives
against a second solver.  Counterpart of ``osqp_tpu/benchmarks.py``:
the generators are the same numpy code, so a seed gives the same data
bit for bit; the solves run on ``device`` (the CUDA card by default).

Synthetic primal-infeasible and dual-infeasible (unbounded) instances
are included; their certificates are verified algebraically.

CLI: ``python -m osqp_tpu_torch.benchmarks [--dims 10,30,...] [--out FILE]``
(on the card; raises without one).
"""

from __future__ import annotations

import json
import time
import zlib

import numpy as np

from . import constants as con
from .buckets import solve_problems
from .models import (
    build_huber,
    build_lasso,
    build_least_squares,
    build_mpc_qp,
    build_portfolio,
    build_svm,
)
from .verify import (
    dual_infeasibility_check,
    kkt_check,
    primal_infeasibility_check,
)

_SOLVED = (con.OSQP_SOLVED, con.OSQP_SOLVED_INACCURATE)
_PINF = (con.OSQP_PRIMAL_INFEASIBLE, con.OSQP_PRIMAL_INFEASIBLE_INACCURATE)
_DINF = (con.OSQP_DUAL_INFEASIBLE, con.OSQP_DUAL_INFEASIBLE_INACCURATE)


# ---------------------------------------------------------------------------
# Family generators (formulations follow the reference docs/examples/*.rst
# and the OSQP paper's benchmark classes; shapes noted per family)
# ---------------------------------------------------------------------------
def gen_random_qp(n, rng):
    """Strictly convex random QP: m = 2n two-sided constraints."""
    m = 2 * n
    M = rng.standard_normal((n, n)) / np.sqrt(n)
    P = M @ M.T + 0.1 * np.eye(n)
    q = rng.standard_normal(n)
    A = rng.standard_normal((m, n)) / np.sqrt(n)
    x0 = rng.standard_normal(n)
    Ax = A @ x0
    s = np.abs(rng.standard_normal(m)) + 0.1
    return P, q, A, Ax - s, Ax + s


def gen_eq_qp(n, rng):
    """Equality-constrained QP: A x = b with m = n // 2 rows."""
    m = max(n // 2, 1)
    M = rng.standard_normal((n, n)) / np.sqrt(n)
    P = M @ M.T + 0.1 * np.eye(n)
    q = rng.standard_normal(n)
    A = rng.standard_normal((m, n)) / np.sqrt(n)
    b = A @ rng.standard_normal(n)
    return P, q, A, b.copy(), b.copy()


def gen_control(nx, rng):
    """Optimal control (MPC) with nu = nx // 2 inputs, horizon 10."""
    nu = max(nx // 2, 1)
    Ad = np.eye(nx) + 0.05 * rng.standard_normal((nx, nx)) / np.sqrt(nx)
    Bd = rng.standard_normal((nx, nu)) / np.sqrt(nx)
    Q = np.eye(nx)
    R = 0.1 * np.eye(nu)
    xinit = rng.standard_normal(nx)
    p = build_mpc_qp(
        Ad, Bd, Q, R, horizon=10, xinit=xinit,
        xmin=np.full(nx, -10.0), xmax=np.full(nx, 10.0),
        umin=np.full(nu, -1.0), umax=np.full(nu, 1.0),
    )
    return p.P, p.q, p.A, p.l, p.u


def gen_portfolio(n, rng):
    """Markowitz portfolio with k = max(n // 10, 2) factors."""
    k = max(n // 10, 2)
    mu = rng.standard_normal(n)
    F = rng.standard_normal((n, k)) / np.sqrt(k)
    D = np.abs(rng.standard_normal(n)) * np.sqrt(k)
    return build_portfolio(mu, F, D, gamma=1.0)


def _regression_data(n, rng, m_factor=2):
    m = m_factor * n
    Ad = rng.standard_normal((m, n)) / np.sqrt(n)
    x_true = rng.standard_normal(n) * (rng.uniform(size=n) > 0.5)
    b = Ad @ x_true + 0.1 * rng.standard_normal(m)
    return Ad, b


def gen_lasso(n, rng):
    Ad, b = _regression_data(n, rng)
    gamma = 0.1 * np.max(np.abs(Ad.T @ b))
    return build_lasso(Ad, b, gamma)


def gen_huber(n, rng):
    Ad, b = _regression_data(n, rng)
    return build_huber(Ad, b, M=1.0)


def gen_svm(n, rng):
    m = 2 * n
    labels = np.sign(rng.standard_normal(m))
    Ad = rng.standard_normal((m, n)) / np.sqrt(n) + 0.5 * labels[:, None] / n
    return build_svm(Ad, labels, lam=1.0)


def gen_least_squares(n, rng):
    Ad, b = _regression_data(n, rng)
    return build_least_squares(Ad, b, lb=0.0, ub=1.0)


def gen_primal_infeasible(n, rng):
    """Contradictory duplicated row (the reference test's construction,
    primal_infeasibility/generate_problem.py:21-35)."""
    P, q, A, l, u = gen_random_qp(n, rng)
    A = np.vstack([A, A[-1]])
    l = np.concatenate([l, [u[-1] + 1.0]])
    u = np.concatenate([u, [u[-1] + 2.0]])
    return P, q, A, l, u


def gen_dual_infeasible(n, rng):
    """Unbounded below: zero curvature along a ray the constraints
    leave free (P singular, q picks the free direction)."""
    P = np.zeros((n, n))
    P[: n // 2, : n // 2] = np.eye(n // 2)
    q = np.zeros(n)
    q[-1] = 1.0
    m = n
    A = np.zeros((m, n))
    A[:, : n // 2] = rng.standard_normal((m, n // 2)) / np.sqrt(n)
    l = np.full(m, -1.0)
    u = np.full(m, 1.0)
    return P, q, A, l, u


FAMILIES = {
    "random_qp": gen_random_qp,
    "eq_qp": gen_eq_qp,
    "control": gen_control,
    "portfolio": gen_portfolio,
    "lasso": gen_lasso,
    "huber": gen_huber,
    "svm": gen_svm,
    "least_squares": gen_least_squares,
    "primal_infeasible": gen_primal_infeasible,
    "dual_infeasible": gen_dual_infeasible,
}


def stable_seed(*parts) -> int:
    """Process-independent seed (python's hash() is salted per process,
    which would make "seeded" suites unreproducible)."""
    return zlib.crc32("|".join(map(str, parts)).encode())


def generate_suite(dims=(10, 30, 60, 120, 250), instances=2, seed=0,
                   families=None):
    """[(name, family, P, q, A, l, u)] over families x dims x instances."""
    out = []
    names = families or list(FAMILIES)
    for fam in names:
        gen = FAMILIES[fam]
        for n in dims:
            for i in range(instances):
                rng = np.random.default_rng(
                    stable_seed(fam, int(n), int(i), int(seed))
                )
                P, q, A, l, u = gen(int(n), rng)
                out.append((f"{fam}_n{n}_{i}", fam, P, q, A, l, u))
    return out


def run_suite(problems, eps=1e-3, polish=True, max_iter=4000, dtype=None,
              fallback_dtype="float64", verbose=True, device=None):
    """Solve + independently verify a generated suite.

    Pass criteria per instance:
      * feasible families: solver status solved AND f64 KKT residuals of
        the returned (x, y) within the OSQP tolerance formula at the
        ORIGINAL data;
      * primal/dual-infeasible families: matching status AND the
        certificate verifies algebraically.

    Every solve runs on ``device``: the CUDA card by default,
    ``device="cpu"`` for the CPU.
    """
    settings = dict(
        eps_abs=eps, eps_rel=eps, polish=polish, max_iter=max_iter,
        verbose=False,
    )
    if dtype is not None:
        settings["dtype"] = dtype

    t0 = time.perf_counter()
    results = solve_problems(
        [(name, P, q, A, l, u) for (name, fam, P, q, A, l, u) in problems],
        progress=verbose,
        device=device,
        **settings,
    )
    solve_time = time.perf_counter() - t0

    # Batched re-solve of failed instances in the fallback dtype
    # (re-bucketed; wall-clock scales with buckets, not failures).
    # "Failed" = anything short of a STRICT status: inaccurate variants
    # and max_iter count as misses against the eps criterion.
    strict = (con.OSQP_SOLVED, con.OSQP_PRIMAL_INFEASIBLE,
              con.OSQP_DUAL_INFEASIBLE)
    if fallback_dtype is not None:
        retry_idx = [i for i, r in enumerate(results)
                     if r.status_val not in strict]
        if retry_idx:
            fb = dict(settings)
            fb["dtype"] = fallback_dtype
            fb_res = solve_problems(
                [(problems[i][0],) + tuple(problems[i][2:])
                 for i in retry_idx],
                device=device,
                **fb,
            )
            for i, r in zip(retry_idx, fb_res):
                results[i] = r

    rows = []
    for (name, fam, P, q, A, l, u), r in zip(problems, results):
        row = dict(
            name=name, family=fam, n=r.n, m=r.m,
            status=con.STATUS_MESSAGE.get(r.status_val, "?"),
            status_val=r.status_val, iter=r.iter, obj=r.obj_val,
        )
        if fam == "primal_infeasible":
            ok = r.status_val in _PINF and r.prim_inf_cert is not None
            if ok:
                chk = primal_infeasibility_check(A, l, u, r.prim_inf_cert)
                row["verify"] = {k: (bool(v) if k == "ok" else float(v))
                                 for k, v in chk.items()}
                ok = chk["ok"]
            else:
                row["verify"] = dict(ok=False)
            row["pass"] = bool(ok)
        elif fam == "dual_infeasible":
            ok = r.status_val in _DINF and r.dual_inf_cert is not None
            if ok:
                chk = dual_infeasibility_check(P, q, A, l, u, r.dual_inf_cert)
                row["verify"] = {k: (bool(v) if k == "ok" else float(v))
                                 for k, v in chk.items()}
                ok = chk["ok"]
            else:
                row["verify"] = dict(ok=False)
            row["pass"] = bool(ok)
        else:
            if r.status_val in _SOLVED:
                chk = kkt_check(P, q, A, l, u, r.x, r.y,
                                eps_abs=eps, eps_rel=eps)
                row["verify"] = {k: (bool(v) if k == "ok" else float(v))
                                 for k, v in chk.items()}
                row["pass"] = bool(chk["ok"])
            else:
                row["verify"] = dict(ok=False)
                row["pass"] = False
        rows.append(row)

    npass = sum(r["pass"] for r in rows)
    summary = dict(
        problems=len(rows),
        passed=npass,
        pass_rate=npass / max(len(rows), 1),
        solve_time=solve_time,
        eps=eps,
    )
    if verbose:
        for r in rows:
            v = r.get("verify", {})
            extra = (
                f" kkt_pri={v.get('pri_res', float('nan')):.2e}"
                f" kkt_dua={v.get('dua_res', float('nan')):.2e}"
                if "pri_res" in v else ""
            )
            print(
                f"{r['name']:<26} n={r['n']:<5} m={r['m']:<6} "
                f"{r['status']:<28} iter={r['iter']:<5} "
                f"{'PASS' if r['pass'] else 'FAIL'}{extra}"
            )
        print(json.dumps(summary))
    return rows, summary


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dims", default="10,30,60,120,250")
    ap.add_argument("--instances", type=int, default=2)
    ap.add_argument("--eps", type=float, default=1e-3)
    ap.add_argument("--dtype", default=None)
    ap.add_argument("--no-polish", action="store_true")
    ap.add_argument("--families", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    dims = [int(d) for d in args.dims.split(",")]
    fams = args.families.split(",") if args.families else None
    problems = generate_suite(dims=dims, instances=args.instances,
                              families=fams)
    rows, summary = run_suite(
        problems, eps=args.eps, polish=not args.no_polish, dtype=args.dtype,
    )
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(summary=summary, rows=rows), f, indent=1)
    return 0 if summary["pass_rate"] == 1.0 else 2


if __name__ == "__main__":
    import sys

    sys.exit(main())
