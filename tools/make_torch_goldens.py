#!/usr/bin/env python3
"""Write the JAX package's Solver results at two Maros-Meszaros problems,
for checking osqp_tpu_torch where JAX is not installed.

    python3 tools/make_torch_goldens.py

Runs ``osqp_tpu.Solver`` on the CPU with x64 enabled at CVXQP2_S
(n=100, m=125) and CVXQP2_M (n=1000, m=1250), each in float64 and
float32, with default settings (eps 1e-3), once with polish off and once
with polish on.  Writes status, iterations, rho updates, objective, x
and y of each solve to ``tests/data/torch_goldens/solver_maros.npz``
(polish off) and, with ``status_polish`` and the residuals added, to
``solver_maros_polish.npz`` (polish on), under keys
``<problem>/<dtype>/<field>``.  At CVXQP2_M (KKT dimension 2250) the JAX
package polishes through its Schur route at delta 1e-4, not through LU,
and that polish is rejected: x and y there are the ADMM point.  So the
polish file also holds, under ``<problem>/reference/<field>``, the
objective and x of a float64 solve at eps 1e-10 with polish off, which a
polished point can be held against (y is not: these problems' duals are
not unique).
A third file, ``sparse_maros.npz``, holds ``osqp_tpu.large.solve_sparse``
with polish off (the sparse path: ELL operands and the cg backend) at
CVXQP2_L in float64, LISWET1 in float64 and float32, and a scenario
batch of 8 copies of LISWET1 with q scaled by 1 + 0.1 i in float64:
status, iterations, objective, x and y per instance, under keys
``<case>/<field>`` with the cases of SPARSE_CASES.
``chip_smoke.py`` holds the port's Solver and solve_sparse against these
files; tier-1 tests regenerate one entry of each with :func:`golden` or
:func:`sparse_golden` and compare, so the files cannot go stale.

    python3 tools/make_torch_goldens.py            # all three files
    python3 tools/make_torch_goldens.py sparse     # sparse_maros.npz alone
"""

from __future__ import annotations

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAROS = os.path.join(REPO, "tests", "data", "maros_mm")
OUT = os.path.join(REPO, "tests", "data", "torch_goldens", "solver_maros.npz")
PROBLEMS = ("CVXQP2_S", "CVXQP2_M")
DTYPES = ("float64", "float32")
OUT_POLISH = os.path.join(REPO, "tests", "data", "torch_goldens", "solver_maros_polish.npz")
FIELDS = ("status_val", "iter", "rho_updates", "obj_val", "x", "y")
POLISH_FIELDS = FIELDS + ("status_polish", "pri_res", "dua_res")
REFERENCE_FIELDS = ("obj_val", "x")
OUT_SPARSE = os.path.join(REPO, "tests", "data", "torch_goldens", "sparse_maros.npz")
# case -> (problem, dtype, instances)
SPARSE_CASES = {
    "CVXQP2_L/float64": ("CVXQP2_L", "float64", 1),
    "LISWET1/float64": ("LISWET1", "float64", 1),
    "LISWET1/float32": ("LISWET1", "float32", 1),
    "LISWET1_B8/float64": ("LISWET1", "float64", 8),
}
SPARSE_FIELDS = ("status_val", "iter", "obj_val", "x", "y")
sys.path.insert(0, REPO)


def golden(name: str, dtype: str, polish: bool = False, **settings) -> dict:
    """One JAX Solver run: {field: numpy array} for FIELDS, or for
    POLISH_FIELDS with ``polish``.  The caller has put jax on the CPU
    with x64 enabled."""
    import osqp_tpu
    from osqp_tpu.io.qps import load_qps

    qp = load_qps(os.path.join(MAROS, f"{name}.qps"), native=False)
    s = osqp_tpu.Solver(P=qp.P, q=qp.q, A=qp.A, l=qp.l, u=qp.u, dtype=dtype, polish=polish, verbose=False,
                        **settings)
    res = s.solve()
    info = res.info
    out = {
        "status_val": np.int64(info.status_val),
        "iter": np.int64(info.iter),
        "rho_updates": np.int64(info.rho_updates),
        "obj_val": np.float64(info.obj_val),
        "x": np.asarray(res.x, np.float64),
        "y": np.asarray(res.y, np.float64),
    }
    if polish:
        out.update(status_polish=np.int64(info.status_polish), pri_res=np.float64(info.pri_res),
                   dua_res=np.float64(info.dua_res))
    return out


def scenario_batch(qp, B: int):
    """(P, q, A, l, u) of B instances of ``qp`` (an object with P, q, A,
    l, u) sharing P and A, with q scaled by 1 + 0.1 i."""
    q = np.stack([np.asarray(qp.q) * (1.0 + 0.1 * i) for i in range(B)])
    return qp.P, q, qp.A, np.tile(qp.l, (B, 1)), np.tile(qp.u, (B, 1))


def sparse_golden(case: str) -> dict:
    """One JAX solve_sparse run of ``case`` (a key of SPARSE_CASES), polish
    off: {field: numpy array}, one row per instance.  The caller has put
    jax on the CPU with x64 enabled."""
    from osqp_tpu.io.qps import load_qps
    from osqp_tpu.large import solve_sparse

    name, dtype, B = SPARSE_CASES[case]
    qp = load_qps(os.path.join(MAROS, f"{name}.qps"), native=False)
    res = solve_sparse(*scenario_batch(qp, B), dtype=dtype, polish=False, verbose=False)
    return {
        "status_val": np.asarray(res.status_val, np.int64),
        "iter": np.asarray(res.iter, np.int64),
        "obj_val": np.asarray(res.obj_val, np.float64),
        "x": np.asarray(res.x, np.float64),
        "y": np.asarray(res.y, np.float64),
    }


def reference(name: str) -> dict:
    """The optimum to solver accuracy: {obj_val, x} of a float64 solve at
    eps 1e-10."""
    g = golden(name, "float64", eps_abs=1e-10, eps_rel=1e-10, max_iter=100000)
    if int(g["status_val"]) != 1:
        raise RuntimeError(f"{name}: the reference solve ended with status {int(g['status_val'])}")
    return {f: g[f] for f in REFERENCE_FIELDS}


def main() -> int:
    import jax

    which = set(sys.argv[1:]) or {"solver", "sparse"}
    if not which <= {"solver", "sparse"}:
        print("usage: make_torch_goldens.py [solver] [sparse]", file=sys.stderr)
        return 2
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    if "sparse" in which:
        arrays = {}
        for case in SPARSE_CASES:
            g = sparse_golden(case)
            print(f"{case}: status {g['status_val'].tolist()}, iterations {g['iter'].tolist()}, "
                  f"obj {g['obj_val'].tolist()}", flush=True)
            arrays.update({f"{case}/{k}": v for k, v in g.items()})
        np.savez_compressed(OUT_SPARSE, **arrays)
        print(f"wrote {OUT_SPARSE}")
    if "solver" not in which:
        return 0
    for polish, out in ((False, OUT), (True, OUT_POLISH)):
        arrays = {}
        for name in PROBLEMS:
            for dtype in DTYPES:
                g = golden(name, dtype, polish)
                print(f"{name} {dtype} polish={polish}: status {int(g['status_val'])}, {int(g['iter'])} iterations, "
                      f"{int(g['rho_updates'])} rho updates, obj {float(g['obj_val'])!r}"
                      + (f", status_polish {int(g['status_polish'])}, pri_res {float(g['pri_res']):.3e}, "
                         f"dua_res {float(g['dua_res']):.3e}" if polish else ""), flush=True)
                arrays.update({f"{name}/{dtype}/{k}": v for k, v in g.items()})
        if polish:
            for name in PROBLEMS:
                r = reference(name)
                print(f"{name} reference: obj {float(r['obj_val'])!r}", flush=True)
                arrays.update({f"{name}/reference/{k}": v for k, v in r.items()})
        np.savez_compressed(out, **arrays)
        print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
