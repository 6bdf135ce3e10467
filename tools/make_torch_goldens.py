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
A fourth, ``sparse_polish.npz``, holds the sparse path with polish on
(the device polish: masked ELL operands and the matrix-free PCG): the
JAX ``SparseSolver`` at LISWET1 (float64, float32) and CVXQP2_L
(float64), and ``solve_sparse`` at B = 2 (LISWET1 with q scaled by
1 + 0.1 i, float64): status, iterations, status_polish, objective,
residuals, x and y, under ``<case>/<field>`` with the cases of
POLISH_CASES, and under ``<problem>/<dtype>/host_status_polish`` the
status_polish of the JAX package's B = 1 ``solve_sparse``, which
polishes on the host.
A fifth, ``mpc.npz``, holds the MPC scenario batch of ``bench.py``'s
``bench_mpc`` (nx = 8, nu = 4, horizon 30: n = 372, m = 612, stages of
b = 12): ``solve_batch`` with ``linsys_solver="block_tridiag"`` on its
first 16 scenarios (eps 1e-3, polish off) in float64 and float32, and
the ``Solver`` with the same backend on scenario 0 alone in float64:
status, iterations, objective, x and y under ``<case>/<field>``
(cases of MPC_CASES).
A sixth, ``maros_rows.npz``, holds ``osqp_tpu.maros.run_maros`` over the
corpus rows that it routes to the dense bucketed batch (every row of
``tests/data/maros_mm`` but the large and structurally sparse ones) in
float64 with polish on (eps 1e-3): per row status, iterations,
status_polish, host_polish, fallback, objective (obj_constant folded
in), residuals, x and y, under ``<row>/<field>``.
A seventh, ``families.npz``, holds ``osqp_tpu.benchmarks.run_suite`` on
the default ``generate_suite()`` (dims 10-250, 2 instances, the ten
families) in float64 with polish on: per instance status, iterations,
pass and objective, under ``<instance>/<field>``.
``chip_smoke.py`` holds the port's Solver and solve_sparse against these
files; tier-1 tests regenerate one entry of each with :func:`golden`,
:func:`sparse_golden` or :func:`mpc_golden` and compare, so the files
cannot go stale.

    python3 tools/make_torch_goldens.py            # all seven files
    python3 tools/make_torch_goldens.py sparse     # sparse_maros.npz alone
    python3 tools/make_torch_goldens.py polish mpc # sparse_polish.npz, mpc.npz
    python3 tools/make_torch_goldens.py maros families  # maros_rows.npz, families.npz
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
OUT_POLISH_SPARSE = os.path.join(REPO, "tests", "data", "torch_goldens", "sparse_polish.npz")
# case -> (problem, dtype, entry, instances)
POLISH_CASES = {
    "LISWET1/float64": ("LISWET1", "float64", "SparseSolver", 1),
    "LISWET1/float32": ("LISWET1", "float32", "SparseSolver", 1),
    "CVXQP2_L/float64": ("CVXQP2_L", "float64", "SparseSolver", 1),
    "LISWET1_B2/float64": ("LISWET1", "float64", "solve_sparse", 2),
}
POLISH_SPARSE_FIELDS = SPARSE_FIELDS + ("status_polish", "pri_res", "dua_res")
OUT_MPC = os.path.join(REPO, "tests", "data", "torch_goldens", "mpc.npz")
# bench.py's bench_mpc: B = 1000 scenarios of one MPC problem
MPC_SCENARIOS = 1000
MPC_SETTINGS = dict(eps_abs=1e-3, eps_rel=1e-3, polish=False, verbose=False, linsys_solver="block_tridiag")
# case -> (dtype, entry, scenarios)
MPC_CASES = {
    "MPC16/float64": ("float64", "solve_batch", 16),
    "MPC16/float32": ("float32", "solve_batch", 16),
    "MPC1/float64": ("float64", "Solver", 1),
}
OUT_MAROS = os.path.join(REPO, "tests", "data", "torch_goldens", "maros_rows.npz")
MAROS_FIELDS = ("status_val", "iter", "status_polish", "host_polish", "fallback", "obj", "pri_res", "dua_res",
                "x", "y")
OUT_FAMILIES = os.path.join(REPO, "tests", "data", "torch_goldens", "families.npz")
FAMILY_FIELDS = ("status_val", "iter", "pass", "obj")
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


def polish_golden(case: str) -> dict:
    """One JAX run of ``case`` (a key of POLISH_CASES) with polish on:
    {field: numpy array}, one row per instance.  The caller has put jax
    on the CPU with x64 enabled."""
    import osqp_tpu
    from osqp_tpu.io.qps import load_qps
    from osqp_tpu.large import solve_sparse

    name, dtype, entry, B = POLISH_CASES[case]
    qp = load_qps(os.path.join(MAROS, f"{name}.qps"), native=False)
    if entry == "SparseSolver":
        res = osqp_tpu.SparseSolver(P=qp.P, q=qp.q, A=qp.A, l=qp.l, u=qp.u, dtype=dtype, polish=True,
                                    verbose=False).solve()
        info = res.info
        out = {f: np.asarray([getattr(info, f)]) for f in ("status_val", "iter", "status_polish")}
        out.update({f: np.asarray([getattr(info, f)], np.float64) for f in ("obj_val", "pri_res", "dua_res")})
        out.update(x=np.asarray(res.x, np.float64)[None], y=np.asarray(res.y, np.float64)[None])
    else:
        res = solve_sparse(*scenario_batch(qp, B), dtype=dtype, polish=True, verbose=False)
        out = {f: np.asarray(getattr(res, f)) for f in POLISH_SPARSE_FIELDS}
    return {f: (v.astype(np.int64) if v.dtype.kind in "iu" else v.astype(np.float64)) for f, v in out.items()}


def host_polish_status(name: str, dtype: str) -> int:
    """status_polish of the JAX package's B = 1 solve_sparse, which
    polishes on the host (``polish_host``)."""
    from osqp_tpu.io.qps import load_qps
    from osqp_tpu.large import solve_sparse

    qp = load_qps(os.path.join(MAROS, f"{name}.qps"), native=False)
    res = solve_sparse(qp.P, qp.q, qp.A, qp.l, qp.u, dtype=dtype, polish=True, verbose=False)
    return int(np.asarray(res.status_polish)[0])


def mpc_scenarios(build_mpc_qp, B: int = MPC_SCENARIOS, horizon: int = 30, seed: int = 0):
    """bench.py's MPC scenario batch (bench_mpc): one random stable
    system with nx = 8 states and nu = 4 inputs over ``horizon`` stages,
    built by ``build_mpc_qp`` (either package's), and B initial states.
    Returns (base problem, P, q, A, l, u) with (B, ...) arrays."""
    nx, nu = 8, 4
    rng = np.random.default_rng(seed)
    Ad = np.eye(nx) + 0.05 * rng.standard_normal((nx, nx)) / np.sqrt(nx)
    Bd = rng.standard_normal((nx, nu)) / np.sqrt(nx)
    base = build_mpc_qp(Ad, Bd, np.eye(nx), 0.1 * np.eye(nu), horizon=horizon, xmin=np.full(nx, -10.0),
                        xmax=np.full(nx, 10.0), umin=np.full(nu, -1.0), umax=np.full(nu, 1.0))
    xinits = rng.standard_normal((B, nx))
    l = np.broadcast_to(base.l, (B,) + base.l.shape).copy()
    u = np.broadcast_to(base.u, (B,) + base.u.shape).copy()
    l[:, :nx] = xinits
    u[:, :nx] = xinits
    P = np.broadcast_to(base.P, (B,) + base.P.shape)
    q = np.broadcast_to(base.q, (B,) + base.q.shape)
    A = np.broadcast_to(base.A, (B,) + base.A.shape)
    return base, P, q, A, l, u


def mpc_golden(case: str) -> dict:
    """One JAX run of ``case`` (a key of MPC_CASES) on the first
    scenarios of the MPC batch: {field: numpy array}, one row per
    instance.  The caller has put jax on the CPU with x64 enabled."""
    import osqp_tpu
    from osqp_tpu.batch import solve_batch
    from osqp_tpu.models import build_mpc_qp

    dtype, entry, k = MPC_CASES[case]
    base, P, q, A, l, u = mpc_scenarios(build_mpc_qp)
    kw = dict(MPC_SETTINGS, dtype=dtype, block_size=base.block_size)
    if entry == "solve_batch":
        res = solve_batch(P[:k], q[:k], A[:k], l[:k], u[:k], **kw)
        out = {f: np.asarray(getattr(res, f)) for f in SPARSE_FIELDS}
    else:
        info_res = osqp_tpu.Solver(base.P, base.q, base.A, l[0], u[0], **kw).solve()
        out = {f: np.asarray([getattr(info_res.info, f)]) for f in ("status_val", "iter", "obj_val")}
        out.update(x=np.asarray(info_res.x)[None], y=np.asarray(info_res.y)[None])
    return {f: (v.astype(np.int64) if v.dtype.kind in "iu" else v.astype(np.float64)) for f, v in out.items()}


def dense_maros_paths() -> list:
    """The corpus files whose rows ``run_maros`` routes to the dense
    bucketed batch, in corpus order."""
    from osqp_tpu.io.qps import load_qps
    from osqp_tpu.maros import _route_sparse, collect_paths

    return [p for p in collect_paths([MAROS]) if not _route_sparse(load_qps(p, native=False))]


def maros_rows(paths) -> dict:
    """The JAX package's run_maros over ``paths`` (float64, polish on):
    {row name: {field: numpy array}} for MAROS_FIELDS.  The caller has
    put jax on the CPU with x64 enabled."""
    from osqp_tpu.maros import run_maros

    rows, _ = run_maros(paths, dtype="float64", polish=True, verbose=False, keep_solutions=True)
    out = {}
    for r in rows:
        g = {f: np.int64(int(bool(r.get(f)))) for f in ("host_polish", "fallback")}
        g.update({f: np.int64(r[f]) for f in ("status_val", "iter", "status_polish")})
        g.update({f: np.float64(r[f]) for f in ("obj", "pri_res", "dua_res")})
        g.update(x=np.asarray(r["x"], np.float64), y=np.asarray(r["y"], np.float64))
        out[r["name"]] = g
    return out


def family_rows(**suite) -> dict:
    """The JAX package's run_suite on generate_suite(**suite) (float64,
    polish on): {instance name: {field: numpy array}} for FAMILY_FIELDS.
    The caller has put jax on the CPU with x64 enabled."""
    from osqp_tpu.benchmarks import generate_suite, run_suite

    rows, _ = run_suite(generate_suite(**suite), dtype="float64", polish=True, verbose=False)
    return {r["name"]: {"status_val": np.int64(r["status_val"]), "iter": np.int64(r["iter"]),
                        "pass": np.int64(int(r["pass"])), "obj": np.float64(r["obj"])} for r in rows}


def reference(name: str) -> dict:
    """The optimum to solver accuracy: {obj_val, x} of a float64 solve at
    eps 1e-10."""
    g = golden(name, "float64", eps_abs=1e-10, eps_rel=1e-10, max_iter=100000)
    if int(g["status_val"]) != 1:
        raise RuntimeError(f"{name}: the reference solve ended with status {int(g['status_val'])}")
    return {f: g[f] for f in REFERENCE_FIELDS}


def main() -> int:
    import jax

    targets = {"solver", "sparse", "polish", "mpc", "maros", "families"}
    which = set(sys.argv[1:]) or targets
    if not which <= targets:
        print("usage: make_torch_goldens.py [solver] [sparse] [polish] [mpc] [maros] [families]", file=sys.stderr)
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
    if "polish" in which:
        arrays = {}
        for case in POLISH_CASES:
            g = polish_golden(case)
            print(f"{case}: status {g['status_val'].tolist()}, iterations {g['iter'].tolist()}, status_polish "
                  f"{g['status_polish'].tolist()}, pri_res {g['pri_res'].tolist()}, dua_res {g['dua_res'].tolist()}",
                  flush=True)
            arrays.update({f"{case}/{k}": v for k, v in g.items()})
        for name, dtype, entry, B in POLISH_CASES.values():
            if entry == "SparseSolver":
                st = host_polish_status(name, dtype)
                print(f"{name}/{dtype}: host polish status_polish {st}", flush=True)
                arrays[f"{name}/{dtype}/host_status_polish"] = np.int64(st)
        np.savez_compressed(OUT_POLISH_SPARSE, **arrays)
        print(f"wrote {OUT_POLISH_SPARSE}")
    if "mpc" in which:
        arrays = {}
        for case in MPC_CASES:
            g = mpc_golden(case)
            print(f"{case}: status {g['status_val'].tolist()}, iterations {g['iter'].tolist()}", flush=True)
            arrays.update({f"{case}/{k}": v for k, v in g.items()})
        np.savez_compressed(OUT_MPC, **arrays)
        print(f"wrote {OUT_MPC}")
    if "maros" in which:
        arrays = {}
        for name, g in maros_rows(dense_maros_paths()).items():
            print(f"{name}: status {int(g['status_val'])}, iterations {int(g['iter'])}, status_polish "
                  f"{int(g['status_polish'])}, host_polish {int(g['host_polish'])}, obj {float(g['obj'])!r}",
                  flush=True)
            arrays.update({f"{name}/{k}": v for k, v in g.items()})
        np.savez_compressed(OUT_MAROS, **arrays)
        print(f"wrote {OUT_MAROS}")
    if "families" in which:
        arrays = {}
        for name, g in family_rows().items():
            print(f"{name}: status {int(g['status_val'])}, iterations {int(g['iter'])}, pass {int(g['pass'])}",
                  flush=True)
            arrays.update({f"{name}/{k}": v for k, v in g.items()})
        np.savez_compressed(OUT_FAMILIES, **arrays)
        print(f"wrote {OUT_FAMILIES}")
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
