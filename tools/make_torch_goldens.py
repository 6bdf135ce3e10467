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
``chip_smoke.py`` holds the port's Solver against these files; tier-1
tests regenerate one entry of each with :func:`golden` and compare, so
the files cannot go stale.
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


def reference(name: str) -> dict:
    """The optimum to solver accuracy: {obj_val, x} of a float64 solve at
    eps 1e-10."""
    g = golden(name, "float64", eps_abs=1e-10, eps_rel=1e-10, max_iter=100000)
    if int(g["status_val"]) != 1:
        raise RuntimeError(f"{name}: the reference solve ended with status {int(g['status_val'])}")
    return {f: g[f] for f in REFERENCE_FIELDS}


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
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
