#!/usr/bin/env python3
"""Write the JAX package's Solver results at two Maros-Meszaros problems,
for checking osqp_tpu_torch where JAX is not installed.

    python3 tools/make_torch_goldens.py

Runs ``osqp_tpu.Solver`` on the CPU with x64 enabled at CVXQP2_S
(n=100, m=125) and CVXQP2_M (n=1000, m=1250), each in float64 and
float32, with default settings (eps 1e-3) and polish off.  Writes
status, iterations, rho updates, objective, x and y of each solve to
``tests/data/torch_goldens/solver_maros.npz`` under keys
``<problem>/<dtype>/<field>``.  ``chip_smoke.py`` holds the port's
Solver against this file; a tier-1 test regenerates one entry with
:func:`golden` and compares, so the file cannot go stale.
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
FIELDS = ("status_val", "iter", "rho_updates", "obj_val", "x", "y")
sys.path.insert(0, REPO)


def golden(name: str, dtype: str) -> dict:
    """One JAX Solver run: {field: numpy array} for FIELDS.  The caller
    has put jax on the CPU with x64 enabled."""
    import osqp_tpu
    from osqp_tpu.io.qps import load_qps

    qp = load_qps(os.path.join(MAROS, f"{name}.qps"), native=False)
    s = osqp_tpu.Solver(P=qp.P, q=qp.q, A=qp.A, l=qp.l, u=qp.u, dtype=dtype, polish=False, verbose=False)
    res = s.solve()
    info = res.info
    return {
        "status_val": np.int64(info.status_val),
        "iter": np.int64(info.iter),
        "rho_updates": np.int64(info.rho_updates),
        "obj_val": np.float64(info.obj_val),
        "x": np.asarray(res.x, np.float64),
        "y": np.asarray(res.y, np.float64),
    }


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    arrays = {}
    for name in PROBLEMS:
        for dtype in DTYPES:
            g = golden(name, dtype)
            print(f"{name} {dtype}: status {int(g['status_val'])}, {int(g['iter'])} iterations, "
                  f"{int(g['rho_updates'])} rho updates, obj {float(g['obj_val'])!r}", flush=True)
            arrays.update({f"{name}/{dtype}/{k}": v for k, v in g.items()})
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
