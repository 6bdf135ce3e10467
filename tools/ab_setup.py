#!/usr/bin/env python3
"""Compare checkouts of osqp_tpu_torch on the Solver's set-up at CVXQP2_M, in turns, on one GPU.

    python3 tools/ab_setup.py ROOT [ROOT ...]

Each ROOT is the root of a checkout (for example the parent commit
unpacked with ``git archive`` and this tree: ``old . . old``, so that
drift on the card falls on both sides).  Each runs in a process of its
own, which builds that checkout's kernels, loads CVXQP2_M (n = 1000, m =
1250) from ``tests/data/maros_mm`` and, in float64 and float32, at the
defaults (``dense_inv``, polish off): builds one ``Solver`` to warm up,
then times ``REPS`` more set-ups by the host's clock with the card
synchronised before and after each (the set-up reads the data, scales
it, and inverts the reduced matrix through K2's route), and solves
``SOLVES`` fresh Solvers (status, iterations, rho updates, objective and
``info.solve_time``, which holds the refactorizations of the rho
updates).  K2's leaf launches per set-up are read from the checkout's
counts (null where it has none).  Prints the card, then one JSON line
per checkout.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

CHILD = r"""
import json, os, statistics, sys, time, torch
root = sys.argv[1]
sys.path.insert(0, root)
import osqp_tpu_torch as ot
from osqp_tpu_torch.io.qps import load_qps
from osqp_tpu_torch.ops import spd_inverse as k2

REPS, SOLVES = 10, 3
qp = load_qps(os.path.join(root, "tests", "data", "maros_mm", "CVXQP2_M.qps"))
out = {"root": root}
for dtype in ("float64", "float32"):
    make = lambda: ot.Solver(qp.P, qp.q, qp.A, qp.l, qp.u, dtype=dtype, verbose=False)
    make()
    torch.cuda.synchronize()
    counts = lambda: tuple(getattr(k2, c, None) for c in ("launches_leaf", "launches_leaf_cluster"))
    before = counts()
    times = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        make()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    after = counts()
    leaves = [None if a is None else (a - b) / REPS for a, b in zip(after, before)]
    runs = []
    for _ in range(SOLVES):
        r = make().solve()
        runs.append(dict(status=r.info.status, iter=r.info.iter, rho_updates=r.info.rho_updates,
                         obj=r.info.obj_val, solve_ms=r.info.solve_time * 1e3))
    out[dtype] = dict(setup_median_ms=statistics.median(times), setup_ms=times, leaves_per_setup=leaves[0],
                      cluster_leaves_per_setup=leaves[1], solves=runs)
print(json.dumps(out))
"""


def main() -> int:
    roots = sys.argv[1:]
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    for root in roots:
        proc = subprocess.run([sys.executable, "-c", CHILD, os.path.abspath(root)], capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr, file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
