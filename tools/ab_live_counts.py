#!/usr/bin/env python3
"""Compare checkouts of osqp_tpu_torch on the live path's launches and host
reads per solve, in turns, on one GPU.

    python3 tools/ab_live_counts.py ROOT [ROOT ...]

Each ROOT is the root of a checkout (for example the parent commit
unpacked with ``git archive`` and this tree: ``old . . old``).  Each runs
in a process of its own, which builds that checkout's kernels, then
solves, once warm and once counted: the headline batch (chip_smoke.py's
data, B=8192, n=100, m=200, float32) through ``solve_batch`` with polish
off and on, CVXQP2_M (n=1000, m=1250) through a fresh ``Solver`` in
float64 with polish on, and on the sparse path ``solve_sparse`` at
CVXQP2_L (n=10000, m=12500) in float64 and at LISWET1 (n=10002,
m=10000) in float64 with polish on.  For each it prints the kernel launches by
wrapper count (chip_smoke.py's ``read_counts``, zeros dropped),
``linalg.host_reads`` and a digest of every output field's bits, so that
two checkouts that give the same launches, reads and digests ran the same
live path.  Prints the card, then one JSON line per checkout.  Imports
nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

CHILD = r"""
import hashlib, json, os, sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
import osqp_tpu_torch as ot
from osqp_tpu_torch import _build, linalg
from osqp_tpu_torch.io.qps import load_qps

_build.library()
dev = torch.device("cuda", 0)


def digest(arrays):
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def counted(fn):
    fn()
    torch.cuda.synchronize()
    cs.reset_counts()
    reads = linalg.host_reads
    out = fn()
    torch.cuda.synchronize()
    return out, {"launches": cs.nonzero(cs.read_counts()), "host_reads": linalg.host_reads - reads}


row = {"root": sys.argv[1]}
B, n, m = cs.HEADLINE["B"], cs.HEADLINE["n"], cs.HEADLINE["m"]
data = cs.on_device(cs.make_qps(B, n, m), torch.float32, dev)
for polish in (False, True):
    res, c = counted(lambda: ot.solve_batch(*data, **dict(cs.SOLVE_KW, polish=polish)))
    c["bits"] = digest(t.cpu().numpy() for t in res)
    row[f"headline_polish_{'on' if polish else 'off'}"] = c
qp = load_qps(os.path.join(cs.MAROS, "CVXQP2_M.qps"))
make = lambda: ot.Solver(qp.P, qp.q, qp.A, qp.l, qp.u, device=dev, dtype="float64", verbose=False, polish=True)
r, c = counted(lambda: make().solve())
c["bits"] = digest([r.x, r.y, np.array([r.info.iter, r.info.status_val, r.info.status_polish]),
                    np.array([r.info.obj_val, r.info.pri_res, r.info.dua_res])])
row["cvxqp2_m_solver_float64_polish"] = c
for name, polish in (("CVXQP2_L", False), ("LISWET1", True)):
    P, q, A, l, u = cs.scenario(name)
    res, c = counted(lambda: ot.solve_sparse(P, q, A, l, u, device=dev, dtype="float64", verbose=False,
                                             polish=polish))
    c["bits"] = digest(t.cpu().numpy() for t in res)
    row[f"{name.lower()}_solve_sparse_float64{'_polish' if polish else ''}"] = c
print(json.dumps(row))
"""


def main() -> int:
    roots = [os.path.abspath(r) for r in sys.argv[1:]]
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    for root in roots:
        env = dict(os.environ, PYTHONPATH=root)
        proc = subprocess.run([sys.executable, "-c", CHILD, root], capture_output=True, text=True, env=env,
                              cwd=root)
        if proc.returncode != 0:
            print(json.dumps({"root": root, "error": proc.stderr[-2000:]}), flush=True)
            return 1
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
