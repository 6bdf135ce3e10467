#!/usr/bin/env python3
"""Compare checkouts of osqp_tpu_torch on the headline shape, in turns, on one GPU.

    python3 tools/ab_headline.py ROOT [ROOT ...]

Each ROOT is the root of a checkout (for example the parent commit
unpacked with ``git archive`` and this tree: ``old . . old``, so that
drift on the card falls on both sides).  Each runs in a process of its
own, which builds that checkout's kernels, then times on chip_smoke.py's
headline data (B=8192, n=100, m=200, float32): K1 (``admm_iter``) with
every instance active, mean of 50 warm calls by CUDA events; K4
(``ruiz``, 10 sweeps) and K2 (``chol_inverse`` of the headline's Schur
matrices), mean of 10 warm calls each; the setup (scaling, rho state and
factor, as chip_smoke.py's headline phase times it), mean of 3;
``solve_batch`` 5 times, median and spread; and the polish leg: K8
(``kkt_lu_factor`` and ``kkt_lu_solve`` on chip_smoke.py's K_delta of the
headline data), mean of 5 warm calls each, and ``solve_batch`` with
``polish=True`` 3 times, median (null for a checkout from before polish
was ported).  Prints the card, then one JSON line per checkout.  Imports
nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

CHILD = r"""
import json, statistics, sys, torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
import osqp_tpu_torch as ot
from osqp_tpu_torch.ops import admm_iter as k1

dev = torch.device("cuda", 0)
B, n, m = cs.HEADLINE["B"], cs.HEADLINE["n"], cs.HEADLINE["m"]
scaled, rs, factor, dyn = cs.path_operands(B, n, m, torch.float32, dev)
x, z, dx, y = cs._random_state(B, n, m, torch.float32, dev)
args = (factor["Minv"], factor["AMinvT"], scaled.A, scaled.q, scaled.l, scaled.u, rs.rho_vec, rs.rho_inv_vec,
        float(dyn.sigma), float(dyn.alpha), torch.ones(B, dtype=torch.bool, device=dev), x, z, y, dx,
        torch.randn_like(z))
k1_ms = cs.cuda_ms(lambda: k1.admm_iter(*args), reps=50)
P, q, A, l, u = cs.on_device(cs.make_qps(B, n, m), torch.float32, dev)
from osqp_tpu_torch import batch, solver
from osqp_tpu_torch.linsys.dense_chol import form_schur
from osqp_tpu_torch.ops import ruiz as k4, spd_inverse as k2
from osqp_tpu_torch.types import DynSettings
k4_ms = cs.cuda_ms(lambda: k4.ruiz(P, q, A, l, u, 10), reps=10)
M = form_schur(scaled.P, scaled.A, dyn.sigma, rs.rho_vec)
k2_ms = cs.cuda_ms(lambda: k2.chol_inverse(M), reps=10)
s = solver.Settings(**cs.SOLVE_KW)
cfg = solver.make_config(n, m, s, torch.float32)
dyn0 = DynSettings.make(torch.float32)
rho0 = torch.full((B,), s.rho, dtype=torch.float32, device=dev)
setup_ms = cs.cuda_ms(lambda: batch._prepare(cfg, s.scaling, P, q, A, l, u, rho0, dyn0, None, None), reps=3, warmup=1)
res = ot.solve_batch(P, q, A, l, u, **cs.SOLVE_KW)
times = []
for _ in range(5):
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    ot.solve_batch(P, q, A, l, u, **cs.SOLVE_KW)
    stop.record()
    torch.cuda.synchronize()
    times.append(start.elapsed_time(stop))
solved = float((res.status_val == ot.OSQP_SOLVED).float().mean())
polish = {"k8_factor_ms": None, "k8_solve_ms": None, "polish_solve_median_ms": None, "polished": None}
if hasattr(cs, "polish_kkt"):
    from osqp_tpu_torch.ops import kkt_lu as k8
    K, _ = cs.polish_kkt((P, q, A, l, u), torch.float32)
    lu, perm = k8.kkt_lu_factor(K)
    b = torch.randn(B, n + m, device=dev)
    polish["k8_factor_ms"] = cs.cuda_ms(lambda: k8.kkt_lu_factor(K), reps=5)
    polish["k8_solve_ms"] = cs.cuda_ms(lambda: k8.kkt_lu_solve(lu, perm, b), reps=5)
    del K, lu
    kw = {**cs.SOLVE_KW, "polish": True}
    pol = ot.solve_batch(P, q, A, l, u, **kw)
    polish["polished"] = float((pol.status_polish == 1).float().mean())
    polish["polish_solve_median_ms"] = statistics.median(
        cs.cuda_ms(lambda: ot.solve_batch(P, q, A, l, u, **kw), reps=1, warmup=0) for _ in range(3))
print(json.dumps({"root": sys.argv[1], "k1_all_active_ms": k1_ms, "k4_ms": k4_ms, "k2_ms": k2_ms,
                  "setup_ms": setup_ms, "solve_median_ms": statistics.median(times),
                  "solve_ms": times, "solved": solved, "max_iter": int(res.iter.max()), **polish}))
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
