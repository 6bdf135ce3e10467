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
was ported); K1r (``admm_iter_refined``) at the headline shape and at the
MPC cell's (B=1000, n=372, m=612, float32, chip_smoke.py's scenarios and
their ``dense_inv`` factor), every instance active, warm (mean of 20
calls) and with the L2 flushed before each call (mean of 10); and K3
(``term_products``) at CVXQP2_M (B=1, n=1000, m=1250, float64, Ruiz-
scaled) without and with the certificate products, and at the headline
shape with them, mean of 50 warm calls each.  A checkout that lacks an
entry point a leg needs gives null for that leg.  Prints the card, then
one JSON line per checkout.  Imports nothing of JAX.
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
K = lu = None
if hasattr(cs, "polish_kkt"):
    from osqp_tpu_torch.ops import kkt_lu as k8
    K, _ = cs.polish_kkt((P, q, A, l, u), torch.float32)
    lu, perm = k8.kkt_lu_factor(K)
    b = torch.randn(B, n + m, device=dev)
    polish["k8_factor_ms"] = cs.cuda_ms(lambda: k8.kkt_lu_factor(K), reps=5)
    polish["k8_solve_ms"] = cs.cuda_ms(lambda: k8.kkt_lu_solve(lu, perm, b), reps=5)
    kw = {**cs.SOLVE_KW, "polish": True}
    pol = ot.solve_batch(P, q, A, l, u, **kw)
    polish["polished"] = float((pol.status_polish == 1).float().mean())
    polish["polish_solve_median_ms"] = statistics.median(
        cs.cuda_ms(lambda: ot.solve_batch(P, q, A, l, u, **kw), reps=1, warmup=0) for _ in range(3))
del K, lu, M
refined = {"k1r_headline_ms": None, "k1r_headline_flushed_ms": None, "k1r_mpc_ms": None, "k1r_mpc_flushed_ms": None}


def k1r_operands(arrays):
    P, q, A, l, u = cs.on_device(arrays, torch.float32, dev)
    sc, rs_, fac, dyn_ = cs.prepared(P, q, A, l, u)
    B_, n_, m_ = P.shape[0], P.shape[1], A.shape[1]
    x_, z_, dx_, y_ = cs._random_state(B_, n_, m_, torch.float32, dev, seed=2)
    return (fac["Minv"], sc.A, fac["P"], sc.q, sc.l, sc.u, rs_.rho_vec, rs_.rho_inv_vec, float(dyn_.sigma),
            float(dyn_.alpha), torch.ones(B_, dtype=torch.bool, device=dev), x_, z_, y_, dx_, torch.randn_like(z_),
            1e-7 * torch.randn_like(z_))


for key, make in (("headline", lambda: cs.make_qps(B, n, m)), ("mpc", lambda: cs.mpc_scenarios()[1:])):
    if key == "mpc" and not hasattr(cs, "mpc_scenarios"):
        continue
    ra = k1r_operands(make())
    refined[f"k1r_{key}_ms"] = cs.cuda_ms(lambda: k1.admm_iter_refined(*ra), reps=20)
    refined[f"k1r_{key}_flushed_ms"] = cs.cuda_ms_flushed(lambda: k1.admm_iter_refined(*ra), reps=10)
    del ra
from osqp_tpu_torch.ops import term_products as k3
Pm, qm, Am, lm, um = cs.on_device(cs.maros_dense("CVXQP2_M"), torch.float64, dev)
_, _, _, Ps, _, As, _, _ = k4.ruiz(Pm, qm, Am, lm, um, 10)
xs, ys, dxs, dys = cs._random_state(1, 1000, 1250, torch.float64, dev)
xh, yh, dxh, dyh = cs._random_state(B, n, m, torch.float32, dev)
k3_legs = {"k3_cvxqp2_m_f64_ms": cs.cuda_ms(lambda: k3.term_products(Ps, As, xs, ys), reps=50),
           "k3_cvxqp2_m_f64_cert_ms": cs.cuda_ms(lambda: k3.term_products(Ps, As, xs, ys, dxs, dys), reps=50),
           "k3_headline_cert_ms": cs.cuda_ms(lambda: k3.term_products(scaled.P, scaled.A, xh, yh, dxh, dyh),
                                             reps=50)}
print(json.dumps({"root": sys.argv[1], "k1_all_active_ms": k1_ms, "k4_ms": k4_ms, "k2_ms": k2_ms,
                  "setup_ms": setup_ms, "solve_median_ms": statistics.median(times),
                  "solve_ms": times, "solved": solved, "max_iter": int(res.iter.max()), **polish, **refined,
                  **k3_legs}))
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
