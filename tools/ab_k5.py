#!/usr/bin/env python3
"""K5's host cost and the sparse solve, per checkout, in turns, on one card.

    python3 tools/ab_k5.py _checkout/parent . . _checkout/parent

Each argument is the root of a checkout of this repository (a parent
unpacked with ``git archive`` into a directory that ``.gitignore``
lists).  For each, in a process of its own, the script builds that
checkout's kernels and measures at CVXQP2_L in float64 (B = 1, the
sparse path's scaled operands):

- the host's microseconds per ``ell_matvec(A, x)`` call: the median of 5
  rounds of 1000 calls back to back, each synchronised once at its end
  (the call's device work is a few microseconds, below its host cost);
- the warm time per call by CUDA events (200 calls);
- ``solve_sparse`` of CVXQP2_L in float64: K5's launches, the
  iterations, the wall time (median of 5 solves), a digest of x and y;
- one more solve under ``torch.profiler``: the wall time, the device's
  busy time, K5's device time and the idle share.

It prints the card's name and power limit, a JSON line per checkout, and
exits with 1 if the checkouts' x, y or iterations differ.
"""

from __future__ import annotations

import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

# K5's kernels, by name in the profiler (in the library's anonymous
# namespace: PyTorch's own reduce_kernel is not one of them)
K5_NAMES = tuple(f"namespace)::{k}<" for k in ("reduce_kernel", "group_kernel", "cg_start_kernel", "scale_kernel"))


def worker(root: str) -> dict:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import osqp_tpu_torch as ot
    from osqp_tpu_torch import _build, batch, large
    from osqp_tpu_torch.io.qps import load_qps
    from osqp_tpu_torch.ops import ell

    assert os.path.abspath(ot.__file__).startswith(root), ot.__file__
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0

    qp = load_qps(os.path.join(root, "tests", "data", "maros_mm", "CVXQP2_L.qps"))
    args = (qp.P, qp.q[None], qp.A, qp.l[None], qp.u[None])
    s, dt, cfg, dyn, P_ell, A_ell, q, l, u = large.prepare_sparse(*args, {"dtype": "float64", "verbose": False}, dev)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=dev)
    scaled = batch._prepare(cfg, s.scaling, P_ell, t(q), A_ell, t(l), t(u), torch.full((1,), s.rho, dtype=dt,
                            device=dev), dyn, None, None)[0]
    A = scaled.A
    x = torch.randn((1, A.shape[1]), generator=torch.Generator(device=dev).manual_seed(3), dtype=dt, device=dev)

    call = lambda: ell.ell_matvec(A, x)
    call()
    rounds = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(1000):
            call()
        torch.cuda.synchronize()
        rounds.append((time.perf_counter() - t0) / 1000 * 1e6)
    host_us = statistics.median(rounds)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(200):
        call()
    stop.record()
    torch.cuda.synchronize()
    event_ms = start.elapsed_time(stop) / 200

    solve = lambda: ot.solve_sparse(*args, dtype="float64", verbose=False)
    walls = []
    for _ in range(5):
        before = ell.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        launches = ell.launches - before
    digest = hashlib.sha256(res.x.cpu().numpy().tobytes() + res.y.cpu().numpy().tobytes()).hexdigest()[:16]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        pwall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in events) / 1e3
    k5_ms = sum(e.time_range.elapsed_us() for e in events if any(k in e.name for k in K5_NAMES)) / 1e3
    return dict(root=root, build_s=round(build_s, 2), host_us_matvec=host_us, host_us_rounds=rounds,
                event_ms_matvec=event_ms,
                k5_launches=launches, iterations=int(res.iter.max()), status=int(res.status_val[0]),
                solve_ms=statistics.median(walls), solve_ms_all=walls, profiled_wall_ms=pwall, busy_ms=busy,
                k5_device_ms=k5_ms, idle=1.0 - busy / pwall if events else None, xy=digest)


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--worker":
        print(json.dumps(worker(sys.argv[2])))
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no card")
    runs = []
    for root in sys.argv[1:]:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", root], capture_output=True,
                             text=True)
        if out.returncode != 0:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]))
    same = len({(r["xy"], r["iterations"], r["status"]) for r in runs}) == 1
    print(f"x, y and iterations the same in every checkout: {same}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
