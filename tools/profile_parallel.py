#!/usr/bin/env python3
"""Where the time of a row-sharded sparse solve goes, on one card.

Runs LISWET1 (float64, polish off) three ways under a one-rank NCCL group
(osqp_tpu_torch.parallel.make_mesh): solve_sparse (K6's device loop),
solve_sparse with the CG forced onto the step kernels (the stepwise path
that the sharded entry takes), and solve_single_sharded_sparse; prints
each one's wall ms (host clock, synchronized; the median of 3) and CG
steps, then each under torch.profiler: the host operations with the most
self CPU time and the device's busy time.  Run on a machine with a CUDA
card: ``python3 tools/profile_parallel.py [NAME]`` (a Maros-Meszaros row
of tests/data/maros_mm, LISWET1 by default).
"""

from __future__ import annotations

import contextlib
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_parallel: no CUDA device", file=sys.stderr)
        return 1
    import osqp_tpu_torch as ot
    from osqp_tpu_torch import parallel
    from osqp_tpu_torch.io.qps import load_qps
    from osqp_tpu_torch.ops import cg as k6

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    name = sys.argv[1] if len(sys.argv) > 1 else "LISWET1"
    qp = load_qps(os.path.join(ROOT, "tests", "data", "maros_mm", f"{name}.qps"))
    mesh = parallel.make_mesh()
    kw = dict(dtype="float64", verbose=False)

    @contextlib.contextmanager
    def stepwise():
        loop = k6.pcg_solve_loop
        k6.pcg_solve_loop = k6.pcg_solve_stepwise
        try:
            yield
        finally:
            k6.pcg_solve_loop = loop

    def unsharded():
        return ot.solve_sparse(qp.P, qp.q, qp.A, qp.l, qp.u, **kw)

    def unsharded_stepwise():
        with stepwise():
            return unsharded()

    def sharded():
        return parallel.solve_single_sharded_sparse(qp.P, qp.q, qp.A, qp.l, qp.u, mesh=mesh, **kw)

    try:
        for label, fn in (("solve_sparse (K6's loop)", unsharded), ("solve_sparse, stepwise PCG", unsharded_stepwise),
                          ("solve_single_sharded_sparse, one rank", sharded)):
            steps = k6.launches
            fn()
            torch.cuda.synchronize()
            steps = k6.launches - steps
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            events = prof.key_averages()
            busy = sum(e.self_device_time_total for e in events) / 1e3
            print(f"{name} float64 {label} [{smi}]: wall ms {statistics.median(times):.3f} "
                  f"{[round(t, 3) for t in times]}; {steps} CG step launches; under the profiler wall {wall:.3f} ms, "
                  f"device busy {busy:.3f} ms")
            top = sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)[:14]
            for e in top:
                print(f"    {e.key[:70]:<70} calls {e.count:>7}  self CPU {e.self_cpu_time_total / 1e3:10.3f} ms  "
                      f"CPU total {e.cpu_time_total / 1e3:10.3f} ms")
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
