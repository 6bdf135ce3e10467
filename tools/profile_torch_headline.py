#!/usr/bin/env python3
"""Where the time of osqp_tpu_torch's headline solve goes, on one CUDA GPU.

    python3 tools/profile_torch_headline.py [--batch 8192] [--top 15] [--polish | --mpc [--backend dense_inv]]

Solves chip_smoke.py's headline batch (B=8192, n=100, m=200, float32,
eps 1e-3; polish off, or on with ``--polish``), or with ``--mpc`` its MPC
cell (1000 scenarios, n=372, m=612, stages of 12, float32, through the
``block_tridiag`` backend, or with ``--backend dense_inv`` through the
explicit inverse, whose loop body is K1r's refined one), once to warm up, then once under
``torch.profiler``.  Prints the card, the solve's wall time (host clock
around work that ends in a synchronize), the device's busy time and
idle share over that window, and device time by kernel, largest first.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import HEADLINE, MPC, MPC_KW, SOLVE_KW, make_qps, mpc_scenarios, on_device  # noqa: E402


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=HEADLINE["B"])
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--polish", action="store_true", help="solve with polish on (adds K8 and polish's K3 calls)")
    ap.add_argument("--mpc", action="store_true", help="the MPC cell through block_tridiag (K7) instead")
    ap.add_argument("--backend", choices=("block_tridiag", "dense_inv"), default="block_tridiag",
                    help="the MPC cell's backend (dense_inv: K1r's refined body)")
    args = ap.parse_args()
    kw = {**SOLVE_KW, "polish": args.polish}
    if not torch.cuda.is_available():
        print("profile_torch_headline: no CUDA device", file=sys.stderr)
        return 1
    import osqp_tpu_torch as ot

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip())
    dev = torch.device("cuda", 0)
    if args.mpc:
        base, *arrays = mpc_scenarios()
        B, (n, m) = MPC["B"], (base.P.shape[0], base.A.shape[0])
        extra = dict(block_size=base.block_size) if args.backend == "block_tridiag" else {}
        kw = dict(MPC_KW, dtype="float32", linsys_solver=args.backend, **extra)
    else:
        B, n, m = args.batch, HEADLINE["n"], HEADLINE["m"]
        arrays = make_qps(B, n, m)
    P, q, A, l, u = on_device(arrays, torch.float32, dev)
    ot.solve_batch(P, q, A, l, u, **kw)  # warm-up: kernel build, allocator
    torch.cuda.synchronize()

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = ot.solve_batch(P, q, A, l, u, **kw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    by_kernel = collections.defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[e.name][0] += 1
            by_kernel[e.name][1] += e.time_range.elapsed_us() / 1e3
    busy_ms = sum(ms for _, ms in by_kernel.values())
    iters = res.iter.cpu()
    what = args.backend if args.mpc else f"polish {'on' if args.polish else 'off'}"
    print(f"B={B} n={n} m={m} float32, {what}: iterations mean "
          f"{iters.float().mean():.2f} max {int(iters.max())}, status_polish 1 in {int((res.status_polish == 1).sum())}")
    print(f"solve wall {wall_ms:.3f} ms (host clock, under the profiler); device busy {busy_ms:.3f} ms; "
          f"idle share {1.0 - busy_ms / wall_ms:.3f}")
    if not by_kernel:
        print("the profiler recorded no device time")
        return 1
    print(f"{'device ms':>10} {'share':>6} {'launches':>8}  kernel")
    for name, (count, ms) in sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[: args.top]:
        print(f"{ms:10.3f} {ms / busy_ms:6.3f} {count:8d}  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
