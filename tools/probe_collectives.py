#!/usr/bin/env python3
"""Host time of one collective on a one-rank NCCL group, at the shapes of
osqp_tpu_torch.parallel's row-sharded products, beside the copy that a
one-rank collective amounts to.

Run on a machine with a CUDA card: ``python3 tools/probe_collectives.py``.
Each variant is called CALLS times back to back after a warm-up, each
call followed by a small kernel (as a CG step follows its product), and
timed by the host's clock around the loop with a synchronize at its end;
prints ms per call, the card's name and power limit.  Then each variant
once behind ~50 ms of queued device work: whether the call waits for it.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

CALLS = 2000


def main() -> int:
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        print("probe_collectives: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    try:
        rows = torch.randn(1, 12500, dtype=torch.float64, device=dev)  # A_r p of CVXQP2_L
        cols = torch.randn(1, 1000, dtype=torch.float64, device=dev)  # A_r'(rho A_r p) of the dense QP
        out_rows = torch.empty_like(rows)
        pad = torch.zeros(1, device=dev)

        def listed():
            outs = [torch.empty_like(rows)]
            dist.all_gather(outs, rows)
            return torch.cat(outs, dim=1)

        variants = {
            "all_gather, a list of outputs, (1, 12500) float64": listed,
            "all_gather_single, one output, (1, 12500) float64": lambda: single(out_rows, rows),
            "all_reduce SUM, (1, 1000) float64": lambda: dist.all_reduce(cols),
            "copy_ of (1, 12500) float64 (no collective)": lambda: out_rows.copy_(rows),
        }
        for label, fn in variants.items():
            for _ in range(50):
                fn()
                pad.add_(1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(CALLS):
                fn()
                pad.add_(1)
            torch.cuda.synchronize()
            print(f"{label} [{smi}]: {(time.perf_counter() - t0) * 1e3 / CALLS:.4f} ms a call, host clock over "
                  f"{CALLS} calls")
        # Does a call wait for the work queued before it?  ~50 ms of device
        # time queued, then one call timed by the host's clock.
        for label, fn in variants.items():
            torch.cuda.synchronize()
            torch.cuda._sleep(100_000_000)
            t0 = time.perf_counter()
            fn()
            host = (time.perf_counter() - t0) * 1e3
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            rest = (time.perf_counter() - t1) * 1e3
            print(f"{label}, behind ~50 ms of queued device work: the call returned after {host:.4f} ms, the "
                  f"queue drained {rest:.4f} ms later")
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
