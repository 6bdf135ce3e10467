#!/usr/bin/env python3
"""Compare checkouts of osqp_tpu_torch on K7's factor above a warp, in turns, on one GPU.

    python3 tools/ab_k7_factor.py ROOT [ROOT ...]

Each ROOT is the root of a checkout (for example the parent commit
unpacked with ``git archive`` and this tree: ``old . . old``, so that
drift on the card falls on both sides).  Each runs in a process of its
own, which builds that checkout's kernels and, for every block size b of
SIZES and batch B of BATCHES and every case of EXTRA, makes the reduced matrix M = P + sigma I +
A' diag(rho) A of a random block-tridiagonal problem with Nb = 3 stages
on the card from a fixed seed (the same M in every checkout), factors
it with ``bt_factor(M, b)`` on the path that checkout takes, and times
it by CUDA events: the median of ROUNDS means of REPS warm calls.  Prints
the card, then one JSON line per checkout: for each case the path
(``factor_path``), the ms, and a hash of C and G's bytes (equal hashes:
the same bits), or the error of a launch the checkout refuses.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

CHILD = r"""
import hashlib, json, statistics, sys, torch
sys.path.insert(0, sys.argv[1])
from osqp_tpu_torch.ops import block_tridiag as k7

SIZES = {"float32": (33, 40, 48, 64, 100, 139), "float64": (33, 40, 48, 64, 98)}
BATCHES = (1, 8, 132, 1000)
# (dtype, b, B) besides: the large-stage MPC batches' cells on the cluster path
EXTRA = (("float32", 140, 4), ("float64", 99, 4), ("float32", 256, 4), ("float64", 256, 4))
REPS, ROUNDS = 20, 3
dev = torch.device("cuda", 0)


def band_schur(B, b, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    Nb, n = 3, 3 * b
    P = torch.zeros(B, n, n, dtype=torch.float64, device=dev)
    for i in range(Nb):
        W = torch.randn(B, b, b, generator=g, dtype=torch.float64, device=dev)
        P[:, i * b:(i + 1) * b, i * b:(i + 1) * b] = W @ W.mT / b + 0.5 * torch.eye(b, dtype=torch.float64, device=dev)
    A = torch.zeros(B, (Nb - 1) * b, n, dtype=torch.float64, device=dev)
    for i in range(Nb - 1):
        A[:, i * b:(i + 1) * b, i * b:(i + 2) * b] = torch.randn(B, b, 2 * b, generator=g, dtype=torch.float64,
                                                                 device=dev)
    rho = torch.randn(B, A.shape[1], generator=g, dtype=torch.float64, device=dev).abs() + 0.1
    M = P + 1e-6 * torch.eye(n, dtype=torch.float64, device=dev) + A.mT @ (rho[:, :, None] * A)
    return M.to(dtype).contiguous()


def ms(fn):
    out = []
    for _ in range(ROUNDS):
        fn()
        fn()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            fn()
        stop.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(stop) / REPS)
    return statistics.median(out)


cases = []
for name, b, B in [(name, b, B) for name, sizes in SIZES.items() for b in sizes for B in BATCHES] + list(EXTRA):
    dtype = getattr(torch, name)
    M = band_schur(B, b, dtype, seed=1000 * b + B)
    try:
        C, G = k7.bt_factor(M, b)
        torch.cuda.synchronize()
    except RuntimeError as e:  # a launch the checkout's kernel refuses
        cases.append(dict(dtype=name, b=b, B=B, path=k7.factor_path(b, dtype), error=str(e)))
        continue
    digest = hashlib.sha256(C.cpu().numpy().tobytes() + G.cpu().numpy().tobytes()).hexdigest()[:16]
    cases.append(dict(dtype=name, b=b, B=B, path=k7.factor_path(b, dtype), ms=ms(lambda: k7.bt_factor(M, b)),
                      bits=digest))
    del M, C, G
print(json.dumps({"root": sys.argv[1], "cases": cases}))
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
