#!/usr/bin/env python3
"""Compare checkouts of osqp_tpu_torch on K7 above a warp, in turns, on one GPU:
the factor above the cluster path's reach and the solve above a warp.

    python3 tools/ab_k7_wide.py [--reference] ROOT [ROOT ...]

Each ROOT is the root of a checkout (for example the parent commit
unpacked with ``git archive`` and this tree: ``old . . old``, so that
drift on the card falls on both sides).  Each runs in a process of its
own, which builds that checkout's kernels and, for every case of FACTOR
and SOLVE, makes the reduced matrix M = P + sigma I + A' diag(rho) A of a
random block-tridiagonal problem with Nb = 3 stages of b on the card from
a fixed seed (the same M and right-hand side in every checkout), then
times ``bt_factor(M, b)`` (a FACTOR case) or ``bt_solve(C, G, r)`` on its
factors (a SOLVE case) by CUDA events: the median of ROUNDS means of
warm calls, as many a round as fill about 0.2 s (2 to 20).  Prints the
card, then one JSON line per checkout: for each case the path
(``factor_path``), the ms and a hash of the output's bytes (C and G, or
x: equal hashes, the same bits), or the error of a launch the checkout
refuses.  With ``--reference`` the first checkout also times, for each
case, the plain version (``bt_factor_plain`` / ``bt_solve_plain``) and
the library call (``torch.linalg.cholesky(M)``, or
``torch.cholesky_solve(r, L)`` with L computed outside the timed
region), and gives the bound: bytes over 3.35 TB/s or operations over 67
(float32) / 34 (float64) TFLOP/s, whichever is larger (the counts of
``chip_smoke.k7_cost``: the solve reads C's lower triangles).  Imports
nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

CHILD = r"""
import hashlib, json, statistics, sys, time, torch
sys.path.insert(0, sys.argv[1])
reference = sys.argv[2] == "1"
from osqp_tpu_torch.ops import block_tridiag as k7

# (dtype, b, B): the factor above cluster_max_block (558 / 361), the
# solve above a warp, at the large-stage batches' B = 4
FACTOR = [("float64", 362, 4), ("float64", 400, 4), ("float32", 559, 4), ("float32", 700, 4),
          ("float64", 900, 1)]
SOLVE = [("float32", 33, 4), ("float32", 140, 4), ("float64", 99, 4), ("float64", 256, 4), ("float64", 362, 4),
         ("float32", 140, 1000)]
# the solve at small b with the card full (few warps a CTA, many CTAs an SM)
SOLVE += [(name, b, B) for name in ("float32", "float64") for b in (33, 48, 64) for B in (132, 1000)]
ROUNDS = 3
PEAK = {"float32": 67e12, "float64": 34e12}
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
    r = torch.randn(B, n, generator=g, dtype=torch.float64, device=dev)
    return M.to(dtype).contiguous(), r.to(dtype).contiguous()


def ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    reps = max(2, min(20, int(0.2 / max(time.perf_counter() - t0, 1e-6))))
    out = []
    for _ in range(ROUNDS):
        fn()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(stop) / reps)
    return statistics.median(out)


def digest(*ts):
    return hashlib.sha256(b"".join(t.cpu().numpy().tobytes() for t in ts)).hexdigest()[:16]


def bound(name, B, b, solve):
    elt = 4 if name == "float32" else 8
    Nb = 3
    if solve:
        nbytes = elt * B * ((Nb - 1) * b * b + Nb * b * (b + 1) // 2 + 2 * Nb * b)
        flops = B * (Nb * 2 * b * b + (Nb - 1) * 4 * b * b)
    else:
        nbytes, flops = elt * B * 2 * (2 * Nb - 1) * b * b, B * (Nb * (b**3 - b) // 3 + (Nb - 1) * 2 * b**3)
    return max(nbytes / 3.35e12, flops / PEAK[name]) * 1e3


cases = []
for kind, table in (("factor", FACTOR), ("solve", SOLVE)):
    for name, b, B in table:
        dtype = getattr(torch, name)
        M, r = band_schur(B, b, dtype, seed=1000 * b + B)
        case = dict(kind=kind, dtype=name, b=b, B=B, path=k7.factor_path(b, dtype))
        try:
            C, G = k7.bt_factor(M, b)
            x = k7.bt_solve(C, G, r)
            torch.cuda.synchronize()
        except RuntimeError as e:  # a launch the checkout's kernel refuses
            cases.append(dict(case, error=str(e)))
            continue
        if kind == "factor":
            case.update(ms=ms(lambda: k7.bt_factor(M, b)), bits=digest(C, G))
        else:
            case.update(ms=ms(lambda: k7.bt_solve(C, G, r)), bits=digest(x))
        if reference:
            if kind == "factor":
                plain = ms(lambda: k7.bt_factor_plain(M, b)) if b <= 600 else None
                lib = ms(lambda: torch.linalg.cholesky(M))
            else:
                plain = ms(lambda: k7.bt_solve_plain(C, G, r))
                L = torch.linalg.cholesky(M)
                rc = r[:, :, None].contiguous()
                lib = ms(lambda: torch.cholesky_solve(rc, L))
            case.update(plain_ms=plain, library_ms=lib, bound_ms=bound(name, B, b, kind == "solve"))
        cases.append(case)
        del M, r, C, G, x
        torch.cuda.empty_cache()
print(json.dumps({"root": sys.argv[1], "cases": cases}))
"""


def main() -> int:
    args = sys.argv[1:]
    reference = bool(args) and args[0] == "--reference"
    roots = args[1:] if reference else args
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    for i, root in enumerate(roots):
        proc = subprocess.run([sys.executable, "-c", CHILD, os.path.abspath(root), "1" if reference and i == 0 else "0"],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr, file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
