#!/usr/bin/env python3
"""K6's dense loop by plan, on one card.

    python3 tools/probe_k6_dense.py [--reps N] [--cases LABEL,...]

Builds the kernels and, at each case (the cg backend's dense system of
the benchmark's random QPs, ``bench.py:31-42``, rho 0.1 on every row,
sigma 1e-6, a random right-hand side and start, relative tolerance 1e-4
in float32 and 1e-7 in float64: the headline B=8192 and B=1024, n=100,
m=200, in float32 and float64; the MPC cell's shape B=1000, n=372, m=612
in float32; B=1 at n=1000, m=1250 in float64), runs
``ops.cg.pcg_solve_dense_loop`` on every plan that fits the card: each
of ``ops.cg.LOOP_CLUSTERS`` in each mode whose shared memory fits
(``ops.cg.dense_loop_smem``) at 256, 512 and 768 threads, where the
card's occupancy query holds a cluster.  Each plan's x and steps are
checked bit for bit against the default plan's (``dense_loop_plan``).
It prints the card's name and power limit, then per case the default
plan and one line a plan: ms per CG step by CUDA events around ``reps``
solves after a warm one, and the stepwise path's ms per step (the step
kernels with batched GEMVs) beside them.  Exits with 1 where a plan's
bits differ.

    python3 tools/probe_k6_dense.py --stamps [--cases LABEL,...]

builds ``csrc/cg_dense.cu`` with ``-DOSQP_STAMPS`` into a library of its
own (about half a minute) and runs it at each case on the default plan
with one cluster in flight over the first 64 instances, so that the
stamped cluster (CTA 0 and its last CTA) runs every step alone on its
SMs: cycles per CG step by phase (``cg_dense.cu``: ``dense_stamps``),
then the same on the default plan's clusters over the whole batch
(other clusters beside it).  x and the steps are held to the library's
loop bit for bit.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import os
import pathlib
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
PHASES = ("fetch, load, start", "rows", "rows barrier", "A'(w A p)", "exchange", "Mp, p'Mp", "update", "p")


def system(B, n, m, dtype, dev, seed=0):
    """(DenseOperator, sigma, dinv, b, tol, x0) of the cg backend at a
    random point of B random QPs of n variables and m rows."""
    import numpy as np
    import torch

    from osqp_tpu_torch.linsys import cg as cg_backend
    from osqp_tpu_torch.ops import cg as k6

    rng = np.random.default_rng(seed)
    M = rng.standard_normal((B, n, n)).astype(np.float32)
    P = np.einsum("bij,bkj->bik", M, M) / n + 0.1 * np.eye(n, dtype=np.float32)
    A = rng.standard_normal((B, m, n)).astype(np.float32) / np.sqrt(n)
    T = lambda a: torch.as_tensor(a, dtype=dtype, device=dev).contiguous()  # noqa: E731
    P, A = T(P), T(A)
    rho = torch.full((B, m), 0.1, dtype=dtype, device=dev)
    fac = cg_backend.init(P, A, 1e-6, rho)
    b, x0 = T(rng.standard_normal((B, n))), T(rng.standard_normal((B, n)))
    tol = torch.full((B,), 1e-4 if dtype == torch.float32 else 1e-7, dtype=dtype, device=dev)
    return k6.DenseOperator(P, A, rho), fac["sigma"], fac["dinv"], b, tol, x0


def events_ms(fn, reps):
    import torch

    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, out


def stamps_library(work: pathlib.Path):
    """csrc/cg_dense.cu built with -DOSQP_STAMPS, bound."""
    from osqp_tpu_torch import _build

    out = work / "libdense_stamps.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-DOSQP_STAMPS", "-shared", "-o", str(out),
           str(ROOT / "osqp_tpu_torch" / "csrc" / "cg_dense.cu")]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{done.stderr}")
    lib = ctypes.CDLL(str(out))
    for name in ("osqp_cg_dense_loop", "osqp_cg_dense_loop_scratch"):
        getattr(lib, name).argtypes = _build._SIGNATURES.get(name, (ctypes.c_int,) * 6)
    lib.osqp_cg_dense_loop.restype = ctypes.c_int
    lib.osqp_cg_dense_loop_scratch.restype = ctypes.c_longlong
    lib.osqp_cg_dense_stamps.argtypes = (ctypes.c_void_p,)
    lib.osqp_cg_dense_stamps.restype = ctypes.c_int
    return lib


def stamped(lib, op, sigma, dinv, b, tol, max_iter, x0, plan):
    """One launch of the stamps build as ops.cg.pcg_solve_dense_loop makes
    it; returns (x, steps, the stamps table 2 x 16)."""
    import numpy as np
    import torch

    from osqp_tpu_torch import _build
    from osqp_tpu_torch.ops import cg as k6

    B, n = b.shape
    m = op.A.shape[1]
    code = _build.dtype_code(b.dtype)
    clusters = min(plan.clusters, B)
    scratch = torch.empty(lib.osqp_cg_dense_loop_scratch(code, n, m, plan.cluster, int(plan.vectors), clusters),
                          dtype=torch.uint8, device=b.device)
    x, steps = torch.empty_like(b), torch.zeros(B + 1, dtype=torch.int32, device=b.device)
    tol2 = k6._tol2(b, tol)
    table = np.zeros((2, 16), dtype=np.uint64)
    lib.osqp_cg_dense_stamps(table.ctypes.data)  # zeroed
    err = lib.osqp_cg_dense_loop(code, op.P.data_ptr(), op.A.data_ptr(), op.w.data_ptr(), float(sigma),
                                 dinv.data_ptr(), b.data_ptr(), x0.data_ptr(), tol2.data_ptr(), x.data_ptr(),
                                 steps.data_ptr(), scratch.data_ptr(), B, n, m, int(max_iter), plan.cluster,
                                 plan.threads, int(plan.resident), int(plan.vectors), clusters, _build.stream())
    torch.cuda.synchronize()
    if err:
        raise RuntimeError(f"the stamps build's launch failed: CUDA error {err}")
    lib.osqp_cg_dense_stamps(table.ctypes.data)
    return x, steps[:B], table


def main() -> int:
    import torch

    from osqp_tpu_torch import _build
    from osqp_tpu_torch.ops import cg as k6

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--cases", default="")
    ap.add_argument("--stamps", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_k6_dense: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    _build.library()
    cases = [("headline B=8192 f32", 8192, 100, 200, torch.float32),
             ("headline B=8192 f64", 8192, 100, 200, torch.float64),
             ("headline B=1024 f32", 1024, 100, 200, torch.float32),
             ("headline B=1024 f64", 1024, 100, 200, torch.float64),
             ("MPC shape B=1000 f32", 1000, 372, 612, torch.float32),
             ("B=1 n=1000 m=1250 f64", 1, 1000, 1250, torch.float64)]
    wanted = [c for c in args.cases.split(",") if c]
    bad = 0
    for label, B, n, m, dtype in cases:
        if wanted and not any(w in label for w in wanted):
            continue
        op, sigma, dinv, b, tol, x0 = system(B, n, m, dtype, dev)
        max_iter = n + m
        code = _build.dtype_code(dtype)
        itemsize = b.element_size()
        default = k6._dense_planned(B, n, m, code, dev.index or 0)
        if args.stamps:
            with tempfile.TemporaryDirectory() as work:
                lib = stamps_library(pathlib.Path(work))
                for what, Bs, plan in (("one cluster, 64 instances", min(B, 64), dataclasses.replace(default,
                                                                                                     clusters=1)),
                                       ("the default plan's clusters, the whole batch", B, default)):
                    cut = lambda t: t[:Bs].contiguous()  # noqa: E731
                    sub = k6.DenseOperator(cut(op.P), cut(op.A), cut(op.w))
                    x, st, table = stamped(lib, sub, sigma, cut(dinv), cut(b), cut(tol), max_iter, cut(x0), plan)
                    xl, sl = k6.pcg_solve_dense_loop(sub, sigma, cut(dinv), cut(b), cut(tol), max_iter, cut(x0),
                                                     plan=plan)
                    same = torch.equal(x, xl) and torch.equal(st, sl)
                    bad += not same
                    total = int(st.sum()) if plan.clusters == 1 else 0
                    for row, cta in enumerate(("CTA 0", f"CTA {plan.cluster - 1}")):
                        cyc = table[row][:len(PHASES)].astype(float)
                        per = ", ".join(f"{ph} {c / total:.0f}" if total else f"{ph} {c / cyc[1:8].sum():.3f}"
                                        for ph, c in zip(PHASES, cyc))
                        print(f"{label}, {what}, plan {plan}, {cta}: "
                              f"{'cycles per CG step' if total else 'share of the steps cycles'} by phase: {per}; "
                              f"bits equal {same}")
            continue
        ms, (xd, sd) = events_ms(lambda: k6.pcg_solve_dense_loop(op, sigma, dinv, b, tol, max_iter, x0), args.reps)
        steps = max(int(sd.max()), 1)
        sms, _ = events_ms(lambda: k6.pcg_solve_stepwise(op, sigma, dinv, b, tol, max_iter, x0), 1)
        print(f"{label}: {steps} steps; default plan {default}: {ms / steps:.6f} ms per CG step; the stepwise path "
              f"{sms / steps:.6f}")
        for cluster in k6.LOOP_CLUSTERS:
            for resident, vectors in ((True, True), (False, True), (False, False)):
                smem = k6.dense_loop_smem(n, m, cluster, resident, vectors, itemsize)
                if smem > _build.SMEM_BYTES:
                    continue
                for threads in (256, 512, 768):
                    held = _build.library().osqp_cg_dense_loop_clusters(code, cluster, threads, smem, resident,
                                                                        vectors)
                    if held < 1:
                        continue
                    plan = k6.LoopPlan(cluster, threads, resident, vectors, smem, min(held, B))
                    ms, (x, s) = events_ms(lambda: k6.pcg_solve_dense_loop(op, sigma, dinv, b, tol, max_iter, x0,
                                                                            plan=plan), args.reps)
                    same = torch.equal(s, sd) and torch.equal(x, xd)
                    bad += not same
                    print(f"  cluster {cluster:2d} x {threads:4d} threads, {'resident' if resident else 'streamed'}"
                          f"{'' if vectors else ', vectors in device memory'}, {smem} B, {plan.clusters} clusters: "
                          f"{ms / steps:.6f} ms per CG step; bits {'equal' if same else 'DIFFER'}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
