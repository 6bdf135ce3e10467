#!/usr/bin/env python3
"""K6's device loop per checkout, in turns, on one card.

    python3 tools/ab_k6.py [--corpus] _checkout/parent . . _checkout/parent

Each argument is the root of a checkout of this repository (a parent
unpacked with ``git archive`` into a directory that ``.gitignore``
lists).  For each, in a process of its own, the script builds that
checkout's kernels and runs ``ops.cg.pcg_solve_loop`` on:

- CVXQP2_L in float64, the cg backend's form, from the ADMM state after
  100 iterations of the sparse path (as ``chip_smoke.py``'s k6 phase);
- LISWET1's first polish system in float32 and in float64, polish's form,
  to polish's tolerance and step cap (as the sparse_polish phase);
- 8 copies of LISWET1 (q scaled by 1 + 0.1 i), the cg form after 50
  iterations;
- 64 scenarios of CVXQP2_M, the cg form after 50 iterations: many
  instances a launch.

For each case: the steps (the batch's most), the device ms of the loop's
kernel under ``torch.profiler`` (its name holds ``loop_kernel`` in every
checkout) per solve and per CG step, the ms of the whole call by CUDA
events (median of 3), the checkout's loop plan where it has one, and a
digest of x and the steps.  Then the wall ms (host clock, synchronised;
median of 3) of ``solve_sparse`` at CVXQP2_L in float64 and of the
polish-on ``solve_sparse`` at LISWET1 in float64, and with ``--corpus``
the wall seconds of ``maros.run_maros`` over the corpus in float64 with
polish on (one run), with its passes.

It prints the card's name and power limit, a JSON line per checkout, and
exits with 1 if any case's x or steps, or the solves' x, y and
iterations, differ between the checkouts.

    python3 tools/ab_k6.py --plans .

times instead, in one checkout, every plan of the loop that fits at each
case (the cluster sizes of ``ops.cg.LOOP_CLUSTERS`` as ``loop_plan``
narrows them, in each mode: operands and vectors in shared memory, the
vectors alone, everything in device memory; and the default plan), each
checked bit for
bit against the default plan, and prints a JSON line per case.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time


def make_cases(cs, dev) -> dict:
    """label -> a function that makes the case's (op, sigma, dinv, b, tol,
    max_iter, x0) with this checkout's modules (``cs``: its chip_smoke)."""
    import torch

    from osqp_tpu_torch import admm
    from osqp_tpu_torch import polish as tpolish
    from osqp_tpu_torch.ops import cg as k6, ell as k5

    def cg_form(name, B, iters):
        cfg, dyn, scaled, scl, rs, fac, it = cs.sparse_prepared(name, "float64", dev, B)
        c = admm.run_segment(cfg, scaled, scl, dyn, admm.init_carry(cfg, scaled, rs, fac, it), iters)
        rs, fac = c.rho_state, c.factor
        b = (dyn.sigma * c.it.x - scaled.q) + k5.ell_tmatvec(scaled.A, c.it.z - rs.rho_inv_vec * c.it.y,
                                                             rs.rho_vec)
        op = k6._operator(fac["P"], scaled.A, rs.rho_vec, plain=False)
        return op, fac["sigma"], fac["dinv"], b, fac["tol_rel"], int(fac["max_iter"]), c.it.x

    def polish_form(dtype):
        cfg, dyn, scaled, scl, rs, fac, it = cs.sparse_prepared("LISWET1", dtype, dev)
        c = admm.run_segment(cfg, scaled, scl, dyn, admm.init_carry(cfg, scaled, rs, fac, it), cfg.max_iter)
        x, z, y = c.it.x, c.it.z, c.it.y
        B, n = x.shape
        m = cfg.m
        lower, upper = z - scaled.l < -y, scaled.u - z < y
        mask = (lower | upper).to(x.dtype)
        MA = k5.ell_scale(scaled.A, mask, torch.ones((B, n), dtype=x.dtype, device=dev))
        rhs_z = mask * torch.where(lower, scaled.l, torch.where(upper, scaled.u, torch.zeros_like(scaled.l)))
        d = dyn.delta if dtype == "float64" else torch.clamp(dyn.delta, min=1e-4)
        t = (-scaled.q + k5.ell_tmatvec(MA, rhs_z.contiguous()) / d).contiguous()
        ones = torch.ones((B, m), dtype=x.dtype, device=dev)
        dinv = 1.0 / (k5.ell_diagonal(scaled.P) + d + k5.ell_sq_colsums(MA, ones) / d)
        tol = torch.full((B,), 1e-12 if dtype == "float64" else 1e-7, dtype=x.dtype, device=dev)
        return k6.EllOperator(scaled.P, MA, div=d), d, dinv, t, tol, tpolish.polish_cg_cap(n, m), None

    return {
        "CVXQP2_L/float64/cg": lambda: cg_form("CVXQP2_L", 1, 100),
        "LISWET1/float32/polish": lambda: polish_form("float32"),
        "LISWET1/float64/polish": lambda: polish_form("float64"),
        "LISWET1_B8/float64/cg": lambda: cg_form("LISWET1", 8, 50),
        "CVXQP2_M_B64/float64/cg": lambda: cg_form("CVXQP2_M", 64, 50),
    }


def timed(call) -> tuple:
    """(the call's result, the loop kernel's device ms in one call under
    the profiler, the ms of the whole call by CUDA events: median of 3 and
    all three)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    res = call()
    ms = []
    for _ in range(3):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        call()
        stop.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(stop))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    kernel_ms = sum(e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA and "loop_kernel" in e.name) / 1e3
    return res, kernel_ms, statistics.median(ms), ms


def digest(*ts) -> str:
    return hashlib.sha256(b"".join(t.detach().cpu().numpy().tobytes() for t in ts)).hexdigest()[:16]


def _checkout(root: str):
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    import osqp_tpu_torch as ot
    from osqp_tpu_torch import _build

    assert os.path.abspath(ot.__file__).startswith(root), ot.__file__
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.library()
    return root, cs, dev, time.perf_counter() - t0


def plans(root: str) -> None:
    """Every plan of the loop that fits, at each case, against the default."""
    root, cs, dev, _ = _checkout(root)
    import torch

    from osqp_tpu_torch import _build
    from osqp_tpu_torch.ops import cg as k6

    for label, make in make_cases(cs, dev).items():
        op, sigma, dinv, b, tol, max_iter, x0 = make()
        B, n = b.shape
        m, kp, ka, kt = op.A.shape[0], op.P.idx.shape[1], op.A.idx.shape[1], op.A.t_idx.shape[1]
        (x, steps), kernel_ms, call_ms, _ = timed(lambda: k6.pcg_solve_loop(op, sigma, dinv, b, tol, max_iter, x0))
        default = k6.last_plan
        n_steps = int(steps.max())
        rows = [dict(plan="default", **dataclasses.asdict(default), kernel_ms_per_step=kernel_ms / n_steps,
                     call_ms=call_ms)]
        code = _build.dtype_code(b.dtype)
        tried = set()
        for start in k6.LOOP_CLUSTERS:
            parts = k6.parts_of(n)
            if start > parts and start > 1:
                continue
            cluster = -(-parts // -(-parts // start))
            for resident, vectors in ((True, True), (False, True), (False, False)):
                smem = k6.loop_smem(n, m, kp, ka, kt, cluster, resident, vectors, b.element_size())
                threads = 256 * min(4, -(-parts // cluster))
                if smem > _build.SMEM_BYTES or (cluster, resident, vectors) in tried:
                    continue
                tried.add((cluster, resident, vectors))
                held = _build.library().osqp_cg_loop_clusters(code, cluster, threads, smem, resident, vectors)
                if held < 1:
                    rows.append(dict(cluster=cluster, resident=resident, vectors=vectors, held=held))
                    continue
                plan = k6.LoopPlan(cluster, threads, resident, vectors, smem, min(held, B))
                (xq, sq), kms, cms, _ = timed(
                    lambda: k6.pcg_solve_loop(op, sigma, dinv, b, tol, max_iter, x0, plan=plan))
                rows.append(dict(**dataclasses.asdict(plan), held=held, kernel_ms_per_step=kms / n_steps,
                                 call_ms=cms, same_bits=bool(torch.equal(xq, x) and torch.equal(sq, steps))))
        print(json.dumps(dict(case=label, B=B, n=n, m=m, kp=kp, ka=ka, kt=kt, steps=n_steps, plans=rows)))


def worker(root: str, corpus: bool) -> dict:
    root, cs, dev, build_s = _checkout(root)
    import torch

    import osqp_tpu_torch as ot
    from osqp_tpu_torch import maros
    from osqp_tpu_torch.ops import cg as k6

    out = {}
    for label, make in make_cases(cs, dev).items():
        op, sigma, dinv, b, tol, max_iter, x0 = make()
        (x, steps), kernel_ms, call_ms, ms = timed(lambda: k6.pcg_solve_loop(op, sigma, dinv, b, tol, max_iter, x0))
        n_steps = int(steps.max())
        plan = getattr(k6, "last_plan", None)
        out[label] = dict(B=b.shape[0], n=b.shape[1], steps=n_steps, kernel_ms=kernel_ms,
                          kernel_ms_per_step=kernel_ms / max(n_steps, 1), call_ms=call_ms, call_ms_all=ms,
                          plan=dataclasses.asdict(plan) if plan is not None else None, bits=digest(x, steps))

    def wall(fn):
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        return res, walls

    for label, name, kw in (("solve_sparse CVXQP2_L/float64", "CVXQP2_L", {}),
                            ("solve_sparse LISWET1/float64 polish", "LISWET1", {"polish": True})):
        P, q, A, l, u = cs.scenario(name)
        fn = lambda: ot.solve_sparse(P, q, A, l, u, dtype="float64", verbose=False, **kw)  # noqa: E731
        fn()
        res, walls = wall(fn)
        out[label] = dict(wall_ms=statistics.median(walls), wall_ms_all=walls, iterations=int(res.iter.max()),
                          status_polish=res.status_polish.cpu().tolist() if kw else None,
                          bits=digest(res.x, res.y, res.iter))
    if corpus:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows, summary = maros.run_maros(maros.collect_paths([cs.MAROS]), eps=1e-3, polish=True, dtype="float64",
                                        device=dev, verbose=False)
        torch.cuda.synchronize()
        out["corpus float64"] = dict(
            wall_s=time.perf_counter() - t0, sparse_rows_s=sum(r["time"] for r in rows if r.get("sparse")),
            solved=sum(r["status_val"] in (1, 2) for r in rows), rows=len(rows),
            bits=hashlib.sha256(json.dumps([(r["name"], r["status_val"], r["iter"], r["status_polish"])
                                            for r in rows]).encode()).hexdigest()[:16])
    return dict(root=root, build_s=round(build_s, 2), **out)


def main() -> int:
    args = sys.argv[1:]
    if len(args) == 2 and args[0] == "--plans":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip().splitlines()
        print(smi[0] if smi else "nvidia-smi: no card")
        plans(args[1])
        return 0
    if len(args) > 1 and args[0] == "--worker":
        print(json.dumps(worker(args[1], corpus=len(args) > 2 and args[2] == "--corpus")))
        return 0
    corpus = "--corpus" in args
    roots = [a for a in args if a != "--corpus"]
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no card")
    runs = []
    for root in roots:
        cmd = [sys.executable, os.path.abspath(__file__), "--worker", root] + (["--corpus"] if corpus else [])
        out = subprocess.run(cmd, capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]))
    same = True
    for key, value in runs[0].items():
        if isinstance(value, dict) and "bits" in value:
            equal = len({r[key]["bits"] for r in runs}) == 1
            same &= equal
            print(f"{key}: bits the same in every checkout {equal}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
