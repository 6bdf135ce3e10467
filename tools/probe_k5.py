#!/usr/bin/env python3
"""K5's grouped kernel by device time, against variants made from its text
and against the kernel it replaced, on one GPU.

    python3 tools/probe_k5.py [PARENT_ROOT]

Builds, with one ``nvcc`` each, all started together, into libraries of
their own in a temporary directory:

- ``shipped``: ``osqp_tpu_torch/csrc/ell_ops.cu`` as it stands;
- ``one_path``: the same with ``group_kernel``'s dispatch cut to the
  kSum path of three slots (the sparse path's A), for what the dispatch
  over modes and slot counts costs;
- ``bounds4``: the same with ``__launch_bounds__(kThreads, 4)`` on
  ``group_kernel`` (at most 64 registers a thread);
- ``no_ldg``: the same with plain loads in place of the read-only path;
- ``job_copy``: the same with the CTA's job copied out of parameter
  space (a copy a thread, in local memory) instead of read in place;
- ``parent``: ``PARENT_ROOT``'s ``ell_ops.cu`` where given (a checkout
  unpacked with ``git archive``), whose ``osqp_ell_reduce`` launched one
  product per launch.

Then, in float64, A x (k = 3) at CVXQP2_L (B = 1) and at CVXQP2_M's
scenario batch (B = 64), each build's device time per launch under
``torch.profiler`` (200 launches, bits held to ``ell_matvec_plain``), the
shipped build at several plans (rows, ipar, run) named to its C entry
``osqp_ell_group``, the others at ``ops.ell.plan``'s; and P x with A x in
one launch of the shipped build at B = 64 and at 1000 copies of CVXQP2_M's
first instance, by the CTAs per SM that ``plan`` aims at (1, 2, 4, 8:
CTAs of several groups of instances stream them through the bulk-copy
ring) and with one group a CTA (values straight from device memory),
beside the bound.  Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

CSRC = ROOT / "osqp_tpu_torch" / "csrc"
DISPATCH = "  switch (job.mode) {"
BOUNDS = "__global__ void __launch_bounds__(kThreads) group_kernel"
LDG = "  return __ldg(p);"
JOB = "  const Job<T>& job = jobs.job[sel];"
PLANS = {1: [(32, 1, 1), (64, 1, 1), (128, 1, 1), (256, 1, 1)],
         64: [(32, 8, 8), (32, 8, 16), (64, 4, 4), (128, 2, 2), (256, 1, 1), (256, 1, 2)]}


def variants(work: pathlib.Path) -> dict:
    text = (CSRC / "ell_ops.cu").read_text()
    for marker in (DISPATCH, BOUNDS, LDG, JOB):
        if text.count(marker) != 1:
            raise RuntimeError(f"ell_ops.cu has not one {marker!r} to replace")
    a = text.index(DISPATCH)
    b = text.index("\n  }\n", a) + len("\n  }\n")
    one = text[:a] + "  tile_fixed<T, kSum, 3>(job, jobs.rows, jobs.ipar, r0, r1, b0, b1, smem);\n" + text[b:]
    out = {"shipped": CSRC / "ell_ops.cu"}
    for name, src in (("one_path", one), ("bounds4", text.replace(BOUNDS, BOUNDS.replace("(kThreads)",
                                                                                      "(kThreads, 4)"))),
                      ("no_ldg", text.replace(LDG, "  return *p;")),
                      ("job_copy", text.replace(JOB, "  const Job<T> job = jobs.job[sel];"))):
        out[name] = work / f"{name}.cu"
        out[name].write_text(src)
    return out


def build(work: pathlib.Path, parent: pathlib.Path | None) -> dict:
    from osqp_tpu_torch import _build

    nvcc = _build._nvcc()
    jobs = {}
    for name, src in variants(work).items():
        jobs[name] = (src, CSRC)
    if parent is not None:
        jobs["parent"] = (parent / "osqp_tpu_torch" / "csrc" / "ell_ops.cu", parent / "osqp_tpu_torch" / "csrc")
    procs = {}
    for name, (src, inc) in jobs.items():
        lib = work / f"{name}.so"
        cmd = [nvcc, *_build.NVCC_FLAGS, f"-I{inc}", "-shared", "-o", str(lib), str(src), str(inc / "common.cu")]
        procs[name] = (lib, cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (path, cmd, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{err}")
        lib = ctypes.CDLL(str(path))
        fn = "osqp_ell_reduce" if name == "parent" else "osqp_ell_group"
        sig = (ctypes.c_int, ctypes.c_int) + (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 4 + (ctypes.c_void_p,) \
            if name == "parent" else _build._SIGNATURES[fn]
        getattr(lib, fn).argtypes = sig
        getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from osqp_tpu_torch.ops import ell as k5

    parent = pathlib.Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else None
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(pathlib.Path(tmp), parent)
        for name, B in (("CVXQP2_L", 1), ("CVXQP2_M", 64)):
            A = cs.sparse_prepared(name, "float64", dev, B)[2].A
            m, n = A.shape
            k = A.idx.shape[1]
            x = torch.randn((B, n), dtype=A.dtype, device=dev)
            want = k5.ell_matvec_plain(A, x)
            out = torch.empty_like(want)
            stream = torch.cuda.current_stream().cuda_stream

            def group(lib, rows, ipar, run):
                tiles, runs = -(-m // rows), -(-B // run)
                words = (ctypes.c_longlong * 11)(A.val.data_ptr(), A.idx.data_ptr(), x.data_ptr(), 0,
                                                 out.data_ptr(), m, k, n, 0, tiles, 0)
                return lambda: lib.osqp_ell_group(1, words, 1, B, rows, ipar, run, tiles * runs, stream)

            def timed(launch):
                out.zero_()
                code = launch()
                torch.cuda.synchronize()
                if code != 0 or not torch.equal(out, want):
                    return f"failed (code {code}, bits equal {torch.equal(out, want)})"
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(200):
                        launch()
                    torch.cuda.synchronize()
                ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
                return f"{sum(e.time_range.elapsed_us() for e in ev) / 200 / 1e3:.4f} ms"

            p = k5.plan((m,), B, sms)
            label = f"A x {name} B={B} m={m} k={k} float64"
            print(f"{label}, ops.ell.plan: rows {p.rows}, ipar {p.ipar}, run {p.run}, {p.ctas} CTAs")
            for lname, lib in libs.items():
                if lname == "parent":
                    launch = lambda: lib.osqp_ell_reduce(1, 0, A.val.data_ptr(), A.idx.data_ptr(), x.data_ptr(), 0,
                                                         out.data_ptr(), B, m, k, n, stream)
                    print(f"  parent reduce_kernel: {timed(launch)}")
                    continue
                print(f"  {lname} at the plan: {timed(group(lib, p.rows, p.ipar, p.run))}")
            for rows, ipar, run in PLANS[B]:
                print(f"  shipped rows {rows} ipar {ipar} run {run}: {timed(group(libs['shipped'], rows, ipar, run))}")
        pair_sweep(libs["shipped"], dev, sms, timed_launch)
    return 0


def timed_launch(launch, outs, wants, reps=50):
    """Device ms per call of ``launch`` under the profiler, after one call
    whose outputs must equal ``wants`` bit for bit."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for o in outs:
        o.zero_()
    code = launch()
    torch.cuda.synchronize()
    if code != 0 or not all(torch.equal(o, w) for o, w in zip(outs, wants)):
        return f"failed (code {code})"
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            launch()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return f"{sum(e.time_range.elapsed_us() for e in ev) / reps / 1e3:.4f} ms"


def pair_sweep(lib, dev, sms, timed) -> None:
    """P x with A x in one launch at B = 64 and 1000 by plan."""
    import dataclasses

    import torch

    import chip_smoke as cs
    from osqp_tpu_torch.ops import ell as k5

    _, _, scaled, *_ = cs.sparse_prepared("CVXQP2_M", "float64", dev, 64)
    big = lambda E: dataclasses.replace(E, val=E.val[:1].expand(1000, -1, -1).contiguous(),
                                        t_val=E.t_val[:1].expand(1000, -1, -1).contiguous())
    stream = torch.cuda.current_stream().cuda_stream
    for B, P, A in ((64, scaled.P, scaled.A), (1000, big(scaled.P), big(scaled.A))):
        m, n = A.shape
        x = torch.randn((B, n), dtype=A.dtype, device=dev)
        wants = (k5.ell_matvec_plain(P, x), k5.ell_matvec_plain(A, x))
        outs = tuple(torch.empty_like(w) for w in wants)

        def launch_of(p):
            words = []
            for E, out, t, c0 in zip((P, A), outs, p.tiles, p.cta0):
                words += (E.val.data_ptr(), E.idx.data_ptr(), x.data_ptr(), 0, out.data_ptr(), E.shape[0],
                          E.idx.shape[1], n, 0, t, c0)
            arr = (ctypes.c_longlong * len(words))(*words)
            return lambda: lib.osqp_ell_group(1, arr, 2, B, p.rows, p.ipar, p.run, p.ctas, stream)

        cells = []
        for cps in (1, 2, 4, 8):
            p = k5.plan((n, m), B, sms, cps)
            cells.append(f"{cps}: {timed(launch_of(p), outs, wants)} ({p.ctas} CTAs, runs of {p.run})")
        p = k5.plan((n, m), B, sms)
        one = p._replace(run=p.ipar, cta0=(0, p.tiles[0] * -(-B // p.ipar)), ctas=sum(p.tiles) * -(-B // p.ipar))
        cells.append(f"one group a CTA: {timed(launch_of(one), outs, wants)} ({one.ctas} CTAs)")
        nbytes, flops = cs.k5_pair_cost(P, A, B)
        print(f"P x with A x CVXQP2_M B={B} float64 ({p.rows} rows x {p.ipar} instances a CTA), device time by the "
              f"CTAs an SM plan aims at: {'; '.join(cells)}; bound {cs.bound(nbytes, flops)[0]:.4f} ms")


if __name__ == "__main__":
    sys.exit(main())
