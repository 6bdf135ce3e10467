#!/usr/bin/env python3
"""K6's device loop by phase and by build, on one card.

    python3 tools/probe_k6.py

Builds ``csrc/cg.cu`` (with ``common.cu``) as it is and with
``-DOSQP_STAMPS``, each into a library of its own, and runs each build's
``osqp_cg_loop`` at the cases of ``tools/ab_k6.py`` (CVXQP2_L's cg
system, LISWET1's polish systems) with the default plan (``ops.cg``'s)
and, in the plain build, the plan's cluster in every mode that fits.  It
prints, per case, build and plan: the device ms per CG step (CUDA events
around the launch alone, median of 5), whether x and the steps equal the
library's loop, and for the stamps build the cycles per CG step of each
phase in CTA 0 and in the last CTA of the first cluster (``cg.cu``:
``cg_stamps``).  Builds take about a minute on the card's machine.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))
CSRC = ROOT / "osqp_tpu_torch" / "csrc"

PHASES = ("fetch and load", "A p", "A p barrier", "Mp", "Mp push", "Mp wait", "alpha", "update", "update push",
          "update wait", "beta", "p", "p barrier", "store")
# build -> its extra nvcc flags
BUILDS = {"shipped": [], "stamps": ["-DOSQP_STAMPS"]}
# modes of the default plan's cluster that each build runs besides the
# default: (operands resident, vectors resident)
MODES = ((True, True), (False, True), (False, False))
CASES = ("CVXQP2_L/float64/cg", "LISWET1/float32/polish", "LISWET1/float64/polish")


def build(work: pathlib.Path) -> dict:
    from osqp_tpu_torch import _build

    nvcc = _build._nvcc()
    jobs, out = [], {}
    for name, flags in BUILDS.items():
        d = work / name
        d.mkdir()
        cmd = [nvcc, *_build.NVCC_FLAGS, *flags, "-shared", "-o", str(d / "lib.so"), str(CSRC / "cg.cu"),
               str(CSRC / "common.cu")]
        jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        out[name] = d / "lib.so"
    for cmd, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{err}")
    libs = {}
    for name, path in out.items():
        lib = ctypes.CDLL(str(path))
        lib.osqp_cg_loop.argtypes = _build._SIGNATURES["osqp_cg_loop"]
        lib.osqp_cg_loop.restype = ctypes.c_int
        if name == "stamps":
            lib.osqp_cg_stamps.argtypes = (ctypes.c_void_p,)
            lib.osqp_cg_stamps.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    import torch

    import ab_k6
    import chip_smoke
    from osqp_tpu_torch import _build
    from osqp_tpu_torch.ops import cg as k6

    if not torch.cuda.is_available():
        print("probe_k6: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    dev = torch.device("cuda", 0)
    _build.library()
    cases = ab_k6.make_cases(chip_smoke, dev)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(pathlib.Path(tmp))
        for label in CASES:
            op, sigma, dinv, b, tol, max_iter, x0 = cases[label]()
            xr, sr = k6.pcg_solve_loop(op, sigma, dinv, b, tol, max_iter, x0)
            plan = k6.last_plan
            start = k6._start(op, sigma, dinv, b, x0, tol)
            B, n = b.shape
            m = op.A.shape[0]
            P, A = op.P, op.A
            steps_n = int(sr.max())

            def run(lib, plan):
                x, r, z, p, rz, rr, tol2 = (t.clone() for t in start)
                steps = torch.zeros(B + 1, dtype=torch.int32, device=dev)
                Ap, Mp = torch.empty((B, m), dtype=b.dtype, device=dev), torch.empty_like(b)
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                code = lib.osqp_cg_loop(
                    _build.dtype_code(b.dtype), P.val.data_ptr(), P.idx.data_ptr(), P.idx.shape[1], A.val.data_ptr(),
                    A.idx.data_ptr(), A.idx.shape[1], A.t_val.data_ptr(), A.t_idx.data_ptr(), A.t_idx.shape[1],
                    op.w.data_ptr() if op.w is not None else 0, float(sigma),
                    float(op.div) if op.div is not None else 0.0, dinv.data_ptr(), tol2.data_ptr(), rz.data_ptr(),
                    rr.data_ptr(), x.data_ptr(), r.data_ptr(), z.data_ptr(), p.data_ptr(), Ap.data_ptr(),
                    Mp.data_ptr(), steps.data_ptr(), B, n, m, int(max_iter), plan.cluster, plan.threads,
                    int(plan.resident), int(plan.vectors), plan.clusters, _build.stream())
                e1.record()
                torch.cuda.synchronize()
                if code:
                    raise RuntimeError(f"launch failed: {code}")
                return x, steps[:B], e0.elapsed_time(e1)

            kp, ka, kt = P.idx.shape[1], A.idx.shape[1], A.t_idx.shape[1]
            plans = [plan]
            for resident, vectors in MODES:
                smem = k6.loop_smem(n, m, kp, ka, kt, plan.cluster, resident, vectors, b.element_size())
                other = dataclasses.replace(plan, resident=resident, vectors=vectors, smem=smem)
                if smem <= _build.SMEM_BYTES and other not in plans:
                    plans.append(other)
            for name, lib in libs.items():
                for each in plans if name != "stamps" else plans[:1]:
                    x, steps, _ = run(lib, each)
                    same = bool(torch.equal(x, xr) and torch.equal(steps, sr))
                    row = dict(case=label, build=name, plan=dataclasses.asdict(each), steps=steps_n, same_bits=same)
                    if name == "stamps":
                        table = (ctypes.c_ulonglong * 32)()
                        lib.osqp_cg_stamps(table)  # the first run's cycles
                        row["cycles_per_step"] = {
                            cta: {ph: round(table[i * 16 + j] / steps_n, 1) for j, ph in enumerate(PHASES)}
                            for i, cta in enumerate(("CTA 0", "last CTA"))}
                    ms = [run(lib, each)[2] for _ in range(5)]
                    row.update(ms_per_step=statistics.median(ms) / steps_n, ms=ms)
                    if name == "stamps":
                        lib.osqp_cg_stamps(table)
                    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
