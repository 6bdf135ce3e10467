#!/usr/bin/env python3
"""Where K7's time goes above the cluster path's reach, on one GPU: the
device-path factor and the wide solve, by phase.

    python3 tools/probe_k7_wide.py

Builds ``osqp_tpu_torch/csrc/block_tridiag.cu`` (with ``common.cu``) as it
stands, with -DOSQP_STAMPS, and with the device path in CTAs of 256
threads (``threads256``, the cluster path's), three ``nvcc`` started
together, each into a library of its own in a temporary directory.
Then, for each case of CASES (the large-stage batches' shapes, B = 4,
Nb = 3), it makes a random band matrix (chip_smoke.py's band_schur),
factors it on the path ``factor_path`` names, and checks that each build
gives the plain version's bits for the factor and the wide solve; times
each build's factor and solve by CUDA events (the stamps build shows the
stamps' own cost), and the shipped build's solve in CTAs of 2, 4, 8 and
12 warps (named to its C entry, ``osqp_bt_solve``); and prints the
stamps build's cycles a launch by phase: the factor's thread 0 of CTAs 0
and k - 1 of the first instance (csrc/block_tridiag.cu:
cluster_factor_kernel), and warp 0 of the wide solve's first instance
(wide_solve_kernel: the forward pass's phases, then the backward
pass's), with the SM clock.  Imports nothing of JAX.
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
FACTOR_PHASES = ("load", "G fetch", "G earlier columns", "G panel", "G store, barrier", "S fetch", "S update",
                 "first diagonal block", "panel solve", "panel barrier", "panel fetch",
                 "trailing update and next diagonal block", "stage end")
SOLVE_PHASES = ("stage start", "panel rows", "column steps", "stores", "round barrier")
CASES = [("float32", 140), ("float64", 99), ("float64", 362), ("float32", 559)]
# the variant: the device path in CTAs of 256 threads, as the cluster path
THREADS = "constexpr int kDeviceThreads = 512;"
THREADS_256 = "constexpr int kDeviceThreads = 256;"


def build(work: pathlib.Path) -> dict:
    from osqp_tpu_torch import _build

    nvcc = _build._nvcc()
    jobs = {}
    text = (CSRC / "block_tridiag.cu").read_text()
    if text.count(THREADS) != 1:
        raise RuntimeError("block_tridiag.cu has not the device path's thread count to replace")
    (work / "threads256.cu").write_text(text.replace(THREADS, THREADS_256))
    for name, flags, src in (("shipped", [], CSRC / "block_tridiag.cu"),
                             ("stamps", ["-DOSQP_STAMPS"], CSRC / "block_tridiag.cu"),
                             ("threads256", [], work / "threads256.cu")):
        lib = work / f"{name}.so"
        cmd = [nvcc, *_build.NVCC_FLAGS, *flags, f"-I{CSRC}", "-shared", "-o", str(lib), str(src),
               str(CSRC / "common.cu")]
        jobs[name] = (lib, cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (path, cmd, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{err}")
        lib = ctypes.CDLL(str(path))
        for fn in ("osqp_bt_factor", "osqp_bt_solve"):
            getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    libs["stamps"].osqp_bt_stamps.argtypes = (ctypes.c_void_p, ctypes.c_int)
    libs["stamps"].osqp_bt_stamps.restype = ctypes.c_int
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_k7_wide: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from osqp_tpu_torch import _build
    from osqp_tpu_torch.ops import block_tridiag as k7

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    dev = torch.device("cuda", 0)
    sms = _build.sm_count(dev)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(pathlib.Path(tmp))
        for name, b in CASES:
            dtype = getattr(torch, name)
            B, Nb = 4, 3
            M, r = chip_smoke.band_schur(B, Nb, b, dtype, dev)
            path = k7.factor_path(b, dtype)
            k = k7.cluster_plan(b, B, dtype, sms) if path == "cluster" else k7.device_plan(B, sms)
            spill = k7.device_scratch(b, dtype) if path == "device" else 0
            scratch = torch.empty(max(1, B * k * spill), dtype=dtype, device=dev)
            _, warps = k7.solve_plan(b, dtype)
            code = _build.dtype_code(dtype)

            def factor(lib):
                C = torch.empty((B, Nb, b, b), dtype=dtype, device=dev)
                G = torch.empty((B, Nb - 1, b, b), dtype=dtype, device=dev)
                err = lib.osqp_bt_factor(code, M.data_ptr(), C.data_ptr(), G.data_ptr(), scratch.data_ptr(), B, b, Nb,
                                         1 if path == "cluster" else 2, k, _build.stream())
                if err:
                    raise RuntimeError(f"factor launch failed: {err}")
                return C, G

            def solve(lib, C, G, w=warps):
                x = torch.empty_like(r)
                err = lib.osqp_bt_solve(code, C.data_ptr(), G.data_ptr(), r.data_ptr(), x.data_ptr(), None, B, b, Nb,
                                        w, _build.stream())
                if err:
                    raise RuntimeError(f"solve launch failed: {err}")
                return x

            Cp, Gp = k7.bt_factor_plain(M, b)
            xp = k7.bt_solve_plain(Cp, Gp, r)
            same, times = {}, {}
            for lib_name, lib in libs.items():
                C, G = factor(lib)
                x = solve(lib, C, G)
                torch.cuda.synchronize()
                same[lib_name] = torch.equal(C, Cp) and torch.equal(G, Gp) and torch.equal(x, xp)
                times[lib_name] = (round(chip_smoke.cuda_ms(lambda: factor(lib), 5), 4),
                                   round(chip_smoke.cuda_ms(lambda: solve(lib, C, G), 20), 4))
            label = f"b={b} B={B} Nb={Nb} {name}, factor on the {path} path (clusters of {k}), solve in CTAs of {warps} warps"
            print(f"{label}: bits of the plain versions {same}; (factor ms, solve ms) {times}")
            C, G = factor(libs["shipped"])
            by_warps = {}
            for w in (2, 4, 8, 12):
                x = solve(libs["shipped"], C, G, w)
                torch.cuda.synchronize()
                by_warps[w] = (bool(torch.equal(x, xp)), round(chip_smoke.cuda_ms(lambda: solve(libs["shipped"], C, G, w),
                                                                                   20), 4))
            print(f"  solve by warps a CTA (bits of the plain version, ms): {by_warps}")
            lib = libs["stamps"]
            out = (ctypes.c_ulonglong * 32)()
            C, G = factor(lib)
            solve(lib, C, G)
            torch.cuda.synchronize()
            lib.osqp_bt_stamps(out, 0)
            lib.osqp_bt_stamps(out, 1)
            reps = 5
            for _ in range(reps):
                factor(lib)
            torch.cuda.synchronize()
            if lib.osqp_bt_stamps(out, 0):
                raise RuntimeError("reading the stamps failed")
            clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                                   capture_output=True, text=True).stdout.strip()
            for cta, row in (("CTA 0", 0), (f"CTA {k - 1}", 1)):
                cyc = [out[16 * row + i] / reps for i in range(len(FACTOR_PHASES))]
                print(f"  factor {cta}: cycles a launch by phase {({p: int(c) for p, c in zip(FACTOR_PHASES, cyc)})}, "
                      f"total {int(sum(cyc))} (SM clock {clock} MHz)")
            for _ in range(reps):
                solve(lib, C, G)
            torch.cuda.synchronize()
            if lib.osqp_bt_stamps(out, 1):
                raise RuntimeError("reading the stamps failed")
            cyc = [out[i] / reps for i in range(10)]
            fwd = {p: int(c) for p, c in zip(SOLVE_PHASES, cyc[:5])}
            bwd = {p: int(c) for p, c in zip(SOLVE_PHASES, cyc[5:])}
            print(f"  solve warp 0: cycles a launch by phase, forward {fwd}, backward {bwd}, total {int(sum(cyc))} "
                  f"(SM clock {clock} MHz)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
