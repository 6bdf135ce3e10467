#!/usr/bin/env python3
"""K7's cluster path on one GPU: its bits launch after launch, and its
time, in variants of its cluster barrier.

    python3 tools/probe_k7_cluster.py

Builds ``osqp_tpu_torch/csrc/block_tridiag.cu`` (with ``common.cu``) as it
stands and in variants made from its text, one ``nvcc`` per variant, all
started together, each into a library of its own in a temporary
directory:

- ``shipped``: the source as it is (``osqp_cuda::cluster_barrier``: an
  arrive with release and a wait with acquire semantics at cluster
  scope);
- ``fence_cta``: K8's form in its place, a CTA-scope fence and a relaxed
  arrive;
- ``fence_cluster``: a cluster-scope fence before the relaxed arrive;
- ``rolled``: the column loops of the diagonal block's factor and of
  the row solves rolled (``#pragma unroll 1``) where the source unrolls
  them;
- ``stamps``: the source as it is with -DOSQP_STAMPS, which stamps the
  cycles of each phase in thread 0 of CTAs 0 and k - 1 of the first
  instance (csrc/cluster.cuh).

Then it factors random band matrices (chip_smoke.py's band_schur) on the
cluster path at each (b, B, clusters of k) of CASES, 20 launches each,
and counts the launches whose C or G differ from the plain version's
bits; times each variant at b = 140, B = 4, Nb = 3 (clusters of 16
and of 2) in interleaved rounds; and prints the stamps variant's cycles
by phase per launch at b = 140, B = 4 (float32) and b = 99, B = 4
(float64), clusters of 16, with the SM clock.  Prints the card and, per
variant, the mismatches and the median times.  Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import pathlib
import statistics
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

CSRC = ROOT / "osqp_tpu_torch" / "csrc"
SYNC = "osqp_cuda::cluster_barrier();"
FENCE_CTA = ('asm volatile("fence.acq_rel.cta;\\n" ::: "memory"); '
             'asm volatile("barrier.cluster.arrive.relaxed.aligned;\\n" ::: "memory"); '
             'asm volatile("barrier.cluster.wait.acquire.aligned;\\n" ::: "memory");')
FENCE = ('asm volatile("fence.acq_rel.cluster;\\n" ::: "memory"); '
         'asm volatile("barrier.cluster.arrive.relaxed.aligned;\\n" ::: "memory"); '
         'asm volatile("barrier.cluster.wait.acquire.aligned;\\n" ::: "memory");')
UNROLLED = "#pragma unroll\n  for (int jj = 0; jj < kPanel; ++jj) {\n    if (jj >= kb) break;"
ROLLED = "#pragma unroll 1\n  for (int jj = 0; jj < kb; ++jj) {"
VARIANTS = {"shipped": None, "fence_cta": FENCE_CTA, "fence_cluster": FENCE, "rolled": None, "stamps": None}
PHASES = ("load", "G fetch", "G earlier columns", "G panel", "G store, barrier", "S fetch", "S update",
          "first diagonal block", "panel solve", "panel barrier",
          "panel fetch", "trailing update and next diagonal block", "stage end")
CASES = [(140, 4, 16), (140, 4, 2), (256, 4, 16), (256, 4, 8), (256, 4, 4), (256, 9, 8), (466, 2, 16)]


def build(work: pathlib.Path) -> dict:
    from osqp_tpu_torch import _build

    nvcc = _build._nvcc()
    jobs, out = [], {}
    for name, sync in VARIANTS.items():
        d = work / name
        d.mkdir()
        text = (CSRC / "block_tridiag.cu").read_text()
        if sync is not None:
            if SYNC not in text:
                raise RuntimeError("block_tridiag.cu has no cluster barrier to replace")
            text = text.replace(SYNC, sync)
        if name == "rolled":
            if text.count(UNROLLED) != 2:
                raise RuntimeError("block_tridiag.cu has not the two unrolled column loops")
            text = text.replace(UNROLLED, ROLLED)
        (d / "block_tridiag.cu").write_text(text)
        for f in ("common.cuh", "cluster.cuh", "common.cu"):
            (d / f).write_text((CSRC / f).read_text())
        lib = d / "lib.so"
        flags = ["-DOSQP_STAMPS"] if name == "stamps" else []
        cmd = [nvcc, *_build.NVCC_FLAGS, *flags, "-shared", "-o", str(lib), str(d / "block_tridiag.cu"),
               str(d / "common.cu")]
        jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        out[name] = lib
    for cmd, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{err}")
    libs = {}
    for name, path in out.items():
        lib = ctypes.CDLL(str(path))
        lib.osqp_bt_factor.argtypes = _build._SIGNATURES["osqp_bt_factor"]
        lib.osqp_bt_factor.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    import torch

    import chip_smoke
    from osqp_tpu_torch import _build
    from osqp_tpu_torch.ops import block_tridiag as k7

    if not torch.cuda.is_available():
        print("probe_k7_cluster: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(pathlib.Path(tmp))

        def factor(lib, M, b, k):
            B, n, _ = M.shape
            Nb = n // b
            C = torch.empty((B, Nb, b, b), dtype=M.dtype, device=dev)
            G = torch.empty((B, Nb - 1, b, b), dtype=M.dtype, device=dev)
            code = lib.osqp_bt_factor(_build.dtype_code(M.dtype), M.data_ptr(), C.data_ptr(), G.data_ptr(), None, B, b,
                                      Nb, 1, k, _build.stream())
            if code:
                raise RuntimeError(f"launch failed: {code}")
            return C, G

        for dtype in (torch.float32, torch.float64):
            for b, B, k in CASES:
                if not k7.cluster_fits(b, k, dtype):
                    continue
                M, _ = chip_smoke.band_schur(B, 3, b, dtype, dev)
                Cp, Gp = k7.bt_factor_plain(M, b)
                row = []
                for name, lib in libs.items():
                    bad = 0
                    for _ in range(20):
                        C, G = factor(lib, M, b, k)
                        torch.cuda.synchronize()
                        bad += not (torch.equal(C, Cp) and torch.equal(G, Gp))
                    row.append(f"{name} {bad}/20")
                print(f"b={b} B={B} clusters of {k} {chip_smoke.dtype_name(dtype)}: launches off the plain bits: "
                      f"{', '.join(row)}")

        M, _ = chip_smoke.band_schur(4, 3, 140, torch.float32, dev)
        for k in (16, 2):
            times = {name: [] for name in libs}
            for _ in range(5):
                for name, lib in libs.items():
                    times[name].append(chip_smoke.cuda_ms(lambda: factor(lib, M, 140, k), 20))
            print(f"b=140 B=4 Nb=3 float32, clusters of {k}: median ms "
                  f"{({n: round(statistics.median(t), 4) for n, t in times.items()})}")

        lib = libs["stamps"]
        lib.osqp_bt_stamps.argtypes = (ctypes.c_void_p, ctypes.c_int)
        lib.osqp_bt_stamps.restype = ctypes.c_int
        out = (ctypes.c_ulonglong * 32)()
        for dtype, b in ((torch.float32, 140), (torch.float64, 99)):
            M, _ = chip_smoke.band_schur(4, 3, b, dtype, dev)
            factor(lib, M, b, 16)
            torch.cuda.synchronize()
            lib.osqp_bt_stamps(out, 0)
            reps = 10
            for _ in range(reps):
                factor(lib, M, b, 16)
            torch.cuda.synchronize()
            if lib.osqp_bt_stamps(out, 0):
                raise RuntimeError("reading the stamps failed")
            clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                                   capture_output=True, text=True).stdout.strip()
            for cta, row in (("CTA 0", 0), ("CTA 15", 1)):
                cyc = [out[16 * row + i] / reps for i in range(len(PHASES))]
                print(f"b={b} B=4 Nb=3 {chip_smoke.dtype_name(dtype)}, clusters of 16, {cta}: cycles a launch by phase "
                      f"{({p: int(c) for p, c in zip(PHASES, cyc)})}, total {int(sum(cyc))} (SM clock {clock} MHz)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
