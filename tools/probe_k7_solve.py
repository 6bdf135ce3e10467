#!/usr/bin/env python3
"""What sets the time of K7's warp solve at the MPC cell, on one GPU.

    python3 tools/probe_k7_solve.py

Builds ``osqp_tpu_torch/csrc/block_tridiag.cu`` as it stands and in
variants made from its text (each replacement must match exactly once),
one ``nvcc`` per variant, all started together, each into a library of
its own in a temporary directory:

- ``shipped``: the source as it is (at column step j every lane takes
  entry j and the diagonal C[j][j] from lane j and divides them itself);
- ``stage0``: every stage's rows and columns of C and G read from stage
  0's blocks, so the solve runs the same arithmetic with the next
  stage's loads hitting the L1 cache (or hoisted out of the loop)
  instead of reaching L2 or device memory (its x is not the solution,
  only finite);
- ``branch``: lane j alone divides, behind a branch, and the quotient
  goes to the other lanes by shuffle (the form before);
- ``branch_stage0``: both;
- ``lane_j``: every lane divides, by 1 where it is not lane j, and lane
  j's quotient goes out by shuffle.

Then it takes C and G of the MPC cell's reduced matrix (B=1000, b=12,
Nb=31, float32, as chip_smoke.py's k7 phase builds them) and of its
first 64 instances in float64, and times each variant's solve by CUDA
events in interleaved rounds: warm (mean of 50 calls, C and G resident
in the 50 MB L2) and with the L2 flushed before each call (mean of 20).
Prints the card, the medians over the rounds, and whether each variant
gives the shipped solve's bits (``branch`` and ``lane_j`` must).
Imports nothing of JAX.
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

SOURCE = ROOT / "osqp_tpu_torch" / "csrc" / "block_tridiag.cu"

STAGE0 = (
    ("cr[t] = own && t < b ? Ci[static_cast<size_t>(i) * bb + r * b + t] : T(0);",
     "cr[t] = own && t < b ? Ci[r * b + t] : T(0);"),
    ("gr[t] = own && t < b && i > 0 ? Gi[static_cast<size_t>(i - 1) * bb + r * b + t] : T(0);",
     "gr[t] = own && t < b && i > 0 ? Gi[r * b + t] : T(0);"),
    ("cc[t] = own && t < b ? Ci[static_cast<size_t>(i) * bb + t * b + r] : T(0);",
     "cc[t] = own && t < b ? Ci[t * b + r] : T(0);"),
    ("gc[t] = own && t < b && i + 1 < Nb ? Gi[static_cast<size_t>(i) * bb + t * b + r] : T(0);",
     "gc[t] = own && t < b && i + 1 < Nb ? Gi[t * b + r] : T(0);"),
)
NEW_Y = "const T yj = quot(__shfl_sync(kFull, v, j), __shfl_sync(kFull, c[j], j));"
NEW_X = "const T xj = quot(__shfl_sync(kFull, v, j), __shfl_sync(kFull, c[j], j));"
BRANCH = (
    (NEW_Y, "const T yj = __shfl_sync(kFull, lane == j ? quot(v, c[j]) : T(0), j);"),
    (NEW_X, "const T xj = __shfl_sync(kFull, lane == j ? quot(v, c[j]) : T(0), j);"),
)
LANE_J = (
    (NEW_Y, "const T yj = __shfl_sync(kFull, quot(v, lane == j ? c[j] : T(1)), j);"),
    (NEW_X, "const T xj = __shfl_sync(kFull, quot(v, lane == j ? c[j] : T(1)), j);"),
)
VARIANTS = {"shipped": (), "stage0": STAGE0, "branch": BRANCH, "branch_stage0": BRANCH + STAGE0, "lane_j": LANE_J}


def variant_source(text: str, replacements) -> str:
    for old, new in replacements:
        if text.count(old) != 1:
            raise RuntimeError(f"a replacement does not match block_tridiag.cu exactly once: {old}")
        text = text.replace(old, new)
    return text


def build(work: pathlib.Path) -> dict:
    from osqp_tpu_torch import _build

    nvcc = _build._nvcc()
    text = SOURCE.read_text()
    jobs = {}
    for name, replacements in VARIANTS.items():
        src = work / f"{name}.cu"
        src.write_text(variant_source(text, replacements))
        cmd = [nvcc, *_build.NVCC_FLAGS, f"-I{SOURCE.parent}", "-shared", "-o", str(work / f"{name}.so"), str(src)]
        jobs[name] = (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (cmd, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{' '.join(cmd)}\n{err}")
        lib = ctypes.CDLL(str(work / f"{name}.so"))
        lib.osqp_bt_solve.argtypes = _build._SIGNATURES["osqp_bt_solve"]
        lib.osqp_bt_solve.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_k7_solve.py needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from osqp_tpu_torch import _build
    from osqp_tpu_torch.ops import block_tridiag as k7

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(f"card: {smi.stdout.strip()}")
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(pathlib.Path(tmp))
        for B, dtype in ((cs.MPC["B"], torch.float32), (64, torch.float64)):
            base, _, _, M = cs.mpc_prepared(B, dtype, dev)
            b = base.block_size
            Nb = M.shape[-1] // b
            C, G = k7.bt_factor(M, b)
            del M
            r = torch.randn(B, Nb * b, generator=torch.Generator(device=dev).manual_seed(7), dtype=dtype, device=dev)
            outs = {name: torch.empty_like(r) for name in libs}

            def call(name):
                code = libs[name].osqp_bt_solve(_build.dtype_code(dtype), C.data_ptr(), G.data_ptr(), r.data_ptr(),
                                                outs[name].data_ptr(), None, B, b, Nb, 0, _build.stream())
                if code:
                    raise RuntimeError(f"osqp_bt_solve ({name}) returned {code}")

            for name in libs:
                call(name)
            torch.cuda.synchronize()
            shipped = outs["shipped"]
            require_same = torch.equal(shipped, k7.bt_solve(C, G, r))
            warm = {name: [] for name in libs}
            cold = {name: [] for name in libs}
            for _ in range(5):
                for name in libs:
                    warm[name].append(cs.cuda_ms(lambda: call(name), reps=50))
                    cold[name].append(cs.cuda_ms_flushed(lambda: call(name), reps=20))
            label = f"MPC B={B} b={b} Nb={Nb} {cs.dtype_name(dtype)}"
            print(f"{label}: the shipped library's solve equals bt_solve's bits {require_same}")
            for name in libs:
                x = outs[name]
                print(f"  {name}: warm {statistics.median(warm[name]):.4f} ms (rounds "
                      f"{', '.join(f'{t:.4f}' for t in warm[name])}), L2 flushed {statistics.median(cold[name]):.4f} "
                      f"ms; x bit-identical to shipped {torch.equal(x, shipped)}, finite "
                      f"{bool(torch.isfinite(x).all())}, |x|max {float(x.abs().max()):.3e}")
            if not require_same or not all(torch.equal(outs[v], shipped) for v in ("branch", "lane_j")):
                print("probe_k7_solve.py: a variant that must keep the bits does not", file=sys.stderr)
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
