#!/usr/bin/env python3
"""What sets the time of K3 (term_products) at the headline, on one GPU.

    python3 tools/probe_k3.py

Builds ``osqp_tpu_torch/csrc/term_products.cu`` as it stands and in
variants made from its text (each replacement must match exactly once),
one ``nvcc`` per variant, all started together, each into a library of
its own in a temporary directory:

- ``shipped``: the source as it is;
- ``nocap``: launch bounds without a minimum of blocks an SM (the source
  asks for four in float32, two in float64);
- ``lb3``: launch bounds asking for three blocks an SM in float32;
- ``nounroll``: the row loop not unrolled (the source unrolls it by 2).

Then it times each variant by CUDA events (mean of 50 warm calls, in
three interleaved rounds, the median printed) on chip_smoke.py's K3
operands: the headline (B=8192, n=100, m=200, float32, Ruiz-scaled)
without and with the certificate products, and CVXQP2_M (B=1, float64)
with them.  Prints the card, then a line per case, with whether every
variant gives the shipped bits.  Imports nothing of JAX.
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

SOURCE = ROOT / "osqp_tpu_torch" / "csrc" / "term_products.cu"

NOCAP = (("__launch_bounds__(kThreads, sizeof(T) == 4 ? 4 : 2) products_kernel",
          "__launch_bounds__(kThreads) products_kernel"),)
NOUNROLL = (("#pragma unroll 2\n  for (int r = r0 + w; r < r1; r += kWarps) {",
             "  for (int r = r0 + w; r < r1; r += kWarps) {"),)
LB3 = (("__launch_bounds__(kThreads, sizeof(T) == 4 ? 4 : 2) products_kernel",
        "__launch_bounds__(kThreads, sizeof(T) == 4 ? 3 : 2) products_kernel"),)
VARIANTS = {"shipped": (), "nocap": NOCAP, "lb3": LB3, "nounroll": NOUNROLL}


def variant_source(text: str, replacements) -> str:
    for old, new in replacements:
        if text.count(old) != 1:
            raise RuntimeError(f"a replacement does not match term_products.cu exactly once: {old}")
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
        lib.osqp_term_products.argtypes = _build._SIGNATURES["osqp_term_products"]
        lib.osqp_term_products.restype = ctypes.c_int
        lib.osqp_term_products_scratch.argtypes = (ctypes.c_int,) * 7
        lib.osqp_term_products_scratch.restype = ctypes.c_longlong
        libs[name] = lib
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_k3.py needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from osqp_tpu_torch import _build
    from osqp_tpu_torch.ops import ruiz as k4

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(f"card: {smi.stdout.strip()}")
    H = cs.HEADLINE
    cases = [("headline float32", cs.make_qps(H["B"], H["n"], H["m"]), torch.float32, (False, True)),
             ("CVXQP2_M float64", cs.maros_dense("CVXQP2_M"), torch.float64, (True,))]
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(pathlib.Path(tmp))
        for label, arrays, dtype, certs in cases:
            _, _, _, P, _, A, _, _ = k4.ruiz(*cs.on_device(arrays, dtype, dev), 10)
            B, n, m = P.shape[0], P.shape[1], A.shape[1]
            x, y, dx, dy = cs._random_state(B, n, m, dtype, dev)
            _, rows_a, rows_p = _build.split_geometry(B, n, m, dev)
            for cert in certs:
                k = 2 if cert else 1
                outs = {name: torch.empty(k * B * (m + 2 * n), dtype=dtype, device=dev) for name in libs}
                scratch = {}
                for name, lib in libs.items():
                    nbytes = lib.osqp_term_products_scratch(_build.dtype_code(dtype), B, n, m, rows_a, rows_p, k)
                    scratch[name] = torch.zeros(max(nbytes, 1), dtype=torch.uint8, device=dev)

                def call(name):
                    o = outs[name]
                    base, elt = o.data_ptr(), o.element_size()
                    rc = libs[name].osqp_term_products(
                        _build.dtype_code(dtype), P.data_ptr(), A.data_ptr(), x.data_ptr(), y.data_ptr(),
                        dx.data_ptr() if cert else 0, dy.data_ptr() if cert else 0, base, base + elt * k * B * m,
                        base + elt * k * B * (m + n), scratch[name].data_ptr(), B, n, m, rows_a, rows_p,
                        _build.stream())
                    if rc:
                        raise RuntimeError(f"{name}: CUDA error {rc}")

                for name in libs:
                    call(name)
                torch.cuda.synchronize()
                same = all(torch.equal(outs[name], outs["shipped"]) for name in libs)
                times = {name: [] for name in libs}
                for _ in range(3):
                    for name in libs:
                        times[name].append(cs.cuda_ms(lambda: call(name), reps=50))
                print(f"{label} B={B} n={n} m={m}{' with certificates' if cert else ''}: "
                      + "; ".join(f"{name} {statistics.median(times[name]):.4f} ms" for name in libs)
                      + f"; every variant bit-identical to shipped {same}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
