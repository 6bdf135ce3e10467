#!/usr/bin/env python3
"""Where the time of K1r's resident path goes, on one GPU.

    python3 tools/probe_k1r_resident.py

Builds ``osqp_tpu_torch/csrc/admm_iter_refined.cu`` as it stands and in
variants made from its text (each replacement must match exactly once),
one ``nvcc`` per variant, all started together, each into a library of
its own in a temporary directory:

- ``shipped``: the source as it is;
- ``ncorr0``: no correction step (the first solve, z~ and the updates
  alone), so that shipped minus ncorr0 is the corrections' cost;
- ``nocopy``: every instance computes on the slabs the first instance
  brought (no copy after the first, no wait), so that shipped minus
  nocopy is what the copies cost beyond the arithmetic;
- ``w8``: 8 warps a CTA at every n (the source takes 16 where n <=
  256);
- ``rows4``: the correction's pass over A taking 4 rows at a time at
  n <= 128 (8 in the source);
- ``stamps``: the source with clock64 stamps of CTA 0's thread 0 at the
  end of each phase of an instance, summed per phase over one call and
  printed as cycles and shares.

Then it times each variant's kernel by CUDA events (mean of 10 warm
calls, in three interleaved rounds, the median printed) on
chip_smoke.py's operands at the headline shape (B=8192, n=100, m=200) in
float32 with clusters of 1 and 2 and in float64 with clusters of 2
and 4, and at the MPC cell's shape (B=1000, n=372, m=612, float32) with
clusters of 8 (P read from device memory) and 16 (P resident).  Prints
the card, then a line per shape and cluster size.  Imports nothing of
JAX.
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

SOURCE = ROOT / "osqp_tpu_torch" / "csrc" / "admm_iter_refined.cu"

NCORR0 = (("const int ncorr = sizeof(T) == 4 ? 2 : 1;\n  const T sig = a.sigma",
           "const int ncorr = 0;\n  const T sig = a.sigma"),)
NOCOPY = (("      load_m(nb);\n", "\n"), ("      load_a(nb);\n", "\n"),
          ("mbar_wait(bar_a, phase);", "mbar_wait(bar_a, 0);"), ("mbar_wait(bar_m, phase);", "mbar_wait(bar_m, 0);"))
W8 = (("__host__ __device__ constexpr int resident_warps(int n) { return n <= 256 ? 16 : 8; }",
       "__host__ __device__ constexpr int resident_warps(int n) { return 8; }"),)
# Cycle stamps of CTA 0's thread 0, summed per phase over its instances
# (clock64 deltas into a device array the probe reads back).
PHASES = ("prologue", "wait A", "A'w", "wait Minv", "Minv't", "fused A pass", "P x~ and meet", "residual",
          "Minv'r", "z~ = A x~", "updates")
STAMPS = (
    ("  uint32_t phase = 0;\n  while (b < B) {",
     "  uint32_t phase = 0;\n  unsigned long long t_stamp = clock64();\n  while (b < B) {"),
    ("    const size_t nb = set ? b + G + (__ffs(set) - 1) * G : next_active(b + 33 * G);\n    __syncthreads();\n",
     "    const size_t nb = set ? b + G + (__ffs(set) - 1) * G : next_active(b + 33 * G);\n    __syncthreads();\n"
     "    K1R_STAMP(0);\n"),
    ("    mbar_wait(bar_a, phase);\n", "    mbar_wait(bar_a, phase);\n    K1R_STAMP(1);\n"),
    ("[&](int j, T s) { tv[j - n0] = add(tv[j - n0], s); }, nothing);\n",
     "[&](int j, T s) { tv[j - n0] = add(tv[j - n0], s); }, nothing);\n    K1R_STAMP(2);\n"),
    ("    mbar_wait(bar_m, phase);\n", "    mbar_wait(bar_m, phase);\n    K1R_STAMP(3);\n"),
    ("[&](int j, T s) { xt[j] = s; }, nothing);\n", "[&](int j, T s) { xt[j] = s; }, nothing);\n    K1R_STAMP(4);\n"),
    ("(sA, mm, n, xt, rho_s, reinterpret_cast<double*>(red));\n",
     "(sA, mm, n, xt, rho_s, reinterpret_cast<double*>(red));\n      K1R_STAMP(5);\n"),
    ("[&](int i, double v) { px[i] = v; }); });\n", "[&](int i, double v) { px[i] = v; }); });\n      K1R_STAMP(6);\n"),
    ("__dadd_rn(pxs, as[j])));\n      }\n      __syncthreads();\n",
     "__dadd_rn(pxs, as[j])));\n      }\n      __syncthreads();\n      K1R_STAMP(7);\n"),
    ("[&](int j, T s) { xt[j] = add(xt[j], s); }, nothing);\n",
     "[&](int j, T s) { xt[j] = add(xt[j], s); }, nothing);\n      K1R_STAMP(8);\n"),
    ("[&](int i, T v) { zt[i] = v; });\n    __syncthreads();\n",
     "[&](int i, T v) { zt[i] = v; });\n    __syncthreads();\n    K1R_STAMP(9);\n"),
    ("    phase ^= 1;\n    b = nb;\n    __syncthreads();\n", "    phase ^= 1;\n    b = nb;\n    __syncthreads();\n"
     "    K1R_STAMP(10);\n"),
    ("namespace {\n\nusing namespace osqp_cuda;",
     "__device__ unsigned long long k1r_stamps[16];\n"
     "#define K1R_STAMP(i) if (threadIdx.x == 0 && blockIdx.x == 0) { const unsigned long long t_ = clock64(); "
     "k1r_stamps[i] += t_ - t_stamp; t_stamp = t_; }\n"
     "extern \"C\" int k1r_stamps_read(unsigned long long* out) { "
     "return cudaMemcpyFromSymbol(out, k1r_stamps, sizeof(k1r_stamps)); }\n"
     "extern \"C\" int k1r_stamps_zero() { unsigned long long z[16] = {}; "
     "return cudaMemcpyToSymbol(k1r_stamps, z, sizeof(z)); }\n"
     "namespace {\n\nusing namespace osqp_cuda;"),
)
ROWS4 = (("slab_fused<kCols, kCols <= 4 ? 8 : 32 / kCols, kW>", "slab_fused<kCols, kCols <= 4 ? 4 : 32 / kCols, kW>"),)
VARIANTS = {"shipped": (), "ncorr0": NCORR0, "nocopy": NOCOPY, "w8": W8, "rows4": ROWS4, "stamps": STAMPS}


def variant_source(text: str, replacements) -> str:
    for old, new in replacements:
        if text.count(old) != 1:
            raise RuntimeError(f"a replacement does not match admm_iter_refined.cu exactly once: {old}")
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
        for fn in ("osqp_admm_iter_refined_resident", "osqp_admm_iter_refined_resident_clusters"):
            getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_k1r_resident.py needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from osqp_tpu_torch import _build

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(f"card: {smi.stdout.strip()}")

    def operands(arrays, dtype):
        P, q, A, l, u = cs.on_device(arrays, dtype, dev)
        scaled, rs, factor, dyn = cs.prepared(P, q, A, l, u)
        B, n, m = P.shape[0], P.shape[1], A.shape[1]
        x, z, dx, y = cs._random_state(B, n, m, dtype, dev, seed=2)
        y_lo = 1e-7 * torch.randn_like(z) if dtype == torch.float32 else None
        ins = (factor["Minv"], scaled.A, factor["P"], scaled.q, scaled.l, scaled.u, rs.rho_vec, rs.rho_inv_vec,
               torch.ones(B, dtype=torch.bool, device=dev), x, z, y, dx, torch.randn_like(z), y_lo)
        return ins, float(dyn.sigma), float(dyn.alpha), (B, n, m)

    H = cs.HEADLINE
    cases = [("headline float32", lambda: cs.make_qps(H["B"], H["n"], H["m"]), torch.float32, ((1, True), (2, True))),
             ("headline float64", lambda: cs.make_qps(H["B"], H["n"], H["m"], dtype=cs.np.float64), torch.float64,
              ((2, True), (4, True))),
             ("MPC float32", lambda: cs.mpc_scenarios()[1:], torch.float32, ((8, False), (16, True)))]
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(pathlib.Path(tmp))
        for label, make, dtype, configs in cases:
            ins, sigma, alpha, (B, n, m) = operands(make(), dtype)
            outs = {name: tuple(torch.empty_like(t) if t is not None else None for t in ins[9:]) for name in libs}
            for k, p_res in configs:
                code_t = _build.dtype_code(dtype)

                def call(name):
                    lib = libs[name]
                    clusters = lib.osqp_admm_iter_refined_resident_clusters(code_t, n, m, k, int(p_res))
                    ptr = lambda t: t.data_ptr() if t is not None else 0
                    code = lib.osqp_admm_iter_refined_resident(
                        code_t, *(ptr(t) for t in ins), *(ptr(t) for t in outs[name]), sigma, alpha, B, n, m, k,
                        int(p_res), clusters, _build.stream())
                    if code:
                        raise RuntimeError(f"{name} at {label}, k={k}: CUDA error {code}")

                for name in libs:
                    call(name)
                first = tuple(t.clone() if t is not None else None for t in outs["shipped"])
                repeats_same = True
                for _ in range(5):
                    call("shipped")
                    repeats_same &= all(a is None or torch.equal(a, b) for a, b in zip(outs["shipped"], first))
                torch.cuda.synchronize()
                same = all(a is None or torch.equal(a, b) for a, b in zip(outs["rows4"], outs["shipped"]))
                times = {name: [] for name in libs}
                for _ in range(3):
                    for name in libs:
                        times[name].append(cs.cuda_ms(lambda: call(name), reps=10))
                clusters = {name: libs[name].osqp_admm_iter_refined_resident_clusters(code_t, n, m, k, int(p_res))
                            for name in libs}
                print(f"{label} B={B} n={n} m={m}, clusters of {k}{' with P' if p_res else ''}: "
                      + "; ".join(f"{name} {statistics.median(times[name]):.4f} ms ({clusters[name]} clusters)"
                                  for name in libs)
                      + f"; rows4 bit-identical to shipped {same}; six launches of shipped bit-identical "
                      f"{repeats_same}", flush=True)
                for name in ("stamps",):
                    lib = libs[name]
                    stamps = (ctypes.c_ulonglong * 16)()
                    lib.k1r_stamps_zero()
                    call(name)
                    torch.cuda.synchronize()
                    lib.k1r_stamps_read(stamps)
                    total = sum(stamps[:len(PHASES)]) or 1
                    print(f"  {name}, CTA 0's cycles by phase over one call ({total} in all): "
                          + "; ".join(f"{ph} {stamps[i]} ({stamps[i] / total:.3f})" for i, ph in enumerate(PHASES)),
                          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
