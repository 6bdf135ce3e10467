#!/usr/bin/env python3
"""K2's cluster leaf on one GPU at CVXQP2_M's first leaf: its time by
cluster size, its cycles by phase, and its distance from the plain leaf.

    python3 tools/probe_k2_leaf.py [OUT.npz]

Builds ``osqp_tpu_torch/csrc/chol_inverse.cu`` (with ``common.cu``) three
times, the ``nvcc`` all started together: as it stands, with its two
column loops (the diagonal block's factor and the forward solves)
rolled, and with -DOSQP_STAMPS (cycle stamps by phase in thread 0 of
CTAs 0 and k - 1 of the first instance, csrc/cluster.cuh).

Takes the leaf that spd_inverse gives the kernel first at CVXQP2_M (B =
1: the leading block of the Jacobi-equilibrated reduced matrix), of 256
(the leaf size the card runs) and of 496 (leaves of cluster_max_n), in
float64 and float32.  Times the leaf in clusters of every size that
fits and its rolled form in clusters of 16 (CUDA events, 20 calls, in
interleaved rounds) beside the plain leaf (the library's Cholesky and
triangular solve), and prints the leaf's largest distance from the plain
one relative to the plain one's largest entry, and at 256 its cycles a
launch by phase.  Given a path, writes S, the kernel's T and the plain T
of the 496 leaf in float64 there (.npz) for a look at their error
against an extended-precision inverse on the host.

Then, through the package's own wrappers, the route at CVXQP2_M
(spd_inverse, B = 1) with the recursion's leaves of at most max_n, 256,
384 and cluster_max_n: its time, its leaves, each leaf's largest
distance from its plain version and the route's from the plain route.
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

CSRC = ROOT / "osqp_tpu_torch" / "csrc"
PHASES = ("load", "diagonal block", "panel solve", "X row, publish", "barrier", "fetch", "next block", "updates",
          "end")


UNROLLED = "#pragma unroll\n  for (int jj = 0; jj < kNB; ++jj) {\n    if (jj >= kb) break;"
ROLLED = "#pragma unroll 1\n  for (int jj = 0; jj < kb; ++jj) {"


def build(work: pathlib.Path) -> dict:
    from osqp_tpu_torch import _build

    nvcc = _build._nvcc()
    text = (CSRC / "chol_inverse.cu").read_text()
    if text.count(UNROLLED) != 2:
        raise RuntimeError("chol_inverse.cu has not the two unrolled column loops")
    for name, body in (("shipped", text), ("rolled", text.replace(UNROLLED, ROLLED))):
        (work / name).mkdir()
        (work / name / "chol_inverse.cu").write_text(body)
        for f in ("common.cuh", "cluster.cuh", "common.cu"):
            (work / name / f).write_text((CSRC / f).read_text())
    jobs, libs = [], {}
    for name, src, flags in (("shipped", "shipped", []), ("rolled", "rolled", []),
                             ("stamps", "shipped", ["-DOSQP_STAMPS"])):
        lib = work / f"{name}.so"
        cmd = [nvcc, *_build.NVCC_FLAGS, *flags, "-shared", "-o", str(lib), str(work / src / "chol_inverse.cu"),
               str(work / src / "common.cu")]
        jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        libs[name] = lib
    for cmd, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{err}")
    out = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        lib.osqp_chol_inverse_leaf_cluster.argtypes = _build._SIGNATURES["osqp_chol_inverse_leaf_cluster"]
        lib.osqp_chol_inverse_leaf_cluster.restype = ctypes.c_int
        out[name] = lib
    out["stamps"].osqp_leaf_stamps.argtypes = (ctypes.c_void_p,)
    out["stamps"].osqp_leaf_stamps.restype = ctypes.c_int
    return out


def schur(dtype, dev):
    """CVXQP2_M's reduced matrix M, as dense_inv.init gets it."""
    import chip_smoke
    from osqp_tpu_torch.linsys.dense_chol import form_schur

    scaled, rs, _, dyn = chip_smoke.prepared(*chip_smoke.on_device(chip_smoke.maros_dense("CVXQP2_M"), dtype, dev))
    return form_schur(scaled.P, scaled.A, dyn.sigma, rs.rho_vec).contiguous()


def first_leaf(dtype, dev, n):
    """The leading n x n block of CVXQP2_M's Jacobi-equilibrated reduced
    matrix: the route's first leaf at leaf size n (256, as the card runs
    it, or 496, as leaves of cluster_max_n would)."""
    import torch

    M = schur(dtype, dev)
    d = 1.0 / torch.sqrt(torch.diagonal(M, dim1=-2, dim2=-1))
    return (M * d[:, :, None] * d[:, None, :])[:, :n, :n].contiguous()


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke
    from osqp_tpu_torch import _build
    from osqp_tpu_torch.ops import spd_inverse as k2

    if not torch.cuda.is_available():
        print("probe_k2_leaf: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(pathlib.Path(tmp))

        def leaf(lib, S, k):
            T = torch.empty_like(S)
            scratch = torch.empty(S.shape[0] * (32 * S.shape[-1] + 512), dtype=S.dtype, device=dev)
            code = lib.osqp_chol_inverse_leaf_cluster(_build.dtype_code(S.dtype), S.data_ptr(), T.data_ptr(),
                                                      scratch.data_ptr(), S.shape[0], S.shape[-1], k, _build.stream())
            if code:
                raise RuntimeError(f"launch failed: {code}")
            return T

        for dtype, n in ((torch.float64, k2.CLUSTER_LEAF_N), (torch.float32, k2.CLUSTER_LEAF_N),
                         (torch.float64, 496), (torch.float32, 496)):
            S = first_leaf(dtype, dev, n)
            Tp = k2.chol_inverse_leaf_plain(S)
            Tk = leaf(libs["shipped"], S, 16)
            torch.cuda.synchronize()
            rel = float((Tk - Tp).abs().max()) / float(Tp.abs().max())
            sizes = [k for k in k2.LEAF_CLUSTERS if k2.cluster_fits(n, k, dtype)]
            times = {k: [] for k in sizes}
            plain, rolled = [], []
            for _ in range(5):
                for k in sizes:
                    times[k].append(chip_smoke.cuda_ms(lambda: leaf(libs["shipped"], S, k), 20))
                rolled.append(chip_smoke.cuda_ms(lambda: leaf(libs["rolled"], S, 16), 20))
                plain.append(chip_smoke.cuda_ms(lambda: k2.chol_inverse_leaf_plain(S), 20))
            print(f"K2 cluster leaf CVXQP2_M first leaf n={n} {chip_smoke.dtype_name(dtype)}: |Tk-Tp|max relative "
                  f"{rel:.3e}; median ms by CTAs a cluster "
                  f"{({k: round(statistics.median(t), 4) for k, t in times.items()})}, the rolled form "
                  f"{statistics.median(rolled):.4f}, plain {statistics.median(plain):.4f}")
            if n != k2.CLUSTER_LEAF_N:
                if dtype == torch.float64 and len(sys.argv) > 1:
                    np.savez(sys.argv[1], S=S[0].cpu().numpy(), Tk=Tk[0].cpu().numpy(), Tp=Tp[0].cpu().numpy())
                continue
            lib = libs["stamps"]
            out = (ctypes.c_ulonglong * 32)()
            leaf(lib, S, 16)
            torch.cuda.synchronize()
            lib.osqp_leaf_stamps(out)
            reps = 10
            for _ in range(reps):
                leaf(lib, S, 16)
            torch.cuda.synchronize()
            if lib.osqp_leaf_stamps(out):
                raise RuntimeError("reading the stamps failed")
            clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                                   capture_output=True, text=True).stdout.strip()
            for cta, row in (("CTA 0", 0), ("CTA 15", 1)):
                cyc = [out[16 * row + i] / reps for i in range(len(PHASES))]
                print(f"  clusters of 16, {cta}: cycles a launch by phase {({p: int(c) for p, c in zip(PHASES, cyc)})}, "
                      f"total {int(sum(cyc))} (SM clock {clock} MHz)")

    # the route by leaf size, through the package
    for dtype in (torch.float64, torch.float32):
        M = schur(dtype, dev)
        sizes = (k2.max_n(dtype), 256, 384, k2.cluster_max_n(dtype))
        Xp = chip_smoke.plain_leaves(lambda: k2.spd_inverse(M))
        times = {n: [] for n in sizes}
        for _ in range(3):
            for n in sizes:
                times[n].append(chip_smoke.cuda_ms(lambda: k2.spd_inverse(M, leaf_n=n), 10))
        for n in sizes:
            seen = []
            X = chip_smoke.leaf_spy(lambda: k2.spd_inverse(M, leaf_n=n), seen)
            torch.cuda.synchronize()
            _, wall, events = chip_smoke.profiled(lambda: [k2.spd_inverse(M, leaf_n=n) for _ in range(5)])
            print(f"K2 route CVXQP2_M {chip_smoke.dtype_name(dtype)}, leaves of at most {n}: median "
                  f"{statistics.median(times[n]):.4f} ms, device time {chip_smoke.event_ms(events) / 5:.4f} ms a "
                  f"call under the profiler (host wall {wall / 5:.4f}); leaves (n, |Tk-Tp|max relative) "
                  f"{[(nl, float(f'{r:.3e}')) for nl, r, _ in seen]}; route against the plain route "
                  f"{chip_smoke.rel_err(X, Xp)[1]:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
