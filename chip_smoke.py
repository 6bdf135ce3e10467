#!/usr/bin/env python3
"""Drive osqp_tpu_torch's main path once on one CUDA GPU and check it.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs
one CUDA device, ``nvcc`` and nothing of JAX.  Phases, in order; any
failure ends the run with a non-zero exit and no result line:

1. the card (nvidia-smi name and power limit) and the torch build;
2. build the kernels from ``osqp_tpu_torch/csrc`` and time the build;
3. K2 (chol_inverse) against its plain version on Schur matrices of the
   benchmark's data, n=100: B=512 in float64 and float32, and the main
   path's B=8192 in float32; the headline factor's inverse residual
   against the refine gate; both versions timed at B=8192;
4. K1 (admm_iter) against its plain version, one step from a random
   state: B=512 in float64 and float32 with half of the instances
   inactive, and B=8192 in float32 half and all active; both timed at
   B=8192;
5. the slice on the GPU against the slice on the CPU (plain path), in
   float64 at B=64, n=20, m=30: equal statuses and iteration counts,
   x and y within 1e-6;
6. the slice at the repo's headline size through ``solve_batch``:
   B=8192, n=100, m=200, float32, eps 1e-3, polish off, with the kernel
   launch counts of that one solve, then 5 timed solves.

The line before the last is a JSON object of the kernels; the last line
is the device JSON object.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

HEADLINE = dict(B=8192, n=100, m=200)
SOLVE_KW = dict(dtype="float32", verbose=False, polish=False, eps_abs=1e-3, eps_rel=1e-3)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def make_qps(B, n, m, seed=0, dtype=np.float32):
    """The benchmark's random strictly convex QPs (bench.py:31-42)."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((B, n, n)).astype(dtype)
    P = np.einsum("bij,bkj->bik", M, M) / n + 0.1 * np.eye(n, dtype=dtype)
    q = rng.standard_normal((B, n)).astype(dtype)
    A = rng.standard_normal((B, m, n)).astype(dtype) / np.sqrt(n)
    xr = rng.standard_normal((B, n)).astype(dtype)
    Ax = np.einsum("bmn,bn->bm", A, xr)
    spread = np.abs(rng.standard_normal((B, m))).astype(dtype)
    l = Ax - spread - 0.1
    u = Ax + spread + 0.1
    return P, q, A, l, u


def cuda_ms(fn, reps, warmup=2):
    """Mean milliseconds of ``fn()`` on the current stream, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def on_device(arrays, dtype, dev):
    import torch

    return [torch.as_tensor(a, dtype=dtype, device=dev).contiguous() for a in arrays]


def path_operands(B, n, m, dtype, dev, seed=0):
    """Scaled data, rho state and dense_inv factor as the main path forms them."""
    import torch

    from osqp_tpu_torch import batch, solver
    from osqp_tpu_torch.types import DynSettings

    P, q, A, l, u = on_device(make_qps(B, n, m, seed), dtype, dev)
    s = solver.Settings(**SOLVE_KW)
    cfg = solver.make_config(n, m, s, dtype)
    dyn = DynSettings.make(dtype)
    rho0 = torch.full((B,), s.rho, dtype=dtype, device=dev)
    scaled, scl, rs, factor, it = batch._prepare(cfg, s.scaling, P, q, A, l, u, rho0, dyn, None, None)
    return scaled, rs, factor, dyn


def phase_k2(dev):
    import torch

    from osqp_tpu_torch.linsys import dense_inv
    from osqp_tpu_torch.linsys.dense_chol import form_schur
    from osqp_tpu_torch.ops import spd_inverse as k2

    B, n, m = HEADLINE["B"], HEADLINE["n"], HEADLINE["m"]
    # (B, dtype, bound on |I - M X|max for both paths, bound on |Xk - Xp|max / |Xp|max);
    # the last case is the main path's own shape and dtype.
    cases = ((512, torch.float64, 1e-10, 1e-10), (512, torch.float32, 1e-3, 1e-4), (B, torch.float32, 1e-3, 1e-4))
    for b, dtype, tol, rel_tol in cases:
        scaled, rs, factor, dyn = path_operands(b, n, m, dtype, dev)
        M = form_schur(scaled.P, scaled.A, dyn.sigma, rs.rho_vec)
        Xk = k2.chol_inverse(M)
        Xp = k2.chol_inverse_plain(M)
        torch.cuda.synchronize()
        eye = torch.eye(n, dtype=dtype, device=dev)
        rk = float((eye - torch.bmm(M, Xk)).abs().max())
        rp = float((eye - torch.bmm(M, Xp)).abs().max())
        err = float((Xk - Xp).abs().max())
        rel = err / float(Xp.abs().max())
        print(f"K2 chol_inverse B={b} {dtype}: |I-MX|max kernel {rk:.3e} plain {rp:.3e}; "
              f"|Xk-Xp|max {err:.3e} relative {rel:.3e} (tol {tol:g}, relative {rel_tol:g})")
        require(rk <= tol and rp <= tol and rel <= rel_tol, f"K2 disagrees with its plain version at B={b} in {dtype}")

    # The headline's setup factor: the residual that dense_inv.init holds
    # against the refine gate, after Newton-Schulz and the guard.
    worst = float(dense_inv._inverse_residual(M, factor["Minv"]).max())
    gate = dense_inv._REFINE_TOL_F32
    print(f"K2 headline factor: |I-M Minv|max after Newton-Schulz {worst:.3e}, refine gate {gate:g} "
          f"({gate / worst:.2f}x above), refine flagged in {int(factor['refine'].sum())} of {B} instances")

    ms = cuda_ms(lambda: k2.chol_inverse(M), reps=10)
    plain_ms = cuda_ms(lambda: k2.chol_inverse_plain(M), reps=10)
    print(f"K2 chol_inverse B={B} n={n} f32: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def phase_k1(dev):
    import torch

    from osqp_tpu_torch.ops import admm_iter as k1

    n, m = HEADLINE["n"], HEADLINE["m"]

    def operands(B, dtype):
        scaled, rs, factor, dyn = path_operands(B, n, m, dtype, dev)
        g = torch.Generator(device=dev).manual_seed(1)
        rnd = lambda *s: torch.randn(*s, generator=g, dtype=dtype, device=dev)
        active = torch.arange(B, device=dev) % 2 == 0
        return (factor["Minv"], factor["AMinvT"], scaled.A, scaled.q, scaled.l, scaled.u,
                rs.rho_vec, rs.rho_inv_vec, float(dyn.sigma), float(dyn.alpha), active,
                rnd(B, n), rnd(B, m), rnd(B, m), rnd(B, n), rnd(B, m))

    def compare(args, rtol, label):
        """Kernel against plain on one step; returns the largest |k - p|."""
        outk = k1.admm_iter(*args)
        outp = k1.admm_iter_plain(*args)
        torch.cuda.synchronize()
        active = args[10]
        worst = err = 0.0
        for name, ok_, op, before in zip(("x", "z", "y", "dx", "dy"), outk, outp, args[11:]):
            require(torch.equal(ok_[~active], before[~active]), f"K1 changed inactive {name} at {label}")
            diff = float((ok_ - op).abs().max())
            worst = max(worst, diff / max(float(op.abs().max()), 1e-300))
            err = max(err, diff)
        print(f"K1 admm_iter {label}: worst |k-p|max/|p|max over x,z,y,dx,dy {worst:.3e} (rtol {rtol:g}), "
              f"|k-p|max {err:.3e}; inactive instances bit-identical")
        require(worst <= rtol, f"K1 disagrees with its plain version at {label}")
        return err

    compare(operands(512, torch.float64), 1e-12, "B=512 float64, half active")
    compare(operands(512, torch.float32), 1e-5, "B=512 float32, half active")
    B = HEADLINE["B"]
    half = operands(B, torch.float32)
    full = half[:10] + (torch.ones_like(half[10]),) + half[11:]
    err = max(compare(half, 1e-5, f"B={B} float32, half active"), compare(full, 1e-5, f"B={B} float32, all active"))

    ms = cuda_ms(lambda: k1.admm_iter(*half), reps=50)
    plain_ms = cuda_ms(lambda: k1.admm_iter_plain(*half), reps=50)
    print(f"K1 admm_iter B={B} n={n} m={m} f32 (half active): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    ms_all = cuda_ms(lambda: k1.admm_iter(*full), reps=50)
    plain_all = cuda_ms(lambda: k1.admm_iter_plain(*full), reps=50)
    gbytes = B * 4 * (n * n + 2 * n * m) / 1e9
    print(f"K1 admm_iter all active: kernel {ms_all:.4f} ms ({gbytes / ms_all:.1f} TB/s of matrix reads), "
          f"plain {plain_all:.4f} ms")
    return dict(max_abs_err=err, ms=ms_all, plain_ms=plain_all)


def phase_parity(dev):
    import torch

    import osqp_tpu_torch as ot

    P, q, A, l, u = make_qps(64, 20, 30, seed=3, dtype=np.float64)
    kw = dict(dtype="float64", verbose=False)
    rg = ot.solve_batch(P, q, A, l, u, device=dev, **kw)
    rc = ot.solve_batch(P, q, A, l, u, device="cpu", **kw)
    same_status = torch.equal(rg.status_val.cpu(), rc.status_val)
    same_iter = torch.equal(rg.iter.cpu(), rc.iter)
    dx = float((rg.x.cpu() - rc.x).abs().max())
    dy = float((rg.y.cpu() - rc.y).abs().max())
    print(f"slice GPU vs CPU, f64 B=64 n=20 m=30: statuses equal {same_status}, iterations equal {same_iter}, "
          f"|dx|max {dx:.3e}, |dy|max {dy:.3e}")
    require(same_status and same_iter and dx <= 1e-6 and dy <= 1e-6, "GPU slice disagrees with the CPU slice")


def phase_headline(dev):
    import torch

    import osqp_tpu_torch as ot
    from osqp_tpu_torch import batch, solver
    from osqp_tpu_torch.ops import admm_iter as k1
    from osqp_tpu_torch.ops import spd_inverse as k2
    from osqp_tpu_torch.types import DynSettings

    B, n, m = HEADLINE["B"], HEADLINE["n"], HEADLINE["m"]
    P, q, A, l, u = on_device(make_qps(B, n, m), torch.float32, dev)
    torch.cuda.synchronize()

    k1.launches = 0
    k2.launches = 0
    t0 = time.perf_counter()
    res = ot.solve_batch(P, q, A, l, u, **SOLVE_KW)
    status = res.status_val.cpu().numpy()
    first_s = time.perf_counter() - t0
    launches = {"admm_iter": k1.launches, "chol_inverse": k2.launches}
    iters = res.iter.cpu().numpy()
    solved = float(np.mean(status == ot.OSQP_SOLVED))
    x = res.x.cpu().numpy()
    print(f"headline B={B} n={n} m={m} f32: first solve {first_s:.3f} s, solved {solved:.4f}, "
          f"iterations mean {iters.mean():.2f} max {iters.max()}, launches {launches}")
    require(solved >= 0.99, f"solved fraction {solved} < 0.99")
    require(not np.any(status == ot.OSQP_MAX_ITER_REACHED), "an instance hit MAX_ITER_REACHED")
    require(np.isfinite(x[status == ot.OSQP_SOLVED]).all(), "non-finite x in a solved instance")
    require(x.shape == (B, n) and res.y.shape == (B, m), "result shapes")
    require(launches["admm_iter"] > 0 and launches["chol_inverse"] > 0, "a kernel of the path never launched")

    times = []
    for _ in range(5):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        ot.solve_batch(P, q, A, l, u, **SOLVE_KW)
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))

    s = solver.Settings(**SOLVE_KW)
    cfg = solver.make_config(n, m, s, torch.float32)
    dyn = DynSettings.make(torch.float32)
    rho0 = torch.full((B,), s.rho, dtype=torch.float32, device=dev)
    setup_ms = cuda_ms(lambda: batch._prepare(cfg, s.scaling, P, q, A, l, u, rho0, dyn, None, None), reps=3, warmup=1)

    med = statistics.median(times)
    loop_iters = int(iters.max())
    per_iter = (med - setup_ms) / loop_iters
    print(f"headline timed solves (ms, CUDA events, data on device): {[round(t, 3) for t in times]}")
    print(f"headline median {med:.3f} ms, spread {min(times):.3f}..{max(times):.3f} ms, "
          f"{B / (med / 1e3):.1f} QPs/s (median), {B / (min(times) / 1e3):.1f}..{B / (max(times) / 1e3):.1f} QPs/s")
    print(f"headline setup (scale + rho + factor) {setup_ms:.3f} ms; loop {med - setup_ms:.3f} ms over "
          f"{loop_iters} iterations = {per_iter:.4f} ms/iteration (incl. checks and rho updates)")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import osqp_tpu_torch  # noqa: F401  (a checkout is required)
    from osqp_tpu_torch import _build

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s: {lib_path.name}")

    k2_stats = phase_k2(dev)
    k1_stats = phase_k1(dev)
    phase_parity(dev)
    launches = phase_headline(dev)

    kernels = [
        dict(name="admm_iter", route="cuda", source="osqp_tpu_torch/csrc/admm_iter.cu",
             replaces="osqp_tpu/linsys/dense_inv.py:164", launches=launches["admm_iter"], **k1_stats),
        dict(name="chol_inverse", route="cuda", source="osqp_tpu_torch/csrc/chol_inverse.cu",
             replaces="osqp_tpu/ops/spd_inverse.py:167", launches=launches["chol_inverse"], **k2_stats),
    ]
    print(json.dumps({"kernels": kernels}))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
