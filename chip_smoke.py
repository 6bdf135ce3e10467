#!/usr/bin/env python3
"""Drive osqp_tpu_torch's main paths once on one CUDA GPU and check them.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs
one CUDA device, ``nvcc`` and nothing of JAX.  Phases, in order; any
failure ends the run with a non-zero exit and no result line:

1. the card (nvidia-smi name and power limit) and the torch build;
2. build the kernels from ``osqp_tpu_torch/csrc`` and time the build;
3. K2 (chol_inverse) against its plain version on Schur matrices of the
   benchmark's data, n=100: B=512 in float64 and float32, and the main
   path's B=8192 in float32; the headline factor's inverse residual
   against the refine gate, which must flag 0 of 8192 instances, and how
   many the residual guard sends to Cholesky; n swept from 1 to the
   shared-memory bound in both dtypes, two launches bit-identical;
   kernel, plain and torch.linalg.inv timed at B=8192 beside the bound,
   with the kernel's blocks per SM; the library route above the bound
   (CVXQP2_M, both dtypes) timed as that case's library_ms;
4. K1 (admm_iter) against its plain version, one step from a random
   state: B=512 in float64 and float32 with half of the instances
   inactive, B=8192 in float32 half and all active, CVXQP2_M's shape at
   B=1 in both dtypes, and B=1, n=2, m=6000 in float64 (above what one
   block per instance could hold); every case launched twice and the two
   results held bit-identical; warm, L2-flushed and profiled device
   times beside the plain time and the bound at B=8192 and CVXQP2_M;
5. K4 (ruiz) against its plain version on the headline data (B=8192,
   n=100, m=200) in float32 and float64, which take the resident path in
   clusters of 2 and 4, and on CVXQP2_M (B=1, n=1000, m=1250, float64
   and float32), which takes the split path: D and E equal, c and the
   scaled data close, two launches bit-identical, the path each took
   checked against cluster_size; both timed, with the bound, and at the
   headline every cluster size that fits, with the clusters resident;
6. K3 (term_products) against its plain version at the same shapes from
   a random state, with and without the certificate products; both
   timed, with the bound;
7. K1r (admm_iter_refined) against its plain version, one step from a
   random state: B=512 in float64 and float32 with half of the instances
   inactive, B=8192 at the headline shape in float32, CVXQP2_M's shape
   at B=1 in both dtypes, B=1, n=2, m=6000 in float64 and B=1,
   n=m=3000 in float32 (above the one-block bound); two launches
   bit-identical; the float32 carry held to TwoSum exactly; the float32
   solve at CVXQP2_M held to a forward-error bound that a float32
   residual misses; times as for K1;
8. the batched slice on the GPU against the slice on the CPU (plain
   path), in float64 at B=64, n=20, m=30: equal statuses and iteration
   counts, x and y within 1e-6;
9. the batched slice at the repo's headline size through
   ``solve_batch``: B=8192, n=100, m=200, float32, eps 1e-3, polish off,
   with the kernel launch counts of that one solve (K4's on the resident
   path, which it must take), then 5 timed solves;
10. the stateful ``Solver`` path: README's quick start, CVXQP2_S and
    CVXQP2_M (read with ``osqp_tpu_torch.io.qps``) in float64 and
    float32, each held against the JAX package's results in
    ``tests/data/torch_goldens/solver_maros.npz``, and a warm re-solve
    after ``update_lin_cost`` held against the same sequence on the CPU;
    launch counts, loop body and times per solve; one more CVXQP2_M
    solve per dtype under the profiler, for ms per iteration and the
    K1/K1r device time per iteration.

The line before the last is a JSON object of the kernels; the last line
is the device JSON object.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HEADLINE = dict(B=8192, n=100, m=200)
SOLVE_KW = dict(dtype="float32", verbose=False, polish=False, eps_abs=1e-3, eps_rel=1e-3)
ROOT = os.path.dirname(os.path.abspath(__file__))
MAROS = os.path.join(ROOT, "tests", "data", "maros_mm")
GOLDENS = os.path.join(ROOT, "tests", "data", "torch_goldens", "solver_maros.npz")
# Relative tolerances of a kernel against its plain version (largest
# difference over the largest plain value): order of summation differs.
RTOL = {"float64": 1e-12, "float32": 1e-5}
# Bound on the relative forward error of K1r's float32 solve at CVXQP2_M
# (cond(M) ~ 4.7e3): a float64 residual gives ~4e-8 there, a float32
# residual ~3e-7.
F64_RESIDUAL_BOUND = 1e-7


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


# One H100 SXM (NVIDIA's data sheet): HBM3 bandwidth and the peak rates
# outside the tensor cores, by type.  A bound is the larger of the bytes
# over the bandwidth and the operations over the peak.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
FLUSH_BYTES = 256 << 20  # written between calls to evict the 50 MB L2
# The kernels of K1 and K1r (csrc/admm_passes.cuh, admm_iter_refined.cu).
K1_KERNELS = ("colsum_kernel", "rowdot_kernel", "epilogue_kernel", "solve_finish_kernel")


def bound(nbytes, flops) -> tuple[float, str]:
    """(least ms, what bounds it): ``nbytes`` over the HBM rate against
    ``flops`` (a count per dtype name) over the peak rates."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = sum(f / PEAK_FLOPS[d] for d, f in flops.items()) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms_flushed(fn, reps):
    """Mean milliseconds of ``fn()`` by CUDA events around each call, with
    the L2 cache flushed before each."""
    import torch

    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(stop)
    return total / reps


def profiled(fn):
    """(fn's result, host ms, device events) of one call of ``fn`` under
    torch.profiler, ending in a synchronize."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return out, wall, events


def event_ms(events, names=None) -> float:
    """Device milliseconds of the events whose name holds one of ``names``
    (all events when None)."""
    return sum(e.time_range.elapsed_us() for e in events if names is None or any(k in e.name for k in names)) / 1e3


def report_times(label, fn, plain, reps, nbytes, flops):
    """Print and return a kernel's times: warm (back-to-back calls), with
    the L2 flushed before each call, and its device time per call from the
    profiler; its plain version's warm time; and its bound."""
    import torch

    warm = cuda_ms(fn, reps)
    cold = cuda_ms_flushed(fn, reps)
    fn()
    torch.cuda.synchronize()
    _, _, events = profiled(lambda: [fn() for _ in range(reps)])
    dev_ms = event_ms(events) / reps
    plain_ms = cuda_ms(plain, reps)
    b, by = bound(nbytes, flops)
    device = f"{dev_ms:.4f} ms" if dev_ms > 0 else "not measured (no device events)"
    share = lambda t: f"{b / t:.3f}" if t > 0 else "not measured"
    print(f"{label}: kernel warm {warm:.4f} ms, L2-flushed {cold:.4f} ms, device time per call {device}; "
          f"plain {plain_ms:.4f} ms; bound {b:.4f} ms ({by}), share of bound warm {share(warm)}, "
          f"flushed {share(cold)}, device {share(dev_ms)}")
    return dict(ms=warm, plain_ms=plain_ms, bound_ms=b, bound_by=by)


def k1_cost(B, n, m, dtype):
    """(bytes, operations) of one K1 call: Minv, AMinvT and A read once, the
    vectors read and written once, a multiply-add per matrix value."""
    elt = 4 if dtype_name(dtype) == "float32" else 8
    nbytes = elt * B * (n * n + 2 * n * m + 5 * n + 10 * m) + B
    return nbytes, {dtype_name(dtype): 2 * B * (n * n + 2 * n * m)}


def k1r_cost(B, n, m, dtype):
    """(bytes, operations) of one K1r call: Minv, A and P read once, the
    vectors (and the float32 carry) read and written once; the products
    of 1 + ncorr passes over Minv, 2 over A and, per correction, the
    float64 residual's passes over A (two) and P."""
    f32 = dtype_name(dtype) == "float32"
    elt, ncorr = (4, 2) if f32 else (8, 1)
    nbytes = elt * B * (2 * n * n + m * n + 5 * n + (12 if f32 else 10) * m) + B
    flops = {dtype_name(dtype): 2 * B * ((1 + ncorr) * n * n + 2 * m * n)}
    f64 = 2 * B * ncorr * (2 * m * n + n * n)
    flops["float64"] = flops.get("float64", 0) + f64
    return nbytes, flops


def random_operands(B, n, m, dtype, dev, seed=5):
    """Operands of one ADMM step with random data: P = G G'/n + 0.1 I,
    A ~ N(0, 1/n), rho in [0.1, ...), Minv = (P + sigma I + A' rho A)^-1
    and AMinvT = Minv A', made in float64 on the card and cast; a random
    state, every instance active."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, dtype=torch.float64, device=dev)
    eye = torch.eye(n, dtype=torch.float64, device=dev)
    G = r(B, n, n)
    P = G @ G.mT / n + 0.1 * eye
    A = r(B, m, n) / n**0.5
    rho = 0.1 + r(B, m).abs()
    sigma = 1e-6
    M = P + sigma * eye + A.mT @ (rho[:, :, None] * A)
    Minv = torch.cholesky_inverse(torch.linalg.cholesky(M))
    l = r(B, m) - 1.0
    ops = dict(Minv=Minv, AMinvT=Minv @ A.mT, A=A, P=P, q=r(B, n), l=l, u=l + 2.0, rho=rho, rho_inv=1.0 / rho,
               x=r(B, n), z=r(B, m), y=r(B, m), dx=r(B, n), dy=r(B, m))
    ops = {k: v.to(dtype).contiguous() for k, v in ops.items()}
    ops.update(sigma=sigma, alpha=1.6, active=torch.ones(B, dtype=torch.bool, device=dev))
    return ops


def k1_args(ops):
    return tuple(ops[k] for k in ("Minv", "AMinvT", "A", "q", "l", "u", "rho", "rho_inv", "sigma", "alpha", "active",
                                  "x", "z", "y", "dx", "dy"))


def k1r_args(ops, y_lo=None):
    return tuple(ops[k] for k in ("Minv", "A", "P", "q", "l", "u", "rho", "rho_inv", "sigma", "alpha", "active",
                                  "x", "z", "y", "dx", "dy")) + (y_lo,)


def on_device(arrays, dtype, dev):
    import torch

    return [torch.as_tensor(a, dtype=dtype, device=dev).contiguous() for a in arrays]


def rel_err(got, want) -> tuple[float, float]:
    """(largest |got - want|, that over the largest |want|)."""
    diff = float((got - want).abs().max()) if want.numel() else 0.0
    scale = float(want.abs().max()) if want.numel() else 1.0
    return diff, diff / (scale if scale > 0 else 1.0)


def dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def maros_dense(name):
    """A Maros-Meszaros problem as dense (1, ...) arrays: full P, q, A, l, u."""
    from osqp_tpu_torch.io.qps import load_qps
    from osqp_tpu_torch.sparse import clamp_bounds, triu_to_full

    qp = load_qps(os.path.join(MAROS, f"{name}.qps"))
    return (triu_to_full(qp.P)[None], qp.q[None], qp.A.toarray()[None], clamp_bounds(qp.l)[None],
            clamp_bounds(qp.u)[None])


def reset_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    from osqp_tpu_torch.ops import admm_iter as k1, ruiz as k4, spd_inverse as k2, term_products as k3

    k1.launches = k1.refined_launches = k2.launches = k3.launches = k4.launches = k4.launches_resident = 0


def read_counts() -> dict:
    from osqp_tpu_torch.ops import admm_iter as k1, ruiz as k4, spd_inverse as k2, term_products as k3

    return {"admm_iter": k1.launches, "admm_iter_refined": k1.refined_launches, "chol_inverse": k2.launches,
            "ruiz": k4.launches, "ruiz_resident": k4.launches_resident, "term_products": k3.launches}


def prepared(P, q, A, l, u):
    """Scaled data, rho state, dense_inv factor and settings of (B, ...)
    tensors, as the main path forms them."""
    import torch

    from osqp_tpu_torch import batch, solver
    from osqp_tpu_torch.types import DynSettings

    (B, n), m, dtype = q.shape, l.shape[1], q.dtype
    s = solver.Settings(**{**SOLVE_KW, "dtype": dtype})
    cfg = solver.make_config(n, m, s, dtype)
    dyn = DynSettings.make(dtype)
    rho0 = torch.full((B,), s.rho, dtype=dtype, device=q.device)
    scaled, _, rs, factor, _ = batch._prepare(cfg, s.scaling, P, q, A, l, u, rho0, dyn, None, None)
    return scaled, rs, factor, dyn


def path_operands(B, n, m, dtype, dev, seed=0):
    """prepared() of the benchmark's data."""
    return prepared(*on_device(make_qps(B, n, m, seed), dtype, dev))


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
    # against the refine gate, after Newton-Schulz and the guard, and how
    # many instances the guard sent to Cholesky.
    worst = float(dense_inv._inverse_residual(M, factor["Minv"]).max())
    gate = dense_inv._REFINE_TOL_F32
    flagged = int(factor["refine"].sum())
    guarded = int((dense_inv._inverse_residual(M, k2.spd_inverse(M)) > dense_inv._GUARD_TOL_F32).sum())
    print(f"K2 headline factor: |I-M Minv|max after Newton-Schulz {worst:.3e}, refine gate {gate:g} "
          f"({gate / worst:.2f}x above), refine flagged in {flagged} of {B} instances; residual guard sent "
          f"{guarded} of {B} to Cholesky")
    require(flagged == 0, f"the headline factor flags refine in {flagged} of {B} instances")

    # n from 1 to the shared-memory bound in both dtypes, on the test's
    # SPD matrices; two launches bit-identical.
    rng = np.random.default_rng(0)
    for dtype, rel_tol, sizes in ((torch.float32, 1e-4, (1, 7, 33, 100, 128, 239, 240)),
                                  (torch.float64, 1e-11, (1, 7, 33, 100, 128, 168, 169))):
        worst_n = 0.0
        for nn in sizes:
            G = rng.standard_normal((64, nn, nn))
            Mn = torch.as_tensor(G @ G.transpose(0, 2, 1) / nn + 0.1 * np.eye(nn), dtype=dtype, device=dev)
            Xa, Xb = k2.chol_inverse(Mn), k2.chol_inverse(Mn)
            torch.cuda.synchronize()
            require(torch.equal(Xa, Xb), f"K2's two launches differ at n={nn} in {dtype}")
            _, rel = rel_err(Xa, k2.chol_inverse_plain(Mn))
            require(rel <= rel_tol, f"K2 off by {rel:.3e} relative at n={nn} in {dtype}")
            worst_n = max(worst_n, rel)
        print(f"K2 chol_inverse B=64 {dtype_name(dtype)} n in {sizes}: worst relative difference {worst_n:.3e} "
              f"(tol {rel_tol:g}); two launches bit-identical")

    print(f"K2 chol_inverse n={n}: {k2.blocks_per_sm(n, torch.float32)} blocks per SM in float32, "
          f"{k2.blocks_per_sm(n, torch.float64)} in float64")
    ms = cuda_ms(lambda: k2.chol_inverse(M), reps=10)
    plain_ms = cuda_ms(lambda: k2.chol_inverse_plain(M), reps=10)
    library_ms = cuda_ms(lambda: torch.linalg.inv(M), reps=10)
    # M read and M^-1 written once; Cholesky, triangular inverse and T'T take
    # about n^3/3 operations each (n^3/6 multiply-adds), n^3 in all
    bound_ms, bound_by = bound(2 * 4 * B * n * n, {"float32": B * n**3})
    print(f"K2 chol_inverse B={B} n={n} f32: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library torch.linalg.inv "
          f"{library_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}), share of bound {bound_ms / ms:.3f}")

    # Above the bound, CVXQP2_M (n=1000): the library route that
    # dense_inv.init takes there (torch's Cholesky, then Newton-Schulz),
    # the yardstick of a later tiled K2.
    for dtype in (torch.float64, torch.float32):
        scaled, rs, _, dyn = prepared(*on_device(maros_dense("CVXQP2_M"), dtype, dev))
        Mm = form_schur(scaled.P, scaled.A, dyn.sigma, rs.rho_vec)
        lib_m = cuda_ms(lambda: k2.newton_schulz(Mm, dense_inv._chol_inverse(Mm)), reps=5)
        print(f"K2 above max_n, CVXQP2_M B=1 n=1000 {dtype_name(dtype)}: library route (Cholesky, cholesky_inverse, "
              f"Newton-Schulz) library_ms {lib_m:.4f}")

    # The Solver's shape: CVXQP2_S, B=1, n=100.
    for dtype, rel_tol in ((torch.float64, 1e-10), (torch.float32, 1e-4)):
        scaled, rs, _, dyn = prepared(*on_device(maros_dense("CVXQP2_S"), dtype, dev))
        Ms = form_schur(scaled.P, scaled.A, dyn.sigma, rs.rho_vec)
        _, rel = rel_err(k2.chol_inverse(Ms), k2.chol_inverse_plain(Ms))
        require(rel <= rel_tol, f"K2 disagrees with its plain version at CVXQP2_S in {dtype}")
        ms_s = cuda_ms(lambda: k2.chol_inverse(Ms), reps=20)
        plain_s = cuda_ms(lambda: k2.chol_inverse_plain(Ms), reps=20)
        print(f"K2 chol_inverse CVXQP2_S B=1 n=100 {dtype_name(dtype)}: relative difference {rel:.3e}; "
              f"kernel {ms_s:.4f} ms, plain {plain_s:.4f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms)


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

    def compare(args, rtol, label, ref64=False):
        """Kernel against plain on one step, and two launches against each
        other; returns the largest |k - p|.  With ref64 (an ill-conditioned
        float32 case, where the order of summation alone moves the result
        by about rtol), both are also held against the plain version in
        float64 on the same inputs, and the kernel must be within rtol of
        the plain version or no further from the float64 result than
        twice the plain version's distance."""
        outk = k1.admm_iter(*args)
        again = k1.admm_iter(*args)
        outp = k1.admm_iter_plain(*args)
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(outk, again)), f"K1's two launches differ at {label}")
        active = args[10]
        worst = err = 0.0
        for name, ok_, op, before in zip(("x", "z", "y", "dx", "dy"), outk, outp, args[11:]):
            require(torch.equal(ok_[~active], before[~active]), f"K1 changed inactive {name} at {label}")
            diff, rel = rel_err(ok_, op)
            worst, err = max(worst, rel), max(err, diff)
        ok = worst <= rtol
        against = ""
        if ref64:
            wide = [a.double() if torch.is_tensor(a) and a.is_floating_point() else a for a in args]
            out64 = k1.admm_iter_plain(*wide)
            err_k = max(rel_err(a.double(), b)[1] for a, b in zip(outk, out64))
            err_p = max(rel_err(a.double(), b)[1] for a, b in zip(outp, out64))
            ok = ok or err_k <= 2 * err_p
            against = f"; against float64 on the same inputs: kernel {err_k:.3e}, plain {err_p:.3e}"
        print(f"K1 admm_iter {label}: worst |k-p|max/|p|max over x,z,y,dx,dy {worst:.3e} (rtol {rtol:g}), "
              f"|k-p|max {err:.3e}{against}; inactive instances bit-identical; two launches bit-identical")
        require(ok, f"K1 disagrees with its plain version at {label}")
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
    stats = report_times(f"K1 admm_iter B={B} n={n} m={m} float32 all active", lambda: k1.admm_iter(*full),
                         lambda: k1.admm_iter_plain(*full), 50, *k1_cost(B, n, m, torch.float32))

    # The Solver's shape: CVXQP2_M, B=1, n=1000, m=1250, in both dtypes.
    for dtype in (torch.float64, torch.float32):
        P, q, A, l, u = on_device(maros_dense("CVXQP2_M"), dtype, dev)
        scaled, rs, factor, dyn = prepared(P, q, A, l, u)
        x, z, dx, y = _random_state(1, P.shape[1], A.shape[1], dtype, dev)
        one = (factor["Minv"], factor["AMinvT"], scaled.A, scaled.q, scaled.l, scaled.u, rs.rho_vec,
               rs.rho_inv_vec, float(dyn.sigma), float(dyn.alpha), torch.ones(1, dtype=torch.bool, device=dev),
               x, z, y, dx, torch.randn_like(z))
        label = f"CVXQP2_M B=1 n=1000 m=1250 {dtype_name(dtype)}"
        # the Solver runs K1r here in float32 (cond(M) ~ 4.7e3): held against float64 too
        compare(one, RTOL[dtype_name(dtype)], label, ref64=dtype == torch.float32)
        report_times(f"K1 admm_iter {label}", lambda: k1.admm_iter(*one), lambda: k1.admm_iter_plain(*one), 20,
                     *k1_cost(1, 1000, 1250, dtype))

    # Above what one block per instance could hold in shared memory.
    compare(k1_args(random_operands(1, 2, 6000, torch.float64, dev)), 1e-12, "B=1 n=2 m=6000 float64")
    return dict(max_abs_err=err, library_ms=None, **stats)


def phase_k4(dev):
    import torch

    from osqp_tpu_torch.ops import ruiz as k4

    B, n, m = HEADLINE["B"], HEADLINE["n"], HEADLINE["m"]
    headline = make_qps(B, n, m)
    cvxqp = maros_dense("CVXQP2_M")
    # the headline on the resident path in float32 and, with a larger
    # cluster, in float64; CVXQP2_M on the split path in both dtypes
    cases = ((f"B={B} n={n} m={m} float32", headline, torch.float32),
             (f"B={B} n={n} m={m} float64", headline, torch.float64),
             ("CVXQP2_M B=1 n=1000 m=1250 float64", cvxqp, torch.float64),
             ("CVXQP2_M B=1 n=1000 m=1250 float32", cvxqp, torch.float32))
    stats = {}
    for label, arrays, dtype in cases:
        args = on_device(arrays, dtype, dev)
        B_, n_, m_ = args[2].shape[0], args[2].shape[2], args[2].shape[1]
        k = k4.cluster_size(n_, m_, dtype)
        path = f"resident, clusters of {k}" if k else "split"
        before = k4.launches_resident
        outk = k4.ruiz(*args, 10)
        again = k4.ruiz(*args, 10)
        outp = k4.ruiz_plain(*args, 10)
        torch.cuda.synchronize()
        require((k4.launches_resident - before == 2) == (k > 0), f"K4 took the wrong path at {label}")
        require(all(torch.equal(a, b) for a, b in zip(outk, again)), f"K4's two launches differ at {label}")
        tol = {"float64": 1e-12, "float32": 1e-6}[dtype_name(dtype)]
        for name, gk, gp in zip(("D", "E"), outk[1:3], outp[1:3]):
            require(torch.equal(gk, gp), f"K4 {name} differs from the plain version's at {label}")
        worst = err = 0.0
        for name, gk, gp in zip(("c", "P", "q", "A", "l", "u"), outk[:1] + outk[3:], outp[:1] + outp[3:]):
            diff, rel = rel_err(gk, gp)
            require(rel <= tol, f"K4 {name} off by {rel:.3e} relative at {label}")
            worst, err = max(worst, rel), max(err, diff)
        ms = cuda_ms(lambda: k4.ruiz(*args, 10), reps=10)
        plain_ms = cuda_ms(lambda: k4.ruiz_plain(*args, 10), reps=10)
        elt = args[0].element_size()
        # P, q, A, l, u read and written scaled once, D, E, c written; about three operations per matrix
        # value in each of 10 sweeps and two in the final scaling
        bound_ms, bound_by = bound(elt * B_ * (2 * (n_ * n_ + m_ * n_ + n_ + 2 * m_) + n_ + m_ + 1),
                                   {dtype_name(dtype): 32 * B_ * (n_ * n_ + m_ * n_)})
        print(f"K4 ruiz {label}: {path}; D, E bit-identical; two launches bit-identical; worst relative difference "
              f"over c, P, q, A, l, u {worst:.3e} (tol {tol:g}), |k-p|max {err:.3e}; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}), share of bound {bound_ms / ms:.3f}")
        if k and B_ == B:
            # every cluster size that fits this shape, for the choice of k
            sizes = [c for c in (1, 2, 4, 8) if k4.fits(n_, m_, c, dtype)]
            times = {c: cuda_ms(lambda: k4.launch(*args, 10, c), reps=10) for c in sizes}
            print(f"K4 ruiz {label}, resident path by cluster size: "
                  + ", ".join(f"k={c} {t:.4f} ms ({k4.resident_clusters(n_, m_, c, dtype)} clusters resident)"
                              for c, t in times.items()) + f" (chosen k={k})")
        stats[label] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                            library_ms=None)
    return stats[cases[0][0]]


def _random_state(B, n, m, dtype, dev, seed=1):
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(*s, generator=g, dtype=dtype, device=dev) for s in ((B, n), (B, m), (B, n), (B, m))]


def phase_k3(dev):
    import torch

    from osqp_tpu_torch.ops import ruiz as k4
    from osqp_tpu_torch.ops import term_products as k3

    B, n, m = HEADLINE["B"], HEADLINE["n"], HEADLINE["m"]
    headline = make_qps(B, n, m)
    cvxqp = maros_dense("CVXQP2_M")
    cases = ((f"B={B} n={n} m={m} float32", headline, torch.float32),
             ("CVXQP2_M B=1 n=1000 m=1250 float64", cvxqp, torch.float64),
             ("CVXQP2_M B=1 n=1000 m=1250 float32", cvxqp, torch.float32))
    stats = {}
    for label, arrays, dtype in cases:
        _, _, _, P, _, A, _, _ = k4.ruiz(*on_device(arrays, dtype, dev), 10)  # the scaled data of the path
        x, y, dx, dy = _random_state(P.shape[0], P.shape[1], A.shape[1], dtype, dev)
        tol = RTOL[dtype_name(dtype)]
        err = worst = 0.0
        for cert in (False, True):
            extra = (dx, dy) if cert else ()
            outk = k3.term_products(P, A, x, y, *extra)
            outp = k3.term_products_plain(P, A, x, y, *extra)
            torch.cuda.synchronize()
            for name, gk, gp in zip(outk._fields, outk, outp):
                if gp is None:
                    require(gk is None, f"K3 returned {name} without certificates")
                    continue
                diff, rel = rel_err(gk, gp)
                require(rel <= tol, f"K3 {name} off by {rel:.3e} relative at {label}")
                worst, err = max(worst, rel), max(err, diff)
        ms = cuda_ms(lambda: k3.term_products(P, A, x, y), reps=20)
        plain_ms = cuda_ms(lambda: k3.term_products_plain(P, A, x, y), reps=20)
        ms_cert = cuda_ms(lambda: k3.term_products(P, A, x, y, dx, dy), reps=20)
        plain_cert = cuda_ms(lambda: k3.term_products_plain(P, A, x, y, dx, dy), reps=20)
        B_, n_, m_ = P.shape[0], P.shape[1], A.shape[1]
        # with certificates: P, A, x, y, dx, dy read once, six products written; A x, A dx, A'y, A'dy and
        # P x, P dx take a multiply-add per matrix value each
        bound_ms, bound_by = bound(P.element_size() * B_ * (n_ * n_ + m_ * n_ + 6 * n_ + 4 * m_),
                                   {dtype_name(dtype): B_ * (8 * m_ * n_ + 4 * n_ * n_)})
        print(f"K3 term_products {label}: worst relative difference {worst:.3e} (tol {tol:g}), |k-p|max {err:.3e}; "
              f"Ax, Px, A'y: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; with certificates: kernel {ms_cert:.4f} ms, "
              f"plain {plain_cert:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), share of bound "
              f"{bound_ms / ms_cert:.3f}")
        stats[label] = dict(max_abs_err=err, ms=ms_cert, plain_ms=plain_cert, bound_ms=bound_ms, bound_by=bound_by,
                            library_ms=None)
    return stats[cases[0][0]]


def phase_k1r(dev):
    import torch

    from osqp_tpu_torch.ops import admm_iter as k1

    n, m = HEADLINE["n"], HEADLINE["m"]

    def operands(arrays, dtype, half=True):
        P, q, A, l, u = on_device(arrays, dtype, dev)
        B, n_, m_ = P.shape[0], P.shape[1], A.shape[1]
        scaled, rs, factor, dyn = prepared(P, q, A, l, u)
        x, z, dx, y = _random_state(B, n_, m_, dtype, dev, seed=2)
        dy = torch.randn_like(z)
        y_lo = 1e-7 * torch.randn_like(z) if dtype == torch.float32 else None
        active = torch.arange(B, device=dev) % 2 == 0 if half else torch.ones(B, dtype=torch.bool, device=dev)
        return (factor["Minv"], scaled.A, factor["P"], scaled.q, scaled.l, scaled.u, rs.rho_vec, rs.rho_inv_vec,
                float(dyn.sigma), float(dyn.alpha), active, x, z, y, dx, dy, y_lo)

    def compare(args, label):
        outk = k1.admm_iter_refined(*args)
        again = k1.admm_iter_refined(*args)
        outp = k1.admm_iter_refined_plain(*args)
        torch.cuda.synchronize()
        require(all((a is None and b is None) or torch.equal(a, b) for a, b in zip(outk, again)),
                f"K1r's two launches differ at {label}")
        active = args[10]
        tol = RTOL[dtype_name(args[11].dtype)]
        worst = err = 0.0
        for name, gk, gp, before in zip(("x", "z", "y", "dx", "dy", "y_lo"), outk, outp, args[11:]):
            if before is None:
                require(gk is None and gp is None, "K1r returned a carry it was not given")
                continue
            require(torch.equal(gk[~active], before[~active]), f"K1r changed inactive {name} at {label}")
            if name != "y_lo":  # the carry is held to TwoSum below
                diff, rel = rel_err(gk, gp)
                worst, err = max(worst, rel), max(err, diff)
        carry = ""
        if args[16] is not None:
            # (y', y_lo') must be exactly TwoSum(y, dy' + y_lo) on every active entry
            y, y_lo = args[13][active], args[16][active]
            bad_k = k1.twosum_violations(y, outk[4][active], y_lo, outk[2][active], outk[5][active])
            bad_p = k1.twosum_violations(y, outp[4][active], y_lo, outp[2][active], outp[5][active])
            carry = f"; TwoSum carry violated at {bad_k} (plain {bad_p}) of {y.numel()} active entries"
            require(bad_k == 0 and bad_p == 0, f"K1r's dual update is not TwoSum(y, dy + y_lo) at {label}")
        print(f"K1r admm_iter_refined {label}: worst |k-p|max/|p|max over x,z,y,dx,dy {worst:.3e} (rtol {tol:g}), "
              f"|k-p|max {err:.3e}; inactive instances bit-identical; two launches bit-identical{carry}")
        require(worst <= tol, f"K1r disagrees with its plain version at {label}")
        return err

    def residual_check(name):
        """The float64 residual of the float32 solve.  With x = z = y = 0
        and alpha = 1, x' is the solve x~ of M x~ = -q exactly; a random q
        makes it a generic right-hand side.  Against M's float64 solve, the
        kernel must land within F64_RESIDUAL_BOUND, and the same two
        corrections with a float32 residual must not."""
        P, q, A, l, u = on_device(maros_dense(name), torch.float32, dev)
        scaled, rs, factor, dyn = prepared(P, q, A, l, u)
        B, n_, m_ = P.shape[0], P.shape[1], A.shape[1]
        rhs = torch.randn(B, n_, generator=torch.Generator(device=dev).manual_seed(3), device=dev)
        zn, zm = torch.zeros(B, n_, device=dev), torch.zeros(B, m_, device=dev)
        sigma = float(dyn.sigma)
        x_k = k1.admm_iter_refined(factor["Minv"], scaled.A, factor["P"], rhs, scaled.l, scaled.u, rs.rho_vec,
                                   rs.rho_inv_vec, sigma, 1.0, torch.ones(B, dtype=torch.bool, device=dev),
                                   zn, zm, zm, zn, zm, zm)[0]
        A64, rho64 = scaled.A.double(), rs.rho_vec.double()
        M64 = (factor["P"].double() + sigma * torch.eye(n_, dtype=torch.float64, device=dev)
               + A64.transpose(1, 2) @ (rho64[:, :, None] * A64))
        truth = torch.linalg.solve(M64, -rhs.double())
        x32 = _solve_f32_residual(factor["Minv"], factor["P"], scaled.A, rs.rho_vec, dyn.sigma, -rhs)
        _, err_k = rel_err(x_k.double(), truth)
        _, err_32 = rel_err(x32.double(), truth)
        print(f"K1r float64 residual, {name} B=1 float32: |x~ - x*|max/|x*|max kernel {err_k:.3e}, "
              f"with a float32 residual {err_32:.3e} (bound {F64_RESIDUAL_BOUND:g})")
        require(err_k <= F64_RESIDUAL_BOUND, f"K1r's solve at {name} is off by {err_k:.3e}: no float64 residual?")
        require(err_32 > F64_RESIDUAL_BOUND, f"the float64-residual check at {name} does not tell the residuals apart")

    small = make_qps(512, n, m, seed=0, dtype=np.float64)
    compare(operands(small, torch.float64), "B=512 float64, half active")
    compare(operands(small, torch.float32), "B=512 float32, half active")
    B = HEADLINE["B"]
    head = operands(make_qps(B, n, m), torch.float32, half=False)
    err = compare(head, f"B={B} float32, all active")
    report_times(f"K1r admm_iter_refined B={B} n={n} m={m} float32 all active",
                 lambda: k1.admm_iter_refined(*head), lambda: k1.admm_iter_refined_plain(*head), 20,
                 *k1r_cost(B, n, m, torch.float32))
    cvxqp = maros_dense("CVXQP2_M")
    for dtype in (torch.float64, torch.float32):
        args = operands(cvxqp, dtype, half=False)
        label = f"CVXQP2_M B=1 n=1000 m=1250 {dtype_name(dtype)}"
        err = max(err, compare(args, label))
        stats = report_times(f"K1r admm_iter_refined {label}", lambda: k1.admm_iter_refined(*args),
                             lambda: k1.admm_iter_refined_plain(*args), 10, *k1r_cost(1, 1000, 1250, dtype))
    # Above what one block per instance could hold in shared memory.
    compare(k1r_args(random_operands(1, 2, 6000, torch.float64, dev)), "B=1 n=2 m=6000 float64")
    big = random_operands(1, 3000, 3000, torch.float32, dev)
    compare(k1r_args(big, 1e-7 * torch.randn_like(big["y"])), "B=1 n=3000 m=3000 float32")
    residual_check("CVXQP2_M")
    # stats: CVXQP2_M in float32, the shape and body of the Solver's K1r launches
    return dict(max_abs_err=err, library_ms=None, **stats)


def _solve_f32_residual(Minv, P, A, rho, sigma, t):
    """The refined float32 solve with its two residuals taken in float32:
    what K1r would give if it skipped the float64 residual."""
    from osqp_tpu_torch.linalg import mat_tvec, mat_vec

    apply_inv = lambda v: mat_tvec(Minv, v)
    x = apply_inv(t)
    for _ in range(2):
        x = x + apply_inv(t - (mat_vec(P, x) + sigma * x + mat_tvec(A, rho * mat_vec(A, x))))
    return x



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
    from osqp_tpu_torch.types import DynSettings

    B, n, m = HEADLINE["B"], HEADLINE["n"], HEADLINE["m"]
    P, q, A, l, u = on_device(make_qps(B, n, m), torch.float32, dev)
    torch.cuda.synchronize()

    reset_counts()
    t0 = time.perf_counter()
    res = ot.solve_batch(P, q, A, l, u, **SOLVE_KW)
    status = res.status_val.cpu().numpy()
    first_s = time.perf_counter() - t0
    launches = read_counts()
    iters = res.iter.cpu().numpy()
    solved = float(np.mean(status == ot.OSQP_SOLVED))
    x = res.x.cpu().numpy()
    print(f"headline B={B} n={n} m={m} f32: first solve {first_s:.3f} s, solved {solved:.4f}, "
          f"iterations mean {iters.mean():.2f} max {iters.max()}, launches {launches}")
    require(solved >= 0.99, f"solved fraction {solved} < 0.99")
    require(not np.any(status == ot.OSQP_MAX_ITER_REACHED), "an instance hit MAX_ITER_REACHED")
    require(np.isfinite(x[status == ot.OSQP_SOLVED]).all(), "non-finite x in a solved instance")
    require(x.shape == (B, n) and res.y.shape == (B, m), "result shapes")
    for name in ("admm_iter", "chol_inverse", "ruiz", "term_products"):
        require(launches[name] > 0, f"{name}, a kernel of the batched path, never launched")
    require(launches["ruiz_resident"] == launches["ruiz"], "the headline's K4 did not take the resident path")

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


def phase_solver(dev):
    """The stateful Solver path.  Counts are set to 0 before the phase and
    read after it; each solve also prints its own."""
    import torch

    import osqp_tpu_torch as ot
    from osqp_tpu_torch.io.qps import load_qps

    gold = np.load(GOLDENS)
    reset_counts()
    total = dict.fromkeys(read_counts(), 0)

    def run(label, make, cpu_make=None):
        before = read_counts()
        s = make(dev)
        r = s.solve()
        after = read_counts()
        delta = {k: after[k] - before[k] for k in after}
        for k in total:
            total[k] += delta[k]
        body = "+".join(b for b, k in (("plain K1", "admm_iter"), ("refined K1r", "admm_iter_refined")) if delta[k])
        it = max(r.info.iter, 1)
        print(f"Solver {label}: {r.info.status}, {r.info.iter} iterations, {r.info.rho_updates} rho updates, "
              f"obj {r.info.obj_val!r}; body {body or 'none'}; setup {s.info.setup_time * 1e3:.3f} ms, "
              f"solve {r.info.solve_time * 1e3:.3f} ms, {r.info.solve_time * 1e3 / it:.4f} ms/iteration; "
              f"launches {delta}")
        require(np.isfinite(r.x).all() and r.x.shape == (s.n,) and r.y.shape == (s.m,), f"Solver {label}: x, y")
        return s, r, delta

    P = np.array([[4.0, 1.0], [1.0, 2.0]])
    A = np.array([[1.0, 1.0], [1.0, 0.0], [0.0, 1.0]])
    quick = (P, np.array([1.0, 1.0]), A, np.array([1.0, 0.0, 0.0]), np.array([1.0, 0.7, 0.7]))
    for dtype in ("float64", "float32"):
        _, r, _ = run(f"quick start {dtype}", lambda d: ot.Solver(*quick, device=d, dtype=dtype, verbose=False))
        require(r.info.status_val == ot.OSQP_SOLVED and np.abs(r.x - [0.3, 0.7]).max() < 1e-2,
                f"quick start {dtype}: x = {r.x}")

    for name in ("CVXQP2_S", "CVXQP2_M"):
        qp = load_qps(os.path.join(MAROS, f"{name}.qps"))
        data = (qp.P, qp.q, qp.A, qp.l, qp.u)
        for dtype in ("float64", "float32"):
            g = lambda f: gold[f"{name}/{dtype}/{f}"]
            label = f"{name} n={qp.n} m={qp.m} {dtype}"
            s, r, delta = run(label, lambda d: ot.Solver(*data, device=d, dtype=dtype, polish=False, verbose=False))
            require(r.info.status_val == int(g("status_val")), f"{label}: status {r.info.status}")
            if dtype == "float64":
                same = (r.info.iter, r.info.rho_updates) == (int(g("iter")), int(g("rho_updates")))
                obj_rel = abs(r.info.obj_val - float(g("obj_val"))) / abs(float(g("obj_val")))
                print(f"  against the JAX package (CPU, goldens): iterations {r.info.iter} / {int(g('iter'))}, "
                      f"rho updates {r.info.rho_updates} / {int(g('rho_updates'))}, obj relative {obj_rel:.3e}, "
                      f"|dx|max {np.abs(r.x - g('x')).max():.3e}, |dy|max {np.abs(r.y - g('y')).max():.3e}")
                require(same and obj_rel <= 1e-6, f"{label} disagrees with the JAX package's run")
            else:
                print(f"  against the JAX package (CPU, goldens): iterations {r.info.iter} / {int(g('iter'))}")
                require(abs(r.info.iter - int(g("iter"))) <= 25, f"{label}: iterations {r.info.iter}")
                if name == "CVXQP2_M":
                    require(delta["admm_iter_refined"] > 0, f"{label}: the refined body (K1r) did not run")
            if name == "CVXQP2_S":
                require(delta["chol_inverse"] > 0, f"{label}: K2 did not factor")

    # Where a CVXQP2_M solve's time goes: one more solve in each dtype,
    # under the profiler (outside the counts above).
    qp = load_qps(os.path.join(MAROS, "CVXQP2_M.qps"))
    for dtype in ("float64", "float32"):
        s = ot.Solver(qp.P, qp.q, qp.A, qp.l, qp.u, device=dev, dtype=dtype, polish=False, verbose=False)
        r, wall, events = profiled(s.solve)
        it = max(r.info.iter, 1)
        k1_ms, busy = event_ms(events, K1_KERNELS), event_ms(events)
        print(f"Solver CVXQP2_M {dtype} under the profiler: wall {wall:.3f} ms over {r.info.iter} iterations = "
              f"{wall / it:.4f} ms/iteration; K1/K1r device time {k1_ms:.3f} ms = {k1_ms / it:.4f} ms/iteration "
              f"({k1_ms / wall:.3f} of the wall); device busy {busy:.3f} ms, idle share {1.0 - busy / wall:.3f}")

    # a warm re-solve after update_lin_cost, against the same sequence on the CPU
    qp = load_qps(os.path.join(MAROS, "CVXQP2_S.qps"))
    q2 = qp.q * 1.1 + 1.0
    results = []
    for d in (dev, torch.device("cpu")):
        s = ot.Solver(qp.P, qp.q, qp.A, qp.l, qp.u, device=d, dtype="float64", verbose=False)
        s.solve()
        if d == dev:
            before = read_counts()
        s.update_lin_cost(q2)
        r = s.solve()
        if d == dev:
            after = read_counts()
            for k in total:
                total[k] += after[k] - before[k]
        results.append(r)
    rg, rc = results
    print(f"Solver warm re-solve after update_lin_cost, CVXQP2_S float64: GPU {rg.info.status}, {rg.info.iter} "
          f"iterations, solve {rg.info.solve_time * 1e3:.3f} ms; CPU {rc.info.status}, {rc.info.iter} iterations; "
          f"|dx|max {np.abs(rg.x - rc.x).max():.3e}, |dy|max {np.abs(rg.y - rc.y).max():.3e}")
    require(rg.info.status_val == rc.info.status_val == ot.OSQP_SOLVED and rg.info.iter == rc.info.iter
            and np.abs(rg.x - rc.x).max() <= 1e-6 and np.abs(rg.y - rc.y).max() <= 1e-6,
            "warm re-solve on the GPU disagrees with the CPU")

    print(f"Solver path launches: {total}")
    for name, n_launch in total.items():
        require(n_launch > 0, f"{name} never launched on the Solver path")
    return total


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
    k4_stats = phase_k4(dev)
    k3_stats = phase_k3(dev)
    k1r_stats = phase_k1r(dev)
    phase_parity(dev)
    launches = phase_headline(dev)
    solver_launches = phase_solver(dev)

    # launches: the batched headline solve's, and for K1r, which that
    # well-conditioned batch does not run, the Solver path's (its times:
    # CVXQP2_M in float32, where the Solver runs it; the others' at the
    # headline shape).
    kernels = [
        dict(name="admm_iter", route="cuda", source="osqp_tpu_torch/csrc/admm_iter.cu",
             replaces="osqp_tpu/linsys/dense_inv.py:164", launches=launches["admm_iter"], **k1_stats),
        dict(name="admm_iter_refined", route="cuda", source="osqp_tpu_torch/csrc/admm_iter_refined.cu",
             replaces="osqp_tpu/linsys/dense_inv.py:173", launches=solver_launches["admm_iter_refined"],
             **k1r_stats),
        dict(name="chol_inverse", route="cuda", source="osqp_tpu_torch/csrc/chol_inverse.cu",
             replaces="osqp_tpu/ops/spd_inverse.py:167", launches=launches["chol_inverse"], **k2_stats),
        dict(name="ruiz", route="cuda", source="osqp_tpu_torch/csrc/ruiz.cu",
             replaces="osqp_tpu/scaling.py:51", launches=launches["ruiz"],
             launches_resident=launches["ruiz_resident"], launches_split=launches["ruiz"] - launches["ruiz_resident"],
             **k4_stats),
        dict(name="term_products", route="cuda", source="osqp_tpu_torch/csrc/term_products.cu",
             replaces="osqp_tpu/termination.py:47", launches=launches["term_products"], **k3_stats),
    ]
    print(json.dumps({"kernels": kernels}))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
