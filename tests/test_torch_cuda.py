"""osqp_tpu_torch's CUDA kernels against their plain versions, on a GPU.

Every test here needs a CUDA device and ``nvcc``, and skips without
them.  The file imports nothing of JAX, so that it runs on a machine
that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q

(``--noconftest``: ``tests/conftest.py`` configures JAX for the JAX
package's tests.)
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import osqp_tpu_torch
from osqp_tpu_torch.io.qps import load_qps
from osqp_tpu_torch.ops import admm_iter as k1
from osqp_tpu_torch.ops import block_tridiag as k7
from osqp_tpu_torch.ops import cg as k6
from osqp_tpu_torch.ops import ell as k5
from osqp_tpu_torch.ops import kkt_lu as k8
from osqp_tpu_torch.ops import ruiz as k4
from osqp_tpu_torch.ops import spd_inverse as k2
from osqp_tpu_torch.ops import term_products as k3

MAROS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "maros_mm")

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _spd(B, n, dtype, seed=0):
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((B, n, n))
    return torch.as_tensor(G @ G.transpose(0, 2, 1) / n + 0.1 * np.eye(n), dtype=dtype)


def _qps(B, n, m, seed=0):
    """The benchmark's random strictly convex QPs (bench.py:31-42)."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((B, n, n))
    P = np.einsum("bij,bkj->bik", M, M) / n + 0.1 * np.eye(n)
    q = rng.standard_normal((B, n))
    A = rng.standard_normal((B, m, n)) / np.sqrt(n)
    Ax = np.einsum("bmn,bn->bm", A, rng.standard_normal((B, n)))
    spread = np.abs(rng.standard_normal((B, m)))
    return P, q, A, Ax - spread - 0.1, Ax + spread + 0.1


# n from 1 to K2's shared-memory bound (240 in float32, 169 in float64):
# odd n, one panel, several panels with a ragged last one, whole panels,
# and the bound, where the leading dimension cannot be padded.
K2_CASES = [(torch.float32, 1e-4, n) for n in (1, 7, 33, 100, 128, 239, 240)] + [
    (torch.float64, 1e-11, n) for n in (1, 7, 33, 100, 128, 168, 169)]


@pytest.mark.parametrize("dtype,tol,n", K2_CASES)
def test_k2_kernel_matches_plain(dev, dtype, tol, n):
    """K2 against its plain version; two launches give the same bits."""
    M = _spd(13, n, dtype).to(dev)
    before = k2.launches
    Xk, again = k2.chol_inverse(M), k2.chol_inverse(M)
    torch.cuda.synchronize()
    assert k2.launches == before + 2
    assert torch.equal(Xk, again)
    Xp = k2.chol_inverse_plain(M)
    assert float((Xk - Xp).abs().max()) <= tol * float(Xp.abs().max())


def test_k2_kernel_at_its_bound_and_nan_on_non_pd(dev):
    """A negative diagonal, and a positive diagonal with a pivot that is
    not positive in the second panel, give NaN in the whole instance."""
    n = k2.max_n(torch.float64)
    M = _spd(3, n, torch.float64).to(dev)
    M[1, 3, 3] = -1.0
    big = 10.0 * float(torch.sqrt(M[2, 20, 20] * M[2, 21, 21]))
    M[2, 20, 21] = M[2, 21, 20] = big
    X = k2.chol_inverse(M)
    torch.cuda.synchronize()
    assert torch.isnan(X[1]).all() and torch.isnan(X[2]).all()
    Xp = k2.chol_inverse_plain(M[:1])
    assert float((X[:1] - Xp).abs().max()) <= 1e-10 * float(Xp.abs().max())


def _k1_args(B, n, m, dtype, dev, seed=0, with_P=False):
    """K1 operands of one step (K1r's with ``with_P``: P in place of
    AMinvT) from consistent data: Minv = (P + sigma I + A' rho A)^-1,
    made in float64 on the card; every other instance inactive."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, dtype=torch.float64).to(dev)
    sigma = 1e-6
    P = _spd(B, n, torch.float64, seed).to(dev)
    A = r(B, m, n) / max(n, 1) ** 0.5
    rho = r(B, m).abs() + 0.1
    M = P + sigma * torch.eye(n, dtype=torch.float64, device=dev) + A.transpose(1, 2) @ (rho[:, :, None] * A)
    Minv = torch.cholesky_inverse(torch.linalg.cholesky(M))
    l = r(B, m) - 1.0
    mats = dict(Minv=Minv, A=A, **({"P": P} if with_P else {"AMinvT": Minv @ A.transpose(1, 2)}))
    vecs = dict(q=r(B, n), l=l, u=l + 2.0, rho=rho, rho_inv=1.0 / rho, x=r(B, n), z=r(B, m), y=r(B, m),
                dx=r(B, n), dy=r(B, m))
    args = {k: v.to(dtype).contiguous() for k, v in {**mats, **vecs}.items()}
    return dict(args, sigma=sigma, alpha=1.6, active=torch.arange(B, device=dev) % 2 == 0)


# Only the order of summation differs from the plain versions.
K1_TOL = [(torch.float32, 1e-5), (torch.float64, 1e-12)]
# (B, n, m): small and ragged shapes with every other instance inactive;
# B=1 at CVXQP2_M's width, an instance split over many blocks; B=3 with
# the middle instance inactive; and shapes where one block per instance
# ran out of shared memory (B=1, n=2, m=6000; B=1, n=m=3000).
K1_SHAPES = [(8, 1, 1), (8, 7, 3), (8, 40, 0), (8, 100, 200), (8, 33, 65), (1, 1000, 1250), (3, 100, 200),
             (1, 2, 6000), (1, 3000, 3000)]


def _check_step(args, outk, outp, rtol, y_lo=None):
    """Active entries within rtol of the plain version (relative to its
    largest value, at least 1), inactive ones equal to the inputs."""
    inactive = ~args["active"]
    olds = [args[k] for k in ("x", "z", "y", "dx", "dy")] + [y_lo]
    for name, got, want, old in zip(("x", "z", "y", "dx", "dy", "y_lo"), outk, outp, olds):
        if old is None:
            assert got is None and want is None
            continue
        assert torch.equal(got[inactive], old[inactive]), name
        if want.numel() and name != "y_lo":
            assert float((got - want).abs().max()) <= rtol * max(float(want.abs().max()), 1.0), name


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("B,n,m", [(1, 600, 900), (2, 300, 1300), (1, 700, 0)])
def test_k3_is_one_launch_over_chunks_and_tiles(dev, dtype, tol, B, n, m):
    """Several column chunks and row tiles, whose partials the last block
    of each group adds: one kernel launch a call (counted by the
    profiler), within tol of plain, two calls bit-identical, and their
    outputs never share memory."""
    from torch.profiler import ProfilerActivity, profile

    P, _, A, _, _ = (torch.as_tensor(a, dtype=dtype).to(dev) for a in _qps(B, n, m, seed=4))
    g = torch.Generator().manual_seed(1)
    r = lambda *s: torch.randn(*s, generator=g, dtype=dtype).to(dev)
    x, y, dx, dy = r(B, n), r(B, m), r(B, n), r(B, m)
    first = k3.term_products(P, A, x, y, dx, dy)
    pad = torch.zeros(1, device=dev)
    torch.cuda.synchronize()
    # small kernels of another name around the call: the profiler may lose the first or last records
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(8):
            pad.add_(1)
        second = k3.term_products(P, A, x, y, dx, dy)
        for _ in range(8):
            pad.add_(1)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("products_kernel" in name for name in names) == k3.launches_per_call(B, n, m, True) == 1
    assert all("products_kernel" in name or "elementwise" in name for name in names)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert not {t.data_ptr() for t in first if t.numel()} & {t.data_ptr() for t in second if t.numel()}
    for got, want in zip(second, k3.term_products_plain(P, A, x, y, dx, dy)):
        assert got.shape == want.shape and _rel(got, want) <= tol


@pytest.mark.parametrize("dtype,rtol", K1_TOL)
@pytest.mark.parametrize("B,n,m", K1_SHAPES)
def test_k1_kernel_matches_plain(dev, dtype, rtol, B, n, m):
    """K1 against its plain version; two launches give the same bits."""
    args = _k1_args(B, n, m, dtype, dev)
    before = k1.launches
    outk, again = k1.admm_iter(**args), k1.admm_iter(**args)
    torch.cuda.synchronize()
    assert k1.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(outk, again))
    _check_step(args, outk, k1.admm_iter_plain(**args), rtol)


def test_wrappers_raise_on_non_contiguous_cuda_input(dev):
    M = _spd(2, 5, torch.float64).to(dev).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        k2.chol_inverse(M)
    args = _k1_args(2, 5, 4, torch.float64, dev)
    args["A"] = args["A"].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        k1.admm_iter(**args)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_solve_batch_gpu_matches_cpu(dev, dtype):
    P, q, A, l, u = _qps(32, 20, 30, seed=3)
    kw = dict(dtype=dtype, verbose=False)
    before = (k1.launches, k2.launches)
    rg = osqp_tpu_torch.solve_batch(P, q, A, l, u, device=dev, **kw)
    assert k1.launches > before[0] and k2.launches > before[1]
    rc = osqp_tpu_torch.solve_batch(P, q, A, l, u, device="cpu", **kw)
    assert torch.equal(rg.status_val.cpu(), rc.status_val)
    if dtype == "float64":
        assert torch.equal(rg.iter.cpu(), rc.iter)
        assert float((rg.x.cpu() - rc.x).abs().max()) <= 1e-6
        assert float((rg.y.cpu() - rc.y).abs().max()) <= 1e-6
    else:
        assert int((rg.iter.cpu() - rc.iter).abs().max()) <= 25


def _rel(got, want):
    scale = float(want.abs().max()) if want.numel() else 1.0
    return (float((got - want).abs().max()) if want.numel() else 0.0) / max(scale, 1e-300)


# (B, n, m): one column chunk and tile; several chunks and tiles (n > 256,
# B=1); no constraints; the headline shape.
SPLIT_SHAPES = [(16, 7, 5), (1, 300, 260), (2, 40, 0), (64, 100, 200)]


def _cluster_boundary(dtype):
    """The last square instance that fits a cluster in ``dtype``, and the
    first that does not (a host computation: no card needed)."""
    last = max(n for n in range(1, 513) if k4.cluster_size(n, n, dtype))
    return [(1, last, last), (1, last + 1, last + 1)]


# (B, n, m) for K4: resident with one CTA per cluster (k = 1), n = 1
# and no constraints, the headline shape (k = 2 in float32, 4 in
# float64), several column chunks on the split path (n > 512), and the
# last square shape that fits a cluster and the first that does not, in
# float32 and in float64 (each run in both dtypes).
K4_SHAPES = [(16, 7, 5), (3, 1, 0), (2, 40, 0), (64, 100, 200), (1, 300, 260), (1, 600, 100)] + \
    _cluster_boundary(torch.float32) + _cluster_boundary(torch.float64)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6), (torch.float64, 1e-12)])
@pytest.mark.parametrize("B,n,m", K4_SHAPES)
def test_k4_kernel_matches_plain(dev, dtype, tol, B, n, m):
    """K4 against its plain version on the path cluster_size picks: D
    and E bit for bit, two launches bit-identical, and the resident
    counter moved exactly where the shape fits a cluster."""
    args = [t.to(dev) for t in (torch.as_tensor(a, dtype=dtype) for a in _qps(B, n, m, seed=4))]
    k = k4.cluster_size(n, m, dtype)
    if (B, n, m) == (64, 100, 200):
        assert k > 1
    before = (k4.launches, k4.launches_resident)
    outk, again = k4.ruiz(*args, 10), k4.ruiz(*args, 10)
    torch.cuda.synchronize()
    assert (k4.launches, k4.launches_resident) == (before[0] + 2, before[1] + (2 if k else 0))
    assert all(torch.equal(a, b) for a, b in zip(outk, again))
    outp = k4.ruiz_plain(*args, 10)
    assert torch.equal(outk[1], outp[1]) and torch.equal(outk[2], outp[2])  # D, E bit for bit
    for got, want in zip(outk[:1] + outk[3:], outp[:1] + outp[3:]):
        assert _rel(got, want) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k4_resident_path_takes_rows_that_are_not_16_byte_aligned(dev, dtype):
    """Contiguous views that start one value into their storage: the
    resident path reads them without 16-byte loads, and still gives the
    plain version's D and E."""
    def offset_view(a):
        t = torch.as_tensor(a, dtype=dtype).to(dev)
        buf = torch.empty(t.numel() + 1, dtype=dtype, device=dev)
        buf[1:] = t.reshape(-1)
        return buf[1:].view(t.shape)
    args = [offset_view(a) for a in _qps(16, 100, 200, seed=7)]
    assert args[0].data_ptr() % 16 and k4.cluster_size(100, 200, dtype)
    outk, outp = k4.ruiz(*args, 10), k4.ruiz_plain(*args, 10)
    assert torch.equal(outk[1], outp[1]) and torch.equal(outk[2], outp[2])
    assert _rel(outk[3], outp[3]) <= 1e-6 and _rel(outk[5], outp[5]) <= 1e-6


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_k4_every_cluster_size_matches_plain(dev, k):
    """The resident path gives the plain version's D and E at the
    headline shape in float32 with every cluster size, cluster_size's
    choice (2) among them: k = 1 fits a block, one CTA per SM."""
    args = [t.to(dev) for t in (torch.as_tensor(a, dtype=torch.float32) for a in _qps(8, 100, 200, seed=6))]
    outk = k4.launch(*args, 10, k)
    outp = k4.ruiz_plain(*args, 10)
    assert torch.equal(outk[1], outp[1]) and torch.equal(outk[2], outp[2])
    assert _rel(outk[3], outp[3]) <= 1e-6 and _rel(outk[5], outp[5]) <= 1e-6


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("B,n,m", SPLIT_SHAPES)
@pytest.mark.parametrize("cert", [False, True])
def test_k3_kernel_matches_plain(dev, dtype, tol, B, n, m, cert):
    P, _, A, _, _ = (torch.as_tensor(a, dtype=dtype).to(dev) for a in _qps(B, n, m, seed=5))
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g, dtype=dtype).to(dev)
    x, y = r(B, n), r(B, m)
    extra = (r(B, n), r(B, m)) if cert else ()
    before = k3.launches
    outk = k3.term_products(P, A, x, y, *extra)
    torch.cuda.synchronize()
    assert k3.launches == before + 1
    outp = k3.term_products_plain(P, A, x, y, *extra)
    for got, want in zip(outk, outp):
        assert (got is None) == (want is None)
        if want is not None:
            assert got.shape == want.shape and _rel(got, want) <= tol


@pytest.mark.parametrize("dtype,rtol", K1_TOL)
@pytest.mark.parametrize("B,n,m", K1_SHAPES)
def test_k1r_kernel_matches_plain(dev, dtype, rtol, B, n, m):
    """K1r against its plain version; two launches give the same bits, and
    in float32 the carry is exactly TwoSum on every active entry."""
    args = _k1_args(B, n, m, dtype, dev, with_P=True)
    y_lo = 1e-7 * torch.randn_like(args["y"]) if dtype == torch.float32 else None
    before = k1.refined_launches
    outk, again = k1.admm_iter_refined(y_lo=y_lo, **args), k1.admm_iter_refined(y_lo=y_lo, **args)
    torch.cuda.synchronize()
    assert k1.refined_launches == before + 2
    assert all((a is None and b is None) or torch.equal(a, b) for a, b in zip(outk, again))
    _check_step(args, outk, k1.admm_iter_refined_plain(y_lo=y_lo, **args), rtol, y_lo)
    if y_lo is not None:
        a = args["active"]
        assert k1.twosum_violations(args["y"][a], outk[4][a], y_lo[a], outk[2][a], outk[5][a]) == 0


# K1r's resident path named directly, at shapes the plan sends to the
# split path (B below the SM count): odd n and m, m = 0, float64 without
# a carry, every other instance inactive, each cluster size, P's slab
# resident and read from device memory, and more CTAs than rows.
K1R_RESIDENT = [
    (torch.float32, 1e-5, 40, 37, 53, 1, True),
    (torch.float32, 1e-5, 40, 37, 53, 2, False),
    (torch.float64, 1e-12, 40, 37, 53, 4, True),
    (torch.float32, 1e-5, 24, 33, 0, 2, True),
    (torch.float64, 1e-12, 24, 100, 200, 2, True),
    (torch.float32, 1e-5, 20, 129, 77, 8, False),
    (torch.float32, 1e-5, 17, 300, 511, 16, True),
    (torch.float64, 1e-12, 9, 5, 3, 16, False),
]


@pytest.mark.parametrize("dtype,rtol,B,n,m,k,p_res", K1R_RESIDENT)
def test_k1r_resident_matches_plain(dev, dtype, rtol, B, n, m, k, p_res):
    """The resident kernel against K1r's plain version: two launches give
    the same bits, inactive instances are copied through, the float32
    carry is exactly TwoSum."""
    args = _k1_args(B, n, m, dtype, dev, with_P=True)
    y_lo = 1e-7 * torch.randn_like(args["y"]) if dtype == torch.float32 else None
    before = k1.refined_launches_resident
    outk = k1.launch_refined(y_lo=y_lo, cluster=k, p_res=p_res, **args)
    again = k1.launch_refined(y_lo=y_lo, cluster=k, p_res=p_res, **args)
    torch.cuda.synchronize()
    assert k1.refined_launches_resident == before + 2
    assert all((a is None and b is None) or torch.equal(a, b) for a, b in zip(outk, again))
    _check_step(args, outk, k1.admm_iter_refined_plain(y_lo=y_lo, **args), rtol, y_lo)
    if y_lo is not None:
        a = args["active"]
        assert k1.twosum_violations(args["y"][a], outk[4][a], y_lo[a], outk[2][a], outk[5][a]) == 0


def test_k1r_plan_takes_the_resident_path_on_a_batch(dev):
    """From B = the SM count up, admm_iter_refined launches the resident
    kernel (clusters of 1 at n=100, m=200 in float32) and agrees with the
    split path named directly."""
    from osqp_tpu_torch import _build

    B = _build.sm_count(dev)
    assert k1.refined_plan(B, 100, 200, torch.float32, B) == ("resident", 1)
    args = _k1_args(B, 100, 200, torch.float32, dev, with_P=True)
    before = k1.refined_launches_resident
    out = k1.admm_iter_refined(**args)
    assert k1.refined_launches_resident == before + 1
    split = k1.launch_refined(cluster=0, **args)
    assert k1.refined_launches_resident == before + 1
    for got, want in zip(out[:5], split[:5]):
        assert _rel(got, want) <= 1e-5


def test_k1r_resident_refuses_what_does_not_fit(dev):
    """A cluster size the path does not take, or a share above a CTA's
    shared memory, raises before any launch."""
    args = _k1_args(2, 372, 612, torch.float32, dev, with_P=True)
    with pytest.raises(ValueError, match="no resident path"):
        k1.launch_refined(cluster=3, **args)
    with pytest.raises(ValueError, match="no resident path"):
        k1.launch_refined(cluster=1, **args)


def test_k1r_kernel_residual_is_f64(dev):
    """K1r's float32 solve at CVXQP2_S (cond(M) ~ 4e3) lands within 1e-7
    of M's float64 solve, relative; the same corrections with a float32
    residual land outside.  x = z = y = 0 and alpha = 1 make x' the solve
    of M x~ = -q exactly, for a random q."""
    from osqp_tpu_torch.linalg import mat_tvec, mat_vec

    qp = load_qps(os.path.join(MAROS, "CVXQP2_S.qps"))
    s = osqp_tpu_torch.Solver(qp.P, qp.q, qp.A, qp.l, qp.u, device=dev, dtype="float32", verbose=False)
    data, rs, factor, sigma = s.data, s.rho_state, s.factor, float(s._dyn.sigma)
    n, m = s.n, s.m
    rhs = torch.as_tensor(np.random.default_rng(3).standard_normal((1, n)), dtype=torch.float32).to(dev)
    zn, zm = torch.zeros(1, n, device=dev), torch.zeros(1, m, device=dev)
    x_k = k1.admm_iter_refined(factor["Minv"], data.A, factor["P"], rhs, data.l, data.u, rs.rho_vec, rs.rho_inv_vec,
                               sigma, 1.0, torch.ones(1, dtype=torch.bool, device=dev), zn, zm, zm, zn, zm, zm)[0]
    A64 = data.A.double()
    M64 = factor["P"].double() + sigma * torch.eye(n, dtype=torch.float64, device=dev)
    M64 = M64 + A64.transpose(1, 2) @ (rs.rho_vec.double()[:, :, None] * A64)
    truth = torch.linalg.solve(M64, -rhs.double())
    apply_inv = lambda v: mat_tvec(factor["Minv"], v)
    x32 = apply_inv(-rhs)
    for _ in range(2):
        Mx = mat_vec(factor["P"], x32) + sigma * x32 + mat_tvec(data.A, rs.rho_vec * mat_vec(data.A, x32))
        x32 = x32 + apply_inv(-rhs - Mx)
    assert _rel(x_k.double(), truth) <= 1e-7 < _rel(x32.double(), truth)


def test_new_wrappers_raise_on_non_contiguous_cuda_input(dev):
    P, q, A, l, u = (torch.as_tensor(a).to(dev) for a in _qps(2, 5, 4))
    At = A.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        k4.ruiz(P, q, At, l, u, 3)
    with pytest.raises(ValueError, match="contiguous"):
        k3.term_products(P, At, q, l)
    args = _k1_args(2, 5, 4, torch.float64, dev, with_P=True)
    args["A"] = args["A"].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        k1.admm_iter_refined(**args)


def test_entry_points_default_to_the_card(dev):
    """Solver and solve_batch on numpy input, with no ``device``, run on
    the CUDA card and launch its kernels there."""
    qp = load_qps(os.path.join(os.path.dirname(MAROS), "HS21.qps"))
    before = (k1.launches + k1.refined_launches, k3.launches)
    s = osqp_tpu_torch.Solver(qp.P, qp.q, qp.A, qp.l, qp.u, dtype="float64", verbose=False)
    assert s.device.type == "cuda" and s.data.P.device.type == "cuda"
    assert s.solve().info.status_val == osqp_tpu_torch.OSQP_SOLVED
    res = osqp_tpu_torch.solve_batch(*_qps(4, 10, 15, seed=2), dtype="float64", verbose=False)
    assert res.x.device.type == res.status_val.device.type == "cuda"
    assert (res.status_val == osqp_tpu_torch.OSQP_SOLVED).all()
    assert k1.launches + k1.refined_launches > before[0] and k3.launches > before[1]


@pytest.mark.parametrize("name", ["CVXQP2_S", "HS21"])
def test_solver_gpu_matches_cpu(dev, name):
    """The stateful Solver on the GPU against the Solver on the CPU in
    float64: the same status and iterations, x and y within 1e-6; K3
    and K4 launched on the way."""
    path = os.path.join(MAROS if name.startswith("CVXQP") else os.path.dirname(MAROS), f"{name}.qps")
    qp = load_qps(path)
    kw = dict(dtype="float64", verbose=False)
    before = (k3.launches, k4.launches)
    sg = osqp_tpu_torch.Solver(qp.P, qp.q, qp.A, qp.l, qp.u, device=dev, **kw)
    rg = sg.solve()
    assert k3.launches > before[0] and k4.launches > before[1]
    rc = osqp_tpu_torch.Solver(qp.P, qp.q, qp.A, qp.l, qp.u, device="cpu", **kw).solve()
    assert rg.info.status_val == rc.info.status_val == osqp_tpu_torch.OSQP_SOLVED
    assert rg.info.iter == rc.info.iter
    assert np.abs(rg.x - rc.x).max() <= 1e-6 and np.abs(rg.y - rc.y).max() <= 1e-6
    sg.update_lin_cost(qp.q * 1.1)
    assert sg.solve().info.status_val == osqp_tpu_torch.OSQP_SOLVED


def _kkt(B, n, m, dtype, dev, seed=0, delta=None):
    """K = [[P + s I, A'], [A, -diag(d)]] from random data made in float64:
    the ADMM form (s = 1e-6, d = 1/rho), or with ``delta`` the polish form
    (s = d = delta, about half of A's rows zeroed)."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, dtype=torch.float64).to(dev)
    P = _spd(B, n, torch.float64, seed).to(dev)
    A = r(B, m, n) / max(n, 1) ** 0.5
    if delta is None:
        K = k8.form_kkt(P, A, 1e-6, 1.0 / (0.1 + r(B, m).abs()))
    else:
        A = A * (r(B, m) > 0)[:, :, None]
        K = k8.form_kkt(P, A, delta, torch.full((B, m), delta, dtype=torch.float64, device=dev))
    return K.to(dtype).contiguous()


# N = n + m: one value, one ragged panel, exactly one panel, one panel and
# a row, several panels, the headline's N, panels narrower than 32 columns
# (f64 above ~870 rows, f32 above ~1750) and, in float64 at N = 3400, a
# panel that fits no shared memory and is factored in device memory.
K8_SHAPES = [(3, 1, 0, None), (5, 3, 4, None), (5, 12, 20, None), (5, 12, 21, None), (7, 30, 45, 1e-6),
             (3, 100, 200, 1e-6), (2, 400, 500, None), (1, 1000, 1250, 1e-6), (1, 1500, 1900, None)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("B,n,m,delta", K8_SHAPES)
def test_k8_factor_matches_plain(dev, dtype, B, n, m, delta):
    """K8's factor gives the plain version's perm and lu bit for bit (every
    update in the same order with the same rounding), twice."""
    K = _kkt(B, n, m, dtype, dev, seed=n, delta=delta)
    keep = K.clone()
    before = k8.launches_factor
    lu, perm = k8.kkt_lu_factor(K)
    lu2, perm2 = k8.kkt_lu_factor(K)
    torch.cuda.synchronize()
    assert k8.launches_factor == before + 2
    assert torch.equal(K, keep)
    assert torch.equal(lu, lu2) and torch.equal(perm, perm2)
    lp, pp = k8.kkt_lu_factor_plain(K)
    assert perm.dtype == torch.int32 and torch.equal(perm, pp)
    assert torch.isfinite(lu).all() and torch.equal(lu, lp)
    assert lu.data_ptr() != K.data_ptr()


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("B,n,m,delta", K8_SHAPES + [(200, 20, 30, 1e-6)])
def test_k8_solve_matches_plain(dev, dtype, tol, B, n, m, delta):
    """K8's solve against its plain version, relative to the largest
    entry, by its backward error against K, and row by row against the
    factors it read, |L U x - b[perm]| <= 8 sqrt(N) eps (|L| |U| |x| +
    |b[perm]|), which no scale of x (b / delta in a masked row) and no
    cond(K) loosens; two launches give the same bits.  B = 200 takes the
    narrow blocks, the others the wide ones."""
    K = _kkt(B, n, m, dtype, dev, seed=n, delta=delta)
    lu, perm = k8.kkt_lu_factor(K)
    b = torch.randn(B, n + m, dtype=dtype, device=dev, generator=torch.Generator(device=dev).manual_seed(1))
    before = k8.launches_solve
    x, again = k8.kkt_lu_solve(lu, perm, b), k8.kkt_lu_solve(lu, perm, b)
    torch.cuda.synchronize()
    assert k8.launches_solve == before + 2 and torch.equal(x, again)
    assert _rel(x, k8.kkt_lu_solve_plain(lu, perm, b)) <= tol
    K64, x64 = K.double(), x.double()
    resid = (torch.bmm(K64, x64[:, :, None])[:, :, 0] - b.double()).abs().amax(-1)
    backward = resid / (K64.abs().sum(-1).amax(-1) * x64.abs().amax(-1))
    assert float(backward.max()) <= (1e-13 if dtype == torch.float64 else 1e-5)
    lu64 = lu.double()
    U, L = torch.triu(lu64), torch.tril(lu64, -1)
    L.diagonal(dim1=-2, dim2=-1).fill_(1.0)
    pb = torch.gather(b.double(), 1, perm.long())
    through = lambda L, U, v: torch.bmm(L, torch.bmm(U, v[:, :, None]))[:, :, 0]
    rowwise = (through(L, U, x64) - pb).abs() / (through(L.abs(), U.abs(), x64.abs()) + pb.abs())
    assert float(rowwise.max()) <= 8 * (n + m) ** 0.5 * torch.finfo(dtype).eps


def test_k8_singular_gives_non_finite(dev):
    """A zero row and column: Inf/NaN in that instance, no exception; the
    other instances are untouched by it."""
    K = _kkt(3, 6, 9, torch.float64, dev)
    K[1, :, 4] = 0.0
    K[1, 4, :] = 0.0
    lu, perm = k8.kkt_lu_factor(K)
    x = k8.kkt_lu_solve(lu, perm, torch.ones(3, 15, dtype=torch.float64, device=dev))
    torch.cuda.synchronize()
    assert not torch.isfinite(x[1]).all()
    lp, pp = k8.kkt_lu_factor_plain(K[[0, 2]])
    assert torch.equal(lu[[0, 2]], lp) and torch.equal(perm[[0, 2]], pp)


def test_k8_wrappers_raise_on_non_contiguous_cuda_input(dev):
    K = _kkt(2, 4, 5, torch.float64, dev)
    with pytest.raises(ValueError, match="contiguous"):
        k8.kkt_lu_factor(K.transpose(1, 2))
    lu, perm = k8.kkt_lu_factor(K)
    b = torch.ones(2, 18, dtype=torch.float64, device=dev)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        k8.kkt_lu_solve(lu, perm, b)


@pytest.mark.parametrize("backend", ["dense_inv", "kkt_lu", "dense_chol"])
def test_polish_and_backends_gpu_match_cpu(dev, backend):
    """solve_batch with polish on through each dense backend, on the GPU
    against the CPU in float64: the same statuses, iterations and
    status_polish, x and y within 1e-6; K8 launched 4 + 16 times by the
    polish, and by every factor and iteration of the kkt_lu backend."""
    data = _qps(16, 20, 30, seed=11)
    kw = dict(dtype="float64", verbose=False, polish=True, linsys_solver=backend)
    before = (k8.launches_factor, k8.launches_solve)
    rg = osqp_tpu_torch.solve_batch(*data, device=dev, **kw)
    torch.cuda.synchronize()
    factors, solves = k8.launches_factor - before[0], k8.launches_solve - before[1]
    rc = osqp_tpu_torch.solve_batch(*data, device="cpu", **kw)
    assert torch.equal(rg.status_val.cpu(), rc.status_val) and torch.equal(rg.iter.cpu(), rc.iter)
    assert torch.equal(rg.status_polish.cpu(), rc.status_polish) and (rc.status_polish == 1).any()
    assert float((rg.x.cpu() - rc.x).abs().max()) <= 1e-6 and float((rg.y.cpu() - rc.y).abs().max()) <= 1e-6
    if backend == "kkt_lu":
        assert factors >= 4 + 1 and solves == 16 + int(rc.iter.max())
    else:
        assert (factors, solves) == (4, 16)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_solver_polish_gpu_matches_cpu(dev, dtype):
    """Solver(polish=True) at CVXQP2_S on the GPU against the CPU."""
    qp = load_qps(os.path.join(MAROS, "CVXQP2_S.qps"))
    kw = dict(dtype=dtype, verbose=False, polish=True)
    rg = osqp_tpu_torch.Solver(qp.P, qp.q, qp.A, qp.l, qp.u, device=dev, **kw).solve()
    rc = osqp_tpu_torch.Solver(qp.P, qp.q, qp.A, qp.l, qp.u, device="cpu", **kw).solve()
    assert rg.info.status_val == rc.info.status_val == osqp_tpu_torch.OSQP_SOLVED
    assert rg.info.status_polish == rc.info.status_polish == 1 and rg.info.polish_time > 0
    if dtype == "float64":
        assert rg.info.iter == rc.info.iter
        assert np.abs(rg.x - rc.x).max() <= 1e-6 and np.abs(rg.y - rc.y).max() <= 1e-6 * np.abs(rc.y).max()


def _ell(M, B, dtype, dev, seed=0, sym=False):
    """An ELL operand of the scipy matrix M with per-instance values."""
    import dataclasses

    from osqp_tpu_torch.sparse_ops import ell_from_scipy

    E = ell_from_scipy(M, dtype, batch=B, sym_from_triu=sym, device=dev).contiguous()
    f = 1.0 + torch.rand(B, 1, 1, generator=torch.Generator().manual_seed(seed), dtype=torch.float64)
    f = f.to(dtype).to(dev)
    return dataclasses.replace(E, val=(E.val * f).contiguous(), t_val=(E.t_val * f).contiguous())


# K6 against its plain loop after tens of CG steps: the dot products sum in
# another order, and CG carries the rounding of alpha and beta forward,
# grown by cond(M) (float64 at B=4, n=3000 below: 9.7e-12 relative after
# the cold solve to 1e-7).
K6_TOL = {torch.float32: 1e-4, torch.float64: 1e-9}
K5_MODES = ["matvec", "tmatvec", "tmatvec_weighted", "sq_colsums", "row_norms", "col_norms", "diagonal", "scale"]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("mode", K5_MODES)
@pytest.mark.parametrize("B,m,n", [(3, 17, 11), (1, 12500, 10000), (64, 300, 200)])
def test_k5_kernel_matches_plain(dev, dtype, mode, B, m, n):
    """Every K5 mode against its plain version, which sums in the
    kernel's slot order: every result bit for bit, sums included; two
    launches give the same bits."""
    import scipy.sparse as sp

    rng = np.random.default_rng(B + m)
    A = _ell(sp.random(m, n, density=min(0.3, 5.0 / n), random_state=rng, format="csr"), B, dtype, dev)
    Pm = sp.random(n, n, density=min(0.3, 5.0 / n), random_state=rng) + sp.eye(n)
    P = _ell(sp.triu(Pm, format="csr"), B, dtype, dev, sym=True)
    r = lambda *s: torch.as_tensor(rng.standard_normal(s), dtype=dtype, device=dev)
    x, y, w, cw = r(B, n), r(B, m), r(B, m).abs() + 0.1, r(B, n).abs() + 0.1
    call = {
        "matvec": lambda f: f(A, x), "tmatvec": lambda f: f(A, y), "tmatvec_weighted": lambda f: f(A, y, w),
        "sq_colsums": lambda f: f(A, w), "row_norms": lambda f: f(A, cw), "col_norms": lambda f: f(A, w),
        "diagonal": lambda f: f(P), "scale": lambda f: f(A, w, cw, cw[:, 0] + 1.0),
    }[mode]
    name = {"tmatvec_weighted": "ell_tmatvec"}.get(mode, f"ell_{mode}")
    before = k5.launches
    got, again = call(getattr(k5, name)), call(getattr(k5, name))
    torch.cuda.synchronize()
    assert k5.launches == before + 2
    want = call(getattr(k5, f"{name}_plain"))
    if mode == "scale":
        for f in ("val", "t_val"):
            assert torch.equal(getattr(got, f), getattr(again, f)) and torch.equal(getattr(got, f), getattr(want, f))
        return
    assert torch.equal(got, again)
    assert torch.equal(got, want)
    assert float((got - want).abs().max()) == 0.0


def _k_slots(m, n, k, rng, sym=False):
    """A scipy (m, n) matrix whose rows hold 1 to k nonzeros, every seventh
    exactly k; with ``sym``, the upper triangle of a random symmetric one
    with about k nonzeros a row and a full diagonal."""
    import scipy.sparse as sp

    counts = rng.integers(1, k + 1, m)
    counts[::7] = k
    if sym:
        M = sp.random(m, n, density=min(1.0, k / (2.0 * n)), random_state=rng) + sp.eye(m, n)
        return sp.triu(M, format="csr")
    cols = [np.sort(rng.choice(n, c, replace=False)) for c in counts]
    indptr = np.concatenate([[0], np.cumsum(counts)])
    return sp.csr_matrix((rng.standard_normal(indptr[-1]), np.concatenate(cols), indptr), shape=(m, n))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("k", [1, 3, 9, 16, 17])
@pytest.mark.parametrize("B", [1, 64])
def test_k5_grouped_launch_matches_plain(dev, dtype, k, B):
    """Eight products of every mode, rows of up to k slots (the staged
    path to 16, the run-time loop above, mixed in one launch where the
    transpose's rows are longer), in one launch of the grouped kernel:
    each bit for bit its single plain function; nine products take two
    launches; a launch's products equal their one-job launches."""
    rng = np.random.default_rng(100 * k + B)
    m, n = 700, 500
    A = _ell(_k_slots(m, n, k, rng), B, dtype, dev, seed=k)
    P = _ell(_k_slots(n, n, k, rng, sym=True), B, dtype, dev, seed=k + 1, sym=True)
    r = lambda *s: torch.as_tensor(rng.standard_normal(s), dtype=dtype, device=dev)
    x, y, w, cw = r(B, n), r(B, m), r(B, m).abs() + 0.1, r(B, n).abs() + 0.1
    calls = [(k5.ell_matvec, A, x), (k5.ell_tmatvec, A, y), (k5.ell_tmatvec, A, y, w), (k5.ell_sq_colsums, A, w),
             (k5.ell_row_norms, A, cw), (k5.ell_col_norms, A, w), (k5.ell_diagonal, P), (k5.ell_matvec, P, x)]
    before = (k5.launches, k5.launches_group)
    got = k5.ell_products(*calls)
    torch.cuda.synchronize()
    assert (k5.launches - before[0], k5.launches_group - before[1]) == (1, 1)
    for (f, *args), o in zip(calls, got):
        want = getattr(k5, f"{f.__name__}_plain")(*args)
        assert torch.equal(o, want), f.__name__
        assert torch.equal(o, f(*args)), f.__name__
    before = k5.launches_group
    again = k5.ell_products(*calls, (k5.ell_matvec, A, x))
    torch.cuda.synchronize()
    assert k5.launches_group - before == 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("k", [1, 3, 9, 17])
@pytest.mark.parametrize("with_rhs", [True, False])
def test_k5_cg_start_matches_plain(dev, dtype, k, with_rhs):
    """The fused CG start (P x0 with A x0 in one grouped launch, then the
    start kernel) against its plain version: b, r and z bit for bit, with
    sigma as the cg backend passes it (a 0-d host tensor) and as a Python
    float, which the wrapper rounds to the dtype as PyTorch does."""
    rng = np.random.default_rng(7 * k)
    B, m, n = 3, 600, 400
    A = _ell(_k_slots(m, n, k, rng), B, dtype, dev, seed=k)
    P = _ell(_k_slots(n, n, k, rng, sym=True), B, dtype, dev, seed=k + 1, sym=True)
    r = lambda *s: torch.as_tensor(rng.standard_normal(s), dtype=dtype, device=dev)
    rho = r(B, m).abs() + 0.1
    x0, dinv, rhs_x, rhs_z = r(B, n), r(B, n).abs(), r(B, n), r(B, m)
    for sigma in (torch.tensor(1e-6, dtype=dtype), 1.1e-6):
        args = (P, A, rho, x0, dinv, sigma, rhs_x) + ((rhs_z, rho) if with_rhs else ())
        before = (k5.launches_group, k5.launches_start)
        got = k5.ell_cg_start(*args)
        torch.cuda.synchronize()
        assert (k5.launches_group - before[0], k5.launches_start - before[1]) == (1, 1)
        want = k5.ell_cg_start_plain(*args)
        for o, w in zip(got, want):
            assert torch.equal(o, w)
        assert (got[0] is rhs_x) == (not with_rhs)


def test_k5_raises_on_broadcast_values(dev):
    """The kernel takes contiguous values and says so; it copies nothing."""
    import scipy.sparse as sp

    from osqp_tpu_torch.sparse_ops import ell_from_scipy

    E = ell_from_scipy(sp.eye(5, format="csr"), torch.float64, batch=2, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        k5.ell_matvec(E, torch.ones(2, 5, dtype=torch.float64, device=dev))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kind", ["ell", "dense"])
@pytest.mark.parametrize("max_iter", [11, 1000])
def test_k6_kernel_matches_plain(dev, dtype, kind, max_iter):
    """K6 against its plain loop: the same steps per instance, x bit for
    bit (the plain step summing in the kernel's order, over K5's plain
    products, which sum in K5's order), an instance frozen from the start
    bit-unchanged, two runs bit-identical, and no step past max_iter
    (11 = a chunk of 8 and 3).  ELL operands take the device loop, one
    launch per solve, and the stepwise path gives the same bits; dense
    ones take the dense loop, one launch per solve, against the plain loop
    over the products in its order (DenseOperator.ordered, the start
    summed in the kernel's order too)."""
    import scipy.sparse as sp

    from osqp_tpu_torch.linsys import cg

    rng = np.random.default_rng(6)
    B, n, m = 4, 3000, 2000
    Pm = sp.random(n, n, density=3.0 / n, random_state=rng)
    Pm = (Pm @ Pm.T + 0.1 * sp.eye(n)).tocsr()
    Am = sp.random(m, n, density=3.0 / n, random_state=rng, format="csr")
    if kind == "ell":
        P, A = _ell(sp.triu(Pm, format="csr"), B, dtype, dev, sym=True), _ell(Am, B, dtype, dev)
    else:
        P = torch.as_tensor(np.stack([Pm[:300, :300].toarray()] * B), dtype=dtype, device=dev)
        A = torch.as_tensor(np.stack([Am[:200, :300].toarray()] * B), dtype=dtype, device=dev)
    nn, mm = (n, m) if kind == "ell" else (300, 200)
    rho = torch.as_tensor(rng.random((B, mm)) + 0.1, dtype=dtype, device=dev)
    fac = cg.init(P, A, torch.tensor(1e-6, dtype=dtype), rho)
    b = torch.as_tensor(rng.standard_normal((B, nn)), dtype=dtype, device=dev)
    x0 = torch.as_tensor(rng.standard_normal((B, nn)), dtype=dtype, device=dev)
    tol = torch.tensor([1e-7, 1e-5, 1e-3, 1e9], dtype=dtype, device=dev)
    args = (P, A, fac["sigma"], rho, fac["dinv"], b, x0, tol, max_iter)
    before, before_loop, before_dense = k6.launches, k6.launches_loop, k6.launches_dense_loop
    xk, sk = k6.cg_solve(*args)
    xk2, sk2 = k6.cg_solve(*args)
    torch.cuda.synchronize()
    if kind == "ell":
        assert k6.launches_loop - before_loop == 2 and k6.launches == before
        xp, sp_ = k6.cg_solve_plain(*args, dot=k6.kernel_dot)
    else:
        assert k6.launches_dense_loop - before_dense == 2 and k6.launches == before
        assert k6.launches_loop == before_loop
        op = k6._operator(P, A, rho, plain=False)
        xp, sp_ = k6.pcg_solve_plain(op.ordered, fac["sigma"], fac["dinv"], b, tol, max_iter, x0, dot=k6.kernel_dot,
                                     start_dot=k6.kernel_dot)
    assert torch.equal(xk, xk2) and torch.equal(sk, sk2)
    assert torch.equal(sk, sp_) and int(sk.max()) <= max_iter
    assert torch.equal(xk[3], x0[3]) and int(sk[3]) == 0
    assert torch.equal(xk, xp)
    assert float((xk - xp).abs().max()) <= K6_TOL[dtype] * float(xp.abs().max())
    if kind == "ell":
        # ELL operands run the device loop; the stepwise path gives the same bits
        xs, ss = k6.pcg_solve_stepwise(k6._operator(P, A, rho, plain=False), fac["sigma"], fac["dinv"], b, tol,
                                       max_iter, x0)
        assert torch.equal(xs, xk) and torch.equal(ss, sk)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_solve_sparse_on_the_card_matches_the_cpu(dev, dtype):
    """solve_sparse on the card against the CPU's plain path."""
    import scipy.sparse as sp

    rng = np.random.default_rng(0)
    n, m = 200, 300
    M = sp.random(n, n, density=0.02, random_state=rng, format="csc")
    P = sp.triu(M @ M.T + 0.1 * sp.eye(n), format="csc")
    A = sp.random(m, n, density=0.02, random_state=rng, format="csc") + sp.eye(m, n, format="csc")
    xr = rng.standard_normal(n)
    s = np.abs(rng.standard_normal(m)) + 0.1
    q = rng.standard_normal(n)
    kw = dict(dtype=dtype, verbose=False)
    rg = osqp_tpu_torch.solve_sparse(P, q, A, A @ xr - s, A @ xr + s, device=dev, **kw)
    rc = osqp_tpu_torch.solve_sparse(P, q, A, A @ xr - s, A @ xr + s, device="cpu", **kw)
    assert torch.equal(rg.status_val.cpu(), rc.status_val)
    if dtype == "float64":
        assert torch.equal(rg.iter.cpu(), rc.iter)
        assert float((rg.x.cpu() - rc.x).abs().max()) <= 1e-6
    else:
        assert int((rg.iter.cpu() - rc.iter).abs().max()) <= 25


def _band_schur(B, Nb, b, dtype, seed=0):
    """M = P + sigma I + A' diag(rho) A of a random block-tridiagonal
    problem (block-diagonal P, rows of A on two adjacent stages)."""
    from osqp_tpu_torch.linsys.dense_chol import form_schur

    rng = np.random.default_rng(seed)
    n = Nb * b
    P = np.zeros((B, n, n))
    for i in range(Nb):
        G = rng.standard_normal((B, b, b))
        P[:, i * b:(i + 1) * b, i * b:(i + 1) * b] = G @ G.transpose(0, 2, 1) / b + 0.5 * np.eye(b)
    A = np.zeros((B, max(Nb - 1, 0) * b, n))
    for i in range(Nb - 1):
        A[:, i * b:(i + 1) * b, i * b:(i + 2) * b] = rng.standard_normal((B, b, 2 * b))
    rho = np.abs(rng.standard_normal((B, A.shape[1]))) + 0.1
    t = lambda a: torch.as_tensor(a, dtype=dtype)
    return form_schur(t(P), t(A), 1e-6, t(rho))


# (B, Nb, b): the MPC cell's stages (b = 12, Nb = 31), one stage, stages of
# one variable, the warp path's register widths at their ends (16, 32),
# block sizes above a warp (the factor's cluster path, the wide solve), the
# end of what one CTA of 227 KB held of the three stage blocks before the
# cluster path took over (139).
K7_SHAPES = [(64, 31, 12), (3, 1, 7), (5, 9, 1), (6, 5, 16), (5, 3, 32), (2, 4, 40), (2, 3, 64), (200, 6, 5)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("B,Nb,b", K7_SHAPES + [(1, 2, 139)])
def test_k7_kernel_matches_plain(dev, dtype, B, Nb, b):
    """K7's factor and solve against their plain versions bit for bit,
    two launches bit-identical, one launch counted per call."""
    M = _band_schur(B, Nb, b, dtype).to(dev).contiguous()
    before = (k7.launches_factor, k7.launches_solve)
    C, G = k7.bt_factor(M, b)
    C2, G2 = k7.bt_factor(M, b)
    Cp, Gp = k7.bt_factor_plain(M, b)
    r = torch.as_tensor(np.random.default_rng(1).standard_normal((B, Nb * b)), dtype=dtype, device=dev)
    x, x2, xp = k7.bt_solve(C, G, r), k7.bt_solve(C, G, r), k7.bt_solve_plain(Cp, Gp, r)
    torch.cuda.synchronize()
    assert (k7.launches_factor - before[0], k7.launches_solve - before[1]) == (2, 2)
    assert torch.equal(C, C2) and torch.equal(G, G2) and torch.equal(x, x2)
    assert torch.equal(C, Cp) and torch.equal(G, Gp) and torch.equal(x, xp)
    assert bool(torch.isfinite(x).all())


@pytest.mark.parametrize("b", [1, 5, 12, 16, 32, 33])
def test_k7_path_by_block_size(dev, b):
    """Up to 32 the warp path runs (counted in launches_*_warp), above it
    the factor's cluster path (launches_factor_cluster) and the wide solve
    (launches_solve_wide); both the plain version's bits."""
    M = _band_schur(9, 4, b, torch.float32).to(dev).contiguous()
    before = (k7.launches_factor_warp, k7.launches_solve_warp, k7.launches_factor_cluster, k7.launches_solve_wide)
    C, G = k7.bt_factor(M, b)
    x = k7.bt_solve(C, G, torch.ones(9, 4 * b, dtype=torch.float32, device=dev))
    Cp, Gp = k7.bt_factor_plain(M, b)
    torch.cuda.synchronize()
    warp = b <= k7.WARP_MAX
    assert (k7.launches_factor_warp - before[0], k7.launches_solve_warp - before[1]) == (warp, warp)
    assert k7.launches_factor_cluster - before[2] == (not warp) and k7.launches_solve_wide - before[3] == (not warp)
    assert torch.equal(C, Cp) and torch.equal(G, Gp)
    assert torch.equal(x, k7.bt_solve_plain(Cp, Gp, torch.ones_like(x)))


def test_k7_stage_not_positive_definite_gives_nan(dev):
    """An indefinite stage: NaN in the lower triangle of its factor and of
    every later stage's, as the plain version; nothing raises."""
    M = _band_schur(2, 4, 3, torch.float64)
    M[1, 6, 6] = -50.0
    M = M.to(dev).contiguous()
    C, G = k7.bt_factor(M, 3)
    Cp, Gp = k7.bt_factor_plain(M, 3)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(C), torch.isnan(Cp)) and torch.isnan(C[1, 2:]).any()
    assert torch.equal(torch.nan_to_num(C), torch.nan_to_num(Cp)) and torch.equal(torch.nan_to_num(G),
                                                                                  torch.nan_to_num(Gp))
    assert bool(torch.isfinite(C[0]).all())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("b,k", [(140, None), (256, None), ("cmax+1", None), ("cmax+1", 1), ("cmax+1", 4),
                                 ("band+1", None)])
def test_k7_device_path_above_its_shared_memory(dev, dtype, b, k):
    """The device path (counted in launches_factor_device; strips in C's
    and G's slots), which the factor takes above cluster_max_block and a
    caller may name at any b above WARP_MAX, in clusters of device_plan's
    size or of a size named, and with its band in device memory above
    848 (f64) / 1705 (f32), gives the plain version's bits, as does the
    solve; two launches bit-identical.  A stage that is not positive
    definite gives NaN there as on the other paths."""
    top = 848 if dtype == torch.float64 else 1705
    b = {"cmax+1": k7.cluster_max_block(dtype) + 1, "band+1": top + 1}.get(b, b)
    assert (k7.device_scratch(b, dtype) > 0) == (b > top)
    path = None if b > k7.cluster_max_block(dtype) and k is None else "device"
    kw = dict(path=path) if k is None else dict(path=path, cluster=k)
    M = _band_schur(2 if b <= top else 1, 3, b, dtype).to(dev).contiguous()
    before = k7.launches_factor_device
    C, G = k7.bt_factor(M, b, **kw)
    C2, G2 = k7.bt_factor(M, b, **kw)
    Cp, Gp = k7.bt_factor_plain(M, b)
    r = torch.as_tensor(np.random.default_rng(1).standard_normal((M.shape[0], 3 * b)), dtype=dtype, device=dev)
    x, xp = k7.bt_solve(C, G, r), k7.bt_solve_plain(Cp, Gp, r)
    torch.cuda.synchronize()
    assert k7.launches_factor_device - before == 2
    assert torch.equal(C, C2) and torch.equal(G, G2)
    assert torch.equal(C, Cp) and torch.equal(G, Gp) and torch.equal(x, xp)
    last = M.shape[0] - 1
    M[last, b + 3, b + 3] = -1e6
    C, _ = k7.bt_factor(M, b, **kw)
    Cp, _ = k7.bt_factor_plain(M, b)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(C), torch.isnan(Cp)) and torch.isnan(C[last, 1:]).any()
    assert torch.equal(torch.nan_to_num(C), torch.nan_to_num(Cp))
    with pytest.raises(ValueError, match="contiguous"):
        k7.bt_factor(M.mT, b)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("b,B,k", [(33, 4, None), (140, 4, None), (140, 3, 1), (140, 2, 2), (140, 3, 5),
                                   (256, 4, None), (256, 9, 8), ("cmax", 2, None), (140, 200, None)])
def test_k7_cluster_path_matches_plain(dev, dtype, b, B, k):
    """Above WARP_MAX up to cluster_max_block the factor takes its
    cluster path (launches_factor_cluster), in clusters of cluster_plan's
    size or of a size named that fits: C and G bit for bit with the plain
    version, two launches bit-identical, the solve on its factors the
    plain solve's bits; NaN where a stage is not positive definite."""
    b = k7.cluster_max_block(dtype) if b == "cmax" else b
    if k is not None and not k7.cluster_fits(b, k, dtype):
        with pytest.raises(ValueError, match="do not fit"):
            k7.bt_factor(_band_schur(1, 2, b, dtype).to(dev).contiguous(), b, path="cluster", cluster=k)
        return
    M = _band_schur(B, 3, b, dtype, seed=b).to(dev).contiguous()
    before = (k7.launches_factor_cluster, k7.launches_factor_device)
    kw = {} if k is None else dict(path="cluster", cluster=k)
    C, G = k7.bt_factor(M, b, **kw)
    C2, G2 = k7.bt_factor(M, b, **kw)
    Cp, Gp = k7.bt_factor_plain(M, b)
    r = torch.as_tensor(np.random.default_rng(2).standard_normal((B, 3 * b)), dtype=dtype, device=dev)
    x, xp = k7.bt_solve(C, G, r), k7.bt_solve_plain(Cp, Gp, r)
    torch.cuda.synchronize()
    assert k7.factor_path(b, dtype) == "cluster"
    assert (k7.launches_factor_cluster - before[0], k7.launches_factor_device - before[1]) == (2, 0)
    assert torch.equal(C, C2) and torch.equal(G, G2)
    assert torch.equal(C, Cp) and torch.equal(G, Gp) and torch.equal(x, xp)
    M[B - 1, b + 5, b + 5] = -1e6
    C, G = k7.bt_factor(M, b, **kw)
    Cp, Gp = k7.bt_factor_plain(M, b)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(C), torch.isnan(Cp)) and torch.isnan(C[B - 1, 1:]).any()
    assert torch.equal(torch.nan_to_num(C), torch.nan_to_num(Cp)) and torch.equal(torch.nan_to_num(G),
                                                                                  torch.nan_to_num(Gp))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("b,B", [(33, 4), (33, 1000), (47, 3), (64, 132), (140, 4), (140, 200), (256, 4), (362, 4),
                                 (362, 2), (559, 2)])
def test_k7_wide_solve_matches_plain(dev, dtype, b, B):
    """The solve above a warp (launches_solve_wide), in CTAs of
    solve_plan's warps: x bit for bit with the plain solve on the plain
    factors, two launches bit-identical; on factors with a NaN stage, the
    plain solve's NaNs."""
    M = _band_schur(B, 3, b, dtype, seed=b).to(dev).contiguous()
    Cp, Gp = k7.bt_factor_plain(M, b)
    r = torch.as_tensor(np.random.default_rng(3).standard_normal((B, 3 * b)), dtype=dtype, device=dev)
    before = (k7.launches_solve_wide, k7.launches_solve_warp)
    x, x2 = k7.bt_solve(Cp, Gp, r), k7.bt_solve(Cp, Gp, r)
    xp = k7.bt_solve_plain(Cp, Gp, r)
    torch.cuda.synchronize()
    assert (k7.launches_solve_wide - before[0], k7.launches_solve_warp - before[1]) == (2, 0)
    assert torch.equal(x, x2) and torch.equal(x, xp)
    M[B - 1, b + 5, b + 5] = -1e6
    Cn, Gn = k7.bt_factor_plain(M, b)
    x, xp = k7.bt_solve(Cn, Gn, r), k7.bt_solve_plain(Cn, Gn, r)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(x), torch.isnan(xp)) and torch.isnan(x[B - 1]).any()
    assert torch.equal(torch.nan_to_num(x), torch.nan_to_num(xp))


@pytest.mark.parametrize("dtype,b,B", [(torch.float64, 7147, 2), (torch.float32, 16833, 1)])
def test_k7_wide_solve_vectors_in_device_memory(dev, dtype, b, B):
    """Above b = 7146 (f64) / 16832 (f32) the wide solve keeps its vectors
    in a scratch of device memory (solve_scratch): x bit for bit with the
    plain solve, two launches bit-identical.  C and G are made directly
    (C lower with a dominant diagonal), Nb = 2 stages."""
    assert k7.solve_scratch(b, dtype) == 3 * b
    g = torch.Generator(device=dev).manual_seed(b)
    C = torch.tril(torch.randn(B, 2, b, b, generator=g, dtype=dtype, device=dev)) / b
    C.diagonal(dim1=-2, dim2=-1).add_(1.0)
    G = torch.randn(B, 1, b, b, generator=g, dtype=dtype, device=dev) / b
    r = torch.randn(B, 2 * b, generator=g, dtype=dtype, device=dev)
    before = k7.launches_solve_wide
    x, x2 = k7.bt_solve(C, G, r), k7.bt_solve(C, G, r)
    xp = k7.bt_solve_plain(C, G, r)
    torch.cuda.synchronize()
    assert k7.launches_solve_wide - before == 2
    assert torch.equal(x, x2) and torch.equal(x, xp) and bool(torch.isfinite(x).all())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_k7_route_quotient_is_the_division(dev, dtype):
    """The wide solve's quotient route gives the division's bits on
    random pairs across exponents and on zeros, infinities and NaNs."""
    g = torch.Generator(device=dev).manual_seed(5)
    n = 1 << 20
    scale = lambda: torch.exp2(torch.randint(-60, 60, (n,), generator=g, device=dev).to(dtype))
    a = torch.randn(n, generator=g, dtype=dtype, device=dev) * scale()
    d = torch.randn(n, generator=g, dtype=dtype, device=dev) * scale()
    a[:64], a[64:128], d[128:192], a[192:256], d[256:320] = 0.0, -0.0, float("nan"), float("inf"), 0.0
    q, ref = k7.route_quotient(a, d), a / d
    torch.cuda.synchronize()
    ints = torch.int32 if dtype == torch.float32 else torch.int64
    assert torch.equal(torch.isnan(q), torch.isnan(ref))
    assert torch.equal(q.view(ints)[~torch.isnan(ref)], ref.view(ints)[~torch.isnan(ref)])


def _large_stage_mpc(b, B=3, horizon=2):
    """A stage-structured MPC batch with stages of b = nx + nu variables
    (nx = 2 b / 3), scenarios by their initial state."""
    from osqp_tpu_torch.models import build_mpc_qp

    nx = 2 * b // 3
    nu = b - nx
    rng = np.random.default_rng(b)
    Ad = np.eye(nx) + 0.05 * rng.standard_normal((nx, nx)) / np.sqrt(nx)
    Bd = rng.standard_normal((nx, nu)) / np.sqrt(nx)
    base = build_mpc_qp(Ad, Bd, np.eye(nx), 0.1 * np.eye(nu), horizon=horizon, xmin=np.full(nx, -10.0),
                        xmax=np.full(nx, 10.0), umin=np.full(nu, -1.0), umax=np.full(nu, 1.0))
    l, u = np.tile(base.l, (B, 1)), np.tile(base.u, (B, 1))
    l[:, :nx] = u[:, :nx] = rng.standard_normal((B, nx))
    return base, (np.stack([base.P] * B), np.stack([base.q] * B), np.stack([base.A] * B), l, u)


@pytest.mark.parametrize("dtype,b", [("float32", 140), ("float64", 99), ("float64", 362)])
def test_block_tridiag_above_max_block_gpu_matches_cpu(dev, dtype, b):
    """Stages of b = 140, 99 and 362 through solve_batch and the Solver
    with block_tridiag on the card (K7's cluster path, or its device path
    at 362, and the wide solve, counted through both entry points)
    against the CPU path: the same statuses and iterations, float64 x and
    y within 1e-6."""
    base, args = _large_stage_mpc(b)
    path = k7.factor_path(b, getattr(torch, dtype))
    assert path == ("device" if b == 362 else "cluster")
    kw = dict(dtype=dtype, verbose=False, linsys_solver="block_tridiag", block_size=base.block_size)
    counts = lambda: (getattr(k7, f"launches_factor_{path}"), k7.launches_factor, k7.launches_solve_wide,
                      k7.launches_solve)

    def ran(before):
        torch.cuda.synchronize()
        f_path, f_all, s_wide, s_all = (a - b_ for a, b_ in zip(counts(), before))
        return f_path == f_all > 0 and s_wide == s_all > 0

    before = counts()
    rg = osqp_tpu_torch.solve_batch(*args, device=dev, **kw)
    assert ran(before)
    rc = osqp_tpu_torch.solve_batch(*args, device="cpu", **kw)
    assert torch.equal(rg.status_val.cpu(), rc.status_val) and torch.equal(rg.iter.cpu(), rc.iter)
    before = counts()
    sg = osqp_tpu_torch.Solver(base.P, base.q, base.A, args[3][0], args[4][0], device=dev, **kw).solve()
    assert ran(before)
    sc = osqp_tpu_torch.Solver(base.P, base.q, base.A, args[3][0], args[4][0], device="cpu", **kw).solve()
    assert sg.info.status_val == sc.info.status_val and sg.info.iter == sc.info.iter
    if dtype == "float64":
        assert float((rg.x.cpu() - rc.x).abs().max()) <= 1e-6 and float((rg.y.cpu() - rc.y).abs().max()) <= 1e-6
        assert np.abs(sg.x - sc.x).max() <= 1e-6 and np.abs(sg.y - sc.y).max() <= 1e-6


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-11)])
@pytest.mark.parametrize("n", [7, "max"])
def test_k2_leaf_matches_plain(dev, dtype, tol, n):
    """K2's leaf entry, T = chol(S)^-1 with no scaling, against its plain
    version, on both forms (B = 5 takes the cluster form, a batch of the
    SM count one block an instance); two launches give the same bits."""
    from osqp_tpu_torch import _build

    n = k2.max_n(dtype) if n == "max" else n
    for B in (5, _build.sm_count(dev)):
        S = _spd(B, n, dtype).to(dev)
        before = (k2.launches_leaf, k2.launches_leaf_cluster)
        T, again = k2.chol_inverse_leaf(S), k2.chol_inverse_leaf(S)
        torch.cuda.synchronize()
        cluster = 2 * (k2.leaf_plan(B, n, dtype, _build.sm_count(dev)) > 0)
        assert (k2.launches_leaf - before[0], k2.launches_leaf_cluster - before[1]) == (2, cluster)
        assert cluster == (2 if B == 5 else 0) and torch.equal(T, again)
        Tp = k2.chol_inverse_leaf_plain(S)
        assert torch.equal(T, torch.tril(T))
        assert float((T - Tp).abs().max()) <= tol * float(Tp.abs().max())


# the cluster form's leaves: one panel, ragged panels, one CTA's strip,
# several CTAs' strips with a ragged last one, the recursion's leaves at
# CVXQP2_M (at most 256), leaves of the largest tree (496, 504), the
# largest leaf of each dtype
K2_CLUSTER_CASES = [(n, k) for n in (7, 100, 240, 241, 256, 300, 496, 504, "cmax") for k in (None, 2, 16)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 2e-14)])
@pytest.mark.parametrize("n,k", K2_CLUSTER_CASES)
def test_k2_cluster_leaf_matches_plain(dev, dtype, tol, n, k):
    """The leaf's cluster form at B = 1 and 3, in clusters of leaf_plan's
    size or of a size named that fits, within the leaf tolerance of
    chip_smoke.py (LEAF_REL_TOL) of its plain version, lower with zeros
    above, two launches bit-identical; NaN over an instance that is not
    PD and over no other."""
    n = k2.cluster_max_n(dtype) if n == "cmax" else n
    if k is not None and not k2.cluster_fits(n, k, dtype):
        with pytest.raises(ValueError, match="does not fit"):
            k2.chol_inverse_leaf(_spd(1, n, dtype).to(dev), cluster=k)
        return
    for B in (1, 3):
        S = _spd(B, n, dtype, seed=n).to(dev)
        kw = {} if k is None else dict(cluster=k)
        before = k2.launches_leaf_cluster
        T, again = k2.chol_inverse_leaf(S, **kw), k2.chol_inverse_leaf(S, **kw)
        Tp = k2.chol_inverse_leaf_plain(S)
        torch.cuda.synchronize()
        assert k2.launches_leaf_cluster - before == 2 and torch.equal(T, again)
        assert torch.equal(T, torch.tril(T))
        assert float((T - Tp).abs().max()) <= tol * float(Tp.abs().max())
    S[1, n // 2, n // 2] = -1.0
    T = k2.chol_inverse_leaf(S, **kw)
    torch.cuda.synchronize()
    assert torch.isnan(T[1]).all() and bool(torch.isfinite(T[0]).all()) and bool(torch.isfinite(T[2]).all())


def test_k2_route_at_b1_runs_its_leaves_on_clusters(dev):
    """spd_inverse at B = 1, n = 1000 (CVXQP2_M's size) in float64: four
    leaves of at most CLUSTER_LEAF_N, all in the cluster form, and the
    plain route's inverse within chip_smoke.py's ROUTE_REL_TOL."""
    M = _spd(1, 1000, torch.float64).to(dev)
    before = (k2.launches_leaf, k2.launches_leaf_cluster)
    X = k2.spd_inverse(M)
    torch.cuda.synchronize()
    assert k2.leaf_size(1, torch.float64, dev) == k2.CLUSTER_LEAF_N
    assert (k2.launches_leaf - before[0], k2.launches_leaf_cluster - before[1]) == (4, 4)
    real = k2.chol_inverse_leaf
    try:
        k2.chol_inverse_leaf = k2.chol_inverse_leaf_plain
        Xp = k2.spd_inverse(M)
    finally:
        k2.chol_inverse_leaf = real
    assert float((X - Xp).abs().max()) <= 1e-13 * float(Xp.abs().max())


@pytest.mark.parametrize("dtype,gate", [(torch.float32, 3e-6), (torch.float64, 1e-12)])
@pytest.mark.parametrize("n", ["max+1", 372, 550])
def test_k2_recursion_above_max_n_within_the_library_residual(dev, dtype, gate, n):
    """dense_inv.init above max_n: K2's recursion on its leaves, no
    torch Cholesky (the guard's rescue not needed), the inverse residual
    under the refine gate, or within 4x the residual of torch's Cholesky
    route with its Newton-Schulz step: in float32 these matrices (cond ~
    40) leave every route a few float32 spacings above the gate."""
    from osqp_tpu_torch.linsys import dense_inv

    n = k2.max_n(dtype) + 1 if n == "max+1" else n
    M = _spd(4, n, dtype).to(dev)
    before, rescued = k2.launches_leaf, dense_inv.guard_rescued
    X = k2.spd_inverse(M)
    torch.cuda.synchronize()
    assert k2.launches_leaf > before
    resid = float(dense_inv._inverse_residual(M, X).max())
    library = float(dense_inv._inverse_residual(M, k2.newton_schulz(M, dense_inv._chol_inverse(M))).max())
    assert resid <= max(gate, 4 * library)
    fac = dense_inv.init(M - 1e-6 * torch.eye(n, dtype=dtype, device=dev),
                         torch.zeros(4, 0, n, dtype=dtype, device=dev), 1e-6, torch.zeros(4, 0, dtype=dtype, device=dev))
    assert dense_inv.guard_rescued == rescued and bool(torch.isfinite(fac["Minv"]).all())


@pytest.mark.parametrize("better", [True, False])
def test_guard_rescue_on_the_card_keeps_the_better_inverse(dev, monkeypatch, better):
    """The residual guard on CUDA tensors: the flagged instance alone goes
    through torch's Cholesky, counted; it keeps whichever inverse has the
    lower residual, the others K2's bit for bit; Minv comes back
    row-major."""
    from osqp_tpu_torch.linsys import dense_inv

    M = _spd(3, 40, torch.float64).to(dev)
    real, real_chol = k2.spd_inverse, dense_inv._chol_inverse
    X = real(M) * torch.tensor([1.0, 1.01, 1.0], dtype=M.dtype, device=dev)[:, None, None]
    monkeypatch.setattr(k2, "spd_inverse", lambda M_: X.clone())
    if not better:
        monkeypatch.setattr(dense_inv, "_chol_inverse", lambda M_: real_chol(M_) * 1.05)
    rescued = dense_inv.guard_rescued
    Minv, resid = dense_inv.guarded_inverse(M)
    torch.cuda.synchronize()
    assert dense_inv.guard_rescued == rescued + 1 and Minv.is_contiguous()
    assert torch.equal(Minv[0], X[0]) and torch.equal(Minv[2], X[2])
    if better:
        assert float(resid[1]) < 1e-12 and not torch.equal(Minv[1], X[1])
    else:
        assert torch.equal(Minv[1], X[1]) and float(resid[1]) > 1e-3


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_batched_solver_gpu_matches_cpu(dev, dtype):
    """BatchedSolver on the card against the CPU: a portfolio batch
    (n = 550 variables, so K2's recursion at set-up), a cold solve and two
    re-solves with new q: the same statuses, iterations within one check
    interval in float32 and equal in float64."""
    from osqp_tpu_torch.models import build_portfolio

    rng = np.random.default_rng(0)
    probs = [build_portfolio(rng.standard_normal(500), rng.standard_normal((500, 50)) / np.sqrt(50),
                             np.abs(rng.standard_normal(500)) * np.sqrt(50)) for _ in range(2)]
    P, q, A, l, u = (np.stack(v) for v in zip(*probs))
    kw = dict(dtype=dtype, verbose=False, eps_abs=1e-3, eps_rel=1e-3)
    bg = osqp_tpu_torch.BatchedSolver(P, q, A, l, u, device=dev, **kw)
    bc = osqp_tpu_torch.BatchedSolver(P, q, A, l, u, device="cpu", **kw)
    for j in range(3):
        qj = q * (1.0 + 0.01 * j)
        rg, rc = (bg.solve(), bc.solve()) if j == 0 else (bg.resolve(q=qj), bc.resolve(q=qj))
        torch.cuda.synchronize()
        assert torch.equal(rg.status_val.cpu(), rc.status_val)
        tol = 0 if dtype == "float64" else 25
        assert int((rg.iter.cpu() - rc.iter).abs().max()) <= tol


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_block_tridiag_backend_gpu_matches_cpu(dev, dtype):
    """An MPC scenario batch (horizon 8) through solve_batch with
    block_tridiag on the card against the CPU's plain path."""
    from osqp_tpu_torch.models import build_mpc_qp

    rng = np.random.default_rng(0)
    nx, nu, B = 8, 4, 32
    Ad = np.eye(nx) + 0.05 * rng.standard_normal((nx, nx)) / np.sqrt(nx)
    Bd = rng.standard_normal((nx, nu)) / np.sqrt(nx)
    base = build_mpc_qp(Ad, Bd, np.eye(nx), 0.1 * np.eye(nu), horizon=8, xmin=np.full(nx, -10.0),
                        xmax=np.full(nx, 10.0), umin=np.full(nu, -1.0), umax=np.full(nu, 1.0))
    l, u = np.tile(base.l, (B, 1)), np.tile(base.u, (B, 1))
    l[:, :nx] = u[:, :nx] = rng.standard_normal((B, nx))
    args = (np.stack([base.P] * B), np.stack([base.q] * B), np.stack([base.A] * B), l, u)
    kw = dict(dtype=dtype, verbose=False, linsys_solver="block_tridiag", block_size=base.block_size)
    before = k7.launches_solve
    rg = osqp_tpu_torch.solve_batch(*args, device=dev, **kw)
    torch.cuda.synchronize()
    assert k7.launches_solve - before == int(rg.iter.max())
    rc = osqp_tpu_torch.solve_batch(*args, device="cpu", **kw)
    assert torch.equal(rg.status_val.cpu(), rc.status_val) and (rc.status_val == 1).all()
    if dtype == "float64":
        assert torch.equal(rg.iter.cpu(), rc.iter)
        assert float((rg.x.cpu() - rc.x).abs().max()) <= 1e-6
    else:
        assert int((rg.iter.cpu() - rc.iter).abs().max()) <= 25


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_pcg_on_k6_matches_plain(dev, dtype):
    """Polish's PCG (pcg_solve: K6's device loop, one launch) against the
    plain loop over the same (K5) products on a masked polish system at
    polish's delta, and against the stepwise path: the same steps and the
    same x, bit for bit (the plain step summing its inner products in the
    kernel's order)."""
    import scipy.sparse as sp

    from osqp_tpu_torch import polish as tpolish
    from osqp_tpu_torch.sparse_ops import ell_from_scipy

    rng = np.random.default_rng(3)
    n, m, B = 3000, 2000, 2
    Pm = sp.random(n, n, density=3.0 / n, random_state=rng)
    Pm = sp.triu(Pm @ Pm.T + 0.1 * sp.eye(n), format="csr")
    Am = sp.random(m, n, density=3.0 / n, random_state=rng, format="csr")
    P = ell_from_scipy(Pm, dtype, batch=B, sym_from_triu=True, device=dev).contiguous()
    A = ell_from_scipy(Am, dtype, batch=B, device=dev).contiguous()
    mask = torch.as_tensor(rng.random((B, m)) < 0.4, dtype=dtype, device=dev)
    MA = k5.ell_scale(A, mask, torch.ones((B, n), dtype=dtype, device=dev))
    d = torch.tensor(1e-6 if dtype == torch.float64 else 1e-4, dtype=dtype)
    solve, steps = tpolish._ell_kkt_solver(n, m, P, MA, d, dtype)
    rhs = torch.as_tensor(rng.standard_normal((B, n + m)), dtype=dtype, device=dev)
    before, before_loop = k6.launches, k6.launches_loop
    sol = solve(rhs)
    torch.cuda.synchronize()
    (sk,) = steps
    assert k6.launches_loop - before_loop == 1 and k6.launches == before and int(sk.max()) > 0
    t = rhs[:, :n] + k5.ell_tmatvec(MA, rhs[:, n:].contiguous()) / d
    ones = torch.ones((B, m), dtype=dtype, device=dev)
    dinv = 1.0 / (k5.ell_diagonal(P) + d + k5.ell_sq_colsums(MA, ones) / d)
    op = k6.EllOperator(P, MA, div=d)
    tol = torch.full((B,), 1e-12 if dtype == torch.float64 else 1e-7, dtype=dtype, device=dev)
    cap = tpolish.polish_cg_cap(n, m)
    xp, sp_ = k6.pcg_solve_plain(op, d, dinv, t.contiguous(), tol, cap, dot=k6.kernel_dot)
    assert torch.equal(sk, sp_)
    assert torch.equal(sol[:, :n], xp)
    xs, ss = k6.pcg_solve_stepwise(op, d, dinv, t.contiguous(), tol, cap)
    assert torch.equal(ss, sk) and torch.equal(xs, xp)


def test_k6_blocks_are_the_plain_sums_blocks(dev):
    """The plain step sums in the kernel's order only if it cuts an
    instance into the kernel's blocks."""
    from osqp_tpu_torch import _build

    for n in (1, 255, 256, 257, 10002, 16384, 16385, 40000):
        assert _build.library().osqp_cg_parts(n) == k6.parts_of(n)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_sparse_polish_on_the_card_matches_the_cpu(dev, dtype):
    """SparseSolver with polish on the card against the CPU's plain path."""
    import scipy.sparse as sp

    rng = np.random.default_rng(0)
    n, m = 200, 300
    M = sp.random(n, n, density=0.02, random_state=rng, format="csc")
    P = sp.triu(M @ M.T + 0.1 * sp.eye(n), format="csc")
    A = sp.random(m, n, density=0.02, random_state=rng, format="csc") + sp.eye(m, n, format="csc")
    xr = rng.standard_normal(n)
    s = np.abs(rng.standard_normal(m)) + 0.1
    args = (P, rng.standard_normal(n), A, A @ xr - s, A @ xr + s)
    kw = dict(dtype=dtype, verbose=False, polish=True)
    rg = osqp_tpu_torch.SparseSolver(*args, device=dev, **kw).solve()
    rc = osqp_tpu_torch.SparseSolver(*args, device="cpu", **kw).solve()
    assert rg.info.status_val == rc.info.status_val and rg.info.status_polish == rc.info.status_polish
    if dtype == "float64":
        assert rg.info.iter == rc.info.iter
        assert np.abs(rg.x - rc.x).max() <= 1e-6


# K8 where the batch cannot fill the card (B below the SM count): the
# cluster factor and the strip solve, at polish's CVXQP2_M size and at a
# batch of four.
K8_SMALL = [(1, 1000, 1250), (4, 300, 400), (1, 60, 40)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("B,n,m", K8_SMALL)
def test_k8_small_batch_path_matches_plain(dev, dtype, B, n, m):
    """The cluster path: lu and perm bit for bit the plain version's and
    two launches alike; the strip solve bit-identical twice, its row-wise
    backward error against the factors under 8 sqrt(N) eps, its backward
    error against K under the chip check's bound, and its forward errors
    quantile by quantile within RTOL plus three times the plain solve's."""
    K = _kkt(B, n, m, dtype, dev, seed=n + B, delta=1e-6)
    N = n + m
    lu, perm = k8.kkt_lu_factor(K)
    kernels, width, cluster = k8.factor_info
    lu2, perm2 = k8.kkt_lu_factor(K)
    lp, pp = k8.kkt_lu_factor_plain(K)
    torch.cuda.synchronize()
    assert cluster >= 1 and width == min(32, N) and kernels > 0
    assert torch.equal(lu, lu2) and torch.equal(perm, perm2)
    assert torch.equal(perm, pp) and torch.equal(lu, lp)
    copies = max(1, 64 // B)  # 64 right-hand sides, so that the quantiles mean something
    Kc, luc, permc = (t.repeat(copies, *[1] * (t.dim() - 1)) for t in (K, lu, perm))
    x_true = torch.randn(Kc.shape[:2], generator=torch.Generator(device=dev).manual_seed(7), dtype=torch.float64,
                         device=dev)
    b = torch.bmm(Kc.double(), x_true[:, :, None])[:, :, 0].to(dtype)
    x, x2 = k8.kkt_lu_solve(luc, permc, b), k8.kkt_lu_solve(luc, permc, b)
    xp = k8.kkt_lu_solve_plain(luc, permc, b)
    torch.cuda.synchronize()
    assert torch.equal(x, x2) and torch.isfinite(x).all()
    K64, x64, xp64 = Kc.double(), x.double(), xp.double()
    resid = (torch.bmm(K64, x64[:, :, None])[:, :, 0] - b.double()).abs().amax(-1)
    backward = resid / (K64.abs().sum(-1).amax(-1) * x64.abs().amax(-1))
    assert float(backward.max()) <= (1e-13 if dtype == torch.float64 else 1e-5)
    lu64 = luc.double()
    U, L = torch.triu(lu64), torch.tril(lu64, -1)
    L.diagonal(dim1=-2, dim2=-1).fill_(1.0)
    pb = torch.gather(b.double(), 1, permc.long())
    through = lambda L, U, v: torch.bmm(L, torch.bmm(U, v[:, :, None]))[:, :, 0]
    rowwise = (through(L, U, x64) - pb).abs() / (through(L.abs(), U.abs(), x64.abs()) + pb.abs())
    assert float(rowwise.max()) <= 8 * N ** 0.5 * torch.finfo(dtype).eps
    scale = x_true.abs().amax(-1)
    qs = torch.tensor([0.5, 0.9, 0.99, 1.0], dtype=torch.float64, device=dev)
    fk = torch.quantile((x64 - x_true).abs().amax(-1) / scale, qs)
    fp = torch.quantile((xp64 - x_true).abs().amax(-1) / scale, qs)
    assert bool((fk <= (1e-12 if dtype == torch.float64 else 1e-5) + 3 * fp).all())


def _blocks(B, n, m, dtype, dev, seed, masked):
    """The blocks of polish's K_delta (delta 1e-6, about half of the rows
    of A zeroed by its mask) or, unmasked, of the ADMM form's K, made in
    float64."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, dtype=torch.float64).to(dev)
    P = _spd(B, n, torch.float64, seed).to(dev)
    A = r(B, m, n) / max(n, 1) ** 0.5
    if masked:
        A, d = A * (r(B, m) > 0)[:, :, None], torch.full((B, m), 1e-6, dtype=torch.float64, device=dev)
    else:
        d = 1.0 / (0.1 + r(B, m).abs())
    T = lambda t: t.to(dtype).contiguous()
    return T(P), T(A), 1e-6, T(d)


# N = n + m on the batched path (B at the SM count): one value, one panel
# of 32 a row short and a row long, one of 64 a row short and a row long,
# the kkt_lu backend's N and the headline's.
K8_BATCHED_N = [(1, 0), (11, 20), (13, 20), (21, 42), (25, 40), (25, 50), (100, 200)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n,m", K8_BATCHED_N)
def test_k8_batched_factor_matches_plain_at_ragged_n(dev, dtype, n, m):
    """The batched path (panels of up to 64 columns, a panel kernel and
    an update kernel a panel) through both entry points: lu and perm the
    plain version's bit for bit, two launches bit-identical, K and the
    blocks untouched."""
    from osqp_tpu_torch import _build

    B = _build.sm_count(dev)
    P, A, shift, d = _blocks(B, n, m, dtype, dev, seed=n + m, masked=m % 2 == 0)
    K = k8.form_kkt(P, A, shift, d).contiguous()
    keep = [t.clone() for t in (K, P, A, d)]
    lp, pp = k8.kkt_lu_factor_plain(K)
    lu, perm = k8.kkt_lu_factor(K)
    assert k8.factor_info[2] == 0
    lu2, perm2 = k8.kkt_lu_factor(K)
    lb, pb = k8.kkt_lu_factor_blocks(P, A, shift, d)
    kernels = k8.factor_info[0]
    lb2, pb2 = k8.kkt_lu_factor_blocks(P, A, shift, d)
    torch.cuda.synchronize()
    assert kernels == k8.factor_info[0] and 1 <= kernels <= 2 * ((n + m + 7) // 8)
    assert all(torch.equal(t, u) for t, u in zip((K, P, A, d), keep))
    assert torch.equal(perm, pp) and torch.equal(lu, lp)
    assert torch.equal(lu, lu2) and torch.equal(perm, perm2)
    assert torch.equal(lb, lp) and torch.equal(pb, pp) and torch.equal(lb, lb2) and torch.equal(pb, pb2)


@pytest.mark.parametrize("N,dtype", [(600, torch.float32), (1100, torch.float64), (2900, torch.float64)])
def test_k8_batched_factor_on_tall_panels(dev, N, dtype):
    """The batched panel's other forms: four rows a thread (N = 600), the
    shared-memory sweep above 1024 rows (N = 1100) and, in float64 at
    N = 2900, a panel that spills to device memory: the plain version's
    bits through both entry points."""
    from osqp_tpu_torch import _build

    B = _build.sm_count(dev)
    n = N // 3
    P, A, shift, d = _blocks(B, n, N - n, dtype, dev, seed=N, masked=True)
    K = k8.form_kkt(P, A, shift, d).contiguous()
    lu, perm = k8.kkt_lu_factor(K)
    lb, pb = k8.kkt_lu_factor_blocks(P, A, shift, d)
    del P, A
    lp, pp = k8.kkt_lu_factor_plain(K)
    torch.cuda.synchronize()
    assert torch.equal(perm, pp) and torch.equal(lu, lp)
    assert torch.equal(pb, pp) and torch.equal(lb, lp)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("masked", [True, False])
def test_k8_blocks_entry_on_the_cluster_path(dev, dtype, masked):
    """Below the SM count the blocks entry forms K in lu by one kernel and
    factors it on the cluster path: the plain version's bits."""
    P, A, shift, d = _blocks(2, 60, 70, dtype, dev, seed=3, masked=masked)
    lu, perm = k8.kkt_lu_factor_blocks(P, A, shift, d)
    assert k8.factor_info[2] >= 1
    lp, pp = k8.kkt_lu_factor_blocks_plain(P, A, shift, d)
    torch.cuda.synchronize()
    assert torch.equal(lu, lp) and torch.equal(perm, pp)


def test_k8_batched_path_is_taken_at_and_above_the_sm_count(dev):
    """From B = SM count up the factor keeps the batched kernels (no
    cluster), and its factors stay the plain version's."""
    from osqp_tpu_torch import _build

    B = _build.sm_count(dev)
    K = _kkt(B, 20, 30, torch.float32, dev, seed=2, delta=1e-6)
    lu, perm = k8.kkt_lu_factor(K)
    assert k8.factor_info[2] == 0
    lp, pp = k8.kkt_lu_factor_plain(K)
    assert torch.equal(lu, lp) and torch.equal(perm, pp)


def _maros_ell(name, dtype, dev):
    import scipy.sparse as sp

    from osqp_tpu_torch.sparse_ops import ell_from_scipy

    qp = load_qps(os.path.join(MAROS, f"{name}.qps"))
    P = ell_from_scipy(sp.triu(qp.P, format="csr"), dtype, sym_from_triu=True, device=dev).contiguous()
    A = ell_from_scipy(qp.A, dtype, device=dev).contiguous()
    return P, A


@pytest.mark.parametrize("name,form", [("CVXQP2_L", "cg"), ("LISWET1", "polish")])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_device_loop_matches_the_plain_loop_on_maros_operators(dev, name, form, dtype):
    """K6's device loop on a Maros-Meszaros problem's ELL operators (CVXQP2_L
    in the cg backend's form, LISWET1 in polish's) against
    pcg_solve_plain(chunk=1, dot=kernel_dot): the same steps, x bit for
    bit, one launch."""
    from osqp_tpu_torch.ops import ell as k5

    P, A = _maros_ell(name, dtype, dev)
    n, m = P.shape[0], A.shape[0]
    rng = np.random.default_rng(5)
    T = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    b, x0 = T(rng.standard_normal((1, n))), T(rng.standard_normal((1, n)))
    if form == "cg":
        sigma, w = torch.tensor(1e-6, dtype=dtype), T(rng.random((1, m)) + 0.1)
        op = k6.EllOperator(P, A, w=w)
        dinv = 1.0 / (k5.ell_diagonal(P) + sigma + k5.ell_sq_colsums(A, w))
        start = x0
    else:
        sigma = torch.tensor(1e-6 if dtype == torch.float64 else 1e-4, dtype=dtype)
        MA = k5.ell_scale(A, T(rng.random((1, m)) < 0.5), torch.ones_like(b))
        op = k6.EllOperator(P, MA, div=sigma)
        dinv = 1.0 / (k5.ell_diagonal(P) + sigma + k5.ell_sq_colsums(MA, torch.ones((1, m), dtype=dtype, device=dev))
                      / sigma)
        start = None
    tol = T([1e-8 if dtype == torch.float64 else 1e-6])
    before = k6.launches_loop
    xk, sk = k6.pcg_solve(op, sigma, dinv, b, tol, 300, start)
    torch.cuda.synchronize()
    assert k6.launches_loop - before == 1
    xp, sp_ = k6.pcg_solve_plain(op, sigma, dinv, b, tol, 300, start, chunk=1, dot=k6.kernel_dot)
    assert int(sk.max()) > 0 and torch.equal(sk, sp_) and torch.equal(xk, xp)


def _loop_system(form, B, n, m, dtype, dev, seed=7):
    """A random ELL system in the cg backend's form or polish's (P
    diagonally dominant, some 5 entries a row), with tolerances from frozen
    at the start to out of reach: (op, sigma, dinv, b, tol, x0)."""
    import scipy.sparse as sp

    from osqp_tpu_torch.ops import ell as k5

    rng = np.random.default_rng(seed)
    M = sp.random(n, n, density=2.0 / n, random_state=rng)
    P = _ell(sp.triu(M + M.T + 6.0 * sp.eye(n), format="csr"), B, dtype, dev, seed=seed, sym=True)
    T = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)  # noqa: E731
    b, x0 = T(rng.standard_normal((B, n))), T(rng.standard_normal((B, n)))
    tol = T(np.resize([1e-10, 1e-3, 1e9, 1e-2, 1e-6], B))
    if not m:
        A = _ell(sp.csr_matrix((0, n)), B, dtype, dev)
        sigma = torch.tensor(1e-2, dtype=dtype)
        op = k6.EllOperator(P, A, w=T(np.ones((B, 0)))) if form == "cg" else k6.EllOperator(P, A, div=sigma)
        return op, sigma, 1.0 / (k5.ell_diagonal(P) + sigma), b, tol, x0
    A = _ell(sp.random(m, n, density=3.0 / n, random_state=rng, format="csr"), B, dtype, dev, seed=seed + 1)
    if form == "cg":
        sigma, w = torch.tensor(1e-6, dtype=dtype), T(rng.random((B, m)) + 0.1)
        return (k6.EllOperator(P, A, w=w), sigma, 1.0 / (k5.ell_diagonal(P) + sigma + k5.ell_sq_colsums(A, w)), b,
                tol, x0)
    sigma = torch.tensor(1e-2, dtype=dtype)
    MA = k5.ell_scale(A, T(rng.random((B, m)) < 0.5), torch.ones_like(b))
    ones = torch.ones((B, m), dtype=dtype, device=dev)
    dinv = 1.0 / (k5.ell_diagonal(P) + sigma + k5.ell_sq_colsums(MA, ones) / sigma)
    return k6.EllOperator(P, MA, div=sigma), sigma, dinv, b, tol, x0


# The loop's modes: operands and vectors in shared memory, the vectors
# alone, and everything in device memory.
LOOP_MODES = ((True, True), (False, True), (False, False))


def _plans_that_fit(op, b, cluster, clusters=None):
    """The plans of the device loop at this cluster size, one a mode that
    fits a CTA's shared memory, their width as loop_plan derives it."""
    from osqp_tpu_torch import _build

    B, n = b.shape
    m = op.A.shape[0]
    kp, ka, kt = op.P.idx.shape[1], op.A.idx.shape[1], op.A.t_idx.shape[1]
    threads = 256 * min(4, -(-k6.parts_of(n) // cluster))
    plans = []
    for resident, vectors in LOOP_MODES:
        smem = k6.loop_smem(n, m, kp, ka, kt, cluster, resident, vectors, b.element_size())
        if smem <= _build.SMEM_BYTES:
            plans.append(k6.LoopPlan(cluster, threads, resident, vectors, smem, clusters or B))
    return plans


def _loop_matches_plain(op, sigma, dinv, b, tol, x0, max_iter, plans):
    """Each plan's loop against pcg_solve_plain(chunk=1, dot=kernel_dot):
    the same steps per instance (instances stopping at several steps) and
    x bit for bit, one launch each."""
    xp, sp_ = k6.pcg_solve_plain(op, sigma, dinv, b, tol, max_iter, x0, chunk=1, dot=k6.kernel_dot)
    assert int(sp_.max()) > 0 and len(set(sp_.tolist())) > 1
    assert plans
    for plan in plans:
        before = k6.launches_loop
        xk, sk = k6.pcg_solve_loop(op, sigma, dinv, b, tol, max_iter, x0, plan=plan)
        torch.cuda.synchronize()
        assert k6.launches_loop - before == 1 and k6.last_plan == plan
        assert torch.equal(sk, sp_), plan
        assert torch.equal(xk, xp), plan


@pytest.mark.parametrize("cluster", [1, 2, 3, 5, 8, 11, 14, 16])
@pytest.mark.parametrize("form", ["cg", "polish"])
def test_device_loop_plans_match_the_plain_loop(dev, cluster, form):
    """The device loop on clusters of 1 to 16 CTAs (float64, n = 5000: 20
    parts), in both operator forms, in every mode that fits a CTA: the
    operands' rows in shared memory from 11 CTAs up, read from device
    memory at each step, and the vectors in device memory (the only mode
    of one CTA here); each against pcg_solve_plain(chunk=1,
    dot=kernel_dot): the same steps per instance and x bit for bit."""
    op, sigma, dinv, b, tol, x0 = _loop_system(form, 5, 5000, 3500, torch.float64, dev)
    plans = _plans_that_fit(op, b, cluster)
    assert [p.resident for p in plans].count(True) == (cluster >= 11)
    assert all(p.vectors for p in plans[:-1]) and not plans[-1].vectors
    _loop_matches_plain(op, sigma, dinv, b, tol, x0, 60, plans)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("cluster", [1, 3, 8, 16])
def test_device_loop_past_16384_variables(dev, dtype, cluster):
    """n = 20000 (64 parts of two rounds of 256 each): the owners'
    arithmetic past one round, in every mode that fits."""
    op, sigma, dinv, b, tol, x0 = _loop_system("cg", 3, 20000, 9000, dtype, dev, seed=11)
    _loop_matches_plain(op, sigma, dinv, b, tol, x0, 40, _plans_that_fit(op, b, cluster))


@pytest.mark.parametrize("clusters", [1, 2, 3])
def test_device_loop_takes_more_instances_than_clusters(dev, clusters):
    """B = 7 over 1 to 3 clusters at once: each cluster takes the next
    instance left when its own is done, and every instance gets the plain
    loop's steps and bits."""
    op, sigma, dinv, b, tol, x0 = _loop_system("cg", 7, 3000, 2000, torch.float64, dev, seed=3)
    _loop_matches_plain(op, sigma, dinv, b, tol, x0, 80, _plans_that_fit(op, b, 4, clusters=clusters))


@pytest.mark.parametrize("form", ["cg", "polish"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_device_loop_without_constraints(dev, form, dtype):
    """m = 0: no A p phase, V p absent; the default plan and forced ones."""
    op, sigma, dinv, b, tol, x0 = _loop_system(form, 4, 3000, 0, dtype, dev, seed=5)
    _, sk = k6.pcg_solve_loop(op, sigma, dinv, b, tol, 50, x0)
    xp, sp_ = k6.pcg_solve_plain(op, sigma, dinv, b, tol, 50, x0, chunk=1, dot=k6.kernel_dot)
    assert torch.equal(sk, sp_)
    _loop_matches_plain(op, sigma, dinv, b, tol, x0, 50, _plans_that_fit(op, b, 3))


def test_device_loop_default_plans_and_the_library_agree(dev):
    """The plan's shared memory is the kernel's (csrc/cg.cu:loop_smem) for
    every mode; the default plan at CVXQP2_L in float64 spreads one
    instance over a cluster of 14 CTAs with its operands resident, and the
    card holds the clusters it plans; a plan the kernel does not serve (a
    cluster wider than the parts) raises."""
    from osqp_tpu_torch import _build

    lib = _build.library()
    for n, m, kp, ka, kt in [(10000, 12500, 9, 3, 5), (10002, 10000, 1, 3, 3), (20000, 9000, 4, 3, 4),
                             (20, 0, 3, 1, 1), (1000, 1250, 9, 3, 5)]:
        for code, itemsize in ((0, 4), (1, 8)):
            for cluster in (1, 2, 3, 14, 16):
                if cluster > k6.parts_of(n):
                    continue
                for res, vec in ((True, True), (False, True), (False, False)):
                    assert lib.osqp_cg_loop_smem(code, n, m, kp, ka, kt, cluster, res, vec) == k6.loop_smem(
                        n, m, kp, ka, kt, cluster, res, vec, itemsize)
    P, A = _maros_ell("CVXQP2_L", torch.float64, dev)
    plan = k6._planned(1, 10000, 12500, P.idx.shape[1], A.idx.shape[1], A.t_idx.shape[1], 1, dev.index or 0)
    assert (plan.cluster, plan.resident, plan.vectors, plan.clusters) == (14, True, True, 1)
    op, sigma, dinv, b, tol, x0 = _loop_system("cg", 2, 3000, 2000, torch.float64, dev)
    with pytest.raises(RuntimeError, match="cg_loop"):
        k6.pcg_solve_loop(op, sigma, dinv, b, tol, 10, x0,
                          plan=dataclasses.replace(_plans_that_fit(op, b, 12)[0], cluster=13))


# ---------------------------------------------------------------------------
# Heterogeneous shapes and the Maros harness on the card against the CPU
# ---------------------------------------------------------------------------
MAROS_SMALL = ["GENHS28", "HS118", "HS21", "HS268", "HS35", "HS35MOD", "HS51", "HS52", "HS53", "HS76", "QPTEST",
               "S268", "TAME", "ZECEVIC2", "CVXQP2_S"]


def _same_rows(got, want, pairs):
    """Statuses, iterations and status_polish equal; f64 x and y within 1e-6."""
    for a, b in pairs(got, want):
        assert (a["status_val"], a["iter"], a["status_polish"]) == (b["status_val"], b["iter"], b["status_polish"])
        np.testing.assert_allclose(a["x"], b["x"], rtol=0, atol=1e-6)
        np.testing.assert_allclose(a["y"], b["y"], rtol=0, atol=1e-6)


def test_solve_problems_on_the_card_matches_the_cpu(dev):
    from osqp_tpu_torch.buckets import solve_problems

    rng = np.random.default_rng(0)
    problems = []
    for i, (n, m) in enumerate([(3, 5), (7, 4), (3, 5), (12, 20), (40, 90)]):
        M = rng.standard_normal((n, n))
        A = rng.standard_normal((m, n))
        x0 = rng.standard_normal(n)
        problems.append((f"p{i}", M @ M.T + 0.5 * np.eye(n), rng.standard_normal(n), A, A @ x0 - 1.0, A @ x0 + 1.0))
    kw = dict(dtype="float64", polish=True, verbose=False)
    as_row = lambda r: dict(vars(r))  # noqa: E731
    got = [as_row(r) for r in solve_problems(problems, device=dev, **kw)]
    want = [as_row(r) for r in solve_problems(problems, device="cpu", **kw)]
    _same_rows(got, want, zip)
    assert [r["bucket"] for r in got] == [r["bucket"] for r in want]


def test_run_maros_on_the_card_matches_the_cpu(dev):
    from osqp_tpu_torch.maros import run_maros

    paths = [os.path.join(MAROS, f"{n}.qps") for n in MAROS_SMALL]
    kw = dict(dtype="float64", polish=True, verbose=False, keep_solutions=True)
    got, s_got = run_maros(paths, device=dev, **kw)
    want, _ = run_maros(paths, device="cpu", **kw)
    assert s_got["pass_rate"] == 1.0
    assert not any(r.get("host_polish") for r in got)
    _same_rows(got, want, zip)


def test_qp_layer_gradients_on_the_card_match_the_cpu(dev):
    """make_qp_layer on the card against the CPU layer in float64 (B=64,
    n=20, m=30, polish on, eps 1e-8): x and dP, dq, dA, dl, du of a
    weighted sum within 1e-8 of the CPU's largest entry, at least 1; the
    backward pass launches K8's factor once, its solve 1 + 3 times and K3
    3 times."""
    P, q, A, l, u = _qps(64, 20, 30, seed=3)
    w = np.random.default_rng(4).standard_normal((64, 20))
    layer = osqp_tpu_torch.make_qp_layer(eps_abs=1e-8, eps_rel=1e-8)

    def run(device):
        ts = [torch.as_tensor(v, dtype=torch.float64, device=device).requires_grad_(True) for v in (P, q, A, l, u)]
        x = layer(*ts)
        return x.detach().cpu(), (torch.as_tensor(w, device=device) * x).sum(), ts

    xg, loss, ts = run(dev)
    f0, s0, t0 = k8.launches_factor, k8.launches_solve, k3.launches
    grads = torch.autograd.grad(loss, ts)
    torch.cuda.synchronize()
    assert (k8.launches_factor - f0, k8.launches_solve - s0, k3.launches - t0) == (1, 4, 3)
    xc, loss_c, tc = run("cpu")
    grads_c = torch.autograd.grad(loss_c, tc)
    for got, want in ((xg, xc), *zip(grads, grads_c)):
        assert float((got.cpu() - want).abs().max()) <= 1e-8 * max(1.0, float(want.abs().max()))


def test_adjoint_solve_float32_on_the_card_matches_the_cpu(dev):
    """The layer's backward solve in float32 (delta 1e-6) on the card
    against the CPU on the same (P, A, mask, g), the mask the active set
    of a float32 solve: u and v within 1e-3 of the CPU's largest entry, at
    least 1.  (End to end, the card's and the CPU's float32 ADMM runs may
    stop a check interval apart and polish from different points.)"""
    from osqp_tpu_torch.diff import _adjoint_solve

    P, q, A, l, u = _qps(64, 20, 30, seed=3)
    y = osqp_tpu_torch.solve_batch(P, q, A, l, u, device="cpu", dtype="float32", verbose=False, polish=True).y
    mask = (y.abs() > 1e-8).to(torch.float32)
    g = torch.as_tensor(np.random.default_rng(4).standard_normal((64, 20)), dtype=torch.float32)
    Pt, At = (torch.as_tensor(v, dtype=torch.float32) for v in (P, A))
    want = _adjoint_solve(Pt, At, mask, g, 1e-6)
    got = _adjoint_solve(Pt.to(dev), At.to(dev), mask.to(dev), g.to(dev), 1e-6)
    for a, b in zip(got, want):
        assert float((a.cpu() - b).abs().max()) <= 1e-3 * max(1.0, float(b.abs().max()))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_compaction_on_the_card(dev, dtype):
    """compact=True on the card against the plain solve on the card and
    against compact=True on the CPU (B=512, n=20, m=30): equal statuses,
    x within 1e-8 (float64) or 1e-4 (float32) relative."""
    args = _qps(512, 20, 30, seed=5)
    kw = dict(dtype=dtype, verbose=False, eps_abs=1e-5, eps_rel=1e-5)
    comp = osqp_tpu_torch.solve_batch(*args, device=dev, compact=True, min_compact_batch=16, **kw)
    plain = osqp_tpu_torch.solve_batch(*args, device=dev, **kw)
    cpu = osqp_tpu_torch.solve_batch(*args, device="cpu", compact=True, min_compact_batch=16, **kw)
    tol = 1e-8 if dtype == "float64" else 1e-4
    for other in (plain, cpu):
        assert torch.equal(comp.status_val.cpu(), other.status_val.cpu())
        scale = other.x.abs().amax(-1).clamp_min(1.0).cpu()
        assert float(((comp.x.cpu() - other.x.cpu()).abs().amax(-1) / scale).max()) <= tol
    assert comp.iter.max() > comp.iter.min()


def test_export_round_trip_on_the_card(dev):
    """An artifact exported for the card and loaded there gives the live
    solve_batch bit for bit; the sparse artifact gives the SparseSolver's
    x within 1e-6."""
    import scipy.sparse as sp

    from osqp_tpu_torch import export

    args = [torch.as_tensor(v, dtype=torch.float32, device=dev) for v in _qps(256, 20, 30, seed=6)]
    kw = dict(dtype="float32", verbose=False, polish=True)
    out = export.load_solver(export.export_solver(256, 20, 30, **kw))(*args)
    live = osqp_tpu_torch.solve_batch(*args, **kw)
    for f in ("x", "y", "status_val", "iter", "status_polish", "obj_val"):
        assert torch.equal(out[f], getattr(live, f)), f
    n = 200
    rng = np.random.default_rng(5)
    P = sp.diags(np.abs(rng.standard_normal(n)) + 1.0).tocsc()
    A = sp.vstack([sp.eye(n), sp.diags([1.0] * (n - 1), 1).tocsr()[: n - 1]]).tocsc()
    q, l, u = rng.standard_normal(n), -np.ones(A.shape[0]), np.ones(A.shape[0])
    s = osqp_tpu_torch.SparseSolver(P, q, A, l, u, device=dev, dtype="float64", verbose=False)
    fn = export.load_sparse_solver(s.export())
    got = fn(sp.triu(P, format="csc").data, q[None], A.data, l[None], u[None])
    assert int(got["status_val"][0]) == 1
    np.testing.assert_allclose(got["x"][0].cpu().numpy(), s.solve().x, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# The dense path's torch.library operators and the exported program
# ---------------------------------------------------------------------------
# (B, n, m): a batch on the resident paths (K4, K1r) and K2's kernel, and
# one problem of CVXQP2_M's size on the split paths and K2's cluster leaf.
OP_SHAPES = [(256, 100, 200), (1, 1000, 1250)]


def _op_problem(dev, dtype, B, n, m, seed=31):
    return [torch.as_tensor(v, dtype=dtype, device=dev) for v in _qps(B, n, m, seed=seed)]


def _same_bits(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    bits = lambda t: t.reshape(-1).view(torch.uint8) if t.dtype.is_floating_point else t
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(bits(a), bits(b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,n,m", OP_SHAPES)
def test_ruiz_and_term_products_ops_match_their_launches(dev, dtype, B, n, m):
    """K4's and K3's operators give the ctypes launches' bits, on the path
    each plan names; K3's twice in turn and on a second stream."""
    P, q, A, l, u = _op_problem(dev, dtype, B, n, m)
    cluster = k4.cluster_size(n, m, dtype)
    for a, b in zip(k4.ruiz_op(P, q, A, l, u, 10, cluster), k4.ruiz(P, q, A, l, u, 10)):
        assert _same_bits(a, b)
    x = torch.randn(B, n, dtype=dtype, device=dev)
    y = torch.randn(B, m, dtype=dtype, device=dev)
    dx, dy = torch.randn_like(x), torch.randn_like(y)
    for extra in ((), (dx, dy)):
        want = k3.term_products(P, A, x, y, *extra)
        for got in (k3.term_products_op(P, A, x, y, *extra), k3.term_products_op(P, A, x, y, *extra)):
            assert all(_same_bits(a, b) for a, b in zip(got, want))
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            got = k3.term_products_op(P, A, x, y, *extra)
        torch.cuda.current_stream(dev).wait_stream(side)
        assert all(_same_bits(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,n,m", OP_SHAPES)
def test_admm_iter_ops_match_their_launches(dev, dtype, B, n, m):
    """K1's operator and K1r's on the plan's path (resident at the batch,
    split at B = 1), with and without the TwoSum carry, give the
    launches' bits, half the instances active."""
    P, q, A, l, u = _op_problem(dev, dtype, B, n, m)
    Minv = k2.spd_inverse(P + 1e-6 * torch.eye(n, dtype=dtype, device=dev)).contiguous()
    AMinvT = torch.bmm(Minv, A.transpose(1, 2)).contiguous()
    rho = torch.full((B, m), 0.1, dtype=dtype, device=dev)
    x, dx = torch.randn(B, n, dtype=dtype, device=dev), torch.randn(B, n, dtype=dtype, device=dev)
    z, y, dy = (torch.randn(B, m, dtype=dtype, device=dev) for _ in range(3))
    active = (torch.arange(B, device=dev) % 2 == 0) if B > 1 else torch.ones(1, dtype=torch.bool, device=dev)
    common = (q, l, u, rho, 1.0 / rho, 1e-6, 1.6, active, x, z, y, dx, dy)
    got, want = k1.admm_iter_op(Minv, AMinvT, A, *common), k1.admm_iter(Minv, AMinvT, A, *common)
    assert all(_same_bits(a, b) for a, b in zip(got, want))
    _, cluster = k1.refined_plan(B, n, m, dtype, torch.cuda.get_device_properties(dev).multi_processor_count)
    for y_lo in (None, torch.randn(B, m, dtype=dtype, device=dev) * 1e-9):
        got = k1.refined_op(Minv, A, P, *common, y_lo, cluster=cluster)
        want = k1.admm_iter_refined(Minv, A, P, *common, y_lo)
        assert all(_same_bits(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_spd_inverse_ops_match_their_launches(dev, dtype):
    """K2's operators: the kernel, the leaf one block an instance and the
    leaf's cluster form give the launches' bits."""
    M = _spd(64, 100, dtype).to(dev)
    assert _same_bits(k2.chol_inverse_op(M), k2.chol_inverse(M))
    assert _same_bits(k2.leaf_op(M, 0), k2.chol_inverse_leaf(M, cluster=0))
    S = _spd(1, 256, dtype).to(dev)
    k = k2.leaf_plan(1, 256, dtype, torch.cuda.get_device_properties(dev).multi_processor_count)
    assert k > 0
    assert _same_bits(k2.leaf_op(S, k), k2.chol_inverse_leaf(S, cluster=k))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,n,m", [(256, 50, 80), (1, 300, 400)])
def test_kkt_lu_ops_match_their_launches(dev, dtype, B, n, m):
    """K8's factor from the blocks and its solve through their operators,
    on the batched path (B at or above the SM count) and the cluster path
    with its second stream (B = 1), give the launches' bits."""
    P, q, A, l, u = _op_problem(dev, dtype, B, n, m)
    d = torch.full((B, m), 1e-6, dtype=dtype, device=dev)
    lu, perm = k8.kkt_lu_factor_blocks_op(P, A, 1e-6, d)
    lu0, perm0 = k8.kkt_lu_factor_blocks(P, A, 1e-6, d)
    assert _same_bits(lu, lu0) and _same_bits(perm, perm0)
    b = torch.randn(B, n + m, dtype=dtype, device=dev)
    assert _same_bits(k8.kkt_lu_solve_op(lu, perm, b), k8.kkt_lu_solve(lu0, perm0, b))


def test_ops_refuse_a_plan_that_does_not_fit_the_card(dev):
    """A plan made for another card raises; no operator takes another path."""
    from osqp_tpu_torch import _build

    P, q, A, l, u = _op_problem(dev, torch.float64, 4, 30, 40)
    ops, sms = _build.ops(), _build.sm_count(dev)
    with pytest.raises(RuntimeError, match="rows a block"):
        ops.ruiz(P, q, A, l, u, 10, 0, 1, 1)
    with pytest.raises(RuntimeError, match="SMs"):
        ops.kkt_lu_solve(torch.eye(70, dtype=torch.float64, device=dev).expand(4, 70, 70).contiguous(),
                         torch.arange(70, dtype=torch.int32, device=dev).repeat(4, 1),
                         torch.ones(4, 70, dtype=torch.float64, device=dev), sms + 1)


@pytest.mark.parametrize("polish", [False, True])
def test_exported_headline_program_gives_the_live_bits(dev, polish):
    """The headline batch (B=8192, n=100, m=200, float32) as a format-2
    artifact, loaded in this process, gives the live solve_batch's bits
    in every field, and its export made no host read."""
    from osqp_tpu_torch import export, linalg

    B, n, m = 8192, 100, 200
    kw = dict(dtype="float32", verbose=False, polish=polish)
    args = [torch.as_tensor(v, dtype=torch.float32, device=dev) for v in _qps(B, n, m, seed=0)]
    reads = linalg.host_reads
    blob = export.export_solver(B, n, m, **kw)
    assert linalg.host_reads == reads
    out = export.load_solver(blob)(*args)
    live = osqp_tpu_torch.solve_batch(*args, **kw)
    differ = [f for f in export._FIELDS if not _same_bits(out[f], getattr(live, f))]
    assert not differ


def test_blob_is_plain_data_with_a_card_program(dev):
    """A blob for both platforms holds both programs, the operators'
    library and the torch that built it, all plain data."""
    import io

    from osqp_tpu_torch import export

    blob = export.export_solver(2, 3, 4, platforms=["cpu", "cuda"], eps_abs=1e-5)
    spec = torch.load(io.BytesIO(blob), weights_only=True)
    assert spec["format_version"] == 2 and spec["platforms"] == ["cpu", "cuda"]
    assert (spec["B"], spec["n"], spec["m"], spec["dtype"]) == (2, 3, 4, "float32")
    assert spec["settings"]["eps_abs"] == 1e-5 and spec["torch_version"] == str(torch.__version__)
    assert sorted(spec["programs"]) == ["cpu", "cuda"]
    assert spec["ops_library"][:4] == b"\x7fELF" and spec["ops_library_name"].startswith("libosqp_torch_ops_")


# ---------------------------------------------------------------------------
# The sparse path's torch.library operators and its exported program
# ---------------------------------------------------------------------------
def _k5_jobs(dtype, dev, B, k=5, seed=0):
    """Nine products of every mode of K5's grouped kernel (the ninth past
    MAX_JOBS), on rows of up to k slots."""
    rng = np.random.default_rng(seed)
    m, n = 700, 500
    A = _ell(_k_slots(m, n, k, rng), B, dtype, dev, seed=k)
    P = _ell(_k_slots(n, n, k, rng, sym=True), B, dtype, dev, seed=k + 1, sym=True)
    r = lambda *s: torch.as_tensor(rng.standard_normal(s), dtype=dtype, device=dev)  # noqa: E731
    x, y, w, cw = r(B, n), r(B, m), r(B, m).abs() + 0.1, r(B, n).abs() + 0.1
    return [(k5.ell_matvec, A, x), (k5.ell_tmatvec, A, y), (k5.ell_tmatvec, A, y, w), (k5.ell_sq_colsums, A, w),
            (k5.ell_row_norms, A, cw), (k5.ell_col_norms, A, w), (k5.ell_diagonal, P), (k5.ell_matvec, P, x),
            (k5.ell_tmatvec, A, w, y)]


def _on_operators(monkeypatch, fn, *args):
    """``fn(*args)`` on the route a traced program takes: the wrappers see
    their operands as traced, with no pointers, and call the operators.
    Each ELL operand is passed as a new object, which keeps no launch
    descriptor of an earlier call."""
    import dataclasses

    from osqp_tpu_torch import _build
    from osqp_tpu_torch.sparse_ops import ELLMatrix

    fresh = lambda a: (dataclasses.replace(a) if isinstance(a, ELLMatrix)  # noqa: E731
                       else tuple(map(fresh, a)) if isinstance(a, tuple) else a)
    before = k5.launches
    with monkeypatch.context() as mp:
        mp.setattr(_build, "tracing", lambda t=None: True)
        out = fn(*map(fresh, args))
    assert k5.launches == before  # no ctypes launch
    return out


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("jobs", [1, 2, 3, 4, 5, 6, 7, 8, 9])
@pytest.mark.parametrize("B", [1, 64])
def test_ell_group_op_matches_its_launches(dev, dtype, jobs, B, monkeypatch):
    """K5's grouped operator on 1 to 8 jobs of every mode (sum, weighted
    sum, squares, maxima, diagonal) and on 9, a chunk past MAX_JOBS: each
    product the ctypes launch's bits."""
    calls = _k5_jobs(dtype, dev, B)[:jobs]
    got, want = _on_operators(monkeypatch, k5.ell_products, *calls), k5.ell_products(*calls)
    assert len(got) == jobs and all(_same_bits(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("with_rhs", [True, False])
def test_ell_cg_start_op_matches_its_launches(dev, dtype, with_rhs, monkeypatch):
    """K5's fused CG start through its operators, with and without rhs_z,
    sigma a 0-d host tensor and a float: b, r and z the launches' bits."""
    rng = np.random.default_rng(9)
    B, m, n = 3, 600, 400
    A = _ell(_k_slots(m, n, 9, rng), B, dtype, dev, seed=9)
    P = _ell(_k_slots(n, n, 9, rng, sym=True), B, dtype, dev, seed=10, sym=True)
    r = lambda *s: torch.as_tensor(rng.standard_normal(s), dtype=dtype, device=dev)  # noqa: E731
    rho = r(B, m).abs() + 0.1
    x0, dinv, rhs_x, rhs_z = r(B, n), r(B, n).abs(), r(B, n), r(B, m)
    for sigma in (torch.tensor(1e-6, dtype=dtype), 1.1e-6):
        args = (P, A, rho, x0, dinv, sigma, rhs_x) + ((rhs_z, rho) if with_rhs else ())
        got, want = _on_operators(monkeypatch, k5.ell_cg_start, *args), k5.ell_cg_start(*args)
        assert all(_same_bits(a, b) for a, b in zip(got, want))
        assert (got[0] is rhs_x) == (not with_rhs)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("with_c", [True, False])
def test_ell_scale_op_matches_its_launch(dev, dtype, with_c, monkeypatch):
    """K5's scaling through its operator, with and without the cost
    factor c: both copies of the values the launch's bits."""
    import scipy.sparse as sp

    rng = np.random.default_rng(4)
    B, m, n = 5, 300, 200
    A = _ell(sp.random(m, n, density=0.03, random_state=rng, format="csr"), B, dtype, dev)
    r = lambda *s: torch.as_tensor(rng.random(s) + 0.5, dtype=dtype, device=dev)  # noqa: E731
    row_s, col_s, c = r(B, m), r(B, n), (r(B) if with_c else None)
    got, want = _on_operators(monkeypatch, k5.ell_scale, A, row_s, col_s, c), k5.ell_scale(A, row_s, col_s, c)
    assert _same_bits(got.val, want.val) and _same_bits(got.t_val, want.t_val)


@pytest.mark.parametrize("form", ["cg", "polish"])
@pytest.mark.parametrize("resident", [True, False])
def test_cg_loop_op_matches_its_launch(dev, form, resident):
    """K6's device loop through its operator, in the cg form from x0 and
    in polish's div form from zero, on a plan with the operands and
    vectors resident and on one with the vectors in device memory: x and
    the steps the launch's bits."""
    op, sigma, dinv, b, tol, x0 = _loop_system(form, 5, 5000, 3500, torch.float64, dev)
    x0 = x0 if form == "cg" else None
    plans = [p for p in _plans_that_fit(op, b, 16, clusters=2) if p.resident == resident and p.vectors == resident]
    assert len(plans) == 1
    xk, sk = k6.pcg_solve_loop(op, sigma, dinv, b, tol, 60, x0, plan=plans[0])
    xo, so = k6.pcg_solve_loop_op(op, sigma, dinv, b, tol, 60, x0, plan=plans[0])
    assert int(sk.max()) > 0 and _same_bits(so, sk) and _same_bits(xo, xk)


def test_sparse_ops_refuse_a_plan_that_does_not_fit_the_card(dev):
    """A grouped launch planned for another card, and a loop planned for
    more clusters than the card holds, raise."""
    from osqp_tpu_torch import _build

    op, sigma, dinv, b, tol, x0 = _loop_system("cg", 2, 3000, 2000, torch.float64, dev)
    ops, sms = _build.ops(), _build.sm_count(dev)
    p = k5.plan((3000,), 2, sms)
    with pytest.raises(RuntimeError, match="SMs"):
        ops.ell_group([op.P.val], [op.P.idx], [b], [None], [0], [3000], list(p.tiles), list(p.cta0), p.rows, p.ipar,
                      p.run, p.ctas, sms + 1)
    plan = _plans_that_fit(op, b, 4)[0]
    x, r, z, pp, rz, rr, tol2 = k6._start(op, sigma, dinv, b, x0, tol)
    with pytest.raises(RuntimeError, match="clusters"):
        ops.cg_loop(op.P.val, op.P.idx, op.A.val, op.A.idx, op.A.t_val, op.A.t_idx, op.w, sigma, None, dinv, tol2,
                    rz, rr, x, r, z, pp, 10, plan.cluster, plan.threads, int(plan.resident), int(plan.vectors),
                    10 ** 6)


def _dense_system(B, n, m, dtype, dev, seed=7):
    """The cg backend's dense system at a random point: its operator,
    sigma, dinv, b, x0 and tol_rel, instance 0 frozen from the start by a
    huge tolerance and the others at tolerances that stop them at several
    steps."""
    from osqp_tpu_torch.linsys import cg as cg_backend

    P, q, A, l, u = _op_problem(dev, dtype, B, n, m, seed=seed)
    g = torch.Generator(device="cpu").manual_seed(seed)
    rho = (torch.rand(B, m, generator=g, dtype=torch.float64) + 0.1).to(dtype).to(dev)
    fac = cg_backend.init(P, A, 1e-6, rho)
    op = k6._operator(P, A, rho, plain=False)
    b = torch.randn(B, n, generator=g, dtype=torch.float64).to(dtype).to(dev)
    x0 = torch.randn(B, n, generator=g, dtype=torch.float64).to(dtype).to(dev)
    tol = torch.logspace(-2, -9 if dtype == torch.float64 else -5, B, dtype=dtype).to(dev)
    tol[0] = 1e9
    return op, fac["sigma"], fac["dinv"], b, x0, tol


def _dense_plans(n, m, dtype, cluster, clusters):
    """The dense loop's plans at this cluster size, one a mode that fits a
    CTA's shared memory, at 256 threads (resident) or 768 (the others)."""
    from osqp_tpu_torch import _build

    itemsize = torch.empty((), dtype=dtype).element_size()
    plans = []
    for resident, vectors in LOOP_MODES:
        smem = k6.dense_loop_smem(n, m, cluster, resident, vectors, itemsize)
        if smem <= _build.SMEM_BYTES:
            plans.append(k6.LoopPlan(cluster, 256 if resident else 768, resident, vectors, smem, clusters))
    return plans


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("B,n,m,from_zero", [(6, 130, 90, False), (3, 300, 37, True), (4, 40, 0, False),
                                             (5, 45, 11, False)])
def test_dense_loop_plans_match_the_plain_twin(dev, dtype, cluster, B, n, m, from_zero):
    """K6's dense loop forced through every mode that fits and every
    cluster size, two clusters at once (each takes several instances),
    against its plain twin pcg_solve_plain(op.ordered, dot=kernel_dot,
    start_dot=kernel_dot): the same steps per instance and x bit for bit,
    from x0 and from zero, with and without rows of A, p past the lanes'
    registers (n = 300); one launch each, nothing on the step kernels;
    a frozen instance keeps x0; two runs give the same bits."""
    op, sigma, dinv, b, x0, tol = _dense_system(B, n, m, dtype, dev)
    x0 = None if from_zero else x0
    xp, sp_ = k6.pcg_solve_plain(op.ordered, sigma, dinv, b, tol, 400, x0, dot=k6.kernel_dot,
                                 start_dot=k6.kernel_dot)
    assert int(sp_[0]) == 0 and int(sp_.max()) > 0 and len(set(sp_.tolist())) > 1
    plans = _dense_plans(n, m, dtype, cluster, clusters=2)
    assert plans
    for plan in plans:
        before, steps_before = k6.launches_dense_loop, k6.launches
        xk, sk = k6.pcg_solve_dense_loop(op, sigma, dinv, b, tol, 400, x0, plan=plan)
        xk2, sk2 = k6.pcg_solve_dense_loop(op, sigma, dinv, b, tol, 400, x0, plan=plan)
        torch.cuda.synchronize()
        assert k6.launches_dense_loop - before == 2 and k6.launches == steps_before and k6.last_dense_plan == plan
        assert torch.equal(sk, sp_), plan
        assert _same_bits(xk, xp), plan
        assert _same_bits(xk, xk2) and torch.equal(sk, sk2), plan
        if x0 is not None:
            assert _same_bits(xk[0], x0[0])


def test_dense_loop_stops_at_max_iter_and_matches_the_library_query(dev):
    """A cap below the steps the tolerances need: every live instance
    takes max_iter steps, as the twin does; the library's shared memory
    of every plan is dense_loop_smem's, and its default plan is
    dense_loop_plan's over the card's query."""
    from osqp_tpu_torch import _build

    op, sigma, dinv, b, x0, tol = _dense_system(5, 100, 200, torch.float64, dev)
    tol = torch.full_like(tol, 1e-14)
    xk, sk = k6.pcg_solve(op, sigma, dinv, b, tol, 7, x0)
    xp, sp_ = k6.pcg_solve_plain(op.ordered, sigma, dinv, b, tol, 7, x0, dot=k6.kernel_dot, start_dot=k6.kernel_dot)
    assert sk.tolist() == [7] * 5 and torch.equal(sk, sp_) and _same_bits(xk, xp)
    lib = _build.library()
    for n, m in ((100, 200), (372, 612), (1000, 750), (40, 0), (3, 17)):
        for cluster in (1, 2, 4, 16):
            for res, vec in LOOP_MODES:
                for code, size in ((0, 4), (1, 8)):
                    assert lib.osqp_cg_dense_loop_smem(code, n, m, cluster, res, vec) == k6.dense_loop_smem(
                        n, m, cluster, res, vec, size)
    plan = k6._dense_planned(8192, 100, 200, 0, dev.index or 0)
    assert plan.resident and plan.cluster in (1, 2, 4) and plan.clusters >= 1


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cg_dense_loop_op_matches_its_launch(dev, dtype):
    """K6's dense loop through its operator, from x0 and from zero, on a
    resident plan and a streamed one: x and the steps the launch's bits,
    nothing counted; a plan for more clusters than the card holds raises."""
    from osqp_tpu_torch import _build

    op, sigma, dinv, b, x0, tol = _dense_system(6, 130, 90, dtype, dev)
    plans = [p for p in _dense_plans(130, 90, dtype, 2, clusters=3) if p.vectors]
    assert len(plans) == 2
    for plan in plans:
        for start in (x0, None):
            xk, sk = k6.pcg_solve_dense_loop(op, sigma, dinv, b, tol, 300, start, plan=plan)
            counted = k6.launches_dense_loop
            xo, so = k6.pcg_solve_dense_loop_op(op, sigma, dinv, b, tol, 300, start, plan=plan)
            torch.cuda.synchronize()
            assert k6.launches_dense_loop == counted
            assert int(sk.max()) > 0 and _same_bits(so, sk) and _same_bits(xo, xk)
    plan = plans[0]
    with pytest.raises(RuntimeError, match="clusters"):
        _build.ops().cg_dense_loop(op.P, op.A, op.w, _build.setting(sigma), dinv, b, x0, tol * tol, 10, plan.cluster,
                                   plan.threads, int(plan.resident), int(plan.vectors), 10 ** 6)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_cg_backend_on_dense_operands_takes_the_dense_loop(dev, dtype):
    """solve_batch, Solver and BatchedSolver with linsys_solver="cg" on
    dense operands launch the dense loop once per CG solve and the step
    kernels never; solve_batch against the CPU's plain path (float64:
    statuses and iterations equal, x and y within 1e-6)."""
    from osqp_tpu_torch.parametric import BatchedSolver

    P, q, A, l, u = _qps(32, 20, 30, seed=3)
    kw = dict(dtype=dtype, verbose=False, linsys_solver="cg")
    loops, steps = k6.launches_dense_loop, k6.launches
    rg = osqp_tpu_torch.solve_batch(P, q, A, l, u, device=dev, **kw)
    assert k6.launches_dense_loop > loops and k6.launches == steps
    rc = osqp_tpu_torch.solve_batch(P, q, A, l, u, device="cpu", **kw)
    assert torch.equal(rg.status_val.cpu(), rc.status_val)
    if dtype == "float64":
        assert torch.equal(rg.iter.cpu(), rc.iter)
        assert float((rg.x.cpu() - rc.x).abs().max()) <= 1e-6
        assert float((rg.y.cpu() - rc.y).abs().max()) <= 1e-6
    loops = k6.launches_dense_loop
    import scipy.sparse as sp

    s = osqp_tpu_torch.Solver(sp.csc_matrix(P[0]), q[0], sp.csc_matrix(A[0]), l[0], u[0], device=dev, **kw)
    assert s.solve().info.status_val == 1
    bs = BatchedSolver(P, q, A, l, u, device=dev, **kw)
    assert (bs.solve().status_val == 1).all()
    assert k6.launches_dense_loop > loops and k6.launches == steps


def _chain_problem(n=200, seed=5):
    """The sparse export tests' chain problem at n variables."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    P = sp.diags(np.abs(rng.standard_normal(n)) + 1.0).tocsc()
    A = sp.vstack([sp.eye(n), sp.diags([1.0] * (n - 1), 1).tocsr()[: n - 1]]).tocsc()
    return P, rng.standard_normal(n), A, -np.ones(A.shape[0]), np.ones(A.shape[0])


@pytest.mark.parametrize("dtype,polish", [("float64", True), ("float32", False)])
def test_exported_sparse_program_gives_the_live_bits(dev, dtype, polish):
    """A scenario batch of 3 as a format-2 sparse artifact, loaded in this
    process, gives solve_sparse's bits in every field, and its export made
    no host read."""
    import scipy.sparse as sp

    from osqp_tpu_torch import export, linalg

    P, q, A, l, u = _chain_problem()
    B = 3
    qs = np.stack([q * (1.0 + 0.1 * i) for i in range(B)])
    ls, us = np.tile(l, (B, 1)), np.tile(u, (B, 1))
    kw = dict(dtype=dtype, verbose=False, polish=polish)
    reads = linalg.host_reads
    blob = export.export_sparse_solver(P, A, B=B, **kw)
    assert linalg.host_reads == reads
    T = lambda v: torch.as_tensor(np.ascontiguousarray(v), dtype=getattr(torch, dtype), device=dev)  # noqa: E731
    out = export.load_sparse_solver(blob)(T(sp.triu(P, format="csc").data), T(qs), T(A.data), T(ls), T(us))
    live = osqp_tpu_torch.solve_sparse(P, qs, A, ls, us, device=dev, **kw)
    assert not [f for f in export._FIELDS if not _same_bits(out[f], getattr(live, f))]
    assert (live.status_val == 1).all()


# ---------------------------------------------------------------------------
# osqp_tpu_torch.parallel on the card
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype,B,n,m", [(torch.float32, 64, 100, 200), (torch.float64, 64, 100, 200),
                                         (torch.float64, 1, 1000, 1250), (torch.float32, 3, 300, 7)])
@pytest.mark.parametrize("blocks", [1, 4])
def test_k4_step_entries_on_row_blocks_match_ruiz_bit_for_bit(dev, dtype, B, n, m, blocks):
    """K4's step entries (sweep_a on each row block, the maxima merged,
    update_de, sweep_p, apply) give ruiz's eight outputs bit for bit on
    either of its paths, and their plain twins' D and E."""
    args = [t.to(dev) for t in (torch.as_tensor(a, dtype=dtype) for a in _qps(B, n, m, seed=11))]
    P, q, A, l, u = args
    before = k4.launches_sweep
    got = k4.ruiz_blocks(P, q, [b.contiguous() for b in torch.tensor_split(A, blocks, dim=1)], l, u, 10)
    torch.cuda.synchronize()
    assert k4.launches_sweep - before == 1 + 10 * (blocks + 2) + blocks + 2
    got = got[:5] + (torch.cat(got[5], dim=1),) + got[6:]
    want = k4.ruiz(*args, 10)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    plain = k4.ruiz_plain(*args, 10)
    assert torch.equal(got[1], plain[1]) and torch.equal(got[2], plain[2])


@pytest.fixture
def one_rank_nccl(dev):
    """A one-rank NCCL group as make_mesh starts it, torn down after."""
    import torch.distributed as dist

    from osqp_tpu_torch import parallel

    if not dist.is_nccl_available():
        pytest.skip("needs NCCL")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    if dist.is_initialized():
        dist.destroy_process_group()
    mesh = parallel.make_mesh()
    yield mesh
    dist.destroy_process_group()


def _same_results(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _schur_polish(monkeypatch):
    """solve_batch's polish on the Schur branch, as the sharded entry's."""
    import functools

    from osqp_tpu_torch import batch, polish

    monkeypatch.setattr(batch, "polish_fn", functools.partial(polish.polish, schur=True))


def _stepwise_dense(monkeypatch):
    """The unsharded cg solve on dense operands on the step kernels, the
    path of the row-sharded entries: their bit-for-bit reference."""
    monkeypatch.setattr(k6, "pcg_solve_dense_loop", k6.pcg_solve_stepwise)


def _loop_parity(got, loop):
    """The sharded solve against the unsharded one on the dense loop, whose
    products sum in another order: the same status, iterations within one
    check interval, x and y within 1e-6."""
    interval = osqp_tpu_torch.Settings().check_termination
    assert torch.equal(got.status_val, loop.status_val)
    assert int((got.iter - loop.iter).abs().max()) <= interval
    assert float((got.x - loop.x).abs().max()) <= 1e-6 and float((got.y - loop.y).abs().max()) <= 1e-6


def test_parallel_entries_at_one_rank_give_the_unsharded_bits(one_rank_nccl, monkeypatch):
    """solve_batch_sharded, solve_single_sharded (polish on) and
    solve_single_sharded_sparse (polish on) under a one-rank NCCL group:
    every field the unsharded solve's bits (the dense polish's on the
    Schur branch, which the sharded one takes); the dense path ran K4's
    step entries and K6's cg_step, and K2 but no K8 in polish; the sparse
    one cg_step and, in polish too, no K6 loop (the unsharded one's
    loop, the same bits); collectives ran.  The dense unsharded reference
    takes the step kernels, as the sharded solve does; against the
    unsharded solve on the dense loop the parity bounds hold."""
    import scipy.sparse as sp

    from osqp_tpu_torch import parallel
    from osqp_tpu_torch.parallel import rows

    mesh = one_rank_nccl
    data = _qps(96, 12, 18, seed=3)
    kw = dict(dtype="float64", verbose=False)
    assert _same_results(parallel.solve_batch_sharded(*data, mesh=mesh, **kw),
                         osqp_tpu_torch.solve_batch(*data, device="cuda", **kw))

    rng = np.random.default_rng(21)
    n, m = 40, 90
    M = rng.standard_normal((n, n))
    P, q, A = M @ M.T / n + 0.2 * np.eye(n), rng.standard_normal(n), rng.standard_normal((m, n))
    x0 = rng.standard_normal(n)
    l, u = A @ x0 - 1.0, A @ x0 + 1.0
    rows.reset_collectives()
    sweeps, steps, inverses, factors = k4.launches_sweep, k6.launches, k2.launches, k8.launches_factor
    got = parallel.solve_single_sharded(P, q, A, l, u, mesh=mesh, polish=True, **kw)
    assert k4.launches_sweep > sweeps and k6.launches > steps and sum(rows.collectives.values()) > 0
    assert k2.launches > inverses and k8.launches_factor == factors and rows.largest_gather <= m
    _schur_polish(monkeypatch)
    unsharded = lambda: osqp_tpu_torch.solve_batch(P[None], q[None], A[None], l[None], u[None],  # noqa: E731
                                                   device="cuda", linsys_solver="cg", polish=True, **kw)
    loops = k6.launches_dense_loop
    loop = unsharded()
    assert k6.launches_dense_loop > loops
    _stepwise_dense(monkeypatch)
    want = unsharded()
    assert _same_results(got, want) and int(got.status_polish[0]) == 1
    _loop_parity(got, loop)

    n = 300
    Ps = sp.diags(1.0 + np.abs(rng.standard_normal(n))).tocsc()
    As = sp.vstack([sp.eye(n), sp.diags([1.0] * (n - 1), 1).tocsr()[: n - 1]]).tocsc()
    qs, ls, us = rng.standard_normal(n), -np.ones(As.shape[0]), np.ones(As.shape[0])
    steps, loops = k6.launches, k6.launches_loop
    got = parallel.solve_single_sharded_sparse(Ps, qs, As, ls, us, mesh=mesh, polish=True, **kw)
    assert k6.launches > steps and k6.launches_loop == loops
    want = osqp_tpu_torch.solve_sparse(Ps, qs, As, ls, us, device="cuda", polish=True, **kw)
    assert k6.launches_loop > loops
    assert _same_results(got, want) and int(got.status_polish[0]) == 1


def test_sharded_dense_polish_on_the_card_is_the_schur_routes_bits(one_rank_nccl, monkeypatch):
    """The sharded dense polish at n = 200 (above K2's one-block n in
    float64, so its recursion on the leaf entry), at eps 1e-5, where the
    ADMM point's active set lets polish succeed (at 1e-3 it fails in both
    branches): the unsharded solve with its polish on the Schur branch
    and its CG on the step kernels gives every bit, the one on the dense
    loop the parity bounds; K2's leaf ran and K8 did not; no all-gather
    moved more than m values; status_polish 1."""
    from osqp_tpu_torch import parallel
    from osqp_tpu_torch.parallel import rows

    rng = np.random.default_rng(22)
    n, m = 200, 600
    M = rng.standard_normal((n, n))
    P, q, A = M @ M.T / n + 0.2 * np.eye(n), rng.standard_normal(n), rng.standard_normal((m, n))
    x0 = rng.standard_normal(n)
    l, u = A @ x0 - 1.0, A @ x0 + 1.0
    kw = dict(dtype="float64", polish=True, verbose=False, eps_abs=1e-5, eps_rel=1e-5)
    rows.reset_collectives()
    leaves, factors = k2.launches_leaf, k8.launches_factor
    got = parallel.solve_single_sharded(P, q, A, l, u, mesh=one_rank_nccl, **kw)
    torch.cuda.synchronize()
    assert k2.launches_leaf > leaves and k8.launches_factor == factors
    assert 0 < rows.largest_gather <= m
    _schur_polish(monkeypatch)
    unsharded = lambda: osqp_tpu_torch.solve_batch(P[None], q[None], A[None], l[None], u[None],  # noqa: E731
                                                   device="cuda", linsys_solver="cg", **kw)
    loop = unsharded()
    _stepwise_dense(monkeypatch)
    want = unsharded()
    assert _same_results(got, want) and int(got.status_polish[0]) == 1
    _loop_parity(got, loop)


def test_parallel_cuda_mesh_refuses_gloo(dev):
    """A CUDA mesh on a gloo group raises: nothing is carried through
    gloo or the CPU in NCCL's place."""
    import torch.distributed as dist

    from osqp_tpu_torch import parallel

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="NCCL"):
            parallel.make_mesh()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("world", [2, 4])
def test_parallel_ranks_on_several_cards(dev, tmp_path, world):
    """The intra-problem and batch cases over ``world`` NCCL ranks, one
    card each: every rank rank 0's bits; the sparse solve the unsharded
    bits; the dense one within 1e-6 of the unsharded cg solve."""
    if torch.cuda.device_count() < world:
        pytest.skip(f"needs {world} CUDA devices")
    import torch_parallel_ranks as R
    from osqp_tpu_torch import _build

    _build.library()  # built once here, not in every rank
    res = R.spawn(world, str(tmp_path), "intra_cuda")
    for k in res[0]:
        if not k.endswith(("/row0", "/seconds")):
            assert np.array_equal(res[1][k], res[0][k], equal_nan=True), k
    P, q, A, l, u = R.sparse_qp()
    want = osqp_tpu_torch.solve_sparse(P, q, A, l, u, device="cuda", verbose=False, **R.F64)
    for f in R.FIELDS:
        assert np.array_equal(res[0][f"sparse/{f}"], getattr(want, f).cpu().numpy(), equal_nan=True), f
    P, q, A, l, u = R.qp(m=50)
    want = osqp_tpu_torch.solve_batch(P[None], q[None], A[None], l[None], u[None], device="cuda",
                                      linsys_solver="cg", verbose=False, **R.F64)
    np.testing.assert_allclose(res[0]["dense50/x"], want.x.cpu().numpy(), atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# The other dense backends' operators (K7's factor and solve, K6's step)
# and their exported programs
# ---------------------------------------------------------------------------
# (dtype, B, Nb, b, path): the warp path (the MPC cell's b = 12), the
# cluster path (b = 140), the device path at b = cluster_max_block + 1 in
# float64 for B = 1 to 4 (clusters of 16 to 1 CTAs a side: device_plan),
# and its band in device memory (b = 849, the operator's scratch).
K7_OP_CASES = [(torch.float32, 64, 31, 12, "warp"), (torch.float64, 4, 3, 12, "warp"),
               (torch.float32, 4, 3, 140, "cluster"), (torch.float64, 2, 3, 99, "cluster"),
               *((torch.float64, B, 3, 362, "device") for B in (1, 2, 3, 4)), (torch.float64, 1, 2, 849, "device")]


@pytest.mark.parametrize("dtype,B,Nb,b,path", K7_OP_CASES)
def test_k7_ops_match_their_launches(dev, dtype, B, Nb, b, path):
    """K7's factor and solve operators on the path and layout the plans
    name give the ctypes launches' bits; the operators count nothing."""
    assert k7.factor_path(b, dtype) == path
    M = _band_schur(B, Nb, b, dtype, seed=b).to(dev)
    C0, G0 = k7.bt_factor(M, b)
    cluster = {"warp": lambda: 0, "cluster": lambda: k7.cluster_plan(b, B, dtype, _sms(dev)),
               "device": lambda: k7.device_plan(B, _sms(dev))}[path]()
    counts = k7.launches_factor, k7.launches_solve
    C, G = k7.bt_factor_op(M, b, path, cluster)
    assert _same_bits(C, C0) and _same_bits(G, G0) and G.shape == (B, Nb - 1, b, b)
    r = torch.randn(B, Nb * b, dtype=dtype, device=dev)
    x = k7.bt_solve_op(C, G, r, k7.solve_plan(b, dtype)[1])
    assert (k7.launches_factor, k7.launches_solve) == counts
    assert _same_bits(x, k7.bt_solve(C0, G0, r))


def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def test_k7_ops_at_one_stage_and_on_the_traced_route(dev, monkeypatch):
    """Nb = 1 (G of shape (B, 0, b, b), also from the Meta kernel), and the
    wrappers' own traced route (``_build.tracing``) to the operators."""
    from osqp_tpu_torch import _build

    M = _band_schur(5, 1, 7, torch.float64).to(dev)
    C, G = k7.bt_factor_op(M, 7, "warp", 0)
    assert G.shape == (5, 0, 7, 7) and _same_bits(C, k7.bt_factor(M, 7)[0])
    meta = _build.ops().bt_factor(M.to("meta"), 7, 0, 0)
    assert tuple(meta[1].shape) == (5, 0, 7, 7) and tuple(meta[0].shape) == (5, 1, 7, 7)
    M = _band_schur(3, 4, 40, torch.float32).to(dev)
    r = torch.randn(3, 160, dtype=torch.float32, device=dev)
    C0, G0 = k7.bt_factor(M, 40)
    counts = k7.launches_factor, k7.launches_solve
    with monkeypatch.context() as mp:
        mp.setattr(_build, "tracing", lambda t=None: True)
        C, G = k7.bt_factor(M, 40)
        x = k7.bt_solve(C, G, r)
    assert (k7.launches_factor, k7.launches_solve) == counts
    assert _same_bits(C, C0) and _same_bits(G, G0) and _same_bits(x, k7.bt_solve(C0, G0, r))
    with pytest.raises(RuntimeError, match="no path"):
        _build.ops().bt_factor(M, 40, 0, 0)


def _cg_state(dev, dtype, B=64, n=300, m=500, seed=9, frozen=True):
    """The cg backend's dense system at a random point on the card: its
    operator, sigma, dinv, b, x0 and tol_rel (every fourth instance
    converged at the start where ``frozen``)."""
    from osqp_tpu_torch.linsys import cg as cg_backend

    P, q, A, l, u = _op_problem(dev, dtype, B, n, m, seed=seed)
    rho = torch.rand(B, m, dtype=dtype, device=dev) + 0.1
    fac = cg_backend.init(P, A, 1e-6, rho)
    op = k6._operator(P, A, rho, plain=False)
    x0 = torch.randn(B, n, dtype=dtype, device=dev)
    u0, v0 = op(x0)
    b = u0 + 1e-6 * x0 + v0 + 1e-3 * torch.randn(B, n, dtype=dtype, device=dev)
    if frozen:
        b[::4] = (u0 + 1e-6 * x0 + v0)[::4]
    tol = torch.full((B,), 1e-7 if dtype == torch.float64 else 1e-4, dtype=dtype, device=dev)
    return op, fac["sigma"], fac["dinv"], b, x0, tol


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cg_step_op_matches_its_launch(dev, dtype):
    """K6's step operator, three steps in turn, against the in-place launch
    (p, x, r, z, the pairs' next slots, steps), bit for bit; its inputs
    unchanged; nothing counted."""
    op, sigma, dinv, b, x0, tol = _cg_state(dev, dtype)
    x, r, z, p, rz, rr, tol2 = k6._start(op, sigma, dinv, b, x0, tol)
    B, n = b.shape
    steps = torch.zeros(B, dtype=torch.int32, device=dev)
    state = (p, x, r, z, rz, rr, steps)
    live = [t.clone() for t in (p, x, r, z)]
    pairs = torch.stack([rz, torch.empty_like(rz)]), torch.stack([rr, torch.empty_like(rr)])
    live_steps, Mp = steps.clone(), torch.empty_like(b)
    parts = torch.empty((3, B, k6._build.library().osqp_cg_parts(n)), dtype=dtype, device=dev)
    for cur in (0, 1, 0):
        u, v = op(state[0])
        inputs, before = state, [t.clone() for t in state]
        counted = k6.launches
        state = k6.cg_step_op(state[0], u, v, sigma, dinv, tol2, state[4], state[5], state[1], state[2], state[3],
                              state[6])
        assert k6.launches == counted
        k6.cg_step(live[0], u, v, float(sigma), dinv, tol2, *pairs, cur, Mp, live[1], live[2], live[3], parts,
                   live_steps)
        assert all(_same_bits(a, b) for a, b in zip(inputs, before))
        got = dict(zip(("p", "x", "r", "z", "rz", "rr", "steps"), state))
        want = dict(zip(("p", "x", "r", "z"), live), rz=pairs[0][1 - cur], rr=pairs[1][1 - cur], steps=live_steps)
        assert not [k for k in got if not _same_bits(got[k], want[k])]
    assert int(live_steps[0]) == 0 and int(live_steps[1]) == 3


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("max_iter", [13, 16, 300])
def test_stepwise_program_matches_the_stepwise_path(dev, dtype, max_iter):
    """The traced stepwise PCG (a while_loop of 8 operator steps a turn and
    a cond for the tail), run eagerly on the card, against the live
    stepwise path: x and the steps bit for bit, at a cap with a tail, a
    whole number of chunks, and one every instance stops before."""
    op, sigma, dinv, b, x0, tol = _cg_state(dev, dtype)
    xs, ss = k6.pcg_solve_stepwise(op, sigma, dinv, b, tol, max_iter, x0)
    xg, sg = k6.pcg_solve_stepwise_program(op, sigma, dinv, b, tol, max_iter, x0)
    assert _same_bits(xg, xs) and _same_bits(sg, ss)
    assert int(ss.max()) <= max_iter and int(ss[0]) == 0


def _mpc_batch(B=64, horizon=8, seed=0):
    """An MPC scenario batch (nx = 8, nu = 4: b = 12) of B initial states."""
    from osqp_tpu_torch.models import build_mpc_qp

    rng = np.random.default_rng(seed)
    nx, nu = 8, 4
    Ad = np.eye(nx) + 0.05 * rng.standard_normal((nx, nx)) / np.sqrt(nx)
    Bd = rng.standard_normal((nx, nu)) / np.sqrt(nx)
    base = build_mpc_qp(Ad, Bd, np.eye(nx), 0.1 * np.eye(nu), horizon=horizon, xmin=np.full(nx, -10.0),
                        xmax=np.full(nx, 10.0), umin=np.full(nu, -1.0), umax=np.full(nu, 1.0))
    l, u = np.tile(base.l, (B, 1)), np.tile(base.u, (B, 1))
    l[:, :nx] = u[:, :nx] = rng.standard_normal((B, nx))
    return base.block_size, (np.stack([base.P] * B), np.stack([base.q] * B), np.stack([base.A] * B), l, u)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_exported_block_tridiag_program_gives_the_live_bits(dev, dtype):
    """An MPC batch through a format-2 block_tridiag blob, loaded in this
    process, gives the live solve_batch's bits in every field; its export
    read the device 0 times and its program calls K7's operators."""
    from osqp_tpu_torch import export, linalg

    b, args = _mpc_batch()
    B, n, m = args[1].shape[0], args[1].shape[1], args[3].shape[1]
    kw = dict(dtype=dtype, verbose=False, linsys_solver="block_tridiag", block_size=b)
    T = lambda a: torch.as_tensor(a, dtype=getattr(torch, dtype), device=dev)  # noqa: E731
    reads = linalg.host_reads
    blob = export.export_solver(B, n, m, **kw)
    assert linalg.host_reads == reads
    out = export.load_solver(blob)(*map(T, args))
    live = osqp_tpu_torch.solve_batch(*map(T, args), segmented=False, **kw)
    assert not [f for f in export._FIELDS if not _same_bits(out[f], getattr(live, f))]
    assert (live.status_val == 1).all()


@pytest.mark.parametrize("backend", ["kkt_lu", "dense_chol", "cg"])
def test_exported_dense_backend_program_gives_the_live_bits(dev, backend):
    """A batch of the benchmark's QPs through a format-2 blob of each other
    dense backend (cg with a CG cap that is no multiple of 8), loaded in
    this process: the live solve_batch's bits in every field."""
    from osqp_tpu_torch import export

    B, n, m = 256, 30, 50
    kw = dict(dtype="float64", verbose=False, linsys_solver=backend, polish=backend == "kkt_lu",
              **({"cg_max_iter": 13} if backend == "cg" else {}))
    args = _op_problem(dev, torch.float64, B, n, m, seed=5)
    out = export.load_solver(export.export_solver(B, n, m, **kw))(*args)
    live = osqp_tpu_torch.solve_batch(*args, segmented=False, **kw)
    assert not [f for f in export._FIELDS if not _same_bits(out[f], getattr(live, f))]
