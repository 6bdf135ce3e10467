"""osqp_tpu_torch's CUDA kernels against their plain versions, on a GPU.

Every test here needs a CUDA device and ``nvcc``, and skips without
them.  The file imports nothing of JAX, so that it runs on a machine
that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q

(``--noconftest``: ``tests/conftest.py`` configures JAX for the JAX
package's tests.)
"""

import os

import numpy as np
import pytest
import torch

import osqp_tpu_torch
from osqp_tpu_torch.io.qps import load_qps
from osqp_tpu_torch.ops import admm_iter as k1
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
    return torch.as_tensor(np.einsum("bij,bkj->bik", G, G) / n + 0.1 * np.eye(n), dtype=dtype)


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


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-11)])
@pytest.mark.parametrize("n", [1, 7, 33, 100])
def test_k2_kernel_matches_plain(dev, dtype, tol, n):
    M = _spd(16, n, dtype).to(dev)
    before = k2.launches
    Xk = k2.chol_inverse(M)
    torch.cuda.synchronize()
    assert k2.launches == before + 1
    Xp = k2.chol_inverse_plain(M)
    assert float((Xk - Xp).abs().max()) <= tol * float(Xp.abs().max())


def test_k2_kernel_at_its_bound_and_nan_on_non_pd(dev):
    n = k2.max_n(torch.float64)
    M = _spd(2, n, torch.float64).to(dev)
    M[1, 3, 3] = -1.0
    X = k2.chol_inverse(M)
    torch.cuda.synchronize()
    assert torch.isnan(X[1]).all()
    Xp = k2.chol_inverse_plain(M[:1])
    assert float((X[:1] - Xp).abs().max()) <= 1e-10 * float(Xp.abs().max())


def _k1_args(B, n, m, dtype, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, dtype=dtype).to(dev)
    Minv = _spd(B, n, dtype, seed).inverse().contiguous().to(dev)
    A = r(B, m, n)
    l = r(B, m) - 1.0
    return dict(
        Minv=Minv, AMinvT=(Minv @ A.transpose(1, 2)).contiguous(), A=A, q=r(B, n), l=l, u=l + 2.0,
        rho=r(B, m).abs() + 0.1, rho_inv=None, sigma=1e-6, alpha=1.6,
        active=torch.arange(B, device=dev) % 2 == 0,
        x=r(B, n), z=r(B, m), y=r(B, m), dx=r(B, n), dy=r(B, m),
    )


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("n,m", [(1, 1), (7, 3), (40, 0), (100, 200), (33, 65)])
def test_k1_kernel_matches_plain(dev, dtype, rtol, n, m):
    args = _k1_args(8, n, m, dtype, dev)
    args["rho_inv"] = 1.0 / args["rho"]
    before = k1.launches
    outk = k1.admm_iter(**args)
    torch.cuda.synchronize()
    assert k1.launches == before + 1
    outp = k1.admm_iter_plain(**args)
    inactive = ~args["active"]
    for got, want, old in zip(outk, outp, (args[k] for k in ("x", "z", "y", "dx", "dy"))):
        assert torch.equal(got[inactive], old[inactive])
        if want.numel():
            assert float((got - want).abs().max()) <= rtol * max(float(want.abs().max()), 1.0)


def test_wrappers_raise_on_non_contiguous_cuda_input(dev):
    M = _spd(2, 5, torch.float64).to(dev).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        k2.chol_inverse(M)
    args = _k1_args(2, 5, 4, torch.float64, dev)
    args["rho_inv"] = 1.0 / args["rho"]
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


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6), (torch.float64, 1e-12)])
@pytest.mark.parametrize("B,n,m", SPLIT_SHAPES)
def test_k4_kernel_matches_plain(dev, dtype, tol, B, n, m):
    args = [t.to(dev) for t in (torch.as_tensor(a, dtype=dtype) for a in _qps(B, n, m, seed=4))]
    before = k4.launches
    outk = k4.ruiz(*args, 10)
    torch.cuda.synchronize()
    assert k4.launches == before + 1
    outp = k4.ruiz_plain(*args, 10)
    assert torch.equal(outk[1], outp[1]) and torch.equal(outk[2], outp[2])  # D, E bit for bit
    for got, want in zip(outk[:1] + outk[3:], outp[:1] + outp[3:]):
        assert _rel(got, want) <= tol


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


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("n,m", [(1, 1), (7, 3), (40, 0), (100, 200), (33, 65)])
def test_k1r_kernel_matches_plain(dev, dtype, rtol, n, m):
    args = _k1_args(8, n, m, dtype, dev)
    args["rho_inv"] = 1.0 / args["rho"]
    del args["AMinvT"]
    P = _spd(8, n, dtype, seed=1).to(dev)
    y_lo = 1e-7 * torch.randn_like(args["y"]) if dtype == torch.float32 else None
    before = k1.refined_launches
    outk = k1.admm_iter_refined(P=P, y_lo=y_lo, **args)
    torch.cuda.synchronize()
    assert k1.refined_launches == before + 1
    outp = k1.admm_iter_refined_plain(P=P, y_lo=y_lo, **args)
    inactive = ~args["active"]
    olds = [args[k] for k in ("x", "z", "y", "dx", "dy")] + [y_lo]
    for name, got, want, old in zip(("x", "z", "y", "dx", "dy", "y_lo"), outk, outp, olds):
        if old is None:
            assert got is None and want is None
            continue
        assert torch.equal(got[inactive], old[inactive])
        if want.numel() and name != "y_lo":
            assert float((got - want).abs().max()) <= rtol * max(float(want.abs().max()), 1.0)
    if y_lo is not None:
        # the carry is exact: (y', y_lo') is TwoSum(y, dy' + y_lo) on every active entry
        a = args["active"]
        assert k1.twosum_violations(args["y"][a], outk[4][a], y_lo[a], outk[2][a], outk[5][a]) == 0


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


def _overflow_args(dev):
    """K1/K1r operands at m = 6000 in float64, where one block needs more
    shared memory than the card gives it."""
    z = lambda *s: torch.zeros(s, dtype=torch.float64, device=dev)
    B, n, m = 1, 2, 6000
    return dict(Minv=z(B, n, n), A=z(B, m, n), q=z(B, n), l=z(B, m), u=z(B, m), rho=z(B, m), rho_inv=z(B, m),
                sigma=1e-6, alpha=1.6, active=torch.ones(B, dtype=torch.bool, device=dev),
                x=z(B, n), z=z(B, m), y=z(B, m), dx=z(B, n), dy=z(B, m)), z(B, n, n), z(B, n, m)


def test_k1_wrapper_rejects_shared_memory_overflow(dev):
    args, _, AMinvT = _overflow_args(dev)
    before = k1.launches
    with pytest.raises(ValueError, match="shared memory"):
        k1.admm_iter(AMinvT=AMinvT, **args)
    assert k1.launches == before


def test_admm_iter_refined_wrapper_rejects_shared_memory_overflow(dev):
    args, P, _ = _overflow_args(dev)
    before = k1.refined_launches
    with pytest.raises(ValueError, match="shared memory"):
        k1.admm_iter_refined(P=P, **args)
    assert k1.refined_launches == before


def test_new_wrappers_raise_on_non_contiguous_cuda_input(dev):
    P, q, A, l, u = (torch.as_tensor(a).to(dev) for a in _qps(2, 5, 4))
    At = A.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        k4.ruiz(P, q, At, l, u, 3)
    with pytest.raises(ValueError, match="contiguous"):
        k3.term_products(P, At, q, l)
    args = _k1_args(2, 5, 4, torch.float64, dev)
    args["rho_inv"] = 1.0 / args["rho"]
    del args["AMinvT"]
    args["A"] = args["A"].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        k1.admm_iter_refined(P=P, **args)


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
    rc = osqp_tpu_torch.Solver(qp.P, qp.q, qp.A, qp.l, qp.u, **kw).solve()
    assert rg.info.status_val == rc.info.status_val == osqp_tpu_torch.OSQP_SOLVED
    assert rg.info.iter == rc.info.iter
    assert np.abs(rg.x - rc.x).max() <= 1e-6 and np.abs(rg.y - rc.y).max() <= 1e-6
    sg.update_lin_cost(qp.q * 1.1)
    assert sg.solve().info.status_val == osqp_tpu_torch.OSQP_SOLVED
