"""osqp_tpu_torch's CUDA kernels against their plain versions, on a GPU.

Every test here needs a CUDA device and ``nvcc``, and skips without
them.  The file imports nothing of JAX, so that it runs on a machine
that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q

(``--noconftest``: ``tests/conftest.py`` configures JAX for the JAX
package's tests.)
"""

import numpy as np
import pytest
import torch

import osqp_tpu_torch
from osqp_tpu_torch.ops import admm_iter as k1
from osqp_tpu_torch.ops import spd_inverse as k2

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
