"""K2 and K7 beyond one block's shared memory, against the JAX package.

K2 above ``spd_inverse.max_n`` runs its blocked recursion over the
leaf entry, and ``dense_inv.init`` takes it at every n; below half the
SM count the leaves take their cluster form and grow to
``spd_inverse.cluster_max_n``.  K7 above ``block_tridiag.WARP_MAX``
takes the factor's cluster path, and above ``cluster_max_block`` its
device path.  On the CPU the wrappers run their plain versions, so these
tests pin the recursion, the plans, the routing and the paths' names,
and hold the results against the JAX package in float64.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import osqp_tpu
import osqp_tpu_torch
from osqp_tpu.ops.spd_inverse import spd_inverse as jspd_inverse
from osqp_tpu_torch.linsys import dense_inv
from osqp_tpu_torch.models import build_mpc_qp
from osqp_tpu_torch.ops import block_tridiag as k7
from osqp_tpu_torch.ops import spd_inverse as k2

torch.set_num_threads(2)

# The port's recursion (leaves by Cholesky) and the JAX package's (padded
# to a power of two, closed-form 2 x 2 leaves) are different roundings of
# one algorithm: on these well-conditioned matrices (cond ~ 1e2) both sit
# ~1e-15 from the inverse, so 1e-8 of the largest entry leaves room for
# ill-conditioning and nothing else; the residual |I - M X|max of each
# inverse stays under 1e-10.
REL_TOL = 1e-8
RESID_TOL = 1e-10
SIZES = (k2.max_n(torch.float64) + 1, 300)


@functools.lru_cache(maxsize=None)
def _problem(n):
    """P, A, rho of a well-conditioned Schur matrix M = P + sigma I +
    A' diag(rho) A, M itself, and the JAX package's inverse of M."""
    rng = np.random.default_rng(n)
    G = rng.standard_normal((2, n, n))
    P = np.einsum("bij,bkj->bik", G, G) / n + 0.1 * np.eye(n)
    A = rng.standard_normal((2, 7, n))
    rho = np.full((2, 7), 0.1)
    M = P + 1e-6 * np.eye(n) + np.einsum("bmi,bm,bmj->bij", A, rho, A)
    return P, A, rho, M, np.asarray(jspd_inverse(jnp.asarray(M)))


def _hold(X, M, J):
    X = X.numpy()
    assert np.abs(X - J).max() <= REL_TOL * np.abs(J).max()
    assert np.abs(np.eye(M.shape[-1]) - M @ X).max() <= RESID_TOL


@pytest.mark.parametrize("n", SIZES)
def test_spd_inverse_above_max_n_matches_reference(n):
    *_, M, J = _problem(n)
    _hold(k2.spd_inverse(torch.as_tensor(M)), M, J)


@pytest.mark.parametrize("n", SIZES)
def test_dense_inv_init_above_max_n_matches_reference(n):
    P, A, rho, M, J = _problem(n)
    rescued = dense_inv.guard_rescued
    fac = dense_inv.init(torch.as_tensor(P), torch.as_tensor(A), 1e-6, torch.as_tensor(rho))
    _hold(fac["Minv"], M, J)
    assert dense_inv.guard_rescued == rescued, "a well-conditioned batch needs no rescue"
    assert not fac["refine"].any()


@pytest.mark.parametrize("n,leaves", [(170, [80, 90]), (300, [144, 156]), (550, [144, 128, 144, 134])])
def test_recursion_splits_at_multiples_of_16_down_to_leaves_that_fit(monkeypatch, n, leaves):
    seen = []
    real = k2.chol_inverse_leaf
    monkeypatch.setattr(k2, "chol_inverse_leaf", lambda S: seen.append(S.shape[-1]) or real(S))
    rng = np.random.default_rng(0)
    G = rng.standard_normal((1, n, n))
    M = torch.as_tensor(G @ G.transpose(0, 2, 1) / n + np.eye(n))
    T = k2.chol_inv(M)
    assert seen == leaves and all(s <= k2.max_n(torch.float64) for s in seen)
    assert torch.equal(T, torch.tril(T))
    # T M T' = I: T is the inverse Cholesky factor of M
    assert float((T @ M @ T.mT - torch.eye(n, dtype=torch.float64)).abs().max()) <= 1e-10


def test_leaf_is_the_inverse_cholesky_factor_and_nan_where_not_pd():
    rng = np.random.default_rng(2)
    G = rng.standard_normal((3, 9, 9))
    S = G @ G.transpose(0, 2, 1) + np.eye(9)
    S[2, 4, 4] = -1.0
    T = k2.chol_inverse_leaf(torch.as_tensor(S)).numpy()
    np.testing.assert_allclose(T[0], np.linalg.inv(np.linalg.cholesky(S[0])), rtol=0, atol=1e-12)
    assert np.array_equal(T[1], np.tril(T[1]))
    assert np.isnan(T[2]).all()
    # and the recursion carries NaN over a whole instance above max_n
    n = k2.max_n(torch.float64) + 1
    M = np.stack([np.eye(n), np.eye(n)])
    M[1, n - 1, n - 1] = -1.0
    X = k2.spd_inverse(torch.as_tensor(M)).numpy()
    np.testing.assert_allclose(X[0], np.eye(n), rtol=0, atol=1e-15)
    assert np.isnan(X[1]).all()


@pytest.mark.parametrize("n", SIZES)
def test_spd_inverse_on_one_large_leaf_matches_reference(monkeypatch, n):
    """Leaves as large as the cluster form takes (n = 170 and 300 as one
    leaf each) give the JAX package's inverse, as the default tree does."""
    seen = []
    real = k2.chol_inverse_leaf
    monkeypatch.setattr(k2, "chol_inverse_leaf", lambda S: seen.append(S.shape[-1]) or real(S))
    *_, M, J = _problem(n)
    _hold(k2.spd_inverse(torch.as_tensor(M), leaf_n=k2.cluster_max_n(torch.float64)), M, J)
    assert seen == [n]


def _spd(n, B=1, seed=0):
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((B, n, n))
    return torch.as_tensor(G @ G.transpose(0, 2, 1) / n + 0.1 * np.eye(n))


def test_spd_inverse_at_n1000_on_the_cluster_leaves_matches_the_default_tree():
    """CVXQP2_M's size, B = 1, in float64: the tree the card takes there
    (two leaves of at most cluster_max_n) against the port's default CPU
    tree (leaves of at most max_n), within the JAX comparison's
    tolerance, both residuals under its bound."""
    M = _spd(1000)
    X = k2.spd_inverse(M, leaf_n=k2.cluster_max_n(torch.float64))
    Xd = k2.spd_inverse(M)
    assert float((X - Xd).abs().max()) <= REL_TOL * float(Xd.abs().max())
    eye = torch.eye(1000, dtype=torch.float64)
    assert float((eye - M @ X).abs().max()) <= RESID_TOL and float((eye - M @ Xd).abs().max()) <= RESID_TOL


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_recursion_at_the_cluster_leaf_size_splits_1000_once(monkeypatch, dtype):
    seen = []
    real = k2.chol_inverse_leaf
    monkeypatch.setattr(k2, "chol_inverse_leaf", lambda S: seen.append(S.shape[-1]) or real(S))
    M = _spd(1000).to(dtype) + torch.eye(1000, dtype=dtype)
    T = k2.chol_inv(M, k2.cluster_max_n(dtype))
    assert seen == [496, 504]
    assert torch.equal(T, torch.tril(T))
    tol = 1e-10 if dtype == torch.float64 else 1e-3
    assert float((T @ M @ T.mT - torch.eye(1000, dtype=dtype)).abs().max()) <= tol


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_recursion_at_the_card_leaf_size_runs_1000_in_four_leaves(monkeypatch, dtype):
    """CLUSTER_LEAF_N, the leaf size the card takes at B = 1: CVXQP2_M's n =
    1000 in four leaves (eight of max_n on one block each before)."""
    seen = []
    real = k2.chol_inverse_leaf
    monkeypatch.setattr(k2, "chol_inverse_leaf", lambda S: seen.append(S.shape[-1]) or real(S))
    M = _spd(1000).to(dtype) + torch.eye(1000, dtype=dtype)
    T = k2.chol_inv(M, k2.CLUSTER_LEAF_N)
    assert seen == [256, 240, 256, 248] and k2.CLUSTER_LEAF_N <= k2.cluster_max_n(dtype)
    tol = 1e-10 if dtype == torch.float64 else 1e-3
    assert float((T @ M @ T.mT - torch.eye(1000, dtype=dtype)).abs().max()) <= tol


def test_cluster_leaf_sizes():
    """The cluster form's largest leaf: 16 CTAs of strips of a multiple
    of 16 rows hold it, not the next one; the CPU keeps max_n."""
    assert (k2.cluster_max_n(torch.float32), k2.cluster_max_n(torch.float64)) == (768, 512)
    for dtype in (torch.float32, torch.float64):
        n = k2.cluster_max_n(dtype)
        assert k2.cluster_fits(n, 16, dtype) and not k2.cluster_fits(n + 1, 16, dtype)
        assert k2.leaf_size(1, dtype, "cpu") == k2.max_n(dtype)
    assert [k2.strip_rows(n, 16) for n in (1, 16, 256, 257, 504, 512, 768)] == [16, 16, 16, 32, 32, 32, 48]


@pytest.mark.parametrize("B,sms,k", [(1, 132, 16), (8, 132, 16), (9, 132, 8), (33, 132, 4), (66, 132, 2),
                                     (67, 132, 0), (256, 132, 0), (8192, 132, 0), (1, 16, 16), (2, 16, 8)])
def test_leaf_cluster_by_batch_and_sm_count(B, sms, k):
    """The cluster form only where B is at most half the SM count: the MPC
    cell (B = 1000), the portfolio (256) and the headline keep one block
    an instance."""
    assert k2.leaf_cluster(B, sms) == k


@pytest.mark.parametrize("B,n,dtype,k", [(1, 504, torch.float64, 16), (1, 170, torch.float64, 16),
                                         (64, 241, torch.float32, 2), (64, 300, torch.float64, 8),
                                         (64, 504, torch.float64, 16), (1000, 186, torch.float32, 0)])
def test_leaf_plan(B, n, dtype, k):
    assert k2.leaf_plan(B, n, dtype, 132) == k


def test_leaf_plan_and_leaf_refuse_what_no_path_holds():
    with pytest.raises(ValueError, match="one block an instance holds"):
        k2.leaf_plan(256, 300, torch.float32, 132)
    with pytest.raises(ValueError, match="a cluster of 16 CTAs holds"):
        k2.leaf_plan(1, 513, torch.float64, 132)
    # the leaf entry takes what some path holds, on the CPU too
    n = k2.cluster_max_n(torch.float64)
    assert k2.chol_inverse_leaf(_spd(n)).shape == (1, n, n)
    with pytest.raises(ValueError, match="holds n <= 512"):
        k2.chol_inverse_leaf(_spd(n + 1))
    with pytest.raises(ValueError, match="holds n <= 169"):
        k2.chol_inverse(_spd(170))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("offset,path", [(32, "warp"), (33, "cluster"), (64, "cluster"), (140, "cluster"),
                                         ("cmax", "cluster"), ("cmax+1", "device")])
def test_k7_factor_path(dtype, offset, path):
    b = {"cmax": k7.cluster_max_block(dtype), "cmax+1": k7.cluster_max_block(dtype) + 1}.get(offset, offset)
    assert k7.factor_path(b, dtype) == path


def test_k7_cluster_max_block_is_what_sixteen_ctas_hold():
    """The cluster path's largest b: 16 CTAs hold it, not the next one."""
    assert (k7.cluster_max_block(torch.float32), k7.cluster_max_block(torch.float64)) == (558, 361)
    for dtype in (torch.float32, torch.float64):
        b = k7.cluster_max_block(dtype)
        assert k7.cluster_fits(b, 16, dtype) and not k7.cluster_fits(b + 1, 16, dtype)
        assert not k7.cluster_fits(b, 8, dtype) and not k7.cluster_fits(b, 12, dtype)


@pytest.mark.parametrize("b,B,dtype,sms,k", [
    (140, 4, torch.float32, 132, 16),     # the large-stage cell: B clusters of 16 on the card
    (140, 8, torch.float32, 132, 16),
    (140, 9, torch.float32, 132, 8),      # 9 x 16 > 132: the largest size that fits the card
    (140, 1000, torch.float32, 132, 1),   # a batch that fills the card: the fewest CTAs that hold a strip
    (99, 1000, torch.float64, 132, 1),
    (140, 1000, torch.float64, 132, 2),
    (256, 1000, torch.float64, 132, 8),   # 8 CTAs needed whatever B
    (361, 1, torch.float64, 132, 16),
    (140, 4, torch.float32, 16, 4),       # a smaller card
    (140, 1, torch.float32, 1, 1),
])
def test_k7_cluster_plan(b, B, dtype, sms, k):
    assert k7.cluster_plan(b, B, dtype, sms) == k
    assert k7.cluster_fits(b, k, dtype)


def test_k7_cluster_plan_refuses_what_no_cluster_holds():
    b = k7.cluster_max_block(torch.float64) + 1
    with pytest.raises(ValueError, match="fit no cluster"):
        k7.cluster_plan(b, 1, torch.float64, 132)


@pytest.mark.parametrize("B,sms,k", [(4, 132, 16), (8, 132, 16), (9, 132, 8), (33, 132, 4), (132, 132, 1),
                                     (1000, 132, 1), (4, 16, 4), (1, 1, 1)])
def test_k7_device_plan(B, sms, k):
    """The device path's strips live in the outputs, so any cluster holds
    them: as many CTAs as B clusters spread over the card, one an
    instance where B fills it."""
    assert k7.device_plan(B, sms) == k


@pytest.mark.parametrize("dtype,b_max", [(torch.float32, 1705), (torch.float64, 848)])
def test_k7_device_band_in_shared_memory_up_to_its_limit(dtype, b_max):
    """Up to b = 1705 (f32) / 848 (f64) the device path keeps its panel
    buffer and band in shared memory and needs no scratch; above, a CTA
    keeps them in device memory."""
    assert k7.device_scratch(k7.cluster_max_block(dtype) + 1, dtype) == 0
    assert k7.device_scratch(b_max, dtype) == 0
    assert k7.device_scratch(b_max + 1, dtype) == k7._band_values(b_max + 1)
    assert k7._band_values(b_max) * torch.empty((), dtype=dtype).element_size() <= k7._CLUSTER_SMEM


@pytest.mark.parametrize("b,dtype,plan", [
    (1, torch.float32, ("warp", 0)), (32, torch.float64, ("warp", 0)),
    (33, torch.float32, ("wide", 3)),      # warp 0 and two warps beside it
    (99, torch.float64, ("wide", 5)),
    (140, torch.float32, ("wide", 6)),     # the large-stage batch, f32
    (320, torch.float64, ("wide", 11)),
    (362, torch.float64, ("wide", 12)),    # the large-stage batch, f64: the most warps
    (559, torch.float32, ("wide", 12)),
    (7146, torch.float64, ("wide", 12)),
    (7147, torch.float64, ("wide", 12)),   # its vectors in device memory (test_k7_solve_scratch)
])
def test_k7_solve_plan(b, dtype, plan):
    assert k7.solve_plan(b, dtype) == plan


@pytest.mark.parametrize("b,dtype,spill", [
    (32, torch.float64, 0), (33, torch.float64, 0), (362, torch.float64, 0),
    (7146, torch.float64, 0),          # the largest b whose vectors a CTA's shared memory holds in f64
    (7147, torch.float64, 3 * 7147),   # above it they go to device memory
    (16832, torch.float32, 0), (16833, torch.float32, 3 * 16833), (60000, torch.float64, 3 * 60000),
])
def test_k7_solve_scratch(b, dtype, spill):
    """The wide solve takes every b: its three vectors stay in shared
    memory beside the blocks and tiles up to 7146 (f64) / 16832 (f32),
    and above that in a scratch of 3 b values an instance; what stays in
    shared memory then fits a CTA at any b."""
    path, warps = k7.solve_plan(b, dtype)
    assert k7.solve_scratch(b, dtype) == spill
    if path == "wide":
        kept = k7._solve_values(b, warps, vectors=not spill)
        assert kept * torch.empty((), dtype=dtype).element_size() <= k7._build.SMEM_BYTES


@pytest.mark.parametrize("b,dtype,warps,nbytes", [
    (33, torch.float32, 3, 4 * (99 + 1088 + 3 * 544)),    # tiles for the 3 warps launched, not for 12
    (33, torch.float64, 3, 8 * (99 + 1088 + 3 * 544)),
    (64, torch.float64, 3, 8 * (192 + 1088 + 3 * 544)),
    (140, torch.float32, 6, 4 * (420 + 1088 + 6 * 544)),
    (362, torch.float64, 12, 8 * (1086 + 1088 + 12 * 544)),
])
def test_k7_solve_shared_memory_by_warps(b, dtype, warps, nbytes):
    """A CTA of the wide solve takes shared memory for the warps it
    launches: its vectors, two rounds of two 16 x 17 blocks, a 32 x 17
    tile a warp."""
    assert k7.solve_plan(b, dtype) == ("wide", warps)
    assert k7._solve_values(b, warps) * torch.empty((), dtype=dtype).element_size() == nbytes


def _mpc_batch(nx, nu, horizon, B, seed=0):
    rng = np.random.default_rng(seed)
    Ad = np.eye(nx) + 0.05 * rng.standard_normal((nx, nx)) / np.sqrt(nx)
    Bd = rng.standard_normal((nx, nu)) / np.sqrt(nx)
    base = build_mpc_qp(Ad, Bd, np.eye(nx), 0.1 * np.eye(nu), horizon=horizon, xmin=np.full(nx, -10.0),
                        xmax=np.full(nx, 10.0), umin=np.full(nu, -1.0), umax=np.full(nu, 1.0))
    l, u = np.tile(base.l, (B, 1)), np.tile(base.u, (B, 1))
    l[:, :nx] = u[:, :nx] = rng.standard_normal((B, nx))
    return base, (np.stack([base.P] * B), np.stack([base.q] * B), np.stack([base.A] * B), l, u)


def test_block_tridiag_at_b99_matches_reference():
    """A stage-structured problem with stages of b = 99 (nx = 66, nu =
    33, two stages), B = 2, in float64 through
    solve_batch with block_tridiag on both packages: the same statuses and
    iterations, x and y within 1e-6.  On the card the same problem takes
    K7's cluster path."""
    base, args = _mpc_batch(66, 33, 1, 2)
    b = base.block_size
    assert b == 99 and k7.factor_path(b, torch.float64) == "cluster"
    kw = dict(dtype="float64", verbose=False, linsys_solver="block_tridiag", block_size=b)
    rt = osqp_tpu_torch.solve_batch(*args, device="cpu", **kw)
    rj = osqp_tpu.solve_batch(*args, **kw)
    np.testing.assert_array_equal(rt.status_val.numpy(), np.asarray(rj.status_val))
    np.testing.assert_array_equal(rt.iter.numpy(), np.asarray(rj.iter))
    assert (rt.status_val == 1).all()
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0, atol=1e-6)
    np.testing.assert_allclose(rt.y.numpy(), np.asarray(rj.y), rtol=0, atol=1e-6)


@pytest.mark.parametrize("n", [12, SIZES[0]])
def test_guard_rescue_is_counted_and_row_major(monkeypatch, n):
    """Instances whose K2 inverse misses the residual guard are inverted
    again through torch's Cholesky, counted in guard_rescued, and come
    back row-major, as the kernels take Minv (the library's batched
    inverse is column-major)."""
    P, A, rho, M, _ = _problem(SIZES[0])
    P, A, rho = P[:, :n, :n], A[:, :, :n], rho
    real = k2.spd_inverse
    # the second instance's inverse off by 1%: the guard catches it alone
    monkeypatch.setattr(k2, "spd_inverse", lambda M_: real(M_) * torch.tensor([1.0, 1.01], dtype=M_.dtype)[:, None, None])
    rescued = dense_inv.guard_rescued
    fac = dense_inv.init(torch.as_tensor(P), torch.as_tensor(A), 1e-6, torch.as_tensor(rho))
    assert dense_inv.guard_rescued == rescued + 1
    assert fac["Minv"].is_contiguous()
    Ms = torch.as_tensor(P + 1e-6 * np.eye(n) + np.einsum("bmi,bm,bmj->bij", A, rho, A))
    np.testing.assert_allclose(fac["Minv"][1].numpy(), np.linalg.inv(Ms[1].numpy()), rtol=0,
                               atol=1e-10 * float(fac["Minv"][1].abs().max()))
    assert torch.equal(fac["Minv"][0], real(Ms)[0]) or float((fac["Minv"][0] - real(Ms)[0]).abs().max()) < 1e-12
    assert not fac["refine"].any(), "the refine flag reads the residual of the inverse kept"


def test_guard_keeps_k2_where_the_rescue_is_no_better(monkeypatch):
    """A flagged instance keeps K2's inverse where Cholesky's residual is
    no lower: the library's inverse never replaces a better one."""
    n = 12
    P, A, rho, _, _ = _problem(SIZES[0])
    P, A = P[:, :n, :n], A[:, :, :n]
    real, real_chol, seen = k2.spd_inverse, dense_inv._chol_inverse, []

    def off(M_):  # K2's inverse of the second instance off by 1%
        seen.append(real(M_) * torch.tensor([1.0, 1.01], dtype=M_.dtype)[:, None, None])
        return seen[-1]

    monkeypatch.setattr(k2, "spd_inverse", off)
    # the rescue's off by 5%
    monkeypatch.setattr(dense_inv, "_chol_inverse", lambda M_: real_chol(M_) * 1.05)
    rescued = dense_inv.guard_rescued
    fac = dense_inv.init(torch.as_tensor(P), torch.as_tensor(A), 1e-6, torch.as_tensor(rho))
    assert dense_inv.guard_rescued == rescued + 1
    assert torch.equal(fac["Minv"], seen[0]) and fac["Minv"].is_contiguous()
    assert fac["refine"].tolist() == [False, True]
