"""The plain versions of K4 (Ruiz), K3 (termination products) and K1r
(refined ADMM iteration) against the JAX package, and the three kernel
wrappers' input checks.  CPU tensors: each wrapper runs its plain
version.  Tolerances: 1e-12 relative in float64, 1e-5 in float32, as
the largest difference over the largest reference value."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osqp_tpu import admm as jadmm
from osqp_tpu import scaling as jscaling
from osqp_tpu import termination as jterm
from osqp_tpu.linalg import bwhere as jbwhere
from osqp_tpu.linalg import mat_tvec as jmat_tvec
from osqp_tpu.linalg import mat_vec as jmat_vec
from osqp_tpu.linsys import dense_inv as jdense_inv
from osqp_tpu.types import DynSettings as JDyn
from osqp_tpu.types import Iterates as JIt
from osqp_tpu.types import QPData as JQP
from osqp_tpu_torch import convert
from osqp_tpu_torch.ops import admm_iter as k1
from osqp_tpu_torch.ops import ruiz as k4
from osqp_tpu_torch.ops import term_products as k3
from osqp_tpu_torch.types import QPData
from test_batch import random_qps

torch.set_num_threads(2)

TOL = {"float64": 1e-12, "float32": 1e-5}


def _rel(t, j):
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    scale = np.abs(j).max()
    return np.abs(t - j).max() / (scale if scale > 0 else 1.0)


def _problem(seed, B=5, n=9, m=13):
    """random_qps with a loose row, an equality row and a one-sided row,
    so that every branch of the scaling and the projections is taken."""
    P, q, A, l, u = random_qps(B, n, m, seed=seed)
    l[:, 0], u[:, 0] = -1e30, 1e30
    u[:, 1] = l[:, 1]
    u[:, 2] = 1e30
    return P, q, A, l, u


def _scaled(seed, dtype):
    jd = jnp.dtype(dtype)
    jdata, _ = jscaling.scale_data(JQP(*(jnp.asarray(v, jd) for v in _problem(seed))), 10)
    return jdata


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("seed,iters", [(0, 10), (1, 1), (2, 0)])
def test_ruiz_plain_matches_reference(dtype, seed, iters):
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    P, q, A, l, u = _problem(seed)
    jdata, jscl = jscaling.scale_data(JQP(*(jnp.asarray(v, jd) for v in (P, q, A, l, u))), iters) if iters else (
        JQP(*(jnp.asarray(v, jd) for v in (P, q, A, l, u))), None)
    c, D, E, Ps, qs, As, ls, us = k4.ruiz(*(torch.as_tensor(v, dtype=td) for v in (P, q, A, l, u)), iters)
    if jscl is None:
        for t in (c, D, E):
            assert (t == 1).all()
    else:
        for t, j in ((c, jscl.c), (D, jscl.D), (E, jscl.E)):
            assert _rel(t, j) <= TOL[dtype]
    for t, j in ((Ps, jdata.P), (qs, jdata.q), (As, jdata.A), (ls, jdata.l), (us, jdata.u)):
        assert _rel(t, j) <= TOL[dtype]


@pytest.mark.parametrize("n", [1, 2, 7, 64, 100])
def test_tree_sum_is_the_pairwise_sum(n):
    v = torch.as_tensor(np.random.default_rng(n).standard_normal((3, n)))
    s = k4.tree_sum(v)
    np.testing.assert_allclose(s.numpy(), v.numpy().sum(-1), rtol=1e-13, atol=1e-13)
    # the order the kernel follows: halves of the zero-padded vector
    width = 1 << (n - 1).bit_length()
    w = np.pad(v.numpy(), ((0, 0), (0, width - n)))
    while w.shape[-1] > 1:
        h = w.shape[-1] // 2
        w = w[:, :h] + w[:, h:]
    np.testing.assert_array_equal(s.numpy(), w[:, 0])


def _state(seed, B, n, m):
    rng = np.random.default_rng(200 + seed)
    x, dx = rng.standard_normal((2, B, n))
    z, y, dy = rng.standard_normal((3, B, m))
    return x, z, y, dx, dy


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("seed", [0, 1])
def test_term_products_plain_matches_reference(dtype, seed):
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    jdata = _scaled(seed, dtype)
    B, n = jdata.q.shape
    m = jdata.l.shape[1]
    x, z, y, dx, dy = _state(seed, B, n, m)
    J = lambda v: jnp.asarray(v, jd)
    T = lambda v: torch.as_tensor(v, dtype=td)
    pr = jterm.compute_products(jdata, J(x), J(z), J(y))
    want = (pr.Ax, pr.Px, pr.Aty, jmat_tvec(jdata.A, J(dy)), jmat_vec(jdata.P, J(dx)), jmat_vec(jdata.A, J(dx)))
    data = convert.from_fields(QPData, jdata, "cpu", td)
    got = k3.term_products(data.P, data.A, T(x), T(y), T(dx), T(dy))
    for g, w in zip(got, want):
        assert g.dtype == td and _rel(g, w) <= TOL[dtype]
    short = k3.term_products(data.P, data.A, T(x), T(y))
    assert short.Atdy is None and short.Pdx is None and short.Adx is None
    for g, w in zip(short[:3], got[:3]):
        assert torch.equal(g, w)


def _factor_setup(seed, dtype, B=6, n=10, m=15):
    """JAX-scaled data with equality and loose rows, its rho state and
    dense_inv factor, and the same carried into the port."""
    P, q, A, l, u = random_qps(B, n, m, seed=seed)
    u[:, :3] = l[:, :3]
    l[:, 3:6], u[:, 3:6] = -1e30, 1e30
    jd = jnp.dtype(dtype)
    jdata, _ = jscaling.scale_data(JQP(*(jnp.asarray(v, jd) for v in (P, q, A, l, u))), 10)
    jrs = jadmm.set_rho_state(jdata, jnp.full((B,), 0.1, jd))
    jdyn = JDyn.make(jd)
    jfac = jdense_inv.init(jdata.P, jdata.A, jdyn.sigma, jrs.rho_vec)
    return jdata, jrs, jdyn, jfac


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("seed", [0, 1])
def test_admm_iter_refined_plain_matches_reference(dtype, seed):
    """K1r's plain version == JAX admm_step over dense_inv.solve(refine=True)
    plus the refined loop body's active-mask selects, on one factor."""
    jdata, jrs, jdyn, jfac = _factor_setup(seed, dtype)
    B, n = jdata.q.shape
    m = jdata.l.shape[1]
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    x, z, y, dx, dy = _state(seed, B, n, m)
    active = np.arange(B) % 2 == 0
    rng = np.random.default_rng(seed)
    y_lo = rng.standard_normal((B, m)) * 1e-7 if dtype == "float32" else None
    J = lambda v: None if v is None else jnp.asarray(v, jd)
    jbk = type("_BK", (), {"solve": staticmethod(functools.partial(jdense_inv.solve, refine=True))})
    jit_new, jdx, jdy, jylo = jadmm.admm_step(jbk, jfac, jdata, jdyn, jrs, JIt(J(x), J(z), J(y)), J(y_lo))
    ja = jnp.asarray(active)
    want = [jbwhere(ja, a, J(b)) for a, b in ((jit_new.x, x), (jit_new.z, z), (jit_new.y, y), (jdx, dx), (jdy, dy))]
    T = lambda v: None if v is None else torch.as_tensor(v, dtype=td)
    got = k1.admm_iter_refined(
        T(np.array(jfac["Minv"])), T(np.array(jdata.A)), T(np.array(jfac["P"])), T(np.array(jdata.q)),
        T(np.array(jdata.l)), T(np.array(jdata.u)), T(np.array(jrs.rho_vec)), T(np.array(jrs.rho_inv_vec)),
        float(jdyn.sigma), float(jdyn.alpha), torch.as_tensor(active), T(x), T(z), T(y), T(dx), T(dy), T(y_lo),
    )
    for g, w, before in zip(got[:5], want, (x, z, y, dx, dy)):
        assert _rel(g, w) <= TOL[dtype]
        np.testing.assert_array_equal(g.numpy()[~active], T(before).numpy()[~active])
    if y_lo is None:
        assert got[5] is None
    else:
        np.testing.assert_array_equal(got[5].numpy()[~active], T(y_lo).numpy()[~active])
        # the carry is exact: (y', y_lo') is TwoSum(y, dy' + y_lo) on every active entry
        a = torch.as_tensor(active)
        assert k1.twosum_violations(T(y)[a], got[4][a], T(y_lo)[a], got[2][a], got[5][a]) == 0
        # and y' + y_lo', the dual in two words, agrees with the JAX package's
        word2 = lambda hi, lo: np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
        assert _rel(word2(got[2], got[5]), word2(want[2], jbwhere(ja, jylo, J(y_lo)))) <= TOL[dtype]


@pytest.mark.parametrize("fault", ["dropped", "passed through", "one ulp off"])
def test_twosum_check_catches_a_lost_carry(fault):
    """twosum_violations, the check chip_smoke.py and the card tests hold
    K1r's carry to, fails a carry that is not TwoSum's."""
    g = torch.Generator().manual_seed(7)
    r = lambda *s: torch.randn(*s, generator=g)
    B, n, m = 4, 6, 50
    Minv = torch.eye(n).expand(B, n, n).contiguous()
    A, P = r(B, m, n), torch.zeros(B, n, n)
    rho = torch.full((B, m), 0.1)
    y_lo = 1e-7 * r(B, m)
    args = (Minv, A, P, r(B, n), -10 * torch.ones(B, m), 10 * torch.ones(B, m), rho, 1 / rho, 1e-6, 1.6,
            torch.ones(B, dtype=torch.bool), r(B, n), r(B, m), r(B, m), r(B, n), r(B, m), y_lo)
    y = args[13]
    _, _, y_new, _, dy, lo_new = k1.admm_iter_refined_plain(*args)
    assert k1.twosum_violations(y, dy, y_lo, y_new, lo_new) == 0
    bad = {"dropped": torch.zeros_like(lo_new), "passed through": y_lo,
           "one ulp off": torch.nextafter(lo_new, torch.full_like(lo_new, float("inf")))}[fault]
    assert k1.twosum_violations(y, dy, y_lo, y_new, bad) >= B * m // 2


# ---------------------------------------------------------------------------
# Wrapper input checks
# ---------------------------------------------------------------------------
def _ruiz_args(B=2, n=3, m=4, dtype=torch.float64):
    z = lambda *s: torch.zeros(s, dtype=dtype)
    return dict(P=z(B, n, n), q=z(B, n), A=z(B, m, n), l=z(B, m), u=z(B, m))


@pytest.mark.parametrize(
    "change,error",
    [
        ({"P": torch.zeros(2, 3, 4, dtype=torch.float64)}, ValueError),
        ({"A": torch.zeros(2, 4, 2, dtype=torch.float64)}, ValueError),
        ({"l": torch.zeros(2, 4, dtype=torch.float32)}, TypeError),
        ({"q": torch.zeros(2, 3, dtype=torch.float16)}, TypeError),
        ({"q": torch.zeros(2, 0, dtype=torch.float64), "P": torch.zeros(2, 0, 0, dtype=torch.float64),
          "A": torch.zeros(2, 4, 0, dtype=torch.float64)}, ValueError),
        ({"u": torch.zeros(2, 4, dtype=torch.float64, device="meta")}, ValueError),
        ({"q": torch.zeros(6, dtype=torch.float64)}, ValueError),
    ],
)
def test_ruiz_wrapper_rejects_bad_input(change, error):
    args = _ruiz_args()
    args.update(change)
    with pytest.raises(error):
        k4.ruiz(**args, n_iters=2)


def _k3_args(B=2, n=3, m=4, dtype=torch.float64):
    z = lambda *s: torch.zeros(s, dtype=dtype)
    return dict(P=z(B, n, n), A=z(B, m, n), x=z(B, n), y=z(B, m), dx=z(B, n), dy=z(B, m))


@pytest.mark.parametrize(
    "change,error",
    [
        ({"P": torch.zeros(2, 4, 4, dtype=torch.float64)}, ValueError),
        ({"A": torch.zeros(2, 3, 3, dtype=torch.float64)}, ValueError),
        ({"y": torch.zeros(2, 4, dtype=torch.float32)}, TypeError),
        ({"x": torch.zeros(2, 3, dtype=torch.int64)}, TypeError),
        ({"dy": None}, ValueError),
        ({"dx": torch.zeros(2, 3, dtype=torch.float64, device="meta")}, ValueError),
        ({"x": torch.zeros(6, dtype=torch.float64)}, ValueError),
    ],
)
def test_term_products_wrapper_rejects_bad_input(change, error):
    args = _k3_args()
    args.update(change)
    with pytest.raises(error):
        k3.term_products(**args)


def _k1r_args(B=3, n=4, m=5, dtype=torch.float32):
    z = lambda *s: torch.zeros(s, dtype=dtype)
    return dict(
        Minv=z(B, n, n), A=z(B, m, n), P=z(B, n, n), q=z(B, n), l=z(B, m), u=z(B, m), rho=z(B, m),
        rho_inv=z(B, m), sigma=1e-6, alpha=1.6, active=torch.ones(B, dtype=torch.bool),
        x=z(B, n), z=z(B, m), y=z(B, m), dx=z(B, n), dy=z(B, m), y_lo=z(B, m),
    )


@pytest.mark.parametrize(
    "change,error",
    [
        ({"Minv": torch.zeros(3, 4, 5)}, ValueError),
        ({"P": torch.zeros(3, 5, 5)}, ValueError),
        ({"A": torch.zeros(3, 4, 4)}, ValueError),
        ({"y_lo": torch.zeros(3, 4)}, ValueError),
        ({"y_lo": torch.zeros(3, 5, dtype=torch.float64)}, TypeError),
        ({"active": torch.ones(3, dtype=torch.uint8)}, TypeError),
        ({"x": torch.zeros(3, 4, dtype=torch.float16)}, TypeError),
        ({"rho": torch.zeros(3, 5, device="meta")}, ValueError),
    ],
)
def test_admm_iter_refined_wrapper_rejects_bad_input(change, error):
    args = _k1r_args()
    args.update(change)
    with pytest.raises(error):
        k1.admm_iter_refined(**args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("refined", [False, True])
def test_admm_iter_wrappers_take_cpu_tensors_above_the_kernel_bound(refined, dtype):
    """At m = 6000, a size the kernels split over blocks (one block per
    instance would need more shared memory than the card has; the card
    runs them there, tests/test_torch_cuda.py), CPU tensors run the plain
    version and launch nothing."""
    args = _k1r_args(B=1, n=2, m=6000, dtype=dtype)
    if not refined:
        args["AMinvT"] = torch.zeros(1, 2, 6000, dtype=dtype)
        del args["P"], args["y_lo"]
    before = (k1.launches, k1.refined_launches)
    wrapper, plain = (k1.admm_iter_refined, k1.admm_iter_refined_plain) if refined else (k1.admm_iter, k1.admm_iter_plain)
    got, want = wrapper(**args), plain(**args)
    assert (k1.launches, k1.refined_launches) == before
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.shape == w.shape and torch.equal(g, w)


def test_cpu_tensors_launch_no_kernel():
    before = (k1.refined_launches, k3.launches, k4.launches)
    k4.ruiz(**_ruiz_args(), n_iters=3)
    k3.term_products(**_k3_args())
    k1.admm_iter_refined(**_k1r_args())
    assert (k1.refined_launches, k3.launches, k4.launches) == before


# (n, m, dtype, expected cluster size): the headline shape in both dtypes,
# CVXQP2_S (the Solver's K2 shape), CVXQP2_M (split path in both), no
# constraints, n = 1, a single wide row, and n above a lane's 512 columns.
@pytest.mark.parametrize(
    "n,m,dtype,want",
    [
        (100, 200, torch.float32, 2),
        (100, 200, torch.float64, 4),
        (100, 125, torch.float64, 2),
        (1000, 1250, torch.float32, 0),
        (1000, 1250, torch.float64, 0),
        (40, 0, torch.float32, 1),
        (1, 0, torch.float64, 1),
        (1, 3, torch.float32, 1),
        (513, 0, torch.float32, 0),
    ],
)
def test_ruiz_cluster_size(n, m, dtype, want):
    """K4's resident path: the smallest cluster whose per-CTA share fits
    the two-CTAs-per-SM budget, 0 (the split path) where none does."""
    k = k4.cluster_size(n, m, dtype)
    assert k == want
    elt = torch.empty((), dtype=dtype).element_size()
    if k:
        assert k4._resident_bytes(n, m, k, elt) <= k4.CTA_BUDGET
        assert 2 * (k4.CTA_BUDGET + 1024) <= 233_472  # two CTAs fit one SM
    smaller = [c for c in (1, 2, 4, 8) if c < k] if k else [1, 2, 4, 8] * (n <= 512)
    for c in smaller:
        assert k4._resident_bytes(n, m, c, elt) > k4.CTA_BUDGET


# --- K8: the KKT LU's plain versions against jax.lax.linalg.lu -----------
def _kkt(n, m, dtype, seed=0, B=3, masked=False):
    """K from the JAX package's form_kkt on random QPs: sigma = 1e-6 and
    1/rho in the ADMM form; masked, K_delta with half of A's rows zeroed."""
    from osqp_tpu.linsys import kkt_lu as jkkt_lu

    P, _, A, _, _ = random_qps(B, n, m, seed=seed)
    jd = jnp.dtype(dtype)
    if masked:
        A = A * (np.arange(m) % 2 == 0)[None, :, None]
        d, s = jnp.full((B, m), 1e-6, jd), 1e-6
    else:
        rho = 0.1 + np.abs(np.random.default_rng(seed).standard_normal((B, m)))
        d, s = jnp.asarray(1.0 / rho, jd), 1e-6
    return jkkt_lu.form_kkt(jnp.asarray(P, jd), jnp.asarray(A, jd), jnp.asarray(s, jd), d)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("n,m,masked", [(1, 0, False), (3, 4, False), (12, 18, False), (30, 45, False),
                                        (12, 18, True), (30, 45, True)])
def test_kkt_lu_plain_matches_reference(dtype, n, m, masked):
    """perm equal; lu and the solve within TOL of their largest value."""
    from osqp_tpu.linsys import kkt_lu as jkkt_lu
    from osqp_tpu_torch.ops import kkt_lu as k8

    td = getattr(torch, dtype)
    jK = _kkt(n, m, dtype, seed=n + m, masked=masked)
    jfac = jkkt_lu._lu_factor(jK)
    K = torch.as_tensor(np.array(jK), dtype=td)
    lu, perm = k8.kkt_lu_factor(K)
    assert lu.dtype == td and perm.dtype == torch.int32 and perm.shape == K.shape[:2]
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jfac["perm"]))
    assert _rel(lu, jfac["lu"]) <= TOL[dtype]
    b = np.random.default_rng(1).standard_normal(K.shape[:2])
    x = k8.kkt_lu_solve(lu, perm, torch.as_tensor(b, dtype=td))
    jx = jkkt_lu._lu_solve(jfac, jnp.asarray(b, jnp.dtype(dtype)))
    assert _rel(x, jx) <= TOL[dtype]
    # K is left alone
    np.testing.assert_array_equal(K.numpy(), np.asarray(jK))


def test_kkt_lu_plain_picks_the_first_of_equal_pivots():
    from osqp_tpu_torch.ops import kkt_lu as k8

    K = torch.tensor([[[1.0, 2.0, 3.0], [-2.0, 1.0, 0.0], [2.0, 5.0, 1.0]]], dtype=torch.float64)
    lu, perm = k8.kkt_lu_factor(K)
    assert perm.tolist() == [[1, 2, 0]]  # rows 1 and 2 tie in column 0: row 1 first
    L = torch.tril(lu[0], -1) + torch.eye(3, dtype=torch.float64)
    torch.testing.assert_close(L @ torch.triu(lu[0]), K[0][perm[0].long()])


def test_kkt_lu_singular_gives_non_finite_in_both():
    """A zero column: no exception, no repair; the solve is not finite."""
    from osqp_tpu.linsys import kkt_lu as jkkt_lu
    from osqp_tpu_torch.ops import kkt_lu as k8

    jK = np.array(_kkt(3, 4, "float64"))
    jK[1, :, 2] = 0.0
    jK[1, 2, :] = 0.0
    b = np.ones(jK.shape[:2])
    jx = np.asarray(jkkt_lu._lu_solve(jkkt_lu._lu_factor(jnp.asarray(jK)), jnp.asarray(b)))
    lu, perm = k8.kkt_lu_factor(torch.as_tensor(jK))
    x = k8.kkt_lu_solve(lu, perm, torch.as_tensor(b)).numpy()
    assert not np.isfinite(jx[1]).all() and not np.isfinite(x[1]).all()
    for i in (0, 2):
        np.testing.assert_allclose(x[i], jx[i], rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("call", [
    lambda k8, K, lu, perm, b: k8.kkt_lu_factor(K.to(torch.float16)),
    lambda k8, K, lu, perm, b: k8.kkt_lu_factor(K[:, :, :3]),
    lambda k8, K, lu, perm, b: k8.kkt_lu_factor(K[0]),
    lambda k8, K, lu, perm, b: k8.kkt_lu_solve(lu, perm.long(), b),
    lambda k8, K, lu, perm, b: k8.kkt_lu_solve(lu, perm, b[:, :3]),
    lambda k8, K, lu, perm, b: k8.kkt_lu_solve(lu, perm, b.float()),
], ids=["dtype", "not_square", "not_batched", "perm_dtype", "b_shape", "b_dtype"])
def test_kkt_lu_wrappers_check_their_input(call):
    from osqp_tpu_torch.ops import kkt_lu as k8

    K = torch.as_tensor(np.array(_kkt(2, 2, "float64")))
    lu, perm = k8.kkt_lu_factor(K)
    with pytest.raises((TypeError, ValueError)):
        call(k8, K, lu, perm, torch.ones(K.shape[:2], dtype=torch.float64))
