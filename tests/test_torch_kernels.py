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
    """At m = 6000 one block of K1 or K1r would need more shared memory
    than the card gives it, and the wrappers refuse CUDA tensors there
    (tests/test_torch_cuda.py); CPU tensors run the plain version at any
    size."""
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
