"""osqp_tpu_torch's dense_inv backend and its two kernels' plain versions
against the JAX package, plus the kernel wrappers' input checks and the
shape dispatch above K2's bound.  CPU tensors: the wrappers run their
plain versions."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osqp_tpu import admm as jadmm
from osqp_tpu import scaling as jscaling
from osqp_tpu.linalg import bwhere as jbwhere
from osqp_tpu.linsys import dense_inv as jdense_inv
from osqp_tpu.ops.spd_inverse import spd_inverse as jspd_inverse
from osqp_tpu.types import DynSettings as JDyn
from osqp_tpu.types import Iterates as JIt
from osqp_tpu.types import QPData as JQP
from osqp_tpu_torch import convert
from osqp_tpu_torch.linsys import dense_inv
from osqp_tpu_torch.ops import admm_iter as k1
from osqp_tpu_torch.ops import spd_inverse as k2
from osqp_tpu_torch.types import DynSettings, Iterates, QPData, RhoState
from test_batch import random_qps

torch.set_num_threads(2)


def _rel(t, j):
    j = np.asarray(j)
    return np.abs(t.numpy() - j).max() / np.abs(j).max()


def _setup(seed, dtype="float64", B=6, n=12, m=18, n_eq=0, n_loose=4):
    """JAX-scaled data, rho state and factor.  With ``n_eq`` > 0, that many
    equality rows (rho x 1e3), ``n_loose`` loose rows (rho = 1e-6) and a
    small P drive the Schur complement's condition number to ~1e5 (four
    loose rows) or ~1e6-1e7 (eight)."""
    P, q, A, l, u = random_qps(B, n, m, seed=seed)
    if n_eq:
        u[:, :n_eq] = l[:, :n_eq]
        l[:, n_eq:n_eq + n_loose], u[:, n_eq:n_eq + n_loose] = -1e30, 1e30
        P *= 1e-3
    jd = jnp.dtype(dtype)
    jdata, _ = jscaling.scale_data(JQP(*(jnp.asarray(v, jd) for v in (P, q, A, l, u))), 10)
    jrs = jadmm.set_rho_state(jdata, jnp.full((B,), 0.1, jd))
    jdyn = JDyn.make(jd)
    jfac = jdense_inv.init(jdata.P, jdata.A, jdyn.sigma, jrs.rho_vec)
    return jdata, jrs, jdyn, jfac


def _port(jdata, jrs, jdyn, jfac, dtype):
    td = getattr(torch, dtype)
    return (
        convert.from_fields(QPData, jdata, "cpu", td),
        convert.from_fields(RhoState, jrs, "cpu", td),
        convert.from_fields(DynSettings, jdyn, "cpu", td),
        convert.factor(jfac, "cpu", td),
    )


@pytest.mark.parametrize("seed,n_eq", [(0, 0), (1, 0), (2, 4), (3, 6)])
def test_dense_inv_init_matches_reference(seed, n_eq):
    # The refine flag compares each inverse's residual with 1e-12, and two
    # algorithms' residuals only agree in order of magnitude.  The cases
    # sit clearly on one side: ~1e-15 (well conditioned) or 1e-11..1e-10
    # (eight loose rows, condition number ~4e6).
    jdata, jrs, jdyn, jfac = _setup(seed, n_eq=n_eq, n_loose=8)
    data, rs, dyn, _ = _port(jdata, jrs, jdyn, jfac, "float64")
    fac = dense_inv.init(data.P, data.A, dyn.sigma, rs.rho_vec)
    # K2 (Cholesky) and the JAX package's recursive inverse are different
    # algorithms: they agree to the inverse's forward error, not bitwise.
    assert _rel(fac["Minv"], jfac["Minv"]) < 1e-8
    assert _rel(fac["AMinvT"], jfac["AMinvT"]) < 1e-8
    np.testing.assert_array_equal(fac["refine"].numpy(), np.asarray(jfac["refine"]))
    if n_eq:
        assert fac["refine"].any(), "the ill-conditioned case should exercise the refine flag"
    # JAX's own spd_inverse on the same Schur matrices, directly
    from osqp_tpu.linsys.dense_chol import form_schur as jform_schur

    jM = jform_schur(jdata.P, jdata.A, jdyn.sigma, jrs.rho_vec)
    assert _rel(k2.spd_inverse(torch.as_tensor(np.array(jM))), jspd_inverse(jM)) < 1e-8


def test_spd_inverse_nan_on_non_pd():
    rng = np.random.default_rng(0)
    G = rng.standard_normal((3, 6, 6))
    M = np.einsum("bij,bkj->bik", G, G) + np.eye(6)
    M[1, 2, 2] = -1.0  # not PD, negative diagonal
    M[2] -= 20.0 * np.eye(6)  # not PD, positive diagonal
    X = k2.chol_inverse(torch.as_tensor(M)).numpy()
    assert np.isnan(X[1]).all() and np.isnan(X[2]).all()
    np.testing.assert_allclose(X[0], np.linalg.inv(M[0]), rtol=1e-10, atol=1e-12)
    assert np.isnan(np.asarray(jspd_inverse(jnp.asarray(M)))[1:]).any(axis=(1, 2)).all()


def _state(seed, B, n, m):
    rng = np.random.default_rng(50 + seed)
    x, dx = rng.standard_normal((2, B, n))
    z, y, dy = rng.standard_normal((3, B, m))
    active = rng.random(B) < 0.6
    return x, z, y, dx, dy, active


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k1_plain_matches_reference_step(seed):
    """K1's plain version == JAX admm_step over dense_inv.solve (plain
    body) plus the loop body's active-mask selects, on identical factors."""
    jdata, jrs, jdyn, jfac = _setup(seed)
    data, rs, dyn, fac = _port(jdata, jrs, jdyn, jfac, "float64")
    B, n = jdata.q.shape
    m = jdata.l.shape[1]
    x, z, y, dx, dy, active = _state(seed, B, n, m)
    jit_new, jdx, jdy, _ = jadmm.admm_step(jdense_inv, jfac, jdata, jdyn, jrs, JIt(*map(jnp.asarray, (x, z, y))))
    ja = jnp.asarray(active)
    want = (
        jbwhere(ja, jit_new.x, x), jbwhere(ja, jit_new.z, z), jbwhere(ja, jit_new.y, y),
        jbwhere(ja, jdx, dx), jbwhere(ja, jdy, dy),
    )
    t = lambda v: torch.as_tensor(v)
    got = dense_inv.fused_step(
        fac, data, dyn, rs, Iterates(t(x), t(z), t(y)), t(dx), t(dy), t(active)
    )
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=1e-12)
    for g, before in zip(got, (x, z, y, dx, dy)):
        np.testing.assert_array_equal(g.numpy()[~active], before[~active])


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-12), ("float32", 2e-5)])
def test_refined_step_matches_reference(dtype, tol):
    """The refined loop body (plain PyTorch): residual-corrected solve and,
    in float32, the TwoSum dual carry."""
    jdata, jrs, jdyn, jfac = _setup(2, dtype=dtype, n_eq=6)
    data, rs, dyn, fac = _port(jdata, jrs, jdyn, jfac, dtype)
    B, n = jdata.q.shape
    m = jdata.l.shape[1]
    x, z, y, _, _, _ = _state(2, B, n, m)
    y_lo = np.random.default_rng(9).standard_normal((B, m)) * 1e-7 if dtype == "float32" else None
    jd = jnp.dtype(dtype)
    jbk = type("_BK", (), {"solve": staticmethod(functools.partial(jdense_inv.solve, refine=True))})
    jit_new, jdx, jdy, jylo = jadmm.admm_step(
        jbk, jfac, jdata, jdyn, jrs, JIt(*(jnp.asarray(v, jd) for v in (x, z, y))),
        None if y_lo is None else jnp.asarray(y_lo, jd),
    )
    td = getattr(torch, dtype)
    t = lambda v: torch.as_tensor(v, dtype=td)
    xn, zn, yn, dx, dy, ylo = dense_inv.refined_step(
        fac, data, dyn, rs, Iterates(t(x), t(z), t(y)), torch.zeros((B, n), dtype=td), torch.zeros((B, m), dtype=td),
        None if y_lo is None else t(y_lo), torch.ones(B, dtype=torch.bool),
    )
    for g, w in ((xn, jit_new.x), (zn, jit_new.z), (yn, jit_new.y), (dx, jdx), (dy, jdy)):
        assert _rel(g, w) < tol
    if y_lo is not None:
        assert np.abs(ylo.numpy() - np.asarray(jylo)).max() <= 1e-6 * np.abs(np.asarray(jit_new.y)).max()


def _k1_args(B=3, n=4, m=5, dtype=torch.float64):
    z = lambda *s: torch.zeros(s, dtype=dtype)
    return dict(
        Minv=z(B, n, n), AMinvT=z(B, n, m), A=z(B, m, n), q=z(B, n), l=z(B, m), u=z(B, m),
        rho=z(B, m), rho_inv=z(B, m), sigma=1e-6, alpha=1.6, active=torch.ones(B, dtype=torch.bool),
        x=z(B, n), z=z(B, m), y=z(B, m), dx=z(B, n), dy=z(B, m),
    )


@pytest.mark.parametrize(
    "change,error",
    [
        ({"Minv": torch.zeros(3, 4, 5, dtype=torch.float64)}, ValueError),
        ({"AMinvT": torch.zeros(3, 5, 4, dtype=torch.float64)}, ValueError),
        ({"A": torch.zeros(2, 5, 4, dtype=torch.float64)}, ValueError),
        ({"q": torch.zeros(3, 4, dtype=torch.float32)}, TypeError),
        ({"active": torch.ones(3, dtype=torch.int32)}, TypeError),
        ({"active": torch.ones(4, dtype=torch.bool)}, ValueError),
        ({"x": torch.zeros(3, 4, dtype=torch.float16)}, TypeError),
        ({"rho": torch.zeros(3, 5, dtype=torch.float64, device="meta")}, ValueError),
    ],
)
def test_k1_wrapper_rejects_bad_input(change, error):
    args = _k1_args()
    args.update(change)
    with pytest.raises(error):
        k1.admm_iter(**args)


@pytest.mark.parametrize(
    "M,error",
    [
        (torch.zeros(2, 3, 3, dtype=torch.float16), TypeError),
        (torch.zeros(2, 3, 3, dtype=torch.int64), TypeError),
        (torch.zeros(2, 3, 4), ValueError),
        (torch.zeros(3, 3), ValueError),
        (torch.zeros(1, 0, 0), ValueError),
        (torch.zeros(1, 241, 241, dtype=torch.float32), ValueError),
        (torch.zeros(1, 170, 170, dtype=torch.float64), ValueError),
    ],
)
def test_k2_wrapper_rejects_bad_input(M, error):
    with pytest.raises(error):
        k2.chol_inverse(M)


def test_k2_bound():
    assert k2.max_n(torch.float32) == 240
    assert k2.max_n(torch.float64) == 169


@pytest.mark.parametrize("n,through_k2", [(169, True), (170, False)])
def test_dense_inv_init_shape_dispatch(monkeypatch, n, through_k2):
    """Up to K2's bound the inverse goes through K2; above it, through
    torch's Cholesky, chosen by n alone."""
    calls = []
    real = k2.chol_inverse
    monkeypatch.setattr(k2, "chol_inverse", lambda M: calls.append(M.shape) or real(M))
    rng = np.random.default_rng(n)
    G = rng.standard_normal((2, n, n))
    P = torch.as_tensor(np.einsum("bij,bkj->bik", G, G) / n + 0.1 * np.eye(n))
    A = torch.as_tensor(rng.standard_normal((2, 3, n)))
    rho = torch.full((2, 3), 0.1, dtype=torch.float64)
    fac = dense_inv.init(P, A, 1e-6, rho)
    assert bool(calls) == through_k2
    M = P + 1e-6 * torch.eye(n, dtype=torch.float64) + A.transpose(1, 2) @ (rho[:, :, None] * A)
    np.testing.assert_allclose(fac["Minv"].numpy(), np.linalg.inv(M.numpy()), rtol=1e-8, atol=1e-10)


def test_dense_inv_init_above_k2_bound_polishes_like_reference():
    """Above K2's bound the Cholesky inverse takes the Newton-Schulz step
    that the JAX package's inverse takes at every n."""
    n = k2.max_n(torch.float32) + 1
    rng = np.random.default_rng(3)
    G = rng.standard_normal((1, n, n))
    P = torch.as_tensor(np.einsum("bij,bkj->bik", G, G) / n + 0.1 * np.eye(n), dtype=torch.float32)
    A = torch.as_tensor(rng.standard_normal((1, 5, n)), dtype=torch.float32)
    rho = torch.full((1, 5), 0.1)
    fac = dense_inv.init(P, A, 1e-6, rho)
    M = P + 1e-6 * torch.eye(n) + A.transpose(1, 2) @ (rho[:, :, None] * A)
    assert torch.equal(fac["Minv"], k2.newton_schulz(M, dense_inv._chol_inverse(M)))
    assert not torch.equal(fac["Minv"], dense_inv._chol_inverse(M))
