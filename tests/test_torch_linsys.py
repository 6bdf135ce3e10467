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
    """Up to K2's bound the inverse goes through K2's whole-matrix entry;
    above it, through K2's blocked recursion on its leaf entry (diagonal
    blocks of 80 and 90), chosen by n alone."""
    calls, leaves = [], []
    real, real_leaf = k2.chol_inverse, k2.chol_inverse_leaf
    monkeypatch.setattr(k2, "chol_inverse", lambda M: calls.append(M.shape) or real(M))
    monkeypatch.setattr(k2, "chol_inverse_leaf", lambda M: leaves.append(M.shape[-1]) or real_leaf(M))
    rng = np.random.default_rng(n)
    G = rng.standard_normal((2, n, n))
    P = torch.as_tensor(np.einsum("bij,bkj->bik", G, G) / n + 0.1 * np.eye(n))
    A = torch.as_tensor(rng.standard_normal((2, 3, n)))
    rho = torch.full((2, 3), 0.1, dtype=torch.float64)
    fac = dense_inv.init(P, A, 1e-6, rho)
    assert bool(calls) == through_k2
    assert leaves == ([] if through_k2 else [80, 90])
    M = P + 1e-6 * torch.eye(n, dtype=torch.float64) + A.transpose(1, 2) @ (rho[:, :, None] * A)
    np.testing.assert_allclose(fac["Minv"].numpy(), np.linalg.inv(M.numpy()), rtol=1e-8, atol=1e-10)


def test_dense_inv_init_above_k2_bound_polishes_like_reference():
    """Above K2's bound the blocked recursion's inverse takes the
    Newton-Schulz step that the JAX package's inverse takes at every n."""
    n = k2.max_n(torch.float32) + 1
    rng = np.random.default_rng(3)
    G = rng.standard_normal((1, n, n))
    P = torch.as_tensor(np.einsum("bij,bkj->bik", G, G) / n + 0.1 * np.eye(n), dtype=torch.float32)
    A = torch.as_tensor(rng.standard_normal((1, 5, n)), dtype=torch.float32)
    rho = torch.full((1, 5), 0.1)
    fac = dense_inv.init(P, A, 1e-6, rho)
    M = P + 1e-6 * torch.eye(n) + A.transpose(1, 2) @ (rho[:, :, None] * A)
    assert torch.equal(fac["Minv"], k2.spd_inverse(M))
    # the recursion's inverse before its Newton-Schulz step
    d = torch.diagonal(M, dim1=-2, dim2=-1).rsqrt()
    T = k2.chol_inv(M * d[:, :, None] * d[:, None, :])
    X0 = torch.bmm(T.mT, T) * d[:, :, None] * d[:, None, :]
    assert not torch.equal(fac["Minv"], X0)
    assert float((fac["Minv"] - X0).abs().max()) <= 1e-3 * float(X0.abs().max())


# --- the kkt_lu and dense_chol backends ----------------------------------
def _backend_setup(name, seed, dtype="float64", **kw):
    """JAX-scaled data, rho state, dyn, and the JAX backend's factor."""
    from osqp_tpu import linsys as jlinsys

    jdata, jrs, jdyn, _ = _setup(seed, dtype=dtype, **kw)
    return jdata, jrs, jdyn, jlinsys.get(name).init(jdata.P, jdata.A, jdyn.sigma, jrs.rho_vec)


@pytest.mark.parametrize("seed,n_eq", [(0, 0), (2, 4)])
def test_kkt_lu_backend_matches_reference(seed, n_eq):
    """form_kkt, init, solve (with the z~ recovery) and solve_raw."""
    from osqp_tpu.linsys import kkt_lu as jkkt_lu
    from osqp_tpu_torch.linsys import kkt_lu
    from osqp_tpu_torch.ops.kkt_lu import form_kkt

    jdata, jrs, jdyn, jfac = _backend_setup("kkt_lu", seed, n_eq=n_eq)
    data, rs, dyn, _ = _port(jdata, jrs, jdyn, {}, "float64")
    K = form_kkt(data.P, data.A, dyn.sigma, rs.rho_inv_vec)
    np.testing.assert_allclose(
        K.numpy(), np.asarray(jkkt_lu.form_kkt(jdata.P, jdata.A, jdyn.sigma, jrs.rho_inv_vec)), rtol=0, atol=0)
    fac = kkt_lu.init(data.P, data.A, dyn.sigma, rs.rho_vec)
    np.testing.assert_array_equal(fac["perm"].numpy(), np.asarray(jfac["perm"]))
    assert _rel(fac["lu"], jfac["lu"]) < 1e-10
    B, n = jdata.q.shape
    m = jdata.l.shape[1]
    rng = np.random.default_rng(seed)
    rhs_x, rhs_z = rng.standard_normal((B, n)), rng.standard_normal((B, m))
    jx, jz = jkkt_lu.solve(jfac, jdata.A, jrs.rho_vec, jnp.asarray(rhs_x), jnp.asarray(rhs_z))
    x_t, z_t = kkt_lu.solve(fac, data.A, rs.rho_vec, torch.as_tensor(rhs_x), torch.as_tensor(rhs_z))
    assert _rel(x_t, jx) < 1e-10 and _rel(z_t, jz) < 1e-10
    # z~ = rhs_z + nu / rho equals A x~
    np.testing.assert_allclose(z_t.numpy(), torch.bmm(data.A, x_t[:, :, None])[:, :, 0].numpy(), rtol=1e-8, atol=1e-9)
    rhs = np.concatenate([rhs_x, rhs_z], axis=-1)
    assert _rel(kkt_lu.solve_raw(fac, torch.as_tensor(rhs)), jkkt_lu.solve_raw(jfac, jnp.asarray(rhs))) < 1e-10


@pytest.mark.parametrize("seed,n_eq", [(0, 0), (2, 4)])
def test_dense_chol_backend_matches_reference(seed, n_eq):
    from osqp_tpu.linsys import dense_chol as jdense_chol
    from osqp_tpu_torch.linsys import dense_chol

    jdata, jrs, jdyn, jfac = _backend_setup("dense_chol", seed, n_eq=n_eq)
    data, rs, dyn, _ = _port(jdata, jrs, jdyn, {}, "float64")
    fac = dense_chol.init(data.P, data.A, dyn.sigma, rs.rho_vec)
    assert _rel(fac["L"], jfac["L"]) < 1e-10
    B, n = jdata.q.shape
    m = jdata.l.shape[1]
    rng = np.random.default_rng(seed)
    rhs_x, rhs_z = rng.standard_normal((B, n)), rng.standard_normal((B, m))
    jx, jz = jdense_chol.solve(jfac, jdata.A, jrs.rho_vec, jnp.asarray(rhs_x), jnp.asarray(rhs_z))
    x_t, z_t = dense_chol.solve(fac, data.A, rs.rho_vec, torch.as_tensor(rhs_x), torch.as_tensor(rhs_z))
    assert _rel(x_t, jx) < 1e-10 and _rel(z_t, jz) < 1e-10


def test_dense_chol_init_nan_on_non_pd():
    from osqp_tpu_torch.linsys import dense_chol

    P = torch.eye(3, dtype=torch.float64).repeat(2, 1, 1)
    P[1, 1, 1] = -5.0
    fac = dense_chol.init(P, torch.zeros(2, 0, 3, dtype=torch.float64), 1e-6, torch.zeros(2, 0, dtype=torch.float64))
    assert torch.isfinite(fac["L"][0]).all() and torch.isnan(fac["L"][1]).all()


@pytest.mark.parametrize("name", ["kkt_lu", "dense_chol"])
def test_converted_factor_solves_like_the_reference(name):
    """convert.factor carries a JAX kkt_lu or dense_chol factor into the
    port's: one factorization, both packages' solves."""
    from osqp_tpu import linsys as jlinsys
    from osqp_tpu_torch import linsys as tlinsys

    jdata, jrs, jdyn, jfac = _backend_setup(name, 1)
    data, rs, _, fac = _port(jdata, jrs, jdyn, jfac, "float64")
    if name == "kkt_lu":
        assert fac["perm"].dtype == torch.int32
    B, n = jdata.q.shape
    rng = np.random.default_rng(4)
    rhs_x, rhs_z = rng.standard_normal((B, n)), rng.standard_normal((B, jdata.l.shape[1]))
    jx, jz = jlinsys.get(name).solve(jfac, jdata.A, jrs.rho_vec, jnp.asarray(rhs_x), jnp.asarray(rhs_z))
    x_t, z_t = tlinsys.get(name).solve(fac, data.A, rs.rho_vec, torch.as_tensor(rhs_x), torch.as_tensor(rhs_z))
    assert _rel(x_t, jx) < 1e-12 and _rel(z_t, jz) < 1e-12


def test_backend_aliases():
    """The counterpart of test_solve_linsys.py's test_backend_aliases."""
    from osqp_tpu_torch import linsys as tlinsys

    assert tlinsys.get("qdldl") is tlinsys.get("dense_inv")
    assert tlinsys.get("mkl pardiso") is tlinsys.get("kkt_lu")
    assert tlinsys.available() == ["block_tridiag", "cg", "dense_chol", "dense_inv", "kkt_lu"]


@pytest.mark.parametrize("name", ["dense_inv", "dense_chol", "kkt_lu", "cg"])
def test_solve_kkt_against_scipy(name):
    """test_solve_linsys.py's KKT problem: x~ and the recovered z~ against
    scipy's sparse LU (generate_problem.py:33-35)."""
    from osqp_tpu_torch import linsys as tlinsys
    from test_solve_linsys import make_kkt_problem

    P, A, rho, sigma, rhs, x_exp, n, m = make_kkt_problem()
    Pd, Ad = torch.as_tensor(P.toarray())[None], torch.as_tensor(A.toarray())[None]
    rho_vec = torch.full((1, m), rho, dtype=torch.float64)
    backend = tlinsys.get(name)
    factor = backend.init(Pd, Ad, torch.tensor(sigma, dtype=torch.float64), rho_vec)
    if name == "dense_inv":  # no solve of its own: the explicit-inverse products of K1
        t = torch.as_tensor(rhs[:n])[None] + (Ad.transpose(1, 2) @ (rho_vec * torch.as_tensor(rhs[n:])[None])[:, :, None])[:, :, 0]
        x_t = (factor["Minv"] @ t[:, :, None])[:, :, 0]
        z_t = (Ad @ x_t[:, :, None])[:, :, 0]
    else:
        x_t, z_t = backend.solve(factor, Ad, rho_vec, torch.as_tensor(rhs[:n])[None], torch.as_tensor(rhs[n:])[None])
    np.testing.assert_allclose(x_t[0].numpy(), x_exp[:n], atol=1e-4)
    np.testing.assert_allclose(z_t[0].numpy(), x_exp[n:], atol=1e-4)


def test_form_kkt_matches_scipy_bmat():
    """The counterpart of test_solve_linsys.py's test of the same name."""
    import scipy.sparse as sp

    from osqp_tpu_torch.ops.kkt_lu import form_kkt
    from test_solve_linsys import make_kkt_problem

    P, A, rho, sigma, *_, n, m = make_kkt_problem()
    K_ref = sp.bmat([[P + sigma * sp.eye(n), A.T], [A, -1.0 / rho * sp.eye(m)]]).toarray()
    K = form_kkt(torch.as_tensor(P.toarray())[None], torch.as_tensor(A.toarray())[None],
                 torch.tensor(sigma, dtype=torch.float64), torch.full((1, m), 1.0 / rho, dtype=torch.float64))
    np.testing.assert_allclose(K[0].numpy(), K_ref, atol=1e-12)
    # m = 0: K is P + sigma I
    K0 = form_kkt(torch.as_tensor(P.toarray())[None], torch.zeros(1, 0, n, dtype=torch.float64), 1.0,
                  torch.zeros(1, 0, dtype=torch.float64))
    np.testing.assert_allclose(K0[0].numpy(), P.toarray() + np.eye(n), atol=1e-12)


@pytest.mark.parametrize("name", ["kkt_lu", "dense_chol"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_generic_body_matches_reference_and_leaves_inactive_alone(name, dtype):
    """run_segment's generic body (admm_step over backend.solve) against
    the JAX loop body on one step: inactive instances keep their state,
    and in float32 the TwoSum carry moves as the JAX package's."""
    import dataclasses

    from osqp_tpu import linsys as jlinsys
    from osqp_tpu_torch import admm as tadmm
    from osqp_tpu_torch.types import StaticConfig

    jdata, jrs, jdyn, jfac = _backend_setup(name, 3, dtype=dtype)
    data, rs, dyn, fac = _port(jdata, jrs, jdyn, jfac, dtype)
    B, n = jdata.q.shape
    m = jdata.l.shape[1]
    x, z, y, dx, dy, active = _state(3, B, n, m)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    y_lo = np.random.default_rng(9).standard_normal((B, m)) * 1e-7 if dtype == "float32" else None
    jit_new, jdx, jdy, jylo = jadmm.admm_step(
        jlinsys.get(name), jfac, jdata, jdyn, jrs, JIt(*(jnp.asarray(v, jd) for v in (x, z, y))),
        None if y_lo is None else jnp.asarray(y_lo, jd))
    t = lambda v: torch.as_tensor(v, dtype=td)
    cfg = StaticConfig(n=n, m=m, linsys_solver=name, check_termination=0, adaptive_rho=False, max_iter=10)
    c = tadmm.init_carry(cfg, data, rs, fac, Iterates(t(x), t(z), t(y)))
    c = dataclasses.replace(c, delta_x=t(dx), delta_y=t(dy), active=torch.as_tensor(active),
                            y_lo=None if y_lo is None else t(y_lo))
    out = tadmm.run_segment(cfg, data, None, dyn, c, 1)
    assert out.k == 2
    tol = 1e-10 if dtype == "float64" else 2e-5
    got = (out.it.x, out.it.z, out.it.y, out.delta_x, out.delta_y)
    for g, w, before in zip(got, (jit_new.x, jit_new.z, jit_new.y, jdx, jdy), (x, z, y, dx, dy)):
        assert _rel(g[active], np.asarray(w)[active]) < tol
        np.testing.assert_array_equal(g.numpy()[~active], before.astype(g.numpy().dtype)[~active])
    if y_lo is not None:
        np.testing.assert_array_equal(out.y_lo.numpy()[~active], y_lo.astype(np.float32)[~active])
        assert np.abs(out.y_lo.numpy() - np.asarray(jylo))[active].max() <= 1e-6 * np.abs(np.asarray(jit_new.y)).max()
    else:
        assert out.y_lo is None


def test_rho_adaptation_merges_an_integer_perm_leaf():
    """A rho update refactors through the registry and merges the new
    kkt_lu factor per instance: lu and the int32 perm of updated instances
    only."""
    import dataclasses

    from osqp_tpu_torch import admm as tadmm
    from osqp_tpu_torch.linsys import kkt_lu
    from osqp_tpu_torch.types import StaticConfig

    jdata, jrs, jdyn, jfac = _backend_setup("kkt_lu", 5)
    data, rs, dyn, fac = _port(jdata, jrs, jdyn, jfac, "float64")
    B, n = jdata.q.shape
    m = jdata.l.shape[1]
    x, _, y, _, _, _ = _state(5, B, n, m)
    cfg = StaticConfig(n=n, m=m, linsys_solver="kkt_lu")
    # z = A x, no primal residual: the rho estimate falls out of the tolerance band
    xt = torch.as_tensor(x)
    c = tadmm.init_carry(cfg, data, rs, fac, Iterates(xt, torch.bmm(data.A, xt[:, :, None])[:, :, 0], torch.as_tensor(y)))
    active = torch.arange(B) % 2 == 0
    c = dataclasses.replace(c, active=active)
    out = tadmm._apply_rho_adaptation(cfg, data, dyn, c)
    upd = out.info.rho_updates > 0
    assert upd.any() and not upd[~active].any()
    assert out.factor["perm"].dtype == torch.int32
    fresh = kkt_lu.init(data.P, data.A, dyn.sigma, out.rho_state.rho_vec)
    for key in ("lu", "perm"):
        assert torch.equal(out.factor[key][upd], fresh[key][upd])
        assert torch.equal(out.factor[key][~upd], fac[key][~upd])
