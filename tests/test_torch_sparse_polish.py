"""osqp_tpu_torch's polish on sparse (ELL) operands and its stateful
``SparseSolver`` against the JAX package on the CPU.

Polish on ELL operands eliminates the masked KKT to its Schur complement
S and solves S by Jacobi-preconditioned CG (``ops.cg.pcg_solve``: K6's
step over K5's products; on CPU tensors their plain versions).  Both
packages polish on the device at every B here except the JAX package's
B = 1 ``solve_sparse``, which polishes on the host; against that one
only the statuses are held.

The rule is ROADMAP's: in float64 the JAX package's status, iterations
and status_polish, the (polished) x and y within 1e-6; in float32 the
same status and status_polish, the iterations within one check interval
(25), x and y within 1e-4 of their largest entry (at least 1).
"""

import importlib.util
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import osqp_tpu
import osqp_tpu.constants as jcon
from osqp_tpu import polish as jpolish
from osqp_tpu import sparse_ops as jsp
from osqp_tpu.large import solve_sparse as jsolve_sparse
from osqp_tpu.verify import kkt_check
import osqp_tpu_torch
from osqp_tpu_torch import convert, large
from osqp_tpu_torch import polish as tpolish
from osqp_tpu_torch.io.qps import load_qps
from osqp_tpu_torch.ops import cg as k6
from osqp_tpu_torch.ops import ell
from test_sparse_large import _rand_sparse_qp

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-6
CHECK = 25


def _goldens_tool():
    path = os.path.join(REPO, "tools", "make_torch_goldens.py")
    spec = importlib.util.spec_from_file_location("make_torch_goldens", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _assert_xy(x, y, jx, jy, dtype):
    """x and y against the JAX package's: 1e-6 absolute in float64, 1e-4
    of the largest entry (at least 1) in float32."""
    for got, want in ((x, jx), (y, jy)):
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        if dtype == "float64":
            np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
        else:
            assert np.abs(got - want).max() <= 1e-4 * max(np.abs(want).max(), 1.0)


def _assert_info(rt, rj, dtype):
    assert rt.info.status_val == rj.info.status_val
    assert rt.info.status_polish == rj.info.status_polish
    if dtype == "float64":
        assert rt.info.iter == rj.info.iter
    else:
        assert abs(rt.info.iter - rj.info.iter) <= CHECK
    _assert_xy(rt.x, rt.y, rj.x, rj.y, dtype)


def _assert_batch(rt, rj, dtype):
    np.testing.assert_array_equal(rt.status_val.numpy(), np.asarray(rj.status_val))
    np.testing.assert_array_equal(rt.status_polish.numpy(), np.asarray(rj.status_polish))
    if dtype == "float64":
        np.testing.assert_array_equal(rt.iter.numpy(), np.asarray(rj.iter))
    else:
        assert np.abs(rt.iter.numpy() - np.asarray(rj.iter)).max() <= CHECK
    _assert_xy(rt.x.numpy(), rt.y.numpy(), np.asarray(rj.x), np.asarray(rj.y), dtype)


# ---------------------------------------------------------------------------
# The polish system and its PCG
# ---------------------------------------------------------------------------
def _polish_system(dtype="float64", seed=3):
    """A masked polish system in both packages: P and A as ELL operands
    with per-instance values (B = 2), a mask of active rows, delta."""
    P, _, A, _, _ = _rand_sparse_qp(30, 45, 0.15, seed=seed)
    B = 2
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    jP = jsp.ell_from_scipy(P, jd, batch=B, sym_from_triu=True)
    jA = jsp.ell_from_scipy(A, jd, batch=B)
    rng = np.random.default_rng(seed)
    mask = (rng.random((B, A.shape[0])) < 0.4).astype(np.float64)
    jMA = jsp.ell_scale(jA, jnp.asarray(mask, jd), jnp.ones((B, P.shape[0]), jd))
    tMA = ell.ell_scale(convert.ell(jA, "cpu", td).contiguous(), torch.as_tensor(mask, dtype=td),
                        torch.ones((B, P.shape[0]), dtype=td))
    rhs = rng.standard_normal((B, P.shape[0] + A.shape[0]))
    return jP, jMA, convert.ell(jP, "cpu", td).contiguous(), tMA, rhs


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-12), ("float32", 1e-5)])
def test_ell_kkt_solve_matches_reference(dtype, tol):
    """K_delta^-1 rhs through the Schur complement: the port's PCG on K5
    and K6 (plain versions) against the JAX package's _pcg, with its
    step count within the cap."""
    jP, jMA, tP, tMA, rhs = _polish_system(dtype)
    n, m = jP.shape[0], jMA.shape[0]
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    delta = 1e-6
    jsolve = jpolish._make_kkt_solver(n, m, jP, jMA, jnp.asarray(delta, jd), jd)
    tsolve, steps = tpolish._ell_kkt_solver(n, m, tP, tMA, torch.tensor(delta, dtype=td), td)
    want = np.asarray(jsolve(jnp.asarray(rhs, jd)))
    got = tsolve(torch.as_tensor(rhs, dtype=td)).numpy()
    assert np.abs(got - want).max() <= tol * np.abs(want).max()
    (k,) = steps
    assert 0 < int(k.max()) <= tpolish.polish_cg_cap(n, m)


def test_pcg_solve_is_the_jax_pcg():
    """pcg_solve_plain with polish's operator against the JAX _pcg on the
    same operator, from zero: x within 1e-12; pcg_solve on CPU tensors is
    the plain loop, and the chunked stop test changes no bit."""
    jP, jMA, tP, tMA, rhs = _polish_system("float64", seed=5)
    n = jP.shape[0]
    d = 1e-4
    from osqp_tpu.linalg import mat_tvec as jmt, mat_vec as jmv

    jmatvec = lambda v: jmv(jP, v) + d * v + jmt(jMA, jmv(jMA, v)) / d
    b = rhs[:, :n]
    dinv = 1.0 / (np.asarray(jsp.ell_diagonal(jP)) + d
                  + np.asarray(jsp.ell_sq_colsums(jMA, jnp.ones(jMA.val.shape[:2]))) / d)
    want = np.asarray(jpolish._pcg(jmatvec, jnp.asarray(b), jnp.asarray(dinv), 1e-12, 500))
    products = lambda v: (ell.ell_matvec(tP, v), ell.ell_tmatvec(tMA, ell.ell_matvec(tMA, v)) / d)
    tol = torch.full((2,), 1e-12, dtype=torch.float64)
    args = (products, d, torch.as_tensor(dinv), torch.as_tensor(b), tol, 500)
    x, steps = k6.pcg_solve(*args)
    assert np.abs(x.numpy() - want).max() <= 1e-12 * np.abs(want).max()
    xp, sp_ = k6.pcg_solve_plain(*args)
    xc, sc = k6.pcg_solve_plain(*args, chunk=k6.CHUNK)
    assert torch.equal(x, xp) and torch.equal(steps, sp_)
    assert torch.equal(xc, xp) and torch.equal(sc, sp_)
    assert k6.launches == 0  # CPU tensors launch nothing


@pytest.mark.parametrize("n", [1, 255, 256, 300, 10002, 16384, 40000])
def test_kernel_dot_is_an_inner_product(n):
    """The plain step's inner product, summed in the kernel's order (one
    or several grid-stride steps, up to 64 blocks), agrees with numpy's
    to rounding, and the blocks it assumes are the kernel's."""
    rng = np.random.default_rng(n)
    a, b = rng.standard_normal((3, n)), rng.standard_normal((3, n))
    got = k6.kernel_dot(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    want = np.einsum("bn,bn->b", a, b)
    assert np.abs(got - want).max() <= 1e-13 * np.abs(a * b).sum(-1).max()
    assert k6.parts_of(n) == min(max(-(-n // 256), 1), 64)


def test_polish_cg_cap_has_the_same_effect_in_both_packages(monkeypatch):
    """OSQP_TPU_POLISH_CG_CAP caps the polish CG in both packages alike:
    at 2 steps both leave the active-set solution unreached and reject
    (or accept) the polish together, with the same point."""
    P, q, A, l, u = _rand_sparse_qp(40, 60, 0.2, seed=11)
    kw = dict(dtype="float64", polish=True, verbose=False)
    B = 2
    args = (P, np.stack([q, 1.1 * q]), A, np.tile(l, (B, 1)), np.tile(u, (B, 1)))
    monkeypatch.setenv("OSQP_TPU_POLISH_CG_CAP", "2")
    assert tpolish.polish_cg_cap(40, 60) == 2
    rj = jsolve_sparse(*args, **kw)
    rt = osqp_tpu_torch.solve_sparse(*args, device="cpu", **kw)
    _assert_batch(rt, rj, "float64")
    monkeypatch.delenv("OSQP_TPU_POLISH_CG_CAP")
    assert tpolish.polish_cg_cap(40, 60) == 400 and tpolish.polish_cg_cap(20000, 30000) == 40000
    full = osqp_tpu_torch.solve_sparse(*args, device="cpu", **kw)
    assert (full.status_polish == 1).all()
    assert not torch.equal(full.x, rt.x)


# ---------------------------------------------------------------------------
# solve_sparse and SparseSolver with polish against the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_sparse_solver_polish_matches_reference(dtype):
    """B = 1: the port's SparseSolver and its solve_sparse (both polish on
    the device) against the JAX package's SparseSolver."""
    P, q, A, l, u = _rand_sparse_qp(40, 60, 0.2, seed=11)
    kw = dict(dtype=dtype, polish=True, verbose=False)
    rj = osqp_tpu.SparseSolver(P=P, q=q, A=A, l=l, u=u, **kw).solve()
    rt = osqp_tpu_torch.SparseSolver(P=P, q=q, A=A, l=l, u=u, device="cpu", **kw).solve()
    assert rt.info.status_polish == 1
    _assert_info(rt, rj, dtype)
    rb = osqp_tpu_torch.solve_sparse(P, q, A, l, u, device="cpu", **kw)
    assert int(rb.status_polish[0]) == rt.info.status_polish and int(rb.iter[0]) == rt.info.iter
    _assert_xy(rb.x.numpy()[0], rb.y.numpy()[0], rj.x, rj.y, dtype)
    # the JAX package's B = 1 solve_sparse polishes on the host: statuses only
    rh = jsolve_sparse(P, q, A, l, u, **kw)
    assert int(rh.status_val[0]) == int(rb.status_val[0]) and int(rh.status_polish[0]) == int(rb.status_polish[0])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_solve_sparse_polish_batch_matches_reference(dtype):
    """B = 2 scenario batch: both packages polish on the device."""
    P, q, A, l, u = _rand_sparse_qp(30, 40, 0.2, seed=4)
    B = 2
    args = (P, np.stack([q * (1 + 0.2 * i) for i in range(B)]), A, np.tile(l, (B, 1)), np.tile(u, (B, 1)))
    kw = dict(dtype=dtype, polish=True, verbose=False)
    rj = jsolve_sparse(*args, **kw)
    rt = osqp_tpu_torch.solve_sparse(*args, device="cpu", **kw)
    assert (rt.status_polish == 1).all()
    _assert_batch(rt, rj, dtype)
    np.testing.assert_allclose(rt.obj_val.numpy(), np.asarray(rj.obj_val), rtol=1e-6 if dtype == "float64" else 1e-4)


def test_sparse_polish_dtype_upgrade_matches_reference():
    """polish_dtype="float64" over a float32 sparse solve casts the ELL
    operands and polishes in float64, as the JAX package does."""
    P, q, A, l, u = _rand_sparse_qp(30, 40, 0.2, seed=7)
    kw = dict(dtype="float32", polish=True, polish_dtype="float64", verbose=False)
    rj = osqp_tpu.SparseSolver(P=P, q=q, A=A, l=l, u=u, **kw).solve()
    rt = osqp_tpu_torch.SparseSolver(P=P, q=q, A=A, l=l, u=u, device="cpu", **kw).solve()
    assert rt.info.status_polish == 1
    _assert_info(rt, rj, "float32")


def test_sparse_polish_matches_dense_polish():
    """The sparse polish reaches the dense polish's point, and its
    residuals beat the unpolished solve's (counterpart of
    test_sparse_large.py's test)."""
    P, q, A, l, u = _rand_sparse_qp(40, 60, 0.2, seed=11)
    kw = dict(dtype="float64", verbose=False)
    r_dense = osqp_tpu_torch.Solver(P=P, q=q, A=A, l=l, u=u, polish=True, device="cpu", **kw).solve()
    assert r_dense.info.status_polish == 1
    r_sparse = osqp_tpu_torch.solve_sparse(P, q, A, l, u, polish=True, device="cpu", **kw)
    assert int(r_sparse.status_polish[0]) == 1
    np.testing.assert_allclose(r_sparse.x.numpy()[0], r_dense.x, rtol=0, atol=1e-4)
    np.testing.assert_allclose(r_sparse.y.numpy()[0], r_dense.y, rtol=0, atol=1e-4)
    r_plain = osqp_tpu_torch.solve_sparse(P, q, A, l, u, polish=False, device="cpu", **kw)
    assert float(r_sparse.pri_res[0]) <= float(r_plain.pri_res[0]) + 1e-15
    assert float(r_sparse.dua_res[0]) <= float(r_plain.dua_res[0])
    rj = osqp_tpu.SparseSolver(P=P, q=q, A=A, l=l, u=u, polish=True, **kw).solve()
    _assert_xy(r_sparse.x.numpy()[0], r_sparse.y.numpy()[0], rj.x, rj.y, "float64")


def test_sparse_polish_banded_medium():
    """A banded n = 2000 problem (LISWET-class structure): the sparse
    polish succeeds, reaches the KKT conditions at 1e-6, and equals the
    JAX package's SparseSolver polish."""
    n = 2000
    main = 2.0 * np.ones(n)
    off = -1.0 * np.ones(n - 1)
    P = sp.diags([off, main, off], [-1, 0, 1], format="csc") + 0.1 * sp.eye(n)
    A = sp.diags([np.ones(n - 1), -2 * np.ones(n - 1)], [0, 1], shape=(n - 1, n), format="csc")
    rng = np.random.default_rng(5)
    q = rng.standard_normal(n)
    x0 = rng.standard_normal(n)
    Ax = np.asarray(A @ x0).ravel()
    s = np.abs(rng.standard_normal(n - 1)) + 0.1
    l, u = Ax - s, Ax + s
    kw = dict(dtype="float64", polish=True, verbose=False)
    res = osqp_tpu_torch.solve_sparse(P, q, A, l, u, device="cpu", **kw)
    assert int(res.status_val[0]) == jcon.OSQP_SOLVED
    assert int(res.status_polish[0]) == 1
    chk = kkt_check(P, q, A, l, u, res.x.numpy()[0], res.y.numpy()[0], eps_abs=1e-6, eps_rel=1e-6)
    assert chk["ok"], chk
    rj = osqp_tpu.SparseSolver(P=sp.triu(P, format="csc"), q=q, A=A, l=l, u=u, **kw).solve()
    assert rj.info.status_polish == 1 and int(res.iter[0]) == rj.info.iter
    _assert_xy(res.x.numpy()[0], res.y.numpy()[0], rj.x, rj.y, "float64")


# ---------------------------------------------------------------------------
# SparseSolver (counterparts of test_sparse_large.py's TestSparseSolver)
# ---------------------------------------------------------------------------
def _chain(n=80, seed=0):
    rng = np.random.default_rng(seed)
    P = sp.diags(np.abs(rng.standard_normal(n)) + 1.0).tocsc()
    A = sp.vstack([sp.eye(n), sp.diags([1.0] * (n - 1), 1).tocsr()[: n - 1]]).tocsc()
    q = rng.standard_normal(n)
    m = A.shape[0]
    return P, q, A, -np.ones(m), np.ones(m)


def _pair(P, q, A, l, u, **kw):
    kw = dict(verbose=False, dtype="float64", **kw)
    return (osqp_tpu.SparseSolver(P=P, q=q, A=A, l=l, u=u, **kw),
            osqp_tpu_torch.SparseSolver(P=P, q=q, A=A, l=l, u=u, device="cpu", **kw))


class TestSparseSolver:
    def test_solve_matches_solve_sparse(self):
        P, q, A, l, u = _chain()
        js, ts = _pair(P, q, A, l, u)
        rj, r = js.solve(), ts.solve()
        assert r.info.status == "solved"
        _assert_info(r, rj, "float64")
        ref = osqp_tpu_torch.solve_sparse(P, q, A, l, u, device="cpu", dtype="float64", verbose=False)
        np.testing.assert_allclose(r.x, ref.x.numpy()[0], rtol=0, atol=1e-12)
        assert r.info.iter == int(ref.iter[0])

    def test_warm_start_resolve_one_interval(self):
        P, q, A, l, u = _chain()
        js, ts = _pair(P, q, A, l, u, check_termination=1)
        r1, _ = ts.solve(), js.solve()
        r2, rj2 = ts.solve(), js.solve()
        assert r2.info.iter == rj2.info.iter == 1
        np.testing.assert_allclose(r2.x, r1.x, rtol=0, atol=5e-3)
        _assert_info(r2, rj2, "float64")

    def test_updates(self):
        P, q, A, l, u = _chain()
        js, ts = _pair(P, q, A, l, u)
        for s in (js, ts):
            s.solve()
            s.update_lin_cost(-q)
        _assert_info(ts.solve(), js.solve(), "float64")
        for s in (js, ts):
            s.update_P(Px=s._Pu.data * 2.0)
        r2, rj2 = ts.solve(), js.solve()
        assert r2.info.status == "solved"
        _assert_info(r2, rj2, "float64")
        with pytest.raises(osqp_tpu_torch.OSQPError):
            ts.update_bounds(l=np.ones(ts.m), u=-np.ones(ts.m))
        fresh = osqp_tpu_torch.solve_sparse(sp.csc_matrix(sp.triu(ts._Pu)), -q, A, l, u, device="cpu",
                                            dtype="float64", verbose=False)
        np.testing.assert_allclose(r2.x, fresh.x.numpy()[0], rtol=0, atol=1e-4)

    def test_update_A_then_solve(self):
        P, q, A, l, u = _chain()
        js, ts = _pair(P, q, A, l, u)
        for s in (js, ts):
            s.solve()
            s.update_A(Ax=s._Ac.data * 0.5)
        r, rj = ts.solve(), js.solve()
        assert r.info.status == "solved"
        _assert_info(r, rj, "float64")
        assert np.all((A * 0.5) @ r.x <= u + 1e-3)

    def test_not_setup_errors(self):
        with pytest.raises(osqp_tpu_torch.OSQPError):
            osqp_tpu_torch.SparseSolver().solve()
        with pytest.raises(osqp_tpu_torch.OSQPError, match="only the matrix-free 'cg'"):
            osqp_tpu_torch.SparseSolver(*_chain(n=10), device="cpu", linsys_solver="dense_inv")

    def test_settings_setters(self):
        P, q, A, l, u = _chain(n=20)
        js, ts = _pair(P, q, A, l, u)
        for s in (js, ts):
            s.update_eps_abs(1e-4)
            s.update_eps_rel(1e-4)
            s.update_max_iter(900)
        assert ts.settings.eps_abs == 1e-4 and ts.settings.max_iter == 900
        with pytest.raises(osqp_tpu_torch.OSQPError):
            ts.update_eps_abs(-1.0)
        with pytest.raises(osqp_tpu_torch.OSQPError):
            ts.update_rho(0.0)
        r = ts.solve()
        assert r.info.status == "solved"
        _assert_info(r, js.solve(), "float64")


class TestSparseSolverDeviceResident:
    """The ELL operands, scaling and iterates stay on the device between
    solves; updates gather values through the slot maps."""

    def test_pattern_built_once(self, monkeypatch):
        P, q, A, l, u = _chain(n=60, seed=3)
        ts = osqp_tpu_torch.SparseSolver(P=P, q=q, A=A, l=l, u=u, device="cpu", verbose=False)
        ts.solve()
        maps = ts._patterns

        def boom(*a, **k):
            raise AssertionError("host ELL pattern rebuild after setup")

        for name in ("ell_pattern_from_scipy", "ell_value_maps", "ell_from_scipy"):
            monkeypatch.setattr(large, name, boom)
        ts.update_P(Px=ts._Pu.data * 1.5)
        ts.update_lin_cost(-q)
        ts.update_bounds(l=l - 0.5, u=u + 0.5)
        assert ts.solve().info.status == "solved"
        assert ts._patterns is maps

    def test_update_equivalence_vs_fresh(self):
        """Updates, then a re-solve, land exactly where a fresh setup on
        the final data lands (and where the JAX package lands)."""
        P, q, A, l, u = _chain(n=60, seed=3)
        js, ts = _pair(P, q, A, l, u, warm_start=False)
        for s in (js, ts):
            s.solve()
            for k in range(3):
                s.update_lin_cost(q * (0.5 + k))
                s.update_P(Px=s._Pu.data * 1.1)
                s.solve()
        fresh = osqp_tpu_torch.SparseSolver(P=sp.csc_matrix(sp.triu(ts._Pu)), q=q * 2.5, A=A, l=l, u=u, device="cpu",
                                            verbose=False, warm_start=False, dtype="float64")
        rf, rs, rj = fresh.solve(), ts.solve(), js.solve()
        assert rs.info.iter == rf.info.iter
        np.testing.assert_allclose(rs.x, rf.x, rtol=0, atol=1e-12)
        _assert_info(rs, rj, "float64")

    def test_polish_on_sparse_solver(self):
        """Polish writes back into the device iterates: a warm re-solve
        terminates at the first check (polish.c:323-327)."""
        P, q, A, l, u = _chain(n=60, seed=3)
        js, ts = _pair(P, q, A, l, u, polish=True)
        r, rj = ts.solve(), js.solve()
        assert r.info.status == "solved" and r.info.status_polish == 1
        _assert_info(r, rj, "float64")
        ts.update_check_termination(1)
        assert ts.solve().info.iter == 1

    def test_indexed_updates_device_path(self):
        P, q, A, l, u = _chain(n=20, seed=3)
        js, ts = _pair(P, q, A, l, u, warm_start=False)
        idx = np.array([0, 3, 7])
        for s in (js, ts):
            s.solve()
            s.update_P(Px=np.full(3, 9.0), Px_idx=idx)
        assert np.allclose(ts._Pu.data[idx], 9.0)
        r, rj = ts.solve(), js.solve()
        assert r.info.status == "solved"
        _assert_info(r, rj, "float64")
        fresh = osqp_tpu_torch.solve_sparse(sp.csc_matrix(sp.triu(ts._Pu)), q, A, l, u, device="cpu",
                                            dtype="float64", verbose=False)
        np.testing.assert_allclose(r.x, fresh.x.numpy()[0], rtol=0, atol=1e-10)

    def test_export_matches_jax_export(self):
        """SparseSolver.export (ROADMAP item 14, which raised until it was
        ported) with polish on: the loaded callable gives the JAX
        package's artifact's status, iterations, status_polish, x and y
        on the device-resident solver's problem."""
        from osqp_tpu import export as jexport
        from osqp_tpu_torch import export as texport

        P, q, A, l, u = _chain(n=10)
        js, ts = _pair(P, q, A, l, u, polish=True)
        inputs = (ts._Pu.data, q[None], ts._Ac.data, l[None], u[None])
        rt = texport.load_sparse_solver(ts.export(), device="cpu")(*inputs)
        rj = jexport.load_sparse_solver(js.export())(*inputs)
        assert rt["status_polish"].tolist() == [1]
        _assert_batch(types.SimpleNamespace(**rt), types.SimpleNamespace(**rj), "float64")


# ---------------------------------------------------------------------------
# LISWET1 with polish against the JAX goldens that chip_smoke.py reads
# ---------------------------------------------------------------------------
def test_liswet1_float32_polish_matches_golden():
    """LISWET1 (n = 10002, m = 10000) in float32 through the SparseSolver
    with polish on: status, iterations (within 25), status_polish and x
    and y (within 1e-4) as the JAX package's SparseSolver in
    sparse_polish.npz; both reject the polish.  (The float64 cases and
    CVXQP2_L take minutes of PCG on the CPU; chip_smoke.py holds them on
    the card.)"""
    tool = _goldens_tool()
    g = np.load(tool.OUT_POLISH_SPARSE)
    case = "LISWET1/float32"
    qp = load_qps(f"{tool.MAROS}/LISWET1.qps")
    r = osqp_tpu_torch.SparseSolver(P=qp.P, q=qp.q, A=qp.A, l=qp.l, u=qp.u, device="cpu", dtype="float32",
                                    polish=True, verbose=False).solve()
    assert [r.info.status_val] == g[f"{case}/status_val"].tolist()
    assert [r.info.status_polish] == g[f"{case}/status_polish"].tolist()
    assert abs(r.info.iter - int(g[f"{case}/iter"][0])) <= CHECK
    _assert_xy(r.x, r.y, g[f"{case}/x"][0], g[f"{case}/y"][0], "float32")


def test_sparse_polish_goldens_are_current():
    """The stored JAX results: one entry regenerated by the tool equals
    the file's, and the file holds every case and the host polish's
    statuses."""
    tool = _goldens_tool()
    g = np.load(tool.OUT_POLISH_SPARSE)
    want = {f"{c}/{f}" for c in tool.POLISH_CASES for f in tool.POLISH_SPARSE_FIELDS}
    want |= {f"{name}/{dtype}/host_status_polish" for name, dtype, entry, _ in tool.POLISH_CASES.values()
             if entry == "SparseSolver"}
    assert set(g.files) == want
    fresh = tool.polish_golden("LISWET1/float32")
    for f in ("status_val", "iter", "status_polish"):
        np.testing.assert_array_equal(fresh[f], g[f"LISWET1/float32/{f}"])
    for f in ("obj_val", "pri_res", "dua_res", "x", "y"):
        np.testing.assert_allclose(fresh[f], g[f"LISWET1/float32/{f}"], rtol=1e-6, atol=1e-6)
