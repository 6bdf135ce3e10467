"""osqp_tpu_torch's sparse path against the JAX package on the CPU: the
ELL operand and its value maps, K5's plain versions (what its wrappers
run for CPU tensors), the matrix-free Ruiz sweeps, the termination
products and ``solve_sparse``.

The rule is ROADMAP's: in float64 the JAX package's status and
iteration count, x and y within 1e-6; in float32 its status and the
iterations within one check interval (25).  Products and scaling agree
to 1e-12 in float64, differing only in the order of summation.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import osqp_tpu.constants as jcon
from osqp_tpu import scaling as jscaling
from osqp_tpu import sparse_ops as jsp
from osqp_tpu import termination as jterm
from osqp_tpu.large import solve_sparse as jsolve_sparse
from osqp_tpu.types import QPData as JQP
from osqp_tpu.verify import primal_infeasibility_check
import osqp_tpu_torch
from osqp_tpu_torch import convert, scaling, sparse_ops, termination
from osqp_tpu_torch.ops import ell
from osqp_tpu_torch.sparse_ops import ELLMatrix
from osqp_tpu_torch.types import QPData
from test_sparse_large import _rand_sparse_qp

torch.set_num_threads(2)

ATOL = 1e-6
CHECK = 25


def _matrix(m, n, seed, explicit_zero=False):
    rng = np.random.default_rng(seed)
    M = sp.random(m, n, density=0.3, random_state=rng, format="csc")
    if explicit_zero and M.nnz:
        M.data[0] = 0.0  # a stored zero keeps its slot
    return M


def _batched(M, B, seed, dtype="float64", sym_from_triu=False):
    """The same ELL operand in both packages, with per-instance values
    (the unscaled values times a random factor per instance)."""
    jE = jsp.ell_from_scipy(M, jnp.float64, batch=B, sym_from_triu=sym_from_triu)
    f = 1.0 + np.random.default_rng(seed).random((B, 1, 1))
    val, t_val = np.asarray(jE.val) * f, np.asarray(jE.t_val) * f
    jd = jnp.dtype(dtype)
    jE = jsp.ELLMatrix(val=jnp.asarray(val, jd), idx=jE.idx, t_val=jnp.asarray(t_val, jd), t_idx=jE.t_idx,
                       shape=jE.shape)
    return jE, convert.ell(jE, "cpu", getattr(torch, dtype))


def _rel(t, j):
    j = np.asarray(j)
    scale = np.abs(j).max() if j.size else 1.0
    return np.abs(t.numpy() - j).max() / (scale if scale > 0 else 1.0) if j.size else 0.0


# ---------------------------------------------------------------------------
# The operand and its value maps
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,sym", [((17, 11), False), ((0, 5), False), ((9, 9), False), ((9, 9), True)])
def test_ell_from_scipy_matches_reference(shape, sym):
    m, n = shape
    M = _matrix(m, n, seed=1)
    jE = jsp.ell_from_scipy(M, jnp.float64, batch=3, sym_from_triu=sym)
    tE = sparse_ops.ell_from_scipy(M, torch.float64, batch=3, sym_from_triu=sym)
    assert tE.shape == jE.shape and tE.batch == 3
    for f in ("val", "idx", "t_val", "t_idx"):
        got, want = getattr(tE, f), np.asarray(getattr(jE, f))
        assert got.dtype == (torch.int32 if f.endswith("idx") else torch.float64), f
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f)
    # values broadcast over the batch; contiguous() makes B copies
    assert tE.val.stride(0) == 0 and tE.contiguous().val.is_contiguous()


@pytest.mark.parametrize("sym", [False, True])
def test_value_maps_and_pattern_match_reference(sym):
    M = _matrix(12, 12, seed=2, explicit_zero=True)
    if sym:
        M = sp.triu(M + M.T, format="csc")
        M.data[0] = 0.0
    js, jts = jsp.ell_value_maps(M, sym_from_triu=sym)
    ts, tts = sparse_ops.ell_value_maps(M, sym_from_triu=sym)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tts, jts)
    jpat = jsp.ell_pattern_from_scipy(M, sym_from_triu=sym)
    tpat = sparse_ops.ell_pattern_from_scipy(M, sym_from_triu=sym)
    np.testing.assert_array_equal(tpat[0], jpat[0])
    np.testing.assert_array_equal(tpat[1], jpat[1])
    assert tpat[2] == jpat[2]
    values = np.random.default_rng(3).standard_normal(M.nnz)
    jE = jsp.ell_with_values(*jpat, js, jts, values, jnp.float64, batch=2)
    tE = sparse_ops.ell_with_values(*tpat, ts, tts, values, torch.float64, batch=2)
    for f in ("val", "idx", "t_val", "t_idx"):
        np.testing.assert_array_equal(getattr(tE, f).numpy(), np.asarray(getattr(jE, f)), err_msg=f)
    with pytest.raises(ValueError, match="same matrix"):
        sparse_ops.ell_with_values(*tpat, ts[:-1], tts, values, torch.float64)


# ---------------------------------------------------------------------------
# K5: the plain versions against the JAX package
# ---------------------------------------------------------------------------
def _k5_cases(B=3, m=17, n=11, seed=4):
    rng = np.random.default_rng(seed)
    jA, tA = _batched(_matrix(m, n, seed), B, seed)
    Pm = sp.triu(_matrix(n, n, seed + 1) + sp.eye(n), format="csc")
    jP, tP = _batched(Pm, B, seed + 1, sym_from_triu=True)
    x, cw, cs = rng.standard_normal((B, n)), rng.random((B, n)) + 0.1, rng.random((B, n)) + 0.5
    y, w, rs = rng.standard_normal((B, m)), rng.random((B, m)) + 0.1, rng.random((B, m)) + 0.5
    c = rng.random(B) + 0.5
    J, T = jnp.asarray, torch.as_tensor
    return {
        "matvec": (lambda: jsp.ell_matvec(jA, J(x)), lambda f: f(tA, T(x))),
        "tmatvec": (lambda: jsp.ell_tmatvec(jA, J(y)), lambda f: f(tA, T(y))),
        "tmatvec_weighted": (lambda: jsp.ell_tmatvec(jA, J(w) * J(y)), lambda f: f(tA, T(y), T(w))),
        "diagonal": (lambda: jsp.ell_diagonal(jP), lambda f: f(tP)),
        "sq_colsums": (lambda: jsp.ell_sq_colsums(jA, J(w)), lambda f: f(tA, T(w))),
        "row_norms": (lambda: jsp.ell_row_norms(jA, J(cw)), lambda f: f(tA, T(cw))),
        "col_norms": (lambda: jsp.ell_col_norms(jA, J(w)), lambda f: f(tA, T(w))),
        "P_col_norms": (lambda: jsp.ell_col_norms(jP, J(cw)), lambda f: f(tP, T(cw))),
        "scale": (lambda: jsp.ell_scale(jA, J(rs), J(cs)), lambda f: f(tA, T(rs), T(cs))),
        "scale_cost": (lambda: jsp.ell_scale(jP, J(cs), J(cs), J(c)), lambda f: f(tP, T(cs), T(cs), T(c))),
    }


_K5_FUNCS = {"matvec": "ell_matvec", "tmatvec": "ell_tmatvec", "tmatvec_weighted": "ell_tmatvec",
             "diagonal": "ell_diagonal", "sq_colsums": "ell_sq_colsums", "row_norms": "ell_row_norms",
             "col_norms": "ell_col_norms", "P_col_norms": "ell_col_norms", "scale": "ell_scale",
             "scale_cost": "ell_scale"}


@pytest.mark.parametrize("case", sorted(_K5_FUNCS))
def test_k5_plain_matches_reference(case):
    """Each K5 mode's plain version against its JAX twin: sums to 1e-12,
    maxima, the diagonal and the scaled values exactly; the wrapper on
    CPU tensors is the plain version."""
    jfn, tfn = _k5_cases()[case]
    name = _K5_FUNCS[case]
    want = jfn()
    got = tfn(getattr(ell, f"{name}_plain"))
    wrapped = tfn(getattr(ell, name))
    if case.startswith("scale"):
        for f in ("val", "t_val"):
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
            assert torch.equal(getattr(wrapped, f), getattr(got, f))
        return
    assert torch.equal(wrapped, got)
    if case in ("diagonal", "row_norms", "col_norms", "P_col_norms"):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        assert _rel(got, want) < 1e-12


def test_k5_empty_operands_take_the_short_cuts():
    """No rows or no columns: zeros of the right shape, nothing launched."""
    for m, n in ((0, 5), (4, 0)):
        E = sparse_ops.ell_from_scipy(sp.csr_matrix((m, n)), torch.float64, batch=2).contiguous()
        x, y = torch.randn(2, n, dtype=torch.float64), torch.randn(2, m, dtype=torch.float64)
        assert ell.ell_matvec(E, x).shape == (2, m) and not ell.ell_matvec(E, x).any()
        assert ell.ell_tmatvec(E, y).shape == (2, n) and not ell.ell_tmatvec(E, y).any()
        assert ell.ell_row_norms(E, x.abs()).shape == (2, m)
        assert ell.ell_col_norms(E, y.abs()).shape == (2, n)
        S = ell.ell_scale(E, y.abs(), x.abs())
        assert not S.val.any() and not S.t_val.any()


def test_k5_wrappers_check_their_inputs():
    E = sparse_ops.ell_from_scipy(_matrix(6, 4, seed=5), torch.float64, batch=2).contiguous()
    with pytest.raises(ValueError, match="expected"):
        ell.ell_matvec(E, torch.randn(2, 5, dtype=torch.float64))
    with pytest.raises(ValueError, match="expected"):
        ell.ell_matvec(E, torch.randn(2, 4, dtype=torch.float32))
    bad = ELLMatrix(val=E.val, idx=E.idx.long(), t_val=E.t_val, t_idx=E.t_idx, shape=E.shape)
    with pytest.raises(TypeError, match="int32"):
        ell.ell_matvec(bad, torch.randn(2, 4, dtype=torch.float64))
    meta = ELLMatrix(val=E.val.to("meta"), idx=E.idx.to("meta"), t_val=E.t_val.to("meta"),
                     t_idx=E.t_idx.to("meta"), shape=E.shape)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ell.ell_matvec(meta, torch.empty(2, 4, dtype=torch.float64, device="meta"))


# ---------------------------------------------------------------------------
# Scaling and the termination products on ELL operands
# ---------------------------------------------------------------------------
def _sparse_data(n=30, m=45, seed=6, B=2, dtype="float64"):
    P, q, A, l, u = _rand_sparse_qp(n, m, 0.15, seed)
    rng = np.random.default_rng(seed)
    qs = np.stack([q * (1 + 0.1 * i) for i in range(B)])
    ls, us = np.tile(l, (B, 1)), np.tile(u, (B, 1)) + rng.random((B, m))
    jd = jnp.dtype(dtype)
    jP = jsp.ell_from_scipy(P, jd, batch=B, sym_from_triu=True)
    jA = jsp.ell_from_scipy(A, jd, batch=B)
    jdata = JQP(P=jP, q=jnp.asarray(qs, jd), A=jA, l=jnp.asarray(ls, jd), u=jnp.asarray(us, jd))
    return jdata, convert.from_fields(QPData, jdata, "cpu", getattr(torch, dtype))


@pytest.mark.parametrize("iters", [1, 10])
def test_scale_data_ell_matches_reference(iters):
    jdata, data = _sparse_data()
    assert isinstance(data.P, ELLMatrix) and data.P.val.is_contiguous()
    jscaled, jscl = jscaling.scale_data(jdata, iters)
    scaled, scl = scaling.scale_data(data, iters)
    for f in ("c", "D", "E", "cinv", "Dinv", "Einv"):
        assert _rel(getattr(scl, f), getattr(jscl, f)) < 1e-12, f
    for f in ("q", "l", "u"):
        assert _rel(getattr(scaled, f), getattr(jscaled, f)) < 1e-12, f
    for M in ("P", "A"):
        for f in ("val", "t_val"):
            assert _rel(getattr(getattr(scaled, M), f), getattr(getattr(jscaled, M), f)) < 1e-12, (M, f)
        assert torch.equal(getattr(scaled, M).idx, getattr(data, M).idx)


def test_termination_products_on_ell_match_reference():
    """compute_products on ELL operands (K5, one launch per product),
    the certificate products included, against the JAX package's."""
    jdata, data = _sparse_data(seed=7)
    B, n = data.q.shape
    m = data.l.shape[1]
    rng = np.random.default_rng(8)
    x, z, y, dx, dy = (rng.standard_normal(s) for s in ((B, n), (B, m), (B, m), (B, n), (B, m)))
    J, T = jnp.asarray, torch.as_tensor
    jpr = jterm.compute_products(jdata, J(x), J(z), J(y))
    pr = termination.compute_products(data, T(x), T(z), T(y), T(dx), T(dy))
    for f in ("Ax", "Px", "Aty", "pri_vec", "dua_vec"):
        assert _rel(getattr(pr, f), getattr(jpr, f)) < 1e-12, f
    from osqp_tpu.linalg import mat_tvec as jmt, mat_vec as jmv

    for got, want in ((pr.Atdy, jmt(jdata.A, J(dy))), (pr.Pdx, jmv(jdata.P, J(dx))), (pr.Adx, jmv(jdata.A, J(dx)))):
        assert _rel(got, want) < 1e-12


# ---------------------------------------------------------------------------
# solve_sparse
# ---------------------------------------------------------------------------
def _assert_parity(rt, rj, dtype):
    np.testing.assert_array_equal(rt.status_val.numpy(), np.asarray(rj.status_val))
    if dtype == "float64":
        np.testing.assert_array_equal(rt.iter.numpy(), np.asarray(rj.iter))
        solved = np.asarray(rj.status_val) == jcon.OSQP_SOLVED
        for f in ("x", "y"):
            np.testing.assert_allclose(getattr(rt, f).numpy()[solved], np.asarray(getattr(rj, f))[solved], atol=ATOL)
    else:
        assert np.abs(rt.iter.numpy() - np.asarray(rj.iter)).max() <= CHECK


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_solve_sparse_matches_reference(dtype):
    P, q, A, l, u = _rand_sparse_qp(40, 60, 0.15, seed=0)
    kw = dict(dtype=dtype, verbose=False)
    rj = jsolve_sparse(P, q, A, l, u, **kw)
    rt = osqp_tpu_torch.solve_sparse(P, q, A, l, u, device="cpu", **kw)
    assert int(rt.status_val[0]) == jcon.OSQP_SOLVED
    _assert_parity(rt, rj, dtype)
    assert rt.x.dtype == getattr(torch, dtype) and rt.x.shape == (1, 40) and rt.y.shape == (1, 60)


def test_solve_sparse_scenario_batch_matches_reference():
    """B = 4 instances sharing P and A, with per-instance q."""
    P, q, A, l, u = _rand_sparse_qp(20, 30, 0.2, seed=2)
    B = 4
    qs = np.stack([q * (1 + 0.1 * i) for i in range(B)])
    kw = dict(dtype="float64", verbose=False)
    rj = jsolve_sparse(P, qs, A, np.tile(l, (B, 1)), np.tile(u, (B, 1)), **kw)
    rt = osqp_tpu_torch.solve_sparse(P, qs, A, np.tile(l, (B, 1)), np.tile(u, (B, 1)), device="cpu", **kw)
    assert (rt.status_val == jcon.OSQP_SOLVED).all()
    _assert_parity(rt, rj, "float64")
    np.testing.assert_allclose(rt.obj_val.numpy(), np.asarray(rj.obj_val), rtol=1e-6)


def test_solve_sparse_primal_infeasible_with_certificate():
    P, q, A, l, u = _rand_sparse_qp(15, 20, 0.3, seed=3)
    A2 = sp.vstack([A, A.getrow(-1)], format="csr")
    l2 = np.concatenate([l, [u[-1] + 1.0]])
    u2 = np.concatenate([u, [u[-1] + 2.0]])
    kw = dict(dtype="float64", verbose=False)
    rj = jsolve_sparse(P, q, A2, l2, u2, **kw)
    rt = osqp_tpu_torch.solve_sparse(P, q, A2, l2, u2, device="cpu", **kw)
    assert int(rt.status_val[0]) in (jcon.OSQP_PRIMAL_INFEASIBLE, jcon.OSQP_PRIMAL_INFEASIBLE_INACCURATE)
    np.testing.assert_array_equal(rt.status_val.numpy(), np.asarray(rj.status_val))
    np.testing.assert_array_equal(rt.iter.numpy(), np.asarray(rj.iter))
    cert = rt.prim_inf_cert[0].numpy()
    np.testing.assert_allclose(cert, np.asarray(rj.prim_inf_cert[0]), atol=ATOL)
    assert primal_infeasibility_check(A2, l2, u2, cert)["ok"]
    assert np.isnan(rt.x.numpy()).all()


def test_solve_sparse_warm_start_and_verbose_header(capsys):
    """x0 / y0 warm starts as the JAX package takes them; the verbose
    header counts nnz from the scipy inputs (P's upper triangle)."""
    P, q, A, l, u = _rand_sparse_qp(20, 30, 0.2, seed=9)
    kw = dict(dtype="float64")
    r0 = osqp_tpu_torch.solve_sparse(P, q, A, l, u, device="cpu", verbose=False, **kw)
    x0, y0 = r0.x.numpy()[0], r0.y.numpy()[0]
    rj = jsolve_sparse(P, q, A, l, u, x0=x0, y0=y0, verbose=False, **kw)
    rt = osqp_tpu_torch.solve_sparse(P, q, A, l, u, x0=x0, y0=y0, device="cpu", verbose=True, **kw)
    _assert_parity(rt, rj, "float64")
    out = capsys.readouterr().out
    nnz = sp.triu(P).nnz + A.nnz
    assert f"nnz(P) + nnz(A) = {nnz}" in out and "linear system solver = cg" in out


def test_solve_sparse_rejects_what_it_does_not_run():
    P, q, A, l, u = _rand_sparse_qp(10, 12, 0.3, seed=1)
    with pytest.raises(osqp_tpu_torch.OSQPError, match="only the matrix-free 'cg'"):
        osqp_tpu_torch.solve_sparse(P, q, A, l, u, device="cpu", linsys_solver="dense_inv", verbose=False)
    with pytest.raises(osqp_tpu_torch.OSQPError, match="inconsistent"):
        osqp_tpu_torch.solve_sparse(P, q, A, l[:-1], u[:-1], device="cpu", verbose=False)
    _, data = _sparse_data(n=6, m=8)
    with pytest.raises(osqp_tpu_torch.OSQPError, match="ELL"):
        osqp_tpu_torch.solve_batch(data.P, data.q, data.A, data.l, data.u, compact=True, verbose=False)


def test_solve_sparse_defaults_to_the_card():
    """No device given: the CUDA card, and without one a RuntimeError
    (nothing falls back to the CPU unasked)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    P, q, A, l, u = _rand_sparse_qp(10, 12, 0.3, seed=1)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        osqp_tpu_torch.solve_sparse(P, q, A, l, u, verbose=False)


# ---------------------------------------------------------------------------
# LISWET1 (n = 10002, m = 10000) against the JAX goldens that chip_smoke.py reads
# ---------------------------------------------------------------------------
def _goldens_tool():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools", "make_torch_goldens.py")
    spec = importlib.util.spec_from_file_location("make_torch_goldens", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_liswet1_matches_sparse_goldens(dtype):
    """The port's sparse path at a real size: LISWET1's status and
    iterations equal to the JAX package's; in float64 x and y within
    1e-8 of their largest entry."""
    from osqp_tpu_torch.io.qps import load_qps

    tool = _goldens_tool()
    g = np.load(tool.OUT_SPARSE)
    qp = load_qps(f"{tool.MAROS}/LISWET1.qps")
    r = osqp_tpu_torch.solve_sparse(qp.P, qp.q, qp.A, qp.l, qp.u, device="cpu", dtype=dtype, verbose=False)
    case = f"LISWET1/{dtype}"
    np.testing.assert_array_equal(r.status_val.numpy(), g[f"{case}/status_val"])
    np.testing.assert_array_equal(r.iter.numpy(), g[f"{case}/iter"])
    np.testing.assert_allclose(r.obj_val.numpy(), g[f"{case}/obj_val"], rtol=1e-6)
    if dtype == "float64":
        for f in ("x", "y"):
            want = g[f"{case}/{f}"]
            assert np.abs(getattr(r, f).numpy() - want).max() <= 1e-8 * np.abs(want).max(), f


def test_sparse_goldens_are_current():
    """The stored JAX solve_sparse results: one entry regenerated by the
    tool equals the file's."""
    tool = _goldens_tool()
    g = np.load(tool.OUT_SPARSE)
    assert sorted(g.files) == sorted(f"{c}/{f}" for c in tool.SPARSE_CASES for f in tool.SPARSE_FIELDS)
    fresh = tool.sparse_golden("LISWET1/float32")
    for f in ("status_val", "iter"):
        np.testing.assert_array_equal(fresh[f], g[f"LISWET1/float32/{f}"])
    for f in ("obj_val", "x", "y"):
        np.testing.assert_allclose(fresh[f], g[f"LISWET1/float32/{f}"], rtol=1e-6, atol=1e-6)
