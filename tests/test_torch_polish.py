"""osqp_tpu_torch.polish against osqp_tpu.polish on the CPU.

Both start from the same ADMM point: the JAX package scales, factors and
solves, and its scaled data, scaling and final iterates are carried
across with osqp_tpu_torch.convert.  Sizes stay at N = n + m <= 2048,
where the JAX package takes its LU branch, the one the port carries.
On CPU tensors K8's wrappers run their plain versions.  In float64:
``success`` equal, x, z, y within 1e-6, the residuals within 1e-6
relative or 1e-12 absolute.  Then the Solver with polish on, against the
JAX Solver and the stored goldens.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import osqp_tpu
import osqp_tpu.constants as jcon
import osqp_tpu_torch
from osqp_tpu import admm as jadmm
from osqp_tpu import batch as jbatch
from osqp_tpu import solver as jsolver
from osqp_tpu.polish import polish as jpolish
from osqp_tpu.types import DynSettings as JDyn
from osqp_tpu_torch import convert
from osqp_tpu_torch import solver as tsolver
from osqp_tpu_torch.io.qps import load_qps
from osqp_tpu_torch.ops import kkt_lu as k8
from osqp_tpu_torch.polish import polish as tpolish
from osqp_tpu_torch.types import DynSettings, QPData, ScalingData
from test_batch import random_qps

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-6


def _admm_point(P, q, A, l, u, dtype, **settings):
    """The JAX package's solve of a batch: (cfg, scaled data, scaling, dyn,
    result) with everything still scaled."""
    jd = jnp.dtype(dtype)
    B, n = q.shape
    m = l.shape[1]
    s = jsolver.Settings(dtype=dtype, verbose=False, **settings)
    cfg = jsolver.make_config(n, m, s, jd)
    dyn = JDyn.make(jd)
    arrays = [jnp.asarray(v, jd) for v in (P, q, A, l, u)]
    scaled, scl, rs, factor, it = jbatch._prepare(
        cfg, int(s.scaling), *arrays, jnp.full((B,), s.rho, jd), dyn, None, None
    )
    return cfg, scaled, scl, dyn, jadmm.solve_core(cfg, scaled, scl, dyn, rs, factor, it)


def _polish_both(point, dtype, refine_iter=3, passes=None, polish_dtype=None):
    jcfg, jdata, jscl, jdyn, res = point
    td = getattr(torch, dtype)
    s = tsolver.Settings(dtype=dtype, polish_dtype=polish_dtype)
    tcfg = tsolver.make_config(jcfg.n, jcfg.m, s, td)
    if polish_dtype is not None:
        import dataclasses

        jcfg = dataclasses.replace(jcfg, polish_dtype=polish_dtype)
    it, info = res.iterates, res.info
    pj = jpolish(jcfg, jdata, jscl, jdyn, it.x, it.z, it.y, info.pri_res, info.dua_res, refine_iter, passes)
    t = lambda a: convert.to_tensor(a, "cpu", td)
    pt = tpolish(
        tcfg,
        convert.from_fields(QPData, jdata, "cpu", td),
        convert.from_fields(ScalingData, jscl, "cpu", td),
        convert.from_fields(DynSettings, jdyn, "cpu", td),
        t(it.x), t(it.z), t(it.y), t(info.pri_res), t(info.dua_res), refine_iter, passes,
    )
    return pj, pt


def _assert_polish_parity(pj, pt, atol=ATOL):
    np.testing.assert_array_equal(pt.success.numpy(), np.asarray(pj.success))
    for f in ("x", "z", "y"):
        np.testing.assert_allclose(getattr(pt, f).numpy(), np.asarray(getattr(pj, f)), rtol=0, atol=atol)
    for f in ("pri_res", "dua_res"):
        np.testing.assert_allclose(getattr(pt, f).numpy(), np.asarray(getattr(pj, f)), rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(pt.obj_val.numpy(), np.asarray(pj.obj_val), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("refine_iter", [0, 3])
@pytest.mark.parametrize("passes", [1, 4])
def test_polish_matches_reference(passes, refine_iter):
    point = _admm_point(*random_qps(6, 10, 15, seed=21), "float64")
    pj, pt = _polish_both(point, "float64", refine_iter, passes)
    _assert_polish_parity(pj, pt)
    assert pt.success.all()
    # without refinement the regularized solve leaves residuals of order delta
    tight = 1e-9 if refine_iter else 1e-4
    assert float(pt.pri_res.max()) < tight and float(pt.dua_res.max()) < tight


def test_polish_default_passes_come_from_the_config():
    point = _admm_point(*random_qps(3, 8, 12, seed=11), "float64", polish_passes=2)
    pj, pt = _polish_both(point, "float64")
    _assert_polish_parity(pj, pt)


def _dependent_rows(seed=4):
    """Instance 0 has two copies of one equality row: both are guessed
    active, the unregularized masked KKT is singular, and refinement
    against it cannot be trusted.  Keep-best must hold the regularized
    step."""
    P, q, A, l, u = random_qps(3, 8, 12, seed=seed)
    A[0, 1] = A[0, 0]
    u[0, 0] = l[0, 0]
    l[0, 1], u[0, 1] = l[0, 0], u[0, 0]
    return P, q, A, l, u


def test_polish_keeps_best_on_dependent_active_rows():
    point = _admm_point(*_dependent_rows(), "float64")
    pj, pt = _polish_both(point, "float64")
    np.testing.assert_array_equal(pt.success.numpy(), np.asarray(pj.success))
    assert torch.isfinite(pt.x).all() and torch.isfinite(pt.y).all()
    # x is determined; the duals of the two copies only through the
    # regularization, at a condition number of ~1/delta^2: x and z to
    # 1e-6, the residuals to their own size
    for f in ("x", "z"):
        np.testing.assert_allclose(getattr(pt, f).numpy(), np.asarray(getattr(pj, f)), rtol=0, atol=ATOL)
    np.testing.assert_allclose(pt.y[1:].numpy(), np.asarray(pj.y)[1:], rtol=0, atol=ATOL)
    admm = point[4].info
    ok = pt.success.numpy()
    assert (pt.pri_res.numpy()[ok] < np.asarray(admm.pri_res)[ok]).all()
    assert (pt.dua_res.numpy()[ok] < np.asarray(admm.dua_res)[ok]).all()
    # no refinement step may have made the kept point worse than step 0
    _, p0 = _polish_both(point, "float64", refine_iter=0)
    worst = lambda p: torch.maximum(p.pri_res, p.dua_res)
    assert (worst(pt) <= worst(p0)).all()


def test_polish_float64_over_a_float32_solve():
    point = _admm_point(*random_qps(4, 8, 12, seed=13), "float32")
    pj, pt = _polish_both(point, "float32", polish_dtype="float64")
    assert pt.x.dtype == torch.float32 and pt.pri_res.dtype == torch.float32
    np.testing.assert_array_equal(pt.success.numpy(), np.asarray(pj.success))
    assert pt.success.all()
    # polished in float64 from the same float32 point, rounded back to float32
    for f in ("x", "z", "y"):
        np.testing.assert_allclose(getattr(pt, f).numpy(), np.asarray(getattr(pj, f)), rtol=0, atol=1e-5)
    # residuals far below what a float32 polish reaches
    _, p32 = _polish_both(point, "float32")
    assert float(pt.dua_res.max()) < 0.1 * float(p32.dua_res.max())


def test_polish_float32_matches_reference():
    point = _admm_point(*random_qps(4, 8, 12, seed=13), "float32")
    pj, pt = _polish_both(point, "float32")
    np.testing.assert_array_equal(pt.success.numpy(), np.asarray(pj.success))
    for f in ("x", "z", "y"):
        np.testing.assert_allclose(getattr(pt, f).numpy(), np.asarray(getattr(pj, f)), rtol=0, atol=1e-3)


def test_polish_singular_masked_kkt_fails_without_raising():
    """A NaN in an instance's P makes its every pass non-finite: its
    success is False and its ADMM point comes back, the others polish."""
    P, q, A, l, u = random_qps(2, 5, 7, seed=3)
    point = _admm_point(P, q, A, l, u, "float64")
    jcfg, jdata, jscl, jdyn, res = point
    td = torch.float64
    data = convert.from_fields(QPData, jdata, "cpu", td)
    bad = QPData(P=data.P.clone(), q=data.q, A=data.A, l=data.l, u=data.u)
    bad.P[0] = 0.0
    bad.P[0, 0, :] = float("nan")
    it, info = res.iterates, res.info
    t = lambda a: convert.to_tensor(a, "cpu", td)
    cfg = tsolver.make_config(jcfg.n, jcfg.m, tsolver.Settings(dtype="float64"), td)
    pt = tpolish(cfg, bad, convert.from_fields(ScalingData, jscl, "cpu", td),
                 convert.from_fields(DynSettings, jdyn, "cpu", td),
                 t(it.x), t(it.z), t(it.y), t(info.pri_res), t(info.dua_res), 3)
    assert not bool(pt.success[0]) and bool(pt.success[1])
    torch.testing.assert_close(pt.x[0], t(it.x)[0], rtol=0, atol=0)


def test_polish_launches_no_library_lu(monkeypatch):
    """Neither path may reach a library LU, solve or inverse."""
    def refuse(*a, **k):
        raise AssertionError("library LU called")

    for name in ("lu_factor", "lu_factor_ex", "lu_solve", "solve", "inv", "lu"):
        monkeypatch.setattr(torch.linalg, name, refuse)
    P, q, A, l, u = random_qps(3, 6, 9, seed=2)
    for backend in ("dense_inv", "kkt_lu"):
        r = osqp_tpu_torch.solve_batch(P, q, A, l, u, device="cpu", dtype="float64", polish=True,
                                       linsys_solver=backend, verbose=False)
        assert (r.status_polish == 1).all()


# --- the Solver with polish on -------------------------------------------
def _basic_qp():
    """tests/test_basic_qp.py's problem and golden solution."""
    import scipy.sparse as sp

    P = sp.triu([[4.0, 1.0], [1.0, 2.0]], format="csc")
    A = sp.csc_matrix(np.array([[1.0, 1.0], [1.0, 0.0], [0.0, 1.0], [0.0, 1.0]]))
    return P, np.ones(2), A, np.array([1.0, 0.0, 0.0, -np.inf]), np.array([1.0, 0.7, 0.7, np.inf])


BASIC = dict(max_iter=2000, alpha=1.6, polish=True, scaling=0, verbose=False, warm_start=False)


def _assert_solver_parity(rj, rt, dtype):
    assert rt.info.status_val == rj.info.status_val
    assert rt.info.status_polish == rj.info.status_polish
    if dtype == "float64":
        assert rt.info.iter == rj.info.iter
        np.testing.assert_allclose(rt.x, rj.x, rtol=0, atol=ATOL)
        np.testing.assert_allclose(rt.y, rj.y, rtol=0, atol=ATOL)
        np.testing.assert_allclose(rt.info.obj_val, rj.info.obj_val, rtol=1e-9)
        np.testing.assert_allclose(rt.info.pri_res, rj.info.pri_res, rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(rt.info.dua_res, rj.info.dua_res, rtol=1e-6, atol=1e-12)
    else:
        assert abs(rt.info.iter - rj.info.iter) <= 25


@pytest.mark.parametrize("scaling", [0, 10])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_solver_polish_basic_qp(dtype, scaling):
    """The counterpart of test_basic_qp.py's test_solve and
    test_solve_with_scaling."""
    kw = dict(BASIC, scaling=scaling, dtype=dtype)
    rj = osqp_tpu.Solver(*_basic_qp(), **kw).solve()
    ts = osqp_tpu_torch.Solver(*_basic_qp(), device="cpu", **kw)
    rt = ts.solve()
    _assert_solver_parity(rj, rt, dtype)
    assert rt.info.status_polish == 1 and rt.info.polish_time > 0
    tol = 1e-4 if dtype == "float64" else 5e-3
    np.testing.assert_allclose(rt.x, [0.3, 0.7], atol=tol)
    np.testing.assert_allclose(rt.y, [-2.9, 0.0, 0.2, 0.0], atol=tol)
    assert abs(rt.info.obj_val - 1.88) < tol
    assert rt.info.run_time == pytest.approx(rt.info.setup_time + rt.info.solve_time + rt.info.polish_time)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_solver_polish_cvxqp2_s(dtype):
    qp = load_qps(os.path.join(REPO, "tests", "data", "maros_mm", "CVXQP2_S.qps"))
    args = (qp.P, qp.q, qp.A, qp.l, qp.u)
    rj = osqp_tpu.Solver(*args, dtype=dtype, polish=True, verbose=False).solve()
    rt = osqp_tpu_torch.Solver(*args, device="cpu", dtype=dtype, polish=True, verbose=False).solve()
    _assert_solver_parity(rj, rt, dtype)
    assert rt.info.status_val == jcon.OSQP_SOLVED


def test_solver_polish_writes_back_for_warm_start():
    """A successful polish leaves the polished iterates as the next
    solve's warm start (polish.c:323-327), in both packages."""
    kw = dict(BASIC, warm_start=True, dtype="float64")
    js = osqp_tpu.Solver(*_basic_qp(), **kw)
    ts = osqp_tpu_torch.Solver(*_basic_qp(), device="cpu", **kw)
    for _ in range(2):
        rj, rt = js.solve(), ts.solve()
        _assert_solver_parity(rj, rt, "float64")
    np.testing.assert_allclose(ts.iterates.x[0].numpy(), np.asarray(js.iterates.x[0]), rtol=0, atol=ATOL)


def test_update_polish_turns_polish_on_and_off():
    ts = osqp_tpu_torch.Solver(*_basic_qp(), device="cpu", **dict(BASIC, polish=False))
    assert ts.solve().info.status_polish == 0
    ts.update_polish(True)
    r = ts.solve()
    assert r.info.status_polish == 1 and ts.settings.polish is True
    ts.update_polish(0)
    assert ts.solve().info.status_polish == 0
    with pytest.raises(osqp_tpu_torch.OSQPError):
        ts.update_polish(2)


def test_polish_is_skipped_unless_solved():
    """max_iter too small to converge: polish does not run (osqp.c:604)."""
    before = k8.launches_factor
    ts = osqp_tpu_torch.Solver(*_basic_qp(), device="cpu", **dict(BASIC, max_iter=5, check_termination=1))
    r = ts.solve()
    assert r.info.status_val != jcon.OSQP_SOLVED and r.info.status_polish == 0 and r.info.polish_time == 0.0
    assert k8.launches_factor == before  # CPU tensors never count a launch


def test_verbose_footer_prints_the_polish_lines(capsys):
    js = osqp_tpu.Solver(*_basic_qp(), **dict(BASIC, verbose=True, dtype="float64"))
    js.solve()
    jout = capsys.readouterr().out
    ts = osqp_tpu_torch.Solver(*_basic_qp(), device="cpu", **dict(BASIC, verbose=True, dtype="float64"))
    ts.solve()
    tout = capsys.readouterr().out
    pick = lambda out: [ln.split()[0] for ln in out.splitlines() if ln.startswith(("plsh", "solution polish"))]
    assert pick(tout) == pick(jout) == ["plsh", "solution"]
    assert "solution polish:      successful" in tout


def _goldens_tool():
    path = os.path.join(REPO, "tools", "make_torch_goldens.py")
    spec = importlib.util.spec_from_file_location("make_torch_goldens", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_polish_goldens_are_current():
    """The stored JAX results with polish on: one entry regenerated by the
    tool equals the file's."""
    tool = _goldens_tool()
    g = np.load(tool.OUT_POLISH)
    assert sorted(g.files) == sorted(
        [f"{p}/{d}/{f}" for p in tool.PROBLEMS for d in tool.DTYPES for f in tool.POLISH_FIELDS]
        + [f"{p}/reference/{f}" for p in tool.PROBLEMS for f in tool.REFERENCE_FIELDS])
    fresh = tool.golden("CVXQP2_S", "float64", polish=True)
    for f in ("status_val", "iter", "rho_updates", "status_polish"):
        assert int(fresh[f]) == int(g[f"CVXQP2_S/float64/{f}"])
    np.testing.assert_allclose(fresh["obj_val"], g["CVXQP2_S/float64/obj_val"], rtol=1e-9)
    for f in ("x", "y"):
        np.testing.assert_allclose(fresh[f], g[f"CVXQP2_S/float64/{f}"], rtol=0, atol=ATOL)
    # the polished point is the optimum of the solve at eps 1e-10
    np.testing.assert_allclose(g["CVXQP2_S/reference/obj_val"], g["CVXQP2_S/float64/obj_val"], rtol=1e-9)
    np.testing.assert_allclose(g["CVXQP2_S/reference/x"], g["CVXQP2_S/float64/x"], rtol=0, atol=1e-8)


def test_polish_cvxqp2_m_matches_the_reference_lu_branch(monkeypatch):
    """KKT dimension 2250: the JAX package would take its Schur route at
    delta 1e-4.  With its switch raised for this call its LU branch at
    delta 1e-6 runs, the branch the port carries at every size, and from
    the JAX package's ADMM point both give the same first pass."""
    import osqp_tpu.polish as jpolish_mod

    monkeypatch.setattr(jpolish_mod, "_SCHUR_KKT_DIM", 1 << 30)
    qp = load_qps(os.path.join(REPO, "tests", "data", "maros_mm", "CVXQP2_M.qps"))
    js = osqp_tpu.Solver(qp.P, qp.q, qp.A, qp.l, qp.u, dtype="float64", polish=False, verbose=False)
    rj = js.solve()
    it = js.iterates
    pri, dua = np.array([rj.info.pri_res]), np.array([rj.info.dua_res])
    pj = jpolish(js._cfg, js.data, js.scaling, js._dyn, it.x, it.z, it.y, jnp.asarray(pri), jnp.asarray(dua), 1, 1)
    td = torch.float64
    t = lambda a: convert.to_tensor(a, "cpu", td)
    pt = tpolish(
        tsolver.make_config(js._cfg.n, js._cfg.m, tsolver.Settings(dtype="float64"), td),
        convert.from_fields(QPData, js.data, "cpu", td),
        convert.from_fields(ScalingData, js.scaling, "cpu", td),
        convert.from_fields(DynSettings, js._dyn, "cpu", td),
        t(it.x), t(it.z), t(it.y), t(pri), t(dua), 1, 1,
    )
    np.testing.assert_array_equal(pt.success.numpy(), np.asarray(pj.success))
    # the guessed active rows are dependent here (K_delta's condition
    # number is ~1/delta^2), so the two LUs agree to a few digits less
    # than at the small sizes
    for f in ("pri_res", "dua_res"):
        np.testing.assert_allclose(getattr(pt, f).numpy(), np.asarray(getattr(pj, f)), rtol=1e-6)
    np.testing.assert_allclose(pt.x.numpy(), np.asarray(pj.x), rtol=0, atol=1e-6 * float(pt.x.abs().max()))
