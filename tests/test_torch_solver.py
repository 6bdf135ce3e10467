"""osqp_tpu_torch.Solver against osqp_tpu.Solver on the CPU.

The same problems go through both packages' stateful solvers (the
port's kernel wrappers then run their plain versions).  The rule is
ROADMAP's: in float64 the same status and iteration count, x and y
within 1e-6; in float32 the same status and iterations within one check
interval (25).  Problems: the README quick start, the HS fixtures,
CVXQP2_S, the infeasible problems of test_infeasibility.py, and update
sequences; plus the verbose layout, time_limit, Ctrl-C, the time-based
rho rule, the dense backends, export, and the JAX
goldens that chip_smoke.py reads.
"""

import importlib.util
import os
import re

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from numpy.random import PCG64, Generator

import osqp_tpu
import osqp_tpu.constants as jcon
import osqp_tpu_torch
from osqp_tpu_torch import admm as tadmm
from osqp_tpu_torch import convert
from osqp_tpu_torch.io.qps import load_qps

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
ATOL = 1e-6
CHECK = 25


def _quick_start():
    """README.md's quick start: x* = [0.3, 0.7]."""
    P = sp.csc_matrix([[4.0, 1.0], [1.0, 2.0]])
    A = sp.csc_matrix([[1.0, 1.0], [1.0, 0.0], [0.0, 1.0]])
    return P, np.array([1.0, 1.0]), A, np.array([1.0, 0.0, 0.0]), np.array([1.0, 0.7, 0.7])


def _qps(path):
    qp = load_qps(path)
    return qp.P, qp.q, qp.A, qp.l, qp.u


def _problem(name):
    if name == "quick_start":
        return _quick_start()
    if name.startswith("CVXQP"):
        return _qps(os.path.join(DATA, "maros_mm", f"{name}.qps"))
    return _qps(os.path.join(DATA, f"{name}.qps"))


def _assert_parity(rj, rt, dtype, cert_atol=ATOL):
    assert rt.info.status_val == rj.info.status_val, (rt.info.status, rj.info.status)
    assert rt.info.status == rj.info.status
    if dtype == "float64":
        assert rt.info.iter == rj.info.iter
        assert rt.info.rho_updates == rj.info.rho_updates
        np.testing.assert_allclose(rt.x, rj.x, rtol=0, atol=ATOL, equal_nan=True)
        np.testing.assert_allclose(rt.y, rj.y, rtol=0, atol=ATOL, equal_nan=True)
        if np.isfinite(rj.info.obj_val):
            np.testing.assert_allclose(rt.info.obj_val, rj.info.obj_val, rtol=1e-6)
    else:
        assert abs(rt.info.iter - rj.info.iter) <= CHECK, (rt.info.iter, rj.info.iter)
    for f in ("prim_inf_cert", "dual_inf_cert"):
        cj, ct = getattr(rj, f), getattr(rt, f)
        assert (cj is None) == (ct is None), f
        if cj is not None:
            np.testing.assert_allclose(ct, cj, rtol=0, atol=cert_atol)


def _both(P, q, A, l, u, **kw):
    kw = {"verbose": False, **kw}
    return osqp_tpu.Solver(P, q, A, l, u, **kw), osqp_tpu_torch.Solver(P, q, A, l, u, device="cpu", **kw)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", ["quick_start", "HS21", "HS35", "HS51", "HS76", "CVXQP2_S"])
def test_solve_matches_reference(name, dtype):
    js, ts = _both(*_problem(name), dtype=dtype)
    rj, rt = js.solve(), ts.solve()
    _assert_parity(rj, rt, dtype)
    assert rt.info.status_val == osqp_tpu_torch.OSQP_SOLVED
    assert rt.x.dtype == np.float64 and rt.x.shape == (ts.n,) and rt.y.shape == (ts.m,)
    if name == "quick_start":
        np.testing.assert_allclose(rt.x, [0.3, 0.7], atol=1e-2)
    assert rt.info.run_time == pytest.approx(rt.info.setup_time + rt.info.solve_time)


@pytest.mark.parametrize(
    "kw",
    [{"unconstrained": True}, {"scaling": 0}, {"scaled_termination": True}, {"adaptive_rho": False},
     {"warm_start": False}, {"check_termination": 0, "max_iter": 60}],
    ids=["unconstrained", "no_scaling", "scaled_termination", "fixed_rho", "cold_start", "no_checks"],
)
def test_settings_match_reference(kw):
    P, q, A, l, u = _quick_start()
    kw = dict(kw)
    if kw.pop("unconstrained", False):
        A = l = u = None
    js, ts = _both(P, q, A, l, u, dtype="float64", **kw)
    for _ in range(2):  # the second solve warm-starts unless warm_start is off
        _assert_parity(js.solve(), ts.solve(), "float64")


def _primal_infeasible_qp():
    """test_infeasibility.test_primal_infeasible_qp's problem."""
    rg = Generator(PCG64(2))
    n, m = 50, 150
    Pt = sp.random(n, n, random_state=rg)
    P = (Pt.T @ Pt + sp.eye(n)).tocsc()
    q = rg.standard_normal(n)
    A = sp.random(m, n, random_state=rg).tolil()
    u = 3 + rg.standard_normal(m)
    l = -3 + rg.standard_normal(m)
    A[n // 2, :] = A[n // 2 + 1, :]
    l[n // 2] = u[n // 2 + 1] + 10 * rg.random()
    u[n // 2] = l[n // 2] + 0.5
    return sp.triu(P, format="csc"), q, A.tocsc(), l, u


_PD_P = sp.diags([1.0, 0.0], format="csc")
_PD_Q = np.array([1.0, -1.0])
_PD_A12 = sp.csc_matrix([[1.0, 1.0], [1.0, 0.0], [0.0, 1.0]])
_PD_A34 = sp.csc_matrix([[1.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
_PD_L = np.array([0.0, 1.0, 1.0])


@pytest.mark.nanok
@pytest.mark.parametrize(
    "case,status",
    [
        ("random_primal_infeasible", jcon.OSQP_PRIMAL_INFEASIBLE),
        ("primal_infeasible", jcon.OSQP_PRIMAL_INFEASIBLE),
        ("dual_infeasible", jcon.OSQP_DUAL_INFEASIBLE),
        ("primal_and_dual_infeasible", jcon.OSQP_PRIMAL_INFEASIBLE),
    ],
)
def test_infeasible_problems_and_certificates(case, status):
    """The problems of test_infeasibility.py, polish off; certificates
    within 1e-6."""
    problem = {
        "random_primal_infeasible": _primal_infeasible_qp,
        "primal_infeasible": lambda: (_PD_P, _PD_Q, _PD_A12, _PD_L, np.array([0.0, 3.0, 3.0])),
        "dual_infeasible": lambda: (_PD_P, _PD_Q, _PD_A34, _PD_L, np.array([2.0, 3.0, np.inf])),
        "primal_and_dual_infeasible": lambda: (_PD_P, _PD_Q, _PD_A34, _PD_L, np.array([0.0, 3.0, np.inf])),
    }[case]()
    js, ts = _both(*problem, dtype="float64")
    rj, rt = js.solve(), ts.solve()
    _assert_parity(rj, rt, "float64")
    assert rt.info.status_val == status
    assert np.isnan(rt.x).all()
    cert = rt.prim_inf_cert if status == jcon.OSQP_PRIMAL_INFEASIBLE else rt.dual_inf_cert
    assert np.max(np.abs(cert)) == 1.0
    # the next solve starts cold, as the reference's does
    assert not ts.iterates.x.any()


def _update_problem():
    """test_update_matrices.py's generator (seeded PCG64(2))."""
    rg = Generator(PCG64(2))
    n, m, p = 5, 8, 0.7
    A = sp.random(m, n, density=p, format="csc", random_state=rg)
    P0 = sp.random(n, n, density=p, random_state=rg)
    Pu = sp.triu((P0 @ P0.T).tocsc() + sp.eye(n, format="csc"), format="csc")
    q = rg.standard_normal(n)
    l = -30 + rg.standard_normal(m)
    u = 30 + rg.standard_normal(m)
    return Pu, q, A, l, u


def _steps(Pu, A, n, m):
    rng = np.random.default_rng(11)
    return [
        ("update_lin_cost", (rng.standard_normal(n),), {}),
        ("update_bounds", (), {"l": -1.0 - rng.random(m), "u": 1.0 + rng.random(m)}),
        ("update_lower_bound", (-2.0 * np.ones(m),), {}),
        ("update_P", (), {"Px": Pu.data[[0, 2]] * 1.5, "Px_idx": np.array([0, 2])}),
        ("update_A", (), {"Ax": A.data[[1, 3, 4]] * 0.5, "Ax_idx": np.array([1, 3, 4])}),
        ("update_P_A", (), {"Px": Pu.data * 1.1, "Ax": A.data * 0.9}),
        ("update_rho", (0.7,), {}),
        ("warm_start", (), {"x": rng.standard_normal(n), "y": rng.standard_normal(m)}),
        ("update", (), {"q": rng.standard_normal(n), "u": 3.0 + rng.random(m)}),
        ("update_alpha", (1.4,), {}),
        ("update_check_termination", (10,), {}),
        ("update_eps_abs", (1e-5,), {}),
        ("update_warm_start", (False,), {}),
    ]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_update_sequence_matches_reference(dtype):
    """Solve after every update of a sequence; in float32 the port's
    state is carried across from the JAX solver before each update, so
    that each solve starts from the same iterates."""
    Pu, q, A, l, u = _update_problem()
    js, ts = _both(Pu, q, A, l, u, dtype=dtype, eps_abs=1e-5, eps_rel=1e-5)
    _assert_parity(js.solve(), ts.solve(), dtype)
    for name, args, kw in _steps(Pu.copy(), A.copy(), 5, 8):
        if dtype == "float32":
            convert.load_solver_state(ts, js)
        getattr(js, name)(*args, **kw)
        getattr(ts, name)(*args, **kw)
        assert (ts.info.status_val, ts.settings) == (js.info.status_val, ts.settings.__class__(**vars(js.settings)))
        _assert_parity(js.solve(), ts.solve(), dtype)
        assert ts.info.run_time == pytest.approx(ts.info.update_time + ts.info.solve_time)


def test_update_rejects_bad_input():
    Pu, q, A, l, u = _update_problem()
    s = osqp_tpu_torch.Solver(Pu, q, A, l, u, device="cpu", verbose=False, dtype="float64")
    with pytest.raises(osqp_tpu_torch.OSQPError):
        s.update_P(Px=np.ones(Pu.nnz + 1))
    with pytest.raises(osqp_tpu_torch.OSQPError):
        s.update_A(Ax=np.ones(2), Ax_idx=np.array([0, A.nnz]))
    with pytest.raises(osqp_tpu_torch.OSQPError):
        s.update_bounds(l=np.ones(8), u=np.zeros(8))
    with pytest.raises(osqp_tpu_torch.OSQPError):
        s.update(qq=np.ones(5))
    with pytest.raises(osqp_tpu_torch.OSQPError):
        s.update_rho(-1.0)
    with pytest.raises(osqp_tpu_torch.OSQPError):
        s.update_alpha(2.0)
    with pytest.raises(osqp_tpu_torch.OSQPError):
        osqp_tpu_torch.Solver(Pu, q, A, l, u, device="cpu", nope=1)
    with pytest.raises(osqp_tpu_torch.OSQPError):
        osqp_tpu_torch.Solver().solve()


def test_non_convex_rejected():
    P = np.array([[1.0, 0.0], [0.0, -1.0]])
    with pytest.raises(osqp_tpu_torch.constants.NonConvexError):
        osqp_tpu_torch.Solver(P, np.zeros(2), np.eye(2), -np.ones(2), np.ones(2), device="cpu", verbose=False,
                              dtype="float64")


def test_verbose_layout_matches_reference(capsys):
    """Header, rows (without the time column) and footer print as the JAX
    package's do; only the title line names the port."""
    P, q, A, l, u = _problem("CVXQP2_S")
    kw = dict(verbose=True, dtype="float64", max_iter=450, eps_abs=1e-6, eps_rel=1e-6)
    osqp_tpu.Solver(P, q, A, l, u, **kw).solve()
    out_j = capsys.readouterr().out
    osqp_tpu_torch.Solver(P, q, A, l, u, device="cpu", **kw).solve()
    out_t = capsys.readouterr().out

    def parts(out):
        lines = out.splitlines()
        head = lines[lines.index(next(x for x in lines if x.startswith("problem:"))):]
        head = head[: head.index("")]
        rows = [x.rsplit(None, 1)[0] for x in lines if re.match(r"^\s*\d+\s", x)]
        # the rho estimate's third digit follows rounding in the dual residual
        keep = ("status:", "number of iterations:", "optimal objective:")
        foot = [x for x in lines if x.startswith(keep)]
        return head, rows, foot

    assert parts(out_t) == parts(out_j)
    assert parts(out_t)[1]  # a row at the first segment boundary
    assert f"OSQP-TPU-TORCH v{osqp_tpu_torch.__version__}" in out_t
    assert "run time:" in out_t and "optimal rho estimate:" in out_t


def _unreachable(**kw):
    P, q, A, l, u = _quick_start()
    kw = {"verbose": False, "eps_abs": 0.0, "eps_rel": 1e-18, "max_iter": 4000, "dtype": "float64", **kw}
    return _both(P, q, A, l, u, **kw)


def test_time_limit():
    js, ts = _unreachable(time_limit=1e-9, check_termination=0, max_iter=100000)
    rj, rt = js.solve(), ts.solve()
    assert rt.info.status_val == rj.info.status_val == jcon.OSQP_TIME_LIMIT_REACHED
    assert rt.info.status == "run time limit reached"
    # one segment of max(4 x 25, 100) iterations, then the clock is read
    assert rt.info.iter == rj.info.iter == 100


def test_sigint_between_segments(monkeypatch, capsys):
    """Ctrl-C during the segmented solve gives OSQP_SIGINT with no further
    checks (osqp.c:377-385); the solver stays usable."""
    _, ts = _unreachable(time_limit=1e6)
    real = tadmm.run_segment
    calls = {"n": 0}

    def interrupting(*args, **kw):
        calls["n"] += 1
        if calls["n"] >= 2:
            raise KeyboardInterrupt
        return real(*args, **kw)

    monkeypatch.setattr(tadmm, "run_segment", interrupting)
    res = ts.solve()
    assert res.info.status_val == jcon.OSQP_SIGINT and res.info.status == "interrupted"
    assert res.info.iter == 100
    assert "Solver interrupted" in capsys.readouterr().out
    monkeypatch.setattr(tadmm, "run_segment", real)
    ts.update_eps_abs(1e-3)
    ts.update_eps_rel(1e-3)
    assert ts.solve().info.status_val == jcon.OSQP_SOLVED


@pytest.mark.parametrize("fraction,fires", [(1e-9, True), (1e9, False)])
def test_time_based_rho_interval(fraction, fires, monkeypatch):
    """adaptive_rho_interval=0 with adaptive_rho_time: the interval is set
    from wall time between segments.  A fraction of 1e-9 sets it at the
    first segment boundary (to 25), 1e9 never; both packages then run the
    same iterations."""
    adapted = []
    real = tadmm._apply_rho_adaptation
    monkeypatch.setattr(tadmm, "_apply_rho_adaptation", lambda *a: adapted.append(a[-1].k) or real(*a))
    rng = np.random.default_rng(5)
    n, m = 40, 60
    M = rng.normal(size=(n, n))
    P = M @ M.T + 1e-2 * np.eye(n)
    A = rng.normal(size=(m, n)) * 100.0
    u = rng.uniform(1.0, 2.0, m) * 100.0
    kw = dict(adaptive_rho_time=True, adaptive_rho_interval=0, adaptive_rho_fraction=fraction, dtype="float64")
    js, ts = _both(P, rng.normal(size=n) * 1e3, A, -u, u, **kw)
    rj, rt = js.solve(), ts.solve()
    _assert_parity(rj, rt, "float64")
    assert bool(adapted) == fires
    assert ts._cfg.adaptive_rho_interval == 0


@pytest.mark.parametrize("sparse", [False, True], ids=["export", "sparse_export"])
def test_formerly_unported_export_runs(sparse):
    """Solver.export and SparseSolver.export (item 14), which raised until
    they were ported, write artifacts whose loaded callables give the JAX
    package's artifacts' results on the quick start."""
    from osqp_tpu import export as jexport
    from osqp_tpu_torch import export as texport

    P, q, A, l, u = _quick_start()
    kw = dict(dtype="float64", verbose=False, polish=True)
    if sparse:
        ts = osqp_tpu_torch.SparseSolver(P, q, A, l, u, device="cpu", **kw)
        js = osqp_tpu.SparseSolver(P, q, A, l, u, **kw)
        inputs = (sp.triu(P, format="csc").data, q[None], A.data, l[None], u[None])
        rt = texport.load_sparse_solver(ts.export(), device="cpu")(*inputs)
        rj = jexport.load_sparse_solver(js.export())(*inputs)
    else:
        js, ts = _both(P, q, A, l, u, **kw)
        inputs = (P.toarray()[None], q[None], A.toarray()[None], l[None], u[None])
        rt = texport.load_solver(ts.export(), device="cpu")(*inputs)
        rj = jexport.load_solver(js.export())(*inputs)
    for f in ("status_val", "iter", "status_polish"):
        assert rt[f].tolist() == np.asarray(rj[f]).tolist(), f
    assert rt["status_val"].tolist() == [osqp_tpu_torch.OSQP_SOLVED]
    for f in ("x", "y"):
        np.testing.assert_allclose(rt[f].numpy(), np.asarray(rj[f]), rtol=0, atol=ATOL, err_msg=f)


@pytest.mark.parametrize(
    "make",
    [
        lambda s: osqp_tpu_torch.Solver(*_quick_start(), device="cpu", dtype="float64", polish=True, verbose=False),
        lambda s: s.update_polish(True) or s,
        lambda s: osqp_tpu_torch.Solver(*_quick_start(), device="cpu", dtype="float64", linsys_solver="kkt_lu",
                                        verbose=False),
        lambda s: osqp_tpu_torch.Solver(*_quick_start(), device="cpu", dtype="float64", linsys_solver="cg",
                                        verbose=False),
        lambda s: osqp_tpu_torch.SparseSolver(*_quick_start(), device="cpu", dtype="float64", polish=True,
                                              verbose=False),
        lambda s: osqp_tpu_torch.Solver(*_quick_start(), device="cpu", dtype="float64",
                                        linsys_solver="block_tridiag", block_size=1, verbose=False),
    ],
    ids=["polish", "update_polish", "kkt_lu", "cg", "sparse_polish", "block_tridiag"],
)
def test_ported_options_run(make):
    """Polish, the kkt_lu, cg and block_tridiag backends and the sparse
    Solver with its polish, which used to raise, now solve the quick
    start as the JAX package does."""
    ts = make(osqp_tpu_torch.OSQP().setup(*_quick_start(), device="cpu", dtype="float64", verbose=False))
    rt = ts.solve()
    kw = {f: getattr(ts.settings, f) for f in ("polish", "linsys_solver", "block_size")}
    reference = osqp_tpu.SparseSolver if isinstance(ts, osqp_tpu_torch.SparseSolver) else osqp_tpu.Solver
    rj = reference(*_quick_start(), dtype="float64", verbose=False, **kw).solve()
    _assert_parity(rj, rt, "float64")
    assert rt.info.status_polish == rj.info.status_polish == (1 if ts.settings.polish else 0)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("backend", ["dense_inv", "dense_chol", "kkt_lu", "cg", "block_tridiag"])
def test_all_backends(backend, dtype):
    """The counterpart of test_basic_qp.py's test_all_backends for the
    three dense backends, cg and block_tridiag: the basic QP with polish
    on, and CVXQP2_S (block_tridiag in stages of 1 and of 50, so that
    every matrix is block tridiagonal)."""
    import scipy.sparse as sp2

    P = sp2.triu([[4.0, 1.0], [1.0, 2.0]], format="csc")
    A = sp2.csc_matrix(np.array([[1.0, 1.0], [1.0, 0.0], [0.0, 1.0], [0.0, 1.0]]))
    basic = (P, np.ones(2), A, np.array([1.0, 0.0, 0.0, -np.inf]), np.array([1.0, 0.7, 0.7, np.inf]))
    stages = backend == "block_tridiag"
    kw = dict(max_iter=2000, alpha=1.6, polish=True, scaling=0, warm_start=False, linsys_solver=backend, dtype=dtype,
              block_size=1 if stages else 0)
    js, ts = _both(*basic, **kw)
    rj, rt = js.solve(), ts.solve()
    _assert_parity(rj, rt, dtype)
    assert rt.info.status_val == jcon.OSQP_SOLVED and rt.info.status_polish == rj.info.status_polish == 1
    tol = 1e-4 if dtype == "float64" else 5e-3
    np.testing.assert_allclose(rt.x, [0.3, 0.7], atol=tol)
    np.testing.assert_allclose(rt.y, [-2.9, 0.0, 0.2, 0.0], atol=tol)
    js, ts = _both(*_problem("CVXQP2_S"), linsys_solver=backend, dtype=dtype, block_size=50 if stages else 0)
    _assert_parity(js.solve(), ts.solve(), dtype)


@pytest.mark.parametrize("backend", ["dense_chol", "kkt_lu", "cg", "block_tridiag"])
def test_backend_update_sequence(backend):
    """Bounds, rho and matrix updates refactor through the registry."""
    P, q, A, l, u = _quick_start()
    js, ts = _both(P, q, A, l, u, linsys_solver=backend, dtype="float64", block_size=1)
    _assert_parity(js.solve(), ts.solve(), "float64")
    for s in (js, ts):
        s.update_bounds(l=np.array([1.0, 0.0, 0.0]), u=np.array([1.0, 0.5, 1e30]))
        s.update_rho(0.7)
    _assert_parity(js.solve(), ts.solve(), "float64")
    for s in (js, ts):
        s.update_P_A(Px=np.array([5.0, 1.5, 3.0]), Ax=A.data * 1.1)
    _assert_parity(js.solve(), ts.solve(), "float64")


def _goldens_tool():
    path = os.path.join(REPO, "tools", "make_torch_goldens.py")
    spec = importlib.util.spec_from_file_location("make_torch_goldens", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_goldens_are_current():
    """The stored JAX results that chip_smoke.py checks against: one entry
    regenerated by the tool equals the file's."""
    tool = _goldens_tool()
    g = np.load(tool.OUT)
    assert sorted(g.files) == sorted(f"{p}/{d}/{f}" for p in tool.PROBLEMS for d in tool.DTYPES for f in tool.FIELDS)
    fresh = tool.golden("CVXQP2_S", "float64")
    for f in ("status_val", "iter", "rho_updates"):
        assert int(fresh[f]) == int(g[f"CVXQP2_S/float64/{f}"])
    np.testing.assert_allclose(fresh["obj_val"], g["CVXQP2_S/float64/obj_val"], rtol=1e-9)
    for f in ("x", "y"):
        np.testing.assert_allclose(fresh[f], g[f"CVXQP2_S/float64/{f}"], rtol=0, atol=ATOL)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_cvxqp2_m_matches_goldens(dtype):
    """CVXQP2_M (n=1000, m=1250) at the Solver's real size, above K2's
    bound: in float64 the golden's status, 150 iterations, 1 rho update,
    x and y within 1e-8 of their largest entry; in float32 solved within
    one check interval, on the refined body."""
    g = np.load(_goldens_tool().OUT)
    key = lambda f: g[f"CVXQP2_M/{dtype}/{f}"]
    s = osqp_tpu_torch.Solver(*_problem("CVXQP2_M"), device="cpu", dtype=dtype, verbose=False)
    assert bool(s.factor["refine"].any()) == (dtype == "float32")
    r = s.solve()
    assert r.info.status_val == int(key("status_val")) == jcon.OSQP_SOLVED
    if dtype == "float64":
        assert (r.info.iter, r.info.rho_updates) == (int(key("iter")), int(key("rho_updates"))) == (150, 1)
        np.testing.assert_allclose(r.info.obj_val, float(key("obj_val")), rtol=1e-6)
        # |y| reaches 1.5e3 here: held relative to the vector's largest entry
        for got, want in ((r.x, key("x")), (r.y, key("y"))):
            assert np.abs(got - want).max() <= 1e-8 * max(1.0, np.abs(want).max())
    else:
        assert abs(r.info.iter - int(key("iter"))) <= CHECK


@pytest.mark.parametrize("make", [
    lambda: osqp_tpu_torch.Solver(*_quick_start(), verbose=False),
    lambda: osqp_tpu_torch.OSQP().setup(*_quick_start(), verbose=False),
], ids=["Solver", "OSQP.setup"])
def test_default_device_is_the_card(make, monkeypatch):
    """Without ``device`` the Solver runs on the CUDA card; where there is
    none it raises and names ``device="cpu"`` rather than carry on on the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        make()
    s = osqp_tpu_torch.Solver(*_quick_start(), device="cpu", verbose=False)
    assert s.device == torch.device("cpu") and s.data.P.device.type == "cpu"


def test_resolve_device_takes_the_card_when_there_is_one(monkeypatch):
    """With a CUDA device present, no ``device`` means the card; an
    explicit one is kept."""
    from osqp_tpu_torch.solver import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
