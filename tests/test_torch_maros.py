"""osqp_tpu_torch's Maros-Meszaros harness (``maros.py``), its pass
criterion (``verify.py``) and host polish (``polish_host.py``) against
the JAX package on the CPU, in float64.

Rows are held to the JAX package's run (live for the small rows, and
``tests/data/torch_goldens/maros_rows.npz`` from
``tools/make_torch_goldens.py maros`` for the CVXQP*_S rows, whose JAX
buckets take long to compile): the same status, iterations,
status_polish and host_polish; the objective and the residuals within
1e-6 relative; x and y within 1e-6.  Three faults of the JAX package's
harness are corrected in the port, each shown where the packages differ.
"""

import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import osqp_tpu
import osqp_tpu.maros as jm
import osqp_tpu.polish_host as jph
import osqp_tpu.verify as jv
import osqp_tpu_torch.maros as tm
import osqp_tpu_torch.polish_host as tph
import osqp_tpu_torch.verify as tv
from osqp_tpu.buckets import ProblemResult as JResult
from osqp_tpu_torch import constants as con
from osqp_tpu_torch.buckets import ProblemResult as TResult
from osqp_tpu_torch import Solver
from osqp_tpu_torch.io.qps import QPSProblem, load_qps
from osqp_tpu_torch.scaling import scale_data
from osqp_tpu_torch.types import QPData
from test_qps_maros import BASIC_QPS, RANGES_QPS
from test_sparse_large import _rand_sparse_qp

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAROS = os.path.join(REPO, "tests", "data", "maros_mm")
GOLDENS = os.path.join(REPO, "tests", "data", "torch_goldens", "maros_rows.npz")
SMALL = ["GENHS28", "HS118", "HS21", "HS268", "HS35", "HS35MOD", "HS51", "HS52", "HS53", "HS76", "QPTEST",
         "S268", "TAME", "ZECEVIC2"]
CVXQP_S = ["CVXQP1_S", "CVXQP2_S", "CVXQP3_S"]
ATOL = 1e-6


def _paths(names):
    return [os.path.join(MAROS, f"{n}.qps") for n in names]


def _close(a, b, rel=ATOL):
    return abs(a - b) <= rel * max(1.0, abs(b))


def _assert_row(row, want):
    """A port row against a JAX row (a dict, or a golden's arrays)."""
    for f in ("status_val", "iter", "status_polish"):
        assert int(row[f]) == int(want[f]), (row["name"], f, row[f], want[f])
    assert bool(row.get("host_polish")) == bool(want.get("host_polish", False)), row["name"]
    for f in ("obj", "pri_res", "dua_res"):
        assert _close(float(row[f]), float(want[f])), (row["name"], f, row[f], want[f])
    for f in ("x", "y"):
        np.testing.assert_allclose(row[f], np.asarray(want[f]), rtol=0, atol=ATOL, err_msg=f"{row['name']} {f}")


@pytest.fixture(scope="module")
def goldens():
    g = np.load(GOLDENS)
    return lambda name: {k.split("/", 1)[1]: g[k] for k in g.files if k.startswith(f"{name}/")}


@pytest.fixture(scope="module")
def small_rows():
    kw = dict(dtype="float64", verbose=False, keep_solutions=True)
    rt, st = tm.run_maros(_paths(SMALL), device="cpu", **kw)
    rj, sj = jm.run_maros(_paths(SMALL), **kw)
    return rt, st, rj, sj


def test_small_rows_match_jax(small_rows, goldens):
    rt, st, rj, sj = small_rows
    assert [r["name"] for r in rt] == SMALL
    for row, jrow in zip(rt, rj):
        _assert_row(row, jrow)
        _assert_row(row, goldens(row["name"]))
    assert st["pass_rate"] == sj["pass_rate"] == 1.0
    assert (st["polish_success"], st["polish_fail"]) == (sj["polish_success"], sj["polish_fail"])


def test_small_rows_share_buckets(small_rows):
    """Twelve rows (n <= 5, m <= 8) share the (8, 8) bucket; GENHS28 and
    HS118 have one each."""
    by = {r["name"]: r["bucket"] for r in small_rows[0]}
    assert by["GENHS28"] == (16, 8, 1) and by["HS118"] == (16, 32, 1)
    assert sorted(n for n, b in by.items() if b == (8, 8, 12)) == sorted(set(SMALL) - {"GENHS28", "HS118"})


def test_cvxqp_s_rows_match_goldens(goldens):
    rows, summary = tm.run_maros(_paths(CVXQP_S), dtype="float64", device="cpu", verbose=False,
                                 keep_solutions=True)
    for row in rows:
        _assert_row(row, goldens(row["name"]))
    assert summary["pass_rate"] == 1.0
    assert [r["bucket"] for r in rows] == [(128, 256, 2), (128, 128, 1), (128, 256, 2)]


def test_pass_criterion_on_small_rows(small_rows):
    """The port's kkt_check at the original data passes every small row,
    as tools/run_maros_mm.py counts a pass."""
    for row in small_rows[0]:
        qp = load_qps(os.path.join(MAROS, f"{row['name']}.qps"))
        chk = tv.kkt_check(qp.P, qp.q, qp.A, qp.l, qp.u, row["x"], row["y"])
        assert chk["ok"], (row["name"], chk)


# ---------------------------------------------------------------------------
# Modes (counterparts of tests/test_qps_maros.py:234-276)
# ---------------------------------------------------------------------------
@pytest.fixture
def basic(tmp_path):
    (tmp_path / "basic.qps").write_text(BASIC_QPS)
    (tmp_path / "ranged.qps").write_text(RANGES_QPS)
    return tmp_path


def test_run_maros(basic):
    rows, summary = tm.run_maros([str(basic / "basic.qps"), str(basic / "ranged.qps")], device="cpu",
                                 verbose=False)
    assert summary["problems"] == 2 and summary["pass_rate"] == 1.0
    assert abs({r["name"]: r for r in rows}["BASICQP"]["obj"] - 0.88) < 1e-3


def test_fallback_dtype_rescues_unsolved(basic):
    """eps = 1e-9 is out of float32's reach; the float64 fallback rescues
    the row and flags it, on the same device."""
    rows, summary = tm.run_maros([str(basic / "basic.qps")], eps=1e-9, dtype="float32",
                                 fallback_dtype="float64", device="cpu", verbose=False)
    assert rows[0].get("fallback") is True and rows[0]["status"] == "solved"
    assert summary["pass_rate"] == 1.0


def test_single_mode_matches_jax(basic):
    paths = [str(basic / "basic.qps"), str(basic / "ranged.qps")]
    kw = dict(single=True, dtype="float64", verbose=False, keep_solutions=True)
    rt, st = tm.run_maros(paths, device="cpu", **kw)
    rj, _ = jm.run_maros(paths, **kw)
    assert st["pass_rate"] == 1.0
    for row, jrow in zip(rt, rj):
        _assert_row(row, jrow)


def test_shard_partition(basic):
    for i in range(4):
        (basic / f"p{i}.qps").write_text(BASIC_QPS)
    paths = sorted(str(p) for p in basic.glob("p*.qps"))
    r0, _ = tm.run_maros(paths, shard=(0, 2), device="cpu", verbose=False)
    r1, _ = tm.run_maros(paths, shard=(1, 2), device="cpu", verbose=False)
    assert len(r0) + len(r1) == 4


def test_run_maros_runs_on_the_card_unless_asked(basic):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tm.run_maros([str(basic / "basic.qps")], verbose=False)


# ---------------------------------------------------------------------------
# Routing and the sparse rows
# ---------------------------------------------------------------------------
def test_route_sparse_matches_jax_on_the_corpus():
    paths = tm.collect_paths([MAROS])
    assert len(paths) == 36
    routes = {}
    for p in paths:
        qp = load_qps(p)
        routes[qp.name] = tm._route_sparse(qp)
        assert routes[qp.name] == jm._route_sparse(qp), qp.name
    assert sum(routes.values()) == 15 and routes["AUG3D"] and not routes["YAO"]


def test_solve_one_sparse_polishes_on_the_device_like_jax():
    """A structurally sparse problem through _solve_one_sparse (float64
    whatever the settings say, polish on the device) against the JAX
    package's device polish (its SparseSolver; its B = 1 solve_sparse
    polishes on the host)."""
    P, q, A, l, u = _rand_sparse_qp(40, 60, 0.2, seed=11)
    qp = QPSProblem(name="R", P=sp.triu(P, format="csc"), q=q, A=A, l=l, u=u, obj_constant=0.5, n=40, m=60)
    settings = dict(eps_abs=1e-3, eps_rel=1e-3, polish=True, max_iter=4000, verbose=False, dtype="float32",
                    polish_dtype="float64")
    row = tm._solve_one_sparse(qp, settings, "cpu")
    rj = osqp_tpu.SparseSolver(P=P, q=q, A=A, l=l, u=u, dtype="float64", polish=True, verbose=False).solve()
    assert row["sparse"] and row["status_polish"] == 1 == rj.info.status_polish
    assert (row["status_val"], row["iter"]) == (rj.info.status_val, rj.info.iter)
    assert _close(row["obj"], rj.info.obj_val + 0.5)
    np.testing.assert_allclose(row["x"], rj.x, rtol=0, atol=ATOL)
    np.testing.assert_allclose(row["y"], rj.y, rtol=0, atol=ATOL)


# ---------------------------------------------------------------------------
# The JAX package's harness faults, corrected in the port
# ---------------------------------------------------------------------------
def _scripted(module, result_type, outcomes, calls):
    """A stand-in for ``module.solve_problems`` whose k-th call returns
    outcomes[k] (status_val, status_polish) for every problem."""

    def solve_problems(problems, **kw):
        sv, spol = outcomes[len(calls)]
        calls.append(kw.get("dtype"))
        out = []
        for name, P, q, A, l, u in problems:
            n, m = len(q), len(l)
            out.append(result_type(name=name, status_val=sv, iter=25, obj_val=1.0, pri_res=1e-4, dua_res=1e-4,
                                   x=np.zeros(n), y=np.zeros(m), n=n, m=m, status_polish=spol))
        return out

    return solve_problems


def test_polish_only_escalation_never_turns_solved_infeasible(monkeypatch, basic):
    """A row solved in float32 whose polish failed is escalated to
    float64; a retry that comes back primal infeasible replaces it in
    the JAX package (_row_rank ranks certificates equal to solved, and
    the tie goes to the retry) but not in the port."""
    outcomes = [(con.OSQP_SOLVED, -1), (con.OSQP_PRIMAL_INFEASIBLE, 0)]
    kw = dict(dtype="float32", fallback_dtype="float64", verbose=False, polish=True)
    path = [str(basic / "basic.qps")]
    jcalls, tcalls = [], []
    monkeypatch.setattr(jm, "solve_problems", _scripted(jm, JResult, outcomes, jcalls))
    monkeypatch.setattr(tm, "solve_problems", _scripted(tm, TResult, outcomes, tcalls))
    jrows, _ = jm.run_maros(path, **kw)
    trows, _ = tm.run_maros(path, device="cpu", **kw)
    assert jcalls == tcalls == ["float32", "float64"]
    assert jrows[0]["status_val"] == con.OSQP_PRIMAL_INFEASIBLE  # the JAX package's fault
    assert trows[0]["status_val"] == con.OSQP_SOLVED and not trows[0].get("fallback")
    row = dict(status_val=con.OSQP_SOLVED, status_polish=-1)
    assert not tm._retry_replaces(row, con.OSQP_PRIMAL_INFEASIBLE, 0)
    assert not tm._retry_replaces(row, con.OSQP_DUAL_INFEASIBLE, 0)
    assert tm._retry_replaces(row, con.OSQP_SOLVED, -1) and tm._retry_replaces(row, con.OSQP_SOLVED, 1)
    # a row that failed outright may still take a certificate
    assert tm._retry_replaces(dict(status_val=con.OSQP_MAX_ITER_REACHED), con.OSQP_PRIMAL_INFEASIBLE, 0)
    assert not tm._retry_replaces(dict(status_val=con.OSQP_SOLVED_INACCURATE, status_polish=1),
                                  con.OSQP_MAX_ITER_REACHED, 0)


def test_polish_escalation_compares_dtype_names(monkeypatch, basic):
    """dtype "float64" with fallback_dtype np.float64 names one dtype: the
    port does not re-run the identical solve for a failed polish; the JAX
    package compares str(np.float64) with "float64" and re-runs it."""
    outcomes = [(con.OSQP_SOLVED, -1), (con.OSQP_SOLVED, -1)]
    kw = dict(dtype="float64", fallback_dtype=np.float64, verbose=False, polish=True)
    path = [str(basic / "basic.qps")]
    jcalls, tcalls = [], []
    monkeypatch.setattr(jm, "solve_problems", _scripted(jm, JResult, outcomes, jcalls))
    monkeypatch.setattr(tm, "solve_problems", _scripted(tm, TResult, outcomes, tcalls))
    jm.run_maros(path, **kw)
    tm.run_maros(path, device="cpu", **kw)
    assert jcalls == ["float64", np.float64]  # the JAX package's fault
    assert tcalls == ["float64"]
    assert tm._dtype_name(np.float64) == tm._dtype_name("float64") == tm._dtype_name(torch.float64) == "float64"
    assert tm._dtype_name(None) == str(torch.get_default_dtype()).removeprefix("torch.")


def test_polish_host_ruiz_caps_the_cost_measure():
    """On a P-dominated problem (P ~ 1e8) the port's host Ruiz gives the
    solver's own c, D and E; the JAX package's, which skips limit_scaling
    on the cost measure, does not (c 0.13x)."""
    rng = np.random.default_rng(0)
    n, m = 6, 4
    for scale, jax_agrees in ((1.0, True), (1e8, False)):
        M = rng.standard_normal((n, n))
        P, A, q = scale * (M @ M.T + np.eye(n)), rng.standard_normal((m, n)), rng.standard_normal(n)
        t = lambda a: torch.as_tensor(a, dtype=torch.float64)[None]  # noqa: E731
        _, scl = scale_data(QPData(P=t(P), q=t(q), A=t(A), l=t(-np.ones(m)), u=t(np.ones(m))), 10)
        want = (float(scl.c[0]), scl.D[0].numpy(), scl.E[0].numpy())
        for mod, agrees in ((tph, True), (jph, jax_agrees)):
            c, D, E = mod._ruiz(sp.csc_matrix(P), sp.csc_matrix(A), q)
            ok = _close(c, want[0], 1e-12) and np.allclose(D, want[1], rtol=1e-12, atol=0) and np.allclose(
                E, want[2], rtol=1e-12, atol=0)
            assert ok == agrees, (mod.__name__, scale, c / want[0])


def test_polish_host_matches_jax_on_cvxqp1_s():
    """Both packages' host polish from one ADMM point of CVXQP1_S (the
    port's polish-off solve): the same outcome, point and residuals."""
    qp = load_qps(os.path.join(MAROS, "CVXQP1_S.qps"))
    res = Solver(qp.P, qp.q, qp.A, qp.l, qp.u, device="cpu", dtype="float64", polish=False, verbose=False).solve()
    args = (qp.P, qp.A, qp.q, qp.l, qp.u, res.x, res.y, res.info.pri_res, res.info.dua_res)
    t_out, j_out = tph.polish_host(*args), jph.polish_host(*args)
    assert t_out[0] is True and j_out[0] is True
    for a, b in zip(t_out[1:3], j_out[1:3]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)
    for a, b in zip(t_out[3:], j_out[3:]):
        assert _close(a, b, 1e-9)
    assert tv.kkt_check(qp.P, qp.q, qp.A, qp.l, qp.u, t_out[1], t_out[2])["ok"]


# ---------------------------------------------------------------------------
# verify.py
# ---------------------------------------------------------------------------
def test_verify_checks_match_jax():
    rng = np.random.default_rng(4)
    n, m = 7, 9
    M = rng.standard_normal((n, n))
    P, q, A = M @ M.T + np.eye(n), rng.standard_normal(n), rng.standard_normal((m, n))
    l, u = -np.abs(rng.standard_normal(m)), np.where(np.arange(m) % 3, np.abs(rng.standard_normal(m)), np.inf)
    x, y = rng.standard_normal(n), rng.standard_normal(m)
    cases = [
        (tv.kkt_check, jv.kkt_check, (P, q, A, l, u, x, y)),
        (tv.kkt_check, jv.kkt_check, (sp.csc_matrix(np.triu(P)), q, sp.csc_matrix(A), l, u, x, y)),
        (tv.kkt_check, jv.kkt_check, (P, q, A, l, u, np.full(n, np.nan), y)),
        (tv.primal_infeasibility_check, jv.primal_infeasibility_check, (A, l, u, y)),
        (tv.primal_infeasibility_check, jv.primal_infeasibility_check,
         (np.array([[1.0, 0.0], [1.0, 0.0]]), np.array([0.0, 2.0]), np.array([1.0, 3.0]), np.array([1.0, -1.0]))),
        (tv.dual_infeasibility_check, jv.dual_infeasibility_check, (P, q, A, l, u, x)),
        (tv.dual_infeasibility_check, jv.dual_infeasibility_check,
         (np.diag([1.0, 0.0]), np.array([0.0, -1.0]), np.array([[1.0, 0.0]]), np.array([-1.0]), np.array([1.0]),
          np.array([0.0, 1.0]))),
    ]
    oks = []
    for port, jax_fn, args in cases:
        a, b = port(*args), jax_fn(*args)
        assert a.keys() == b.keys()
        for k in a:
            assert (a[k] == b[k]) or (np.isnan(a[k]) and np.isnan(b[k])), (port.__name__, k, a[k], b[k])
        oks.append(a["ok"])
    assert oks == [False, False, False, False, True, False, True]
