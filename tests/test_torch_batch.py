"""osqp_tpu_torch.solve_batch end to end against osqp_tpu.solve_batch.

The same problems, made with numpy from a seed, go through both
packages on the CPU (the port's kernel wrappers then run their plain
versions).  In float64 the port must give the same status and iteration
count per instance, and x and y within 1e-6; in float32 the same status
and iterations within one check interval (25).
"""

import os
import re

import numpy as np
import pytest
import torch

import osqp_tpu
import osqp_tpu.constants as jcon
import osqp_tpu_torch
from osqp_tpu.io.qps import parse_qps
from test_batch import random_qps

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
ATOL = 1e-6
CHECK = 25


def _solve_both(P, q, A, l, u, dtype, **kw):
    kw = {"verbose": False, **kw}
    rj = osqp_tpu.solve_batch(P, q, A, l, u, dtype=dtype, **kw)
    rt = osqp_tpu_torch.solve_batch(P, q, A, l, u, dtype=dtype, device="cpu", **kw)
    return rj, rt


def _assert_parity(rj, rt, dtype):
    sj, st = np.asarray(rj.status_val), rt.status_val.numpy()
    np.testing.assert_array_equal(st, sj)
    ij, it = np.asarray(rj.iter), rt.iter.numpy()
    if dtype == "float64":
        np.testing.assert_array_equal(it, ij)
        for f in ("x", "y"):
            np.testing.assert_allclose(
                getattr(rt, f).numpy(), np.asarray(getattr(rj, f)), rtol=0, atol=ATOL, equal_nan=True
            )
    else:
        assert np.abs(it.astype(int) - ij.astype(int)).max() <= CHECK, (it, ij)


def _mixed():
    """test_batch.py's mixed batch: instance 2 is primal infeasible (one
    row twice, with disjoint bounds)."""
    P, q, A, l, u = random_qps(4, 6, 8, seed=3)
    A[2, 1] = A[2, 0]
    l[2, 0], u[2, 0] = 1.0, 2.0
    l[2, 1], u[2, 1] = 5.0, 6.0
    return P, q, A, l, u


def _ill_conditioned(seed=2):
    """Equality rows, eight loose rows and a small P: the Schur
    complement's condition number is ~1e6-1e7, so the dense_inv factor
    raises its refine flag and the loop runs the refined body."""
    P, q, A, l, u = random_qps(6, 12, 18, seed=seed)
    u[:, :4] = l[:, :4]
    l[:, 4:12], u[:, 4:12] = -1e30, 1e30
    return P * 1e-3, q, A, l, u


def _hs(name):
    with open(os.path.join(DATA, f"{name}.qps")) as f:
        qp = parse_qps(f.read(), name_hint=name)
    Pu = qp.P.toarray()
    P = Pu + Pu.T - np.diag(np.diag(Pu))
    return P[None], qp.q[None], qp.A.toarray()[None], qp.l[None], qp.u[None]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("seed", [7, 11])
def test_random_batch(dtype, seed):
    rj, rt = _solve_both(*random_qps(5, 8, 12, seed=seed), dtype)
    _assert_parity(rj, rt, dtype)
    assert (rt.status_val == osqp_tpu_torch.OSQP_SOLVED).all()


@pytest.mark.nanok
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_mixed_batch_with_primal_infeasible_instance(dtype):
    rj, rt = _solve_both(*_mixed(), dtype)
    _assert_parity(rj, rt, dtype)
    st = rt.status_val.numpy()
    assert st[2] == osqp_tpu_torch.OSQP_PRIMAL_INFEASIBLE
    assert (st[[0, 1, 3]] == osqp_tpu_torch.OSQP_SOLVED).all()
    assert torch.isnan(rt.x[2]).all()
    # the certificate, normalized to unit inf-norm
    cj, ct = np.asarray(rj.prim_inf_cert)[2], rt.prim_inf_cert[2].numpy()
    np.testing.assert_allclose(ct, cj, rtol=0, atol=ATOL if dtype == "float64" else 1e-3)


@pytest.mark.nanok
def test_dual_infeasible_instance():
    P, q, A, l, u = random_qps(3, 6, 8, seed=5)
    P[1] = 0.0
    q[1] = -1.0
    A[1] = np.abs(A[1])
    u[1] = 1e30
    rj, rt = _solve_both(P, q, A, l, u, "float64")
    _assert_parity(rj, rt, "float64")
    assert rt.status_val[1] == osqp_tpu_torch.OSQP_DUAL_INFEASIBLE
    np.testing.assert_allclose(rt.dual_inf_cert[1].numpy(), np.asarray(rj.dual_inf_cert)[1], rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", ["HS21", "HS35", "HS51", "HS76"])
def test_hs_fixture_as_batch_of_one(name):
    rj, rt = _solve_both(*_hs(name), "float64")
    _assert_parity(rj, rt, "float64")
    assert rt.status_val[0] == osqp_tpu_torch.OSQP_SOLVED
    np.testing.assert_allclose(rt.obj_val.numpy(), np.asarray(rj.obj_val), rtol=1e-9)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_ill_conditioned_batch_runs_refined_body(dtype):
    """The refined loop body: residual-corrected solves and, in float32,
    the TwoSum dual carry."""
    from osqp_tpu_torch.ops import admm_iter as k1

    before = k1.launches
    rj, rt = _solve_both(*_ill_conditioned(), dtype, max_iter=400)
    _assert_parity(rj, rt, dtype)
    # CPU tensors never count a kernel launch
    assert k1.launches == before


@pytest.mark.parametrize("verbose", [False, True])
def test_refine_flag_flips_at_a_rho_refactor(verbose, monkeypatch, capsys):
    """The rho update at iteration 100 turns the refine flag on (inverse
    residuals ~1e-14 before, >= 5e-12 after, against a gate of 1e-12).
    The loop body is chosen per segment, so one whole-range segment
    (verbose off) stays on the plain body while check-long segments
    (verbose on) switch to the refined body at iteration 101.  Either
    way the port re-reads the flag where the JAX driver does."""
    from osqp_tpu_torch.linsys import dense_inv

    signals = []
    real = dense_inv.refine_signal
    monkeypatch.setattr(dense_inv, "refine_signal", lambda f: signals.append(bool(real(f))) or real(f))
    P, q, A, l, u = random_qps(4, 12, 6, seed=0)
    u[:, :3] = l[:, :3]
    kw = {"rho": 1e-4, "eps_abs": 1e-6, "eps_rel": 1e-6, "max_iter": 600, "verbose": verbose}
    rj, rt = _solve_both(P * 0.1, q, A, l, u, "float64", **kw)
    _assert_parity(rj, rt, "float64")
    assert (rt.rho_updates > 0).all() and (rt.iter > 100).all()
    assert signals[0] is False
    assert signals[-1] is verbose


@pytest.mark.parametrize(
    "kw",
    [
        {"verbose": True},  # segments of one check interval
        {"segmented": False},
        {"adaptive_rho": False},
        {"scaled_termination": True, "check_termination": 10},
        {"alpha": 1.0, "sigma": 1e-4, "rho": 1.0},
    ],
    ids=["verbose", "unsegmented", "fixed_rho", "scaled_term", "settings"],
)
def test_settings_and_drivers(kw, capsys):
    P, q, A, l, u = random_qps(5, 8, 12, seed=7)
    rj, rt = _solve_both(P, q, A, l, u, "float64", **kw)
    _assert_parity(rj, rt, "float64")


def test_verbose_rows_and_footer_match_reference(capsys):
    """verbose=True (the default) prints the same iteration rows and
    footer as the JAX package, apart from the wall-clock column."""
    P, q, A, l, u = _ill_conditioned(seed=4)
    osqp_tpu.solve_batch(P, q, A, l, u, dtype="float64")
    out_j = capsys.readouterr().out
    osqp_tpu_torch.solve_batch(P, q, A, l, u, dtype="float64", device="cpu")
    out_t = capsys.readouterr().out

    def rows(out):
        lines = [ln for ln in out.splitlines() if re.match(r"^\s*\d+\s", ln)]
        return [ln.rsplit(None, 1)[0] for ln in lines]  # drop the time column

    def footer(out):
        keep = ("status:", "batch status:", "number of iterations:", "optimal objective:")
        return [ln for ln in out.splitlines() if ln.startswith(keep)]

    assert rows(out_t) and rows(out_t) == rows(out_j)
    assert footer(out_t) == footer(out_j)
    assert f"OSQP-TPU-TORCH v{osqp_tpu_torch.__version__}" in out_t


def test_warm_start():
    P, q, A, l, u = random_qps(5, 8, 12, seed=7)
    rng = np.random.default_rng(0)
    x0, y0 = rng.standard_normal((5, 8)), rng.standard_normal((5, 12))
    rj, rt = _solve_both(P, q, A, l, u, "float64", x0=x0, y0=y0)
    _assert_parity(rj, rt, "float64")
    rj, rt = _solve_both(P, q, A, l, u, "float64", x0=x0)
    _assert_parity(rj, rt, "float64")


def test_time_limit_stops_at_the_same_segment():
    """Both drivers poll the clock only after their second segment; with
    a limit that has passed by then, both stop at the same iteration."""
    P, q, A, l, u = random_qps(5, 8, 12, seed=7)
    kw = {"time_limit": 1e-9, "eps_abs": 1e-12, "eps_rel": 1e-12}
    rj, rt = _solve_both(P, q, A, l, u, "float64", **kw)
    _assert_parity(rj, rt, "float64")
    stopped = rt.status_val == jcon.OSQP_TIME_LIMIT_REACHED
    assert stopped.any()
    assert (rt.iter[stopped] == 200).all()


def test_solve_batch_takes_tensors_and_keeps_their_device():
    P, q, A, l, u = (torch.as_tensor(v) for v in random_qps(3, 5, 7, seed=1))
    res = osqp_tpu_torch.solve_batch(P, q, A, l, u, dtype=torch.float64, verbose=False)
    assert res.x.device == P.device and res.x.dtype == torch.float64
    assert res.x.shape == (3, 5) and res.y.shape == (3, 7)
    assert (res.status_val == osqp_tpu_torch.OSQP_SOLVED).all()


def test_solve_batch_on_numpy_defaults_to_the_card(monkeypatch):
    """numpy input with no ``device`` goes to the CUDA card; where there is
    none, solve_batch raises and names ``device="cpu"``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        osqp_tpu_torch.solve_batch(*random_qps(2, 3, 4, seed=1), dtype="float64", verbose=False)


@pytest.mark.parametrize("cuda", [False, True])
def test_solve_batch_keeps_cpu_tensors_on_the_cpu(cuda, monkeypatch):
    """CPU tensors with no ``device`` stay on the CPU, card or no card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cuda)
    P, q, A, l, u = (torch.as_tensor(v) for v in random_qps(2, 3, 4, seed=1))
    res = osqp_tpu_torch.solve_batch(P, q, A, l, u, dtype=torch.float64, verbose=False)
    assert res.x.device.type == res.status_val.device.type == "cpu"
    assert (res.status_val == osqp_tpu_torch.OSQP_SOLVED).all()


# --- polish and the other dense backends ---------------------------------
def _assert_polish_parity(rj, rt, dtype):
    np.testing.assert_array_equal(rt.status_polish.numpy(), np.asarray(rj.status_polish))
    if dtype == "float64":
        for f in ("pri_res", "dua_res"):
            np.testing.assert_allclose(getattr(rt, f).numpy(), np.asarray(getattr(rj, f)), rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(rt.obj_val.numpy(), np.asarray(rj.obj_val), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_batch_polish(dtype):
    """The slice with polish on at B=16, n=20, m=30: statuses, iterations
    and status_polish as the JAX package's (one instance fails to polish
    in both), and the polished solutions satisfy the KKT conditions
    tightly."""
    rj, rt = _solve_both(*random_qps(16, 20, 30, seed=11), dtype, polish=True)
    _assert_parity(rj, rt, dtype)
    _assert_polish_parity(rj, rt, dtype)
    ok = rt.status_polish == 1
    assert int(ok.sum()) >= 15 and rt.status_polish.dtype == torch.int32
    tight = 1e-9 if dtype == "float64" else 1e-3
    assert float(rt.pri_res[ok].max()) < tight and float(rt.dua_res[ok].max()) < tight


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_batch_polish_all_succeed(dtype):
    """The counterpart of test_batch.py's test_batch_polish."""
    rj, rt = _solve_both(*random_qps(3, 8, 12, seed=11), dtype, polish=True)
    _assert_parity(rj, rt, dtype)
    _assert_polish_parity(rj, rt, dtype)
    assert (rt.status_polish == 1).all()
    tight = 1e-9 if dtype == "float64" else 1e-5
    assert float(rt.pri_res.max()) < tight and float(rt.dua_res.max()) < tight


@pytest.mark.nanok
def test_batch_polish_status_by_instance():
    """Polish is taken only where the instance is solved: the infeasible
    instance of the mixed batch keeps status_polish 0 and its NaN x."""
    rj, rt = _solve_both(*_mixed(), "float64", polish=True)
    _assert_parity(rj, rt, "float64")
    np.testing.assert_array_equal(rt.status_polish.numpy(), np.asarray(rj.status_polish))
    assert rt.status_polish.tolist() == [1, 1, 0, 1]
    assert torch.isnan(rt.x[2]).all()


@pytest.mark.parametrize("kw", [{"polish_refine_iter": 0}, {"polish_passes": 1}, {"segmented": False},
                                {"delta": 1e-5}, {"scaling": 0}],
                         ids=["no_refinement", "one_pass", "unsegmented", "delta", "no_scaling"])
def test_batch_polish_settings(kw):
    rj, rt = _solve_both(*random_qps(5, 8, 12, seed=7), "float64", polish=True, **kw)
    _assert_parity(rj, rt, "float64")
    _assert_polish_parity(rj, rt, "float64")


def test_batch_polish_in_float64_over_a_float32_solve():
    rj, rt = _solve_both(*random_qps(5, 8, 12, seed=7), "float32", polish=True, polish_dtype="float64")
    _assert_parity(rj, rt, "float32")
    np.testing.assert_array_equal(rt.status_polish.numpy(), np.asarray(rj.status_polish))
    assert rt.x.dtype == torch.float32 and (rt.status_polish == 1).all()
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0, atol=1e-5)


def test_batch_polish_verbose_footer_matches_reference(capsys):
    P, q, A, l, u = random_qps(3, 8, 12, seed=11)
    osqp_tpu.solve_batch(P, q, A, l, u, dtype="float64", polish=True)
    out_j = capsys.readouterr().out
    osqp_tpu_torch.solve_batch(P, q, A, l, u, dtype="float64", polish=True, device="cpu")
    out_t = capsys.readouterr().out
    keep = ("plsh", "status:", "batch status:", "solution polish:", "number of iterations:", "optimal objective:")
    # the plsh row's residuals are rounding noise (~1e-16): keep its objective only
    pick = lambda out: [ln[:17] if ln.startswith("plsh") else ln for ln in out.splitlines() if ln.startswith(keep)]
    assert pick(out_t) == pick(out_j) and pick(out_t)[0].startswith("plsh")
    assert any(ln.startswith("solution polish:      successful") for ln in pick(out_t))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("backend", ["kkt_lu", "dense_chol", "mkl pardiso"])
def test_dense_backends(backend, dtype):
    """solve_batch through the full-KKT LU and the Cholesky backends
    against the JAX package with the same backend, and against the port's
    own dense_inv run."""
    P, q, A, l, u = random_qps(6, 10, 14, seed=5)
    rj, rt = _solve_both(P, q, A, l, u, dtype, linsys_solver=backend)
    _assert_parity(rj, rt, dtype)
    assert (rt.status_val == osqp_tpu_torch.OSQP_SOLVED).all()
    ref = osqp_tpu_torch.solve_batch(P, q, A, l, u, dtype=dtype, device="cpu", verbose=False)
    if dtype == "float64":
        np.testing.assert_array_equal(rt.iter.numpy(), ref.iter.numpy())
        np.testing.assert_allclose(rt.x.numpy(), ref.x.numpy(), rtol=0, atol=ATOL)


@pytest.mark.parametrize("backend", ["kkt_lu", "dense_chol"])
def test_dense_backends_with_rho_updates_and_polish(backend):
    """A batch whose rho adapts (the factor is rebuilt and merged per
    instance, kkt_lu's integer perm included), then polish."""
    P, q, A, l, u = random_qps(4, 12, 6, seed=0)
    u[:, :3] = l[:, :3]
    kw = {"rho": 1e-4, "eps_abs": 1e-6, "eps_rel": 1e-6, "max_iter": 600, "linsys_solver": backend, "polish": True}
    rj, rt = _solve_both(P * 0.1, q, A, l, u, "float64", **kw)
    _assert_parity(rj, rt, "float64")
    _assert_polish_parity(rj, rt, "float64")
    assert (rt.rho_updates > 0).all()


@pytest.mark.parametrize("backend", ["dense_inv", "kkt_lu", "dense_chol"])
def test_batch_polish_without_constraints(backend):
    """m = 0: K is P + sigma I alone, polish's mask and nu are empty."""
    rng = np.random.default_rng(0)
    B, n = 3, 6
    M = rng.standard_normal((B, n, n))
    P = np.einsum("bij,bkj->bik", M, M) / n + 0.1 * np.eye(n)
    q = rng.standard_normal((B, n))
    A, l, u = np.zeros((B, 0, n)), np.zeros((B, 0)), np.zeros((B, 0))
    rj, rt = _solve_both(P, q, A, l, u, "float64", polish=True, linsys_solver=backend)
    _assert_parity(rj, rt, "float64")
    _assert_polish_parity(rj, rt, "float64")
    assert (rt.status_polish == 1).all()
