"""osqp_tpu_torch.BatchedSolver against osqp_tpu.parametric.BatchedSolver.

The same batches, made with numpy from a seed, go through both packages
on the CPU in float64 (the port's kernel wrappers then run their plain
versions), step by step through the same updates and re-solves: the same
statuses and iteration counts per instance, x and y within 1e-6.  The
first four tests are the counterparts of ``tests/test_parametric.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import osqp_tpu_torch
from osqp_tpu.parametric import BatchedSolver as JBatchedSolver
from osqp_tpu_torch import constants as con
from osqp_tpu_torch import convert, linalg
from osqp_tpu_torch import linsys as linsys_registry
from osqp_tpu_torch.models import build_mpc_qp, build_portfolio
from test_batch import random_qps

torch.set_num_threads(2)

ATOL = 1e-6
F64 = dict(dtype="float64", verbose=False)


def _pair(P, q, A, l, u, **kw):
    kw = {**F64, **kw}
    return (osqp_tpu_torch.BatchedSolver(P, q, A, l, u, device="cpu", **kw),
            JBatchedSolver(P, q, A, l, u, **kw))


def _assert_parity(rt, rj, what=""):
    np.testing.assert_array_equal(rt.status_val.numpy(), np.asarray(rj.status_val), err_msg=f"status {what}")
    np.testing.assert_array_equal(rt.iter.numpy(), np.asarray(rj.iter), err_msg=f"iter {what}")
    for name in ("x", "y"):
        # an instance without a solution is NaN in both (store_solution)
        t, j = getattr(rt, name).numpy(), np.asarray(getattr(rj, name))
        np.testing.assert_array_equal(np.isnan(t), np.isnan(j), err_msg=f"{name} NaN {what}")
        t, j = np.nan_to_num(t), np.nan_to_num(j)
        assert np.abs(t - j).max() <= ATOL * max(1.0, np.abs(j).max()), (name, what)


def test_parametric_loop_matches_single_solvers():
    B, n, m = 4, 6, 9
    P, q, A, l, u = random_qps(B, n, m, seed=23)
    rng = np.random.default_rng(42)
    bs, js = _pair(P, q, A, l, u)
    singles = [osqp_tpu_torch.Solver(P[i], q[i], A[i], l[i], u[i], device="cpu", **F64) for i in range(B)]
    for step in range(3):
        rb, rj = bs.solve(), js.solve()
        _assert_parity(rb, rj, f"step {step}")
        rs = [s.solve() for s in singles]
        for i in range(B):
            assert int(rb.status_val[i]) == con.OSQP_SOLVED == rs[i].info.status_val
            assert int(rb.iter[i]) == rs[i].info.iter, (step, i)
            np.testing.assert_allclose(rb.x[i].numpy(), rs[i].x, rtol=0, atol=1e-9)
        # parametric perturbations for the next step
        q = q + 0.1 * rng.standard_normal((B, n))
        shift = 0.05 * rng.standard_normal((B, m))
        l, u = l + shift, u + shift
        for s in (bs, js):
            s.update_lin_cost(q)
            s.update_bounds(l, u)
        for i in range(B):
            singles[i].update_lin_cost(q[i])
            singles[i].update_bounds(l=l[i], u=u[i])


def test_parametric_update_rho_and_warm_start():
    B, n, m = 3, 5, 7
    P, q, A, l, u = random_qps(B, n, m, seed=29)
    bs, js = _pair(P, q, A, l, u, adaptive_rho=False, check_termination=1)
    r1, j1 = bs.solve(), js.solve()
    _assert_parity(r1, j1, "first solve")
    # warm start at the optimum: one iteration (test_basic_qp.h:893 analogue)
    bs.warm_start(x=r1.x.numpy(), y=r1.y.numpy())
    js.warm_start(x=np.asarray(j1.x), y=np.asarray(j1.y))
    r2, j2 = bs.solve(), js.solve()
    assert (r2.iter == 1).all()
    _assert_parity(r2, j2, "warm start")
    bs.update_rho(0.5)
    js.update_rho(0.5)
    r3, j3 = bs.solve(), js.solve()
    assert (r3.status_val == con.OSQP_SOLVED).all()
    _assert_parity(r3, j3, "after update_rho")
    with pytest.raises(con.OSQPError):
        bs.update_rho(0.0)


def test_parametric_update_P_A():
    B, n, m = 3, 5, 7
    P, q, A, l, u = random_qps(B, n, m, seed=31)
    kw = dict(polish=True, eps_abs=1e-7, eps_rel=1e-7)
    bs, js = _pair(P, q, A, l, u, **kw)
    bs.solve()
    js.solve()
    P2, A2 = P * 1.5, A + 0.01
    bs.update_P_A(P2, A2)
    js.update_P_A(P2, A2)
    rb, rj = bs.solve(), js.solve()  # warm-started from the pre-update solution
    _assert_parity(rb, rj, "after update_P_A")
    for i in range(B):
        ri = osqp_tpu_torch.Solver(P2[i], q[i], A2[i], l[i], u[i], device="cpu", **F64, **kw).solve()
        np.testing.assert_allclose(rb.x[i].numpy(), ri.x, rtol=0, atol=1e-6)
    # update_A alone keeps P and each instance's rho
    bs.update_A(A)
    js.update_A(A)
    _assert_parity(bs.solve(), js.solve(), "after update_A")


def test_fused_resolve_matches_update_then_solve():
    """resolve(q, l, u) must be bit-identical to update_lin_cost +
    update_bounds + solve(), and agree with the JAX package's resolve."""
    P, q, A, l, u = random_qps(4, 16, 24, seed=3)
    a, j = _pair(P, q, A, l, u)
    b = osqp_tpu_torch.BatchedSolver(P, q, A, l, u, device="cpu", **F64)
    for s in (a, b, j):
        s.solve()

    def both(q=None, l=None, u=None):
        if q is not None:
            a.update_lin_cost(q)
        if l is not None:
            a.update_bounds(l, u)
        ra, rb, rj = a.solve(), b.resolve(q=q, l=l, u=u), j.resolve(q=q, l=l, u=u)
        assert torch.equal(ra.iter, rb.iter) and torch.equal(ra.status_val, rb.status_val)
        np.testing.assert_array_equal(ra.x.numpy(), rb.x.numpy())
        np.testing.assert_array_equal(ra.y.numpy(), rb.y.numpy())
        _assert_parity(rb, rj)
        return rb

    both(q=q * 1.25, l=l * 0.9, u=u * 0.9)
    assert not b.last_resolve["refactored"]
    both(q=q * 0.5)  # q only: no bounds, no refactor
    # a bounds change that flips constraint classes (the refactor): two
    # rows become equalities
    l3, u3 = l.copy(), u.copy()
    l3[:, 0] = u3[:, 0] = 0.1
    both(l=l3, u=u3)
    assert b.last_resolve["refactored"]


def test_resolve_reads_the_device_once_beyond_the_loop():
    """resolve's host reads: the segmented loop's own (one per check and
    rho iteration, one refinement signal) and the one changed.any();
    update_bounds adds the l <= u check's, both counted."""
    P, q, A, l, u = random_qps(3, 8, 12, seed=5)
    bs = osqp_tpu_torch.BatchedSolver(P, q, A, l, u, device="cpu", **F64)
    bs.solve()
    plain = osqp_tpu_torch.BatchedSolver(P, q, A, l, u, device="cpu", **F64)
    plain.iterates = bs.iterates
    plain.rho_state, plain.factor = bs.rho_state, bs.factor
    plain.update_lin_cost(q * 1.1)
    reads0 = linalg.host_reads
    plain.update_bounds(l * 1.1, u * 1.1)
    assert linalg.host_reads - reads0 == 2
    reads0 = linalg.host_reads
    plain.solve()
    loop_reads = linalg.host_reads - reads0
    bs.resolve(q=q * 1.1, l=l * 1.1, u=u * 1.1)
    assert bs.last_resolve == {"host_reads": loop_reads + 1, "refactored": False}
    bs.resolve(q=q)
    assert bs.last_resolve["host_reads"] >= 1 and not bs.last_resolve["refactored"]


def test_update_bounds_rejects_crossed_bounds():
    P, q, A, l, u = random_qps(2, 4, 5, seed=1)
    bs = osqp_tpu_torch.BatchedSolver(P, q, A, l, u, device="cpu", **F64)
    with pytest.raises(con.OSQPError):
        bs.update_bounds(u, l)


def test_kkt_lu_class_change_merges_perm_and_lu_per_instance(monkeypatch):
    """resolve(l=, u=) turns a row of instance 1 into an equality: the
    refactor replaces instance 1's lu AND its int32 perm and keeps the
    other instances' (the JAX package passes perm through whole).  The
    spy garbles the fresh factor of every instance whose rho did not
    change, so a pass-through would show."""
    B, n, m = 3, 6, 8
    P, q, A, l, u = random_qps(B, n, m, seed=11)
    kw = dict(linsys_solver="kkt_lu", adaptive_rho=False)
    bs, js = _pair(P, q, A, l, u, **kw)
    twin = osqp_tpu_torch.BatchedSolver(P, q, A, l, u, device="cpu", **F64, **kw)
    for s in (bs, js, twin):
        s.solve()
    old = dict(bs.factor)
    old_rv = bs.rho_state.rho_vec.clone()
    real = linsys_registry.init_factor

    def spy(cfg, P_, A_, sigma, rho_vec):
        f = real(cfg, P_, A_, sigma, rho_vec)
        keep = ~(rho_vec != old_rv).any(-1)
        f["perm"] = torch.where(keep[:, None], f["perm"].flip(-1), f["perm"])
        f["lu"] = torch.where(keep[:, None, None], f["lu"] + 1.0, f["lu"])
        return f

    l2, u2 = l.copy(), u.copy()
    l2[1, 0] = u2[1, 0] = 0.5 * (l[1, 0] + u[1, 0])
    monkeypatch.setattr(linsys_registry, "init_factor", spy)
    rb = bs.resolve(l=l2, u=u2)
    monkeypatch.undo()
    assert bs.last_resolve["refactored"]
    fresh = real(bs._cfg, bs.data.P, bs.data.A, bs._dyn.sigma, bs.rho_state.rho_vec)
    for key in ("perm", "lu"):
        assert torch.equal(bs.factor[key][1], fresh[key][1]), key
        assert not torch.equal(bs.factor[key][1], old[key][1]), key
        for i in (0, 2):
            assert torch.equal(bs.factor[key][i], old[key][i]), (key, i)
    assert bs.factor["perm"].dtype == torch.int32
    twin.update_bounds(l2, u2)
    rt = twin.solve()
    assert torch.equal(rb.iter, rt.iter) and torch.equal(rb.x, rt.x)
    _assert_parity(rb, js.resolve(l=l2, u=u2), "after the class change")


def test_mpc_receding_horizon_block_tridiag():
    """Three receding-horizon steps of an MPC batch (nx=2, nu=1, horizon
    4) through block_tridiag: x0 from the previous step's x_1, then
    resolve(l=, u=), against the JAX package."""
    B, nx, nu = 3, 2, 1
    rng = np.random.default_rng(4)
    Ad = np.array([[1.0, 0.1], [0.0, 1.0]])
    Bd = np.array([[0.005], [0.1]])
    base = build_mpc_qp(Ad, Bd, np.eye(nx), 0.1 * np.eye(nu), horizon=4, xmin=np.full(nx, -5.0),
                        xmax=np.full(nx, 5.0), umin=np.full(nu, -1.0), umax=np.full(nu, 1.0))
    l, u = np.tile(base.l, (B, 1)), np.tile(base.u, (B, 1))
    l[:, :nx] = u[:, :nx] = rng.standard_normal((B, nx))
    args = (np.stack([base.P] * B), np.stack([base.q] * B), np.stack([base.A] * B), l, u)
    bs, js = _pair(*args, linsys_solver="block_tridiag", block_size=base.block_size)
    rt, rj = bs.solve(), js.solve()
    _assert_parity(rt, rj, "step 0")
    b = base.block_size
    for step in range(1, 4):
        x1 = rt.x.numpy()[:, b:b + nx]
        l, u = l.copy(), u.copy()
        l[:, :nx] = u[:, :nx] = x1
        rt, rj = bs.resolve(l=l, u=u), js.resolve(l=l, u=u)
        assert (rt.status_val == con.OSQP_SOLVED).all()
        assert not bs.last_resolve["refactored"]
        _assert_parity(rt, rj, f"step {step}")


def test_portfolio_resolves_match_reference():
    """Portfolio QPs (n=20 assets, k=4 factors, B=3) solved, then two
    warm-started re-solves with new expected returns, as bench.py's
    portfolio leg, against the JAX package."""
    B, n, k = 3, 20, 4
    rng = np.random.default_rng(0)
    probs = [build_portfolio(rng.standard_normal(n), rng.standard_normal((n, k)) / np.sqrt(k),
                             np.abs(rng.standard_normal(n)) * np.sqrt(k)) for _ in range(B)]
    P, q, A, l, u = (np.stack(v) for v in zip(*probs))
    assert P.shape == (B, n + k, n + k) and A.shape == (B, k + 1 + n, n + k)
    bs, js = _pair(P, q, A, l, u, eps_abs=1e-3, eps_rel=1e-3)
    _assert_parity(bs.solve(), js.solve(), "cold solve")
    for j in range(2):
        qj = q * (1.0 + 0.01 * (j + 1))
        rt = bs.resolve(q=qj)
        assert (rt.status_val == con.OSQP_SOLVED).all()
        _assert_parity(rt, js.resolve(q=qj), f"re-solve {j}")


def test_build_portfolio_matches_reference():
    from osqp_tpu.models import build_portfolio as jbuild

    rng = np.random.default_rng(1)
    mu, F, D = rng.standard_normal(7), rng.standard_normal((7, 3)), np.abs(rng.standard_normal(7))
    for a, b in zip(build_portfolio(mu, F, D, gamma=0.5), jbuild(mu, F, D, gamma=0.5)):
        np.testing.assert_array_equal(a, b)


def test_converted_state_solves_like_the_reference():
    """convert.load_solver_state carries a JAX BatchedSolver's state
    (data, scaling, rho state, factor, iterates) into the port's: the
    next solve gives the reference's statuses, iterations, x and y."""
    P, q, A, l, u = random_qps(3, 6, 9, seed=17)
    bs, js = _pair(P, q, A, l, u)
    js.solve()
    js.update_lin_cost(q * 0.8)
    convert.load_solver_state(bs, js)
    assert isinstance(bs.data, type(bs.data)) and bs.iterates.x.dtype == torch.float64
    _assert_parity(bs.solve(), js.solve(), "after the carry")


def test_batched_solver_needs_a_device_or_the_card():
    P, q, A, l, u = random_qps(2, 3, 4, seed=2)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        osqp_tpu_torch.BatchedSolver(P, q, A, l, u, **F64)
    with pytest.raises(ValueError):
        osqp_tpu_torch.BatchedSolver(P, q[0], A, l, u, device="cpu", **F64)
    assert dataclasses.is_dataclass(osqp_tpu_torch.BatchedSolver(P, q, A, l, u, device="cpu", **F64).data)
