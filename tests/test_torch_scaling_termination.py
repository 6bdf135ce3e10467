"""osqp_tpu_torch's Ruiz scaling, termination checks and rho estimate
against the JAX package, on identical inputs in float64.

The JAX side runs eagerly on the CPU with x64 on (conftest.py); state
crosses over through ``osqp_tpu_torch.convert``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osqp_tpu import scaling as jscaling
from osqp_tpu import termination as jterm
from osqp_tpu.types import DynSettings as JDyn
from osqp_tpu.types import QPData as JQP
from osqp_tpu.types import StaticConfig as JCfg
from osqp_tpu_torch import convert, scaling as tscaling, termination as tterm
from osqp_tpu_torch.types import DynSettings, QPData, ScalingData, StaticConfig
from test_batch import random_qps

torch.set_num_threads(2)

F64 = torch.float64
RTOL = 1e-12


def _close(t, j, rtol=RTOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=0)


def _problem(seed, B=6, n=10, m=14):
    """random_qps plus a dual-infeasible instance 1 (P = 0, q < 0, A x >= 0
    unbounded above), a primal-infeasible instance 2 (one row twice, with
    disjoint bounds) and a loose row, so that every status can occur."""
    P, q, A, l, u = random_qps(B, n, m, seed=seed)
    P[1] = 0.0
    q[1] = -1.0
    A[1] = np.abs(A[1])
    u[1] = 1e30
    A[2, 1] = A[2, 0]
    l[2, :2], u[2, :2] = (1.0, 5.0), (2.0, 6.0)
    l[0, 0], u[0, 0] = -1e30, 1e30
    return P, q, A, l, u


def _scaled(seed, iters=10):
    P, q, A, l, u = _problem(seed)
    jdata, jscl = jscaling.scale_data(JQP(*(jnp.asarray(v) for v in (P, q, A, l, u))), iters)
    return jdata, jscl


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("iters", [1, 10])
def test_scale_data_matches_reference(seed, iters):
    P, q, A, l, u = _problem(seed)
    jdata, jscl = jscaling.scale_data(JQP(*(jnp.asarray(v) for v in (P, q, A, l, u))), iters)
    tdata, tscl = tscaling.scale_data(QPData(*(torch.as_tensor(v) for v in (P, q, A, l, u))), iters)
    for f in ("c", "cinv", "D", "Dinv", "E", "Einv"):
        _close(getattr(tscl, f), getattr(jscl, f))
    for f in ("P", "q", "A", "l", "u"):
        _close(getattr(tdata, f), getattr(jdata, f))
    x, y = np.random.default_rng(seed).standard_normal((2, 6, 14))
    jx, jy = jscaling.unscale_solution(jnp.asarray(x[:, :10]), jnp.asarray(y), jscl)
    tx, ty = tscaling.unscale_solution(torch.as_tensor(x[:, :10]), torch.as_tensor(y), tscl)
    _close(tx, jx)
    _close(ty, jy)


def _state(jdata, jscl, seed):
    """Random iterates plus, in scaled space, the certificates of
    instance 1 (dx = ones) and instance 2 (dy = e0 - e1)."""
    rng = np.random.default_rng(100 + seed)
    B, n = jdata.q.shape
    m = jdata.l.shape[1]
    x, dx = rng.standard_normal((2, B, n))
    z, y, dy = rng.standard_normal((3, B, m))
    dx[1] = np.asarray(jscl.Dinv)[1]  # unscaled direction: all ones
    dy[2] = 0.0
    dy[2, :2] = np.asarray(jscl.Einv)[2, :2] * np.array([1.0, -1.0])
    return x, z, y, dx, dy


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("scaled_termination", [False, True])
@pytest.mark.parametrize("approximate", [False, True])
@pytest.mark.parametrize("eps", [1e-3, 1e3])
def test_check_termination_matches_reference(seed, scaled_termination, approximate, eps):
    jdata, jscl = _scaled(seed)
    B, n = jdata.q.shape
    m = jdata.l.shape[1]
    x, z, y, dx, dy = _state(jdata, jscl, seed)
    jcfg = JCfg(n=n, m=m, scaled_termination=scaled_termination)
    tcfg = StaticConfig(n=n, m=m, scaled_termination=scaled_termination)
    jdyn = JDyn.make(jnp.float64, eps_abs=eps, eps_rel=eps)
    jr = jterm.check_termination(jcfg, jdata, jscl, jdyn, *(jnp.asarray(v) for v in (x, z, y, dx, dy)), approximate)
    tr = tterm.check_termination(
        tcfg,
        convert.from_fields(QPData, jdata, "cpu", F64),
        convert.from_fields(ScalingData, jscl, "cpu", F64),
        convert.from_fields(DynSettings, jdyn, "cpu", F64),
        *(torch.as_tensor(v) for v in (x, z, y, dx, dy)),
        approximate,
    )
    np.testing.assert_array_equal(tr.terminated.numpy(), np.asarray(jr.terminated))
    np.testing.assert_array_equal(tr.status.numpy(), np.asarray(jr.status))
    for f in ("pri_res", "dua_res", "dy_cert", "dx_cert", "tol_ratio"):
        _close(getattr(tr, f), getattr(jr, f))
    np.testing.assert_array_equal(tr.obj_at_term.numpy(), np.asarray(jr.obj_at_term))
    if eps == 1e3 and not approximate:
        assert tr.terminated.all()
    if eps == 1e-3:
        # the constructed certificates are recognized
        assert tr.terminated[1] and tr.terminated[2]
        pinf, dinf = (
            (jterm.OSQP_PRIMAL_INFEASIBLE_INACCURATE, jterm.OSQP_DUAL_INFEASIBLE_INACCURATE)
            if approximate else (jterm.OSQP_PRIMAL_INFEASIBLE, jterm.OSQP_DUAL_INFEASIBLE)
        )
        assert int(tr.status[1]) == dinf and int(tr.status[2]) == pinf


@pytest.mark.parametrize("seed", [0, 1])
def test_compute_rho_estimate_matches_reference(seed):
    jdata, jscl = _scaled(seed)
    x, z, y, _, _ = _state(jdata, jscl, seed)
    rho = np.random.default_rng(seed).uniform(1e-3, 10.0, jdata.q.shape[0])
    je = jterm.compute_rho_estimate(jdata, *(jnp.asarray(v) for v in (x, z, y, rho)))
    te = tterm.compute_rho_estimate(
        convert.from_fields(QPData, jdata, "cpu", F64), *(torch.as_tensor(v) for v in (x, z, y, rho))
    )
    _close(te, je)
