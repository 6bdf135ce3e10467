"""osqp_tpu_torch's block_tridiag backend (K7) against the JAX package on
the CPU: the block extraction, the factor (C, G) and the solve, K7's plain
versions (what its wrappers run for CPU tensors), the structure checks,
the MPC builder, and whole solves through ``Solver`` and ``solve_batch``,
among them the first 16 scenarios of the MPC cell at full width
(n = 372, m = 612, b = 12) against ``tests/data/torch_goldens/mpc.npz``.

The rule is ROADMAP's: in float64 the JAX package's status and iteration
count, x and y within 1e-6; in float32 its status and the iterations
within one check interval (25).  The factors agree to 1e-12 in float64:
the two packages order the Cholesky's and the products' sums apart.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import osqp_tpu
import osqp_tpu.constants as jcon
from osqp_tpu.batch import solve_batch as jsolve_batch
from osqp_tpu.linsys import block_tridiag as jbt
from osqp_tpu.models import build_mpc_qp as jbuild_mpc_qp
import osqp_tpu_torch
from osqp_tpu_torch.linsys import block_tridiag as bt
from osqp_tpu_torch.linsys import dense_chol
from osqp_tpu_torch.models import build_mpc_qp
from osqp_tpu_torch.ops import block_tridiag as k7
from test_block_tridiag import _double_integrator_mpc, _random_block_tridiag_qp

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


def _factor_inputs(B, Nb, b, seed=0):
    """P, A and rho of _random_block_tridiag_qp (float64 numpy)."""
    P, A = _random_block_tridiag_qp(B, Nb, b, seed=seed)
    rng = np.random.default_rng(seed + 1)
    rho = np.abs(rng.standard_normal((B, A.shape[1]))) + 0.1
    return P, A, rho


def _off(got, want) -> float:
    """Largest |got - want| over the largest |want| (at least 1); 0 when
    empty."""
    want = np.asarray(want)
    if not want.size:
        return 0.0
    return float(np.abs(got.numpy() - want).max() / max(np.abs(want).max(), 1.0))


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


# ---------------------------------------------------------------------------
# Counterparts of tests/test_block_tridiag.py
# ---------------------------------------------------------------------------
def test_factor_solve_matches_dense():
    B, Nb, b = 3, 5, 4
    P, A, rho = _factor_inputs(B, Nb, b)
    n, m = Nb * b, A.shape[1]
    sigma = 1e-6
    assert bt.check_block_structure(_t(P), _t(A), sigma, _t(rho), b) == 0.0

    factor = bt.init(_t(P), _t(A), sigma, _t(rho), block_size=b)
    rng = np.random.default_rng(1)
    rhs_x, rhs_z = rng.standard_normal((B, n)), rng.standard_normal((B, m))
    x_t, z_t = bt.solve(factor, _t(A), _t(rho), _t(rhs_x), _t(rhs_z))

    M = P + sigma * np.eye(n) + np.einsum("bmi,bm,bmj->bij", A, rho, A)
    t = rhs_x + np.einsum("bmn,bm->bn", A, rho * rhs_z)
    x_ref = np.linalg.solve(M, t[..., None])[..., 0]
    np.testing.assert_allclose(x_t.numpy(), x_ref, rtol=0, atol=1e-8)
    np.testing.assert_allclose(z_t.numpy(), np.einsum("bmn,bn->bm", A, x_ref), rtol=0, atol=1e-8)


def test_single_block_is_dense_chol():
    B, n, m = 2, 6, 4
    rng = np.random.default_rng(2)
    M0 = rng.standard_normal((B, n, n))
    P = _t(np.einsum("bij,bkj->bik", M0, M0) / n + 0.3 * np.eye(n))
    A = _t(rng.standard_normal((B, m, n)))
    rho = torch.full((B, m), 0.7, dtype=torch.float64)
    rhs_x, rhs_z = _t(rng.standard_normal((B, n))), _t(rng.standard_normal((B, m)))
    x1, z1 = bt.solve(bt.init(P, A, 1e-6, rho, block_size=n), A, rho, rhs_x, rhs_z)
    x2, z2 = dense_chol.solve(dense_chol.init(P, A, 1e-6, rho), A, rho, rhs_x, rhs_z)
    np.testing.assert_allclose(x1.numpy(), x2.numpy(), rtol=0, atol=1e-9)
    np.testing.assert_allclose(z1.numpy(), z2.numpy(), rtol=0, atol=1e-9)


@pytest.mark.parametrize("block_size", [4, 0])
def test_init_rejects_bad_block_size(block_size):
    P = torch.eye(6, dtype=torch.float64)[None]
    A = torch.zeros((1, 0, 6), dtype=torch.float64)
    with pytest.raises(ValueError, match="block_size"):
        jbt.init(jnp.asarray(P.numpy()), jnp.zeros((1, 0, 6)), 1e-6, jnp.zeros((1, 0)), block_size=block_size)
    with pytest.raises(ValueError, match="block_size"):
        bt.init(P, A, 1e-6, torch.zeros((1, 0), dtype=torch.float64), block_size=block_size)
    with pytest.raises(ValueError, match="block size"):
        k7.bt_factor(P, block_size)


def test_setup_rejects_out_of_band_structure():
    """Coupling outside the band is rejected at setup with the JAX
    package's DATA_VALIDATION_ERROR, through Solver and solve_batch."""
    n, b = 8, 2
    P = np.eye(n)
    P[0, 6] = P[6, 0] = 0.5  # couples block 0 and block 3
    A = np.eye(n)
    q, l, u = np.zeros(n), -np.ones(n), np.ones(n)
    kw = dict(linsys_solver="block_tridiag", block_size=b, verbose=False)
    with pytest.raises(osqp_tpu.OSQPError) as je:
        osqp_tpu.Solver(P, q, A, l, u, **kw)
    with pytest.raises(osqp_tpu_torch.OSQPError, match="block-tridiagonal") as te:
        osqp_tpu_torch.Solver(P, q, A, l, u, device="cpu", **kw)
    assert int(te.value.code) == int(je.value.code) == int(jcon.ErrorCode.DATA_VALIDATION_ERROR)
    assert str(te.value) == str(je.value)
    with pytest.raises(osqp_tpu_torch.OSQPError, match="block-tridiagonal"):
        osqp_tpu_torch.solve_batch(P[None], q[None], A[None], l[None], u[None], device="cpu", **kw)
    # an off-band row of A alone (A'A coupling) is rejected too
    A2 = np.eye(n)
    A2[0, 0] = A2[0, 7] = 1.0
    with pytest.raises(osqp_tpu_torch.OSQPError, match="block-tridiagonal"):
        osqp_tpu_torch.Solver(np.eye(n), q, A2, l, u, device="cpu", **kw)
    with pytest.raises(osqp_tpu_torch.OSQPError, match="must divide"):
        osqp_tpu_torch.Solver(np.eye(n), q, A, l, u, device="cpu", linsys_solver="block_tridiag", block_size=3,
                              verbose=False)
    # a banded problem passes
    osqp_tpu_torch.Solver(np.eye(n), q, np.eye(n), l, u, device="cpu", **kw)


def test_mpc_block_tridiag_matches_dense():
    """The double-integrator MPC through the Solver with block_tridiag:
    the JAX package's solve, polish included, and the dense_inv solve's
    x; the dynamics hold along the trajectory."""
    prob = _double_integrator_mpc()
    assert bt.check_block_structure(_t(prob.P)[None], _t(prob.A)[None], 1e-6,
                                    torch.ones((1, prob.A.shape[0]), dtype=torch.float64), prob.block_size) == 0.0
    common = dict(polish=True, verbose=False, eps_abs=1e-6, eps_rel=1e-6, dtype="float64")
    kw = dict(common, linsys_solver="block_tridiag", block_size=prob.block_size)
    rj = osqp_tpu.Solver(prob.P, prob.q, prob.A, prob.l, prob.u, **kw).solve()
    r1 = osqp_tpu_torch.Solver(prob.P, prob.q, prob.A, prob.l, prob.u, device="cpu", **kw).solve()
    r2 = osqp_tpu_torch.Solver(prob.P, prob.q, prob.A, prob.l, prob.u, device="cpu", linsys_solver="dense_inv",
                               **common).solve()
    assert r1.info.status == rj.info.status == r2.info.status == "solved"
    assert r1.info.iter == rj.info.iter and r1.info.status_polish == rj.info.status_polish
    np.testing.assert_allclose(r1.x, rj.x, rtol=0, atol=ATOL)
    np.testing.assert_allclose(r1.y, rj.y, rtol=0, atol=ATOL)
    np.testing.assert_allclose(r1.x, r2.x, rtol=0, atol=1e-5)
    np.testing.assert_allclose(r1.info.obj_val, r2.info.obj_val, rtol=0, atol=1e-6)
    xs, us = prob.split_solution(r1.x)
    Ad = np.array([[1.0, 0.1], [0.0, 1.0]])
    Bd = np.array([[0.005], [0.1]])
    for k in range(prob.horizon):
        np.testing.assert_allclose(xs[k + 1], Ad @ xs[k] + Bd @ us[k], rtol=0, atol=1e-5)
    np.testing.assert_allclose(xs[0], [1.0, 0.0], rtol=0, atol=1e-6)
    assert np.all(np.abs(us) <= 1.0 + 1e-6)


def test_mpc_receding_horizon_bounds_update():
    """Twenty receding-horizon steps, each moving x_0 by update_bounds,
    in both packages in lockstep: the same status and iterations at every
    step, and the regulator drives the state toward the origin."""
    jprob, tprob = _double_integrator_mpc(N=8), _double_integrator_mpc(N=8)
    kw = dict(linsys_solver="block_tridiag", block_size=tprob.block_size, polish=False, verbose=False,
              dtype="float64")
    js = osqp_tpu.Solver(jprob.P, jprob.q, jprob.A, jprob.l, jprob.u, **kw)
    ts = osqp_tpu_torch.Solver(tprob.P, tprob.q, tprob.A, tprob.l, tprob.u, device="cpu", **kw)
    x = np.array([1.0, 0.0])
    Ad = np.array([[1.0, 0.1], [0.0, 1.0]])
    Bd = np.array([[0.005], [0.1]])
    for _ in range(20):
        rj, rt = js.solve(), ts.solve()
        assert rt.info.status == rj.info.status == "solved"
        assert rt.info.iter == rj.info.iter
        np.testing.assert_allclose(rt.x, rj.x, rtol=0, atol=ATOL)
        _, us = tprob.split_solution(rt.x)
        x = Ad @ x + Bd @ us[0]
        jprob.update_xinit(js, x)
        tprob.update_xinit(ts, x)
    assert np.linalg.norm(x) < 0.5


# ---------------------------------------------------------------------------
# The factor and the solve against the JAX package's
# ---------------------------------------------------------------------------
def test_extract_blocks_matches_reference():
    rng = np.random.default_rng(4)
    M = rng.standard_normal((2, 12, 12))
    for b in (3, 4, 12):
        jD, jO = jbt._extract_blocks(jnp.asarray(M), b)
        D, O = bt._extract_blocks(_t(M), b)
        np.testing.assert_array_equal(D.numpy(), np.asarray(jD))
        np.testing.assert_array_equal(O.numpy(), np.asarray(jO))


@pytest.mark.parametrize("B,Nb,b,seed", [(3, 5, 4, 0), (2, 7, 3, 1), (4, 1, 5, 2), (2, 6, 1, 3), (1, 4, 12, 4)])
def test_init_and_solve_match_reference(B, Nb, b, seed):
    """C and G within 1e-12 of the JAX package's, the solve within 1e-12
    of its; the wrappers give their plain versions' results exactly."""
    P, A, rho = _factor_inputs(B, Nb, b, seed)
    n, m = Nb * b, A.shape[1]
    sigma = 1e-6
    jf = jbt.init(jnp.asarray(P), jnp.asarray(A), sigma, jnp.asarray(rho), block_size=b)
    f = bt.init(_t(P), _t(A), sigma, _t(rho), block_size=b)
    assert f["C"].shape == (B, Nb, b, b) and f["G"].shape == (B, Nb - 1, b, b)
    for key in ("C", "G"):
        assert _off(f[key], jf[key]) <= 1e-12, key
    rng = np.random.default_rng(seed + 7)
    rhs_x, rhs_z = rng.standard_normal((B, n)), rng.standard_normal((B, m))
    jx, jz = jbt.solve(jf, jnp.asarray(A), jnp.asarray(rho), jnp.asarray(rhs_x), jnp.asarray(rhs_z))
    x, z = bt.solve(f, _t(A), _t(rho), _t(rhs_x), _t(rhs_z))
    for got, want in ((x, jx), (z, jz)):
        assert _off(got, want) <= 1e-12

    M = dense_chol.form_schur(_t(P), _t(A), sigma, _t(rho))
    C, G = k7.bt_factor(M, b)
    Cp, Gp = k7.bt_factor_plain(M, b)
    assert torch.equal(C, Cp) and torch.equal(G, Gp)
    r = _t(rng.standard_normal((B, n)))
    assert torch.equal(k7.bt_solve(C, G, r), k7.bt_solve_plain(C, G, r))
    assert k7.launches_factor == 0 and k7.launches_solve == 0  # CPU tensors launch nothing


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("float64", 1e-12)])
def test_factor_in_each_dtype(dtype, tol):
    """float32 factors and solves agree with the JAX package's float32 to
    a float32 tolerance, relative to the largest entry."""
    B, Nb, b = 3, 6, 4
    P, A, rho = _factor_inputs(B, Nb, b, seed=5)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    jf = jbt.init(jnp.asarray(P, jd), jnp.asarray(A, jd), 1e-6, jnp.asarray(rho, jd), block_size=b)
    f = bt.init(_t(P, td), _t(A, td), 1e-6, _t(rho, td), block_size=b)
    for key in ("C", "G"):
        want = np.asarray(jf[key])
        assert f[key].dtype == td
        assert np.abs(f[key].numpy() - want).max() <= tol * np.abs(want).max(), key
    rhs = np.random.default_rng(8).standard_normal((B, Nb * b))
    jx, _ = jbt.solve(jf, jnp.asarray(A, jd), jnp.asarray(rho, jd), jnp.asarray(rhs, jd), jnp.zeros((B, A.shape[1]), jd))
    x, _ = bt.solve(f, _t(A, td), _t(rho, td), _t(rhs, td), torch.zeros((B, A.shape[1]), dtype=td))
    assert np.abs(x.numpy() - np.asarray(jx)).max() <= 100 * tol * np.abs(np.asarray(jx)).max()


def test_stage_not_positive_definite_gives_nan_as_reference():
    """A stage that is not positive definite leaves NaN in the lower
    triangle of its factor block and of every later stage's, as
    jnp.linalg.cholesky does; the solve then gives NaN in both packages,
    in the same entries."""
    B, Nb, b = 2, 4, 3
    P, A, rho = _factor_inputs(B, Nb, b, seed=6)
    P[1, 2 * b, 2 * b] = -50.0  # stage 2 of instance 1 is indefinite
    jf = jbt.init(jnp.asarray(P), jnp.asarray(A), 1e-6, jnp.asarray(rho), block_size=b)
    f = bt.init(_t(P), _t(A), 1e-6, _t(rho), block_size=b)
    C = f["C"].numpy()
    lower = np.tril(np.ones((b, b), bool))
    assert np.isnan(C[1, 2:][:, lower]).all() and (C[1, 2:][:, ~lower] == 0).all() and np.isfinite(C[1, :2]).all()
    assert np.isfinite(C[0]).all()
    np.testing.assert_array_equal(np.isnan(C), np.isnan(np.asarray(jf["C"])))
    rhs_x = np.random.default_rng(9).standard_normal((B, Nb * b))
    rhs_z = np.zeros((B, A.shape[1]))
    jx, _ = jbt.solve(jf, jnp.asarray(A), jnp.asarray(rho), jnp.asarray(rhs_x), jnp.asarray(rhs_z))
    x, _ = bt.solve(f, _t(A), _t(rho), _t(rhs_x), _t(rhs_z))
    np.testing.assert_array_equal(np.isnan(x.numpy()), np.isnan(np.asarray(jx)))
    assert np.isnan(x.numpy()[1]).all()
    np.testing.assert_allclose(x.numpy()[0], np.asarray(jx)[0], rtol=0, atol=1e-12)


def test_wrappers_check_their_inputs():
    M = torch.eye(6, dtype=torch.float64)[None]
    with pytest.raises(TypeError):
        k7.bt_factor(M.to(torch.float16), 3)
    with pytest.raises(ValueError):
        k7.bt_factor(M[0], 3)
    C, G = k7.bt_factor(M, 3)
    with pytest.raises(ValueError):
        k7.bt_solve(C, G[:, :0], torch.zeros(1, 6, dtype=torch.float64))
    with pytest.raises(ValueError):
        k7.bt_solve(C, G, torch.zeros(1, 5, dtype=torch.float64))
    with pytest.raises(ValueError):
        k7.bt_solve(C, G, torch.zeros(1, 6, dtype=torch.float32))
    assert k7.factor_path(k7.WARP_MAX + 1, torch.float32) == "cluster"
    assert (k7.cluster_max_block(torch.float32), k7.cluster_max_block(torch.float64)) == (558, 361)


def test_check_block_structure_matches_reference():
    P, A, rho = _factor_inputs(2, 4, 3, seed=10)
    P[:, 0, 9] = P[:, 9, 0] = 0.25  # block 0 against block 3
    want = jbt.check_block_structure(jnp.asarray(P), jnp.asarray(A), 1e-6, jnp.asarray(rho), 3)
    got = bt.check_block_structure(_t(P), _t(A), 1e-6, _t(rho), 3)
    assert got == want == 0.25
    with pytest.raises(ValueError):
        bt.check_block_structure(_t(P), _t(A), 1e-6, _t(rho), 5)


@pytest.mark.parametrize("sparse", [False, True])
def test_validate_structure_matches_reference(sparse):
    """validate_structure raises where the JAX package's does, with the
    same message, on scipy and on batched dense input."""
    n, b = 12, 3
    rng = np.random.default_rng(11)
    for coupling in (0.0, 0.5):
        P = np.eye(n)
        P[1, 10] = P[10, 1] = coupling
        A = np.eye(n) + np.diag(rng.standard_normal(n - 1), 1)
        args = (sp.csc_matrix(sp.triu(P)), sp.csc_matrix(A)) if sparse else (np.stack([P, P]), np.stack([A, A]))
        errors = []
        for mod, targs in ((jbt, args), (bt, args if sparse else tuple(_t(a) for a in args))):
            try:
                mod.validate_structure(*targs, b)
                errors.append(None)
            except (osqp_tpu.OSQPError, osqp_tpu_torch.OSQPError) as e:
                errors.append(str(e))
        assert errors[0] == errors[1]
        assert (errors[1] is None) == (coupling == 0.0)


# ---------------------------------------------------------------------------
# The MPC builder and MPC solves
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("horizon", [1, 5, 30])
def test_build_mpc_qp_matches_reference(horizon):
    tool = _goldens_tool()
    jbase, *jarrays = tool.mpc_scenarios(jbuild_mpc_qp, B=3, horizon=horizon)
    tbase, *tarrays = tool.mpc_scenarios(build_mpc_qp, B=3, horizon=horizon)
    for f in ("P", "q", "A", "l", "u"):
        np.testing.assert_array_equal(getattr(tbase, f), getattr(jbase, f))
    for f in ("nx", "nu", "horizon", "block_size"):
        assert getattr(tbase, f) == getattr(jbase, f)
    for j, t in zip(jarrays, tarrays):
        np.testing.assert_array_equal(t, j)
    v = np.arange(tbase.P.shape[0], dtype=np.float64)
    for a, c in zip(tbase.split_solution(v), jbase.split_solution(v)):
        np.testing.assert_array_equal(a, c)
    assert tbase.block_size == 12 and tbase.P.shape[0] == (horizon + 1) * 12


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_mpc_scenario_batch_matches_reference(dtype):
    """bench_mpc's generator at horizon 6 (n = 84, b = 12) and B = 8
    through both packages' solve_batch with block_tridiag."""
    tool = _goldens_tool()
    base, P, q, A, l, u = tool.mpc_scenarios(build_mpc_qp, B=8, horizon=6)
    kw = dict(tool.MPC_SETTINGS, dtype=dtype, block_size=base.block_size)
    rj = jsolve_batch(P, q, A, l, u, **kw)
    rt = osqp_tpu_torch.solve_batch(P, q, A, l, u, device="cpu", **kw)
    np.testing.assert_array_equal(rt.status_val.numpy(), np.asarray(rj.status_val))
    assert (rt.status_val == osqp_tpu_torch.OSQP_SOLVED).all()
    if dtype == "float64":
        np.testing.assert_array_equal(rt.iter.numpy(), np.asarray(rj.iter))
        np.testing.assert_array_equal(rt.rho_updates.numpy(), np.asarray(rj.rho_updates))
        for f in ("x", "y"):
            np.testing.assert_allclose(getattr(rt, f).numpy(), np.asarray(getattr(rj, f)), rtol=0, atol=ATOL)
    else:
        assert np.abs(rt.iter.numpy() - np.asarray(rj.iter)).max() <= CHECK


def _assert_golden(res, g, dtype):
    np.testing.assert_array_equal(np.asarray(res["status_val"]), g["status_val"])
    if dtype == "float64":
        np.testing.assert_array_equal(np.asarray(res["iter"]), g["iter"])
        for f in ("x", "y"):
            np.testing.assert_allclose(np.asarray(res[f]), g[f], rtol=0, atol=ATOL)
        np.testing.assert_allclose(np.asarray(res["obj_val"]), g["obj_val"], rtol=1e-9)
    else:
        assert np.abs(np.asarray(res["iter"]) - g["iter"]).max() <= CHECK


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_mpc_cell_first_scenarios_match_goldens(dtype):
    """The MPC cell at full width (n = 372, m = 612, b = 12): its first 16
    scenarios through solve_batch with block_tridiag against the JAX
    package's results in mpc.npz."""
    tool = _goldens_tool()
    g = np.load(tool.OUT_MPC)
    case = f"MPC16/{dtype}"
    _, _, k = tool.MPC_CASES[case]
    base, P, q, A, l, u = tool.mpc_scenarios(build_mpc_qp)
    assert base.P.shape == (372, 372) and base.A.shape == (612, 372)
    res = osqp_tpu_torch.solve_batch(P[:k], q[:k], A[:k], l[:k], u[:k], device="cpu", dtype=dtype,
                                     block_size=base.block_size, **{**tool.MPC_SETTINGS})
    assert (res.status_val == osqp_tpu_torch.OSQP_SOLVED).all()
    _assert_golden({f: getattr(res, f).numpy() for f in tool.SPARSE_FIELDS}, {f: g[f"{case}/{f}"] for f in
                                                                             tool.SPARSE_FIELDS}, dtype)


def test_mpc_solver_matches_golden():
    """The Solver with block_tridiag on scenario 0 of the MPC cell in
    float64 against the JAX package's, stored in mpc.npz; the stored
    golden is regenerated and compared, so the file cannot go stale."""
    tool = _goldens_tool()
    g = np.load(tool.OUT_MPC)
    assert sorted(g.files) == sorted(f"{c}/{f}" for c in tool.MPC_CASES for f in tool.SPARSE_FIELDS)
    base, _, _, _, l, u = tool.mpc_scenarios(build_mpc_qp)
    r = osqp_tpu_torch.Solver(base.P, base.q, base.A, l[0], u[0], device="cpu", dtype="float64",
                              block_size=base.block_size, **tool.MPC_SETTINGS).solve()
    res = dict(status_val=[r.info.status_val], iter=[r.info.iter], obj_val=[r.info.obj_val], x=r.x[None], y=r.y[None])
    want = {f: g[f"MPC1/float64/{f}"] for f in tool.SPARSE_FIELDS}
    _assert_golden(res, want, "float64")
    fresh = tool.mpc_golden("MPC1/float64")
    for f in ("status_val", "iter"):
        np.testing.assert_array_equal(fresh[f], want[f])
    for f in ("obj_val", "x", "y"):
        np.testing.assert_allclose(fresh[f], want[f], rtol=1e-9, atol=1e-12)
