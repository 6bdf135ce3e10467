"""K5's grouped launch and fused CG start on the CPU: the plan that deals
a launch's CTAs to its jobs, the grouped products and the fused start
against the single plain functions they replace, and the callers that
group their products (Ruiz, the termination products, the cg backend),
bit for bit with the composition they had.  Inputs are made from seeds
with numpy; every comparison is exact (``torch.equal``)."""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from osqp_tpu_torch import scaling, termination
from osqp_tpu_torch.linsys import cg
from osqp_tpu_torch.ops import cg as k6
from osqp_tpu_torch.ops import ell as k5
from osqp_tpu_torch.sparse_ops import ELLMatrix, ell_from_scipy
from osqp_tpu_torch.types import QPData


def _k_slots(m, n, k, rng):
    """(m, n) with 1 to k nonzeros a row, every fifth row exactly k."""
    counts = rng.integers(1, k + 1, m)
    counts[::5] = k
    cols = [np.sort(rng.choice(n, c, replace=False)) for c in counts]
    indptr = np.concatenate([[0], np.cumsum(counts)])
    return sp.csr_matrix((rng.standard_normal(indptr[-1]), np.concatenate(cols), indptr), shape=(m, n))


def _operands(k, B, dtype, seed=0, m=60, n=40):
    """A (m, n) with rows of up to k slots and a symmetric P (n, n), both
    with per-instance values, and a generator of (B, ·) vectors."""
    rng = np.random.default_rng(seed)
    A = ell_from_scipy(_k_slots(m, n, k, rng), dtype, batch=B).contiguous()
    M = _k_slots(n, n, k, rng)
    P = ell_from_scipy(sp.triu(M + M.T + 4 * sp.eye(n), format="csr"), dtype, batch=B, sym_from_triu=True)
    P = P.contiguous()
    f = torch.as_tensor(1.0 + rng.random((B, 1, 1)), dtype=dtype)
    A = dataclasses.replace(A, val=(A.val * f).contiguous(), t_val=(A.t_val * f).contiguous())
    r = lambda *s: torch.as_tensor(rng.standard_normal(s), dtype=dtype)
    return A, P, r


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------
PLAN_ROWS = [(1,), (31, 33), (2500,), (12500, 10000), (1, 4000, 257, 64, 3, 1000, 2, 17), (1000, 1250) * 3]


@pytest.mark.parametrize("R", PLAN_ROWS)
@pytest.mark.parametrize("B", [1, 3, 64])
@pytest.mark.parametrize("sms", [132, 7, 1])
def test_plan_covers_every_row_of_every_job_once(R, B, sms):
    """Walking the CTAs as the kernel reads its block index covers every
    (instance, row) of every job exactly once; tiles and runs fit a CTA;
    where the rows allow, every SM gets a CTA."""
    p = k5.plan(R, B, sms)
    seen = [np.zeros((B, r), np.int32) for r in R]
    for j, r0, r1, b0, b1 in k5.plan_tiles(p, R, B):
        assert r0 < r1 and b0 < b1
        seen[j][b0:b1, r0:r1] += 1
    assert all((s == 1).all() for s in seen)
    assert p.rows in (32, 64, 128, 256) and p.rows * p.ipar <= k5.THREADS and p.run % p.ipar == 0
    assert p.ipar == min(k5.THREADS // p.rows, B)
    if sum(-(-r // 32) for r in R) >= sms:
        assert p.ctas >= sms
    # a run never splits a group of ipar instances, and no run is empty
    assert len({(b0, b1) for *_, b0, b1 in k5.plan_tiles(p, R, B)}) == -(-B // p.run)


def test_plan_takes_jobs_with_rows_only():
    for R, B in (((), 1), ((0,), 1), ((5, 0), 2), ((5,), 0)):
        with pytest.raises(ValueError, match="at least one row"):
            k5.plan(R, B, 132)


def test_plan_at_the_sparse_paths_shapes():
    """CVXQP2_L at B = 1 (P x with A x: 10000 and 12500 rows) takes tiles
    well under 256 rows, a CTA per SM; CVXQP2_M's scenario batch (B = 64)
    keeps runs of many instances, so that a CTA reads its tile's pattern
    once for them."""
    p = k5.plan((10000, 12500), 1, 132)
    assert p.rows == 128 and p.ipar == 1 and p.ctas >= 132
    p = k5.plan((1000, 1250), 64, 132)
    assert p.rows == 32 and p.ipar == 8 and p.run >= 8 and p.ctas >= 132


# ---------------------------------------------------------------------------
# Grouped products against the single plain functions
# ---------------------------------------------------------------------------
def _calls(A, P, r, B):
    m, n = A.shape
    x, y, w, cw = r(B, n), r(B, m), r(B, m).abs() + 0.1, r(B, n).abs() + 0.1
    return [(k5.ell_matvec, A, x), (k5.ell_tmatvec, A, y), (k5.ell_tmatvec, A, y, w), (k5.ell_sq_colsums, A, w),
            (k5.ell_row_norms, A, cw), (k5.ell_col_norms, A, w), (k5.ell_diagonal, P), (k5.ell_matvec, P, x),
            (k5.ell_col_norms, P, cw)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("k", list(range(1, 18)))
def test_grouped_products_equal_their_single_plain_functions(k, B, dtype):
    """Nine products of every mode over rows of up to k slots: each result
    of the grouped call equals its single plain function's bit for bit,
    and the plan of their rows covers every row of every job once."""
    A, P, r = _operands(k, B, dtype, seed=k)
    assert A.idx.shape[1] == k
    calls = _calls(A, P, r, B)
    got = k5.ell_products(*calls)
    assert len(got) == len(calls)
    for (f, *args), o in zip(calls, got):
        assert torch.equal(o, getattr(k5, f"{f.__name__}_plain")(*args)), f.__name__
    R = tuple(o.shape[1] for o in got)
    p = k5.plan(R, B, 132)
    covered = sum((r1 - r0) * (b1 - b0) for _, r0, r1, b0, b1 in k5.plan_tiles(p, R, B))
    assert covered == B * sum(R)


def test_grouped_products_take_the_empty_short_cut():
    """Operands with no rows or no columns give zeros of the right shape
    beside the other products of the call."""
    A, P, r = _operands(3, 2, torch.float64)
    for m, n in ((0, 40), (60, 0)):
        E = ell_from_scipy(sp.csr_matrix((m, n)), torch.float64, batch=2).contiguous()
        x, y = r(2, n), r(2, m)
        got = k5.ell_products((k5.ell_matvec, E, x), (k5.ell_matvec, A, r(2, 40)), (k5.ell_tmatvec, E, y),
                              (k5.ell_col_norms, E, y.abs()), (k5.ell_diagonal, P))
        assert got[0].shape == (2, m) and not got[0].any()
        assert got[2].shape == (2, n) and not got[2].any() and got[3].shape == (2, n)
        assert torch.equal(got[4], k5.ell_diagonal_plain(P))
    assert k5.ell_products() == []


def test_grouped_products_check_their_calls():
    A, P, r = _operands(3, 2, torch.float64)
    with pytest.raises(TypeError, match="product functions"):
        k5.ell_products((k5.ell_scale, A, r(2, 60), r(2, 40)))
    A32, _, r32 = _operands(3, 2, torch.float32)
    with pytest.raises(ValueError, match="differ in device, dtype or batch"):
        k5.ell_products((k5.ell_matvec, A, r(2, 40)), (k5.ell_matvec, A32, r32(2, 40)))
    with pytest.raises(ValueError, match="expected"):
        k5.ell_products((k5.ell_matvec, A, r(2, 60)))


def test_operand_is_checked_once_and_kept():
    """The launch descriptor is made at the first product and kept on the
    matrix; a replaced matrix makes its own; a bad operand raises at every
    call."""
    A, _, r = _operands(3, 2, torch.float64)
    k5.ell_matvec(A, r(2, 40))
    d = A.__dict__["_k5_operand"]
    k5.ell_products((k5.ell_tmatvec, A, r(2, 60)))
    assert A.__dict__["_k5_operand"] is d and not d.cuda and d.B == 2
    assert "_k5_operand" not in dataclasses.replace(A, val=A.val.clone()).__dict__
    bad = ELLMatrix(val=A.val, idx=A.idx.long(), t_val=A.t_val, t_idx=A.t_idx, shape=A.shape)
    for _ in range(2):
        with pytest.raises(TypeError, match="int32"):
            k5.ell_matvec(bad, r(2, 40))


# ---------------------------------------------------------------------------
# The fused CG start
# ---------------------------------------------------------------------------
def _composed_start(P, A, w, x0, dinv, sigma, rhs_x, rhs_z=None, rho=None):
    """The start as linsys/cg.py:solve and ops/cg.py:_start composed it
    before the fused start: the right-hand side, then r = b - M x0 through
    the cg operator's plain products, and z = dinv r."""
    b = rhs_x if rhs_z is None else rhs_x + k5.ell_tmatvec_plain(A, rhs_z, rho)
    u, v = k6.EllOperator(P, A, w=w).plain(x0)
    Mx = u + sigma * x0
    Mx = Mx + v
    r = b - Mx
    return b, r, dinv * r


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("with_rhs", [True, False])
@pytest.mark.parametrize("k", [1, 3, 9, 17])
def test_fused_start_is_the_composition(dtype, with_rhs, k):
    """ell_cg_start (on the CPU its plain version) gives the bits of the
    composition it replaced, with sigma a 0-d host tensor (the cg
    factor's) or a float."""
    A, P, r = _operands(k, 3, dtype, seed=10 + k)
    m, n = A.shape
    rho = r(3, m).abs() + 0.1
    x0, dinv, rhs_x, rhs_z = r(3, n), r(3, n).abs(), r(3, n), r(3, m)
    for sigma in (torch.tensor(1e-6, dtype=dtype), 1e-6):
        args = (P, A, rho, x0, dinv, sigma, rhs_x) + ((rhs_z, rho) if with_rhs else ())
        want = _composed_start(*args)
        for got in (k5.ell_cg_start(*args), k5.ell_cg_start_plain(*args)):
            assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_fused_start_checks_its_inputs():
    A, P, r = _operands(3, 2, torch.float64)
    m, n = A.shape
    args = [P, A, r(2, m), r(2, n), r(2, n), 1e-6, r(2, n), r(2, m), r(2, m)]
    with pytest.raises(ValueError, match="together"):
        k5.ell_cg_start(*args[:8])
    with pytest.raises(ValueError, match="expected"):
        k5.ell_cg_start(*args[:3], r(2, n + 1), *args[4:])
    empty = ell_from_scipy(sp.csr_matrix((0, n)), torch.float64, batch=2).contiguous()
    with pytest.raises(ValueError, match="must have rows"):
        k5.ell_cg_start(P, empty, r(2, 0), *args[3:7])


def _cg_problem(dtype, B=3, seed=4, n=50, m=70):
    rng = np.random.default_rng(seed)
    M = sp.random(n, n, density=4.0 / n, random_state=rng)
    P = ell_from_scipy(sp.triu(M @ M.T + 0.1 * sp.eye(n), format="csr"), dtype, batch=B, sym_from_triu=True)
    A = ell_from_scipy(sp.random(m, n, density=4.0 / n, random_state=rng, format="csr"), dtype, batch=B)
    T = lambda a: torch.as_tensor(a, dtype=dtype)
    rho = T(rng.random((B, m)) + 0.1)
    vecs = [T(rng.standard_normal(s)) for s in ((B, n), (B, m), (B, n))]
    return P.contiguous(), A.contiguous(), rho, vecs


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cg_solve_on_ell_gives_the_bits_of_the_unfused_path(dtype):
    """The cg backend's solve, whose start is now fused, against the path
    it replaced: b = rhs_x + A'(rho rhs_z), then the CG from x0 over the
    plain products: x and z = A x bit for bit."""
    P, A, rho, (rhs_x, rhs_z, x0) = _cg_problem(dtype)
    fac = cg.init(P, A, torch.tensor(1e-6, dtype=dtype), rho)
    x, z = cg.solve(fac, A, rho, rhs_x, rhs_z, x0)
    b = rhs_x + k5.ell_tmatvec_plain(A, rhs_z, rho)
    want, _ = k6.cg_solve_plain(P, A, fac["sigma"], rho, fac["dinv"], b, x0, fac["tol_rel"], int(fac["max_iter"]))
    assert torch.equal(x, want) and torch.equal(z, k5.ell_matvec_plain(A, want))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_pcg_start_on_an_ell_operator_is_the_unfused_start(dtype):
    """pcg_solve given the cg form of an EllOperator and x0 takes the fused
    start; over the operator's plain products it takes the composed one:
    the same steps and x bit for bit."""
    P, A, rho, (b, _, x0) = _cg_problem(dtype, seed=8)
    fac = cg.init(P, A, torch.tensor(1e-6, dtype=dtype), rho)
    op = k6.EllOperator(P, A, w=rho)
    args = (fac["sigma"], fac["dinv"], b, fac["tol_rel"], 200, x0)
    x1, s1 = k6.pcg_solve_plain(op, *args)
    x2, s2 = k6.pcg_solve_plain(op.plain, *args)
    assert torch.equal(x1, x2) and torch.equal(s1, s2)


# ---------------------------------------------------------------------------
# Callers that group their products
# ---------------------------------------------------------------------------
def test_cg_init_on_ell_is_the_composition():
    P, A, rho, _ = _cg_problem(torch.float64)
    sigma = torch.tensor(1e-6, dtype=torch.float64)
    fac = cg.init(P, A, sigma, rho)
    diagM = k5.ell_diagonal_plain(P) + sigma
    diagM = diagM + k5.ell_sq_colsums_plain(A, rho)
    assert torch.equal(fac["dinv"], 1.0 / diagM)


def test_termination_products_on_ell_are_the_single_products():
    P, A, rho, (x, y, dx) = _cg_problem(torch.float64, seed=2)
    data = QPData(P=P, q=x, A=A, l=y - 1, u=y + 1)
    dy = y.flip(-1).contiguous()
    pr = termination.compute_products(data, x, y, y, dx, dy)
    want = [k5.ell_matvec_plain(A, x), k5.ell_matvec_plain(P, x), k5.ell_tmatvec_plain(A, y),
            k5.ell_tmatvec_plain(A, dy), k5.ell_matvec_plain(P, dx), k5.ell_matvec_plain(A, dx)]
    assert all(torch.equal(g, w) for g, w in zip((pr.Ax, pr.Px, pr.Aty, pr.Atdy, pr.Pdx, pr.Adx), want))
    pr = termination.compute_products(data, x, y, y)
    assert pr.Atdy is None and pr.Pdx is None and pr.Adx is None and torch.equal(pr.Aty, want[2])


@pytest.mark.parametrize("n_iters", [0, 1, 10])
def test_ruiz_on_ell_gives_the_bits_of_one_launch_a_norm(n_iters):
    """scale_data on ELL operands, whose sweeps now share launches, against
    the sweeps written one norm at a time as before: c, D, E and the
    scaled data bit for bit."""
    from osqp_tpu_torch.ops.ruiz import limit_scaling

    P, A, _, (q, l, _) = _cg_problem(torch.float64, B=2, seed=5)
    data = QPData(P=P, q=q, A=A, l=l - 1, u=l + 1)
    scaled, scl = scaling.scale_data(data, n_iters)
    B, n = q.shape
    m = l.shape[1]
    c, D, E = torch.ones(B, dtype=q.dtype), torch.ones(B, n, dtype=q.dtype), torch.ones(B, m, dtype=q.dtype)
    Pcol = k5.ell_col_norms_plain(P, D) * D
    for _ in range(n_iters):
        Pn = Pcol * c[:, None]
        d_norm = torch.maximum(Pn, k5.ell_col_norms_plain(A, E) * D)
        e_norm = k5.ell_row_norms_plain(A, D) * E
        D = D * (1.0 / torch.sqrt(limit_scaling(d_norm)))
        E = E * (1.0 / torch.sqrt(limit_scaling(e_norm)))
        Pcol = k5.ell_col_norms_plain(P, D) * D
        c_temp = limit_scaling(torch.maximum((Pcol * c[:, None]).mean(-1), limit_scaling((q.abs() * D).amax(-1) * c)))
        c = c / c_temp
    assert torch.equal(scl.c, c) and torch.equal(scl.D, D) and torch.equal(scl.E, E)
    assert torch.equal(scaled.P.val, k5.ell_scale_plain(P, D, D, c).val)
    assert torch.equal(scaled.A.t_val, k5.ell_scale_plain(A, E, D).t_val)
