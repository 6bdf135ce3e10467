"""osqp_tpu_torch's ``cg`` backend and K6's plain loop against the JAX
package on the CPU, on dense and on ELL operands.

The backend's init, tolerance schedule and floor equal the JAX
package's; K6's plain loop (what its wrapper runs for CPU tensors)
agrees with ``osqp_tpu.linsys.cg.solve`` to 1e-10 in float64 from
identical state, frozen instances and the step cap included; running it
in chunks, as the kernel path does, changes no bit of x.  Then one ADMM
step over cg, the rho-adaptation merge of a cg factor, the warm start,
and whole solves through ``solve_batch`` and ``Solver`` at eps 1e-3 and
1e-6: in float64 the JAX package's status and iterations with x and y
within 1e-6, in float32 its status with iterations within 25.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import osqp_tpu
import osqp_tpu.constants as jcon
from osqp_tpu import admm as jadmm
from osqp_tpu import scaling as jscaling
from osqp_tpu import solver as jsolver
from osqp_tpu import sparse_ops as jsp
from osqp_tpu.batch import solve_batch as jsolve_batch
from osqp_tpu.linsys import cg as jcg
from osqp_tpu.types import DynSettings as JDyn
from osqp_tpu.types import Iterates as JIt
from osqp_tpu.types import QPData as JQP
import osqp_tpu_torch
from osqp_tpu_torch import admm as tadmm
from osqp_tpu_torch import batch as tbatch
from osqp_tpu_torch import convert
from osqp_tpu_torch import solver as tsolver
from osqp_tpu_torch._build import SMEM_BYTES
from osqp_tpu_torch.linsys import cg
from osqp_tpu_torch.ops import cg as k6
from osqp_tpu_torch.sparse_ops import ELLMatrix
from osqp_tpu_torch.types import DynSettings, Iterates, QPData, RhoState, StaticConfig
from test_batch import random_qps
from test_sparse_large import _rand_sparse_qp

torch.set_num_threads(2)

ATOL = 1e-6
CHECK = 25


def _rel(t, j):
    j = np.asarray(j)
    return np.abs(t.numpy() - j).max() / np.abs(j).max()


def _jax_data(kind, dtype="float64", B=4, n=20, m=30, seed=0):
    """Scaled JAX data with dense or ELL operands (B instances)."""
    jd = jnp.dtype(dtype)
    if kind == "dense":
        P, q, A, l, u = random_qps(B, n, m, seed=seed)
        data = JQP(*(jnp.asarray(v, jd) for v in (P, q, A, l, u)))
    else:
        P, q, A, l, u = _rand_sparse_qp(n, m, 0.2, seed)
        qs = np.stack([q * (1 + 0.1 * i) for i in range(B)])
        data = JQP(P=jsp.ell_from_scipy(P, jd, batch=B, sym_from_triu=True), q=jnp.asarray(qs, jd),
                   A=jsp.ell_from_scipy(A, jd, batch=B), l=jnp.asarray(np.tile(l, (B, 1)), jd),
                   u=jnp.asarray(np.tile(u, (B, 1)), jd))
    jdata, _ = jscaling.scale_data(data, 10)
    jrs = jadmm.set_rho_state(jdata, jnp.full((B,), 0.1, jd))
    return jdata, jrs, JDyn.make(jd)


def _port(jdata, jrs, jdyn, jfac, dtype):
    td = getattr(torch, dtype)
    return (convert.from_fields(QPData, jdata, "cpu", td), convert.from_fields(RhoState, jrs, "cpu", td),
            convert.from_fields(DynSettings, jdyn, "cpu", td), convert.factor(jfac, "cpu", td))


# ---------------------------------------------------------------------------
# init, the tolerance schedule and its floor
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["dense", "ell"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_init_matches_reference(kind, dtype):
    jdata, jrs, jdyn = _jax_data(kind, dtype)
    jfac = jcg.init(jdata.P, jdata.A, jdyn.sigma, jrs.rho_vec, cg_max_iter=0, cg_tol_fraction=1e-7)
    data, rs, dyn, _ = _port(jdata, jrs, jdyn, {}, dtype)
    fac = cg.init(data.P, data.A, dyn.sigma, rs.rho_vec, cg_max_iter=0, cg_tol_fraction=1e-7)
    assert set(fac) == set(jfac)
    assert _rel(fac["dinv"], jfac["dinv"]) < (1e-12 if dtype == "float64" else 1e-6)
    np.testing.assert_array_equal(fac["tol_rel"].numpy(), np.asarray(jfac["tol_rel"]))
    for key in ("max_iter", "tol_frac", "sigma"):
        assert fac[key].ndim == 0 and fac[key].device.type == "cpu"
        assert fac[key].item() == pytest.approx(float(jfac[key]), rel=1e-7)
    assert fac["max_iter"].dtype == torch.int32 and int(fac["max_iter"]) == 50
    assert fac["P"] is data.P
    capped = cg.init(data.P, data.A, dyn.sigma, rs.rho_vec, cg_max_iter=7, cg_tol_fraction=1e-1)
    jcapped = jcg.init(jdata.P, jdata.A, jdyn.sigma, jrs.rho_vec, cg_max_iter=7, cg_tol_fraction=1e-1)
    assert int(capped["max_iter"]) == 7
    np.testing.assert_array_equal(capped["tol_rel"].numpy(), np.asarray(jcapped["tol_rel"]))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("tol_frac", [1e-7, 1e-3])
def test_update_tolerance_matches_reference(dtype, tol_frac):
    jdata, jrs, jdyn = _jax_data("dense", dtype)
    jfac = jcg.init(jdata.P, jdata.A, jdyn.sigma, jrs.rho_vec, cg_tol_fraction=tol_frac)
    _, _, dyn, fac = _port(jdata, jrs, jdyn, jfac, dtype)
    ratio = np.array([0.5, 3.0, 1e3, 1e9])
    want = jcg.update_tolerance(jfac, jnp.asarray(ratio), jdyn)["tol_rel"]
    got = cg.update_tolerance(fac, torch.as_tensor(ratio), dyn)["tol_rel"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize(
    "kw",
    [{}, {"eps_abs": 1e-6, "eps_rel": 1e-6}, {"eps_abs": 0.0, "eps_rel": 1e-9}, {"eps_abs": 1e-8},
     {"cg_tol_fraction": 1e-3, "eps_rel": 1e-7}, {"eps_abs": 1e-15, "eps_rel": 0.0}],
)
def test_link_cg_floor_matches_reference(kw):
    js, ts = jsolver.Settings(**kw), tsolver.Settings(**kw)
    assert cg.link_cg_floor(ts) == jcg.link_cg_floor(js)
    assert tsolver.make_config(5, 7, ts, torch.float64).cg_tol_fraction == jsolver.make_config(
        5, 7, js, "float64").cg_tol_fraction


# ---------------------------------------------------------------------------
# K6's plain loop against the JAX solve
# ---------------------------------------------------------------------------
def _solve_case(kind, tol_rel, cg_max_iter=0, seed=1):
    jdata, jrs, jdyn = _jax_data(kind, seed=seed)
    jfac = jcg.init(jdata.P, jdata.A, jdyn.sigma, jrs.rho_vec, cg_max_iter=cg_max_iter)
    jfac = {**jfac, "tol_rel": jnp.asarray(tol_rel)}
    B, n = jdata.q.shape
    m = jdata.l.shape[1]
    rng = np.random.default_rng(seed)
    rhs_x, rhs_z, x0 = rng.standard_normal((B, n)), rng.standard_normal((B, m)), rng.standard_normal((B, n))
    return jdata, jrs, jdyn, jfac, rhs_x, rhs_z, x0


@pytest.mark.parametrize("kind", ["dense", "ell"])
@pytest.mark.parametrize("case", ["converge", "freeze", "step_cap"])
def test_cg_solve_matches_reference(kind, case):
    """x and z~ within 1e-10 of the JAX solve in float64: every instance
    converging; instances converging at very different steps (one frozen
    from the start keeps x0 bit for bit); and a solve cut at 3 steps."""
    tol_rel = {"converge": [1e-10] * 4, "freeze": [1e-10, 1e-4, 1e-2, 1e3], "step_cap": [1e-10] * 4}[case]
    jdata, jrs, jdyn, jfac, rhs_x, rhs_z, x0 = _solve_case(kind, tol_rel, cg_max_iter=3 if case == "step_cap" else 0)
    jx, jz = jcg.solve(jfac, jdata.A, jrs.rho_vec, jnp.asarray(rhs_x), jnp.asarray(rhs_z), x0=jnp.asarray(x0))
    data, rs, dyn, fac = _port(jdata, jrs, jdyn, jfac, "float64")
    T = torch.as_tensor
    x, z = cg.solve(fac, data.A, rs.rho_vec, T(rhs_x), T(rhs_z), x0=T(x0))
    assert _rel(x, jx) < 1e-10 and _rel(z, jz) < 1e-10
    b = T(rhs_x) + (osqp_tpu_torch.linalg.mat_tvec(data.A, rs.rho_vec * T(rhs_z)))
    _, steps = k6.cg_solve_plain(fac["P"], data.A, fac["sigma"], rs.rho_vec, fac["dinv"], b, T(x0), fac["tol_rel"],
                                 int(fac["max_iter"]))
    if case == "freeze":
        assert torch.equal(x[3], T(x0[3])) and steps[3] == 0
        assert steps[0] > steps[1] > steps[2] > 0
    if case == "step_cap":
        assert steps.tolist() == [3] * 4


@pytest.mark.parametrize("kind", ["dense", "ell"])
@pytest.mark.parametrize("max_iter", [11, 1000])
def test_chunked_stop_test_changes_no_bit(kind, max_iter):
    """The plain loop tested once per CHUNK steps, as the kernel path runs,
    against the loop tested at every step: x bit-identical and the same
    steps, also when a chunk would pass max_iter (11 = 8 + 3)."""
    jdata, jrs, jdyn, jfac, rhs_x, rhs_z, x0 = _solve_case(kind, [1e-10, 1e-5, 1e-3, 1e3], seed=2)
    data, rs, dyn, fac = _port(jdata, jrs, jdyn, jfac, "float64")
    T = torch.as_tensor
    b = T(rhs_x) + osqp_tpu_torch.linalg.mat_tvec(data.A, rs.rho_vec * T(rhs_z))
    args = (fac["P"], data.A, fac["sigma"], rs.rho_vec, fac["dinv"], b, T(x0), fac["tol_rel"], max_iter)
    x1, s1 = k6.cg_solve_plain(*args)
    xc, sc = k6.cg_solve_plain(*args, chunk=k6.CHUNK)
    assert torch.equal(x1, xc) and torch.equal(s1, sc)
    assert int(s1.max()) <= max_iter and (max_iter > 11 or int(s1.max()) == 11)
    # the wrapper on CPU tensors is the step-by-step loop
    xw, sw = k6.cg_solve(*args)
    assert torch.equal(xw, x1) and torch.equal(sw, s1)


def test_cg_solve_checks_its_inputs():
    jdata, jrs, jdyn, jfac, rhs_x, rhs_z, x0 = _solve_case("dense", [1e-8] * 4)
    data, rs, dyn, fac = _port(jdata, jrs, jdyn, jfac, "float64")
    b = torch.as_tensor(rhs_x)
    with pytest.raises(ValueError, match="dinv"):
        k6.cg_solve(fac["P"], data.A, fac["sigma"], rs.rho_vec, fac["dinv"][:, :-1], b, None, fac["tol_rel"], 5)
    with pytest.raises(ValueError, match="tol_rel"):
        k6.cg_solve(fac["P"], data.A, fac["sigma"], rs.rho_vec, fac["dinv"], b, None, fac["tol_rel"].float(), 5)


def _ell_system(dtype=torch.float64, B=3, n=60, m=40, seed=4):
    """ELL operands (P symmetric, A) of random sparse data, B copies, with
    rho, a mask of A's rows, b and x0."""
    from osqp_tpu_torch.sparse_ops import ell_from_scipy

    rng = np.random.default_rng(seed)
    M = sp.random(n, n, density=4.0 / n, random_state=rng)
    Pm = sp.triu(M @ M.T + 0.1 * sp.eye(n), format="csr")
    Am = sp.random(m, n, density=4.0 / n, random_state=rng, format="csr")
    P = ell_from_scipy(Pm, dtype, batch=B, sym_from_triu=True).contiguous()
    A = ell_from_scipy(Am, dtype, batch=B).contiguous()
    T = lambda a: torch.as_tensor(a, dtype=dtype)
    return (P, A, T(rng.random((B, m)) + 0.1), T(rng.random((B, m)) < 0.5), T(rng.standard_normal((B, n))),
            T(rng.standard_normal((B, n))))


def test_pcg_takes_the_device_loop_for_ell_operators_only():
    """pcg_solve's path follows the operator's type: the plain loop on the
    CPU; on the card the device loop for an EllOperator (the sparse path's
    cg backend and polish), the dense loop for a DenseOperator (the cg
    backend on dense operands; its operator in a trace), the step kernels
    for any other operator (a row-sharded A's products)."""
    P, A, rho, *_ = _ell_system()
    op = k6.EllOperator(P, A, w=rho)
    dense = lambda p: (p, None)
    assert k6._route(op, "cuda") is k6.pcg_solve_loop
    assert k6._route(dense, "cuda") is k6.pcg_solve_stepwise
    assert k6._route(op.plain, "cuda") is k6.pcg_solve_stepwise
    assert k6._route(op, "cpu") is k6.pcg_solve_plain and k6._route(dense, "cpu") is k6.pcg_solve_plain
    with pytest.raises(ValueError, match="CPU or CUDA"):
        k6._route(op, "meta")
    # the cg backend hands ELL operands over as an EllOperator, dense ones as a DenseOperator
    assert k6._operator(P, A, rho, plain=False) == op
    Pd, Ad = torch.eye(4, dtype=torch.float64)[None], torch.ones((1, 2, 4), dtype=torch.float64)
    assert not isinstance(k6._operator(Pd, Ad, torch.ones((1, 2), dtype=torch.float64), plain=False),
                          k6.EllOperator)
    dense_op = k6._operator(Pd, Ad, torch.ones((1, 2), dtype=torch.float64), plain=False)
    assert isinstance(dense_op, k6.DenseOperator)
    assert k6._route(dense_op, "cuda") is k6.pcg_solve_dense_loop
    assert k6._route(dense_op, "cuda", traced=True) is k6.pcg_solve_dense_loop_op
    assert k6._route(dense_op, "cpu") is k6.pcg_solve_plain


def test_ell_operator_computes_both_forms_as_their_plain_versions():
    """The cg form, P p and A'(rho * A p) through K5's weighted transpose,
    and polish's form, P p and A'(A p) / d divided after the product: each
    bit for bit the composition of K5's functions; no rows of A, no V p."""
    from osqp_tpu_torch.ops import ell as k5

    P, A, rho, mask, p, _ = _ell_system()
    u, v = k6.EllOperator(P, A, w=rho)(p)
    assert torch.equal(u, k5.ell_matvec(P, p)) and torch.equal(v, k5.ell_tmatvec(A, k5.ell_matvec(A, p), rho))
    d = torch.tensor(1e-6, dtype=torch.float64)
    MA = k5.ell_scale(A, mask, torch.ones_like(p))
    u, v = k6.EllOperator(P, MA, div=d)(p)
    assert torch.equal(v, k5.ell_tmatvec(MA, k5.ell_matvec(MA, p)) / d)
    u2, v2 = k6.EllOperator(P, MA, div=d).plain(p)
    assert torch.equal(u, u2) and torch.equal(v, v2)
    from osqp_tpu_torch.sparse_ops import ell_from_scipy

    empty = ell_from_scipy(sp.csr_matrix((0, p.shape[1])), torch.float64, batch=p.shape[0]).contiguous()
    assert k6.EllOperator(P, empty, div=d)(p)[1] is None
    for kw in ({}, {"w": rho, "div": d}):
        with pytest.raises(ValueError, match="exactly one"):
            k6.EllOperator(P, A, **kw)


def _loop_args(**change):
    P, A, rho, _, b, x0 = _ell_system()
    B, n = b.shape
    args = dict(op=k6.EllOperator(P, A, w=rho), sigma=1e-6, dinv=torch.ones_like(b), b=b,
                tol_rel=torch.full((B,), 1e-8, dtype=b.dtype), max_iter=10, x0=x0)
    args.update({k: (v(args) if callable(v) else v) for k, v in change.items()})
    return args


@pytest.mark.parametrize(
    "change,error,match",
    [
        ({}, ValueError, "CUDA tensors"),
        ({"op": lambda a: (lambda p: (p, None))}, TypeError, "EllOperator"),
        ({"op": lambda a: dataclasses.replace(a["op"], P=torch.eye(60, dtype=torch.float64)[None])}, TypeError,
         "ELLMatrix"),
        ({"b": lambda a: a["b"][:2]}, ValueError, "over 3 instances"),
        ({"dinv": lambda a: a["dinv"][:, :-1]}, ValueError, "dinv"),
        ({"tol_rel": lambda a: a["tol_rel"].float()}, ValueError, "tol_rel"),
        ({"op": lambda a: dataclasses.replace(a["op"], w=a["op"].w[:, :-1])}, ValueError, "w is"),
    ],
)
def test_device_loop_rejects_bad_input(change, error, match):
    """The loop's wrapper checks the operator's type, the operands' shapes
    and types against b, and that everything is on the card, before it
    builds or launches anything."""
    with pytest.raises(error, match=match):
        k6.pcg_solve_loop(**_loop_args(**change))


@pytest.mark.parametrize("form", ["cg", "polish"])
@pytest.mark.parametrize("max_iter", [11, 1000])
@pytest.mark.parametrize("dot", ["kernel", "torch"])
def test_chunked_stop_test_changes_no_bit_in_either_operator_form(form, max_iter, dot):
    """The plain loop tested at every step, as the device loop tests,
    against the loop tested once per CHUNK steps, as the stepwise path
    does, over each ELL operator form: the same steps and x bit for bit
    (an instance frozen from the start included)."""
    from osqp_tpu_torch.ops import ell as k5

    P, A, rho, mask, b, x0 = _ell_system(B=4, seed=5)
    B, n = b.shape
    if form == "cg":
        op, sigma = k6.EllOperator(P, A, w=rho), torch.tensor(1e-6, dtype=torch.float64)
        dinv = 1.0 / (k5.ell_diagonal(P) + sigma + k5.ell_sq_colsums(A, rho))
    else:
        sigma = torch.tensor(1e-4, dtype=torch.float64)
        MA = k5.ell_scale(A, mask, torch.ones_like(b))
        op = k6.EllOperator(P, MA, div=sigma)
        dinv = 1.0 / (k5.ell_diagonal(P) + sigma + k5.ell_sq_colsums(MA, torch.ones_like(rho)) / sigma)
    tol = torch.tensor([1e-12, 1e-6, 1e-3, 1e9], dtype=torch.float64)
    kw = dict(dot=k6.kernel_dot) if dot == "kernel" else {}
    x1, s1 = k6.pcg_solve_plain(op, sigma, dinv, b, tol, max_iter, x0, chunk=1, **kw)
    xc, sc = k6.pcg_solve_plain(op, sigma, dinv, b, tol, max_iter, x0, chunk=k6.CHUNK, **kw)
    assert torch.equal(s1, sc) and torch.equal(x1, xc)
    assert int(s1.max()) <= max_iter and int(s1[-1]) == 0 and torch.equal(x1[-1], x0[-1])
    assert int(s1.max()) > 0


# ---------------------------------------------------------------------------
# The device loop's plan and its per-instance stop
# ---------------------------------------------------------------------------
MAROS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "maros_mm")


def _maros_widths(name):
    """(n, m, kp, ka, kt) of a Maros-Meszaros problem's ELL operands."""
    from osqp_tpu_torch.io.qps import load_qps
    from osqp_tpu_torch.sparse_ops import ell_from_scipy

    qp = load_qps(os.path.join(MAROS, f"{name}.qps"))
    P = ell_from_scipy(sp.triu(qp.P, format="csr"), torch.float64, sym_from_triu=True)
    A = ell_from_scipy(qp.A, torch.float64)
    return qp.P.shape[0], qp.A.shape[0], P.idx.shape[1], A.idx.shape[1], A.t_idx.shape[1]


@pytest.mark.parametrize(
    "name,dtype,cluster,resident",
    [("CVXQP2_L", "float64", 14, True), ("CVXQP2_L", "float32", 14, True), ("LISWET1", "float64", 14, True),
     ("LISWET1", "float32", 14, True), ("DTOC3", "float64", 15, True), ("DTOC3", "float32", 15, True),
     ("CVXQP3_L", "float64", 14, False), ("CVXQP3_L", "float32", 14, True)],
)
def test_loop_plan_spreads_one_instance_over_a_cluster(name, dtype, cluster, resident):
    """At B = 1 the plan spreads the instance over the fewest CTAs that
    keep 16's most parts a CTA (CVXQP2_L's 40 parts over 14, DTOC3's 59
    over 15), 256 threads a part up to four, its vectors in shared memory
    and its operands too where they fit (CVXQP3_L's do not in float64)."""
    n, m, kp, ka, kt = _maros_widths(name)
    plan = k6.loop_plan(1, n, m, kp, ka, kt, dtype, 132)
    itemsize = 8 if dtype == "float64" else 4
    assert (plan.cluster, plan.resident, plan.vectors, plan.clusters) == (cluster, resident, True, 1)
    assert plan.threads == 256 * min(4, -(-k6.parts_of(n) // cluster))
    assert plan.smem == k6.loop_smem(n, m, kp, ka, kt, cluster, resident, True, itemsize) <= SMEM_BYTES
    assert (k6.loop_smem(n, m, kp, ka, kt, cluster, True, True, itemsize) <= SMEM_BYTES) == resident


def test_loop_plan_keeps_the_vectors_in_device_memory_where_no_cluster_holds_them():
    """n = 2e5 in float64: no cluster's shared memory holds the vectors,
    so they stay in device memory, on the widest cluster; its shared
    memory holds the partials alone."""
    plan = k6.loop_plan(1, 200_000, 150_000, 9, 3, 5, torch.float64, 132)
    assert (plan.cluster, plan.resident, plan.vectors) == (16, False, False)
    assert plan.smem == k6.loop_smem(200_000, 150_000, 9, 3, 5, 16, False, False, 8) < 4096
    assert k6.loop_smem(200_000, 150_000, 9, 3, 5, 16, False, True, 8) > SMEM_BYTES


def test_loop_plan_shrinks_the_cluster_for_batches_above_the_clusters_at_once():
    """Where the card holds fewer clusters than B (the occupancy query,
    here given), the plan takes the cluster size with the fewest waves of
    clusters over the batch, the largest among them; it never takes a
    cluster that the card cannot hold, and the vectors leave shared memory
    only where no cluster holds them."""
    widths = _maros_widths("CVXQP2_L")
    held = {14: 7, 8: 16, 4: 33, 2: 66, 1: 132}
    active = lambda cluster, threads, smem, resident, vectors: held[cluster]  # noqa: E731
    plan = k6.loop_plan(8, *widths, torch.float64, 132, active)
    assert (plan.cluster, plan.clusters) == (8, 8)
    plan = k6.loop_plan(7, *widths, torch.float64, 132, active)
    assert (plan.cluster, plan.clusters) == (14, 7)
    # 200 instances: 7 waves at a cluster of 4, the narrowest whose CTAs
    # hold the vectors (2 would take 4 waves with the vectors in device
    # memory)
    plan = k6.loop_plan(200, *widths, torch.float64, 132, active)
    assert (plan.cluster, plan.clusters, plan.vectors) == (4, 33, True)
    assert k6.loop_smem(*widths, 2, False, True, 8) > SMEM_BYTES
    plan = k6.loop_plan(1, *widths, torch.float64, 132, lambda c, t, s, r, v: 0 if c == 14 else 1)
    assert plan.cluster == 8
    with pytest.raises(RuntimeError, match="no plan"):
        k6.loop_plan(1, *widths, torch.float64, 132, lambda c, t, s, r, v: 0)
    # the estimate without the query, by the SMs' shared memory and
    # threads: 64 instances in two waves of 33 clusters of 8, two CTAs of
    # 1024 threads an SM with the operands read from device memory, where
    # clusters of 14 with resident operands (one CTA an SM) would take 8
    plan = k6.loop_plan(64, *widths, torch.float64, 132)
    assert (plan.cluster, plan.resident, plan.threads, plan.clusters) == (8, False, 1024, 33)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_loop_plan_without_constraints(dtype):
    """m = 0: no rows of A in the plan's shared memory, and a cluster no
    wider than the parts (3000 variables: 12 parts, 6 CTAs of 2)."""
    plan = k6.loop_plan(3, 3000, 0, 4, 1, 1, dtype, 132)
    itemsize = 8 if dtype == "float64" else 4
    assert (plan.cluster, plan.threads, plan.resident, plan.clusters) == (6, 512, True, 3)
    assert plan.smem == k6.loop_smem(3000, 0, 4, 1, 1, 6, True, True, itemsize)
    assert plan.smem < k6.loop_smem(3000, 1, 4, 1, 1, 6, True, True, itemsize)
    assert k6.loop_plan(1, 20, 0, 3, 1, 1, dtype, 132).cluster == 1


@pytest.mark.parametrize("form", ["cg", "polish"])
def test_each_instance_alone_gives_the_batch_its_bits(form):
    """The device loop stops each instance at its own freeze (or at
    max_iter) where the batch loop stopped all of them at the last one's:
    a frozen instance keeps its x bit for bit.  So each instance run alone
    through pcg_solve_plain(dot=kernel_dot) gives the batch's x bit for
    bit and its steps exactly, in both operator forms."""
    import dataclasses as dc

    from osqp_tpu_torch.ops import ell as k5

    B = 5
    P, A, rho, mask, b, x0 = _ell_system(B=B, seed=9)
    scale = torch.linspace(1.0, 2.0, B, dtype=torch.float64)[:, None, None]
    P = dc.replace(P, val=P.val * scale, t_val=P.t_val * scale)
    if form == "cg":
        sigma = torch.tensor(1e-6, dtype=torch.float64)
        op = k6.EllOperator(P, A, w=rho)
        dinv = 1.0 / (k5.ell_diagonal(P) + sigma + k5.ell_sq_colsums(A, rho))
        max_iter = 45
    else:
        sigma = torch.tensor(1e-2, dtype=torch.float64)
        op = k6.EllOperator(P, k5.ell_scale(A, mask, torch.ones_like(b)), div=sigma)
        dinv = 1.0 / (k5.ell_diagonal(P) + sigma + k5.ell_sq_colsums(op.A, torch.ones_like(rho)) / sigma)
        max_iter = 120
    tol = torch.tensor([1e-12, 1e-6, 1e-3, 1e9, 1e-2], dtype=torch.float64)
    xb, sb = k6.pcg_solve_plain(op, sigma, dinv, b, tol, max_iter, x0, dot=k6.kernel_dot)
    assert len(set(sb.tolist())) == B and int(sb.max()) == max_iter and int(sb.min()) == 0
    one = lambda M, i: dc.replace(M, val=M.val[i:i + 1], t_val=M.t_val[i:i + 1])  # noqa: E731
    for i in range(B):
        op_i = dc.replace(op, P=one(op.P, i), A=one(op.A, i), w=op.w[i:i + 1] if op.w is not None else None)
        xi, si = k6.pcg_solve_plain(op_i, sigma, dinv[i:i + 1], b[i:i + 1], tol[i:i + 1], max_iter, x0[i:i + 1],
                                    dot=k6.kernel_dot)
        assert int(si[0]) == int(sb[i]) and torch.equal(xi[0], xb[i])


# ---------------------------------------------------------------------------
# In the ADMM loop
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["dense", "ell"])
def test_admm_step_over_cg_matches_reference(kind):
    """One ADMM step over cg against the JAX package's to 1e-10: the
    previous x warm-starts the solve.  A cold start lands elsewhere by
    the CG tolerance, far more than 1e-10."""
    jdata, jrs, jdyn = _jax_data(kind, seed=3)
    jfac = jcg.init(jdata.P, jdata.A, jdyn.sigma, jrs.rho_vec)
    B, n = jdata.q.shape
    m = jdata.l.shape[1]
    rng = np.random.default_rng(3)
    x, z, y = rng.standard_normal((B, n)), rng.standard_normal((B, m)), rng.standard_normal((B, m))
    jit_new, jdx, jdy, _ = jadmm.admm_step(jcg, jfac, jdata, jdyn, jrs, JIt(*(jnp.asarray(v) for v in (x, z, y))))
    data, rs, dyn, fac = _port(jdata, jrs, jdyn, jfac, "float64")
    T = torch.as_tensor
    it, dx, dy, _ = tadmm.admm_step(cg.solve, fac, data, dyn, rs, Iterates(T(x), T(z), T(y)))
    for g, w in zip((it.x, it.z, it.y, dx, dy), (jit_new.x, jit_new.z, jit_new.y, jdx, jdy)):
        assert _rel(g, w) < 1e-10
    cold = lambda *a, x0=None: cg.solve(*a)
    it_cold, *_ = tadmm.admm_step(cold, fac, data, dyn, rs, Iterates(T(x), T(z), T(y)))
    assert _rel(it_cold.x, jit_new.x) > 1e-10


def test_warm_start_cuts_the_steps_late_in_a_solve():
    """Late in a solve the previous x is close to the new x~: the
    warm-started CG takes a fraction of the cold-started one's steps."""
    P, q, A, l, u = _rand_sparse_qp(400, 600, 0.01, seed=0)
    s, dtype, cfg, dyn, P_ell, A_ell, q, l, u = osqp_tpu_torch.large.prepare_sparse(
        P, q, A, l, u, {"dtype": "float64", "eps_abs": 1e-6, "eps_rel": 1e-6, "verbose": False})
    T = lambda a: torch.as_tensor(a, dtype=dtype)
    scaled, scl, rs, fac, it = tbatch._prepare(cfg, 10, P_ell, T(q), A_ell, T(l), T(u), T([0.1]), dyn, None, None)
    c = tadmm.run_segment(cfg, scaled, scl, dyn, tadmm.init_carry(cfg, scaled, rs, fac, it), 200)
    assert c.any_active
    rs, fac = c.rho_state, c.factor
    rhs_x = dyn.sigma * c.it.x - scaled.q
    b = rhs_x + osqp_tpu_torch.ops.ell.ell_tmatvec(scaled.A, c.it.z - rs.rho_inv_vec * c.it.y, rs.rho_vec)
    args = (fac["P"], scaled.A, fac["sigma"], rs.rho_vec, fac["dinv"], b)
    _, warm = k6.cg_solve(*args, c.it.x, fac["tol_rel"], int(fac["max_iter"]))
    _, cold = k6.cg_solve(*args, None, fac["tol_rel"], int(fac["max_iter"]))
    assert 0 < int(warm[0]) * 3 <= int(cold[0]), (int(warm[0]), int(cold[0]))


def test_rho_adaptation_merges_a_cg_factor_on_ell_operands():
    """A rho update refactors cg per instance: dinv and tol_rel of the
    updated instances only (tol_rel back to init's value); the ELL
    operand and the 0-d leaves pass through whole."""
    jdata, jrs, jdyn = _jax_data("ell", seed=5)
    jfac = jcg.init(jdata.P, jdata.A, jdyn.sigma, jrs.rho_vec)
    data, rs, dyn, fac = _port(jdata, jrs, jdyn, jfac, "float64")
    B, n = data.q.shape
    m = data.l.shape[1]
    fac = {**fac, "tol_rel": torch.full((B,), 1e-3, dtype=torch.float64)}
    cfg = StaticConfig(n=n, m=m, linsys_solver="cg")
    rng = np.random.default_rng(5)
    x, y = torch.as_tensor(rng.standard_normal((B, n))), torch.as_tensor(rng.standard_normal((B, m)))
    # z = A x, no primal residual: the rho estimate falls out of the tolerance band
    c = tadmm.init_carry(cfg, data, rs, fac, Iterates(x, osqp_tpu_torch.linalg.mat_vec(data.A, x), y))
    active = torch.arange(B) % 2 == 0
    out = tadmm._apply_rho_adaptation(cfg, data, dyn, dataclasses.replace(c, active=active))
    upd = out.info.rho_updates > 0
    assert upd.any() and not upd[~active].any()
    assert isinstance(out.factor["P"], ELLMatrix) and out.factor["P"] is data.P
    for key in ("sigma", "max_iter", "tol_frac"):
        assert out.factor[key].ndim == 0
    fresh = cg.init(data.P, data.A, dyn.sigma, out.rho_state.rho_vec)
    for key in ("dinv", "tol_rel"):
        assert torch.equal(out.factor[key][upd], fresh[key][upd])
        assert torch.equal(out.factor[key][~upd], fac[key][~upd])


@pytest.mark.parametrize("eps,dtype", [(1e-3, "float64"), (1e-6, "float64"), (1e-3, "float32")])
def test_solve_batch_cg_matches_reference(eps, dtype):
    P, q, A, l, u = random_qps(4, 12, 18, seed=11)
    kw = dict(dtype=dtype, verbose=False, linsys_solver="cg", eps_abs=eps, eps_rel=eps)
    rj = jsolve_batch(P, q, A, l, u, **kw)
    rt = osqp_tpu_torch.solve_batch(P, q, A, l, u, device="cpu", **kw)
    np.testing.assert_array_equal(rt.status_val.numpy(), np.asarray(rj.status_val))
    assert (rt.status_val == jcon.OSQP_SOLVED).all()
    if dtype == "float64":
        np.testing.assert_array_equal(rt.iter.numpy(), np.asarray(rj.iter))
        np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=ATOL)
        np.testing.assert_allclose(rt.y.numpy(), np.asarray(rj.y), atol=ATOL)
    else:
        assert np.abs(rt.iter.numpy() - np.asarray(rj.iter)).max() <= CHECK


@pytest.mark.parametrize("eps", [1e-3, 1e-6])
def test_solver_cg_matches_reference(eps):
    """The stateful Solver over cg, then a tightened eps_abs, whose
    refreshed cg floor the next solve runs under."""
    P, q, A, l, u = _rand_sparse_qp(20, 30, 0.2, seed=12)
    kw = dict(dtype="float64", verbose=False, linsys_solver="cg", eps_abs=eps, eps_rel=eps)
    js = osqp_tpu.Solver(P, q, A, l, u, **kw)
    ts = osqp_tpu_torch.Solver(P, q, A, l, u, device="cpu", **kw)
    for step in range(2):
        rj, rt = js.solve(), ts.solve()
        assert rt.info.status_val == rj.info.status_val == jcon.OSQP_SOLVED
        assert (rt.info.iter, rt.info.rho_updates) == (rj.info.iter, rj.info.rho_updates)
        np.testing.assert_allclose(rt.x, rj.x, atol=ATOL)
        np.testing.assert_allclose(rt.y, rj.y, atol=ATOL)
        if step == 0:
            js.update_eps_abs(eps * 1e-2)
            ts.update_eps_abs(eps * 1e-2)
            assert ts._cfg.cg_tol_fraction == js._cfg.cg_tol_fraction
            assert float(ts.factor["tol_frac"]) == pytest.approx(float(js.factor["tol_frac"]))
