"""K6's dense loop (``csrc/cg_dense.cu``) on the CPU: its plan, the order
of its products and its plain twin.

The loop runs only on the card; here its plan (``ops.cg.dense_loop_plan``,
a pure function of the shapes, the dtype and the SM count) is held to
shared-memory counts written out by hand, ``DenseOperator.ordered`` (the
products in the loop's order) to a scalar rendering of that order and to
the batched GEMVs within a few ulps a product, and the loop's plain twin
``pcg_solve_plain(op.ordered, ..., dot=kernel_dot, start_dot=kernel_dot)``
to the JAX package's ``osqp_tpu.linsys.cg.solve`` in float64 and to
itself run an instance at a time.
"""

import numpy as np
import pytest
import torch

from osqp_tpu.linsys import cg as jcg
from osqp_tpu_torch import _build
from osqp_tpu_torch.linsys import cg as cg_backend
from osqp_tpu_torch.ops import cg as k6

torch.set_num_threads(2)

H100_SMS = 132


# ---------------------------------------------------------------------------
# (a) the plan
# ---------------------------------------------------------------------------
# (B, n, m, dtype) -> (cluster, threads, resident, smem): each count is
# 16 bytes of mbarriers and the values 8 + 2 * 64 + 2 * parts * 8 (scalars,
# the two sums' partials and warps' sums), (6 + 16 / C) n (x r z p dinv Mp
# and the CTA's leaves' partials) and 2 rows of A a CTA (weights and
# w A p), rounded up to 16 bytes; resident plans add the CTA's rows of P
# and of A, each with 32 bytes to spare, rounded up to 16.  A's rows fall
# in S = 16 sub-slabs of RS = ceil(m / 16) rows, 16 / C of them a CTA.
PLANS = [
    # headline f32: clusters of 2, 50 rows of P, 8 sub-slabs of 13 rows of A
    ((8192, 100, 200, "float32"), (2, 256, True, (16 + 4 * (8 + 128 + 16 + 14 * 100 + 2 * 104))
                                   + (4 * 50 * 100 + 32) + (4 * 104 * 100 + 32))),
    # headline f64: clusters of 4, 25 rows of P, 4 sub-slabs of 13 rows
    ((8192, 100, 200, "float64"), (4, 256, True, (16 + 8 * (8 + 128 + 16 + 10 * 100 + 2 * 52))
                                   + (8 * 25 * 100 + 32) + (8 * 52 * 100 + 32))),
    # the MPC cell's shape f32: clusters of 16 (two CTAs an SM, so 256
    # threads), 24 rows of P, one sub-slab of 39 rows; parts = 2; the
    # values' bytes 11416 rounded up to 11424
    ((1000, 372, 612, "float32"), (16, 256, True, 11424 + (4 * 24 * 372 + 32) + (4 * 39 * 372 + 32))),
    # CVXQP2_M's shape f64 at B=1 (14 MB of operands): streamed over 16
    # CTAs of 768 threads, one sub-slab of 47 rows a CTA, parts = 4
    ((1, 1000, 750, "float64"), (16, 768, False, 16 + 8 * (8 + 128 + 64 + 7 * 1000 + 2 * 47))),
    # n=1000, m=8000 f64 at B=1 (72 MB): streamed, 500 rows of A a CTA
    ((1, 1000, 8000, "float64"), (16, 768, False, 16 + 8 * (8 + 128 + 64 + 7 * 1000 + 2 * 500))),
]


@pytest.mark.parametrize("shape,want", PLANS)
def test_dense_loop_plan_by_shape(shape, want):
    B, n, m, dtype = shape
    cluster, threads, resident, smem = want
    plan = k6.dense_loop_plan(B, n, m, dtype, H100_SMS)
    assert (plan.cluster, plan.threads, plan.resident, plan.vectors, plan.smem) == (cluster, threads, resident,
                                                                                   True, smem)
    assert plan.smem <= _build.SMEM_BYTES and 1 <= plan.clusters <= B
    itemsize = 4 if dtype == "float32" else 8
    assert plan.smem == k6.dense_loop_smem(n, m, cluster, resident, True, itemsize)


def test_dense_loop_plan_weighs_the_headline_cuts():
    """At the f32 headline one CTA of 132 KB an instance holds one CTA an
    SM (132 clusters at once); clusters of two CTAs of 67 KB hold three an
    SM (198 clusters): fewer waves over 8192 instances, so two.  A resident
    plan goes before a streamed one with more clusters (f64: 4 CTAs
    resident, 99 clusters, against one streamed CTA, 528); the card's own
    count of clusters decides where it is given; a cluster is never wider
    than DENSE_MIN_WORK multiply-adds a CTA allow."""
    one = k6.dense_loop_smem(100, 200, 1, True, True, 4)
    assert one == 16 + 4 * (8 + 128 + 16 + 22 * 100 + 2 * 208 + 2 * 100) + (4 * 100 * 100 + 32) + (4 * 208 * 100 + 32)
    assert _build.SMEM_PER_SM // (one + _build.SMEM_RESERVED_PER_BLOCK) == 1
    two = k6.dense_loop_plan(8192, 100, 200, "float32", H100_SMS)
    assert _build.SMEM_PER_SM // (two.smem + _build.SMEM_RESERVED_PER_BLOCK) == 3 and two.clusters == 198
    f64 = k6.dense_loop_plan(8192, 100, 200, "float64", H100_SMS)
    streamed = k6.dense_loop_smem(100, 200, 1, False, True, 8)
    assert f64.resident and f64.clusters == 99 and streamed < f64.smem
    seen = []
    active = lambda cluster, threads, smem, resident, vectors: seen.append(cluster) or (9 if cluster == 1 else 1)  # noqa: E731
    assert k6.dense_loop_plan(8192, 100, 200, "float32", H100_SMS, active).cluster == 1
    assert max(seen) <= 100 * (100 + 400) // k6.DENSE_MIN_WORK
    assert k6.dense_loop_plan(4, 20, 30, "float64", H100_SMS).cluster == 1
    assert k6.dense_loop_plan(3, 40, 0, "float32", H100_SMS).resident


# ---------------------------------------------------------------------------
# (b) the products in the loop's order
# ---------------------------------------------------------------------------
def _system(B, n, m, dtype, seed=0):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((B, n, n))
    P = M @ M.transpose(0, 2, 1) / n + 0.1 * np.eye(n)
    A = rng.standard_normal((B, m, n)) / np.sqrt(n)
    w = rng.random((B, m)) + 0.1
    T = lambda a: torch.as_tensor(a, dtype=dtype)  # noqa: E731
    return k6.DenseOperator(T(P), T(A), T(w)), T(rng.standard_normal((B, n)))


def _scalar_order(P, A, w, p):
    """The loop's products of one instance, a scalar at a time in numpy's
    type (each product and sum rounded on its own): a row by 32 lanes
    adding entries l, l + 32, ... then the xor butterfly's lane 0; A' by
    up to 16 sub-slabs, each column of a sub-slab adding its rows in order,
    the partials the leaves of a pairwise tree of 16 (+0 past the
    sub-slabs)."""
    t = P.dtype.type
    n, m = P.shape[0], A.shape[0]

    def row(r):
        lanes = [t(0)] * 32
        for k in range(-(-n // 32)):
            for lane in range(32):
                j = lane + 32 * k
                lanes[lane] = t(lanes[lane] + (t(r[j] * p[j]) if j < n else t(0)))
        for off in (16, 8, 4, 2, 1):
            lanes = [t(lanes[lane] + lanes[lane ^ off]) for lane in range(32)]
        return lanes[0]

    u = np.array([row(P[i]) for i in range(n)], dtype=t)
    if not m:
        return u, None
    v = np.array([t(w[j] * row(A[j])) for j in range(m)], dtype=t)
    S, RS = k6.dense_slabs(m)
    total = np.zeros(n, dtype=t)
    for i in range(n):
        leaves = [t(0)] * 16
        for s in range(S):
            acc = t(0)
            for jj in range(RS):
                j = s * RS + jj
                acc = t(acc + (t(A[j, i] * v[j]) if j < m else t(0)))
            leaves[s] = acc
        while len(leaves) > 1:
            leaves = [t(leaves[2 * k] + leaves[2 * k + 1]) for k in range(len(leaves) // 2)]
        total[i] = leaves[0]
    return u, total


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n,m", [(37, 21), (70, 5), (9, 0)])
def test_ordered_products_are_the_loops_order(dtype, n, m):
    """DenseOperator.ordered, bit for bit, against the loop's order written
    out a scalar at a time (a ragged last chunk of 32, sub-slabs of
    ceil(m / 16) rows with a short last one, m < 16, m = 0)."""
    op, p = _system(2, n, m, dtype, seed=n + m)
    u, v = op.ordered(p)
    for b in range(2):
        su, sv = _scalar_order(op.P[b].numpy(), op.A[b].numpy(), op.w[b].numpy(), p[b].numpy())
        assert np.array_equal(u[b].numpy(), su)
        if m:
            assert np.array_equal(v[b].numpy(), sv)
        else:
            assert v is None


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_ordered_products_agree_with_the_gemvs(dtype):
    """ordered against the batched GEMVs (DenseOperator's __call__): each
    product within a few ulps of its terms' magnitude, n + 2 for P p and
    m + n + 2 for V p (the two orders' rounding bounds summed)."""
    B, n, m = 3, 100, 200
    op, p = _system(B, n, m, dtype)
    eps = torch.finfo(dtype).eps
    u, v = op(p)
    uo, vo = op.ordered(p)
    scale_u = torch.bmm(op.P.abs(), p.abs()[:, :, None])[:, :, 0]
    Ap = torch.bmm(op.A.abs(), p.abs()[:, :, None])[:, :, 0]
    scale_v = torch.bmm((op.w * Ap)[:, None, :], op.A.abs())[:, 0]
    assert ((u - uo).abs() <= 2 * (n + 2) * eps * scale_u).all()
    assert ((v - vo).abs() <= 2 * (m + n + 2) * eps * scale_v).all()
    assert float((u - uo).abs().max()) > 0 or float((v - vo).abs().max()) > 0  # the orders differ


# ---------------------------------------------------------------------------
# (c) the plain twin against the JAX package
# ---------------------------------------------------------------------------
def test_plain_twin_matches_the_jax_cg_solve():
    """The loop's plain twin on the cg backend's system (float64, B=4,
    n=30, m=45, sigma 1e-6, rho in [0.1, 1.1)) from a warm start, against
    osqp_tpu.linsys.cg.solve on the same numpy inputs: x within 1e-6 at
    the JAX package's tolerance (tol_rel 1e-8, the float64 cap; steps cap
    n + m = 75), every instance converging in 20 to 75 steps."""
    rng = np.random.default_rng(11)
    B, n, m = 4, 30, 45
    M = rng.standard_normal((B, n, n))
    P = M @ M.transpose(0, 2, 1) / n + 0.1 * np.eye(n)
    A = rng.standard_normal((B, m, n)) / np.sqrt(n)
    rho = rng.random((B, m)) + 0.1
    rhs_x, rhs_z, x0 = rng.standard_normal((B, n)), rng.standard_normal((B, m)), rng.standard_normal((B, n))
    sigma = 1e-6
    jfac = jcg.init(P, A, sigma, rho)
    jx, _ = jcg.solve(jfac, A, rho, rhs_x, rhs_z, x0)
    T = torch.as_tensor
    fac = cg_backend.init(T(P), T(A), sigma, T(rho))
    b = T(rhs_x) + torch.bmm((T(rho) * T(rhs_z))[:, None, :], T(A))[:, 0]
    op = k6.DenseOperator(T(P), T(A), T(rho))
    x, steps = k6.pcg_solve_plain(op.ordered, fac["sigma"], fac["dinv"], b, fac["tol_rel"], int(fac["max_iter"]), T(x0),
                                  dot=k6.kernel_dot, start_dot=k6.kernel_dot)
    assert float(fac["tol_rel"][0]) == 1e-8 and int(fac["max_iter"]) == n + m
    assert 20 <= int(steps.min()) and int(steps.max()) < n + m
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# (d) each instance alone
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("from_zero", [False, True])
def test_each_instance_alone_gives_the_batch_its_bits(from_zero):
    """The dense loop stops each instance at its own freeze or at max_iter;
    its twin, run on the batch, stops all at the last one's, a frozen
    instance keeping its x bit for bit.  So each instance run alone gives
    the batch's x bit for bit and its steps exactly."""
    B, n, m = 5, 24, 33
    op, b = _system(B, n, m, torch.float64, seed=4)
    scale = torch.linspace(1.0, 2.0, B, dtype=torch.float64)[:, None, None]
    op = k6.DenseOperator(op.P * scale, op.A, op.w)
    sigma = torch.tensor(1e-6, dtype=torch.float64)
    dinv = 1.0 / (torch.diagonal(op.P, dim1=-2, dim2=-1) + sigma + torch.einsum("bm,bmn->bn", op.w, op.A * op.A))
    x0 = None if from_zero else torch.as_tensor(np.random.default_rng(5).standard_normal((B, n)))
    tol = torch.tensor([1e-12, 1e-6, 1e-3, 1e9, 1e-2], dtype=torch.float64)
    max_iter = 22  # instance 0 at its cap, the others at their freeze
    run = lambda o, d, bb, t, x: k6.pcg_solve_plain(o.ordered, sigma, d, bb, t, max_iter, x,  # noqa: E731
                                                    dot=k6.kernel_dot, start_dot=k6.kernel_dot)
    xb, sb = run(op, dinv, b, tol, x0)
    assert len(set(sb.tolist())) == B and int(sb.max()) == max_iter and int(sb.min()) == 0
    for i in range(B):
        one = k6.DenseOperator(op.P[i:i + 1], op.A[i:i + 1], op.w[i:i + 1])
        xi, si = run(one, dinv[i:i + 1], b[i:i + 1], tol[i:i + 1], None if x0 is None else x0[i:i + 1])
        assert int(si[0]) == int(sb[i]) and torch.equal(xi[0], xb[i])
