"""osqp_tpu_torch.parallel in one process: the mesh and the multi-host
helpers on a one-rank gloo group, K4's step entries composed over row
blocks (their plain versions), and the row-sharded operand's products on
W blocks held to the unsharded ones, its W ranks run as threads of this
process over an in-process stand-in for the collectives.  The
multi-process runs are in tests/test_torch_parallel_ranks.py."""

import functools
import os
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest
import scipy.sparse as sp
import torch
import torch.distributed as dist

import osqp_tpu_torch as ot
from osqp_tpu_torch import batch as batch_mod
from osqp_tpu_torch import constants as con
from osqp_tpu_torch import parallel
from osqp_tpu_torch import polish as polish_mod
from osqp_tpu_torch.linalg import mat_tvec, mat_vec
from osqp_tpu_torch.linsys import cg as cg_backend
from osqp_tpu_torch.ops import cg as k6
from osqp_tpu_torch.ops import ell as k5
from osqp_tpu_torch.ops import ruiz as k4
from osqp_tpu_torch.parallel import intra as intra_mod
from osqp_tpu_torch.parallel import rows as rows_mod
from osqp_tpu_torch.scaling import scale_data
from osqp_tpu_torch.sparse_ops import ell_from_scipy
from osqp_tpu_torch.termination import compute_products
from osqp_tpu_torch.types import QPData

import torch_parallel_ranks as R


@pytest.fixture
def no_group():
    """No process group before the test, and none left after it."""
    if dist.is_initialized():
        dist.destroy_process_group()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture
def one_rank(no_group):
    """A one-rank gloo group, as make_mesh starts it on the CPU."""
    return parallel.make_mesh(device="cpu")


def test_exports_the_jax_packages_names():
    import osqp_tpu.parallel as jax_parallel

    names = {"make_mesh", "solve_batch_sharded", "solve_single_sharded", "solve_single_sharded_sparse",
             "initialize", "host_shard", "global_batch_mesh", "allreduce_summary"}
    assert set(parallel.__all__) == names
    assert all(hasattr(jax_parallel, n) and callable(getattr(parallel, n)) for n in names)


def test_parallel_imports_leave_jax_out():
    code = (
        "import sys, osqp_tpu_torch.parallel as p;"
        "import osqp_tpu_torch.parallel.intra, osqp_tpu_torch.parallel.mesh, osqp_tpu_torch.parallel.multihost;"
        "[getattr(p, name) for name in p.__all__];"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'osqp_tpu')];"
        "assert not bad, bad"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr


def test_make_mesh_on_the_cpu_starts_a_one_rank_group(one_rank):
    mesh = one_rank
    assert dist.is_initialized() and dist.get_world_size() == 1 and dist.get_backend() == "gloo"
    assert mesh.device_type == "cpu" and mesh.size() == 1 and mesh.mesh_dim_names == ("batch",)
    assert dist.get_world_size(mesh.get_group("batch")) == 1
    again = parallel.make_mesh(1, axis_name="rows", device="cpu")  # the group exists: reused
    assert again.mesh_dim_names == ("rows",) and dist.get_world_size() == 1


@pytest.mark.parametrize("have_group", [False, True])
def test_make_mesh_refuses_more_ranks_than_the_world(no_group, have_group):
    if have_group:
        parallel.make_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="torchrun"):
        parallel.make_mesh(2, device="cpu")


def test_make_mesh_needs_a_card_unless_asked_for_the_cpu(no_group):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        parallel.make_mesh()
    assert not dist.is_initialized()


def test_initialize_twice_is_a_no_op(no_group, tmp_path):
    assert parallel.host_shard() == (0, 1)
    parallel.initialize(backend="gloo", init_method=f"file://{tmp_path}/store", rank=0, world_size=1)
    group = dist.group.WORLD
    parallel.initialize()  # a group exists
    parallel.initialize(backend="nccl")  # ignored too
    assert dist.group.WORLD is group and dist.get_backend() == "gloo"
    assert parallel.host_shard() == (0, 1)
    mesh = parallel.global_batch_mesh("hosts")
    assert mesh.device_type == "cpu" and mesh.size() == 1 and mesh.mesh_dim_names == ("hosts",)


@pytest.mark.parametrize("grouped", [False, True])
def test_allreduce_summary_recomputes_the_pass_rate(no_group, grouped):
    if grouped:
        parallel.make_mesh(device="cpu")
    summary = dict(problems=4, solved=2, final=3, pass_rate=0.5, polish_success=1, polish_fail=1, total_time=1.5,
                   name="HS")
    out = parallel.allreduce_summary(summary)
    assert out == {**summary, "pass_rate": 0.75}
    assert isinstance(out["problems"], int) and isinstance(out["total_time"], float)


# ---------------------------------------------------------------------------
# K4's step entries over row blocks
# ---------------------------------------------------------------------------
def _dense_qps(B, n, m, dtype, seed=0):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((B, n, n))
    P = M @ M.transpose(0, 2, 1) / n + 0.1 * np.eye(n)
    # rows of very different scale, so that E moves far from 1
    A = rng.standard_normal((B, m, n)) * 10.0 ** rng.uniform(-3, 3, (B, m, 1))
    q = rng.standard_normal((B, n))
    return [torch.as_tensor(a, dtype=dtype) for a in (P, q, A, -rng.random((B, m)) - 0.1, rng.random((B, m)) + 0.1)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("W", [1, 2, 3, 4])
def test_ruiz_steps_on_row_blocks_equal_ruiz_plain_bit_for_bit(dtype, W):
    """The sweeps step by step on W row blocks, their maxima merged as the
    collectives merge them: c, D, E and the scaled data are ruiz_plain's
    bits (the maxima do not depend on how the rows are cut)."""
    P, q, A, l, u = _dense_qps(3, 9, 12, dtype)
    want = k4.ruiz_plain(P, q, A, l, u, 10)
    got = k4.ruiz_blocks(P, q, list(torch.tensor_split(A, W, dim=1)), l, u, 10)
    for name, a, b in zip(("c", "D", "E", "P", "q", "A", "l", "u"), want, got):
        b = torch.cat(b, dim=1) if name == "A" else b
        assert torch.equal(a, b), name


def test_ruiz_steps_without_constraints():
    P, q, A, l, u = _dense_qps(2, 5, 0, torch.float64)
    want = k4.ruiz_plain(P, q, A, l, u, 4)
    got = k4.ruiz_blocks(P, q, [A], l, u, 4)
    assert all(torch.equal(a, b) for a, b in zip(want[:5] + want[6:], got[:5] + got[6:]))


def test_merge_maxima_orders_bits_as_values():
    a = torch.tensor([0.0, 1.5, float("inf"), 3.0], dtype=torch.float64)
    b = torch.tensor([2.0, 1.0, 7.0, float("nan")], dtype=torch.float64)
    got = k4.merge_maxima(a, b)
    assert got[:3].tolist() == [2.0, 1.5, float("inf")] and torch.isnan(got[3])


# ---------------------------------------------------------------------------
# The row-sharded operand on W blocks, its ranks as threads
# ---------------------------------------------------------------------------
class ThreadRanks:
    """Stands in for ``torch.distributed`` inside parallel/rows.py: W
    threads, one a rank, meet at a barrier for each collective; the
    all-reduce sums in rank order, the gather concatenates."""

    ReduceOp = dist.ReduceOp

    def __init__(self, W):
        self.W = W
        self.barrier = threading.Barrier(W)
        self.slots = [None] * W
        self.local = threading.local()

    def get_world_size(self, group=None):
        return self.W

    def _exchange(self, t):
        self.slots[self.local.rank] = t.clone()
        self.barrier.wait()
        got = list(self.slots)
        self.barrier.wait()
        return got

    def all_gather_single(self, out, t, group=None):
        out.copy_(torch.cat(self._exchange(t)))

    def all_reduce(self, t, op=None, group=None):
        parts = self._exchange(t)
        acc = parts[0]
        for p in parts[1:]:
            acc = torch.maximum(acc, p) if op == dist.ReduceOp.MAX else acc + p
        t.copy_(acc)

    def run(self, fn):
        """fn(rank) in W threads; returns the results in rank order."""
        out, errors = [None] * self.W, []

        def body(r):
            self.local.rank = r
            try:
                out[r] = fn(r)
            except BaseException as e:  # noqa: BLE001 - reported below
                errors.append(e)
                self.barrier.abort()

        threads = [threading.Thread(target=body, args=(r,)) for r in range(self.W)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        if errors:
            raise errors[0]
        assert not any(t.is_alive() for t in threads), "a rank thread did not finish"
        return out


@pytest.fixture
def thread_ranks(monkeypatch):
    def make(W):
        fake = ThreadRanks(W)
        monkeypatch.setattr(rows_mod, "dist", fake)
        return fake

    return make


def _sharded_dense(A, W, r):
    R_ = A.shape[1] // W
    return rows_mod.RowSharded(A[:, r * R_:(r + 1) * R_].contiguous(), A.shape[1], r * R_, None)


def _ell_qp(n=40, m=60, B=2, dtype=torch.float64, seed=3):
    rng = np.random.default_rng(seed)
    A = sp.random(m, n, density=0.15, random_state=seed, format="csr") + sp.eye(m, n, format="csr")
    A.data *= 10.0 ** rng.uniform(-2, 2, A.nnz)
    M = sp.random(n, n, density=0.1, random_state=seed + 1)
    P = sp.triu(M @ M.T + sp.eye(n), format="csr")
    return ell_from_scipy(P, dtype, batch=B, sym_from_triu=True).contiguous(), \
        ell_from_scipy(A, dtype, batch=B).contiguous()


def _sharded_ell(A, W, r):
    m = A.shape[0]
    R_ = m // W
    return rows_mod.RowSharded.from_ell(A.val[:, r * R_:(r + 1) * R_].contiguous(),
                                        A.idx[r * R_:(r + 1) * R_].contiguous(), A.t_val, A.t_idx, m, r * R_, None)


@pytest.mark.parametrize("W", [1, 3, 4])
def test_dense_products_on_w_blocks_match_unsharded(thread_ranks, W):
    """A x bit for bit (each row's product is its own); A'y, the
    termination products, the cg diagonal and the CG's products, whose sums
    are cut by rank, within 1e-12; every rank the same bits."""
    B, n, m = 2, 9, 12
    P, q, A, l, u = _dense_qps(B, n, m, torch.float64, seed=2)
    g = torch.Generator().manual_seed(0)
    x, dx, p = (torch.randn(B, n, generator=g, dtype=torch.float64) for _ in range(3))
    y, dy, w = (torch.randn(B, m, generator=g, dtype=torch.float64) for _ in range(3))
    w = w.abs() + 0.1
    data = QPData(P=P, q=q, A=A, l=l, u=u)
    want = (mat_vec(A, x), mat_tvec(A, y), *compute_products(data, x, l, y, dx, dy),
            cg_backend.init(P, A, 1e-6, w)["dinv"], *k6._operator(P, A, w, plain=True)(p))

    def rank(r):
        As = _sharded_dense(A, W, r)
        d = QPData(P=P, q=q, A=As, l=l, u=u)
        return (mat_vec(As, x), mat_tvec(As, y), *compute_products(d, x, l, y, dx, dy),
                cg_backend.init(P, As, 1e-6, w)["dinv"], *k6._operator(P, As, w, plain=True)(p))

    got = thread_ranks(W).run(rank)
    assert torch.equal(got[0][0], want[0])
    for a, b in zip(got[0], want):
        assert float((a - b).abs().max()) <= 1e-12 * max(1.0, float(b.abs().max()))
    for g_r in got[1:]:
        assert all(torch.equal(a, b) for a, b in zip(g_r, got[0]))


@pytest.mark.parametrize("W", [1, 3, 4])
def test_ell_products_on_w_blocks_are_the_unsharded_bits(thread_ranks, W):
    """Rows and the replicated transpose: A x, A'y, A'(w y) (the weighted
    product's bits, as the cg backend's right-hand side takes it), the
    termination products, the cg diagonal, the CG's products and the whole
    Ruiz scaling give the unsharded bits."""
    P, A = _ell_qp()
    B, (m, n) = A.batch, A.shape
    g = torch.Generator().manual_seed(1)
    x, dx, p, q = (torch.randn(B, n, generator=g, dtype=torch.float64) for _ in range(4))
    y, dy, w = (torch.randn(B, m, generator=g, dtype=torch.float64) for _ in range(3))
    w = w.abs() + 0.1
    l, u = -torch.rand(B, m, dtype=torch.float64) - 0.1, torch.rand(B, m, dtype=torch.float64) + 0.1
    data = QPData(P=P, q=q, A=A, l=l, u=u)
    scaled, scl = scale_data(data, 10)
    want = (mat_vec(A, x), mat_tvec(A, y), k5.ell_tmatvec(A, y, w), *compute_products(data, x, l, y, dx, dy),
            cg_backend.init(P, A, 1e-6, w)["dinv"], *k6._operator(P, A, w, plain=True)(p),
            scl.c, scl.D, scl.E, scaled.q, scaled.l, scaled.P.val, scaled.A.val, scaled.A.t_val)

    def rank(r):
        As = _sharded_ell(A, W, r)
        d = QPData(P=P, q=q, A=As, l=l, u=u)
        s2, c2 = scale_data(d, 10)
        rows = s2.A.local
        return (mat_vec(As, x), mat_tvec(As, y), mat_tvec(As, w * y), *compute_products(d, x, l, y, dx, dy),
                cg_backend.init(P, As, 1e-6, w)["dinv"], *k6._operator(P, As, w, plain=True)(p),
                c2.c, c2.D, c2.E, s2.q, s2.l, s2.P.val, s2.A.gather_rows(rows.val), rows.t_val)

    got = thread_ranks(W).run(rank)
    for g_r in got:
        for i, (a, b) in enumerate(zip(g_r, want)):
            assert torch.equal(a, b), i


@pytest.mark.parametrize("W", [1, 2, 4])
def test_dense_ruiz_on_w_blocks_is_ruiz_plains_bits(thread_ranks, W):
    """scale_data on a row-sharded dense A: K4's steps with the maxima
    merged by the all-reduce of their bits and the gather of the rows."""
    P, q, A, l, u = _dense_qps(2, 7, 8, torch.float64, seed=5)
    want = k4.ruiz_plain(P, q, A, l, u, 10)

    def rank(r):
        scaled, scl = scale_data(QPData(P=P, q=q, A=_sharded_dense(A, W, r), l=l, u=u), 10)
        As = scaled.A
        return scl.c, scl.D, scl.E, scaled.P, scaled.q, As.gather_rows(As.local), scaled.l, scaled.u

    for got in thread_ranks(W).run(rank):
        assert all(torch.equal(a, b) for a, b in zip(want, got))


def test_ell_scale_rows_is_ell_scales_bits():
    P, A = _ell_qp(dtype=torch.float32)
    B, (m, n) = A.batch, A.shape
    g = torch.Generator().manual_seed(2)
    E, D, c = (torch.rand(B, k, generator=g) + 0.5 for k in (m, n, 1))
    want = k5.ell_scale(A, E, D, c[:, 0])
    R_ = m // 3
    for r in range(3):
        val, t_val = k5.ell_scale_rows(A.val[:, r * R_:(r + 1) * R_].contiguous(), A.idx[r * R_:(r + 1) * R_],
                                       A.t_val, A.t_idx, E[:, r * R_:(r + 1) * R_].contiguous(), E, D, c[:, 0])
        assert torch.equal(val, want.val[:, r * R_:(r + 1) * R_]) and torch.equal(t_val, want.t_val)


# ---------------------------------------------------------------------------
# The entries at one rank: the unsharded bits
# ---------------------------------------------------------------------------
def _fields(res):
    return [getattr(res, f) for f in R.FIELDS]


@pytest.mark.parametrize("polish", [False, True])
def test_solve_single_sharded_at_one_rank_gives_the_unsharded_bits(one_rank, polish, monkeypatch):
    """With polish, the unsharded solve's polish takes the Schur branch
    (``polish(..., schur=True)``), as the sharded one does on its rows:
    the same bits at one rank, K2's inverse of S and no K8."""
    P, q, A, l, u = R.qp(m=50)
    got = parallel.solve_single_sharded(P, q, A, l, u, mesh=one_rank, verbose=False, polish=polish, **R.F64)
    monkeypatch.setattr(batch_mod, "polish_fn", functools.partial(polish_mod.polish, schur=True))
    want = ot.solve_batch(P[None], q[None], A[None], l[None], u[None], device="cpu", linsys_solver="cg",
                          verbose=False, polish=polish, **R.F64)
    assert all(torch.equal(a, b) for a, b in zip(_fields(got), _fields(want)))
    assert int(got.status_polish[0]) == (1 if polish else 0)


def test_solve_single_sharded_sparse_at_one_rank_gives_the_unsharded_bits(one_rank):
    P, q, A, l, u = R.sparse_polish_qp()
    got = parallel.solve_single_sharded_sparse(P, q, A, l, u, mesh=one_rank, verbose=False, polish=True, **R.F64)
    want = ot.solve_sparse(P, q, A, l, u, device="cpu", verbose=False, polish=True, **R.F64)
    assert all(torch.equal(a, b) for a, b in zip(_fields(got), _fields(want)))


def test_solve_batch_sharded_at_one_rank_gives_the_unsharded_bits(one_rank):
    b = R.BATCH
    data = R.random_qps(b["B"], b["n"], b["m"], b["seed"])
    got = parallel.solve_batch_sharded(*data, mesh=one_rank, verbose=False, **R.F64)
    want = ot.solve_batch(*data, device="cpu", verbose=False, **R.F64)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_the_entries_refuse_a_time_limit_and_direct_backends(one_rank):
    """The direct backends are refused.  A time limit no longer is: both
    entries stop at the first poll (iteration 200) with the unsharded
    solve's bits at the same limit."""
    P, q, A, l, u = R.qp()
    with pytest.raises(con.OSQPError, match="cg backend"):
        parallel.solve_single_sharded(P, q, A, l, u, mesh=one_rank, verbose=False, linsys_solver="kkt_lu")
    kw = dict(verbose=False, time_limit=1e-9, **R.TIGHT)
    got = parallel.solve_single_sharded(P, q, A, l, u, mesh=one_rank, **kw)
    want = ot.solve_batch(P[None], q[None], A[None], l[None], u[None], device="cpu", linsys_solver="cg", **kw)
    assert all(torch.equal(a, b) for a, b in zip(_fields(got), _fields(want)))
    got = parallel.solve_single_sharded_sparse(*R.sparse_dense_qp(), mesh=one_rank, **kw)
    want = ot.solve_sparse(*R.sparse_dense_qp(), device="cpu", **kw)
    assert all(torch.equal(a, b) for a, b in zip(_fields(got), _fields(want)))
    assert int(got.status_val[0]) == con.OSQP_TIME_LIMIT_REACHED and int(got.iter[0]) == 200


# ---------------------------------------------------------------------------
# Polish on the shards: the Schur branch and the row-sharded operators
# ---------------------------------------------------------------------------
def _masked_kkt(B=2, n=12, m=20, seed=4):
    """P, MA, delta and a right-hand side in float64, about half of MA's
    rows inactive (zero), as polish masks them."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((B, n, n))
    P = M @ M.transpose(0, 2, 1) / n + 0.1 * np.eye(n)
    mask = (rng.random((B, m)) < 0.5).astype(np.float64)
    mask[:, :2] = 0.0  # inactive rows at the first block's start
    MA = mask[:, :, None] * rng.standard_normal((B, m, n))
    rhs = rng.standard_normal((B, n + m))
    rhs[:, n:] *= mask  # an inactive row's right-hand side is 0 (polish.c:105-121)
    return P, MA, 1e-6, rhs


def test_schur_kkt_solver_matches_the_jax_packages_schur_branch():
    """K_delta^-1 rhs by _schur_kkt_solver against osqp_tpu.polish.
    _make_kkt_solver(prefer_schur=True), both at d = max(delta, 1e-4).
    Each side forms S and its inverse X with its own rounding, an error
    of order cond(S) eps |X| in X, and then sx = X t cancels: t = r_x +
    (MA)' r_z / d is ~1e5 here where sx is ~1.  So the two agree within
    cond(S) eps |X|_2 |t|_2 (~2e-5 here; they differ by ~6e-7, as far as
    each lies from a direct solve of K_delta); inactive rows give nu = 0
    exactly in both."""
    import jax.numpy as jnp

    from osqp_tpu.polish import _make_kkt_solver

    P, MA, delta, rhs = _masked_kkt()
    B, m, n = MA.shape
    want = np.asarray(_make_kkt_solver(n, m, jnp.asarray(P), jnp.asarray(MA), delta, jnp.float64,
                                       prefer_schur=True)(jnp.asarray(rhs)))
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)
    got = polish_mod._schur_kkt_solver(n, m, t(P), t(MA), torch.tensor(delta, dtype=torch.float64),
                                       torch.float64)(t(rhs)).numpy()
    d = max(delta, 1e-4)
    S = P + MA.transpose(0, 2, 1) @ MA / d + d * np.eye(n)
    t_ = rhs[:, :n] + np.einsum("bmn,bm->bn", MA, rhs[:, n:]) / d
    tol = max(np.linalg.cond(S[b]) * np.finfo(np.float64).eps * np.linalg.norm(t_[b]) / np.linalg.eigvalsh(S[b])[0]
              for b in range(B))
    assert np.abs(got - want).max() <= tol
    inactive = np.abs(MA).sum(-1) == 0
    assert np.all(got[:, n:][inactive] == 0.0) and np.all(want[:, n:][inactive] == 0.0)


@pytest.mark.parametrize("W", [1, 2, 4])
def test_dense_polish_operators_on_w_blocks(thread_ranks, W):
    """masked and gram on W row blocks against the whole A: the mask's
    product bit for bit, (MA)'(MA) within 1e-12 (its sums are cut by
    rank), the Schur solve within 1e-9 and bit for bit at one block; no
    gather larger than B m."""
    P, MA, delta, rhs = _masked_kkt(m=16)
    B, m, n = MA.shape
    rng = np.random.default_rng(5)
    A = torch.as_tensor(rng.standard_normal((B, m, n)))
    mask = torch.as_tensor((rng.random((B, m)) < 0.5).astype(np.float64))
    P, rhs = torch.as_tensor(P), torch.as_tensor(rhs)
    d = torch.tensor(delta, dtype=torch.float64)
    whole = mask[:, :, None] * A
    want = (torch.bmm(whole.mT, whole), polish_mod._schur_kkt_solver(n, m, P, whole, d, torch.float64)(rhs))

    def rank(r):
        rows_mod.reset_collectives()
        MAs = _sharded_dense(A, W, r).masked(mask)
        got = (MAs.local, MAs.gram(), polish_mod._schur_kkt_solver(n, m, P, MAs, d, torch.float64)(rhs))
        return got, rows_mod.largest_gather

    for r, (got, largest) in enumerate(thread_ranks(W).run(rank)):
        R_ = m // W
        assert torch.equal(got[0], whole[:, r * R_:(r + 1) * R_])
        assert float((got[1] - want[0]).abs().max()) <= 1e-12 * float(want[0].abs().max())
        assert float((got[2] - want[1]).abs().max()) <= 1e-9 * float(want[1].abs().max())
        if W == 1:
            assert torch.equal(got[1], want[0]) and torch.equal(got[2], want[1])
        assert largest <= B * m


@pytest.mark.parametrize("W", [1, 3, 4])
def test_ell_polish_operators_on_w_blocks_are_the_unsharded_bits(thread_ranks, W):
    """masked (K5's scale on the block and the transpose) and the Schur
    operator of schur_products against ell_scale and EllOperator(div=d) on
    the whole A: the same bits; the operator's gather is an m-vector."""
    P, A = _ell_qp()
    B, (m, n) = A.batch, A.shape
    g = torch.Generator().manual_seed(3)
    mask = (torch.rand(B, m, generator=g) < 0.5).to(torch.float64)
    p = torch.randn(B, n, generator=g, dtype=torch.float64)
    d = torch.tensor(1e-6, dtype=torch.float64)
    MA = k5.ell_scale(A, mask, torch.ones(B, n, dtype=torch.float64))
    want = (MA.val, MA.t_val, *k6.EllOperator(P, MA, div=d)(p))

    def rank(r):
        rows_mod.reset_collectives()
        MAs = _sharded_ell(A, W, r).masked(mask)
        got = (MAs.gather_rows(MAs.local.val), MAs.t.t_val, *MAs.schur_products(P, d)(p))
        return got, rows_mod.largest_gather

    for got, largest in thread_ranks(W).run(rank):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert largest <= B * m * A.val.shape[-1]  # the check's own gather of the values; the operator's is B m


# ---------------------------------------------------------------------------
# The agreed stop
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("W", [1, 3])
def test_agreed_stop_carries_rank_0s_clock_and_any_ranks_sigint(thread_ranks, W):
    """One all-reduce (MAX) of (rank 0's clock decision, SIGINT seen) a
    poll: rank 0 past the limit stops every rank; another rank past it
    stops none; a SIGINT on any rank stops every rank, before the clock."""
    def rank(r, late_rank, sigint_rank):
        stop = intra_mod._AgreedStop(None, r, torch.device("cpu"), 1.0)
        if r == late_rank:
            stop.t0 -= 10.0
        stop.interrupted = r == sigint_rank
        return stop()

    ranks = thread_ranks(W)
    assert ranks.run(lambda r: rank(r, -1, -1)) == [None] * W
    assert ranks.run(lambda r: rank(r, 0, -1)) == [con.OSQP_TIME_LIMIT_REACHED] * W
    assert ranks.run(lambda r: rank(r, W - 1, W - 1)) == [con.OSQP_SIGINT] * W
    assert ranks.run(lambda r: rank(r, 0, W - 1)) == [con.OSQP_SIGINT] * W
    if W > 1:
        assert ranks.run(lambda r: rank(r, 1, -1)) == [None] * W


def test_deferred_sigint_records_the_signal_and_restores_the_handler():
    before = signal.getsignal(signal.SIGINT)
    stop = intra_mod._AgreedStop(None, 0, torch.device("cpu"), 0.0)
    with intra_mod._deferred_sigint(stop):
        signal.raise_signal(signal.SIGINT)  # no KeyboardInterrupt
    assert stop.interrupted
    assert signal.getsignal(signal.SIGINT) is before


@pytest.mark.parametrize("status", [None, con.OSQP_TIME_LIMIT_REACHED, con.OSQP_SIGINT])
def test_the_segmented_loops_stop_hook_ends_the_solve_where_it_says(monkeypatch, status):
    """batch._solve_segmented with a stop hook: polled from the second
    segment's end (200) on; stopping at the second poll ends at 300 with
    the hook's status (SIGINT with no further checks), and a hook that
    never stops leaves the unsharded solve's bits."""
    P, q, A, l, u = (a[None] for a in R.qp(m=50))
    kw = dict(device="cpu", linsys_solver="cg", verbose=False, **R.TIGHT)
    plain = ot.solve_batch(P, q, A, l, u, **kw)
    polls = []

    def stop():
        polls.append(len(polls))
        return status if len(polls) == 2 else None

    segmented = batch_mod._solve_segmented
    monkeypatch.setattr(batch_mod, "_solve_segmented", lambda *a, **k: segmented(*a, **k, stop=stop))
    got = ot.solve_batch(P, q, A, l, u, **kw)
    if status is None:
        assert all(torch.equal(a, b) for a, b in zip(_fields(got), _fields(plain)))
        assert len(polls) == (int(plain.iter[0]) - 1) // 100 - 1
    else:
        assert int(got.status_val[0]) == status and int(got.iter[0]) == 300 and len(polls) == 2
