"""osqp_tpu_torch.parallel in one process: the mesh and the multi-host
helpers on a one-rank gloo group, K4's step entries composed over row
blocks (their plain versions), and the row-sharded operand's products on
W blocks held to the unsharded ones, its W ranks run as threads of this
process over an in-process stand-in for the collectives.  The
multi-process runs are in tests/test_torch_parallel_ranks.py."""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import scipy.sparse as sp
import torch
import torch.distributed as dist

import osqp_tpu_torch as ot
from osqp_tpu_torch import constants as con
from osqp_tpu_torch import parallel
from osqp_tpu_torch.linalg import mat_tvec, mat_vec
from osqp_tpu_torch.linsys import cg as cg_backend
from osqp_tpu_torch.ops import cg as k6
from osqp_tpu_torch.ops import ell as k5
from osqp_tpu_torch.ops import ruiz as k4
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
        whole = s2.A.gather()
        return (mat_vec(As, x), mat_tvec(As, y), mat_tvec(As, w * y), *compute_products(d, x, l, y, dx, dy),
                cg_backend.init(P, As, 1e-6, w)["dinv"], *k6._operator(P, As, w, plain=True)(p),
                c2.c, c2.D, c2.E, s2.q, s2.l, s2.P.val, whole.val, whole.t_val)

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
        return scl.c, scl.D, scl.E, scaled.P, scaled.q, scaled.A.gather(), scaled.l, scaled.u

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
def test_solve_single_sharded_at_one_rank_gives_the_unsharded_bits(one_rank, polish):
    P, q, A, l, u = R.qp(m=50)
    got = parallel.solve_single_sharded(P, q, A, l, u, mesh=one_rank, verbose=False, polish=polish, **R.F64)
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
    P, q, A, l, u = R.qp()
    with pytest.raises(con.OSQPError, match="time limit"):
        parallel.solve_single_sharded(P, q, A, l, u, mesh=one_rank, verbose=False, time_limit=1.0)
    with pytest.raises(con.OSQPError, match="cg backend"):
        parallel.solve_single_sharded(P, q, A, l, u, mesh=one_rank, verbose=False, linsys_solver="kkt_lu")
    with pytest.raises(con.OSQPError, match="time limit"):
        parallel.solve_single_sharded_sparse(*R.sparse_polish_qp(), mesh=one_rank, verbose=False, time_limit=1.0)
