"""The ranks of the multi-process tests of ``osqp_tpu_torch.parallel``
(``tests/test_torch_parallel_ranks.py``).

:func:`spawn` starts W processes with ``torch.multiprocessing`` (gloo on
the CPU, a ``FileStore`` for the rendezvous), each runs every case of its
suite and writes its results to ``rank<r>.npz``; the tests read them.
This module imports nothing of JAX: the children import it to find
:func:`run_rank`.
"""

import contextlib
import os
import signal
import time
import types
from datetime import timedelta

import numpy as np

MAROS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "maros_mm")
HS_ROWS = ("HS118", "HS21", "HS268", "HS35", "HS35MOD", "HS51", "HS52", "HS53", "HS76")
GROUP_TIMEOUT_S = 60
# B divides by 3, 4 and the JAX package's 8 devices; BAD_B by none of 3, 4
BATCH = dict(B=24, n=8, m=12, seed=9)
BAD_B = 26


def qp(n=24, m=50, seed=21):
    """tests/test_intra_sharding.py:_qp: a random strictly convex QP."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n))
    P = M @ M.T / n + 0.2 * np.eye(n)
    q = rng.standard_normal(n)
    A = rng.standard_normal((m, n))
    x0 = rng.standard_normal(n)
    return P, q, A, A @ x0 - 1.0, A @ x0 + 1.0


def random_qps(B, n, m, seed=7):
    """tests/test_batch.py:random_qps."""
    from numpy.random import PCG64, Generator

    rg = Generator(PCG64(seed))
    M = rg.standard_normal((B, n, n))
    P = np.einsum("bij,bkj->bik", M, M) / n + 0.1 * np.eye(n)
    q = rg.standard_normal((B, n))
    A = rg.standard_normal((B, m, n))
    xr = rg.standard_normal((B, n))
    Ax = np.einsum("bmn,bn->bm", A, xr)
    l = Ax - np.abs(rg.standard_normal((B, m))) - 0.1
    u = Ax + np.abs(rg.standard_normal((B, m))) + 0.1
    return P, q, A, l, u


def sparse_qp():
    """tests/test_intra_sharding.py:test_sparse_sharded_matches_unsharded's QP."""
    import scipy.sparse as sp

    n = 1024
    rng = np.random.default_rng(0)
    P = sp.diags(2.0 + np.abs(rng.standard_normal(n))).tocsc()
    A = sp.diags([np.ones(n), 0.5 * np.ones(n - 1)], [0, -1], shape=(n, n), format="csc")
    q = rng.standard_normal(n)
    Ax = A @ rng.standard_normal(n)
    s = np.abs(rng.standard_normal(n)) + 0.1
    return P, q, A, Ax - s, Ax + s


def sparse_polish_qp():
    """tests/test_intra_sharding.py:test_sparse_sharded_polish's QP."""
    import scipy.sparse as sp

    rng = np.random.default_rng(9)
    n = 96
    P = sp.diags(1.0 + np.abs(rng.standard_normal(n))).tocsc()
    A = sp.vstack([sp.eye(n), sp.diags([1.0] * (n - 1), 1).tocsr()[: n - 1]]).tocsc()
    q = rng.standard_normal(n)
    m = A.shape[0]
    return P, q, A, -np.ones(m), np.ones(m)


def sparse_dense_qp(m=50):
    """:func:`qp` as scipy matrices, for the sparse entry: 675 iterations
    at eps 1e-9 (``sparse_qp`` stops at 125, before the first poll of a
    time limit)."""
    import scipy.sparse as sp

    P, q, A, l, u = qp(m=m)
    return sp.triu(P, format="csc"), q, sp.csc_matrix(A), l, u


F64 = {"dtype": "float64"}
# eps 1e-9: nothing converges before the first poll, after 2 segments of 100
TIGHT = {**F64, "eps_abs": 1e-9, "eps_rel": 1e-9}
# a clock past this on rank 1 alone must stop no rank
LONG_LIMIT = 1000.0
# name -> (entry, data, settings)
INTRA_CASES = {
    "dense50": ("dense", lambda: qp(m=50), F64),
    "dense48": ("dense", lambda: qp(m=48), F64),
    "dense_polish": ("dense", lambda: qp(m=50), {**F64, "polish": True}),
    "sparse": ("sparse", sparse_qp, F64),
    "sparse_polish": ("sparse", sparse_polish_qp, {**F64, "polish": True}),
    "dense_time_limit": ("dense", lambda: qp(m=50), {**TIGHT, "time_limit": 1e-9}),
    "sparse_time_limit": ("sparse", sparse_dense_qp, {**TIGHT, "time_limit": 1e-9}),
    "dense_clock_rank1": ("dense", lambda: qp(m=50), {**F64, "time_limit": LONG_LIMIT}),
    "dense_sigint_rank1": ("dense", lambda: qp(m=50), TIGHT),
}
# what rank 1 does to itself during a case (:func:`_rank1_hook`)
RANK1_HOOKS = {"dense_clock_rank1": "clock", "dense_sigint_rank1": "sigint"}
SIGINT_SEGMENT_END = 200  # rank 1 raises SIGINT as the segment to this end starts
FIELDS = ("x", "y", "status_val", "iter", "obj_val", "pri_res", "dua_res", "rho_updates", "rho_estimate",
          "status_polish", "prim_inf_cert", "dual_inf_cert")


@contextlib.contextmanager
def _rank1_hook(name: str, rank: int):
    """On rank 1, for a case of ``RANK1_HOOKS``: ``"clock"`` pushes the
    clock of the entries' agreed stop 1e9 s ahead after its first reading
    (the solve's start), past ``LONG_LIMIT``; ``"sigint"`` raises SIGINT
    in this process as the segment ending at ``SIGINT_SEGMENT_END``
    starts.  Elsewhere nothing."""
    from osqp_tpu_torch import admm
    from osqp_tpu_torch.parallel import intra

    hook = RANK1_HOOKS.get(name) if rank == 1 else None
    if hook == "clock":
        readings = []

        def pushed():
            readings.append(None)
            return time.perf_counter() + (0.0 if len(readings) == 1 else 1e9)

        intra.time = types.SimpleNamespace(perf_counter=pushed)
        try:
            yield
        finally:
            intra.time = time
    elif hook == "sigint":
        run_segment = admm.run_segment

        def interrupted(cfg, data, scl, dyn, c, end_iter):
            if end_iter == SIGINT_SEGMENT_END:
                signal.raise_signal(signal.SIGINT)
            return run_segment(cfg, data, scl, dyn, c, end_iter)

        admm.run_segment = interrupted
        try:
            yield
        finally:
            admm.run_segment = run_segment
    else:
        yield


def _intra_suite(out: dict, device: str) -> None:
    import torch
    import torch.distributed as dist

    from osqp_tpu_torch.constants import OSQPError
    from osqp_tpu_torch.parallel import intra, make_mesh, rows, solve_batch_sharded

    mesh = make_mesh(device=device)
    rank = dist.get_rank()
    blocks = []

    class Recorded(rows.RowSharded):
        """The operand an entry builds, recorded for its block's shape."""

        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            blocks.append(self)

    intra.RowSharded = Recorded
    handler = signal.getsignal(signal.SIGINT)
    for name, (entry, data, settings) in INTRA_CASES.items():
        blocks.clear()
        rows.reset_collectives()
        fn = intra.solve_single_sharded if entry == "dense" else intra.solve_single_sharded_sparse
        t0 = time.perf_counter()
        with _rank1_hook(name, rank):
            res = fn(*data(), mesh=mesh, verbose=False, **settings)
        out[f"{name}/seconds"] = np.array(time.perf_counter() - t0)
        for f in FIELDS:
            out[f"{name}/{f}"] = getattr(res, f).cpu().numpy()
        blk = blocks[0]
        out[f"{name}/block_rows"] = np.array(blk.rows_count)
        out[f"{name}/block_stored_rows"] = np.array(blk.local.shape[0] if blk.ell else blk.local.shape[1])
        out[f"{name}/row0"] = np.array(blk.row0)
        out[f"{name}/collectives"] = np.array([rows.collectives[k] for k in sorted(rows.collectives)])
        out[f"{name}/largest_gather"] = np.array(rows.largest_gather)
        out[f"{name}/padded_m"] = np.array(blk.m)
    out["sigint_handler_restored"] = np.array(int(signal.getsignal(signal.SIGINT) is handler))
    try:
        intra.solve_single_sharded(*qp(), mesh=mesh, linsys_solver="dense_inv", verbose=False)
        out["direct_refused"] = np.array(0)
    except OSQPError:
        out["direct_refused"] = np.array(1)

    b = BATCH
    res = solve_batch_sharded(*random_qps(b["B"], b["n"], b["m"], b["seed"]), mesh=mesh, verbose=False, **F64)
    for f in FIELDS:
        out[f"batch/{f}"] = getattr(res, f).cpu().numpy()
    try:
        solve_batch_sharded(*random_qps(BAD_B, b["n"], b["m"], b["seed"]), mesh=mesh, verbose=False, **F64)
        out["bad_batch_refused"] = np.array(0)
    except ValueError:
        out["bad_batch_refused"] = np.array(1)
    out["threads"] = np.array(torch.get_num_threads())


def _multihost_suite(out: dict, store: str, rank: int, world: int) -> None:
    from osqp_tpu_torch.maros import run_maros
    from osqp_tpu_torch.parallel import allreduce_summary, host_shard, initialize

    initialize(backend="gloo", init_method=f"file://{store}", rank=rank, world_size=world,
               timeout=timedelta(seconds=GROUP_TIMEOUT_S))
    initialize()  # a group exists: a no-op
    r, w = host_shard()
    paths = [os.path.join(MAROS, f"{name}.qps") for name in HS_ROWS]
    rows_, summary = run_maros(paths, dtype="float64", shard=(r, w), verbose=False, device="cpu")
    total = allreduce_summary(summary)
    out["host_shard"] = np.array([r, w])
    out["names"] = np.array(sorted(row["name"] for row in rows_))
    for k, v in total.items():
        if k != "total_time":
            out[f"summary/{k}"] = np.array(v)


def run_rank(rank: int, world: int, store: str, out_dir: str, suite: str) -> None:
    """One rank: join the group through the FileStore ``store``, run the
    suite (``"intra"``: the intra-problem and batch cases on the CPU under
    gloo; ``"intra_cuda"``: the same on card ``rank`` under NCCL;
    ``"multihost"``: the Maros helpers) and write ``rank<r>.npz``."""
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    os.environ["LOCAL_RANK"] = str(rank)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    out = {}
    try:
        if suite == "multihost":
            _multihost_suite(out, store, rank, world)
        else:
            cuda = suite == "intra_cuda"
            dist.init_process_group("nccl" if cuda else "gloo", store=dist.FileStore(store, world), rank=rank,
                                    world_size=world, timeout=timedelta(seconds=GROUP_TIMEOUT_S))
            _intra_suite(out, "cuda" if cuda else "cpu")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


def spawn(world: int, tmp_dir: str, suite: str, timeout_s: float = 240.0) -> list:
    """Run ``suite`` in ``world`` spawned ranks; returns each rank's
    results (a dict of arrays), in rank order.  A rank that raises fails
    the call; ranks still running after ``timeout_s`` are killed."""
    import torch.multiprocessing as mp

    store = os.path.join(tmp_dir, "store")
    ctx = mp.start_processes(run_rank, args=(world, store, tmp_dir, suite), nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout_s
    while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            raise TimeoutError(f"{suite} ranks still running after {timeout_s} s")
    results = []
    for r in range(world):
        with np.load(os.path.join(tmp_dir, f"rank{r}.npz")) as f:
            results.append({k: f[k] for k in f.files})
    return results
