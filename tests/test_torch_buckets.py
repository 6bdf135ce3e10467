"""osqp_tpu_torch.buckets against osqp_tpu.buckets on the CPU: the bucket
sizes, the exact padding, the chunk size by dtype and device memory, and
heterogeneous batches through both packages in float64 (same statuses,
iterations and status_polish; x, y and the certificates within 1e-6;
the objective within 1e-6 relative)."""

import numpy as np
import pytest
import torch

import osqp_tpu.buckets as jb
import osqp_tpu_torch.buckets as tb
from osqp_tpu_torch import constants as con

torch.set_num_threads(2)
ATOL = 1e-6


def _hetero_problems():
    """The heterogeneous batch of tests/test_qps_maros.py:151-163."""
    rng = np.random.default_rng(0)
    problems = []
    for i, (n, m) in enumerate([(3, 5), (7, 4), (3, 5), (12, 20)]):
        M = rng.standard_normal((n, n))
        P = M @ M.T + 0.5 * np.eye(n)
        q = rng.standard_normal(n)
        A = rng.standard_normal((m, n))
        x0 = rng.standard_normal(n)
        problems.append((f"p{i}", P, q, A, A @ x0 - 1.0, A @ x0 + 1.0))
    return problems


def _infeasible_problems():
    """The infeasible-in-bucket pair of tests/test_qps_maros.py:178-189."""
    P, q = np.eye(2), np.zeros(2)
    A = np.array([[1.0, 0.0], [1.0, 0.0]])
    return [
        ("feasible", P, q, A, np.array([0.0, 0.0]), np.array([1.0, 1.0])),
        ("infeasible", P, q, A, np.array([0.0, 2.0]), np.array([1.0, 3.0])),
    ]


def _assert_same(rt, rj):
    assert len(rt) == len(rj)
    for a, b in zip(rt, rj):
        assert (a.name, a.n, a.m) == (b.name, b.n, b.m)
        assert (a.status_val, a.iter, a.status_polish) == (b.status_val, b.iter, b.status_polish)
        np.testing.assert_allclose(a.x, np.asarray(b.x), rtol=0, atol=ATOL)
        np.testing.assert_allclose(a.y, np.asarray(b.y), rtol=0, atol=ATOL)
        assert abs(a.obj_val - b.obj_val) <= ATOL * max(1.0, abs(b.obj_val))
        for c, d in ((a.prim_inf_cert, b.prim_inf_cert), (a.dual_inf_cert, b.dual_inf_cert)):
            assert (c is None) == (d is None)
            if c is not None:
                np.testing.assert_allclose(c, np.asarray(d), rtol=0, atol=ATOL)


def test_next_bucket_matches_jax():
    assert [tb._next_bucket(v) for v in range(1, 9001)] == [jb._next_bucket(v) for v in range(1, 9001)]


@pytest.mark.parametrize("shape", [(3, 5, 8, 8), (12, 20, 16, 32), (1000, 1250, 1024, 2048), (5, 0, 8, 8)])
def test_pad_problem_matches_jax(shape):
    n, m, N, M = shape
    rng = np.random.default_rng(n + m)
    P = rng.standard_normal((n, n))
    args = (P + P.T, rng.standard_normal(n), rng.standard_normal((m, n)), -np.abs(rng.standard_normal(m)),
            np.where(np.arange(m) % 2, np.inf, np.abs(rng.standard_normal(m))))
    for a, b in zip(tb.pad_problem(*args, N, M), jb.pad_problem(*args, N, M)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("N,M", [(8, 8), (128, 256), (1024, 2048), (2048, 2048), (8192, 8192)])
def test_max_chunk_by_dtype_and_memory(N, M):
    per = 3 * N * N + 5 * N * M
    # float32 on the CPU: the JAX package's count
    assert tb._max_chunk(N, M, 4) == jb._max_chunk(N, M) == max(1, int(4e9 / (per * 4)))
    # float64 counts 8 bytes an entry (the JAX package counts 4 whatever the dtype)
    assert tb._max_chunk(N, M, 8) == max(1, int(4e9 / (per * 8)))
    # a card's budget is a quarter of its memory (80 GB: 20e9 bytes)
    assert tb._max_chunk(N, M, 8, total_memory=80e9) == max(1, int(20e9 / (per * 8)))
    assert tb._max_chunk(N, M, 4, total_memory=16e9) == jb._max_chunk(N, M)


def test_solve_problems_chunks_by_the_solve_dtype(monkeypatch):
    """A budget of 2.5 float64 instances of the (8, 8) bucket splits five
    problems into chunks of 2, 2 and 1 in float64 and into one of 5 in
    float32; each result names the solve that took it."""
    problems = [(f"p{i}", np.eye(2), np.full(2, i), np.eye(2), -np.ones(2), np.ones(2)) for i in range(5)]
    monkeypatch.setattr(tb, "_HBM_BUDGET", 2.5 * (3 * 64 + 5 * 64) * 8)
    kw = dict(device="cpu", verbose=False, polish=False)
    r64 = tb.solve_problems(problems, dtype="float64", **kw)
    assert [r.bucket for r in r64] == [(8, 8, 2)] * 4 + [(8, 8, 1)]
    r32 = tb.solve_problems(problems, dtype="float32", **kw)
    assert [r.bucket for r in r32] == [(8, 8, 5)] * 5
    assert all(r.status_val == con.OSQP_SOLVED and r.seconds > 0 for r in r64 + r32)


def test_solve_problems_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tb.solve_problems(_infeasible_problems(), verbose=False)


def test_fallback_context_changes_nothing():
    before = torch.get_default_dtype()
    with tb.fallback_context("float64"):
        assert torch.get_default_dtype() == before


@pytest.mark.parametrize("polish", [True, False])
def test_heterogeneous_batch_matches_jax(polish):
    kw = dict(polish=polish, verbose=False, dtype="float64")
    rt = tb.solve_problems(_hetero_problems(), device="cpu", **kw)
    _assert_same(rt, jb.solve_problems(_hetero_problems(), **kw))
    assert [r.bucket[:2] for r in rt] == [(8, 8), (8, 8), (8, 8), (16, 32)]
    assert all(r.status_val == con.OSQP_SOLVED for r in rt)
    assert all(r.status_polish == (1 if polish else 0) for r in rt)


@pytest.mark.nanok
def test_infeasible_in_bucket_matches_jax():
    kw = dict(verbose=False, dtype="float64")
    rt = tb.solve_problems(_infeasible_problems(), device="cpu", **kw)
    _assert_same(rt, jb.solve_problems(_infeasible_problems(), **kw))
    assert [r.status_val for r in rt] == [con.OSQP_SOLVED, con.OSQP_PRIMAL_INFEASIBLE]
    assert rt[1].prim_inf_cert is not None and rt[1].prim_inf_cert.shape == (2,)
