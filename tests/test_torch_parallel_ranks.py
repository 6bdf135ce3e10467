"""osqp_tpu_torch.parallel over several processes: gloo ranks on the CPU
(``tests/torch_parallel_ranks.py``, one spawn per world size, every case
run inside it), held against the port's unsharded solves and the JAX
package's sharded ones on the 8-device virtual mesh of conftest.py.

W = 3 and W = 4: the QP of 50 rows pads to 51 and 52, the one of 48 does
not pad.  The counterparts of tests/test_intra_sharding.py and of
tests/test_batch.py::TestSharded.
"""

import functools

import numpy as np
import pytest
import torch

import osqp_tpu_torch as ot
import torch_parallel_ranks as R

WORLDS = (3, 4)
ITER_SLACK = 25  # one check interval: the dense sums run in another order


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """world -> each rank's results of the intra suite, spawned once a world."""
    spawned = {}

    def get(world):
        if world not in spawned:
            spawned[world] = R.spawn(world, str(tmp_path_factory.mktemp(f"w{world}")), "intra")
        return spawned[world]

    return get


@functools.lru_cache(maxsize=None)
def _jax(case: str):
    """The JAX package's sharded solve of a case on the 8-device mesh."""
    from osqp_tpu.parallel import make_mesh, solve_batch_sharded, solve_single_sharded, solve_single_sharded_sparse

    mesh = make_mesh(8)
    if case == "batch":
        b = R.BATCH
        res = solve_batch_sharded(*R.random_qps(b["B"], b["n"], b["m"], b["seed"]), mesh=mesh, verbose=False)
    else:
        entry, data, settings = R.INTRA_CASES[case]
        fn = solve_single_sharded if entry == "dense" else solve_single_sharded_sparse
        res = fn(*data(), mesh=mesh, verbose=False, **{k: v for k, v in settings.items() if k != "dtype"})
    return {f: np.asarray(getattr(res, f)) for f in ("x", "y", "status_val", "iter", "status_polish")}


@functools.lru_cache(maxsize=None)
def _port(case: str):
    """The port's unsharded solve of a case on the CPU: the cg backend for
    the dense QPs, solve_sparse for the sparse ones, solve_batch for the
    batch."""
    if case == "batch":
        b = R.BATCH
        res = ot.solve_batch(*R.random_qps(b["B"], b["n"], b["m"], b["seed"]), device="cpu", verbose=False, **R.F64)
    else:
        entry, data, settings = R.INTRA_CASES[case]
        P, q, A, l, u = data()
        if entry == "dense":
            res = ot.solve_batch(P[None], q[None], A[None], l[None], u[None], device="cpu", linsys_solver="cg",
                                 verbose=False, **settings)
        else:
            res = ot.solve_sparse(P, q, A, l, u, device="cpu", verbose=False, **settings)
    return {f: getattr(res, f).numpy() for f in R.FIELDS}


def _get(results, case):
    return {f: results[f"{case}/{f}"] for f in R.FIELDS}


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_returns_rank_0s_bits(ranks, world):
    res = ranks(world)
    assert len(res) == world
    shared = [k for k in res[0] if not k.endswith(("/row0", "/seconds"))]
    for r in range(1, world):
        for k in shared:
            assert torch.equal(torch.as_tensor(res[r][k]), torch.as_tensor(res[0][k])), (r, k)
    assert all(int(x["threads"]) == 1 for x in res)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", ["dense50", "dense48"])
def test_dense_sharded_matches_unsharded_and_jax(ranks, world, case):
    got = _get(ranks(world)[0], case)
    port, jax_ = _port(case), _jax(case)
    m = R.qp(m=50 if case == "dense50" else 48)[2].shape[0]
    assert got["y"].shape == (1, m) and got["prim_inf_cert"].shape == (1, m)  # padding stripped
    assert int(got["status_val"][0]) == ot.OSQP_SOLVED
    assert got["status_val"][0] == port["status_val"][0] == jax_["status_val"][0]
    for want in (port, jax_):
        assert abs(int(got["iter"][0]) - int(want["iter"][0])) <= ITER_SLACK
        np.testing.assert_allclose(got["x"], want["x"], atol=1e-6, rtol=0)
        np.testing.assert_allclose(got["y"], want["y"], atol=1e-6, rtol=0)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", list(R.INTRA_CASES))
def test_each_rank_holds_only_its_rows_and_collectives_ran(ranks, world, case):
    """The guard against a solve that runs replicated: each rank's block
    holds ceil(m / W) rows, at its own offset, and the products ran
    collectives (tests/test_intra_sharding.py checks the HLO instead)."""
    entry, data, _ = R.INTRA_CASES[case]
    A = data()[2]
    m = A.shape[0]
    rows = -(-m // world)
    for r, res in enumerate(ranks(world)):
        assert int(res[f"{case}/block_rows"]) == int(res[f"{case}/block_stored_rows"]) == rows
        assert int(res[f"{case}/row0"]) == r * rows
        assert int(res[f"{case}/collectives"].sum()) > 0


@pytest.mark.parametrize("world", WORLDS)
def test_direct_backends_refused(ranks, world):
    assert int(ranks(world)[0]["direct_refused"]) == 1


@pytest.mark.parametrize("world", WORLDS)
def test_dense_sharded_polish(ranks, world):
    got, port, jax_ = _get(ranks(world)[0], "dense_polish"), _port("dense_polish"), _jax("dense_polish")
    assert int(got["status_val"][0]) == ot.OSQP_SOLVED
    assert int(got["status_polish"][0]) == int(port["status_polish"][0]) == int(jax_["status_polish"][0]) == 1
    np.testing.assert_allclose(got["x"], port["x"], atol=1e-7, rtol=0)
    np.testing.assert_allclose(got["y"], port["y"], atol=1e-7, rtol=0)
    np.testing.assert_allclose(got["x"], jax_["x"], atol=1e-6, rtol=0)


@pytest.mark.parametrize("world", WORLDS)
def test_sparse_sharded_bit_for_bit_with_unsharded(ranks, world):
    """Products of rows and of the replicated transpose sum in the
    unsharded order: the same bits as solve_sparse, and within 1e-12 of
    the JAX package's sharded solve."""
    got, port, jax_ = _get(ranks(world)[0], "sparse"), _port("sparse"), _jax("sparse")
    assert int(got["status_val"][0]) == ot.OSQP_SOLVED
    for f in R.FIELDS:
        assert torch.equal(torch.as_tensor(got[f]), torch.as_tensor(port[f])), f
    assert int(got["iter"][0]) == int(jax_["iter"][0])
    np.testing.assert_allclose(got["x"], jax_["x"], atol=1e-12, rtol=0)


@pytest.mark.parametrize("world", WORLDS)
def test_sparse_sharded_polish(ranks, world):
    got, port, jax_ = _get(ranks(world)[0], "sparse_polish"), _port("sparse_polish"), _jax("sparse_polish")
    assert int(got["status_val"][0]) == ot.OSQP_SOLVED
    assert int(got["status_polish"][0]) == int(port["status_polish"][0]) == 1
    np.testing.assert_allclose(got["x"], port["x"], atol=1e-9, rtol=0)
    np.testing.assert_allclose(got["x"], jax_["x"], atol=1e-9, rtol=0)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", ["dense_polish", "sparse_polish"])
def test_sharded_polish_gathers_no_more_than_an_m_vector(ranks, world, case):
    """A stays sharded through polish: no all-gather of the solve moves
    more than B m elements (m padded to a multiple of W), an m-vector an
    instance, where gathering A would move m n (dense) or its nnz slots."""
    for res in ranks(world):
        B, m = 1, int(res[f"{case}/padded_m"])
        assert 0 < int(res[f"{case}/largest_gather"]) <= B * m


@pytest.mark.parametrize("world", WORLDS)
def test_time_limit_stops_every_rank_at_the_same_segment(ranks, world):
    """time_limit=1e-9 at eps 1e-9: rank 0's clock stops every rank at the
    first poll, after the second segment (iteration 200), with the JAX
    package's status.  Dense: the JAX package's sharded solve stops at the
    same poll.  Sparse: the port's unsharded solve_sparse at the same
    limit, bit for bit, and the JAX package's sharded solve, whose
    segment loop drops its dispatch band (not ported on purpose) under a
    time limit, at the same poll too."""
    from osqp_tpu import constants as jcon

    res = ranks(world)
    for case in ("dense_time_limit", "sparse_time_limit"):
        got, jax_ = _get(res[0], case), _jax(case)
        assert int(got["status_val"][0]) == ot.OSQP_TIME_LIMIT_REACHED == jcon.OSQP_TIME_LIMIT_REACHED
        assert int(jax_["status_val"][0]) == jcon.OSQP_TIME_LIMIT_REACHED
        assert int(got["iter"][0]) == int(jax_["iter"][0]) == 200
        for r in range(1, world):
            assert all(torch.equal(torch.as_tensor(a), torch.as_tensor(b))
                       for a, b in zip(_get(res[r], case).values(), got.values())), r
    got, port = _get(res[0], "sparse_time_limit"), _port("sparse_time_limit")
    for f in R.FIELDS:
        assert torch.equal(torch.as_tensor(got[f]), torch.as_tensor(port[f])), f


@pytest.mark.parametrize("world", WORLDS)
def test_a_clock_past_the_limit_on_rank_1_alone_stops_no_rank(ranks, world):
    """Rank 1's clock reads 1e9 s past the solve's start at every poll;
    only rank 0's decides: every rank solves to the bits of the case with
    no limit."""
    res = ranks(world)
    want = _get(res[0], "dense50")
    assert int(want["status_val"][0]) == ot.OSQP_SOLVED
    for r in range(world):
        got = _get(res[r], "dense_clock_rank1")
        for f in R.FIELDS:
            assert torch.equal(torch.as_tensor(got[f]), torch.as_tensor(want[f])), (r, f)


@pytest.mark.parametrize("world", WORLDS)
def test_sigint_on_rank_1_stops_every_rank_at_the_same_segment(ranks, world):
    """Rank 1 raises SIGINT on itself as the second segment starts; the
    entries' handler records it, the next poll carries it to every rank,
    and all return OSQP_SIGINT (the JAX package's constant) at that
    segment's end with rank 0's bits; the handler is restored after."""
    from osqp_tpu import constants as jcon

    res = ranks(world)
    want = _get(res[0], "dense_sigint_rank1")
    for r in range(world):
        got = _get(res[r], "dense_sigint_rank1")
        assert int(got["status_val"][0]) == ot.OSQP_SIGINT == jcon.OSQP_SIGINT
        assert int(got["iter"][0]) == R.SIGINT_SEGMENT_END
        for f in R.FIELDS:
            assert torch.equal(torch.as_tensor(got[f]), torch.as_tensor(want[f])), (r, f)
        assert int(res[r]["sigint_handler_restored"]) == 1


@pytest.mark.parametrize("world", WORLDS)
def test_batch_sharded_matches_local_and_jax(ranks, world):
    res = ranks(world)[0]
    got, port, jax_ = _get(res, "batch"), _port("batch"), _jax("batch")
    assert got["x"].shape == (R.BATCH["B"], R.BATCH["n"])
    for want in (port, jax_):
        np.testing.assert_allclose(got["x"], want["x"], atol=1e-10, rtol=0)
        np.testing.assert_array_equal(got["status_val"], want["status_val"])
        np.testing.assert_array_equal(got["iter"], want["iter"])
    assert int(res["bad_batch_refused"]) == 1


@pytest.fixture(scope="module")
def multihost(tmp_path_factory):
    return R.spawn(2, str(tmp_path_factory.mktemp("mh")), "multihost")


def test_multihost_shards_the_corpus_and_sums_the_summary(multihost):
    """initialize, host_shard, run_maros(shard=...) on the HS rows in two
    ranks, then allreduce_summary: the counts of a one-process run."""
    from osqp_tpu_torch.maros import run_maros

    paths = [f"{R.MAROS}/{name}.qps" for name in R.HS_ROWS]
    _, whole = run_maros(paths, dtype="float64", verbose=False, device="cpu")
    names = []
    for r, res in enumerate(multihost):
        assert res["host_shard"].tolist() == [r, 2]
        names += res["names"].tolist()
        for k in ("problems", "solved", "final", "polish_success", "polish_fail"):
            assert int(res[f"summary/{k}"]) == whole[k], k
        assert float(res["summary/pass_rate"]) == whole["pass_rate"]
    assert sorted(names) == sorted(R.HS_ROWS)
