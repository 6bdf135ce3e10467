"""osqp_tpu_torch.program's sparse solve (SparseSolveProgram) and its
format-2 artifact (export.export_sparse_solver), on the CPU.

The program run eagerly against the live unsegmented solve bit for bit
(every field): the operands assembled from the value vectors through the
value maps, then ``_prepare`` -> ``admm.solve_core`` -> ``_postprocess``,
which a format-1 blob's callable runs.  The cases: float64 and float32,
polish off and on, B = 1 and a scenario batch of B = 3, rho adapting, a
primal infeasible instance.  Then one traced program per dtype (module
scope: a trace, save and load of the n = 80 problem takes ~20 s here):
no host read while tracing, while_loop operators in the graph, the
loaded program bit for bit with the eager one, the blob run by a process
in which neither package can be imported, and the loaded callable
against the JAX package's ``export_sparse_solver`` artifact (float64:
statuses and iterations equal, x and y within 1e-6; float32: statuses
equal, iterations within one check interval).
"""

import dataclasses
import io

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import osqp_tpu_torch
from osqp_tpu import export as jexport
from osqp_tpu_torch import admm, export, linalg, program
from osqp_tpu_torch import constants as con
from osqp_tpu_torch.batch import _postprocess, _prepare
from osqp_tpu_torch.solver import Settings, make_config
from osqp_tpu_torch.sparse_ops import ell_with_values
from torch_program_helpers import differ, graph_targets, run_torch_alone

torch.set_num_threads(2)

FIELDS = program.FIELDS
# The traced blobs' check interval: a turn of the program's loop unrolls
# this many iterations, and the trace's cost grows with it.
CHECK = 5


def _sparse_problem():
    """tests/test_torch_export.py's sparse problem (n = 80, m = 159)."""
    n = 80
    rng = np.random.default_rng(5)
    P = sp.diags(np.abs(rng.standard_normal(n)) + 1.0).tocsc()
    A = sp.vstack([sp.eye(n), sp.diags([1.0] * (n - 1), 1).tocsr()[: n - 1]]).tocsc()
    q = rng.standard_normal(n)
    m = A.shape[0]
    return P, q, A, -np.ones(m), np.ones(m)


def _batch(B, scale=1.0):
    """The problem as B scenarios sharing P and A, q scaled by
    scale * (1 + 0.1 i); the value vectors in CSC order."""
    P, q, A, l, u = _sparse_problem()
    qs = np.stack([scale * q * (1.0 + 0.1 * i) for i in range(B)])
    return P, A, (sp.triu(P, format="csc").data, qs, sp.csc_matrix(A).data, np.tile(l, (B, 1)), np.tile(u, (B, 1)))


def _infeasible_batch():
    """Three scenarios of the problem with x_0's row twice: its copy's
    bounds hold x_0 in [-10, 10], then in [5, 6] (disjoint from its
    first row's [-1, 1]: primal infeasible), then in [-0.5, 0.5]."""
    P, q, A, l, u = _sparse_problem()
    A = sp.vstack([A, sp.csr_matrix(([1.0], ([0], [0])), shape=(1, A.shape[1]))]).tocsc()
    l = np.stack([np.append(l, lo) for lo in (-10.0, 5.0, -0.5)])
    u = np.stack([np.append(u, hi) for hi in (10.0, 6.0, 0.5)])
    return P, A, (sp.triu(P, format="csc").data, np.tile(q, (3, 1)), A.data, l, u)


def _tensors(values, dtype):
    return [torch.as_tensor(np.ascontiguousarray(v), dtype=getattr(torch, dtype)) for v in values]


def _live(P, A, B, values, **kw):
    """The live unsegmented solve of a format-1 sparse blob's callable:
    the operands from the values through the maps, then _prepare,
    admm.solve_core and _postprocess."""
    s = Settings(**{"linsys_solver": "cg", **kw})
    dtype = getattr(torch, s.dtype)
    ops = program.sparse_operands(P, A)
    n, m = ops["P"]["shape"][0], ops["A"]["shape"][0]
    cfg = make_config(n, m, s, dtype)
    dyn = program.make_dyn(s, dtype)
    P_val, q, A_val, l, u = _tensors(values, s.dtype)
    ell = lambda op, v: ell_with_values(*op["pattern"], tuple(op["shape"]), *op["maps"], v.numpy(), dtype, batch=B)
    clamp = lambda v: torch.clamp(v, -con.OSQP_INFTY, con.OSQP_INFTY)
    rho0 = torch.full((B,), s.rho, dtype=dtype)
    scaled, scl, rs, factor, it = _prepare(cfg, int(s.scaling), ell(ops["P"], P_val), q, ell(ops["A"], A_val),
                                           clamp(l), clamp(u), rho0, dyn, None, None)
    fin = admm.solve_core(cfg, scaled, scl, dyn, rs, factor, it)
    return _postprocess(cfg, bool(s.polish), int(s.polish_refine_iter), scaled, scl, dyn, fin)


def _eager(P, A, B, values, **kw):
    out = program.SparseSolveProgram(program.sparse_operands(P, A), B, **kw)(*_tensors(values, kw["dtype"]))
    return dict(zip(FIELDS, out))


EAGER_CASES = {
    "float64, B=1": (1, dict(dtype="float64")),
    "float64, B=1, polish": (1, dict(dtype="float64", polish=True)),
    "float32, B=1": (1, dict(dtype="float32")),
    "float32, B=3, polish": (3, dict(dtype="float32", polish=True)),
    "float64, B=3, polish": (3, dict(dtype="float64", polish=True)),
}


@pytest.mark.parametrize("case", list(EAGER_CASES))
def test_eager_program_gives_the_live_bits(case):
    B, kw = EAGER_CASES[case]
    kw = dict(kw, verbose=False)
    P, A, values = _batch(B)
    live = _live(P, A, B, values, **kw)
    assert not differ(_eager(P, A, B, values, **kw), live)
    assert (live.status_val == 1).all()
    if kw.get("polish"):
        assert (live.status_polish == 1).all()


def test_eager_program_gives_the_live_bits_where_rho_adapts():
    """A long solve (q x40, eps 1e-7) with rho updated at every fifth
    iteration: the update's cond, its cg re-init and the inner tolerance
    schedule give the live loop's bits."""
    kw = dict(dtype="float64", verbose=False, check_termination=5, adaptive_rho_interval=5, eps_abs=1e-7,
              eps_rel=1e-7)
    P, A, values = _batch(3, scale=40.0)
    live = _live(P, A, 3, values, **kw)
    assert not differ(_eager(P, A, 3, values, **kw), live)
    assert (live.rho_updates > 0).all() and (live.status_val == 1).all()


def test_eager_program_gives_the_live_bits_on_a_primal_infeasible_instance():
    """Statuses 1, -3 and 1 in one batch, with the certificate, polish on."""
    kw = dict(dtype="float64", verbose=False, polish=True)
    P, A, values = _infeasible_batch()
    live = _live(P, A, 3, values, **kw)
    assert not differ(_eager(P, A, 3, values, **kw), live)
    assert live.status_val.tolist() == [1, -3, 1]


def test_solve_sparse_gives_the_program_bits():
    """solve_sparse (the live entry chip_smoke.py holds the card's blobs
    to) builds its operands from the matrices, not the maps: the same
    bits as the program on this pattern."""
    kw = dict(dtype="float64", verbose=False, polish=True)
    P, A, values = _batch(3)
    _, q, _, l, u = values
    live = osqp_tpu_torch.solve_sparse(P, q, A, l, u, device="cpu", **kw)
    assert not differ(_eager(P, A, 3, values, **kw), live)


# One traced blob a dtype, made once: float64 with polish, float32 without.
BLOB_CASES = {"float64": dict(dtype="float64", polish=True), "float32": dict(dtype="float32", polish=False)}
B_TRACED = 3


@pytest.fixture(scope="module")
def blobs():
    """(blob, host reads while tracing) by dtype."""
    out = {}
    P, A, _ = _batch(B_TRACED)
    for dtype, kw in BLOB_CASES.items():
        reads = linalg.host_reads
        blob = export.export_sparse_solver(P, A, B=B_TRACED, platforms=["cpu"], verbose=False,
                                           check_termination=CHECK, **kw)
        out[dtype] = (blob, linalg.host_reads - reads)
    return out


@pytest.mark.parametrize("dtype", list(BLOB_CASES))
def test_traced_program_reads_nothing_and_gives_the_eager_bits(blobs, dtype):
    """The trace read the host 0 times; the saved program holds its loops
    as while_loop operators (the ADMM loop and each plain CG solve, nested)
    and its decisions as conds, and, loaded, gives the eager program's
    bits, through load_sparse_solver too."""
    blob, reads = blobs[dtype]
    assert reads == 0
    spec = torch.load(io.BytesIO(blob), weights_only=True)
    assert spec["format_version"] == 2 and spec["kind"] == "sparse" and list(spec["programs"]) == ["cpu"]
    loaded = torch.export.load(io.BytesIO(spec["programs"]["cpu"])).module()
    targets = graph_targets(loaded)
    assert torch.ops.higher_order.while_loop in targets and torch.ops.higher_order.cond in targets
    kw = dict(BLOB_CASES[dtype], verbose=False, check_termination=CHECK)
    P, A, values = _batch(B_TRACED)
    eager = _eager(P, A, B_TRACED, values, **kw)
    with torch.no_grad():
        assert not differ(loaded(*_tensors(values, dtype)), eager)
    assert not differ(export.load_sparse_solver(blob, device="cpu")(*_tensors(values, dtype)), eager)
    assert not differ(eager, _live(P, A, B_TRACED, values, **kw))


def test_sparse_blob_runs_with_torch_alone(blobs, tmp_path):
    """The float64 blob, loaded by a process in which neither package can
    be imported, gives the live solve's bits."""
    blob, _ = blobs["float64"]
    kw = dict(BLOB_CASES["float64"], verbose=False, check_termination=CHECK)
    P, A, values = _batch(B_TRACED)
    (got,) = run_torch_alone([(blob, _tensors(values, "float64"))], tmp_path)
    assert not differ(got, _live(P, A, B_TRACED, values, **kw))


@pytest.mark.parametrize("dtype", list(BLOB_CASES))
def test_loaded_sparse_callable_matches_jax_artifact(blobs, dtype):
    """float64: statuses, iterations and status_polish equal, x and y
    within 1e-6; float32: statuses equal, iterations within one check
    interval."""
    kw = dict(BLOB_CASES[dtype], verbose=False, check_termination=CHECK)
    P, A, values = _batch(B_TRACED)
    inputs = [np.asarray(v, getattr(np, dtype)) for v in values]
    got = export.load_sparse_solver(blobs[dtype][0], device="cpu")(*inputs)
    want = jexport.load_sparse_solver(jexport.export_sparse_solver(P, A, B=B_TRACED, **kw))(*inputs)
    assert got["status_val"].tolist() == np.asarray(want["status_val"]).tolist()
    if dtype == "float64":
        assert got["iter"].tolist() == np.asarray(want["iter"]).tolist()
        assert got["status_polish"].tolist() == np.asarray(want["status_polish"]).tolist()
        for f in ("x", "y"):
            np.testing.assert_allclose(got[f].numpy(), np.asarray(want[f]), rtol=0, atol=1e-6, err_msg=f)
    else:
        assert np.abs(got["iter"].numpy().astype(int) - np.asarray(want["iter"]).astype(int)).max() <= CHECK


def test_format_1_sparse_blob_still_loads():
    """A sparse blob of the earlier format (the settings, pattern and maps
    alone) loads and runs the live solve."""
    kw = dict(dtype="float64", verbose=False)
    P, A, values = _batch(2)
    s = export._settings("float64", {"verbose": False}, linsys_solver="cg")
    ops = program.sparse_operands(P, A)
    blob = export._dump(dict(kind="sparse", B=2, n=ops["P"]["shape"][0], m=ops["A"]["shape"][0], dtype="float64",
                             platforms=["cpu"], settings=dataclasses.asdict(s), operands=ops), 1)
    got = export.load_sparse_solver(blob, device="cpu")(*values)
    assert not differ(got, _live(P, A, 2, values, **kw))


def test_program_refuses_other_inputs():
    P, A, values = _batch(1)
    prog = program.SparseSolveProgram(program.sparse_operands(P, A), 1, dtype="float64", verbose=False)
    with pytest.raises(ValueError, match="float64"):
        prog(*_tensors(values, "float32"))
    with pytest.raises(ValueError, match="cg"):
        program.SparseSolveProgram(program.sparse_operands(P, A), 1, linsys_solver="dense_inv")
