"""The traced program (osqp_tpu_torch.program) of the ``kkt_lu`` and
``dense_chol`` backends, and their format-2 artifacts, on the CPU.

Neither backend has an operator of its own: ``kkt_lu`` factors and
solves through K8's wrappers (their plain versions here: the K8 loops,
never a library LU), ``dense_chol`` through torch's Cholesky.  The
program runs eagerly against the live ``solve_batch(segmented=False)``
bit for bit in every field: float64 and float32, polish on, and rho
adapting (for ``kkt_lu`` with a refactor of some instances of the batch,
whose ``lu`` and ``perm`` merge together per instance).  Then one traced
float64 blob per backend (module scope: a trace, save and load take
~10-30 s here): no host read while tracing, ``while_loop`` and ``cond``
operators in the graph, the loaded program and a process that cannot
import either package giving the live bits, and the loaded callable
against the JAX package's ``export_solver`` artifact of the same
backend (float64: statuses and iterations equal, x and y within 1e-6;
float32, the eager program: statuses equal, iterations within 25).
"""

import dataclasses

import numpy as np
import pytest
import torch

import osqp_tpu_torch
from osqp_tpu import export as jexport
from osqp_tpu_torch import export, linalg, program
from test_batch import random_qps
from torch_program_helpers import (differ, graph_targets, loaded_program, partial, refactors, run_torch_alone,
                                   tensors)

torch.set_num_threads(2)

BACKENDS = ("kkt_lu", "dense_chol")
# The traced blobs' check interval: a turn of the program's loop unrolls
# this many iterations, and the trace's cost grows with it.
CHECK = 5
B, N, M = 3, 5, 7


def _run_both(args, **kw):
    """(the program's outputs, run eagerly; the live unsegmented solve's)."""
    kw = {"verbose": False, "dtype": "float64", **kw}
    ts = tensors(args, kw["dtype"])
    live = osqp_tpu_torch.solve_batch(*ts, device="cpu", segmented=False, **kw)
    return program.SolveProgram(ts[1].shape[1], ts[3].shape[1], **kw)(*ts), live


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("dtype,polish", [("float64", False), ("float64", True), ("float32", False)])
def test_eager_program_gives_the_live_bits(backend, dtype, polish):
    out, live = _run_both(random_qps(4, 6, 9, seed=2), dtype=dtype, polish=polish, linsys_solver=backend)
    assert not differ(out, live)
    assert (live.status_val == 1).all()
    if polish:
        assert (live.status_polish == 1).all()


@pytest.mark.parametrize("backend", BACKENDS)
def test_eager_program_gives_the_live_bits_where_rho_adapts(backend, monkeypatch):
    """Rho updated at every fifth iteration; for kkt_lu some refactor
    updates some instances of the batch and keeps the others, whose
    factor (lu with its perm) the cond's merge keeps per instance."""
    masks = refactors(monkeypatch)
    out, live = _run_both(random_qps(4, 6, 9, seed=5), check_termination=5, adaptive_rho_interval=5, eps_abs=1e-7,
                          eps_rel=1e-7, linsys_solver=backend)
    assert not differ(out, live)
    assert (live.rho_updates > 0).any() and (live.status_val == 1).all()
    assert partial(masks)


@pytest.fixture(scope="module")
def blobs():
    """{backend: (blob, host reads while tracing, its program loaded)}:
    float64, polish off."""
    out = {}
    for backend in BACKENDS:
        reads = linalg.host_reads
        blob = export.export_solver(B, N, M, dtype="float64", platforms=["cpu"], verbose=False,
                                    check_termination=CHECK, linsys_solver=backend)
        out[backend] = (blob, linalg.host_reads - reads, loaded_program(blob))
    return out


def _inputs():
    return random_qps(B, N, M, seed=4)


def _live(backend):
    return osqp_tpu_torch.solve_batch(*tensors(_inputs(), "float64"), device="cpu", segmented=False, verbose=False,
                                      dtype="float64", check_termination=CHECK, linsys_solver=backend)


@pytest.mark.parametrize("backend", BACKENDS)
def test_traced_program_reads_nothing_and_gives_the_live_bits(blobs, backend):
    """The trace read the host 0 times; the saved program holds its loop
    as a while_loop and its decisions as conds, and, loaded, gives the
    live solve's bits."""
    _, reads, (spec, loaded) = blobs[backend]
    assert reads == 0
    assert spec["format_version"] == 2 and spec["settings"]["linsys_solver"] == backend
    targets = graph_targets(loaded)
    assert torch.ops.higher_order.while_loop in targets and torch.ops.higher_order.cond in targets
    with torch.no_grad():
        assert not differ(loaded(*tensors(_inputs(), "float64")), _live(backend))


def test_blobs_run_with_torch_alone(blobs, tmp_path):
    """Both blobs, loaded by one process in which neither package can be
    imported, give the live solve's bits."""
    ts = tensors(_inputs(), "float64")
    outs = run_torch_alone([(blobs[backend][0], ts) for backend in BACKENDS], tmp_path)
    for backend, got in zip(BACKENDS, outs):
        assert not differ(got, _live(backend)), backend


@pytest.mark.parametrize("backend", BACKENDS)
def test_loaded_callable_matches_the_jax_artifact(blobs, backend, monkeypatch):
    """float64, the blob through load_solver: statuses and iterations
    equal, x and y within 1e-6, on a case where no refactor is partial
    (the JAX package pairs a kept kkt_lu factor with a new perm there:
    ROADMAP queue 3); float32, the eager program: statuses equal,
    iterations within 25."""
    masks = refactors(monkeypatch)
    _live(backend)
    assert not partial(masks)
    args = [np.asarray(v) for v in _inputs()]
    kw = dict(verbose=False, check_termination=CHECK, linsys_solver=backend)
    got = export.load_solver(blobs[backend][0], device="cpu")(*args)
    want = jexport.load_solver(jexport.export_solver(B, N, M, dtype="float64", **kw))(*args)
    for f in ("status_val", "iter"):
        assert got[f].tolist() == np.asarray(want[f]).tolist(), f
    for f in ("x", "y"):
        np.testing.assert_allclose(got[f].numpy(), np.asarray(want[f]), rtol=0, atol=1e-6, err_msg=f)
    out, _ = _run_both(_inputs(), dtype="float32", **kw)
    got = dict(zip(program.FIELDS, out))
    f32 = [a.astype(np.float32) for a in args]
    want = jexport.load_solver(jexport.export_solver(B, N, M, dtype="float32", **kw))(*f32)
    assert got["status_val"].tolist() == np.asarray(want["status_val"]).tolist()
    assert np.abs(got["iter"].numpy().astype(int) - np.asarray(want["iter"]).astype(int)).max() <= 25


def test_format_1_dense_blob_still_loads():
    """A dense blob of the earlier format (the settings alone) for kkt_lu
    loads and runs the live unsegmented solve."""
    s = export._settings("float64", {"verbose": False, "linsys_solver": "kkt_lu", "check_termination": CHECK})
    blob = export._dump(dict(kind="dense", B=B, n=N, m=M, dtype="float64", platforms=["cpu"],
                             settings=dataclasses.asdict(s)), 1)
    got = export.load_solver(blob, device="cpu")(*_inputs())
    assert not differ(got, _live("kkt_lu"))
