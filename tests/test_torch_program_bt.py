"""The traced program (osqp_tpu_torch.program) of the ``block_tridiag``
backend, and its format-2 artifact, on the CPU.

K7's wrappers take their operators (``bt_factor``, ``bt_solve``) on
traced CUDA tensors; here, on CPU tensors, their plain versions.  The
inputs are MPC batches of ``models/mpc.py`` (``build_mpc_qp`` of both packages)
with b = 3 and Nb = 3: a double integrator over two stages, B = 4
initial states.  The program runs eagerly against the live
``solve_batch(segmented=False)`` bit for bit in every field: float64 and
float32, polish on, and rho adapting with a refactor of some instances.
Then one traced float64 blob (module scope, written by
``Solver.export``): no host read while
tracing, ``while_loop`` and ``cond`` operators in the graph, the loaded
program and a process that cannot import either package giving the live
bits, and the loaded callable against the JAX package's
``export_solver`` artifact with ``block_tridiag`` (float64: statuses and
iterations equal, x and y within 1e-6; float32, the eager program:
statuses equal, iterations within 25).  ``validate_structure`` is a host
check of the live entry points, not of the program, as in the JAX
package.
"""

import numpy as np
import pytest
import torch

import osqp_tpu_torch
from osqp_tpu import export as jexport
from osqp_tpu.models import build_mpc_qp as jbuild_mpc_qp
from osqp_tpu_torch import export, linalg, program
from osqp_tpu_torch.linsys import block_tridiag
from osqp_tpu_torch.models import build_mpc_qp
from torch_program_helpers import (differ, graph_targets, loaded_program, partial, refactors, run_torch_alone,
                                   tensors)

torch.set_num_threads(2)

CHECK = 5
B = 4


def _mpc(build, B=B, horizon=2, seed=0):
    """A double integrator (nx = 2, nu = 1: b = 3) over ``horizon``
    stages (Nb = horizon + 1), built by ``build`` (either package's), for
    B initial states: (block size, [P, q, A, l, u]) as (B, ...) arrays."""
    rng = np.random.default_rng(seed)
    Ad = np.array([[1.0, 0.1], [0.0, 1.0]]) + 0.01 * rng.standard_normal((2, 2))
    Bd = np.array([[0.005], [0.1]])
    base = build(Ad, Bd, np.eye(2), 0.1 * np.eye(1), horizon=horizon, xmin=np.full(2, -10.0), xmax=np.full(2, 10.0),
                 umin=np.full(1, -1.0), umax=np.full(1, 1.0))
    x0 = 3.0 * rng.standard_normal((B, 2))
    l, u = np.tile(base.l, (B, 1)), np.tile(base.u, (B, 1))
    l[:, :2], u[:, :2] = x0, x0
    return base.block_size, [np.tile(base.P, (B, 1, 1)), np.tile(base.q, (B, 1)), np.tile(base.A, (B, 1, 1)), l, u]


def _settings(**kw):
    b, _ = _mpc(build_mpc_qp)
    return {"verbose": False, "dtype": "float64", "linsys_solver": "block_tridiag", "block_size": b, **kw}


def _run_both(args, **kw):
    """(the program's outputs, run eagerly; the live unsegmented solve's)."""
    kw = _settings(**kw)
    ts = tensors(args, kw["dtype"])
    live = osqp_tpu_torch.solve_batch(*ts, device="cpu", segmented=False, **kw)
    return program.SolveProgram(ts[1].shape[1], ts[3].shape[1], **kw)(*ts), live


def test_the_mpc_batch_is_stage_structured():
    """Both packages build the same batch, b = 3 and Nb = 3, and it passes
    the backend's host check."""
    (b, args), (jb, jargs) = _mpc(build_mpc_qp), _mpc(jbuild_mpc_qp)
    assert b == jb == 3 and args[1].shape[1] == 3 * b
    for a, j in zip(args, jargs):
        np.testing.assert_array_equal(a, j)
    block_tridiag.validate_structure(args[0], args[2], b)


@pytest.mark.parametrize("dtype,polish", [("float64", False), ("float64", True), ("float32", False)])
def test_eager_program_gives_the_live_bits(dtype, polish):
    out, live = _run_both(_mpc(build_mpc_qp)[1], dtype=dtype, polish=polish)
    assert not differ(out, live)
    assert (live.status_val == 1).all()
    if polish:
        assert (live.status_polish == 1).all()


def test_eager_program_gives_the_live_bits_where_rho_adapts(monkeypatch):
    """Rho updated at every fifth iteration, some refactor updating some
    instances and keeping the others (C and G merged per instance)."""
    masks = refactors(monkeypatch)
    out, live = _run_both(_mpc(build_mpc_qp, seed=3)[1], check_termination=5, adaptive_rho_interval=5,
                          eps_abs=1e-7, eps_rel=1e-7)
    assert not differ(out, live)
    assert (live.rho_updates > 0).any() and (live.status_val == 1).all()
    assert partial(masks)


@pytest.fixture(scope="module")
def blob():
    """(blob, host reads while tracing, its program loaded, the Solver's
    result): ``Solver.export(B=4)`` of a Solver on the batch's first
    instance, float64, polish off."""
    b, args = _mpc(build_mpc_qp)
    s = osqp_tpu_torch.Solver(*(a[0] for a in args), device="cpu", **_settings(check_termination=CHECK))
    r = s.solve()
    reads = linalg.host_reads
    blob = s.export(B=B)
    return blob, linalg.host_reads - reads, loaded_program(blob), r


def _live():
    ts = tensors(_mpc(build_mpc_qp)[1], "float64")
    return osqp_tpu_torch.solve_batch(*ts, device="cpu", segmented=False, **_settings(check_termination=CHECK))


def test_traced_program_reads_nothing_and_gives_the_live_bits(blob):
    _, reads, (spec, loaded), _ = blob
    assert reads == 0
    assert spec["format_version"] == 2 and spec["settings"]["block_size"] == 3
    targets = graph_targets(loaded)
    assert torch.ops.higher_order.while_loop in targets and torch.ops.higher_order.cond in targets
    with torch.no_grad():
        assert not differ(loaded(*tensors(_mpc(build_mpc_qp)[1], "float64")), _live())


def test_blob_runs_with_torch_alone(blob, tmp_path):
    (got,) = run_torch_alone([(blob[0], tensors(_mpc(build_mpc_qp)[1], "float64"))], tmp_path)
    assert not differ(got, _live())


def test_loaded_callable_matches_the_jax_artifact(blob):
    """float64, the blob through load_solver: statuses and iterations
    equal, x and y within 1e-6; float32, the eager program: statuses
    equal, iterations within 25.  The JAX artifact takes the JAX
    package's MPC batch."""
    _, args = _mpc(build_mpc_qp)
    _, jargs = _mpc(jbuild_mpc_qp)
    kw = _settings(check_termination=CHECK)
    n, m = args[1].shape[1], args[3].shape[1]
    got = export.load_solver(blob[0], device="cpu")(*args)
    want = jexport.load_solver(jexport.export_solver(B, n, m, **kw))(*jargs)
    for f in ("status_val", "iter"):
        assert got[f].tolist() == np.asarray(want[f]).tolist(), f
    for f in ("x", "y"):
        np.testing.assert_allclose(got[f].numpy(), np.asarray(want[f]), rtol=0, atol=1e-6, err_msg=f)
    out, _ = _run_both(args, **dict(kw, dtype="float32"))
    got = dict(zip(program.FIELDS, out))
    want = jexport.load_solver(jexport.export_solver(B, n, m, **dict(kw, dtype="float32")))(
        *[a.astype(np.float32) for a in jargs])
    assert got["status_val"].tolist() == np.asarray(want["status_val"]).tolist()
    assert np.abs(got["iter"].numpy().astype(int) - np.asarray(want["iter"]).astype(int)).max() <= 25


def test_solver_export_writes_the_program(blob):
    """Solver.export with block_tridiag writes format 2 with the block
    size in its settings; its program gives the Solver's solve on the
    Solver's instance."""
    _, _, (spec, loaded), r = blob
    assert spec["format_version"] == 2 and spec["settings"]["linsys_solver"] == "block_tridiag"
    with torch.no_grad():
        out = dict(zip(program.FIELDS, loaded(*tensors(_mpc(build_mpc_qp)[1], "float64"))))
    assert int(out["status_val"][0]) == 1 and int(out["iter"][0]) == r.info.iter
    np.testing.assert_allclose(out["x"][0].numpy(), r.x, rtol=0, atol=1e-9)
