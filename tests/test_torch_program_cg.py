"""The traced program (osqp_tpu_torch.program) of the ``cg`` backend on
dense operands, the stepwise PCG as device control flow, and its
format-2 artifact, on the CPU.

On the card a traced dense ``cg`` solve is one call of K6's dense loop
operator (``cg_dense_loop``).  The stepwise program,
``ops.cg.pcg_solve_stepwise_program``, renders the step kernels' path
for any other operator: the stop test a ``while_loop`` turn before every
``CHUNK`` = 8 steps of K6's step operator, and the ``max_iter % CHUNK``
steps left under a ``cond``.  Here that loop runs
with the plain step summed in the kernel's order, against the plain
loop that tests before every eighth step (``pcg_solve_plain(chunk=
CHUNK)``, the live stepwise path's order): the same steps and bits at
caps that are and are not multiples of 8, eagerly and traced.  On CPU
tensors the program's CG is the plain loop, a nested ``while_loop``.
The program runs eagerly against the live ``solve_batch(segmented=
False)`` bit for bit in every field: float64 and float32, polish on,
rho adapting with a refactor of some instances, and a CG cap that is no
multiple of 8.  Then one traced float64 blob (module scope): no host
read while tracing, ``while_loop`` and ``cond`` operators, the loaded
program and a process that cannot import either package giving the live
bits, and the loaded callable against the JAX package's
``export_solver`` artifact with ``cg`` (float64: statuses and iterations
equal, x and y within 1e-6; float32 at the default eps, the eager
program: statuses equal, iterations within 25).
"""

import numpy as np
import pytest
import torch

import osqp_tpu_torch
from osqp_tpu import export as jexport
from osqp_tpu_torch import export, flow, linalg, program
from osqp_tpu_torch.ops import cg as k6
from test_batch import random_qps
from torch_program_helpers import (differ, graph_targets, loaded_program, partial, refactors, run_torch_alone,
                                   tensors)

torch.set_num_threads(2)

CHECK = 5
B, N, M = 3, 5, 7


def _run_both(args, **kw):
    """(the program's outputs, run eagerly; the live unsegmented solve's)."""
    kw = {"verbose": False, "dtype": "float64", "linsys_solver": "cg", **kw}
    ts = tensors(args, kw["dtype"])
    live = osqp_tpu_torch.solve_batch(*ts, device="cpu", segmented=False, **kw)
    return program.SolveProgram(ts[1].shape[1], ts[3].shape[1], **kw)(*ts), live


# ---------------------------------------------------------------------------
# The stepwise PCG as device control flow
# ---------------------------------------------------------------------------
def _plain_step(p, u, v, sigma, dinv, tol2, rz, rr, x, r, z, steps):
    """The step operator's contract in plain PyTorch (sums in the kernel's
    order): the new (p, x, r, z, rz, r'r, steps), contiguous as the
    operator's."""
    steps = steps + (rr > tol2).to(torch.int32)
    x, r, z, p, rz, rr = k6.cg_step_plain(p, u, v, sigma, dinv, x, r, rz, rr, tol2, k6.kernel_dot)
    return p, x, r, z, rz.contiguous(), rr.contiguous(), steps


def _cg_system(B=4, n=12, m=16, seed=3, frozen=True):
    """The cg backend's system at a random ADMM point: its dense operator,
    sigma, dinv, b, x0 and tol_rel (instance 0 already converged where
    ``frozen``)."""
    from osqp_tpu_torch.linsys import cg as cg_backend

    P, q, A, l, u = (torch.as_tensor(v) for v in random_qps(B, n, m, seed=seed))
    rng = np.random.default_rng(seed)
    rho = torch.as_tensor(rng.random((B, m)) + 0.1)
    fac = cg_backend.init(P, A, 1e-6, rho)
    x0 = torch.as_tensor(rng.standard_normal((B, n)))
    op = k6._operator(P, A, rho, plain=True)
    u_, v_ = op(x0)
    b = u_ + 1e-6 * x0 + v_ + torch.as_tensor(rng.standard_normal((B, n))) * 1e-3
    if frozen:
        b[0] = (u_ + 1e-6 * x0 + v_)[0]
    tol = torch.full((B,), 1e-12, dtype=torch.float64)
    return op, fac["sigma"], fac["dinv"], b, x0, tol


@pytest.mark.parametrize("max_iter", [3, 8, 13, 21, 400])
def test_stepwise_program_takes_the_live_chunks(max_iter):
    """The stepwise program over the plain step, eagerly, against the plain
    loop that tests before every eighth step: x and the steps bit for bit,
    at caps inside one chunk, at one chunk, with a tail, and where every
    instance converges first; one host read a turn and one for a tail."""
    op, sigma, dinv, b, x0, tol = _cg_system()
    want = k6.pcg_solve_plain(op, sigma, dinv, b, tol, max_iter, x0, chunk=k6.CHUNK, dot=k6.kernel_dot)
    reads = linalg.host_reads
    got = k6.pcg_solve_stepwise_program(op, sigma, dinv, b, tol, max_iter, x0, step=_plain_step)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    turns = -(-int(want[1].max()) // k6.CHUNK) if max_iter >= k6.CHUNK else 0
    whole, tail = divmod(max_iter, k6.CHUNK)
    expect = min(turns + 1, whole + 1) if whole else 0
    assert linalg.host_reads - reads == expect + (tail > 0)
    assert int(want[1][0]) == 0 and int(want[1].max()) <= max_iter


class _Stepwise(torch.nn.Module):
    def __init__(self, max_iter):
        super().__init__()
        self.max_iter = max_iter

    def forward(self, P, A, rho, dinv, b, x0, tol):
        op = k6._operator(P, A, rho, plain=True)
        with flow.program():
            return k6.pcg_solve_stepwise_program(op, torch.tensor(1e-6, dtype=torch.float64), dinv, b, tol,
                                                 self.max_iter, x0, step=_plain_step)


def test_stepwise_program_traces_to_a_while_loop_and_a_cond():
    """Traced at a cap of 13 (one chunk and a tail of 5), with no host
    read: a while_loop and a cond, and the traced loop's bits."""
    op, sigma, dinv, b, x0, tol = _cg_system()
    inputs = (op.P, op.A, op.w, dinv, b, x0, tol)
    reads = linalg.host_reads
    ep = torch.export.export(_Stepwise(13), inputs, strict=False)
    assert linalg.host_reads == reads
    targets = graph_targets(ep.module())
    assert torch.ops.higher_order.while_loop in targets and torch.ops.higher_order.cond in targets
    want = k6.pcg_solve_plain(op, sigma, dinv, b, tol, 13, x0, chunk=k6.CHUNK, dot=k6.kernel_dot)
    got = ep.module()(*inputs)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_a_traced_dense_solve_takes_the_stepwise_program():
    """On the card the route of a dense operator is the dense loop live and
    its operator in a trace; any other operator's is the stepwise path
    live and the stepwise program in a trace; on the CPU the plain loop."""
    dense = k6._operator(torch.eye(3, dtype=torch.float64)[None], torch.ones((1, 2, 3), dtype=torch.float64),
                         torch.ones((1, 2), dtype=torch.float64), plain=False)
    assert isinstance(dense, k6.DenseOperator)
    assert k6._route(dense, "cuda") is k6.pcg_solve_dense_loop
    assert k6._route(dense, "cuda", traced=True) is k6.pcg_solve_dense_loop_op
    generic = lambda p: (p, None)  # noqa: E731
    assert k6._route(generic, "cuda") is k6.pcg_solve_stepwise
    assert k6._route(generic, "cuda", traced=True) is k6.pcg_solve_stepwise_program
    assert k6._route(dense, "cpu", traced=True) is k6.pcg_solve_plain


# ---------------------------------------------------------------------------
# The program of the cg backend on dense operands
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype,polish", [("float64", False), ("float64", True), ("float32", False)])
def test_eager_program_gives_the_live_bits(dtype, polish):
    out, live = _run_both(random_qps(4, 6, 9, seed=2), dtype=dtype, polish=polish)
    assert not differ(out, live)
    assert (live.status_val == 1).all()
    if polish:
        assert (live.status_polish == 1).all()


def test_eager_program_gives_the_live_bits_where_rho_adapts(monkeypatch):
    """Rho updated at every fifth iteration, some refactor updating some
    instances; the inner tolerance retuned at each check."""
    masks = refactors(monkeypatch)
    out, live = _run_both(random_qps(4, 6, 9, seed=5), check_termination=5, adaptive_rho_interval=5, eps_abs=1e-7,
                          eps_rel=1e-7)
    assert not differ(out, live)
    assert (live.rho_updates > 0).any() and (live.status_val == 1).all()
    assert partial(masks)


def test_eager_program_gives_the_live_bits_with_a_cap_off_the_chunks():
    """cg_max_iter = 13, no multiple of CHUNK: the capped CG solves give
    the live solve's bits."""
    out, live = _run_both(random_qps(4, 8, 12, seed=7), cg_max_iter=13, eps_abs=1e-6, eps_rel=1e-6)
    assert not differ(out, live)


@pytest.fixture(scope="module")
def blob():
    """(blob, host reads while tracing, its program loaded): float64,
    polish off."""
    reads = linalg.host_reads
    blob = export.export_solver(B, N, M, dtype="float64", platforms=["cpu"], verbose=False, check_termination=CHECK,
                                linsys_solver="cg")
    return blob, linalg.host_reads - reads, loaded_program(blob)


def _inputs():
    return random_qps(B, N, M, seed=4)


def _live():
    return osqp_tpu_torch.solve_batch(*tensors(_inputs(), "float64"), device="cpu", segmented=False, verbose=False,
                                      dtype="float64", check_termination=CHECK, linsys_solver="cg")


def test_traced_program_reads_nothing_and_gives_the_live_bits(blob):
    _, reads, (spec, loaded) = blob
    assert reads == 0
    assert spec["format_version"] == 2 and spec["settings"]["linsys_solver"] == "cg"
    targets = graph_targets(loaded)
    assert torch.ops.higher_order.while_loop in targets and torch.ops.higher_order.cond in targets
    with torch.no_grad():
        assert not differ(loaded(*tensors(_inputs(), "float64")), _live())


def test_blob_runs_with_torch_alone(blob, tmp_path):
    (got,) = run_torch_alone([(blob[0], tensors(_inputs(), "float64"))], tmp_path)
    assert not differ(got, _live())


def test_loaded_callable_matches_the_jax_artifact(blob):
    """float64, the blob through load_solver: statuses and iterations
    equal, x and y within 1e-6; float32 at the default eps (ROADMAP queue
    3: the dense cg's f32 counts spread at eps 1e-6), the eager program:
    statuses equal, iterations within 25."""
    args = [np.asarray(v) for v in _inputs()]
    kw = dict(verbose=False, check_termination=CHECK, linsys_solver="cg")
    got = export.load_solver(blob[0], device="cpu")(*args)
    want = jexport.load_solver(jexport.export_solver(B, N, M, dtype="float64", **kw))(*args)
    for f in ("status_val", "iter"):
        assert got[f].tolist() == np.asarray(want[f]).tolist(), f
    for f in ("x", "y"):
        np.testing.assert_allclose(got[f].numpy(), np.asarray(want[f]), rtol=0, atol=1e-6, err_msg=f)
    out, _ = _run_both(_inputs(), dtype="float32", **kw)
    got = dict(zip(program.FIELDS, out))
    want = jexport.load_solver(jexport.export_solver(B, N, M, dtype="float32", **kw))(
        *[a.astype(np.float32) for a in args])
    assert got["status_val"].tolist() == np.asarray(want["status_val"]).tolist()
    assert np.abs(got["iter"].numpy().astype(int) - np.asarray(want["iter"]).astype(int)).max() <= 25
