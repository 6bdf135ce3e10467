"""osqp_tpu_torch.program, the dense solve as one traceable program, on the CPU.

``solve_batch_program`` run eagerly against the live ``solve_batch`` bit
for bit (every field) in each case the program's control flow decides
something: float64 with polish off and on, a rho update, primal and dual
infeasible instances, float32 with the TwoSum carry, a batch on the
refined body, and a batch where the residual guard fires (held to 1e-6
there: the program's guard inverts the whole batch by Cholesky, the live
one the flagged instances alone).  Then the program against the JAX
package's ``solve_batch_jit`` (``osqp_tpu.solve_batch(segmented=False)``),
the trace (no host read, a ``while_loop`` node), and a format-2 blob
loaded and run by a process in which neither package can be imported.
"""

import io

import numpy as np
import pytest
import torch

import osqp_tpu
import osqp_tpu_torch
from osqp_tpu_torch import export, flow, linalg, program
from osqp_tpu_torch.linsys import dense_inv
from osqp_tpu_torch.solver import Settings, make_config
from test_batch import random_qps
from torch_program_helpers import differ, run_torch_alone

torch.set_num_threads(2)

FIELDS = program.FIELDS
CHECK = 25


def _run_both(args, **kw):
    """(the program's outputs, run eagerly; the live solve_batch's)."""
    kw = {"verbose": False, "dtype": "float64", **kw}
    dtype = getattr(torch, kw["dtype"])
    ts = [torch.as_tensor(v, dtype=dtype) for v in args]
    live = osqp_tpu_torch.solve_batch(*ts, device="cpu", **kw)
    return program.SolveProgram(ts[1].shape[1], ts[3].shape[1], **kw)(*ts), live


def _infeasible_batch():
    """A solvable instance, a primal infeasible one (a row twice with
    disjoint bounds) and a dual infeasible one (P = 0, q pointing down an
    unconstrained direction)."""
    P, q, A, l, u = random_qps(3, 4, 5, seed=12)
    A[1, 1] = A[1, 0]
    l[1, 0], u[1, 0] = 1.0, 2.0
    l[1, 1], u[1, 1] = 5.0, 6.0
    P[2] = 0.0
    q[2] = [-1.0, 0.5, 0.0, 0.0]
    A[2] = 0.0
    A[2, :, 1:] = np.eye(5, 3)
    l[2], u[2] = -1.0, 1.0
    return P, q, A, l, u


def _ill_conditioned(scale, seed=2):
    """test_torch_batch.py's recipe: equality rows, loose rows and P
    scaled by ``scale``, so that the dense_inv factor's inverse residual
    passes the refine gate (0.1 in float32, 0.01 in float64) and stays
    under the residual guard."""
    P, q, A, l, u = random_qps(3, 12, 18, seed=seed)
    u[:, :4] = l[:, :4]
    l[:, 4:12], u[:, 4:12] = -1e30, 1e30
    return P * scale, q, A, l, u


@pytest.mark.parametrize("dtype,polish", [("float64", False), ("float64", True), ("float32", False)])
def test_program_gives_the_live_bits(dtype, polish):
    out, live = _run_both(random_qps(4, 6, 9, seed=2), dtype=dtype, polish=polish)
    assert not differ(out, live)
    assert (live.status_val == 1).all()
    if polish:
        assert (live.status_polish == 1).all()


def test_program_gives_the_live_bits_where_rho_adapts():
    """Rho updated at every fifth iteration: the update's cond and its
    refactor give the live loop's rho, its counts and its iterates."""
    out, live = _run_both(random_qps(4, 6, 9, seed=5), check_termination=5, adaptive_rho_interval=5,
                          eps_abs=1e-7, eps_rel=1e-7)
    assert not differ(out, live)
    assert (live.rho_updates > 0).any()


def test_program_gives_the_live_bits_with_a_rho_interval_off_the_checks():
    """A rho interval that is no multiple of the check interval: the
    update falls at several places of a turn."""
    out, live = _run_both(random_qps(3, 5, 7, seed=6), check_termination=10, adaptive_rho_interval=4,
                          eps_abs=1e-7, eps_rel=1e-7, max_iter=57)
    assert not differ(out, live)
    assert (live.rho_updates > 0).any()


def test_program_gives_the_live_bits_on_infeasible_instances():
    """Statuses 1, -3 and -4 in one batch, with their certificates."""
    out, live = _run_both(_infeasible_batch(), polish=True)
    assert not differ(out, live)
    assert live.status_val.tolist() == [1, -3, -4]


def test_program_gives_the_live_bits_in_float32_with_the_carry():
    """float32 on the refined body, which carries the TwoSum low part of y."""
    args = _ill_conditioned(0.1)
    out, live = _run_both(args, dtype="float32")
    assert not differ(out, live)
    assert _refine_signal(*(torch.as_tensor(v, dtype=torch.float32) for v in args))


def _refine_signal(P, q, A, l, u) -> bool:
    """Does the solve's factor set the refinement signal?"""
    from osqp_tpu_torch.batch import _prepare

    s = Settings(verbose=False, dtype=P.dtype)
    dtype = P.dtype
    cfg = make_config(q.shape[1], l.shape[1], s, dtype)
    rho0 = torch.full((q.shape[0],), s.rho, dtype=dtype)
    factor = _prepare(cfg, int(s.scaling), P, q, A, l, u, rho0, program.make_dyn(s, dtype), None, None)[3]
    return bool(dense_inv.refine_signal(factor))


def test_program_gives_the_live_bits_on_the_refined_body():
    args = _ill_conditioned(0.01)
    assert _refine_signal(*(torch.as_tensor(v) for v in args))
    rescued = dense_inv.guard_rescued
    out, live = _run_both(args)
    assert dense_inv.guard_rescued == rescued
    assert not differ(out, live)


def test_program_where_the_guard_fires(monkeypatch):
    """One instance whose K2 inverse is off by 1%, above the guard: the
    program's guard (a cond over the whole batch) against the live one
    (the flagged instance alone) to 1e-6, statuses and iterations equal."""
    from osqp_tpu_torch.ops import spd_inverse as k2

    real = k2.spd_inverse
    monkeypatch.setattr(k2, "spd_inverse", lambda M: real(M) * torch.tensor([1.0, 1.01, 1.0], dtype=M.dtype)[:, None, None])
    rescued = dense_inv.guard_rescued
    out, live = _run_both(random_qps(3, 6, 9, seed=4))
    assert dense_inv.guard_rescued == rescued + 1
    got = dict(zip(FIELDS, out))
    for f in ("status_val", "iter", "status_polish"):
        assert torch.equal(got[f], getattr(live, f)), f
    for f in ("x", "y"):
        np.testing.assert_allclose(got[f].numpy(), getattr(live, f).numpy(), rtol=0, atol=1e-6, err_msg=f)


def test_program_reads_the_device_once_a_turn_and_at_each_decision():
    """Run eagerly, the program's host reads are its decisions: the guard,
    the body, one a turn of the loop (and the last), one a possible rho
    place a turn, one a rho update."""
    ts = [torch.as_tensor(v) for v in random_qps(4, 6, 9, seed=2)]
    reads = linalg.host_reads
    out = program.SolveProgram(6, 9, verbose=False, dtype="float64")(*ts)
    iters = int(dict(zip(FIELDS, out))["iter"].max())
    turns = iters // CHECK
    assert linalg.host_reads - reads == 2 + (turns + 1) + turns


def test_program_matches_the_jax_solve_batch_jit():
    """float64: statuses and iterations equal, x and y within 1e-6;
    float32: statuses equal, iterations within a check interval."""
    args = random_qps(5, 7, 10, seed=21)
    args[1][3] *= 40.0  # a longer solve: rho adapts there
    for dtype in ("float64", "float32"):
        out, _ = _run_both(args, dtype=dtype, polish=True)
        got = dict(zip(FIELDS, out))
        rj = osqp_tpu.solve_batch(*args, dtype=dtype, polish=True, verbose=False, segmented=False)
        np.testing.assert_array_equal(got["status_val"].numpy(), np.asarray(rj.status_val))
        if dtype == "float64":
            np.testing.assert_array_equal(got["iter"].numpy(), np.asarray(rj.iter))
            np.testing.assert_array_equal(got["status_polish"].numpy(), np.asarray(rj.status_polish))
            for f in ("x", "y"):
                np.testing.assert_allclose(got[f].numpy(), np.asarray(getattr(rj, f)), rtol=0, atol=1e-6, err_msg=f)
        else:
            assert np.abs(got["iter"].numpy().astype(int) - np.asarray(rj.iter).astype(int)).max() <= CHECK


def test_trace_reads_nothing_and_holds_a_while_loop():
    """torch.export traces the program with no host read; its graph holds
    the loop as a while_loop operator and the decisions as conds."""
    ts = [torch.as_tensor(v) for v in random_qps(2, 3, 4, seed=3)]
    reads = linalg.host_reads
    ep = torch.export.export(program.SolveProgram(3, 4, verbose=False, dtype="float64", check_termination=5), tuple(ts), strict=False)
    assert linalg.host_reads == reads
    targets = {n.target for _, g in ep.graph_module.named_modules() if hasattr(g, "graph")
               for n in g.graph.nodes if n.op == "call_function"}
    assert torch.ops.higher_order.while_loop in targets and torch.ops.higher_order.cond in targets


def test_flow_reads_the_host_only_when_not_tracing():
    """flow.cond and flow.while_loop run eagerly with one counted read a
    decision, and rebuild nested operands (dataclasses, dicts, tuples)."""
    reads = linalg.host_reads
    c = {"k": torch.tensor(0), "v": (torch.ones(2), None)}
    out = flow.while_loop(lambda c, lim: c["k"] < lim, lambda c, lim: {"k": c["k"] + 1, "v": (c["v"][0] * 2, None)},
                          c, (torch.tensor(3),))
    assert int(out["k"]) == 3 and out["v"][0].tolist() == [8.0, 8.0] and out["v"][1] is None
    assert linalg.host_reads - reads == 4
    assert flow.cond(torch.tensor(False), lambda a: a + 1, lambda a: a - 1, (torch.tensor(1),)).item() == 0
    assert not flow.in_program()
    with flow.program():
        assert flow.in_program()


def test_format_2_blob_runs_with_torch_alone(tmp_path):
    """A CPU blob, loaded by a process in which neither package can be
    imported, gives the live solve's bits; load_solver gives them too."""
    B, n, m = 3, 5, 7
    kw = dict(dtype="float64", verbose=False, check_termination=5)
    ts = [torch.as_tensor(v) for v in random_qps(B, n, m, seed=4)]
    blob = export.export_solver(B, n, m, platforms=["cpu"], **kw)
    spec = torch.load(io.BytesIO(blob), weights_only=True)
    assert spec["format_version"] == 2 and list(spec["programs"]) == ["cpu"] and "ops_library" not in spec
    live = osqp_tpu_torch.solve_batch(*ts, device="cpu", **kw)
    (got,) = run_torch_alone([(blob, ts)], tmp_path)
    assert not differ(got, live)
    here = export.load_solver(blob, device="cpu")(*ts)
    assert not differ(here, live)


def test_program_refuses_other_backends():
    """Every backend runs on dense operands; on ELL operands only cg: a
    dense backend there is refused, by solve_batch_program and by
    SparseSolveProgram."""
    import scipy.sparse as sp

    from osqp_tpu_torch.sparse_ops import ell_from_scipy

    P = ell_from_scipy(sp.eye(3, format="csr"), torch.float64, sym_from_triu=True)
    A = ell_from_scipy(sp.random(4, 3, density=0.5, random_state=0, format="csr"), torch.float64)
    s = Settings(linsys_solver="kkt_lu", dtype="float64", verbose=False)
    cfg = make_config(3, 4, s, torch.float64)
    with pytest.raises(ValueError, match="cg backend on ELL operands, not 'kkt_lu'"):
        program.solve_batch_program(cfg, 0, False, 0, P, torch.zeros(1, 3, dtype=torch.float64), A,
                                    -torch.ones(1, 4, dtype=torch.float64), torch.ones(1, 4, dtype=torch.float64),
                                    torch.ones(1, dtype=torch.float64), program.make_dyn(s, torch.float64))
    with pytest.raises(ValueError, match="cg"):
        program.SparseSolveProgram(program.sparse_operands(sp.eye(3), sp.eye(3)), 1, linsys_solver="dense_chol")
