"""Console reporting with the reference's columns (counterpart of
``osqp_tpu/utils/printing.py``; reference src/util.c:42-236)."""

from __future__ import annotations

import time

from .. import constants as con


def print_setup_header(solver) -> None:
    """print_setup_header (util.c:58-150) of the stateful Solver."""
    print_setup_header_vals(solver.settings, solver.n, solver.m, solver._Pu.nnz + solver._Ac.nnz)


def print_setup_header_vals(s, n, m, nnz, B: int = 1) -> None:
    """Setup header (util.c:58-150), shared by the stateful Solver and the
    functional solve_batch entry, which has no solver object."""
    from .. import __version__

    print("-" * 59)
    print(
        f"        OSQP-TPU-TORCH v{__version__}  -  Operator Splitting QP Solver\n"
        "              (PyTorch/CUDA port of osqp_tpu)"
    )
    print("-" * 59)
    batch = f" (x {B} instances)" if B > 1 else ""
    print("problem:  variables n = %d, constraints m = %d%s" % (n, m, batch))
    print("          nnz(P) + nnz(A) = %d" % nnz)
    print("settings: linear system solver = %s (backend)" % s.linsys_solver)
    print(
        f"          eps_abs = {s.eps_abs:.1e}, eps_rel = {s.eps_rel:.1e},\n"
        f"          eps_prim_inf = {s.eps_prim_inf:.1e}, "
        f"eps_dual_inf = {s.eps_dual_inf:.1e},\n"
        f"          rho = {s.rho:.2e} "
        + ("(adaptive)" if s.adaptive_rho else "")
        + f",\n          sigma = {s.sigma:.2e}, alpha = {s.alpha:.2f}, "
        f"max_iter = {s.max_iter}"
    )
    if s.check_termination:
        print(f"          check_termination: on (interval {s.check_termination})")
    else:
        print("          check_termination: off")
    print(
        f"          scaling: {'on' if s.scaling else 'off'}, "
        f"scaled_termination: {'on' if s.scaled_termination else 'off'}"
    )
    print(
        f"          warm start: {'on' if s.warm_start else 'off'}, "
        f"polish: {'on' if s.polish else 'off'}, "
        f"time_limit: {s.time_limit if s.time_limit else 'off'}"
    )
    print()


def print_iter_row(k, obj, pri, dua, rho, t) -> None:
    """print_summary (util.c:152-175)."""
    print(f"{k:4d}  {obj: .4e}  {pri:.2e}  {dua:.2e}  {rho:.2e}  {t:.2e}s")


def print_iter_header() -> None:
    """print_header (util.c:42-56)."""
    print("iter   objective    pri res    dua res    rho        time")


def print_summary_footer(solver) -> None:
    """print_footer (util.c:177-236) of the stateful Solver; its
    per-iteration rows are printed live by the segmented solve loop.
    Polish is not ported, so there is no polish line."""
    info = solver.info
    print()
    print(f"status:               {info.status}")
    print(f"number of iterations: {info.iter}")
    if info.status_val in (con.OSQP_SOLVED, con.OSQP_SOLVED_INACCURATE):
        print(f"optimal objective:    {info.obj_val:.4f}")
    print(f"run time:             {info.run_time:.2e}s")
    print(f"optimal rho estimate: {info.rho_estimate:.2e}")
    print()


def print_batch_footer(res, settings, run_time: float) -> None:
    """Footer of a batched solve (util.c:177-236).  The per-solution lines
    report instance 0, and a status histogram covers the whole batch."""
    status = res.status_val.cpu().tolist()
    s0 = status[0]
    print()
    print(f"status:               {con.STATUS_MESSAGE.get(s0, str(s0))}")
    if len(status) > 1:
        hist = ", ".join(
            f"{con.STATUS_MESSAGE.get(v, str(v))}: {status.count(v)}" for v in sorted(set(status))
        )
        print(f"batch status:         {hist}")
    print(f"number of iterations: {int(res.iter[0])}")
    if s0 in (con.OSQP_SOLVED, con.OSQP_SOLVED_INACCURATE):
        print(f"optimal objective:    {float(res.obj_val[0]):.4f}")
    print(f"run time:             {run_time:.2e}s")
    print(f"optimal rho estimate: {float(res.rho_estimate[0]):.2e}")
    print()


class IterRowPrinter:
    """The reference's live-row cadence: a row at iteration 1, then every
    PRINT_INTERVAL (util.c:152-175)."""

    def __init__(self, t0: float):
        self.t0 = t0
        self.next_print = 1
        print_iter_header()

    def maybe(self, end: int, fetch) -> None:
        """Print a row for iteration ``end`` if the cadence calls for one;
        ``fetch()`` returns (obj, pri, dua, rho) tensors and runs only
        when a row is printed."""
        if end >= self.next_print:
            obj, pri, dua, rho = fetch()
            print_iter_row(
                end, float(obj[0]), float(pri[0]), float(dua[0]), float(rho[0]),
                time.perf_counter() - self.t0,
            )
            self.next_print = (end // con.PRINT_INTERVAL + 1) * con.PRINT_INTERVAL
