"""One QP with its constraint rows spread over devices (counterpart of
``osqp_tpu/parallel/intra.py``), one process a device.

When one QP is too large for one card, the matrix-free ``cg`` backend
splits A's m rows over the ranks of a mesh: each rank puts only its block
of rows on its device (:class:`~osqp_tpu_torch.parallel.rows.RowSharded`),
and the products carry the collectives:

    A x             the block's rows, then an all-gather of the m-vector
    A'(rho v)       the block's partial products and one all-reduce (dense);
                    the replicated transpose, no collective (ELL)
    Ruiz            the maxima of the block merged over the ranks a sweep

Every m-vector (z, y, l, u, rho, the residuals) stays whole on every rank,
so termination, rho adaptation, the certificates and finalize run
unchanged and every rank takes the same decisions; the JAX package
shards y too.

**The stop is agreed.**  Every rank runs the same segments (``max(4
check, 100)`` iterations each) and, from the second segment's end on,
takes part in one all-reduce (MAX) of two flags at each end: rank 0's
clock decision (``time_limit`` reached since the solve began; the other
ranks send 0, so their clocks decide nothing) and whether any rank has
received SIGINT.  So every rank stops after the same segment, with
``OSQP_TIME_LIMIT_REACHED`` or ``OSQP_SIGINT``, and finalizes from the
same state.  While an entry runs in the main thread, its SIGINT handler
only records the signal (the previous handler comes back on the way
out): Ctrl-C stops the solve at the next segment end, not at once, and a
signal after the last segment end lets the solve finish.  The JAX
package, one controller, stops at once, where its host catches the
``KeyboardInterrupt``.

Polish runs on the shards: A is never gathered (``polish.polish``).  A
dense A takes the Schur branch, whose (MA)'(MA) is summed over the
blocks by one all-reduce and whose n x n S is inverted by K2 on every
rank; an ELL A runs the Schur PCG over the row-sharded operators, on the
card by K6's step kernels.  As in the JAX package, whose ``cg`` backend
routes polish to the same branches.

Every rank calls an entry with the same arguments; the results are the
same on every rank, bit for bit.
"""

from __future__ import annotations

import contextlib
import signal
import threading
import time

import numpy as np
import scipy.sparse as sp
import torch

from .. import constants as con
from ..batch import BatchSolveResults, _solve_segmented
from ..large import prepare_sparse
from ..linalg import host_array
from ..solver import Settings, make_config, reject_time_based_rho, torch_dtype, validate_settings
from ..sparse_ops import ELLMatrix
from ..types import DynSettings
from .mesh import make_mesh, mesh_group
from .rows import RowSharded, all_reduce_max


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _padded(l, u, m: int, W: int):
    """l and u with the loose rows that pad m to a multiple of W."""
    pad = (-m) % W
    if pad:
        l = np.concatenate([l, np.full(pad, -con.OSQP_INFTY)])
        u = np.concatenate([u, np.full(pad, con.OSQP_INFTY)])
    return l, u, pad


def _strip(res: BatchSolveResults, m: int, pad: int) -> BatchSolveResults:
    if pad:
        res = res._replace(y=res.y[:, :m], prim_inf_cert=res.prim_inf_cert[:, :m])
    return res


def solve_single_sharded(P, q, A, l, u, mesh=None, axis_name: str = "batch", device=None, **settings
                         ) -> BatchSolveResults:
    """Solve one QP with A's rows spread over the mesh's ranks.

    P: (n, n) dense symmetric (every rank holds it); q: (n,); A: (m, n)
    dense; l, u: (m,); arrays or tensors.  ``linsys_solver`` must be
    ``"cg"`` (the default here).  The rows are padded with loose all-zero
    constraints (l = -inf, u = +inf) to a multiple of the mesh's size,
    which changes no iterate; rank r puts rows r R to (r + 1) R of the
    padded A on its device.  ``time_limit`` and Ctrl-C stop every rank
    at the same segment end (the module's docstring); ``polish=True``
    polishes by the Schur complement on the shards.  Returns a
    batch-of-1 :class:`BatchSolveResults`, the padding stripped from y
    and ``prim_inf_cert``."""
    settings.setdefault("linsys_solver", "cg")
    if settings["linsys_solver"] != "cg":
        raise con.OSQPError(con.ErrorCode.SETTINGS_VALIDATION_ERROR,
                            "intra-problem sharding requires the cg backend")
    s = Settings(**settings)
    validate_settings(s)
    reject_time_based_rho(s)
    mesh = mesh if mesh is not None else make_mesh(axis_name=axis_name, device=device)
    group, W, rank, dev = mesh_group(mesh, axis_name, device)

    P, q, A = _host(P), _host(q).ravel(), _host(A)
    m, n = A.shape
    l, u, pad = _padded(_host(l).astype(np.float64).ravel(), _host(u).astype(np.float64).ravel(), m, W)
    R = (m + pad) // W
    r0 = rank * R
    block = A[r0:min(r0 + R, m)]
    if block.shape[0] < R:
        block = np.concatenate([block, np.zeros((R - block.shape[0], n), A.dtype)])

    dtype = torch_dtype(s.dtype)
    as_t = lambda v: torch.as_tensor(v, dtype=dtype, device=dev).contiguous()
    bound = lambda v: torch.clamp(as_t(v[None]), -con.OSQP_INFTY, con.OSQP_INFTY)
    A_s = RowSharded(as_t(block[None]), m + pad, r0, group, pad)
    res = _solve(s, dtype, dev, n, m + pad, as_t(P[None]), as_t(q[None]), A_s, bound(l), bound(u), group, rank)
    return _strip(res, m, pad)


def solve_single_sharded_sparse(P, q, A, l, u, mesh=None, axis_name: str = "batch", device=None, **settings
                                ) -> BatchSolveResults:
    """One large sparse QP with A's rows spread over the mesh's ranks: the
    ELL path of :func:`osqp_tpu_torch.solve_sparse` on the row-sharded
    operand.  P and A are scipy sparse, q (n,), l and u (m,).  The rows
    are padded as in :func:`solve_single_sharded`; the ELL operands come
    from :func:`osqp_tpu_torch.large.prepare_sparse`, and each rank puts
    P, its block of A's rows and A's whole transpose on its device.
    ``time_limit`` and Ctrl-C as in :func:`solve_single_sharded`;
    ``polish=True`` runs the Schur PCG on the sharded rows.  Returns a
    batch-of-1 :class:`BatchSolveResults`."""
    l = _host(l).astype(np.float64).ravel()
    u = _host(u).astype(np.float64).ravel()
    A = sp.csr_matrix(A)
    m = A.shape[0]
    mesh = mesh if mesh is not None else make_mesh(axis_name=axis_name, device=device)
    group, W, rank, dev = mesh_group(mesh, axis_name, device)
    l, u, pad = _padded(l, u, m, W)
    if pad:
        A = sp.vstack([A, sp.csr_matrix((pad, A.shape[1]))], format="csr")

    s, dtype, cfg, dyn, P_ell, A_ell, q2, l2, u2 = prepare_sparse(P, q, A, l, u, settings)
    R = (m + pad) // W
    r0 = rank * R
    on = lambda t: t.to(dev).contiguous()
    A_s = RowSharded.from_ell(on(A_ell.val[:, r0:r0 + R]), on(A_ell.idx[r0:r0 + R]), on(A_ell.t_val),
                              on(A_ell.t_idx), m + pad, r0, group, pad)
    as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)
    P_dev = ELLMatrix(val=on(P_ell.val), idx=on(P_ell.idx), t_val=on(P_ell.t_val), t_idx=on(P_ell.t_idx),
                            shape=P_ell.shape)
    res = _solve(s, dtype, dev, cfg.n, cfg.m, P_dev, as_t(q2), A_s, as_t(l2), as_t(u2), group, rank, cfg=cfg,
                 dyn=dyn)
    return _strip(res, m, pad)


class _AgreedStop:
    """The stop hook of :func:`osqp_tpu_torch.batch._solve_segmented` that
    every rank of ``group`` polls at the same segment ends: one all-reduce
    (MAX) of (rank 0's clock decision, SIGINT seen here), read on the host.
    ``interrupted`` is set by the entries' SIGINT handler."""

    def __init__(self, group, rank: int, dev, time_limit: float):
        self.group, self.dev = group, dev
        self.clock = rank == 0 and time_limit > 0
        self.time_limit = float(time_limit)
        self.t0 = time.perf_counter()
        self.interrupted = False

    def __call__(self):
        late = self.clock and time.perf_counter() - self.t0 >= self.time_limit
        flags = torch.tensor([int(late), int(self.interrupted)], dtype=torch.int32, device=self.dev)
        late, interrupted = host_array(all_reduce_max(flags, self.group)).tolist()
        if interrupted:
            return con.OSQP_SIGINT
        if late:
            return con.OSQP_TIME_LIMIT_REACHED
        return None


@contextlib.contextmanager
def _deferred_sigint(stop: _AgreedStop):
    """SIGINT recorded in ``stop`` instead of raised, in the main thread
    (where Python runs signal handlers); the previous handler restored on
    the way out.  Elsewhere nothing changes."""
    if threading.current_thread() is not threading.main_thread():
        yield
        return

    def record(signum, frame):
        stop.interrupted = True

    previous = signal.signal(signal.SIGINT, record)
    try:
        yield
    finally:
        signal.signal(signal.SIGINT, signal.SIG_DFL if previous is None else previous)


def _solve(s: Settings, dtype, dev, n: int, m: int, P, q, A, l, u, group, rank: int, cfg=None, dyn=None
           ) -> BatchSolveResults:
    """The segmented driver of :func:`osqp_tpu_torch.solve_batch` on one
    instance, from its settings, stopped where the ranks agree."""
    if cfg is None:
        cfg = make_config(n, m, s, dtype)
        dyn = DynSettings.make(
            dtype, sigma=s.sigma, alpha=s.alpha, eps_abs=s.eps_abs, eps_rel=s.eps_rel,
            eps_prim_inf=s.eps_prim_inf, eps_dual_inf=s.eps_dual_inf,
            adaptive_rho_tolerance=s.adaptive_rho_tolerance, delta=s.delta,
        )
    rho0 = torch.full((1,), s.rho, dtype=dtype, device=dev)
    stop = _AgreedStop(group, rank, dev, s.time_limit)
    with _deferred_sigint(stop):
        return _solve_segmented(cfg, int(s.scaling), bool(s.polish), int(s.polish_refine_iter), P, q, A, l, u, rho0,
                                dyn, None, None, verbose=bool(s.verbose), stop=stop)
