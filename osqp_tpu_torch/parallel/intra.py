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
shards y too.  A time limit is refused: each rank's clock could stop it
at another iteration.

Polish runs on both paths, unsharded: A is gathered whole on every rank
once, at the start of polish, which costs a rank m n values of a dense A
and the rows' nnz slots of an ELL one on top of its block.  The dense
path factors the polish KKT with K8's LU, as the port's ``cg`` polish
does everywhere; the ELL path runs K6's device loop over the whole rows.
The JAX package partitions a Schur-complement polish over the row shards
instead (its batched LU cannot be partitioned).

Every rank calls an entry with the same arguments; the results are the
same on every rank, bit for bit.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from .. import constants as con
from ..batch import BatchSolveResults, _solve_segmented
from ..large import prepare_sparse
from ..solver import Settings, make_config, reject_time_based_rho, torch_dtype, validate_settings
from ..sparse_ops import ELLMatrix
from ..types import DynSettings
from .mesh import make_mesh, mesh_group
from .rows import RowSharded


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _refuse_time_limit(s: Settings) -> None:
    if s.time_limit and s.time_limit > 0:
        raise con.OSQPError(
            con.ErrorCode.SETTINGS_VALIDATION_ERROR,
            "intra-problem sharding takes no time limit: the ranks' clocks could stop them at different iterations",
        )


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
    padded A on its device.  Returns a batch-of-1
    :class:`BatchSolveResults`, the padding stripped from y and
    ``prim_inf_cert``."""
    settings.setdefault("linsys_solver", "cg")
    if settings["linsys_solver"] != "cg":
        raise con.OSQPError(con.ErrorCode.SETTINGS_VALIDATION_ERROR,
                            "intra-problem sharding requires the cg backend")
    s = Settings(**settings)
    validate_settings(s)
    reject_time_based_rho(s)
    _refuse_time_limit(s)
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
    res = _solve(s, dtype, dev, n, m + pad, as_t(P[None]), as_t(q[None]), A_s, bound(l), bound(u))
    return _strip(res, m, pad)


def solve_single_sharded_sparse(P, q, A, l, u, mesh=None, axis_name: str = "batch", device=None, **settings
                                ) -> BatchSolveResults:
    """One large sparse QP with A's rows spread over the mesh's ranks: the
    ELL path of :func:`osqp_tpu_torch.solve_sparse` on the row-sharded
    operand.  P and A are scipy sparse, q (n,), l and u (m,).  The rows
    are padded as in :func:`solve_single_sharded`; the ELL operands come
    from :func:`osqp_tpu_torch.large.prepare_sparse`, and each rank puts
    P, its block of A's rows and A's whole transpose on its device.
    ``polish=True`` polishes on the gathered rows.  Returns a batch-of-1
    :class:`BatchSolveResults`."""
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
    _refuse_time_limit(s)
    R = (m + pad) // W
    r0 = rank * R
    on = lambda t: t.to(dev).contiguous()
    A_s = RowSharded.from_ell(on(A_ell.val[:, r0:r0 + R]), on(A_ell.idx[r0:r0 + R]), on(A_ell.t_val),
                              on(A_ell.t_idx), m + pad, r0, group, pad)
    as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)
    P_dev = ELLMatrix(val=on(P_ell.val), idx=on(P_ell.idx), t_val=on(P_ell.t_val), t_idx=on(P_ell.t_idx),
                            shape=P_ell.shape)
    res = _solve(s, dtype, dev, cfg.n, cfg.m, P_dev, as_t(q2), A_s, as_t(l2), as_t(u2), cfg=cfg, dyn=dyn)
    return _strip(res, m, pad)


def _solve(s: Settings, dtype, dev, n: int, m: int, P, q, A, l, u, cfg=None, dyn=None) -> BatchSolveResults:
    """The segmented driver of :func:`osqp_tpu_torch.solve_batch` on one
    instance, from its settings."""
    if cfg is None:
        cfg = make_config(n, m, s, dtype)
        dyn = DynSettings.make(
            dtype, sigma=s.sigma, alpha=s.alpha, eps_abs=s.eps_abs, eps_rel=s.eps_rel,
            eps_prim_inf=s.eps_prim_inf, eps_dual_inf=s.eps_dual_inf,
            adaptive_rho_tolerance=s.adaptive_rho_tolerance, delta=s.delta,
        )
    rho0 = torch.full((1,), s.rho, dtype=dtype, device=dev)
    return _solve_segmented(cfg, int(s.scaling), bool(s.polish), int(s.polish_refine_iter), P, q, A, l, u, rho0, dyn,
                            None, None, verbose=bool(s.verbose))
