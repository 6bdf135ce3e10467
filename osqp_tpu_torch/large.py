"""Large sparse QPs, the n ~ 1e4..1e5 regime (counterpart of
``osqp_tpu/large.py``).

The dense layout of :mod:`osqp_tpu_torch.batch` needs O(n^2) memory per
instance; this path keeps the data sparse end to end: host CSR input
that is never densified, ELL operands on the device
(:mod:`osqp_tpu_torch.sparse_ops`), matrix-free Ruiz scaling and
termination products on K5, and the Jacobi-preconditioned CG backend
(K6) for the KKT solve.  The ADMM core, termination logic,
infeasibility certificates and polish are the dense path's code: the
operand type dispatches underneath (:func:`osqp_tpu_torch.linalg.mat_vec`;
polish solves its reduced KKT matrix-free on ELL operands,
:mod:`osqp_tpu_torch.polish`).  :class:`SparseSolver` is the stateful
``Solver`` over the same operands, kept on the device between solves.

Restrictions against the dense path:

* ``linsys_solver`` is always ``cg`` (matrix-free);
* a batch of instances shares one sparsity pattern and the values of P
  and A (scenario batches with per-instance q, l, u);
* there is no setup-time convexity check: non-convexity shows up as
  divergence (OSQP_NON_CVX), the reference's second detection path
  (auxil.c:699-706).

The JAX package's entry carries three workarounds for its TPU: at most
2000 iterations per device dispatch, a dispatch band in its segmented
driver, and polish on the host (``polish_host``) for B = 1.  Each exists
only because a long TPU dispatch killed the worker that served the chip.
A CUDA card has no such limit, so none of them is carried over: the
segments here are those of :func:`osqp_tpu_torch.solve_batch`, and every
B polishes on the device, as the JAX package's ``SparseSolver`` does.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import scipy.sparse as sp
import torch

from . import constants as con
from .admm import set_rho_state
from .batch import BatchSolveResults, _solve_segmented
from .linsys import init_factor
from .scaling import scale_data
from .solver import (
    Settings,
    Solver,
    make_config,
    reject_time_based_rho,
    resolve_device,
    torch_dtype,
    validate_settings,
)
from .sparse_ops import ell_from_scipy, ell_pattern_from_scipy, ell_value_maps, ell_with_values
from .types import DynSettings, QPData, ScalingData


def prepare_sparse(P, q, A, l, u, settings: dict, device="cpu"):
    """Settings validation (cg only), dtype, the ELL operands on
    ``device`` and the static and dynamic configs.  Returns
    ``(s, dtype, cfg, dyn, P_ell, A_ell, q, l, u)`` with q, l, u as
    (B, ·) float64 numpy, the bounds clamped."""
    settings.setdefault("linsys_solver", "cg")
    s = Settings(**settings)
    validate_settings(s)
    reject_time_based_rho(s)
    if s.linsys_solver != "cg":
        raise con.OSQPError(
            con.ErrorCode.SETTINGS_VALIDATION_ERROR,
            "the sparse path supports only the matrix-free 'cg' backend",
        )

    q = np.atleast_2d(np.asarray(q, np.float64))
    B, n = q.shape
    l = np.atleast_2d(np.asarray(l, np.float64))
    u = np.atleast_2d(np.asarray(u, np.float64))
    # the reference's finite infinity (constants.h:98-100)
    l = np.clip(np.broadcast_to(l, (B, l.shape[-1])), -con.OSQP_INFTY, con.OSQP_INFTY)
    u = np.clip(np.broadcast_to(u, (B, u.shape[-1])), -con.OSQP_INFTY, con.OSQP_INFTY)
    m = l.shape[-1]

    dtype = torch_dtype(s.dtype)
    # Contiguous values: the scenario batch's B copies, which K5 reads.
    P_ell = ell_from_scipy(sp.csr_matrix(P), dtype, batch=B, sym_from_triu=True, device=device).contiguous()
    A_ell = ell_from_scipy(sp.csr_matrix(A), dtype, batch=B, device=device).contiguous()
    if A_ell.shape != (m, n):
        raise con.OSQPError(
            con.ErrorCode.DATA_VALIDATION_ERROR,
            f"A shape {A_ell.shape} inconsistent with q/l/u ({m}, {n})",
        )

    cfg = make_config(n, m, s, dtype)
    dyn = DynSettings.make(
        dtype,
        sigma=s.sigma,
        alpha=s.alpha,
        eps_abs=s.eps_abs,
        eps_rel=s.eps_rel,
        eps_prim_inf=s.eps_prim_inf,
        eps_dual_inf=s.eps_dual_inf,
        adaptive_rho_tolerance=s.adaptive_rho_tolerance,
        delta=s.delta,
    )
    return s, dtype, cfg, dyn, P_ell, A_ell, q, l, u


def solve_sparse(P, q, A, l, u, x0=None, y0=None, device=None, **settings) -> BatchSolveResults:
    """Solve one sparse QP, or B that share its sparsity pattern and the
    values of P and A with per-instance q, l, u, without densifying P or A.

    Args:
      P: scipy sparse (n, n), upper triangular or full symmetric.
      q: (n,) or (B, n).
      A: scipy sparse (m, n).
      l, u: (m,) or (B, m).
      x0, y0: optional warm starts (unscaled); either alone is allowed.
      device: where to solve: the CUDA card by default (raises without
        one: pass ``device="cpu"`` for the CPU).
      settings: reference setting names; ``linsys_solver`` must be
        ``"cg"`` (the default here).  ``polish=True`` polishes every
        instance on the device through the matrix-free reduced-KKT CG
        (polish.c:212-350 semantics).

    Returns :class:`BatchSolveResults` of tensors on ``device`` (B = 1
    for 1-D inputs).
    """
    device = resolve_device(device)
    s, dtype, cfg, dyn, P_ell, A_ell, q, l, u = prepare_sparse(P, q, A, l, u, settings, device)
    B, n = q.shape
    m = l.shape[-1]
    as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)
    rho0 = torch.full((B,), s.rho, dtype=dtype, device=device)
    if x0 is not None or y0 is not None:
        # reference osqp_warm_start: either side alone is allowed, the
        # other defaults to zero (osqp.c:967-1010)
        x0 = as_t(np.reshape(x0, (B, n)) if x0 is not None else np.zeros((B, n)))
        y0 = as_t(np.reshape(y0, (B, m)) if y0 is not None else np.zeros((B, m)))

    verbose = bool(s.verbose)
    if verbose:
        from .utils.printing import print_setup_header_vals, sparse_nnz

        print_setup_header_vals(s, n, m, sparse_nnz(P, A), B=B)
    t0 = time.perf_counter()
    res = _solve_segmented(
        cfg, int(s.scaling), bool(s.polish), int(s.polish_refine_iter),
        P_ell, as_t(q), A_ell, as_t(l), as_t(u), rho0, dyn, x0, y0,
        time_limit=float(s.time_limit), verbose=verbose,
    )
    if verbose:
        from .utils.printing import print_batch_footer

        print_batch_footer(res, s, time.perf_counter() - t0)
    return res


# ---------------------------------------------------------------------------
# The stateful Solver over the sparse path
# ---------------------------------------------------------------------------
def _device_setup_sparse(cfg, scaling_iters: int, P, q, A, l, u, rho, dyn):
    """Scale, classify rho and initialize the cg backend on ELL operands
    (osqp.c:192-215).  No factor-time convexity check: cg factors
    nothing, and non-convexity surfaces as divergence (auxil.c:699-706)."""
    data = QPData(P=P, q=q, A=A, l=l, u=u)
    B, n = q.shape
    if scaling_iters > 0:
        scaled, scl = scale_data(data, scaling_iters)
    else:
        scaled, scl = data, ScalingData.identity(B, n, cfg.m, q.dtype, q.device)
    rho_state = set_rho_state(scaled, rho)
    factor = init_factor(cfg, scaled.P, scaled.A, dyn.sigma, rho_state.rho_vec)
    return scaled, scl, rho_state, factor


class SparseSolver(Solver):
    """The stateful :class:`~osqp_tpu_torch.Solver` (setup, solve,
    update_*, warm_start, the settings setters; osqp.c:76-283,
    765-1617) over ELL operands that stay on the device between solves:

    * the ELL pattern and the CSC-nnz to ELL-slot value maps are built
      once, at setup, and uploaded once (the analogue of the reference's
      PtoKKT/AtoKKT maps, kkt.c:184-212);
    * ``update_P`` / ``update_A`` edit the host CSC values (indexed
      semantics, osqp.c:1031-1062), upload those values alone, and
      assemble the device operands by gathering them through the maps;
    * rescaling and the cg re-init run on the device (the tail of
      osqp_update_P, osqp.c:1066-1075);
    * iterates stay on the device between solves (warm starting), and
      polish, matrix-free, writes back into them.

    ``linsys_solver`` must be ``"cg"``.  ``export`` writes the
    pattern-baked artifact of :func:`osqp_tpu_torch.export.export_sparse_solver`.
    """

    def setup(self, P=None, q=None, A=None, l=None, u=None, device=None, **settings):
        settings.setdefault("linsys_solver", "cg")
        if settings["linsys_solver"] != "cg":
            raise con.OSQPError(
                con.ErrorCode.SETTINGS_VALIDATION_ERROR,
                "SparseSolver supports only the matrix-free 'cg' backend",
            )
        self._patterns = None  # built in _push_data_and_factor
        return super().setup(P=P, q=q, A=A, l=l, u=u, device=device, **settings)

    def _push_data_and_factor(self, rho: float):
        """Upload the values alone through the slot maps, then rescale and
        re-init on the device (osqp.c:1048-1075); the pattern work runs
        once, at setup."""
        if self._patterns is None:
            on = lambda a: torch.as_tensor(a, device=self.device)
            P_idx, P_tidx, P_shape = ell_pattern_from_scipy(self._Pu, sym_from_triu=True)
            A_idx, A_tidx, A_shape = ell_pattern_from_scipy(self._Ac)
            P_src, P_tsrc = ell_value_maps(self._Pu, sym_from_triu=True)
            A_src, A_tsrc = ell_value_maps(self._Ac)
            self._patterns = (
                (on(P_idx), on(P_tidx), P_shape, on(P_src), on(P_tsrc)),
                (on(A_idx), on(A_tidx), A_shape, on(A_src), on(A_tsrc)),
            )
        P_pat, A_pat = self._patterns
        dt, dev = self._dtype, self.device
        P_ell = ell_with_values(*P_pat, self._Pu.data, dt, device=dev)
        A_ell = ell_with_values(*A_pat, self._Ac.data, dt, device=dev)
        rho_arr = torch.full((1,), rho, dtype=dt, device=dev)
        self.data, self.scaling, self.rho_state, self.factor = _device_setup_sparse(
            self._cfg, int(self.settings.scaling), P_ell, self._tensor(self._q), A_ell,
            self._tensor(self._l), self._tensor(self._u), rho_arr, self._dyn,
        )

    def export(self, path=None, B: int = 1) -> bytes:
        """Serialize this problem's pattern and settings: the artifact's
        callable takes only value vectors (P_val, q, A_val, l, u) in this
        solver's CSC order, the parametric EMBEDDED workflow at sparse
        scale (osqp.c:1031-1062 value semantics), on this solver's device
        type.  Load with :func:`osqp_tpu_torch.export.load_sparse_solver`;
        optionally written to ``path``."""
        from .export import export_sparse_solver

        self._require_setup()
        blob = export_sparse_solver(
            self._Pu, self._Ac, B=B, dtype=self._dtype, platforms=[self.device.type],
            **{f.name: getattr(self.settings, f.name) for f in dataclasses.fields(Settings)
               if f.name not in ("dtype", "verbose", "time_limit")},
            verbose=False,
        )
        if path is not None:
            with open(path, "wb") as f:
                f.write(blob)
        return blob
