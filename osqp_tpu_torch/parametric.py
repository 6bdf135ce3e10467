"""Batched parametric solving (counterpart of ``osqp_tpu/parametric.py``):
the reference's update/re-solve workflow at batch scale.

:class:`BatchedSolver` keeps B problems' scaled data, factorization, rho
state and iterates on one device, and exposes the reference's update
surface over whole batches, so that B independent controllers step in
lockstep:

    bs = BatchedSolver(P, q, A, l, u, ...)        # (B, ...) arrays
    res = bs.solve()                              # warm-started batch solve
    res = bs.resolve(l=l_new, u=u_new)            # update and re-solve

Update semantics mirror src/osqp.c:

* ``update_lin_cost``: rescale q only (osqp.c:765-795);
* ``update_bounds``: rescale l and u, reclassify rho, refactor the
  instances that changed constraint class (osqp.c:797-846,
  auxil.c:100-142);
* ``update_rho``: clamp, rebuild rho_vec, refactor (osqp.c:1281-1332);
* ``warm_start``: scale the iterates, z = A x (osqp.c:942-1007);
* ``update_P`` / ``update_A`` / ``update_P_A``: new batched values,
  rescaled from scratch and refactored, each instance keeping its rho
  (osqp.c:1012-1279).

:meth:`BatchedSolver.resolve` is the JAX package's fused
``_resolve_jit``: the update, the warm-started solve and the postprocess
in one call on device tensors.  Its only read of the device beyond the
segmented loop's own (``linalg.host_read``) is ``changed.any()`` after a
bounds update; where it is set, the refactored factor is merged per
instance through ``admm._select_factor``, integer leaves included (the
JAX package passes those through whole, which under ``kkt_lu`` pairs a
kept ``lu`` with a new ``perm``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import admm as admm_mod
from . import constants as con
from . import linalg
from . import linsys as linsys_registry
from .admm import rho_vec_from_type, update_rho_state
from .batch import BatchSolveResults, _postprocess, _prepare
from .linalg import mat_vec
from .linsys import block_tridiag
from .solver import Settings, make_config, reject_time_based_rho, resolve_device, torch_dtype, validate_settings
from .types import DynSettings, Iterates


class BatchedSolver:
    """B same-shape QPs resident on one device, with parametric updates.

    ``device``: where the state lives; default: P's device if P is a
    tensor, else the CUDA card (raises without one: pass
    ``device="cpu"`` for the CPU).  ``settings``: the reference's names
    (see :class:`~osqp_tpu_torch.solver.Settings`); ``dtype`` defaults to
    torch's default dtype.
    """

    def __init__(self, P, q, A, l, u, device=None, **settings):
        s = Settings(**settings)
        validate_settings(s)
        reject_time_based_rho(s)
        self.settings = s
        self._dtype = torch_dtype(s.dtype)
        if device is None:
            device = P.device if isinstance(P, torch.Tensor) else resolve_device(None)
        self.device = torch.device(device)
        q = self._tensor(q)
        if q.ndim != 2:
            raise ValueError("q must be (B, n)")
        A = self._tensor(A)
        self.B, self.n = q.shape
        self.m = A.shape[1]
        self._cfg = make_config(self.n, self.m, s, self._dtype)
        if s.linsys_solver == "block_tridiag":
            block_tridiag.validate_structure(P, A, s.block_size)
        self._dyn = DynSettings.make(
            self._dtype,
            sigma=s.sigma,
            alpha=s.alpha,
            eps_abs=s.eps_abs,
            eps_rel=s.eps_rel,
            eps_prim_inf=s.eps_prim_inf,
            eps_dual_inf=s.eps_dual_inf,
            adaptive_rho_tolerance=s.adaptive_rho_tolerance,
            delta=s.delta,
        )
        self._setup_data(P, q, A, l, u, rho=float(s.rho))
        self.iterates = self._cold()
        # Host reads of the device in the last resolve, and whether it
        # refactored.
        self.last_resolve = {"host_reads": 0, "refactored": False}

    # -- internals -----------------------------------------------------------
    def _tensor(self, v) -> torch.Tensor:
        v = v if isinstance(v, torch.Tensor) else np.asarray(v)
        return torch.as_tensor(v, dtype=self._dtype, device=self.device).contiguous()

    def _clamp(self, v) -> torch.Tensor:
        return torch.clamp(self._tensor(v), -con.OSQP_INFTY, con.OSQP_INFTY)

    def _cold(self) -> Iterates:
        return Iterates.cold(self.B, self.n, self.m, self._dtype, self.device)

    def _start(self) -> Iterates:
        return self.iterates if self.settings.warm_start else self._cold()

    def _setup_data(self, P, q, A, l, u, rho):
        """Scale, classify rho and factorize (osqp.c:192-215).  ``rho`` is
        a scalar (a fresh setup) or each instance's adapted value (B,),
        which matrix updates keep, as B independent Solvers would."""
        rho0 = torch.as_tensor(rho, dtype=self._dtype, device=self.device).broadcast_to((self.B,)).contiguous()
        self.data, self.scaling, self.rho_state, self.factor, _ = _prepare(
            self._cfg, int(self.settings.scaling), self._tensor(P), self._tensor(q), self._tensor(A),
            self._clamp(l), self._clamp(u), rho0, self._dyn, None, None,
        )

    def _refactor(self):
        return linsys_registry.init_factor(self._cfg, self.data.P, self.data.A, self._dyn.sigma,
                                           self.rho_state.rho_vec)

    def _finish(self, result) -> BatchSolveResults:
        """Keep the adapted rho, factor and iterates for the next solve;
        unscale and normalise the certificates."""
        self.rho_state, self.factor, self.iterates = result.rho_state, result.factor, result.iterates
        s = self.settings
        return _postprocess(self._cfg, bool(s.polish), int(s.polish_refine_iter), self.data, self.scaling,
                            self._dyn, result)

    # -- solve ---------------------------------------------------------------
    def solve(self) -> BatchSolveResults:
        """The batch solve (osqp.c:288-654), warm-started from the last
        iterates unless ``warm_start`` is off."""
        result = admm_mod.solve_core(self._cfg, self.data, self.scaling, self._dyn, self.rho_state, self.factor,
                                     self._start())
        return self._finish(result)

    def resolve(self, q=None, l=None, u=None) -> BatchSolveResults:
        """Update and warm-started re-solve in one call on device tensors
        (the JAX package's ``_resolve_jit``): q <- c D q; l and u clipped
        and rescaled by E, rho reclassified, a refactor where an instance
        changed class; the solve; the postprocess.  ``q``, ``l``, ``u``
        are new unscaled values, any may be omitted.  The same as
        ``update_lin_cost`` and ``update_bounds`` followed by ``solve()``,
        without the l <= u check and its host read."""
        reads0 = linalg.host_reads
        if q is not None:
            self.update_lin_cost(q)
        refactored = (l is not None or u is not None) and self._set_bounds(l, u)
        out = self.solve()
        self.last_resolve = {"host_reads": linalg.host_reads - reads0, "refactored": refactored}
        return out

    # -- parametric updates --------------------------------------------------
    def _set_bounds(self, l, u, check=False) -> bool:
        """Clip and rescale the new bounds (``l <= u`` checked where
        asked), reclassify rho, and refactor where an instance changed
        class, merged per instance through ``admm._select_factor``
        (osqp.c:797-846, auxil.c:100-142).  Returns whether a refactor
        ran."""
        ls = self.data.l if l is None else self._clamp(l) * self.scaling.E
        us = self.data.u if u is None else self._clamp(u) * self.scaling.E
        if check and linalg.host_read((ls > us).any()):
            raise con.OSQPError(con.ErrorCode.DATA_VALIDATION_ERROR,
                                "lower bound must be lower than or equal to upper bound")
        self.data = dataclasses.replace(self.data, l=ls, u=us)
        self.rho_state, changed = update_rho_state(self.data, self.rho_state)
        if not linalg.host_read(changed.any()):
            return False
        new = self._refactor()
        self.factor = {k: admm_mod._select_factor(changed, v, self.factor[k]) for k, v in new.items()}
        return True

    def update_lin_cost(self, q_new):
        """q_scaled = c D q_new (osqp.c:765-795)."""
        self.data = dataclasses.replace(self.data, q=self._tensor(q_new) * self.scaling.D * self.scaling.c[:, None])

    def update_bounds(self, l=None, u=None):
        """Rescale the bounds, raising where l > u; refactor the instances
        that changed class (osqp.c:797-846)."""
        self._set_bounds(l, u, check=True)

    def update_rho(self, rho_new: float):
        """osqp_update_rho (osqp.c:1281-1332), for every instance."""
        if rho_new <= 0:
            raise con.OSQPError(con.ErrorCode.SETTINGS_VALIDATION_ERROR, "rho must be positive")
        rho = float(np.clip(rho_new, con.RHO_MIN, con.RHO_MAX))
        rho_arr = torch.full((self.B,), rho, dtype=self._dtype, device=self.device)
        rv = rho_vec_from_type(self.rho_state.constr_type, rho_arr)
        self.rho_state = dataclasses.replace(self.rho_state, rho=rho_arr, rho_vec=rv, rho_inv_vec=1.0 / rv)
        self.factor = self._refactor()

    def update_P(self, P_new=None, A_new=None, l=None, u=None, q=None):
        """New batched P (and optionally A, q, l, u) values: the data not
        replaced is unscaled, the whole is prepared again with each
        instance's rho, the iterates kept (osqp.c:1012-1279)."""
        scl, data = self.scaling, self.data
        Dinv, Einv, cinv = scl.Dinv, scl.Einv, scl.cinv
        P_u = P_new if P_new is not None else cinv[:, None, None] * data.P * Dinv[:, :, None] * Dinv[:, None, :]
        A_u = A_new if A_new is not None else data.A * Einv[:, :, None] * Dinv[:, None, :]
        q_u = q if q is not None else cinv[:, None] * data.q * Dinv
        l_u = l if l is not None else data.l * Einv
        u_u = u if u is not None else data.u * Einv
        self._setup_data(P_u, q_u, A_u, l_u, u_u, rho=self.rho_state.rho)

    def update_A(self, A_new):
        self.update_P(A_new=A_new)

    def update_P_A(self, P_new, A_new):
        self.update_P(P_new=P_new, A_new=A_new)

    def warm_start(self, x=None, y=None):
        """Scale the iterates, z = A x (osqp.c:942-1007)."""
        it = self.iterates
        if x is not None:
            xs = self._tensor(x) * self.scaling.Dinv
            it = Iterates(x=xs, z=mat_vec(self.data.A, xs), y=it.y)
        if y is not None:
            ys = self._tensor(y) * self.scaling.Einv * self.scaling.c[:, None]
            it = Iterates(x=it.x, z=it.z, y=ys)
        self.iterates = it
