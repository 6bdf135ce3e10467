"""The stateful Solver with the reference OSQP lifecycle and API surface
(counterpart of ``osqp_tpu/solver.py``; include/osqp.h:32-421,
src/osqp.c), and the settings, their validation and the static
configuration that it shares with :func:`osqp_tpu_torch.solve_batch`.

* ``setup`` (osqp.c:76-283): validate, scale (K4), classify rho,
  factorize (K2 or torch's Cholesky by n), convexity check
* ``solve`` (osqp.c:288-654): the segmented ADMM loop (K1 or K1r per
  segment, K3 at every check) and the solution
* ``update_lin_cost`` (765), ``update_bounds`` (797),
  ``update_lower_bound`` (848), ``update_upper_bound`` (895),
  ``warm_start`` (942-1007), ``update_P`` (1012), ``update_A`` (1092),
  ``update_P_A`` (1171), ``update_rho`` (1281) and the settings setters
  (1339-1617)

State lives on one device, explicit at setup (``device=``, default the
CPU), as batch-of-1 tensors in the solve dtype; a CUDA device runs the
hand-written kernels.  Polish (ROADMAP queue 1, item 10) and ``export``
(item 14) are not ported yet and raise.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import replace as _rp
from typing import Any

import numpy as np
import torch

from . import admm as admm_mod
from . import constants as con
from . import linsys as linsys_registry
from .admm import rho_vec_from_type, set_rho_state, update_rho_state
from .constants import ErrorCode, NonConvexError, OSQPError
from .linalg import mat_vec
from .scaling import scale_data, unscale_solution
from .sparse import clamp_bounds, triu_to_full, validate_problem
from .types import DynSettings, Iterates, QPData, ScalingData, StaticConfig


@dataclasses.dataclass
class Settings:
    """Reference setting names and defaults (types.h:139-176,
    constants.h:58-121), as the JAX package's ``Settings``."""

    rho: float = con.RHO
    sigma: float = con.SIGMA
    scaling: int = con.SCALING
    adaptive_rho: bool = bool(con.ADAPTIVE_RHO)
    adaptive_rho_interval: int = con.ADAPTIVE_RHO_INTERVAL
    adaptive_rho_tolerance: float = con.ADAPTIVE_RHO_TOLERANCE
    adaptive_rho_fraction: float = con.ADAPTIVE_RHO_FRACTION
    # The reference's wall-clock interval rule (osqp.c:456-485); only the
    # stateful Solver can honor it, and the batched entry rejects it.
    adaptive_rho_time: bool = False
    max_iter: int = con.MAX_ITER
    eps_abs: float = con.EPS_ABS
    eps_rel: float = con.EPS_REL
    eps_prim_inf: float = con.EPS_PRIM_INF
    eps_dual_inf: float = con.EPS_DUAL_INF
    alpha: float = con.ALPHA
    linsys_solver: str = "dense_inv"
    delta: float = con.DELTA
    polish: bool = bool(con.POLISH)
    polish_refine_iter: int = con.POLISH_REFINE_ITER
    polish_passes: int = con.POLISH_PASSES
    polish_dtype: Any = None
    verbose: bool = bool(con.VERBOSE)
    scaled_termination: bool = bool(con.SCALED_TERMINATION)
    check_termination: int = con.CHECK_TERMINATION
    warm_start: bool = bool(con.WARM_START)
    time_limit: float = con.TIME_LIMIT
    dtype: Any = None  # None -> torch.get_default_dtype()
    # Knobs of the cg and block_tridiag backends, not ported yet
    # (ROADMAP queue 1, items 11-12); accepted so that the reference's
    # setting names all pass through.
    cg_max_iter: int = 0
    cg_tol_fraction: float = 1e-7
    block_size: int = 0


def torch_dtype(d) -> torch.dtype:
    """float32 or float64 from a torch dtype, a numpy dtype or a name;
    ``None`` gives torch's default dtype."""
    if d is None:
        d = torch.get_default_dtype()
    if not isinstance(d, torch.dtype):
        d = getattr(torch, np.dtype(d).name)
    if d not in (torch.float32, torch.float64):
        raise OSQPError(ErrorCode.SETTINGS_VALIDATION_ERROR, f"dtype must be float32 or float64, not {d}")
    return d


def validate_settings(s: Settings) -> None:
    """validate_settings (auxil.c:893-1065), identical rules."""
    err = lambda msg: OSQPError(ErrorCode.SETTINGS_VALIDATION_ERROR, msg)
    if s.scaling < 0:
        raise err("scaling must be nonnegative")
    if s.adaptive_rho not in (0, 1, True, False):
        raise err("adaptive_rho must be either 0 or 1")
    if s.adaptive_rho_interval < 0:
        raise err("adaptive_rho_interval must be nonnegative")
    if s.adaptive_rho_fraction <= 0:
        raise err("adaptive_rho_fraction must be positive")
    if s.adaptive_rho_time and not s.adaptive_rho:
        raise err("adaptive_rho_time requires adaptive_rho")
    if s.adaptive_rho_tolerance < 1.0:
        raise err("adaptive_rho_tolerance must be >= 1")
    if s.polish_refine_iter < 0:
        raise err("polish_refine_iter must be nonnegative")
    if s.polish_passes < 1:
        raise err("polish_passes must be positive")
    if s.polish_dtype is not None:
        try:
            torch_dtype(s.polish_dtype)
        except (OSQPError, TypeError, AttributeError):
            raise err("polish_dtype must be float32, float64 or None") from None
    if s.rho <= 0.0:
        raise err("rho must be positive")
    if s.sigma <= 0.0:
        raise err("sigma must be positive")
    if s.delta <= 0.0:
        raise err("delta must be positive")
    if s.max_iter <= 0:
        raise err("max_iter must be positive")
    if s.eps_abs < 0.0:
        raise err("eps_abs must be nonnegative")
    if s.eps_rel < 0.0:
        raise err("eps_rel must be nonnegative")
    if s.eps_rel == 0.0 and s.eps_abs == 0.0:
        raise err("at least one of eps_abs and eps_rel must be positive")
    if s.eps_prim_inf <= 0.0:
        raise err("eps_prim_inf must be positive")
    if s.eps_dual_inf <= 0.0:
        raise err("eps_dual_inf must be positive")
    if not (0.0 < s.alpha < 2.0):
        raise err("alpha must be strictly between 0 and 2")
    try:
        linsys_registry.get(s.linsys_solver)
    except KeyError:
        raise err("linsys_solver not recognized") from None
    if s.verbose not in (0, 1, True, False):
        raise err("verbose must be either 0 or 1")
    if s.scaled_termination not in (0, 1, True, False):
        raise err("scaled_termination must be either 0 or 1")
    if s.check_termination < 0:
        raise err("check_termination must be nonnegative")
    if s.warm_start not in (0, 1, True, False):
        raise err("warm_start must be either 0 or 1")
    if s.time_limit < 0:
        raise err("time_limit must be nonnegative")


def reject_time_based_rho(s: Settings) -> None:
    """The batched entry has no per-segment host clock for the
    reference's wall-clock interval rule; reject it rather than ignore it."""
    if s.adaptive_rho_time:
        raise OSQPError(
            ErrorCode.SETTINGS_VALIDATION_ERROR,
            "adaptive_rho_time (wall-clock interval selection) is only "
            "honored by the stateful Solver; batched entries use the "
            "deterministic interval",
        )


def _resolve_rho_interval(s: Settings) -> int:
    """Deterministic adaptive-rho interval (constants.h:111-112,
    osqp.c:487-498)."""
    if not s.adaptive_rho:
        return 0
    if s.adaptive_rho_interval:
        return int(s.adaptive_rho_interval)
    if s.adaptive_rho_time:
        return 0  # selected at run time by a segmented host driver
    if s.check_termination:
        return con.ADAPTIVE_RHO_MULTIPLE_TERMINATION * int(s.check_termination)
    return con.ADAPTIVE_RHO_FIXED


def make_config(n: int, m: int, settings: Settings, dtype) -> StaticConfig:
    """The one place a StaticConfig is derived from Settings."""
    return StaticConfig(
        n=n,
        m=m,
        max_iter=int(settings.max_iter),
        check_termination=int(settings.check_termination),
        adaptive_rho=bool(settings.adaptive_rho),
        adaptive_rho_interval=_resolve_rho_interval(settings),
        scaled_termination=bool(settings.scaled_termination),
        linsys_solver=str(settings.linsys_solver),
        dtype=str(torch_dtype(dtype)).removeprefix("torch."),
    )


# ---------------------------------------------------------------------------
# Info / results (types.h:66-91)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Info:
    iter: int = 0
    status: str = "unsolved"
    status_val: int = con.OSQP_UNSOLVED
    status_polish: int = 0
    obj_val: float = float("nan")
    pri_res: float = float("nan")
    dua_res: float = float("nan")
    setup_time: float = 0.0
    solve_time: float = 0.0
    update_time: float = 0.0
    polish_time: float = 0.0
    run_time: float = 0.0
    rho_updates: int = 0
    rho_estimate: float = con.RHO


@dataclasses.dataclass
class Results:
    x: np.ndarray
    y: np.ndarray
    prim_inf_cert: np.ndarray | None
    dual_inf_cert: np.ndarray | None
    info: Info


def update_csc_values(M, x_new, x_idx, name):
    """Indexed nnz-value update on a scipy CSC matrix, with the
    reference's validation (osqp.c:1031-1062)."""
    x_new = np.asarray(x_new, np.float64).ravel()
    if x_idx is None:
        if x_new.shape[0] != M.nnz:
            raise OSQPError(
                ErrorCode.DATA_VALIDATION_ERROR,
                f"new {name} has wrong number of nonzeros ({x_new.shape[0]} != {M.nnz})",
            )
        M.data[:] = x_new
    else:
        x_idx = np.asarray(x_idx, np.int64).ravel()
        if x_idx.shape[0] != x_new.shape[0]:
            raise OSQPError(ErrorCode.DATA_VALIDATION_ERROR, "index/value length mismatch")
        if x_idx.size and (x_idx.max() >= M.nnz or x_idx.min() < 0):
            raise OSQPError(ErrorCode.DATA_VALIDATION_ERROR, f"index exceeds {name} nonzeros")
        M.data[x_idx] = x_new


# ---------------------------------------------------------------------------
# Device-side stages
# ---------------------------------------------------------------------------
def _device_setup(cfg: StaticConfig, scaling_iters: int, P, q, A, l, u, rho, dyn):
    """Scale + classify rho + factorize + convexity check (osqp.c:192-215)."""
    data = QPData(P=P, q=q, A=A, l=l, u=u)
    B, n = q.shape
    if scaling_iters > 0:
        scaled, scl = scale_data(data, scaling_iters)
    else:
        scaled, scl = data, ScalingData.identity(B, n, cfg.m, q.dtype, q.device)
    rho_state = set_rho_state(scaled, rho)
    factor = linsys_registry.init_factor(cfg, scaled.P, scaled.A, dyn.sigma, rho_state.rho_vec)
    # Convexity check: the KKT is quasi-definite iff P + sigma I is PD,
    # the condition QDLDL checks by counting positive D entries
    # (qdldl_interface.c:93-99).
    eye = torch.eye(n, dtype=q.dtype, device=q.device)
    _, chol_info = torch.linalg.cholesky_ex(scaled.P + dyn.sigma * eye)
    return scaled, scl, rho_state, factor, chol_info == 0


def _device_refactor(cfg: StaticConfig, P, A, sigma, rho_vec):
    """Refactor after a rho or bounds change (osqp.c:1281-1332)."""
    return linsys_registry.init_factor(cfg, P, A, sigma, rho_vec)


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported to osqp_tpu_torch yet (ROADMAP queue 1, item {item})")


# ---------------------------------------------------------------------------
# Solver
# ---------------------------------------------------------------------------
class Solver:
    """Single-problem OSQP-compatible solver (a batch of one on the device)."""

    def __init__(self, P=None, q=None, A=None, l=None, u=None, device=None, **settings):
        self._is_setup = False
        if P is not None or q is not None:
            self.setup(P=P, q=q, A=A, l=l, u=u, device=device, **settings)

    # -- lifecycle ---------------------------------------------------------
    def setup(self, P=None, q=None, A=None, l=None, u=None, device=None, **settings):
        """osqp_setup (osqp.c:76-283).  ``device``: where the solver's
        state lives and its solves run (default the CPU)."""
        t0 = time.perf_counter()
        unknown = set(settings) - {f.name for f in dataclasses.fields(Settings)}
        if unknown:
            raise OSQPError(ErrorCode.SETTINGS_VALIDATION_ERROR, f"unknown settings: {sorted(unknown)}")
        self.settings = Settings(**settings)
        validate_settings(self.settings)
        if self.settings.polish:
            raise _not_ported("polish", "10")

        # Canonical unscaled host data (float64 numpy / scipy CSC).
        Pu, qv, Ac, lv, uv, n, m = validate_problem(P, q, A, l, u)
        self._Pu, self._Ac = Pu, Ac
        self._q, self._l, self._u = qv, lv, uv
        self.n, self.m = n, m
        self.device = torch.device("cpu" if device is None else device)
        self._dtype = torch_dtype(self.settings.dtype)
        self._cfg = make_config(n, m, self.settings, self._dtype)
        self._dyn = DynSettings.make(
            self._dtype,
            sigma=self.settings.sigma,
            alpha=self.settings.alpha,
            eps_abs=self.settings.eps_abs,
            eps_rel=self.settings.eps_rel,
            eps_prim_inf=self.settings.eps_prim_inf,
            eps_dual_inf=self.settings.eps_dual_inf,
            adaptive_rho_tolerance=self.settings.adaptive_rho_tolerance,
            delta=self.settings.delta,
        )

        self._push_data_and_factor(rho=self.settings.rho)

        self.iterates = self._cold()
        self.info = Info(rho_estimate=float(self.settings.rho))
        self._first_run = True
        self._clear_update_time = False
        self.info.setup_time = time.perf_counter() - t0
        self._is_setup = True
        if self.settings.verbose:
            from .utils.printing import print_setup_header

            print_setup_header(self)
        return self

    def _tensor(self, a) -> torch.Tensor:
        """Host data as a batch-of-1 tensor in the solve dtype on the device."""
        return torch.as_tensor(np.asarray(a, np.float64), dtype=self._dtype, device=self.device)[None].contiguous()

    def _cold(self) -> Iterates:
        return Iterates.cold(1, self.n, self.m, self._dtype, self.device)

    def _push_data_and_factor(self, rho: float):
        """(Re)upload unscaled data, rescale, classify rho, refactor: the
        tail of osqp_setup and of osqp_update_P/A (osqp.c:1048-1075)."""
        data_unscaled = (
            self._tensor(triu_to_full(self._Pu)),
            self._tensor(self._q),
            self._tensor(self._Ac.toarray()),
            self._tensor(self._l),
            self._tensor(self._u),
        )
        rho_arr = torch.full((1,), rho, dtype=self._dtype, device=self.device)
        scaled, scl, rho_state, factor, cvx_ok = _device_setup(
            self._cfg, int(self.settings.scaling), *data_unscaled, rho_arr, self._dyn
        )
        if not bool(cvx_ok[0]):
            raise NonConvexError("problem non convex: P + sigma*I is not positive definite")
        self.data = scaled
        self.scaling = scl
        self.rho_state = rho_state
        self.factor = factor

    def _require_setup(self):
        if not self._is_setup:
            raise OSQPError(ErrorCode.WORKSPACE_NOT_INIT_ERROR)

    # -- solve --------------------------------------------------------------
    def solve(self) -> Results:
        """osqp_solve (osqp.c:288-654)."""
        self._require_setup()
        if self._clear_update_time:
            self.info.update_time = 0.0
        t0 = time.perf_counter()

        iterates = self.iterates if self.settings.warm_start else self._cold()
        # Always the segmented host loop: time_limit polling
        # (osqp.c:387-407), per-interval printing (osqp.c:414-427) and
        # Ctrl-C polling (osqp.c:374-385), as the JAX package does.
        result = self._solve_segmented(iterates, t0)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.info.solve_time = time.perf_counter() - t0

        # Persist adapted rho/factor + final iterates for warm starting
        self.rho_state = result.rho_state
        self.factor = result.factor
        self.iterates = result.iterates

        info = result.info
        status_val = int(info.status_val[0])
        self.info.iter = int(info.iter[0])
        self.info.status_val = status_val
        self.info.status = con.STATUS_MESSAGE.get(status_val, "unknown")
        self.info.obj_val = float(info.obj_val[0])
        self.info.pri_res = float(info.pri_res[0])
        self.info.dua_res = float(info.dua_res[0])
        self.info.rho_updates = int(info.rho_updates[0])
        self.info.rho_estimate = float(info.rho_estimate[0])
        self.info.status_polish = 0
        self.info.polish_time = 0.0

        # ---- store_solution (auxil.c:524-562) -----------------------------
        host = lambda t: t[0].to(device="cpu", dtype=torch.float64).numpy()
        prim_cert = dual_cert = None
        if status_val not in _NO_SOLUTION:
            x_u, y_u = unscale_solution(self.iterates.x, self.iterates.y, self.scaling)
            x_out, y_out = host(x_u), host(y_u)
        else:
            x_out = np.full(self.n, np.nan)
            y_out = np.full(self.m, np.nan)
            if status_val in (con.OSQP_PRIMAL_INFEASIBLE, con.OSQP_PRIMAL_INFEASIBLE_INACCURATE):
                dy = host(result.delta_y)
                nrm = np.max(np.abs(dy)) if dy.size else 0.0
                prim_cert = dy / nrm if nrm > 0 else dy
            if status_val in (con.OSQP_DUAL_INFEASIBLE, con.OSQP_DUAL_INFEASIBLE_INACCURATE):
                dx = host(result.delta_x)
                nrm = np.max(np.abs(dx))
                dual_cert = dx / nrm if nrm > 0 else dx
            # Cold start iterates for the next run (auxil.c:559-561)
            self.iterates = self._cold()

        # ---- run_time composition (osqp.c:610-628) ------------------------
        if self._first_run:
            self.info.run_time = self.info.setup_time + self.info.solve_time + self.info.polish_time
            self._first_run = False
        else:
            self.info.run_time = self.info.update_time + self.info.solve_time + self.info.polish_time
        self._clear_update_time = True

        if self.settings.verbose:
            from .utils.printing import print_summary_footer

            print_summary_footer(self)

        return Results(
            x=x_out, y=y_out, prim_inf_cert=prim_cert, dual_inf_cert=dual_cert, info=dataclasses.replace(self.info)
        )

    def _solve_segmented(self, iterates, t0: float):
        """Host-chunked solve (osqp_tpu/solver.py:557-626): segments of
        ``check`` iterations when verbose or with the time-based rho rule,
        else of max(4 check, 100); between segments it polls the clock
        (time_limit), prints summary rows and catches Ctrl-C.  The loop
        body (K1 or K1r) is chosen per segment, so these lengths are the
        JAX package's exactly."""
        from .utils.printing import IterRowPrinter

        cfg = self._cfg
        verbose = bool(self.settings.verbose)
        time_limit = float(self.settings.time_limit)
        # Reference PROFILING rule (osqp.c:456-485), opt-in: the interval
        # stays 0 (no in-loop adaptation) until solve wall time exceeds
        # adaptive_rho_fraction x setup time, then is fixed to the
        # current iteration rounded to a multiple of check_termination.
        rho_time = bool(self.settings.adaptive_rho_time) and cfg.adaptive_rho and cfg.adaptive_rho_interval == 0
        check = cfg.check_termination if cfg.check_termination > 0 else 25
        seg = check if (verbose or rho_time) else max(4 * check, 100)

        c = admm_mod.init_carry(cfg, self.data, self.rho_state, self.factor, iterates)
        rows = IterRowPrinter(t0) if verbose else None
        fallback = con.OSQP_MAX_ITER_REACHED
        run_checks = True
        k = 1
        # time budget composition (osqp.c:387-396)
        base_time = self.info.setup_time if self._first_run else self.info.update_time
        try:
            while k <= cfg.max_iter:
                end = min(k + seg - 1, cfg.max_iter)
                c = admm_mod.run_segment(cfg, self.data, self.scaling, self._dyn, c, end)
                k = end + 1
                elapsed = time.perf_counter() - t0
                if rho_time and elapsed > self.settings.adaptive_rho_fraction * self.info.setup_time:
                    # c_roundmultiple(iter, check_termination), floored at
                    # check_termination (osqp.c:469-483)
                    interval = max(int(round(end / check)) * check, check)
                    cfg = dataclasses.replace(cfg, adaptive_rho_interval=interval)
                    rho_time = False
                if verbose:
                    rows.maybe(end, lambda: admm_mod.segment_row_info(cfg, self.data, self.scaling, self._dyn, c))
                if not c.any_active:
                    break
                if time_limit > 0 and base_time + elapsed >= time_limit:
                    fallback = con.OSQP_TIME_LIMIT_REACHED
                    break
        except KeyboardInterrupt:
            fallback = con.OSQP_SIGINT
            run_checks = False
            print("Solver interrupted")
        return admm_mod.finalize(
            cfg, self.data, self.scaling, self._dyn, c, fallback_status=fallback, run_checks=run_checks
        )

    # -- warm start (osqp.c:942-1007) ---------------------------------------
    def warm_start(self, x=None, y=None):
        self._require_setup()
        if x is None and y is None:
            raise OSQPError(ErrorCode.DATA_VALIDATION_ERROR, "nothing to warm start")
        if not self.settings.warm_start:
            self.settings.warm_start = True
        it = self.iterates
        if x is not None:
            xs = self._tensor(np.asarray(x, np.float64).reshape(self.n)) * self.scaling.Dinv
            it = Iterates(x=xs, z=mat_vec(self.data.A, xs), y=it.y)  # z = A x (osqp.c:960)
        if y is not None:
            ys = self._tensor(np.asarray(y, np.float64).reshape(self.m)) * self.scaling.Einv * self.scaling.c[:, None]
            it = Iterates(x=it.x, z=it.z, y=ys)
        self.iterates = it

    def export(self, path: str | None = None, B: int = 1) -> bytes:
        """The EMBEDDED/codegen workflow of the reference; not ported yet."""
        raise _not_ported("Solver.export", "14")

    def update(self, **kwargs):
        """osqp-python-style combined update: accepts q, l, u, Px, Px_idx,
        Ax, Ax_idx and dispatches to the specific update paths."""
        self._require_setup()
        allowed = {"q", "l", "u", "Px", "Px_idx", "Ax", "Ax_idx"}
        unknown = set(kwargs) - allowed
        if unknown:
            raise OSQPError(ErrorCode.DATA_VALIDATION_ERROR, f"update: unknown arguments {sorted(unknown)}")
        if not (set(kwargs) & {"q", "l", "u", "Px", "Ax"}):
            raise OSQPError(ErrorCode.DATA_VALIDATION_ERROR, "update: nothing to update (indices without values?)")
        if "q" in kwargs:
            self.update_lin_cost(kwargs["q"])
        if "l" in kwargs or "u" in kwargs:
            self.update_bounds(l=kwargs.get("l"), u=kwargs.get("u"))
        if "Px" in kwargs or "Ax" in kwargs:
            self.update_P_A(
                Px=kwargs.get("Px"), Px_idx=kwargs.get("Px_idx"), Ax=kwargs.get("Ax"), Ax_idx=kwargs.get("Ax_idx")
            )

    # -- data updates ---------------------------------------------------------
    def _start_update_timer(self):
        if self._clear_update_time:
            self._clear_update_time = False
            self.info.update_time = 0.0
        return time.perf_counter()

    def _reset_info(self):
        """reset_info (auxil.c:632-649)."""
        self.info.status_val = con.OSQP_UNSOLVED
        self.info.status = con.STATUS_MESSAGE[con.OSQP_UNSOLVED]
        self.info.solve_time = 0.0
        self.info.polish_time = 0.0
        self.info.rho_updates = 0

    def update_lin_cost(self, q_new):
        """osqp_update_lin_cost (osqp.c:765-795): q_scaled = c * D * q_new."""
        self._require_setup()
        t0 = self._start_update_timer()
        q_new = np.asarray(q_new, np.float64).reshape(self.n)
        self._q = q_new
        qs = self._tensor(q_new) * self.scaling.D * self.scaling.c[:, None]
        self.data = _rp(self.data, q=qs)
        self._reset_info()
        self.info.update_time += time.perf_counter() - t0

    def update_bounds(self, l=None, u=None):
        """osqp_update_bounds / _lower_bound / _upper_bound (osqp.c:797-940)."""
        self._require_setup()
        t0 = self._start_update_timer()
        l_new = clamp_bounds(l).reshape(self.m) if l is not None else self._l
        u_new = clamp_bounds(u).reshape(self.m) if u is not None else self._u
        if np.any(l_new > u_new):
            raise OSQPError(ErrorCode.DATA_VALIDATION_ERROR, "lower bound must be lower than or equal to upper bound")
        self._l, self._u = l_new, u_new
        self.data = _rp(self.data, l=self._tensor(l_new) * self.scaling.E, u=self._tensor(u_new) * self.scaling.E)
        self._reset_info()
        # update_rho_vec + conditional refactor (auxil.c:100-142)
        self.rho_state, changed = update_rho_state(self.data, self.rho_state)
        if bool(changed.any()):
            rv = self.rho_state.rho_vec
            self.factor = _device_refactor(self._cfg, self.data.P, self.data.A, self._dyn.sigma, rv)
        self.info.update_time += time.perf_counter() - t0

    def update_lower_bound(self, l_new):
        self.update_bounds(l=l_new)

    def update_upper_bound(self, u_new):
        self.update_bounds(u=u_new)

    def update_P(self, Px=None, Px_idx=None, **_):
        """osqp_update_P (osqp.c:1012-1090): new values on the triu(P)
        pattern; rescales from scratch and refactors."""
        self.update_P_A(Px=Px, Px_idx=Px_idx)

    def update_A(self, Ax=None, Ax_idx=None, **_):
        """osqp_update_A (osqp.c:1092-1169)."""
        self.update_P_A(Ax=Ax, Ax_idx=Ax_idx)

    def update_P_A(self, Px=None, Px_idx=None, Ax=None, Ax_idx=None):
        """osqp_update_P_A (osqp.c:1171-1279)."""
        self._require_setup()
        t0 = self._start_update_timer()
        if Px is not None:
            update_csc_values(self._Pu, Px, Px_idx, "P")
        if Ax is not None:
            update_csc_values(self._Ac, Ax, Ax_idx, "A")
        self._push_data_and_factor(rho=float(self.rho_state.rho[0]))
        self._reset_info()
        self.info.update_time += time.perf_counter() - t0

    def update_rho(self, rho_new):
        """osqp_update_rho (osqp.c:1281-1332)."""
        self._require_setup()
        if rho_new <= 0:
            raise OSQPError(ErrorCode.SETTINGS_VALIDATION_ERROR, "rho must be positive")
        t0 = self._start_update_timer()
        rho = float(np.clip(rho_new, con.RHO_MIN, con.RHO_MAX))
        self.settings.rho = rho
        rho_arr = torch.full((1,), rho, dtype=self._dtype, device=self.device)
        rv = rho_vec_from_type(self.rho_state.constr_type, rho_arr)
        self.rho_state = dataclasses.replace(self.rho_state, rho=rho_arr, rho_vec=rv, rho_inv_vec=1.0 / rv)
        self.factor = _device_refactor(self._cfg, self.data.P, self.data.A, self._dyn.sigma, rv)
        self.info.update_time += time.perf_counter() - t0

    # -- settings setters (osqp.c:1339-1617) ----------------------------------
    def _set_dyn(self, **kw):
        self._dyn = dataclasses.replace(self._dyn, **{k: torch.tensor(v, dtype=self._dtype) for k, v in kw.items()})

    def _check(self, ok: bool, msg: str):
        if not ok:
            raise OSQPError(ErrorCode.SETTINGS_VALIDATION_ERROR, msg)

    def update_max_iter(self, v):
        self._check(v > 0, "max_iter must be positive")
        self.settings.max_iter = int(v)
        self._cfg = dataclasses.replace(self._cfg, max_iter=int(v))

    def update_eps_abs(self, v):
        self._check(v >= 0, "eps_abs must be nonnegative")
        self.settings.eps_abs = float(v)
        self._set_dyn(eps_abs=v)

    def update_eps_rel(self, v):
        self._check(v >= 0, "eps_rel must be nonnegative")
        self.settings.eps_rel = float(v)
        self._set_dyn(eps_rel=v)

    def update_eps_prim_inf(self, v):
        self._check(v > 0, "eps_prim_inf must be positive")
        self.settings.eps_prim_inf = float(v)
        self._set_dyn(eps_prim_inf=v)

    def update_eps_dual_inf(self, v):
        self._check(v > 0, "eps_dual_inf must be positive")
        self.settings.eps_dual_inf = float(v)
        self._set_dyn(eps_dual_inf=v)

    def update_alpha(self, v):
        self._check(0 < v < 2, "alpha must be strictly between 0 and 2")
        self.settings.alpha = float(v)
        self._set_dyn(alpha=v)

    def update_delta(self, v):
        self._check(v > 0, "delta must be positive")
        self.settings.delta = float(v)
        self._set_dyn(delta=v)

    def update_polish(self, v):
        self._check(v in (0, 1, True, False), "polish should be either 0 or 1")
        if v:
            raise _not_ported("polish", "10")
        self.settings.polish = False

    def update_polish_refine_iter(self, v):
        self._check(v >= 0, "polish_refine_iter must be nonnegative")
        self.settings.polish_refine_iter = int(v)

    def update_verbose(self, v):
        self._check(v in (0, 1, True, False), "verbose should be either 0 or 1")
        self.settings.verbose = bool(v)

    def update_scaled_termination(self, v):
        self._check(v in (0, 1, True, False), "scaled_termination should be either 0 or 1")
        self.settings.scaled_termination = bool(v)
        self._cfg = dataclasses.replace(self._cfg, scaled_termination=bool(v))

    def update_check_termination(self, v):
        self._check(v >= 0, "check_termination should be nonnegative")
        self.settings.check_termination = int(v)
        self._cfg = dataclasses.replace(
            self._cfg, check_termination=int(v), adaptive_rho_interval=_resolve_rho_interval(self.settings)
        )

    def update_warm_start(self, v):
        self._check(v in (0, 1, True, False), "warm_start should be either 0 or 1")
        self.settings.warm_start = bool(v)

    def update_time_limit(self, v):
        self._check(v >= 0, "time_limit must be nonnegative")
        self.settings.time_limit = float(v)


_NO_SOLUTION = (
    con.OSQP_PRIMAL_INFEASIBLE,
    con.OSQP_PRIMAL_INFEASIBLE_INACCURATE,
    con.OSQP_DUAL_INFEASIBLE,
    con.OSQP_DUAL_INFEASIBLE_INACCURATE,
    con.OSQP_NON_CVX,
)

# Reference-style alias: ``osqp_tpu_torch.OSQP().setup(...)``
OSQP = Solver
