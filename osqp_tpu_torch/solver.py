"""Settings, their validation and the static configuration derived from
them (counterpart of ``osqp_tpu/solver.py:57-216``).

The stateful ``Solver``/``OSQP`` object is not ported yet (ROADMAP
queue 1, item 9); :func:`osqp_tpu_torch.solve_batch` is the entry point.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from . import constants as con
from . import linsys as linsys_registry
from .constants import ErrorCode, OSQPError
from .types import StaticConfig


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
