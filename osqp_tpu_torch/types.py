"""Core state types of the port: frozen dataclasses of tensors.

Counterpart of ``osqp_tpu/types.py``, where the same classes are jax
pytrees.  Every tensor carries a leading batch axis ``B``; functions
return new instances (``dataclasses.replace``) instead of mutating.

* :class:`StaticConfig` — frozen and hashable: problem shape, iteration
  schedule, backend choice, dtype.
* :class:`DynSettings` — runtime scalars, held as 0-d *host* tensors in
  the solve dtype.  They enter device arithmetic as scalars and read
  back with ``float()`` without a device sync.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from . import constants as con


@dataclasses.dataclass(frozen=True)
class QPData:
    """Batched dense QP data; ``P`` is dense symmetric."""

    P: torch.Tensor  # (B, n, n)
    q: torch.Tensor  # (B, n)
    A: torch.Tensor  # (B, m, n)
    l: torch.Tensor  # (B, m)   clamped to [-OSQP_INFTY, OSQP_INFTY]
    u: torch.Tensor  # (B, m)


@dataclasses.dataclass(frozen=True)
class ScalingData:
    """Ruiz equilibration state (reference OSQPScaling, types.h:45-52)."""

    c: torch.Tensor  # (B,)
    cinv: torch.Tensor  # (B,)
    D: torch.Tensor  # (B, n)
    Dinv: torch.Tensor  # (B, n)
    E: torch.Tensor  # (B, m)
    Einv: torch.Tensor  # (B, m)

    @staticmethod
    def identity(B: int, n: int, m: int, dtype, device) -> "ScalingData":
        one = lambda *s: torch.ones(s, dtype=dtype, device=device)
        return ScalingData(
            c=one(B), cinv=one(B), D=one(B, n), Dinv=one(B, n), E=one(B, m), Einv=one(B, m)
        )


@dataclasses.dataclass(frozen=True)
class StaticConfig:
    """Hashable configuration: shape, schedule, backend, dtype, polish."""

    n: int
    m: int
    max_iter: int = con.MAX_ITER
    check_termination: int = con.CHECK_TERMINATION
    adaptive_rho: bool = con.ADAPTIVE_RHO
    adaptive_rho_interval: int = con.ADAPTIVE_RHO_MULTIPLE_TERMINATION * con.CHECK_TERMINATION
    scaled_termination: bool = con.SCALED_TERMINATION
    linsys_solver: str = "dense_inv"
    dtype: str = "float64"
    # Knobs of the cg backend: its step cap (0 -> n + m) and the floor of
    # its inexact tolerance schedule; and the stage-block size of
    # block_tridiag.
    cg_max_iter: int = 0
    cg_tol_fraction: float = 1e-7
    block_size: int = 0
    polish_passes: int = con.POLISH_PASSES
    # e.g. "float64": polish in float64 over a float32 solve; None: the solve dtype
    polish_dtype: str | None = None


@dataclasses.dataclass(frozen=True)
class DynSettings:
    """Runtime settings (reference OSQPSettings, types.h:139-176)."""

    sigma: torch.Tensor
    alpha: torch.Tensor
    eps_abs: torch.Tensor
    eps_rel: torch.Tensor
    eps_prim_inf: torch.Tensor
    eps_dual_inf: torch.Tensor
    adaptive_rho_tolerance: torch.Tensor
    delta: torch.Tensor  # polish regularization

    @staticmethod
    def make(
        dtype,
        sigma=con.SIGMA,
        alpha=con.ALPHA,
        eps_abs=con.EPS_ABS,
        eps_rel=con.EPS_REL,
        eps_prim_inf=con.EPS_PRIM_INF,
        eps_dual_inf=con.EPS_DUAL_INF,
        adaptive_rho_tolerance=con.ADAPTIVE_RHO_TOLERANCE,
        delta=con.DELTA,
    ) -> "DynSettings":
        a = lambda v: torch.tensor(v, dtype=dtype)
        return DynSettings(
            sigma=a(sigma),
            alpha=a(alpha),
            eps_abs=a(eps_abs),
            eps_rel=a(eps_rel),
            eps_prim_inf=a(eps_prim_inf),
            eps_dual_inf=a(eps_dual_inf),
            adaptive_rho_tolerance=a(adaptive_rho_tolerance),
            delta=a(delta),
        )


@dataclasses.dataclass(frozen=True)
class RhoState:
    """Per-constraint penalty (auxil.c:76-142)."""

    rho: torch.Tensor  # (B,)
    rho_vec: torch.Tensor  # (B, m)
    rho_inv_vec: torch.Tensor  # (B, m)
    constr_type: torch.Tensor  # (B, m) int8: -1 loose, 0 ineq, 1 eq


@dataclasses.dataclass(frozen=True)
class Iterates:
    x: torch.Tensor  # (B, n)
    z: torch.Tensor  # (B, m)
    y: torch.Tensor  # (B, m)

    @staticmethod
    def cold(B: int, n: int, m: int, dtype, device) -> "Iterates":
        """cold_start (auxil.c:155-159)."""
        z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
        return Iterates(x=z(B, n), z=z(B, m), y=z(B, m))


@dataclasses.dataclass(frozen=True)
class InfoState:
    """Per-instance solve info (reference OSQPInfo, types.h:66-91)."""

    iter: torch.Tensor  # (B,) int32
    status_val: torch.Tensor  # (B,) int32
    obj_val: torch.Tensor  # (B,)
    pri_res: torch.Tensor  # (B,)
    dua_res: torch.Tensor  # (B,)
    rho_updates: torch.Tensor  # (B,) int32
    rho_estimate: torch.Tensor  # (B,)

    @staticmethod
    def fresh(B: int, dtype, rho: torch.Tensor) -> "InfoState":
        dev = rho.device
        return InfoState(
            iter=torch.zeros(B, dtype=torch.int32, device=dev),
            status_val=torch.full((B,), con.OSQP_UNSOLVED, dtype=torch.int32, device=dev),
            obj_val=torch.zeros(B, dtype=dtype, device=dev),
            pri_res=torch.full((B,), float("inf"), dtype=dtype, device=dev),
            dua_res=torch.full((B,), float("inf"), dtype=dtype, device=dev),
            rho_updates=torch.zeros(B, dtype=torch.int32, device=dev),
            rho_estimate=rho.to(dtype).expand(B).clone(),
        )


@dataclasses.dataclass(frozen=True)
class SolveResult:
    """Output of the solve core (still scaled; the caller unscales)."""

    iterates: Iterates
    info: InfoState
    rho_state: RhoState
    factor: Any  # linsys factorization after possible rho updates
    delta_x: torch.Tensor  # (B, n) dual-infeasibility certificate
    delta_y: torch.Tensor  # (B, m) primal-infeasibility certificate
