"""osqp_tpu_torch — the PyTorch/CUDA port of osqp_tpu.

The same batched OSQP algorithm (ADMM with Ruiz scaling, adaptive rho
and infeasibility certificates) on dense batched data, written for an
NVIDIA H100.  The two routines that carry the dense main path are
hand-written CUDA kernels (``osqp_tpu_torch/csrc``):

* the fused ADMM iteration (:mod:`osqp_tpu_torch.ops.admm_iter`),
* the batched SPD inverse (:mod:`osqp_tpu_torch.ops.spd_inverse`).

Each has a plain PyTorch version beside it, which serves CPU tensors.
A CUDA tensor always goes through the kernel.  The package imports
neither jax nor ``osqp_tpu``; ``osqp_tpu`` stays the reference that the
tests hold this package against.

Entry point: :func:`solve_batch`.
"""

from __future__ import annotations

import importlib.metadata
import pathlib
import tomllib

from . import linalg  # noqa: F401  (pins full-f32 matmuls at import)


def _version() -> str:
    """The one version, ``pyproject.toml``'s: read from the file in a
    source checkout, else from the installed distribution's metadata."""
    pyproject = pathlib.Path(__file__).resolve().parent.parent / "pyproject.toml"
    if pyproject.is_file():
        with open(pyproject, "rb") as f:
            return tomllib.load(f)["project"]["version"]
    return importlib.metadata.version("osqp-tpu")


__version__ = _version()

from . import constants  # noqa: E402
from .batch import BatchSolveResults, solve_batch  # noqa: E402
from .constants import (  # noqa: E402
    OSQP_DUAL_INFEASIBLE,
    OSQP_DUAL_INFEASIBLE_INACCURATE,
    OSQP_MAX_ITER_REACHED,
    OSQP_NON_CVX,
    OSQP_PRIMAL_INFEASIBLE,
    OSQP_PRIMAL_INFEASIBLE_INACCURATE,
    OSQP_SIGINT,
    OSQP_SOLVED,
    OSQP_SOLVED_INACCURATE,
    OSQP_TIME_LIMIT_REACHED,
    OSQP_UNSOLVED,
    ErrorCode,
    OSQPError,
)
from .solver import Settings  # noqa: E402
from .types import DynSettings, QPData, ScalingData, StaticConfig  # noqa: E402

__all__ = [
    "solve_batch",
    "BatchSolveResults",
    "Settings",
    "QPData",
    "ScalingData",
    "DynSettings",
    "StaticConfig",
    "OSQPError",
    "ErrorCode",
    "constants",
    "OSQP_SOLVED",
    "OSQP_SOLVED_INACCURATE",
    "OSQP_MAX_ITER_REACHED",
    "OSQP_PRIMAL_INFEASIBLE",
    "OSQP_PRIMAL_INFEASIBLE_INACCURATE",
    "OSQP_DUAL_INFEASIBLE",
    "OSQP_DUAL_INFEASIBLE_INACCURATE",
    "OSQP_NON_CVX",
    "OSQP_UNSOLVED",
    "OSQP_SIGINT",
    "OSQP_TIME_LIMIT_REACHED",
]
