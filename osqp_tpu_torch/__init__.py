"""osqp_tpu_torch — the PyTorch/CUDA port of osqp_tpu.

The same batched OSQP algorithm (ADMM with Ruiz scaling, adaptive rho
and infeasibility certificates) on dense batched data, written for an
NVIDIA H100.  The routines that carry the dense main path are
hand-written CUDA kernels (``osqp_tpu_torch/csrc``):

* the fused ADMM iteration, plain and refined body
  (:mod:`osqp_tpu_torch.ops.admm_iter`),
* the batched SPD inverse (:mod:`osqp_tpu_torch.ops.spd_inverse`),
* the termination and rho-estimate products
  (:mod:`osqp_tpu_torch.ops.term_products`),
* the Ruiz equilibration (:mod:`osqp_tpu_torch.ops.ruiz`),
* the partially pivoted LU of the full KKT matrix and its solve, for
  polish and the ``kkt_lu`` backend (:mod:`osqp_tpu_torch.ops.kkt_lu`),
* the row-gather products of sparse ELL operands
  (:mod:`osqp_tpu_torch.ops.ell`),
* the batched preconditioned conjugate gradient of the ``cg`` backend
  and of polish on sparse operands (:mod:`osqp_tpu_torch.ops.cg`),
* the block-tridiagonal Cholesky recursion and its solve, for the
  ``block_tridiag`` backend (:mod:`osqp_tpu_torch.ops.block_tridiag`).

Each has a plain PyTorch version beside it, which serves CPU tensors.
A CUDA tensor always goes through the kernel.  The package imports
neither jax nor ``osqp_tpu``; ``osqp_tpu`` stays the reference that the
tests hold this package against.

Entry points: the stateful :class:`Solver` (alias :data:`OSQP`), OSQP's
own API, :func:`solve_batch` for B same-shape problems, and
:class:`BatchedSolver`, which keeps such a batch on the device for
parametric updates and warm-started re-solves (``resolve``); all polish
with ``polish=True`` and take ``linsys_solver`` ``"dense_inv"``,
``"dense_chol"``, ``"kkt_lu"``, ``"cg"`` or ``"block_tridiag"`` (with
``block_size``, for stage-ordered problems such as
:func:`osqp_tpu_torch.models.build_mpc_qp`'s).  :func:`solve_sparse`
solves scipy-sparse problems (or scenario batches sharing their pattern)
on ELL operands without densifying them, through ``cg``, and
:class:`SparseSolver` is the stateful solver over them.  On top of
them, :func:`osqp_tpu_torch.buckets.solve_problems` solves a list of QPs
of different shapes (one batched solve per padded shape bucket),
:func:`osqp_tpu_torch.maros.run_maros` runs the Maros-Meszaros harness
and :func:`osqp_tpu_torch.benchmarks.run_suite` the OSQP-paper families,
each solution checked by :mod:`osqp_tpu_torch.verify`.
:func:`make_qp_layer` is the differentiable batched QP layer (a
``torch.autograd.Function``), ``solve_batch(..., compact=True)`` shrinks
the working batch as instances finish, and :mod:`osqp_tpu_torch.export`
writes and loads fixed-shape solver artifacts (``Solver.export``,
``SparseSolver.export``).
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
from .diff import make_qp_layer  # noqa: E402
from .large import SparseSolver, solve_sparse  # noqa: E402
from .parametric import BatchedSolver  # noqa: E402
from .solver import OSQP, Info, Results, Settings, Solver  # noqa: E402
from .types import DynSettings, QPData, ScalingData, StaticConfig  # noqa: E402

__all__ = [
    "Solver",
    "OSQP",
    "Info",
    "Results",
    "solve_batch",
    "BatchedSolver",
    "solve_sparse",
    "SparseSolver",
    "make_qp_layer",
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
