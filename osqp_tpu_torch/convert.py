"""Carry state across from the JAX package.

Turns the arrays of ``osqp_tpu``'s ``QPData``, ``ScalingData``,
``RhoState``, ``Iterates``, ``DynSettings``, ``ELLMatrix`` and factor
dicts (anything ``numpy.asarray`` reads) into this package's types, on
a given device and dtype, and carries a whole ``osqp_tpu.Solver``'s (or
``osqp_tpu.parametric.BatchedSolver``'s) device state into an
``osqp_tpu_torch.Solver`` (or ``BatchedSolver``).  The tests use it to
put identical scaled data, factors and iterates through both packages.
Nothing here imports jax.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .sparse_ops import ELLMatrix
from .types import DynSettings, Iterates, QPData, RhoState, ScalingData


def to_tensor(a, device, dtype: torch.dtype) -> torch.Tensor:
    """Floating arrays become ``dtype``; integer and bool arrays keep
    their type (constraint classes, flags).  The data is copied."""
    arr = np.array(a)
    if arr.dtype.kind == "f":
        return torch.as_tensor(arr, dtype=dtype, device=device)
    return torch.as_tensor(arr, device=device)


def ell(E, device, dtype: torch.dtype) -> ELLMatrix:
    """The JAX package's ``ELLMatrix`` as the port's: values in ``dtype``
    (contiguous, one copy per instance), the int32 pattern as it is."""
    return ELLMatrix(
        val=to_tensor(E.val, device, dtype),
        idx=to_tensor(E.idx, device, dtype),
        t_val=to_tensor(E.t_val, device, dtype),
        t_idx=to_tensor(E.t_idx, device, dtype),
        shape=tuple(E.shape),
    )


def _leaf(v, device, dtype: torch.dtype):
    """A tensor, or an ELLMatrix where ``v`` is one."""
    return ell(v, device, dtype) if hasattr(v, "t_idx") else to_tensor(v, device, dtype)


def from_fields(cls, obj, device, dtype: torch.dtype):
    """An instance of the dataclass ``cls`` from an object with the same
    field names, e.g. ``from_fields(QPData, jax_qp_data, "cpu", torch.float64)``;
    a QPData's P and A may be ELL operands.  ``DynSettings`` scalars stay
    on the host, as the port keeps them."""
    if cls is DynSettings:
        device = "cpu"
    return cls(**{f.name: _leaf(getattr(obj, f.name), device, dtype) for f in dataclasses.fields(cls)})


def factor(f: dict, device, dtype: torch.dtype) -> dict:
    """A factor dict of the JAX package as the port's: ``dense_inv``
    (Minv, AMinvT, refine, P, sigma), ``kkt_lu`` (lu, and perm as int32),
    ``dense_chol`` (L) or ``cg`` (P, dense or ELL, sigma, dinv, max_iter,
    tol_frac, tol_rel).  0-d leaves (sigma, cg's int32 max_iter and
    tol_frac) stay scalars on the host."""
    scalar = lambda v: not hasattr(v, "t_idx") and np.ndim(v) == 0
    out = {k: to_tensor(v, "cpu", dtype) if scalar(v) else _leaf(v, device, dtype) for k, v in f.items()}
    if "perm" in f:
        out["perm"] = out["perm"].to(torch.int32)
    return out


def load_solver_state(solver, src) -> None:
    """Carry the device state of ``src``, an ``osqp_tpu.Solver`` (or
    ``osqp_tpu.parametric.BatchedSolver``), into ``solver``, an
    ``osqp_tpu_torch.Solver`` (or ``BatchedSolver``) set up on the same
    problem and settings: the scaled ``data``, ``scaling``, ``rho_state``,
    ``factor`` and ``iterates``, on ``solver``'s device and dtype."""
    dev, dt = solver.device, solver._dtype
    solver.data = from_fields(QPData, src.data, dev, dt)
    solver.scaling = from_fields(ScalingData, src.scaling, dev, dt)
    solver.rho_state = from_fields(RhoState, src.rho_state, dev, dt)
    solver.factor = factor(src.factor, dev, dt)
    solver.iterates = from_fields(Iterates, src.iterates, dev, dt)

