"""Carry state across from the JAX package.

Turns the arrays of ``osqp_tpu``'s ``QPData``, ``ScalingData``,
``RhoState``, ``Iterates``, ``DynSettings`` and factor dicts (anything
``numpy.asarray`` reads) into this package's types, on a given device
and dtype, and carries a whole ``osqp_tpu.Solver``'s device state into
an ``osqp_tpu_torch.Solver``.  The tests use it to put identical scaled
data, factors and iterates through both packages.  Nothing here imports
jax.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .types import DynSettings, Iterates, QPData, RhoState, ScalingData


def to_tensor(a, device, dtype: torch.dtype) -> torch.Tensor:
    """Floating arrays become ``dtype``; integer and bool arrays keep
    their type (constraint classes, flags).  The data is copied."""
    arr = np.array(a)
    if arr.dtype.kind == "f":
        return torch.as_tensor(arr, dtype=dtype, device=device)
    return torch.as_tensor(arr, device=device)


def from_fields(cls, obj, device, dtype: torch.dtype):
    """An instance of the dataclass ``cls`` from an object with the same
    field names, e.g. ``from_fields(QPData, jax_qp_data, "cpu", torch.float64)``.
    ``DynSettings`` scalars stay on the host, as the port keeps them."""
    if cls is DynSettings:
        device = "cpu"
    return cls(**{f.name: to_tensor(getattr(obj, f.name), device, dtype) for f in dataclasses.fields(cls)})


def factor(f: dict, device, dtype: torch.dtype) -> dict:
    """A factor dict of the JAX package as the port's: ``dense_inv``
    (Minv, AMinvT, refine, P, sigma; the 0-d ``sigma`` stays on the
    host), ``kkt_lu`` (lu, and perm as int32) or ``dense_chol`` (L)."""
    out = {k: to_tensor(v, device, dtype) for k, v in f.items()}
    if "sigma" in f:
        out["sigma"] = to_tensor(f["sigma"], "cpu", dtype)
    if "perm" in f:
        out["perm"] = out["perm"].to(torch.int32)
    return out


def load_solver_state(solver, src) -> None:
    """Carry the device state of ``src``, an ``osqp_tpu.Solver``, into
    ``solver``, an ``osqp_tpu_torch.Solver`` set up on the same problem
    and settings: the scaled ``data``, ``scaling``, ``rho_state``,
    ``factor`` and ``iterates``, on ``solver``'s device and dtype."""
    dev, dt = solver.device, solver._dtype
    solver.data = from_fields(QPData, src.data, dev, dt)
    solver.scaling = from_fields(ScalingData, src.scaling, dev, dt)
    solver.rho_state = from_fields(RhoState, src.rho_state, dev, dt)
    solver.factor = factor(src.factor, dev, dt)
    solver.iterates = from_fields(Iterates, src.iterates, dev, dt)
