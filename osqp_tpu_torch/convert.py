"""Carry state across from the JAX package.

Turns the arrays of ``osqp_tpu``'s ``QPData``, ``ScalingData``,
``RhoState``, ``Iterates``, ``DynSettings`` and factor dicts (anything
``numpy.asarray`` reads) into this package's types, on a given device
and dtype.  The tests use it to put identical scaled data, factors and
iterates through both packages.  Nothing here imports jax.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .types import DynSettings


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
    """A ``dense_inv`` factor dict (Minv, AMinvT, refine, P, sigma); the
    0-d ``sigma`` stays on the host."""
    out = {k: to_tensor(v, device, dtype) for k, v in f.items()}
    out["sigma"] = to_tensor(f["sigma"], "cpu", dtype)
    return out
