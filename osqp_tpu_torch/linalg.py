"""Batched dense linear-algebra primitives (counterpart of
``osqp_tpu/linalg.py``, dense operands only).

Importing this module pins float32 matrix products to full precision.
On the H100, TF32 would keep about three decimal digits, and ADMM
silently stalls at reduced-precision products: the same reason the JAX
package wraps its traced bodies in ``with_high_precision``.
"""

from __future__ import annotations

import dataclasses

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def norm_inf(v: torch.Tensor) -> torch.Tensor:
    """Batched infinity norm over the last axis (lin_alg.c:32-43);
    zero-length axis gives 0."""
    if v.shape[-1] == 0:
        return torch.zeros(v.shape[:-1], dtype=v.dtype, device=v.device)
    return v.abs().amax(-1)


def scaled_norm_inf(S: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """||diag(S) v||_inf (lin_alg.c:19-30)."""
    if v.shape[-1] == 0:
        return torch.zeros(v.shape[:-1], dtype=v.dtype, device=v.device)
    return (S * v).abs().amax(-1)


def mat_vec(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched A @ x: (B, m, n) x (B, n) -> (B, m) (lin_alg.c:241-271)."""
    return torch.bmm(A, x.unsqueeze(-1)).squeeze(-1)


def mat_tvec(A: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Batched A' @ y: (B, m, n) x (B, m) -> (B, n) (lin_alg.c:273-323)."""
    return torch.bmm(y.unsqueeze(-2), A).squeeze(-2)


def quad_form(P: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """0.5 x' P x with symmetric P (lin_alg.c:387-413)."""
    return 0.5 * vec_dot(x, mat_vec(P, x))


def vec_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched inner product over the last axis (lin_alg.c:143-152)."""
    return (a * b).sum(-1)


def bwhere(mask: torch.Tensor, new, old):
    """Per-instance select: ``mask`` (B,) applied to (B, ...) tensors or
    to dataclasses of them, field by field."""
    if dataclasses.is_dataclass(new):
        return dataclasses.replace(
            new,
            **{
                f.name: bwhere(mask, getattr(new, f.name), getattr(old, f.name))
                for f in dataclasses.fields(new)
            },
        )
    m = mask.reshape(mask.shape + (1,) * (new.ndim - mask.ndim))
    return torch.where(m, new, old)
