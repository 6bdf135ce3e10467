"""Batched linear-algebra primitives (counterpart of
``osqp_tpu/linalg.py``).  The matrix products dispatch on the operand:
a dense (B, m, n) tensor goes to ``torch.bmm``, an
:class:`~osqp_tpu_torch.sparse_ops.ELLMatrix` to K5
(:mod:`osqp_tpu_torch.ops.ell`), an A whose rows are spread over
processes (:class:`~osqp_tpu_torch.parallel.rows.RowSharded`) to its
products and their collectives.

Importing this module pins float32 matrix products to full precision.
On the H100, TF32 would keep about three decimal digits, and ADMM
silently stalls at reduced-precision products: the same reason the JAX
package wraps its traced bodies in ``with_high_precision``.
"""

from __future__ import annotations

import dataclasses

import torch

from .ops.ell import ell_matvec, ell_tmatvec
from .parallel.rows import RowSharded
from .sparse_ops import ELLMatrix

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

# Reads of a device value by the host in the solve path (each waits for
# the device where it is a CUDA card), counted by :func:`host_read`.
host_reads = 0


def host_read(t: torch.Tensor):
    """``t.item()`` of a one-element tensor, counted in ``host_reads``."""
    global host_reads
    host_reads += 1
    return t.item()


def host_array(t: torch.Tensor):
    """A numpy copy of ``t``, counted in ``host_reads``."""
    global host_reads
    host_reads += 1
    return t.cpu().numpy()


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


def mat_vec(A, x: torch.Tensor) -> torch.Tensor:
    """Batched A @ x: (B, m, n) x (B, n) -> (B, m) (lin_alg.c:241-271)."""
    if isinstance(A, ELLMatrix):
        return ell_matvec(A, x)
    if isinstance(A, RowSharded):
        return A.matvec(x)
    return torch.bmm(A, x.unsqueeze(-1)).squeeze(-1)


def mat_tvec(A, y: torch.Tensor) -> torch.Tensor:
    """Batched A' @ y: (B, m, n) x (B, m) -> (B, n) (lin_alg.c:273-323)."""
    if isinstance(A, ELLMatrix):
        return ell_tmatvec(A, y)
    if isinstance(A, RowSharded):
        return A.tmatvec(y)
    return torch.bmm(y.unsqueeze(-2), A).squeeze(-2)


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
