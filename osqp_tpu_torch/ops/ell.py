"""K5: the row-gather products of ELL operands (counterpart of
``osqp_tpu/sparse_ops.py:120-177``).

Each public function is the kernel's wrapper: for CUDA operands it
launches ``csrc/ell_ops.cu`` (one templated row-gather kernel for the
reductions, one elementwise kernel for :func:`ell_scale`); for CPU
operands it runs its ``_plain`` twin, the same function in plain
PyTorch: a gather, then the sum over the slot axis taken in slot order,
as the kernel takes it, so that the two agree bit for bit (the JAX
package writes the same gather and reduction).  The kernel takes
contiguous values and raises on anything else: values broadcast over the
batch are made contiguous once at set-up (:meth:`ELLMatrix.contiguous`),
never here.

Operands with no rows or no columns take the short cuts of the JAX
package: an empty product is zeros, and nothing is launched.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import _build
from ..sparse_ops import ELLMatrix

launches = 0

_SUM, _WSUM, _SQ, _MAX, _DIAG = range(5)


def _take(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """v[:, idx], (B, R, k); an empty ``v`` gathers zeros (every slot is
    padding then)."""
    if v.shape[-1] == 0:
        return v.new_zeros((v.shape[0],) + tuple(idx.shape))
    return v[:, idx]


def _check_operand(val, idx, name):
    if val.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: ELL values must be float32 or float64, not {val.dtype}")
    if val.ndim != 3 or idx.ndim != 2 or tuple(val.shape[1:]) != tuple(idx.shape):
        raise ValueError(f"{name}: values {tuple(val.shape)} do not fit the pattern {tuple(idx.shape)}")
    if idx.dtype != torch.int32:
        raise TypeError(f"{name}: the ELL pattern must be int32, not {idx.dtype}")
    if idx.device != val.device:
        raise ValueError(f"{name}: pattern on {idx.device}, values on {val.device}")


def _check_vector(v, B, G, ref, name):
    if v.dtype != ref.dtype or v.device != ref.device or tuple(v.shape) != (B, G):
        raise ValueError(
            f"{name}: vector {tuple(v.shape)} {v.dtype} on {v.device}, expected ({B}, {G}) {ref.dtype} on {ref.device}"
        )


def _zeros(A: ELLMatrix, L: int) -> torch.Tensor:
    """The (B, L) zeros of an empty product, launching nothing."""
    return torch.zeros((A.batch, L), dtype=A.dtype, device=A.device)


def _on_cuda(val, name) -> bool:
    if val.device.type == "cpu":
        return False
    if val.device.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA tensors, not {val.device}")
    return True


def _reduce(mode, val, idx, g, w, name):
    """One launch of the reduction kernel over contiguous operands."""
    global launches
    B, R, k = val.shape
    G = g.shape[1] if g is not None else 0
    for t in (val, idx, g, w):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors (make the operand so with ELLMatrix.contiguous)")
    out = torch.empty((B, R), dtype=val.dtype, device=val.device)
    lib = _build.library()
    with torch.cuda.device(val.device):
        code = lib.osqp_ell_reduce(
            _build.dtype_code(val.dtype), mode, val.data_ptr(), idx.data_ptr(),
            g.data_ptr() if g is not None else 0, w.data_ptr() if w is not None else 0,
            out.data_ptr(), B, R, k, G, _build.stream(),
        )
    _build.check(code, name)
    launches += 1
    return out


def _gathered(A_val, A_idx, g, G, name):
    """Validate an operand and the vector it gathers from (B, G)."""
    _check_operand(A_val, A_idx, name)
    _check_vector(g, A_val.shape[0], G, A_val, name)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------
def ell_matvec(A: ELLMatrix, x: torch.Tensor) -> torch.Tensor:
    """A x: (B, n) -> (B, m)."""
    m, n = A.shape
    _gathered(A.val, A.idx, x, n, "ell_matvec")
    if m == 0 or n == 0:
        return _zeros(A, m)
    if not _on_cuda(A.val, "ell_matvec"):
        return ell_matvec_plain(A, x)
    return _reduce(_SUM, A.val, A.idx, x, None, "ell_matvec")


def ell_tmatvec(A: ELLMatrix, y: torch.Tensor, w: torch.Tensor | None = None) -> torch.Tensor:
    """A'y through the stored transpose: (B, m) -> (B, n).  With ``w``
    (B, m), A'(w * y), the product w * y taken per slot and rounded as
    the elementwise product would be."""
    m, n = A.shape
    _gathered(A.t_val, A.t_idx, y, m, "ell_tmatvec")
    if w is not None:
        _check_vector(w, A.batch, m, A.val, "ell_tmatvec")
    if m == 0 or n == 0:
        return _zeros(A, n)
    if not _on_cuda(A.val, "ell_tmatvec"):
        return ell_tmatvec_plain(A, y, w)
    return _reduce(_SUM if w is None else _WSUM, A.t_val, A.t_idx, y, w, "ell_tmatvec")


def ell_diagonal(P: ELLMatrix) -> torch.Tensor:
    """(B, n) diagonal of a square ELL matrix."""
    _check_operand(P.val, P.idx, "ell_diagonal")
    if P.shape[0] == 0:
        return _zeros(P, 0)
    if not _on_cuda(P.val, "ell_diagonal"):
        return ell_diagonal_plain(P)
    return _reduce(_DIAG, P.val, P.idx, None, None, "ell_diagonal")


def ell_sq_colsums(A: ELLMatrix, w: torch.Tensor) -> torch.Tensor:
    """(B, n) column sums  sum_i w_i A_ij^2  (the Jacobi preconditioner's
    term) through the transpose copy."""
    m, n = A.shape
    _gathered(A.t_val, A.t_idx, w, m, "ell_sq_colsums")
    if m == 0 or n == 0:
        return _zeros(A, n)
    if not _on_cuda(A.val, "ell_sq_colsums"):
        return ell_sq_colsums_plain(A, w)
    return _reduce(_SQ, A.t_val, A.t_idx, w, None, "ell_sq_colsums")


def ell_row_norms(A: ELLMatrix, col_w: torch.Tensor) -> torch.Tensor:
    """(B, m) row inf-norms under a column weight: max_j |A_ij| col_w_j."""
    m, n = A.shape
    _gathered(A.val, A.idx, col_w, n, "ell_row_norms")
    if m == 0 or n == 0:
        return _zeros(A, m)
    if not _on_cuda(A.val, "ell_row_norms"):
        return ell_row_norms_plain(A, col_w)
    return _reduce(_MAX, A.val, A.idx, col_w, None, "ell_row_norms")


def ell_col_norms(A: ELLMatrix, row_w: torch.Tensor) -> torch.Tensor:
    """(B, n) column inf-norms under a row weight: max_i row_w_i |A_ij|
    (through the transpose)."""
    m, n = A.shape
    _gathered(A.t_val, A.t_idx, row_w, m, "ell_col_norms")
    if m == 0 or n == 0:
        return _zeros(A, n)
    if not _on_cuda(A.val, "ell_col_norms"):
        return ell_col_norms_plain(A, row_w)
    return _reduce(_MAX, A.t_val, A.t_idx, row_w, None, "ell_col_norms")


def ell_scale(A: ELLMatrix, row_s: torch.Tensor, col_s: torch.Tensor, c: torch.Tensor | None = None) -> ELLMatrix:
    """diag(row_s) A diag(col_s), times c (B,) where given, on both
    copies of the values."""
    global launches
    m, n = A.shape
    B = A.batch
    _check_operand(A.val, A.idx, "ell_scale")
    _check_operand(A.t_val, A.t_idx, "ell_scale")
    _check_vector(row_s, B, m, A.val, "ell_scale")
    _check_vector(col_s, B, n, A.val, "ell_scale")
    if c is not None:
        _check_vector(c[:, None], B, 1, A.val, "ell_scale")
    if m == 0 or n == 0:
        # every slot is padding: the scaled values are the zeros they were
        return dataclasses.replace(A, val=torch.zeros_like(A.val), t_val=torch.zeros_like(A.t_val))
    if not _on_cuda(A.val, "ell_scale"):
        return ell_scale_plain(A, row_s, col_s, c)
    ins = (A.val, A.idx, A.t_val, A.t_idx, row_s, col_s) + ((c,) if c is not None else ())
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("ell_scale takes contiguous tensors (make the operand so with ELLMatrix.contiguous)")
    val = torch.empty_like(A.val)
    t_val = torch.empty_like(A.t_val)
    lib = _build.library()
    with torch.cuda.device(A.device):
        code = lib.osqp_ell_scale(
            _build.dtype_code(A.dtype), A.val.data_ptr(), A.idx.data_ptr(), A.t_val.data_ptr(), A.t_idx.data_ptr(),
            row_s.data_ptr(), col_s.data_ptr(), c.data_ptr() if c is not None else 0, val.data_ptr(),
            t_val.data_ptr(), B, m, A.val.shape[2], n, A.t_val.shape[2], _build.stream(),
        )
    _build.check(code, "ell_scale")
    launches += 1
    return dataclasses.replace(A, val=val, t_val=t_val)


# ---------------------------------------------------------------------------
# Plain versions (an operand with no rows or columns gathers zeros: _take)
# ---------------------------------------------------------------------------
def _slot_sum(v: torch.Tensor) -> torch.Tensor:
    """(B, R, k) -> (B, R): the sum over the slots in slot order, from 0,
    as the kernel's thread adds them, so that the two agree bit for bit."""
    acc = torch.zeros(v.shape[:-1], dtype=v.dtype, device=v.device)
    for s in range(v.shape[-1]):
        acc = acc + v[..., s]
    return acc


def ell_matvec_plain(A: ELLMatrix, x: torch.Tensor) -> torch.Tensor:
    return _slot_sum(A.val * _take(x, A.idx))


def ell_tmatvec_plain(A: ELLMatrix, y: torch.Tensor, w: torch.Tensor | None = None) -> torch.Tensor:
    g = y if w is None else w * y
    return _slot_sum(A.t_val * _take(g, A.t_idx))


def ell_diagonal_plain(P: ELLMatrix) -> torch.Tensor:
    rows = torch.arange(P.shape[0], dtype=P.idx.dtype, device=P.idx.device)[:, None]
    return (P.val * (P.idx == rows).to(P.dtype)).sum(-1)


def ell_sq_colsums_plain(A: ELLMatrix, w: torch.Tensor) -> torch.Tensor:
    return _slot_sum(A.t_val * A.t_val * _take(w, A.t_idx))


def ell_row_norms_plain(A: ELLMatrix, col_w: torch.Tensor) -> torch.Tensor:
    return (A.val.abs() * _take(col_w, A.idx)).amax(-1)


def ell_col_norms_plain(A: ELLMatrix, row_w: torch.Tensor) -> torch.Tensor:
    return (A.t_val.abs() * _take(row_w, A.t_idx)).amax(-1)


def ell_scale_plain(A: ELLMatrix, row_s, col_s, c=None) -> ELLMatrix:
    val = A.val * row_s[..., None] * _take(col_s, A.idx)
    t_val = A.t_val * col_s[..., None] * _take(row_s, A.t_idx)
    if c is not None:
        val = val * c[:, None, None]
        t_val = t_val * c[:, None, None]
    return dataclasses.replace(A, val=val, t_val=t_val)
