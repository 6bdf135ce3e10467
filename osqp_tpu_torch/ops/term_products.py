"""K3: the matrix products of the termination checks, certificates and
rho estimate (counterpart of ``osqp_tpu/termination.py:47-51,94-184,
309-329`` and ``osqp_tpu/admm.py:479-487``).

:func:`term_products` is the kernel's wrapper: for CUDA tensors it
launches the hand-written kernels in ``csrc/term_products.cu``, which
read A and P once per call for all the products asked for; for CPU
tensors it runs :func:`term_products_plain`, the same products in plain
PyTorch.  The tolerances, certificates and status decisions stay plain
PyTorch on the returned vectors (:mod:`osqp_tpu_torch.termination`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import _build
from ..linalg import mat_tvec, mat_vec

launches = 0


class TermProducts(NamedTuple):
    Ax: torch.Tensor  # (B, m)
    Px: torch.Tensor  # (B, n)
    Aty: torch.Tensor  # (B, n)
    Atdy: torch.Tensor | None  # (B, n), with the certificate products
    Pdx: torch.Tensor | None  # (B, n)
    Adx: torch.Tensor | None  # (B, m)


def _validate(P, A, x, y, dx, dy) -> None:
    dtype = x.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"term_products takes float32 or float64, not {dtype}")
    if x.ndim != 2 or y.ndim != 2:
        raise ValueError("term_products takes x (B, n) and y (B, m)")
    if (dx is None) != (dy is None):
        raise ValueError("term_products takes both certificate directions dx and dy, or neither")
    (B, n), m = x.shape, y.shape[1]
    shapes = {"P": (P, (B, n, n)), "A": (A, (B, m, n)), "dx": (dx, (B, n)), "dy": (dy, (B, m))}
    for name, (t, shape) in shapes.items():
        if t is None:
            continue
        if tuple(t.shape) != shape:
            raise ValueError(f"term_products: {name} has shape {tuple(t.shape)}, expected {shape}")
        if t.device != x.device:
            raise ValueError(f"term_products: {name} is on {t.device}, x on {x.device}")
        if t.dtype != dtype:
            raise TypeError(f"term_products: {name} is {t.dtype}, x is {dtype}")
    if y.device != x.device or y.dtype != dtype:
        raise TypeError(f"term_products: y is {y.dtype} on {y.device}, x is {dtype} on {x.device}")


def term_products(P, A, x, y, dx=None, dy=None) -> TermProducts:
    """A x, P x and A'y; with the certificate directions dx (B, n) and
    dy (B, m) also A'dy, P dx and A dx (else those are None)."""
    global launches
    _validate(P, A, x, y, dx, dy)
    if x.device.type == "cpu":
        return term_products_plain(P, A, x, y, dx, dy)
    if x.device.type != "cuda":
        raise ValueError(f"term_products runs on CPU or CUDA tensors, not {x.device}")
    cert = dx is not None
    ins = (P, A, x, y) + ((dx, dy) if cert else ())
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("term_products takes contiguous tensors")
    B, n = x.shape
    m = y.shape[1]
    dtype, dev = x.dtype, x.device
    k = 2 if cert else 1
    chunks, rows_a, rows_p = _build.split_geometry(B, n, m, dev)
    tiles_a = max(-(-m // rows_a), 1)
    # Outputs: [Ax, Adx] (k, B, m), [Px, Pdx] and [Aty, Atdy] (k, B, n);
    # scratch: the partial sums of each column chunk and row tile.
    row_out = torch.empty((k, B, m), dtype=dtype, device=dev)
    p_out = torch.empty((k, B, n), dtype=dtype, device=dev)
    col_out = torch.empty((k, B, n), dtype=dtype, device=dev)
    row_ws = torch.empty((k, B, chunks, max(m, n)) if chunks > 1 else (0,), dtype=dtype, device=dev)
    col_ws = torch.empty((k, B, tiles_a, n) if tiles_a > 1 else (0,), dtype=dtype, device=dev)
    null = 0
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.osqp_term_products(
            _build.dtype_code(dtype),
            P.data_ptr(), A.data_ptr(), x.data_ptr(), y.data_ptr(),
            dx.data_ptr() if cert else null, dy.data_ptr() if cert else null,
            row_out.data_ptr(), p_out.data_ptr(), col_out.data_ptr(),
            row_ws.data_ptr() if row_ws.numel() else null,
            col_ws.data_ptr() if col_ws.numel() else null,
            B, n, m, rows_a, rows_p, _build.stream(),
        )
    _build.check(code, "term_products")
    launches += 1
    if cert:
        return TermProducts(row_out[0], p_out[0], col_out[0], col_out[1], p_out[1], row_out[1])
    return TermProducts(row_out[0], p_out[0], col_out[0], None, None, None)


def term_products_plain(P, A, x, y, dx=None, dy=None) -> TermProducts:
    """Plain PyTorch version of :func:`term_products`."""
    if dx is None:
        return TermProducts(mat_vec(A, x), mat_vec(P, x), mat_tvec(A, y), None, None, None)
    return TermProducts(
        mat_vec(A, x), mat_vec(P, x), mat_tvec(A, y), mat_tvec(A, dy), mat_vec(P, dx), mat_vec(A, dx)
    )
