"""K3: the matrix products of the termination checks, certificates and
rho estimate (counterpart of ``osqp_tpu/termination.py:47-51,94-184,
309-329`` and ``osqp_tpu/admm.py:479-487``).

:func:`term_products` is the kernel's wrapper: for CUDA tensors it
launches the hand-written kernel in ``csrc/term_products.cu``, one
launch per call, which reads A and P once for all the products asked
for; for CPU tensors it runs :func:`term_products_plain`, the same
products in plain PyTorch.  The tolerances, certificates and status
decisions stay plain PyTorch on the returned vectors
(:mod:`osqp_tpu_torch.termination`).

The outputs are allocated fresh on every call (callers keep them across
checks); the kernel's partial sums and its tickets live in a scratch
buffer cached per device, stream, dtype and shape, which every call
leaves zeroed for the next.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import _build
from ..linalg import mat_tvec, mat_vec

launches = 0
_PLAN_ENTRIES = 16  # shapes whose geometry and scratch stay cached
_plans: dict = {}


class TermProducts(NamedTuple):
    Ax: torch.Tensor  # (B, m)
    Px: torch.Tensor  # (B, n)
    Aty: torch.Tensor  # (B, n)
    Atdy: torch.Tensor | None  # (B, n), with the certificate products
    Pdx: torch.Tensor | None  # (B, n)
    Adx: torch.Tensor | None  # (B, m)


def _validate(P, A, x, y, dx, dy) -> None:
    dtype, dev = x.dtype, x.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"term_products takes float32 or float64, not {dtype}")
    if x.ndim != 2 or y.ndim != 2:
        raise ValueError("term_products takes x (B, n) and y (B, m)")
    if (dx is None) != (dy is None):
        raise ValueError("term_products takes both certificate directions dx and dy, or neither")
    (B, n), m = x.shape, y.shape[1]
    for name, t, shape in (("P", P, (B, n, n)), ("A", A, (B, m, n)), ("dx", dx, (B, n)), ("dy", dy, (B, m))):
        if t is None:
            continue
        if t.shape != shape:
            raise ValueError(f"term_products: {name} has shape {tuple(t.shape)}, expected {shape}")
        if t.device != dev:
            raise ValueError(f"term_products: {name} is on {t.device}, x on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"term_products: {name} is {t.dtype}, x is {dtype}")
    if y.device != dev or y.dtype != dtype:
        raise TypeError(f"term_products: y is {y.dtype} on {y.device}, x is {dtype} on {dev}")


def launches_per_call(B: int, n: int, m: int, cert: bool) -> int:
    """Kernel launches of one :func:`term_products` call on the card: one
    at every shape, with or without the certificate products (none for
    an empty batch)."""
    return 1 if B > 0 else 0


def _plan(dev, dtype, B, n, m, k):
    """(dtype code, rows of A and of P a block takes, scratch pointer, the
    scratch, the stream) of a call at these shapes on the current stream.
    The scratch is zeroed at its allocation and left zeroed by every call,
    so one buffer serves the calls in order on one stream."""
    stream = _build.stream()
    key = (dev, stream, dtype, B, n, m, k)
    plan = _plans.get(key)
    if plan is None:
        code = _build.dtype_code(dtype)
        _, rows_a, rows_p = _build.split_geometry(B, n, m, dev)
        nbytes = _build.library().osqp_term_products_scratch(code, B, n, m, rows_a, rows_p, k)
        ws = torch.zeros(nbytes, dtype=torch.uint8, device=dev) if nbytes else None
        if len(_plans) >= _PLAN_ENTRIES:
            _plans.pop(next(iter(_plans)))
        plan = _plans[key] = (code, rows_a, rows_p, ws.data_ptr() if ws is not None else 0, ws, stream)
    return plan


def term_products(P, A, x, y, dx=None, dy=None) -> TermProducts:
    """A x, P x and A'y; with the certificate directions dx (B, n) and
    dy (B, m) also A'dy, P dx and A dx (else those are None)."""
    global launches
    _validate(P, A, x, y, dx, dy)
    dev = x.device
    if dev.type == "cpu":
        return term_products_plain(P, A, x, y, dx, dy)
    if dev.type != "cuda":
        raise ValueError(f"term_products runs on CPU or CUDA tensors, not {dev}")
    cert = dx is not None
    if not (P.is_contiguous() and A.is_contiguous() and x.is_contiguous() and y.is_contiguous()
            and (not cert or (dx.is_contiguous() and dy.is_contiguous()))):
        raise ValueError("term_products takes contiguous tensors")
    B, n = x.shape
    m = y.shape[1]
    if _build.tracing(x):
        return term_products_op(P, A, x, y, dx, dy)
    k = 2 if cert else 1
    lib = _build.library()
    with torch.cuda.device(dev):
        code, rows_a, rows_p, ws, _, stream = _plan(dev, x.dtype, B, n, m, k)
        # Outputs, one allocation: [Ax, Adx] (k, B, m), then [Px, Pdx] and [Aty, Atdy] (k, B, n).
        out = torch.empty(k * B * (m + 2 * n), dtype=x.dtype, device=dev)
        base, elt = out.data_ptr(), out.element_size()
        rc = lib.osqp_term_products(
            code, P.data_ptr(), A.data_ptr(), x.data_ptr(), y.data_ptr(),
            dx.data_ptr() if cert else 0, dy.data_ptr() if cert else 0,
            base, base + elt * k * B * m, base + elt * k * B * (m + n), ws, B, n, m, rows_a, rows_p, stream,
        )
    _build.check(rc, "term_products")
    launches += 1
    view = lambda rows, at: out.as_strided((B, rows), (rows, 1), at)
    Ax, Px, Aty = view(m, 0), view(n, k * B * m), view(n, k * B * (m + n))
    if cert:
        return TermProducts(Ax, Px, Aty, view(n, k * B * (m + n) + B * n), view(n, k * B * m + B * n), view(m, B * m))
    return TermProducts(Ax, Px, Aty, None, None, None)


def term_products_op(P, A, x, y, dx=None, dy=None) -> TermProducts:
    """:func:`term_products` through its operator
    (``torch.ops.osqp_tpu_torch.term_products``), as a traced program
    calls it.  The operator allocates the scratch zeroed at each call, where
    the wrapper keeps one per shape and stream that every launch leaves
    zeroed: the same bits."""
    (B, n), m = x.shape, y.shape[1]
    _, rows_a, rows_p = _build.split_geometry(B, n, m, x.device)
    rows, pcols, cols = _build.ops().term_products(P, A, x, y, dx, dy, rows_a, rows_p)
    if dx is not None:
        return TermProducts(rows[0], pcols[0], cols[0], cols[1], pcols[1], rows[1])
    return TermProducts(rows[0], pcols[0], cols[0], None, None, None)


def term_products_plain(P, A, x, y, dx=None, dy=None) -> TermProducts:
    """Plain PyTorch version of :func:`term_products`."""
    if dx is None:
        return TermProducts(mat_vec(A, x), mat_vec(P, x), mat_tvec(A, y), None, None, None)
    return TermProducts(
        mat_vec(A, x), mat_vec(P, x), mat_tvec(A, y), mat_tvec(A, dy), mat_vec(P, dx), mat_vec(A, dx)
    )
