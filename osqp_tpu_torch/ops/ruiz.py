"""K4: modified Ruiz equilibration, dense (counterpart of
``osqp_tpu/scaling.py:51-130``; reference src/scaling.c:44-156).

:func:`ruiz` is the kernel's wrapper: for CUDA tensors it launches the
hand-written kernels in ``csrc/ruiz.cu``, which take each sweep's
column and row maxima of the scaled KKT matrix straight from P and A
(no scaled temporaries) and write c·DPD, EAD, c·Dq, El and Eu in one
final pass; for CPU tensors it runs :func:`ruiz_plain`, the same
function in plain PyTorch.

The maxima do not depend on their order, and the cost normalisation's
mean is taken as the same pairwise sum (:func:`tree_sum`) in both
versions, so c, D and E come out equal bit for bit on one device.
"""

from __future__ import annotations

import torch

from .. import _build
from ..constants import MAX_SCALING, MIN_SCALING

# Shared-memory bound of the kernel's pairwise sum: one value per
# column, padded to a power of two.
_MAX_N = 16384

launches = 0


def limit_scaling(v: torch.Tensor) -> torch.Tensor:
    """scaling.c:7-14: values below MIN_SCALING -> 1, above MAX_SCALING -> MAX."""
    v = torch.where(v < MIN_SCALING, torch.ones_like(v), v)
    return torch.clamp(v, max=MAX_SCALING)


def tree_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis as a fixed pairwise tree: zero-padded to a
    power of two, then the upper half added onto the lower half until
    one value is left.  The kernel sums in this order too."""
    n = v.shape[-1]
    width = 1 << max(n - 1, 0).bit_length()
    if width > n:
        v = torch.nn.functional.pad(v, (0, width - n))
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = v[..., :h] + v[..., h:]
    return v[..., 0]


def _validate(P, q, A, l, u) -> None:
    dtype = q.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"ruiz takes float32 or float64, not {dtype}")
    if q.ndim != 2 or l.ndim != 2:
        raise ValueError("ruiz takes q (B, n) and l (B, m)")
    (B, n), m = q.shape, l.shape[1]
    shapes = {"P": (P, (B, n, n)), "A": (A, (B, m, n)), "l": (l, (B, m)), "u": (u, (B, m))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"ruiz: {name} has shape {tuple(t.shape)}, expected {shape}")
        if t.device != q.device:
            raise ValueError(f"ruiz: {name} is on {t.device}, q on {q.device}")
        if t.dtype != dtype:
            raise TypeError(f"ruiz: {name} is {t.dtype}, q is {dtype}")
    if not 1 <= n <= _MAX_N:
        raise ValueError(f"ruiz takes 1 <= n <= {_MAX_N}, got n = {n}")


def ruiz(P, q, A, l, u, n_iters: int):
    """``n_iters`` Ruiz sweeps and the final scaling.  Returns
    (c (B,), D (B, n), E (B, m), c·DPD, c·Dq, EAD, El, Eu)."""
    global launches
    _validate(P, q, A, l, u)
    if q.device.type == "cpu":
        return ruiz_plain(P, q, A, l, u, n_iters)
    if q.device.type != "cuda":
        raise ValueError(f"ruiz runs on CPU or CUDA tensors, not {q.device}")
    if not all(t.is_contiguous() for t in (P, q, A, l, u)):
        raise ValueError("ruiz takes contiguous tensors")
    B, n = q.shape
    m = l.shape[1]
    dtype, dev = q.dtype, q.device
    c = torch.ones(B, dtype=dtype, device=dev)
    D = torch.ones((B, n), dtype=dtype, device=dev)
    E = torch.ones((B, m), dtype=dtype, device=dev)
    outs = tuple(torch.empty_like(t) for t in (P, q, A, l, u))
    # Scratch: the maxima as bit patterns (zero = +0.0) and P's column norm.
    col_a, col_p, p_col = (torch.zeros((B, n), dtype=dtype, device=dev) for _ in range(3))
    row_a = torch.zeros((B, m), dtype=dtype, device=dev)
    _, rows_a, rows_p = _build.split_geometry(B, n, m, dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.osqp_ruiz(
            _build.dtype_code(dtype),
            *(t.data_ptr() for t in (P, q, A, l, u)),
            *(t.data_ptr() for t in (c, D, E)),
            *(t.data_ptr() for t in outs),
            *(t.data_ptr() for t in (col_a, row_a, col_p, p_col)),
            int(n_iters), B, n, m, rows_a, rows_p, _build.stream(),
        )
    _build.check(code, "ruiz")
    launches += 1
    Ps, qs, As, ls, us = outs
    return c, D, E, Ps, qs, As, ls, us


def ruiz_plain(P, q, A, l, u, n_iters: int):
    """Plain PyTorch version of :func:`ruiz`.  The sweeps only read P and
    A: the accumulated (c, D, E) are folded into the norms, and the
    cost-normalisation norm of one sweep is the P norm of the next."""
    B, n = q.shape
    m = l.shape[-1]
    dtype, dev = q.dtype, q.device
    absP = P.abs()
    absA = A.abs()
    ones = lambda *s: torch.ones(s, dtype=dtype, device=dev)

    def p_colmax(D):
        """colmax_j(D_i |P_ij|) * D_j, the c-free column norm of DPD."""
        return (absP * D[:, :, None]).amax(-2) * D

    c, D, E = ones(B), ones(B, n), ones(B, m)
    Pcol = p_colmax(D)
    for _ in range(n_iters):
        Pn = Pcol * c[:, None]
        if m:
            An_col = (absA * E[:, :, None]).amax(-2) * D
            e_norm = (absA * D[:, None, :]).amax(-1) * E
            d_norm = torch.maximum(Pn, An_col)
        else:
            e_norm = torch.zeros((B, m), dtype=dtype, device=dev)
            d_norm = Pn
        D = D * (1.0 / torch.sqrt(limit_scaling(d_norm)))
        E = E * (1.0 / torch.sqrt(limit_scaling(e_norm)))

        # Cost normalisation (scaling.c:110-141) on the scaled P, q.
        Pcol = p_colmax(D)
        # Divided by a tensor: PyTorch multiplies by the reciprocal of a
        # Python-number divisor on the card, which may round differently.
        c_temp = tree_sum(Pcol * c[:, None]) / torch.full_like(c, n)
        inf_norm_q = limit_scaling((q.abs() * D).amax(-1) * c)
        c_temp = limit_scaling(torch.maximum(c_temp, inf_norm_q))
        c = c / c_temp

    return (
        c,
        D,
        E,
        c[:, None, None] * (D[:, :, None] * P * D[:, None, :]),
        c[:, None] * (D * q),
        E[:, :, None] * A * D[:, None, :],
        E * l,
        E * u,
    )
