"""K1: one masked ADMM iteration of the ``dense_inv`` backend, plain body.

:func:`admm_iter` is the kernel's wrapper: for CUDA tensors it launches
the hand-written kernel in ``csrc/admm_iter.cu``, which fuses the
explicit-inverse KKT solve (``osqp_tpu/linsys/dense_inv.py:solve``),
the relaxed x/z/y updates (``osqp_tpu/admm.py:admm_step``) and the
active-mask selects of the loop body into one pass over Minv, AMinvT
and A; for CPU tensors it runs :func:`admm_iter_plain`, the same
function in plain PyTorch.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from .. import _build
from ..linalg import bwhere, mat_tvec
from ..types import Iterates

# Warps of the kernel's block (kWarps in csrc/admm_iter.cu).
_WARPS = 8

launches = 0


def _validate(Minv, AMinvT, A, q, l, u, rho, rho_inv, active, x, z, y, dx, dy) -> None:
    dtype = x.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"admm_iter takes float32 or float64, not {dtype}")
    if x.ndim != 2 or z.ndim != 2:
        raise ValueError("admm_iter takes x (B, n) and z (B, m)")
    (B, n), m = x.shape, z.shape[1]
    shapes = {
        "Minv": (Minv, (B, n, n)),
        "AMinvT": (AMinvT, (B, n, m)),
        "A": (A, (B, m, n)),
        "q": (q, (B, n)),
        "dx": (dx, (B, n)),
        "l": (l, (B, m)),
        "u": (u, (B, m)),
        "rho": (rho, (B, m)),
        "rho_inv": (rho_inv, (B, m)),
        "y": (y, (B, m)),
        "dy": (dy, (B, m)),
        "active": (active, (B,)),
    }
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"admm_iter: {name} has shape {tuple(t.shape)}, expected {shape}")
        if t.device != x.device:
            raise ValueError(f"admm_iter: {name} is on {t.device}, x on {x.device}")
        if name != "active" and t.dtype != dtype:
            raise TypeError(f"admm_iter: {name} is {t.dtype}, x is {dtype}")
    if active.dtype != torch.bool:
        raise TypeError(f"admm_iter: active must be bool, not {active.dtype}")
    smem = (2 * n + 2 * m + _WARPS * max(n, m)) * x.element_size()
    if smem > _build.SMEM_BYTES:
        raise ValueError(f"admm_iter: n={n}, m={m} needs {smem} bytes of shared memory, above {_build.SMEM_BYTES}")


def admm_iter(Minv, AMinvT, A, q, l, u, rho, rho_inv, sigma, alpha, active, x, z, y, dx, dy):
    """One ADMM iteration where ``active``; returns new (x, z, y, dx, dy),
    equal to the inputs bit for bit where ``active`` is false.

    Shapes: Minv (B,n,n), AMinvT (B,n,m) = Minv A', A (B,m,n); q, x, dx
    (B,n); l, u, rho, rho_inv, z, y, dy (B,m); active (B,) bool; sigma
    and alpha scalars (floats or 0-d host tensors).
    """
    global launches
    args = (Minv, AMinvT, A, q, l, u, rho, rho_inv, active, x, z, y, dx, dy)
    _validate(*args)
    if x.device.type == "cpu":
        return admm_iter_plain(Minv, AMinvT, A, q, l, u, rho, rho_inv, sigma, alpha, active, x, z, y, dx, dy)
    if x.device.type != "cuda":
        raise ValueError(f"admm_iter runs on CPU or CUDA tensors, not {x.device}")
    if not all(t.is_contiguous() for t in args):
        raise ValueError("admm_iter takes contiguous tensors")
    B, n = x.shape
    m = z.shape[1]
    outs = tuple(torch.empty_like(t) for t in (x, z, y, dx, dy))
    lib = _build.library()
    with torch.cuda.device(x.device):
        code = lib.osqp_admm_iter(
            _build.dtype_code(x.dtype),
            *(t.data_ptr() for t in args),
            *(t.data_ptr() for t in outs),
            float(sigma),
            float(alpha),
            B,
            n,
            m,
            _build.stream(),
        )
    _build.check(code, "admm_iter")
    launches += 1
    return outs


def _kkt_solve(factor, A, rho_vec, rhs_x, rhs_z):
    """Explicit-inverse KKT solve (osqp_tpu/linsys/dense_inv.py:164-171):
    x~ = Minv t and z~ = (A Minv) t with t = rhs_x + A'(rho rhs_z)."""
    t = (rhs_x + mat_tvec(A, rho_vec * rhs_z)).unsqueeze(1)
    return torch.bmm(t, factor["Minv"]).squeeze(1), torch.bmm(t, factor["AMinvT"]).squeeze(1)


def admm_iter_plain(Minv, AMinvT, A, q, l, u, rho, rho_inv, sigma, alpha, active, x, z, y, dx, dy):
    """Plain PyTorch version of :func:`admm_iter`: ``admm.admm_step`` on
    the explicit-inverse solve, then the active-mask selects."""
    from ..admm import admm_step  # admm imports the backends, which import this module

    data = SimpleNamespace(q=q, A=A, l=l, u=u)
    dyn = SimpleNamespace(sigma=torch.as_tensor(sigma, dtype=x.dtype), alpha=torch.as_tensor(alpha, dtype=x.dtype))
    rs = SimpleNamespace(rho_vec=rho, rho_inv_vec=rho_inv)
    factor = {"Minv": Minv, "AMinvT": AMinvT}
    it, dx_new, dy_new, _ = admm_step(_kkt_solve, factor, data, dyn, rs, Iterates(x=x, z=z, y=y))
    return (
        bwhere(active, it.x, x),
        bwhere(active, it.z, z),
        bwhere(active, it.y, y),
        bwhere(active, dx_new, dx),
        bwhere(active, dy_new, dy),
    )
