"""K1 and K1r: one masked ADMM iteration of the ``dense_inv`` backend,
in its plain and its refined loop body.

:func:`admm_iter` (K1) is the plain body's wrapper: for CUDA tensors it
launches the hand-written kernel in ``csrc/admm_iter.cu``, which fuses
the explicit-inverse KKT solve (``osqp_tpu/linsys/dense_inv.py:solve``),
the relaxed x/z/y updates (``osqp_tpu/admm.py:admm_step``) and the
active-mask selects of the loop body into one pass over Minv, AMinvT
and A; for CPU tensors it runs :func:`admm_iter_plain`, the same
function in plain PyTorch.

:func:`admm_iter_refined` (K1r) is the refined body's wrapper, for
ill-conditioned batches: the KKT solve with residual correction
(``dense_inv.py:solve(refine=True)``), z~ = A x~, and in float32 the
TwoSum dual carry (``admm.py:152-160``).  CUDA tensors launch
``csrc/admm_iter_refined.cu``; CPU tensors run
:func:`admm_iter_refined_plain`.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from .. import _build
from ..linalg import bwhere, mat_tvec, mat_vec
from ..types import Iterates

launches = 0
refined_launches = 0


def _validate(name, mats, q, l, u, rho, rho_inv, active, x, z, y, dx, dy, y_lo=None) -> None:
    """Device, dtype and shape checks of both bodies; ``mats`` maps each
    matrix operand's name to (tensor, shape as a function of B, n, m)."""
    dtype = x.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name} takes float32 or float64, not {dtype}")
    if x.ndim != 2 or z.ndim != 2:
        raise ValueError(f"{name} takes x (B, n) and z (B, m)")
    (B, n), m = x.shape, z.shape[1]
    shapes = {
        **{k: (t, shape(B, n, m)) for k, (t, shape) in mats.items()},
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
    if y_lo is not None:
        shapes["y_lo"] = (y_lo, (B, m))
    for arg, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, expected {shape}")
        if t.device != x.device:
            raise ValueError(f"{name}: {arg} is on {t.device}, x on {x.device}")
        if arg != "active" and t.dtype != dtype:
            raise TypeError(f"{name}: {arg} is {t.dtype}, x is {dtype}")
    if active.dtype != torch.bool:
        raise TypeError(f"{name}: active must be bool, not {active.dtype}")


def admm_iter(Minv, AMinvT, A, q, l, u, rho, rho_inv, sigma, alpha, active, x, z, y, dx, dy):
    """One ADMM iteration where ``active``; returns new (x, z, y, dx, dy),
    equal to the inputs bit for bit where ``active`` is false.

    Shapes: Minv (B,n,n), AMinvT (B,n,m) = Minv A', A (B,m,n); q, x, dx
    (B,n); l, u, rho, rho_inv, z, y, dy (B,m); active (B,) bool; sigma
    and alpha scalars (floats or 0-d host tensors).
    """
    global launches
    args = (Minv, AMinvT, A, q, l, u, rho, rho_inv, active, x, z, y, dx, dy)
    mats = {
        "Minv": (Minv, lambda B, n, m: (B, n, n)),
        "AMinvT": (AMinvT, lambda B, n, m: (B, n, m)),
        "A": (A, lambda B, n, m: (B, m, n)),
    }
    _validate("admm_iter", mats, *args[3:])
    if x.device.type == "cpu":
        return admm_iter_plain(Minv, AMinvT, A, q, l, u, rho, rho_inv, sigma, alpha, active, x, z, y, dx, dy)
    if x.device.type != "cuda":
        raise ValueError(f"admm_iter runs on CPU or CUDA tensors, not {x.device}")
    if not all(t.is_contiguous() for t in args):
        raise ValueError("admm_iter takes contiguous tensors")
    (B, n), m = x.shape, z.shape[1]
    _build.check_smem("admm_iter", x.dtype, n, m)
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


def admm_iter_refined(Minv, A, P, q, l, u, rho, rho_inv, sigma, alpha, active, x, z, y, dx, dy, y_lo=None):
    """One refined ADMM iteration where ``active``; returns new
    (x, z, y, dx, dy, y_lo), equal to the inputs bit for bit where
    ``active`` is false.  ``y_lo`` (B, m) is the TwoSum carry of the
    dual update (float32; None turns it off and returns None).

    Shapes: Minv, P (B,n,n), A (B,m,n); q, x, dx (B,n); l, u, rho,
    rho_inv, z, y, dy (B,m); active (B,) bool; sigma and alpha scalars.
    """
    global refined_launches
    args = (Minv, A, P, q, l, u, rho, rho_inv, active, x, z, y, dx, dy)
    mats = {
        "Minv": (Minv, lambda B, n, m: (B, n, n)),
        "A": (A, lambda B, n, m: (B, m, n)),
        "P": (P, lambda B, n, m: (B, n, n)),
    }
    _validate("admm_iter_refined", mats, *args[3:], y_lo=y_lo)
    if x.device.type == "cpu":
        return admm_iter_refined_plain(Minv, A, P, q, l, u, rho, rho_inv, sigma, alpha, active, x, z, y, dx, dy, y_lo)
    if x.device.type != "cuda":
        raise ValueError(f"admm_iter_refined runs on CPU or CUDA tensors, not {x.device}")
    ins = args + ((y_lo,) if y_lo is not None else ())
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("admm_iter_refined takes contiguous tensors")
    (B, n), m = x.shape, z.shape[1]
    _build.check_smem("admm_iter_refined", x.dtype, n, m)
    outs = tuple(torch.empty_like(t) for t in (x, z, y, dx, dy))
    lo_out = torch.empty_like(y_lo) if y_lo is not None else None
    ptr = lambda t: t.data_ptr() if t is not None else 0
    lib = _build.library()
    with torch.cuda.device(x.device):
        code = lib.osqp_admm_iter_refined(
            _build.dtype_code(x.dtype),
            *(t.data_ptr() for t in args),
            ptr(y_lo),
            *(t.data_ptr() for t in outs),
            ptr(lo_out),
            float(sigma),
            float(alpha),
            B,
            n,
            m,
            _build.stream(),
        )
    _build.check(code, "admm_iter_refined")
    refined_launches += 1
    return outs + (lo_out,)


def _refined_kkt_solve(factor, A, rho_vec, rhs_x, rhs_z):
    """KKT solve with residual correction (osqp_tpu/linsys/dense_inv.py:173-231).

    In float32, two correction steps whose residual t - M x is
    accumulated in float64; M x is applied matrix-free as
    P x + sigma x + A'(rho (A x)).  In float64, one correction step.
    Returns (x~, z~ = A x~).
    """
    t = rhs_x + mat_tvec(A, rho_vec * rhs_z)
    Minv, P, sigma = factor["Minv"], factor["P"], factor["sigma"]
    apply_inv = lambda v: torch.bmm(v.unsqueeze(1), Minv).squeeze(1)
    x = apply_inv(t)
    if t.dtype == torch.float32:
        P64, A64, rho64, t64 = P.double(), A.double(), rho_vec.double(), t.double()
        sig64 = sigma.double()
        for _ in range(2):
            x64 = x.double()
            Mx = mat_vec(P64, x64) + sig64 * x64
            Mx = Mx + mat_tvec(A64, rho64 * mat_vec(A64, x64))
            x = x + apply_inv((t64 - Mx).to(t.dtype))
    else:
        Mx = mat_vec(P, x) + sigma * x
        Mx = Mx + mat_tvec(A, rho_vec * mat_vec(A, x))
        x = x + apply_inv(t - Mx)
    return x, mat_vec(A, x)


def admm_iter_refined_plain(Minv, A, P, q, l, u, rho, rho_inv, sigma, alpha, active, x, z, y, dx, dy, y_lo=None):
    """Plain PyTorch version of :func:`admm_iter_refined`:
    ``admm.admm_step`` on the residual-corrected solve, then the
    active-mask selects."""
    from ..admm import admm_step  # admm imports the backends, which import this module

    data = SimpleNamespace(q=q, A=A, l=l, u=u)
    as_t = lambda v: torch.as_tensor(v, dtype=x.dtype)
    dyn = SimpleNamespace(sigma=as_t(sigma), alpha=as_t(alpha))
    rs = SimpleNamespace(rho_vec=rho, rho_inv_vec=rho_inv)
    factor = {"Minv": Minv, "P": P, "sigma": as_t(sigma)}
    it, dx_new, dy_new, lo_new = admm_step(_refined_kkt_solve, factor, data, dyn, rs, Iterates(x=x, z=z, y=y), y_lo)
    return (
        bwhere(active, it.x, x),
        bwhere(active, it.z, z),
        bwhere(active, it.y, y),
        bwhere(active, dx_new, dx),
        bwhere(active, dy_new, dy),
        None if y_lo is None else bwhere(active, lo_new, y_lo),
    )


def twosum_violations(y, dy, y_lo, y_new, y_lo_new) -> int:
    """Entries at which (y_new, y_lo_new) is not TwoSum(y, dy + y_lo),
    the float32 dual update with its carry, where dy is the step's own dy.

    TwoSum is exact: y_new + y_lo_new equals y + b, b = dy + y_lo rounded
    in float32, as real numbers.  Both sides are summed in float64, where
    equal exact sums round to equal values, so the test is equality.  And
    |y_lo_new| is at most half the spacing of float32 values at y_new.
    A carry that is dropped, or passed through unchanged, fails both.
    """
    b = dy + y_lo
    exact = y_new.double() + y_lo_new.double() == y.double() + b.double()
    mag = y_new.abs()
    spacing = torch.nextafter(mag, torch.full_like(mag, float("inf"))) - mag
    bounded = y_lo_new.double().abs() <= spacing.double() / 2
    return int((~(exact & bounded)).sum())
