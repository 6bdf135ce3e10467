"""K1 and K1r: one masked ADMM iteration of the ``dense_inv`` backend,
in its plain and its refined loop body.

:func:`admm_iter` (K1) is the plain body's wrapper: for CUDA tensors it
launches the hand-written kernels in ``csrc/admm_iter.cu``, which fuse
the explicit-inverse KKT solve (``osqp_tpu/linsys/dense_inv.py:solve``),
the relaxed x/z/y updates (``osqp_tpu/admm.py:admm_step``) and the
active-mask selects of the loop body into one pass over Minv, AMinvT
and A, each instance split over blocks; for CPU tensors it runs
:func:`admm_iter_plain`, the same function in plain PyTorch.

:func:`admm_iter_refined` (K1r) is the refined body's wrapper, for
ill-conditioned batches: the KKT solve with residual correction
(``dense_inv.py:solve(refine=True)``), z~ = A x~, and in float32 the
TwoSum dual carry (``admm.py:152-160``).  CUDA tensors launch
``csrc/admm_iter_refined.cu``; CPU tensors run
:func:`admm_iter_refined_plain`.  K1r has two paths on the card, chosen
by :func:`refined_plan` from the shapes: the resident path, one kernel
launch per call in which each instance's slabs of Minv, A and (where
they fit) P stay in the shared memory of a thread-block cluster for the
whole iteration, and the split path, a short sequence of kernels that
spreads one instance over the card (single large problems).

Each launch is one ctypes call; the split paths' partial sums go to a
scratch buffer the wrapper allocates, sized by the library.
``launches`` and ``refined_launches`` count those calls,
``refined_launches_resident`` the K1r calls that took the resident path.
"""

from __future__ import annotations

import functools
from types import SimpleNamespace

import torch

from .. import _build
from ..linalg import bwhere, mat_tvec, mat_vec
from ..types import Iterates

launches = 0
refined_launches = 0
refined_launches_resident = 0

# K1r's resident path (csrc/admm_iter_refined.cu, refined_resident_kernel):
# a lane keeps up to 16 columns (n <= 512), in clusters of up to 16 CTAs
# (above 8 a non-portable cluster size).
RESIDENT_MAX_N = 512
CLUSTERS = (1, 2, 4, 8, 16)


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
    if _build.tracing(x):
        return admm_iter_op(*args[:8], sigma, alpha, *args[8:])
    (B, n), m = x.shape, z.shape[1]
    outs = tuple(torch.empty_like(t) for t in (x, z, y, dx, dy))
    lib = _build.library()
    with torch.cuda.device(x.device):
        ws, sms = _build.scratch("admm_iter", x.dtype, B, n, m, x.device)
        code = lib.osqp_admm_iter(
            _build.dtype_code(x.dtype),
            *(t.data_ptr() for t in args),
            *(t.data_ptr() for t in outs),
            ws.data_ptr(),
            float(sigma),
            float(alpha),
            B,
            n,
            m,
            sms,
            _build.stream(),
        )
    _build.check(code, "admm_iter")
    launches += 1
    return outs


def admm_iter_op(Minv, AMinvT, A, q, l, u, rho, rho_inv, sigma, alpha, active, x, z, y, dx, dy):
    """:func:`admm_iter` through its operator
    (``torch.ops.osqp_tpu_torch.admm_iter``), as a traced program calls
    it: the same C entry, the same bits."""
    return tuple(_build.ops().admm_iter(Minv, AMinvT, A, q, l, u, rho, rho_inv, active, x, z, y, dx, dy,
                                        _build.setting(sigma), _build.setting(alpha), _build.sm_count(x.device)))


def _kkt_solve(factor, A, rho_vec, rhs_x, rhs_z, x0=None):
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


def refined_bytes(n: int, m: int, k: int, dtype, p_resident: bool = True) -> int:
    """Shared memory of one CTA of K1r's resident path with clusters of k
    CTAs (``RLayout`` in csrc/admm_iter_refined.cu): 16 bytes of
    mbarriers, then regions each rounded up to 16 bytes: the CTA's row
    slabs of Minv (ceil(n/k) rows), A (ceil(m/k) rows) and, resident, P,
    each with 16 bytes of slack on each side for its aligned bulk copy;
    x~ (n values); t, r and x (a value per slab row of Minv); w, z~,
    rho, z, y, rho^-1, l, u and y_lo (per row of A); in double P x~ and
    A'(rho A x~) (per row of Minv), the warps' column sums (n a warp:
    16 warps where n <= 256, 8 above) and, in a cluster, two sets of
    partials (2 n)."""
    elt = torch.finfo(dtype).bits // 8
    pad = 16 // elt
    rn, rm = -(-n // k), -(-m // k)
    slab = lambda rows: elt * (rows * n + 2 * pad)
    regions = ((slab(rn), slab(rm), slab(rn) if p_resident else 0, elt * n) + (elt * rn,) * 3 + (elt * rm,) * 9
               + (8 * rn, 8 * rn, 8 * resident_warps(n) * n, 16 * n if k > 1 else 0))
    return 16 + sum(-(-r // 16) * 16 for r in regions)


def resident_warps(n: int) -> int:
    """Warps of a CTA of K1r's resident path: 16 where a lane holds at
    most 8 columns (n <= 256), 8 above."""
    return 16 if n <= 256 else 8


def p_resident(n: int, m: int, k: int, dtype) -> bool:
    """Does P's slab fit in shared memory beside Minv's and A's with
    clusters of k CTAs?  Where it does not, the resident path reads P's
    rows from device memory at each P x~."""
    return refined_bytes(n, m, k, dtype, True) <= _build.SMEM_BYTES


def refined_plan(B: int, n: int, m: int, dtype, sm_count: int) -> tuple[str, int]:
    """K1r's path for B instances of n variables and m constraints on a
    card of ``sm_count`` SMs: ``("resident", k)`` with k the smallest of
    1, 2, 4, 8, 16 whose CTA share of Minv and A (and P, where
    :func:`p_resident`) fits one CTA's shared memory, or ``("split", 0)``
    where none does (n > 512 among them) or where B clusters of k CTAs
    would leave SMs of the card idle (B k < sm_count), as a single
    problem does: the split path spreads one instance over the card."""
    if not 1 <= n <= RESIDENT_MAX_N:
        return ("split", 0)
    for k in CLUSTERS:
        if refined_bytes(n, m, k, dtype, False) <= _build.SMEM_BYTES:
            break
    else:
        return ("split", 0)
    if B * k < sm_count:
        return ("split", 0)
    return ("resident", k)


@functools.lru_cache(maxsize=None)
def _resident_clusters(index: int, code: int, n: int, m: int, k: int, p_res: bool) -> int:
    with torch.cuda.device(index):
        return _build.library().osqp_admm_iter_refined_resident_clusters(code, n, m, k, int(p_res))


def resident_clusters(n: int, m: int, k: int, dtype, p_res: bool, device) -> int:
    """Clusters of k CTAs of K1r's resident path that the CUDA ``device``
    holds at once (the CUDA occupancy query), 0 or less where none fits."""
    device = torch.device(device)
    index = device.index if device.index is not None else torch.cuda.current_device()
    return _resident_clusters(index, _build.dtype_code(dtype), n, m, k, bool(p_res))


def admm_iter_refined(Minv, A, P, q, l, u, rho, rho_inv, sigma, alpha, active, x, z, y, dx, dy, y_lo=None):
    """One refined ADMM iteration where ``active``; returns new
    (x, z, y, dx, dy, y_lo), equal to the inputs bit for bit where
    ``active`` is false.  ``y_lo`` (B, m) is the TwoSum carry of the
    dual update (float32; None turns it off and returns None).

    Shapes: Minv, P (B,n,n), A (B,m,n); q, x, dx (B,n); l, u, rho,
    rho_inv, z, y, dy (B,m); active (B,) bool; sigma and alpha scalars.
    """
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
    _, cluster = refined_plan(B, n, m, x.dtype, _build.sm_count(x.device))
    if _build.tracing(x):
        return refined_op(Minv, A, P, q, l, u, rho, rho_inv, sigma, alpha, active, x, z, y, dx, dy, y_lo,
                          cluster=cluster)
    return launch_refined(Minv, A, P, q, l, u, rho, rho_inv, sigma, alpha, active, x, z, y, dx, dy, y_lo,
                          cluster=cluster)


def launch_refined(Minv, A, P, q, l, u, rho, rho_inv, sigma, alpha, active, x, z, y, dx, dy, y_lo=None, *,
                   cluster: int, p_res: bool | None = None):
    """K1r on validated contiguous CUDA tensors: the resident path with
    clusters of ``cluster`` CTAs (P's slab resident where ``p_res``, by
    default where it fits), or the split path where ``cluster`` is 0.
    :func:`admm_iter_refined` chooses by :func:`refined_plan`; a caller
    may name another path (``chip_smoke.py`` times them).  Raises where
    the card refuses the launch."""
    global refined_launches, refined_launches_resident
    if x.device.type != "cuda":
        raise ValueError(f"launch_refined runs the kernel on CUDA tensors, not {x.device}")
    args = (Minv, A, P, q, l, u, rho, rho_inv, active, x, z, y, dx, dy)
    (B, n), m = x.shape, z.shape[1]
    dtype = x.dtype
    outs = tuple(torch.empty_like(t) for t in (x, z, y, dx, dy))
    lo_out = torch.empty_like(y_lo) if y_lo is not None else None
    ptr = lambda t: t.data_ptr() if t is not None else 0
    lib = _build.library()
    with torch.cuda.device(x.device):
        if cluster:
            if p_res is None:
                p_res = p_resident(n, m, cluster, dtype)
            if cluster not in CLUSTERS or not 1 <= n <= RESIDENT_MAX_N or (
                    refined_bytes(n, m, cluster, dtype, p_res) > _build.SMEM_BYTES):
                raise ValueError(f"admm_iter_refined: no resident path with clusters of {cluster} at n = {n}, "
                                 f"m = {m} in {dtype}")
            clusters = resident_clusters(n, m, cluster, dtype, p_res, x.device)
            if clusters <= 0:
                raise RuntimeError(f"admm_iter_refined: the card holds no cluster of {cluster} CTAs of the resident "
                                   f"path at n = {n}, m = {m} in {dtype}")
            code = lib.osqp_admm_iter_refined_resident(
                _build.dtype_code(dtype), *(t.data_ptr() for t in args), ptr(y_lo),
                *(t.data_ptr() for t in outs), ptr(lo_out), float(sigma), float(alpha),
                B, n, m, cluster, int(p_res), clusters, _build.stream(),
            )
        else:
            ws, sms = _build.scratch("admm_iter_refined", dtype, B, n, m, x.device)
            code = lib.osqp_admm_iter_refined(
                _build.dtype_code(dtype), *(t.data_ptr() for t in args), ptr(y_lo),
                *(t.data_ptr() for t in outs), ptr(lo_out), ws.data_ptr(), float(sigma), float(alpha),
                B, n, m, sms, _build.stream(),
            )
    _build.check(code, "admm_iter_refined")
    refined_launches += 1
    refined_launches_resident += bool(cluster)
    return outs + (lo_out,)


def refined_op(Minv, A, P, q, l, u, rho, rho_inv, sigma, alpha, active, x, z, y, dx, dy, y_lo=None, *,
               cluster: int):
    """:func:`launch_refined` through its operators
    (``admm_iter_refined_resident`` with clusters of ``cluster`` CTAs, P
    resident where it fits, or ``admm_iter_refined`` where ``cluster`` is
    0), as a traced program calls them: the plan's numbers are arguments,
    which the operator checks against the card."""
    (B, n), m = x.shape, z.shape[1]
    ops = _build.ops()
    args = (Minv, A, P, q, l, u, rho, rho_inv, active, x, z, y, dx, dy, y_lo, _build.setting(sigma),
            _build.setting(alpha))
    if cluster:
        p_res = p_resident(n, m, cluster, x.dtype)
        outs = ops.admm_iter_refined_resident(*args, int(cluster), int(p_res),
                                              resident_clusters(n, m, cluster, x.dtype, p_res, x.device))
    else:
        outs = ops.admm_iter_refined(*args, _build.sm_count(x.device))
    return tuple(outs[:5]) + ((outs[5] if y_lo is not None else None),)


def _refined_kkt_solve(factor, A, rho_vec, rhs_x, rhs_z, x0=None):
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
