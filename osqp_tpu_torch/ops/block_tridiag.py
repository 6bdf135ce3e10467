"""K7: the block-tridiagonal Cholesky factorization and its solve
(counterpart of ``osqp_tpu/linsys/block_tridiag.py:133-228``, ``init``,
``_tsolve`` and ``solve``).

For a stage-ordered problem (MPC) with Nb stages of b variables, the
reduced KKT matrix M (B, Nb b, Nb b) is block tridiagonal.  With D_i its
diagonal blocks and O_i = M[block i, block i-1]:

    C_0 = chol(D_0),  G_i = O_i C_{i-1}^-T,  C_i = chol(D_i - G_i G_i')

and M x = r is solved by y_i = C_i^-1 (r_i - G_i y_{i-1}) over the
stages, then x_i = C_i^-T (y_i - G_{i+1}' x_{i+1}) back over them.

:func:`bt_factor` and :func:`bt_solve` are the kernels' wrappers: for
CUDA tensors they launch ``csrc/block_tridiag.cu``.  The factor takes one
of three paths by block size (:func:`factor_path`): up to ``WARP_MAX`` =
32 a warp per instance (lane r holding row r of the stage, column steps
by shuffles, several instances a block); above it, up to
:func:`cluster_max_block` (558 in float32, 361 in float64), the cluster
path, each instance over a thread-block cluster whose CTAs hold its rows
in strips of their shared memory (:func:`cluster_plan` sizes the
cluster); above that the device path, the same kernel and steps with the
strips in C's and G's own rows of the outputs (L2-resident), the panel
buffer and diagonal band in shared memory up to b = 848 / 1705 and in a
scratch of device memory beyond (:func:`device_scratch`), in clusters of
:func:`device_plan`'s size.  The solve takes a warp per instance up to
``WARP_MAX`` and above it the wide solve, one CTA an instance of
:func:`solve_plan`'s warps (its vectors in shared memory, or in the
scratch of :func:`solve_scratch` above b = 7146 / 16832), by panels of
16 columns: warp 0 runs each panel's chain of quotients (by a reciprocal
worked out before the chain and two corrections, :func:`route_quotient`,
the division's bits) while the other warps apply the panel before to
the rows beyond it.
``launches_factor_warp`` / ``launches_factor_cluster`` /
``launches_factor_device`` count the factor's paths and
``launches_solve_warp`` / ``launches_solve_wide`` the solve's among
``launches_factor`` / ``launches_solve``.  For CPU tensors they run
:func:`bt_factor_plain` and :func:`bt_solve_plain`, the same functions
in plain PyTorch, written in the kernels' order (triangular solves by
columns, the Cholesky right-looking column by column, every product and
sum rounded on its own), so that the two agree bit for bit; the panels
and strips of the cluster and device paths and the wide solve's rounds
keep that order for every entry (``tests/test_torch_block_tridiag_order.py``
renders them).  A stage that is not positive definite gives NaN in the
whole lower triangle of its factor block, as ``jnp.linalg.cholesky``
does, and nothing raises.

In a traced program (:mod:`osqp_tpu_torch.program`) the wrappers call
the ``torch.library`` operators ``bt_factor`` and ``bt_solve``
(:func:`bt_factor_op`, :func:`bt_solve_op`: the same C entries on the
same path, cluster size and layout, their scratch allocated by the
operator), and count nothing: the program launches them after the
trace.
"""

from __future__ import annotations

import functools

import torch

from .. import _build

launches_factor = 0
launches_solve = 0
# Of those, the launches on the warp path (b <= WARP_MAX).
launches_factor_warp = 0
launches_solve_warp = 0
# Of the factor's launches, those on the cluster path (WARP_MAX < b <=
# cluster_max_block) and on the device path (above).
launches_factor_cluster = 0
launches_factor_device = 0
# Of the solve's launches, those of the wide solve (b > WARP_MAX).
launches_solve_wide = 0
# The largest block size of the warp path: up to it a warp takes an
# instance, above it a cluster (factor) or a CTA (solve) does.
WARP_MAX = 32
# Warps of a CTA of the wide solve: warp 0 runs the chain, the others
# (at least one) the products beside it.
SOLVE_WARPS = (2, 12)


_PATH_CODES = {"warp": 0, "cluster": 1, "device": 2}
# CTAs a cluster of the cluster path may have (above 8 the card's
# non-portable sizes), and the shared memory each may take: a block's
# 227 KB less 64 bytes for the kernel's static flag.
CLUSTERS = (1, 2, 4, 8, 16)
_CLUSTER_SMEM = _build.SMEM_BYTES - 64
PANEL = 16


def _band_values(b: int) -> int:
    """Values of the panel buffer and the diagonal band of one CTA of the
    cluster and device paths (csrc/block_tridiag.cu:band_values)."""
    return max(PANEL * (b | 1), (PANEL + 1) * b) + -(-b // PANEL) * PANEL * (PANEL + 1)


def _cluster_values(b: int, s: int) -> int:
    """Shared-memory values of one CTA of the cluster path with strips of
    s rows (csrc/block_tridiag.cu:cluster_values): two strips, the panel
    buffer, the diagonal band."""
    return 2 * s * b + _band_values(b)


def _elt(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def device_scratch(b: int, dtype: torch.dtype) -> int:
    """Values of device memory a CTA of the device path needs for its
    panel buffer and band: 0 where they fit its shared memory (b <= 848
    in float64, 1705 in float32), else :func:`_band_values`."""
    return 0 if _band_values(b) * _elt(dtype) <= _CLUSTER_SMEM else _band_values(b)


def cluster_fits(b: int, k: int, dtype: torch.dtype) -> bool:
    """Whether a CTA of a cluster of k holds its strip of ceil(b / k) rows."""
    return k in CLUSTERS and _cluster_values(b, -(-b // k)) * _elt(dtype) <= _CLUSTER_SMEM


@functools.lru_cache(maxsize=None)
def cluster_max_block(dtype: torch.dtype) -> int:
    """Largest block size b of the cluster path, whose strips fit a
    cluster of 16 CTAs: 558 in float32, 361 in float64.  Above it the
    factor takes the device path."""
    b = WARP_MAX
    while cluster_fits(b + 1, CLUSTERS[-1], dtype):
        b += 1
    return b


def factor_path(b: int, dtype: torch.dtype) -> str:
    """The path of :func:`bt_factor`'s kernel at block size b: ``"warp"``
    up to ``WARP_MAX``, ``"cluster"`` up to :func:`cluster_max_block`,
    ``"device"`` above."""
    if b <= WARP_MAX:
        return "warp"
    return "cluster" if b <= cluster_max_block(dtype) else "device"


def cluster_plan(b: int, B: int, dtype: torch.dtype, sm_count: int) -> int:
    """CTAs a cluster of the cluster path at block size b for B instances
    on a card of ``sm_count`` SMs: the fewest of :data:`CLUSTERS` whose
    strips fit, or more where B clusters of them would leave SMs idle,
    as many as B clusters spread over the card (16 at B = 4 on an H100's
    132 SMs).  Raises where none fits."""
    fit = [k for k in CLUSTERS if cluster_fits(b, k, dtype)]
    if not fit:
        raise ValueError(f"bt_factor: stages of b = {b} fit no cluster of at most {CLUSTERS[-1]} CTAs in {dtype}")
    spread = [k for k in fit if B * k <= sm_count]
    return max(spread) if spread else fit[0]


def device_plan(B: int, sm_count: int) -> int:
    """CTAs a cluster of the device path for B instances on a card of
    ``sm_count`` SMs: its strips live in the outputs and fit any cluster,
    so as many as B clusters spread over the card (16 at B = 4 on an
    H100's 132 SMs), and one CTA an instance where B fills the card."""
    spread = [k for k in CLUSTERS if B * k <= sm_count]
    return max(spread) if spread else 1


def _solve_values(b: int, warps: int, vectors: bool = True) -> int:
    """Shared-memory values of a CTA of the wide solve of ``warps`` warps,
    with its three vectors of b or without them
    (csrc/block_tridiag.cu:solve_values)."""
    return 3 * b * vectors + 4 * PANEL * (PANEL + 1) + warps * 32 * (PANEL + 1)


def solve_plan(b: int, dtype: torch.dtype) -> tuple[str, int]:
    """The layout of :func:`bt_solve` at block size b: ``("warp", 0)`` up
    to ``WARP_MAX`` (a warp an instance), above it ``("wide", w)``: one
    CTA an instance of w warps: warp 0 for the chain and one more for
    every 32 rows, at least one and at most 11 (b = 140: 6 warps, from b
    = 321: 12; at 12 warps a thread may take 170 registers, at 16 only
    128, with which the chain spills).  One CTA and not a cluster at
    every B: a cluster would add a barrier or a flag a panel to a chain
    that is already the solve's time.  Every b has a layout
    (:func:`solve_scratch` says where its vectors go)."""
    if b <= WARP_MAX:
        return "warp", 0
    return "wide", 1 + min(SOLVE_WARPS[1] - 1, max(SOLVE_WARPS[0] - 1, -(-b // 32)))


def solve_scratch(b: int, dtype: torch.dtype) -> int:
    """Values of device memory an instance of the wide solve needs for its
    three vectors of b (this stage's entries, the other stage's, the
    reciprocals of the diagonal): 0 where they fit the CTA's shared memory
    beside its blocks and tiles (b <= 7146 in float64, 16832 in float32),
    else 3 b."""
    path, warps = solve_plan(b, dtype)
    if path == "warp" or _solve_values(b, warps) * _elt(dtype) <= _build.SMEM_BYTES:
        return 0
    return 3 * b


def band_blocks(M: torch.Tensor, b: int):
    """Views of the diagonal blocks D (B, Nb, b, b) and the sub-diagonal
    blocks O (B, Nb-1, b, b), O[:, i-1] = M[block i, block i-1]."""
    B, n, _ = M.shape
    Nb = n // b
    Mb = M.reshape(B, Nb, b, Nb, b)
    D = torch.diagonal(Mb, offset=0, dim1=1, dim2=3).permute(0, 3, 1, 2)
    O = torch.diagonal(Mb, offset=-1, dim1=1, dim2=3).permute(0, 3, 1, 2)
    return D, O


def _validate_factor(M: torch.Tensor, b: int) -> None:
    if M.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"bt_factor takes float32 or float64, not {M.dtype}")
    if M.ndim != 3 or M.shape[1] != M.shape[2] or M.shape[1] == 0:
        raise ValueError(f"bt_factor takes a (B, n, n) batch with n >= 1, not {tuple(M.shape)}")
    n = M.shape[1]
    if b <= 0 or n % b:
        raise ValueError(f"bt_factor needs a block size dividing n: block_size={b}, n={n}")


def bt_factor(M: torch.Tensor, b: int, *, path: str | None = None, cluster: int | None = None):
    """(C, G) of each matrix of the batch: C (B, Nb, b, b) the stages'
    lower Cholesky factors (zeros above the diagonal), G (B, Nb-1, b, b)
    the coupling blocks.  Only the band blocks of M are read.  On the
    card the kernel takes :func:`factor_path`'s path, the cluster path in
    clusters of :func:`cluster_plan`'s size, the device path of
    :func:`device_plan`'s; a caller may name another path that takes b,
    or another cluster size that fits (``chip_smoke.py`` times them).
    Every path gives the same bits."""
    global launches_factor, launches_factor_warp, launches_factor_cluster, launches_factor_device
    _validate_factor(M, b)
    if M.device.type == "cpu":
        return bt_factor_plain(M, b)
    if M.device.type != "cuda":
        raise ValueError(f"bt_factor runs on CPU or CUDA tensors, not {M.device}")
    if not M.is_contiguous():
        raise ValueError("bt_factor takes a contiguous tensor")
    path = factor_path(b, M.dtype) if path is None else path
    B, n, _ = M.shape
    Nb = n // b
    if path == "cluster":
        cluster = cluster_plan(b, B, M.dtype, _build.sm_count(M.device)) if cluster is None else cluster
        if not cluster_fits(b, cluster, M.dtype):
            raise ValueError(f"bt_factor: stages of b = {b} do not fit clusters of {cluster} CTAs in {M.dtype}")
    elif path == "device":
        cluster = device_plan(B, _build.sm_count(M.device)) if cluster is None else cluster
        if cluster not in CLUSTERS:
            raise ValueError(f"bt_factor: no cluster of {cluster} CTAs, only {CLUSTERS}")
    elif path != "warp" or cluster is not None:
        raise ValueError(f"bt_factor: no path {path!r} with clusters of {cluster}")
    if _build.tracing(M):
        return bt_factor_op(M, b, path, cluster or 0)
    C = torch.empty((B, Nb, b, b), dtype=M.dtype, device=M.device)
    G = torch.empty((B, Nb - 1, b, b), dtype=M.dtype, device=M.device)
    spill = device_scratch(b, M.dtype) if path == "device" else 0
    scratch = torch.empty(B * cluster * spill, dtype=M.dtype, device=M.device) if spill else None
    lib = _build.library()
    with torch.cuda.device(M.device):
        code = lib.osqp_bt_factor(_build.dtype_code(M.dtype), M.data_ptr(), C.data_ptr(), G.data_ptr(),
                                  scratch.data_ptr() if spill else None, B, b, Nb, _PATH_CODES[path], cluster or 0,
                                  _build.stream())
    _build.check(code, "bt_factor")
    launches_factor += 1
    launches_factor_warp += path == "warp"
    launches_factor_cluster += path == "cluster"
    launches_factor_device += path == "device"
    return C, G


def _validate_solve(C, G, r) -> None:
    if C.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"bt_solve takes float32 or float64, not {C.dtype}")
    if C.ndim != 4 or C.shape[2] != C.shape[3] or C.shape[1] == 0 or C.shape[2] == 0:
        raise ValueError(f"bt_solve takes C of shape (B, Nb, b, b), not {tuple(C.shape)}")
    B, Nb, b, _ = C.shape
    if tuple(G.shape) != (B, Nb - 1, b, b) or G.dtype != C.dtype:
        raise ValueError(f"bt_solve takes G ({B}, {Nb - 1}, {b}, {b}) {C.dtype}, not {tuple(G.shape)} {G.dtype}")
    if tuple(r.shape) != (B, Nb * b) or r.dtype != C.dtype:
        raise ValueError(f"bt_solve takes r ({B}, {Nb * b}) {C.dtype}, not {tuple(r.shape)} {r.dtype}")
    if G.device != C.device or r.device != C.device:
        raise ValueError(f"bt_solve: C on {C.device}, G on {G.device}, r on {r.device}")


def bt_solve(C: torch.Tensor, G: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """x = M^-1 r with the factors of :func:`bt_factor`; r and x (B, n).
    On the card the kernel takes :func:`solve_plan`'s layout, with the
    scratch of :func:`solve_scratch` where the vectors need one."""
    global launches_solve, launches_solve_warp, launches_solve_wide
    _validate_solve(C, G, r)
    if C.device.type == "cpu":
        return bt_solve_plain(C, G, r)
    if C.device.type != "cuda":
        raise ValueError(f"bt_solve runs on CPU or CUDA tensors, not {C.device}")
    if not (C.is_contiguous() and G.is_contiguous() and r.is_contiguous()):
        raise ValueError("bt_solve takes contiguous tensors")
    B, Nb, b, _ = C.shape
    path, warps = solve_plan(b, C.dtype)
    if _build.tracing(C):
        return bt_solve_op(C, G, r, warps)
    x = torch.empty_like(r)
    spill = solve_scratch(b, C.dtype)
    scratch = torch.empty(B * spill, dtype=C.dtype, device=C.device) if spill else None
    lib = _build.library()
    with torch.cuda.device(C.device):
        code = lib.osqp_bt_solve(_build.dtype_code(C.dtype), C.data_ptr(), G.data_ptr(), r.data_ptr(), x.data_ptr(),
                                 scratch.data_ptr() if spill else None, B, b, Nb, warps, _build.stream())
    _build.check(code, "bt_solve")
    launches_solve += 1
    launches_solve_warp += path == "warp"
    launches_solve_wide += path == "wide"
    return x


def bt_factor_op(M: torch.Tensor, b: int, path: str, cluster: int):
    """:func:`bt_factor` through its operator
    (``torch.ops.osqp_tpu_torch.bt_factor``) on ``path`` in clusters of
    ``cluster`` CTAs (0 on the warp path), as a traced program calls it."""
    return tuple(_build.ops().bt_factor(M, int(b), _PATH_CODES[path], int(cluster)))


def bt_solve_op(C: torch.Tensor, G: torch.Tensor, r: torch.Tensor, warps: int) -> torch.Tensor:
    """:func:`bt_solve` through its operator
    (``torch.ops.osqp_tpu_torch.bt_solve``) in CTAs of ``warps`` warps (0:
    the warp path), as a traced program calls it."""
    return _build.ops().bt_solve(C, G, r, int(warps))


def route_quotient(a: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """a / d elementwise by the wide solve's quotient route (the
    reciprocal of d, then two corrections) on CUDA tensors, which gives
    the division's bits; ``chip_smoke.py`` holds it to ``a / d``.  For CPU
    tensors, the division."""
    if a.dtype not in (torch.float32, torch.float64) or d.dtype != a.dtype or a.shape != d.shape or a.ndim != 1:
        raise ValueError("route_quotient takes two float32 or float64 vectors of one shape and dtype")
    if a.device.type == "cpu":
        return a / d
    if not (a.is_cuda and d.device == a.device and a.is_contiguous() and d.is_contiguous()):
        raise ValueError("route_quotient takes contiguous tensors on one CUDA device")
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        code = _build.library().osqp_bt_quotients(_build.dtype_code(a.dtype), a.data_ptr(), d.data_ptr(),
                                                  out.data_ptr(), a.numel(), _build.stream())
    _build.check(code, "route_quotient")
    return out


def bt_factor_plain(M: torch.Tensor, b: int):
    """Plain PyTorch version of :func:`bt_factor`, stage by stage."""
    D, O = band_blocks(M, b)
    B, Nb = D.shape[:2]
    C = torch.empty((B, Nb, b, b), dtype=M.dtype, device=M.device)
    G = torch.empty((B, Nb - 1, b, b), dtype=M.dtype, device=M.device)
    for i in range(Nb):
        S = D[:, i].clone()
        if i > 0:
            # G_i = O_i C_{i-1}^-T by columns
            Cp, W = C[:, i - 1], O[:, i - 1].clone()
            for j in range(b):
                W[:, :, j] = W[:, :, j] / Cp[:, j, j, None]
                if j + 1 < b:
                    W[:, :, j + 1:] = W[:, :, j + 1:] - W[:, :, j, None] * Cp[:, None, j + 1:, j]
            G[:, i - 1] = W
            for t in range(b):
                S = S - W[:, :, t, None] * W[:, None, :, t]
        bad = torch.zeros(B, dtype=torch.bool, device=M.device)
        for j in range(b):
            piv = S[:, j, j].clone()
            d = torch.sqrt(piv)
            bad |= ~(piv > 0)
            S[:, j + 1:, j] = S[:, j + 1:, j] / d[:, None]
            S[:, j, j] = d
            S[:, j + 1:, j + 1:] = S[:, j + 1:, j + 1:] - S[:, j + 1:, j, None] * S[:, None, j + 1:, j]
        C[:, i] = torch.tril(torch.where(bad[:, None, None], float("nan"), S))
    return C, G


def bt_solve_plain(C: torch.Tensor, G: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`bt_solve`: forward, then backward
    block substitution, each triangular solve by columns."""
    B, Nb, b, _ = C.shape
    x = torch.empty_like(r)
    for i in range(Nb):
        v = r[:, i * b:(i + 1) * b].clone()
        if i > 0:
            yp = x[:, (i - 1) * b:i * b]
            for t in range(b):
                v = v - G[:, i - 1, :, t] * yp[:, t, None]
        c = C[:, i]
        for j in range(b):
            yj = v[:, j] / c[:, j, j]
            x[:, i * b + j] = yj
            if j + 1 < b:
                v[:, j + 1:] = v[:, j + 1:] - c[:, j + 1:, j] * yj[:, None]
    for i in reversed(range(Nb)):
        v = x[:, i * b:(i + 1) * b].clone()
        if i < Nb - 1:
            xn = x[:, (i + 1) * b:(i + 2) * b]
            for t in range(b):
                v = v - G[:, i, t, :] * xn[:, t, None]
        c = C[:, i]
        for j in reversed(range(b)):
            xj = v[:, j] / c[:, j, j]
            x[:, i * b + j] = xj
            if j > 0:
                v[:, :j] = v[:, :j] - c[:, j, :j] * xj[:, None]
    return x
