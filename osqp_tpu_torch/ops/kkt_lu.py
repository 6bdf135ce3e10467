"""K8: batched LU of the full KKT matrix with partial pivoting, and the
solve with its factors (counterpart of ``osqp_tpu/linsys/kkt_lu.py:37-50``,
``_lu_factor`` and ``_lu_solve``, which polish reuses through
``osqp_tpu/polish.py:161-168``).

:func:`kkt_lu_factor`, :func:`kkt_lu_factor_blocks` and
:func:`kkt_lu_solve` are the kernels' wrappers: for CUDA tensors they
launch the hand-written kernels in ``csrc/kkt_lu.cu``; for CPU tensors
they run :func:`kkt_lu_factor_plain`, :func:`kkt_lu_factor_blocks_plain`
and :func:`kkt_lu_solve_plain`, the same functions in plain PyTorch: an
unblocked right-looking LU and two substitution loops, N steps of
batched tensor operations each.  No library LU is called on either path.
:func:`kkt_lu_factor_blocks` factors the KKT matrix from its blocks (P,
A, a shift of P's diagonal and the (2,2) diagonal), which polish and the
``kkt_lu`` backend call: on the card K is never formed.

The kernels take one of two paths by batch size.  A batch that fills the
card (B at or above the SM count, the headline) factors each instance's
panels of up to 64 columns in one block, in shared memory, and brings
the rest of the matrix up to date with one launch a panel (the panel's
row moves, U12 and the trailing update by column strips); it solves one
instance per block.  A smaller batch
(polish's B = 1) factors each panel in a thread-block cluster of up to 16
CTAs per instance, 32 columns wide, with the next panel factored on a
second stream while the rest of the trailing update runs, and solves by
strips of 32 rows spread over the card, each strip published to the next
by a flag.  ``factor_info`` holds the last factor's kernel launches, its
first panel's width and that panel's cluster size (0 on the batched
path).

The pivot of a column is the first row of largest absolute value.  The
kernel takes every update in the plain version's order with the plain
version's rounding, so both give the same ``perm`` and the same ``lu``
bit for bit.  A zero pivot column divides by zero and leaves Inf/NaN
behind, as LAPACK-style LU does; polish reads that as a failed pass.

On the H100 the batched factor is bound by its operations (no fused
multiply-add: twice the operations figure of a bound that assumes one)
and the batched solve by one read of ``lu``; at B = 1 both by
their chains (pivot columns, diagonal blocks); see the source's header.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

launches_factor = 0
launches_solve = 0
# The last factor's (kernel launches, first panel's width, CTAs of its
# cluster or 0 on the batched path).
factor_info = (0, 0, 0)


def _validate_factor(K: torch.Tensor) -> None:
    if K.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"kkt_lu_factor takes float32 or float64, not {K.dtype}")
    if K.ndim != 3 or K.shape[1] != K.shape[2] or K.shape[1] == 0:
        raise ValueError(f"kkt_lu_factor takes a (B, N, N) batch with N >= 1, not {tuple(K.shape)}")


def _launch_factor(device, dtype, B, N, launch):
    """Allocate lu, perm and the scratch, run ``launch(lib, lu, perm,
    scratch, sms, info)`` on the current stream and count the factor."""
    global launches_factor, factor_info
    lu = torch.empty((B, N, N), dtype=dtype, device=device)
    perm = torch.empty((B, N), dtype=torch.int32, device=device)
    lib = _build.library()
    scratch = torch.empty(lib.osqp_kkt_lu_factor_scratch(_build.dtype_code(dtype), B, N), dtype=torch.uint8,
                          device=device)
    info = (ctypes.c_int * 3)()
    with torch.cuda.device(device):
        code = launch(lib, lu, perm, scratch, _build.sm_count(device), info)
    _build.check(code, "kkt_lu_factor")
    launches_factor += 1
    factor_info = tuple(info)
    return lu, perm


def kkt_lu_factor(K: torch.Tensor):
    """P K = L U of each matrix of the batch (B, N, N), with row pivoting.

    Returns ``(lu, perm)``: ``lu`` (B, N, N) holds the unit-lower L below
    the diagonal and U on and above it; ``perm`` (B, N) int32 is the row
    order, row i of P K being row ``perm[i]`` of K.  K is not written.
    """
    _validate_factor(K)
    if K.device.type == "cpu":
        return kkt_lu_factor_plain(K)
    if K.device.type != "cuda":
        raise ValueError(f"kkt_lu_factor runs on CPU or CUDA tensors, not {K.device}")
    if not K.is_contiguous():
        raise ValueError("kkt_lu_factor takes a contiguous tensor")
    B, N, _ = K.shape
    return _launch_factor(K.device, K.dtype, B, N, lambda lib, lu, perm, scratch, sms, info: lib.osqp_kkt_lu_factor(
        _build.dtype_code(K.dtype), K.data_ptr(), lu.data_ptr(), perm.data_ptr(), scratch.data_ptr(), B, N, sms,
        info, _build.stream()))


def _validate_blocks(P, A, d) -> None:
    if P.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"kkt_lu_factor_blocks takes float32 or float64, not {P.dtype}")
    if P.ndim != 3 or P.shape[1] != P.shape[2] or P.shape[1] == 0:
        raise ValueError(f"kkt_lu_factor_blocks takes P of shape (B, n, n) with n >= 1, not {tuple(P.shape)}")
    B, n, _ = P.shape
    m = A.shape[1] if A.ndim == 3 else -1
    if A.ndim != 3 or A.shape[0] != B or A.shape[2] != n:
        raise ValueError(f"kkt_lu_factor_blocks takes A of shape ({B}, m, {n}), not {tuple(A.shape)}")
    if tuple(d.shape) != (B, m):
        raise ValueError(f"kkt_lu_factor_blocks takes d of shape ({B}, {m}), not {tuple(d.shape)}")
    for v in (A, d):
        if v.dtype != P.dtype or v.device != P.device:
            raise ValueError(f"kkt_lu_factor_blocks: P is {P.dtype} on {P.device}, got {v.dtype} on {v.device}")


def kkt_lu_factor_blocks(P: torch.Tensor, A: torch.Tensor, shift: float, d: torch.Tensor):
    """:func:`kkt_lu_factor` of K = [[P + shift I, A'], [A, -diag(d)]] from
    its blocks: P (B, n, n), A (B, m, n), d (B, m).  On the card K is never
    formed: the factor's first pass reads the blocks where it would read
    K.  The same bits as factoring :func:`form_kkt`'s K."""
    _validate_blocks(P, A, d)
    if P.device.type == "cpu":
        return kkt_lu_factor_blocks_plain(P, A, shift, d)
    if P.device.type != "cuda":
        raise ValueError(f"kkt_lu_factor_blocks runs on CPU or CUDA tensors, not {P.device}")
    B, n, _ = P.shape
    m = A.shape[1]
    P, A, d = P.contiguous(), A.contiguous(), d.contiguous()
    if _build.tracing(P):
        return kkt_lu_factor_blocks_op(P, A, shift, d)
    return _launch_factor(P.device, P.dtype, B, n + m, lambda lib, lu, perm, scratch, sms, info:
                          lib.osqp_kkt_lu_factor_blocks(
                              _build.dtype_code(P.dtype), P.data_ptr(), A.data_ptr(), d.data_ptr(), float(shift),
                              n, m,
                              lu.data_ptr(), perm.data_ptr(), scratch.data_ptr(), B, sms, info, _build.stream()))


def form_kkt(P, A, sigma, rho_inv_vec):
    """K = [[P + sigma I, A'], [A, -diag(rho_inv_vec)]], batched (B, n+m,
    n+m) (mirrors kkt.c:6-177, dense): the plain path's K."""
    n, m = P.shape[-1], A.shape[-2]
    top = torch.cat([P + sigma * torch.eye(n, dtype=P.dtype, device=P.device), A.transpose(1, 2)], dim=-1)
    bot = torch.cat([A, torch.diag_embed(-rho_inv_vec)], dim=-1) if m else A
    return torch.cat([top, bot], dim=-2)


def kkt_lu_factor_blocks_plain(P, A, shift, d):
    """Plain PyTorch version of :func:`kkt_lu_factor_blocks`: K formed by
    :func:`form_kkt`, then :func:`kkt_lu_factor_plain`."""
    return kkt_lu_factor_plain(form_kkt(P, A, shift, d))


def _validate_solve(lu, perm, b) -> None:
    if lu.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"kkt_lu_solve takes float32 or float64, not {lu.dtype}")
    if lu.ndim != 3 or lu.shape[1] != lu.shape[2] or lu.shape[1] == 0:
        raise ValueError(f"kkt_lu_solve takes lu of shape (B, N, N) with N >= 1, not {tuple(lu.shape)}")
    B, N, _ = lu.shape
    if tuple(perm.shape) != (B, N) or perm.dtype != torch.int32:
        raise ValueError(f"kkt_lu_solve takes perm (B, N) int32, not {tuple(perm.shape)} {perm.dtype}")
    if tuple(b.shape) != (B, N) or b.dtype != lu.dtype:
        raise ValueError(f"kkt_lu_solve takes b (B, N) {lu.dtype}, not {tuple(b.shape)} {b.dtype}")
    if perm.device != lu.device or b.device != lu.device:
        raise ValueError(f"kkt_lu_solve: lu on {lu.device}, perm on {perm.device}, b on {b.device}")


def kkt_lu_solve(lu: torch.Tensor, perm: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x = U^-1 L^-1 b[perm] with the factors of :func:`kkt_lu_factor`;
    ``b`` and the result are (B, N)."""
    global launches_solve
    _validate_solve(lu, perm, b)
    if lu.device.type == "cpu":
        return kkt_lu_solve_plain(lu, perm, b)
    if lu.device.type != "cuda":
        raise ValueError(f"kkt_lu_solve runs on CPU or CUDA tensors, not {lu.device}")
    if not (lu.is_contiguous() and perm.is_contiguous() and b.is_contiguous()):
        raise ValueError("kkt_lu_solve takes contiguous tensors")
    if _build.tracing(lu):
        return kkt_lu_solve_op(lu, perm, b)
    B, N, _ = lu.shape
    x = torch.empty_like(b)
    lib = _build.library()
    sms = _build.sm_count(lu.device)
    ints = lib.osqp_kkt_lu_solve_scratch(B, N, sms)
    scratch = torch.zeros(ints, dtype=torch.int32, device=lu.device) if ints else None
    with torch.cuda.device(lu.device):
        code = lib.osqp_kkt_lu_solve(
            _build.dtype_code(lu.dtype), lu.data_ptr(), perm.data_ptr(), b.data_ptr(), x.data_ptr(),
            scratch.data_ptr() if scratch is not None else 0, B, N, sms, _build.stream(),
        )
    _build.check(code, "kkt_lu_solve")
    launches_solve += 1
    return x


def kkt_lu_factor_blocks_op(P, A, shift, d):
    """:func:`kkt_lu_factor_blocks` through its operator
    (``torch.ops.osqp_tpu_torch.kkt_lu_factor_blocks``), as a traced
    program calls it; ``factor_info`` is left as it was."""
    return tuple(_build.ops().kkt_lu_factor_blocks(P, A, d, _build.setting(shift), _build.sm_count(P.device)))


def kkt_lu_solve_op(lu, perm, b):
    """:func:`kkt_lu_solve` through its operator
    (``torch.ops.osqp_tpu_torch.kkt_lu_solve``), as a traced program calls
    it."""
    return _build.ops().kkt_lu_solve(lu, perm, b, _build.sm_count(lu.device))


def kkt_lu_factor_plain(K: torch.Tensor):
    """Plain PyTorch version of :func:`kkt_lu_factor`: the unblocked
    right-looking algorithm, one batched step per column."""
    B, N, _ = K.shape
    lu = K.clone()
    perm = torch.arange(N, dtype=torch.int32, device=K.device).repeat(B, 1)
    inst = torch.arange(B, device=K.device)
    for k in range(N):
        # argmax returns the first of several largest values
        p = lu[:, k:, k].abs().argmax(dim=1) + k
        row_k, row_p = lu[:, k].clone(), lu[inst, p]
        lu[:, k] = row_p
        lu[inst, p] = row_k
        perm_k, perm_p = perm[:, k].clone(), perm[inst, p]
        perm[:, k] = perm_p
        perm[inst, p] = perm_k
        if k + 1 < N:
            l = lu[:, k + 1:, k] / lu[:, k, k, None]
            lu[:, k + 1:, k] = l
            lu[:, k + 1:, k + 1:] -= l[:, :, None] * lu[:, k, None, k + 1:]
    return lu, perm


def kkt_lu_solve_plain(lu: torch.Tensor, perm: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`kkt_lu_solve`: a gather, then
    forward and backward substitution by columns."""
    N = lu.shape[-1]
    y = torch.gather(b, 1, perm.long())
    for j in range(N - 1):
        y[:, j + 1:] -= lu[:, j + 1:, j] * y[:, j, None]
    for j in range(N - 1, -1, -1):
        y[:, j] /= lu[:, j, j]
        y[:, :j] -= lu[:, :j, j] * y[:, j, None]
    return y
