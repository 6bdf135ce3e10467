"""K2: batched SPD inverse (counterpart of ``osqp_tpu/ops/spd_inverse.py``).

:func:`chol_inverse` is the kernel's wrapper: for a CUDA tensor it
launches the hand-written kernel in ``csrc/chol_inverse.cu`` (Jacobi
equilibration, Cholesky, triangular inverse and d(T'T)d, one thread
block per instance, all in shared memory); for a CPU tensor it runs
:func:`chol_inverse_plain`, the same function in plain PyTorch.  It
takes n up to :func:`max_n`, where one matrix fits a block's shared
memory.

:func:`spd_inverse` inverts at every n.  Up to :func:`max_n` it is
:func:`chol_inverse` and a Newton-Schulz step.  Above, it runs the JAX
package's blocked recursion (``osqp_tpu/ops/spd_inverse.py:_chol_inv``)
on the Jacobi-equilibrated matrix: split at about n/2 (a multiple of
16) until a diagonal block fits, T = chol(.)^-1 of each such block by
the kernel's leaf entry (:func:`chol_inverse_leaf`), the blocks between
them by batched GEMMs, then X = T'T, one Newton-Schulz step and the
scaling undone, as there.  The JAX package pads n to a power of two and
recurses to closed-form 2 x 2 leaves, because a Cholesky factorization
serialises on the TPU; neither is carried over (padding with the
identity is exact).  Non-PD input gives NaN in the whole instance, which
callers read as the non-convexity signal.
"""

from __future__ import annotations

import math

import torch

from .. import _build

launches = 0
# Launches of the leaf entry, by the recursion above max_n.
launches_leaf = 0
# The recursion splits at a multiple of this.
SPLIT = 16


def max_n(dtype: torch.dtype) -> int:
    """Largest n whose n*n + 2n working values fit one block's shared
    memory: 240 in float32, 169 in float64."""
    values = _build.SMEM_BYTES // torch.empty((), dtype=dtype).element_size()
    return math.isqrt(values + 1) - 1  # n*n + 2n = (n+1)^2 - 1


def blocks_per_sm(n: int, dtype: torch.dtype) -> int:
    """How many blocks of the kernel one SM of the current CUDA card holds
    at once at n (the CUDA occupancy query)."""
    return _build.library().osqp_chol_inverse_blocks_per_sm(_build.dtype_code(dtype), n)


def _validate(M: torch.Tensor) -> None:
    if M.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"chol_inverse takes float32 or float64, not {M.dtype}")
    if M.ndim != 3 or M.shape[1] != M.shape[2] or M.shape[1] == 0:
        raise ValueError(f"chol_inverse takes a (B, n, n) batch with n >= 1, not {tuple(M.shape)}")
    if M.shape[1] > max_n(M.dtype):
        raise ValueError(
            f"chol_inverse holds one n x n matrix in shared memory: n <= {max_n(M.dtype)} "
            f"in {M.dtype}, got n = {M.shape[1]}"
        )


def chol_inverse(M: torch.Tensor) -> torch.Tensor:
    """d (T'T) d with T = chol(dMd)^-1, d = diag(M)^-1/2: the inverse of
    each SPD matrix of the batch (B, n, n); NaN where one is not PD."""
    global launches
    _validate(M)
    if M.device.type == "cpu":
        return chol_inverse_plain(M)
    if M.device.type != "cuda":
        raise ValueError(f"chol_inverse runs on CPU or CUDA tensors, not {M.device}")
    if not M.is_contiguous():
        raise ValueError("chol_inverse takes a contiguous tensor")
    B, n, _ = M.shape
    X = torch.empty_like(M)
    lib = _build.library()
    with torch.cuda.device(M.device):
        code = lib.osqp_chol_inverse(
            _build.dtype_code(M.dtype), M.data_ptr(), X.data_ptr(), B, n, _build.stream()
        )
    _build.check(code, "chol_inverse")
    launches += 1
    return X


def chol_inverse_leaf(S: torch.Tensor) -> torch.Tensor:
    """T = chol(S)^-1 of each SPD matrix of the batch (B, n, n), n <=
    max_n(dtype): lower triangular, zeros above; NaN over the whole
    instance where S is not PD.  S is taken as it is (no scaling); only
    its lower triangle is read."""
    global launches_leaf
    _validate(S)
    if S.device.type == "cpu":
        return chol_inverse_leaf_plain(S)
    if S.device.type != "cuda":
        raise ValueError(f"chol_inverse_leaf runs on CPU or CUDA tensors, not {S.device}")
    if not S.is_contiguous():
        raise ValueError("chol_inverse_leaf takes a contiguous tensor")
    B, n, _ = S.shape
    T = torch.empty_like(S)
    lib = _build.library()
    with torch.cuda.device(S.device):
        code = lib.osqp_chol_inverse_leaf(_build.dtype_code(S.dtype), S.data_ptr(), T.data_ptr(), B, n,
                                          _build.stream())
    _build.check(code, "chol_inverse_leaf")
    launches_leaf += 1
    return T


def chol_inverse_leaf_plain(S: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`chol_inverse_leaf`."""
    n = S.shape[-1]
    L, info = torch.linalg.cholesky_ex(S)
    eye = torch.eye(n, dtype=S.dtype, device=S.device).expand_as(S)
    T = torch.linalg.solve_triangular(torch.where((info == 0)[:, None, None], L, eye), eye, upper=False)
    return torch.where((info == 0)[:, None, None], T, float("nan"))


def chol_inverse_plain(M: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`chol_inverse`."""
    n = M.shape[-1]
    eye = torch.eye(n, dtype=M.dtype, device=M.device)
    dg = torch.diagonal(M, dim1=-2, dim2=-1)
    pos = dg > 0
    d = torch.where(pos, 1.0 / torch.sqrt(torch.where(pos, dg, 1.0)), float("nan"))
    Ms = M * d[:, :, None] * d[:, None, :]
    ok = pos.all(-1)
    L, info = torch.linalg.cholesky_ex(torch.where(ok[:, None, None], Ms, eye))
    X = torch.cholesky_inverse(L) * d[:, :, None] * d[:, None, :]
    return torch.where((ok & (info == 0))[:, None, None], X, float("nan"))


def newton_schulz(M: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """One Newton-Schulz step X <- X (2I - M X) towards M^-1."""
    eye2 = 2.0 * torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    return torch.bmm(X, eye2 - torch.bmm(M, X))


def split(n: int) -> int:
    """Where the recursion splits an n x n matrix: about n/2, rounded to
    a multiple of SPLIT."""
    return max(SPLIT, (n // 2 + SPLIT // 2) // SPLIT * SPLIT)


def chol_inv(M: torch.Tensor) -> torch.Tensor:
    """T = chol(M)^-1 (lower) at any n by the blocked recursion
    (``osqp_tpu/ops/spd_inverse.py:_chol_inv``), the diagonal blocks that
    fit by :func:`chol_inverse_leaf`."""
    n = M.shape[-1]
    if n <= max_n(M.dtype):
        return chol_inverse_leaf(M.contiguous())
    h = split(n)
    T11 = chol_inv(M[:, :h, :h])
    L21 = torch.bmm(M[:, h:, :h], T11.mT)
    T22 = chol_inv(M[:, h:, h:] - torch.bmm(L21, L21.mT))
    T = torch.zeros_like(M)
    T[:, :h, :h] = T11
    T[:, h:, :h] = -torch.bmm(T22, torch.bmm(L21, T11))
    T[:, h:, h:] = T22
    return T


def spd_inverse(M: torch.Tensor) -> torch.Tensor:
    """Inverse of a batch of SPD matrices (B, n, n) at any n >= 1,
    polished by one Newton-Schulz step, as the JAX package's default; NaN
    over an instance that is not PD."""
    if M.shape[-1] <= max_n(M.dtype):
        return newton_schulz(M, chol_inverse(M))
    # Jacobi equilibration, exact: inv(M) = d inv(dMd) d (the JAX
    # package's spd_inverse:176-179)
    dg = torch.diagonal(M, dim1=-2, dim2=-1)
    pos = dg > 0
    d = torch.where(pos, 1.0 / torch.sqrt(torch.where(pos, dg, 1.0)), float("nan"))
    Ms = M * d[:, :, None] * d[:, None, :]
    T = chol_inv(Ms)
    return newton_schulz(Ms, torch.bmm(T.mT, T)) * d[:, :, None] * d[:, None, :]
