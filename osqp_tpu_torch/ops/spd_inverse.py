"""K2: batched SPD inverse (counterpart of ``osqp_tpu/ops/spd_inverse.py``).

:func:`chol_inverse` is the kernel's wrapper: for a CUDA tensor it
launches the hand-written kernel in ``csrc/chol_inverse.cu`` (Jacobi
equilibration, Cholesky, triangular inverse and d(T'T)d, one thread
block per instance, all in shared memory); for a CPU tensor it runs
:func:`chol_inverse_plain`, the same function in plain PyTorch.
:func:`spd_inverse` adds the Newton-Schulz step, a plain product on
either path, as in the JAX package.

The JAX package's recursive-GEMM formulation and its batch-minor leaf
exist because a Cholesky factorization serialises on the TPU; they are
not carried over.  Non-PD input gives NaN in the whole instance, which
callers read as the non-convexity signal.
"""

from __future__ import annotations

import math

import torch

from .. import _build

launches = 0


def max_n(dtype: torch.dtype) -> int:
    """Largest n whose n*n + 2n working values fit one block's shared
    memory: 240 in float32, 169 in float64."""
    values = _build.SMEM_BYTES // torch.empty((), dtype=dtype).element_size()
    return math.isqrt(values + 1) - 1  # n*n + 2n = (n+1)^2 - 1


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


def spd_inverse(M: torch.Tensor) -> torch.Tensor:
    """Inverse of a batch of SPD matrices (B, n, n), n <= max_n(dtype),
    polished by one Newton-Schulz step."""
    return newton_schulz(M, chol_inverse(M))
