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
16) until a diagonal block is a leaf, T = chol(.)^-1 of each leaf by
the kernel's leaf entry (:func:`chol_inverse_leaf`), the blocks between
them by batched GEMMs, then X = T'T, one Newton-Schulz step and the
scaling undone, as there.  Where B instances leave most SMs of the card
idle (:func:`leaf_plan`: B at most half the SM count, the Solver's B =
1 among them) a leaf spreads one instance over a thread-block cluster
of up to 16 CTAs, which holds leaves up to :func:`cluster_max_n` (512
in float64, 768 in float32); the recursion stops at ``CLUSTER_LEAF_N``
= 256 there (:func:`leaf_size`), so CVXQP2_M's n = 1000 runs four
leaves, not eight.  Elsewhere, and on the CPU, leaves stop at
:func:`max_n`, one block an instance.  The JAX package pads n to a
power of two and recurses to closed-form 2 x 2 leaves, because a
Cholesky factorization serialises on the TPU; neither is carried over
(padding with the identity is exact).  Non-PD input gives NaN in the whole instance, which
callers read as the non-convexity signal.
"""

from __future__ import annotations

import functools
import math

import torch

from .. import _build

launches = 0
# Launches of the leaf entry, by the recursion above max_n, and of them
# those of its cluster form.
launches_leaf = 0
launches_leaf_cluster = 0
# The recursion splits at a multiple of this; a CTA of the cluster form
# holds a multiple of this many rows.
SPLIT = 16
# CTAs of a cluster of the leaf's cluster form (above 8 the card's
# non-portable sizes), and the shared memory each may take: a block's
# 227 KB less 64 bytes for the kernel's static flag.
LEAF_CLUSTERS = (2, 4, 8, 16)
_CLUSTER_SMEM = _build.SMEM_BYTES - 64
# The recursion's largest leaf where the leaves take the cluster form.
# Each 16-column panel of a leaf pays a chain of 16 pivots, a cluster
# barrier and its loads whatever the leaf's size, and the GEMMs between
# leaves use the whole card: at CVXQP2_M (B = 1) the route's device time
# with leaves of at most 256 is 0.8730 ms (float64) and 0.8370 (float32),
# with leaves of cluster_max_n 1.1778 and 1.0983, with leaves of max_n
# 0.9153 and 0.9041 (tools/probe_k2_leaf.py under the profiler; NVIDIA
# H100 80GB HBM3, 700.00 W).  Its event time at B = 1 follows the host,
# which launches ~25 more small kernels for four leaves than for two.
CLUSTER_LEAF_N = 256


def max_n(dtype: torch.dtype) -> int:
    """Largest n whose n*n + 2n working values fit one block's shared
    memory: 240 in float32, 169 in float64."""
    values = _build.SMEM_BYTES // torch.empty((), dtype=dtype).element_size()
    return math.isqrt(values + 1) - 1  # n*n + 2n = (n+1)^2 - 1


def blocks_per_sm(n: int, dtype: torch.dtype) -> int:
    """How many blocks of the kernel one SM of the current CUDA card holds
    at once at n (the CUDA occupancy query)."""
    return _build.library().osqp_chol_inverse_blocks_per_sm(_build.dtype_code(dtype), n)


def _leaf_cluster_values(n: int, s: int) -> int:
    """Shared-memory values of one CTA of the leaf's cluster form with
    strips of s rows (csrc/chol_inverse.cu:leaf_cluster_values)."""
    pitch = SPLIT + 1
    return s * n + s * pitch + pitch * n + 2 * SPLIT * pitch


def strip_rows(n: int, k: int) -> int:
    """Rows of S a CTA of a cluster of k holds: a multiple of SPLIT."""
    return SPLIT * -(-n // (SPLIT * k))


def cluster_fits(n: int, k: int, dtype: torch.dtype) -> bool:
    """Whether a cluster of k CTAs holds one n x n leaf."""
    elt = torch.empty((), dtype=dtype).element_size()
    return k in LEAF_CLUSTERS and _leaf_cluster_values(n, strip_rows(n, k)) * elt <= _CLUSTER_SMEM


@functools.lru_cache(maxsize=None)
def cluster_max_n(dtype: torch.dtype) -> int:
    """Largest leaf of the cluster form, held by 16 CTAs: 768 in float32,
    512 in float64."""
    n = max_n(dtype)
    while cluster_fits(n + 1, LEAF_CLUSTERS[-1], dtype):
        n += 1
    return n


def leaf_cluster(B: int, sm_count: int) -> int:
    """CTAs a cluster that B instances on a card of ``sm_count`` SMs
    spread over: the largest of :data:`LEAF_CLUSTERS` with B k <=
    sm_count (16 at B <= 8 on an H100's 132), or 0 where B is above half
    the SM count and one block an instance keeps the card busy."""
    fit = [k for k in LEAF_CLUSTERS if B * k <= sm_count]
    return fit[-1] if fit else 0


def leaf_plan(B: int, n: int, dtype: torch.dtype, sm_count: int) -> int:
    """CTAs a cluster of the leaf at B instances of n on a card of
    ``sm_count`` SMs: :func:`leaf_cluster`'s, or more where a leaf of n
    needs them; 0 for one block an instance (the batched shapes).
    Raises where no path holds n."""
    k = leaf_cluster(B, sm_count)
    if k == 0:
        if n > max_n(dtype):
            raise ValueError(f"chol_inverse_leaf: at B = {B} one block an instance holds n <= {max_n(dtype)} in "
                             f"{dtype}, got n = {n}")
        return 0
    for c in LEAF_CLUSTERS:
        if c >= k and cluster_fits(n, c, dtype):
            return c
    raise ValueError(f"chol_inverse_leaf: a cluster of {LEAF_CLUSTERS[-1]} CTAs holds n <= {cluster_max_n(dtype)} "
                     f"in {dtype}, got n = {n}")


def leaf_size(B: int, dtype: torch.dtype, device) -> int:
    """Largest leaf of :func:`chol_inv`'s recursion for B instances on
    ``device``: ``CLUSTER_LEAF_N`` where the leaves take the cluster form,
    :func:`max_n` otherwise and on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and leaf_cluster(B, _build.sm_count(device)):
        return min(CLUSTER_LEAF_N, cluster_max_n(dtype))
    return max_n(dtype)


def _validate(M: torch.Tensor, limit: int, what: str) -> None:
    if M.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what} takes float32 or float64, not {M.dtype}")
    if M.ndim != 3 or M.shape[1] != M.shape[2] or M.shape[1] == 0:
        raise ValueError(f"{what} takes a (B, n, n) batch with n >= 1, not {tuple(M.shape)}")
    if M.shape[1] > limit:
        raise ValueError(f"{what} holds n <= {limit} in {M.dtype}, got n = {M.shape[1]}")


def chol_inverse(M: torch.Tensor) -> torch.Tensor:
    """d (T'T) d with T = chol(dMd)^-1, d = diag(M)^-1/2: the inverse of
    each SPD matrix of the batch (B, n, n); NaN where one is not PD."""
    global launches
    _validate(M, max_n(M.dtype), "chol_inverse")
    if M.device.type == "cpu":
        return chol_inverse_plain(M)
    if M.device.type != "cuda":
        raise ValueError(f"chol_inverse runs on CPU or CUDA tensors, not {M.device}")
    if not M.is_contiguous():
        raise ValueError("chol_inverse takes a contiguous tensor")
    if _build.tracing(M):
        return chol_inverse_op(M)
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


def chol_inverse_op(M: torch.Tensor) -> torch.Tensor:
    """:func:`chol_inverse` through its operator
    (``torch.ops.osqp_tpu_torch.chol_inverse``), as a traced program calls
    it."""
    return _build.ops().chol_inverse(M)


def chol_inverse_leaf(S: torch.Tensor, *, cluster: int | None = None) -> torch.Tensor:
    """T = chol(S)^-1 of each SPD matrix of the batch (B, n, n): lower
    triangular, zeros above; NaN over the whole instance where S is not
    PD.  S is taken as it is (no scaling); only its lower triangle is
    read.  On the card one block an instance takes n <= max_n(dtype),
    and the cluster form, clusters of :func:`leaf_plan`'s size, n <=
    cluster_max_n(dtype); a caller may name another cluster size that
    fits, or 0 for one block an instance (``chip_smoke.py`` times them)."""
    global launches_leaf, launches_leaf_cluster
    _validate(S, cluster_max_n(S.dtype), "chol_inverse_leaf")
    if S.device.type == "cpu":
        return chol_inverse_leaf_plain(S)
    if S.device.type != "cuda":
        raise ValueError(f"chol_inverse_leaf runs on CPU or CUDA tensors, not {S.device}")
    if not S.is_contiguous():
        raise ValueError("chol_inverse_leaf takes a contiguous tensor")
    B, n, _ = S.shape
    if cluster is None:
        cluster = leaf_plan(B, n, S.dtype, _build.sm_count(S.device))
    if cluster == 0:
        _validate(S, max_n(S.dtype), "chol_inverse_leaf with one block an instance")
    elif not cluster_fits(n, cluster, S.dtype):
        raise ValueError(f"chol_inverse_leaf: n = {n} does not fit clusters of {cluster} CTAs in {S.dtype}")
    if _build.tracing(S):
        return leaf_op(S, cluster)
    T = torch.empty_like(S)
    lib = _build.library()
    with torch.cuda.device(S.device):
        if cluster:
            # L's panel columns and the next diagonal block, published by
            # their owners for the cluster's other CTAs
            scratch = torch.empty(B * lib.osqp_chol_inverse_leaf_scratch(n), dtype=S.dtype, device=S.device)
            code = lib.osqp_chol_inverse_leaf_cluster(_build.dtype_code(S.dtype), S.data_ptr(), T.data_ptr(),
                                                      scratch.data_ptr(), B, n, cluster, _build.stream())
        else:
            code = lib.osqp_chol_inverse_leaf(_build.dtype_code(S.dtype), S.data_ptr(), T.data_ptr(), B, n,
                                              _build.stream())
    _build.check(code, "chol_inverse_leaf")
    launches_leaf += 1
    launches_leaf_cluster += cluster > 0
    return T


def leaf_op(S: torch.Tensor, cluster: int) -> torch.Tensor:
    """:func:`chol_inverse_leaf` with clusters of ``cluster`` CTAs (0: one
    block an instance) through its operator (``chol_inverse_leaf_cluster``
    or ``chol_inverse_leaf`` of ``torch.ops.osqp_tpu_torch``), as a traced
    program calls it."""
    ops = _build.ops()
    return ops.chol_inverse_leaf_cluster(S, int(cluster)) if cluster else ops.chol_inverse_leaf(S)


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


def chol_inv(M: torch.Tensor, leaf_n: int | None = None) -> torch.Tensor:
    """T = chol(M)^-1 (lower) at any n by the blocked recursion
    (``osqp_tpu/ops/spd_inverse.py:_chol_inv``), down to diagonal blocks
    of at most ``leaf_n`` (by default :func:`leaf_size`'s), each by
    :func:`chol_inverse_leaf`."""
    n = M.shape[-1]
    if leaf_n is None:
        leaf_n = leaf_size(M.shape[0], M.dtype, M.device)
    if n <= leaf_n:
        return chol_inverse_leaf(M.contiguous())
    h = split(n)
    T11 = chol_inv(M[:, :h, :h], leaf_n)
    L21 = torch.bmm(M[:, h:, :h], T11.mT)
    T22 = chol_inv(M[:, h:, h:] - torch.bmm(L21, L21.mT), leaf_n)
    T = torch.zeros_like(M)
    T[:, :h, :h] = T11
    T[:, h:, :h] = -torch.bmm(T22, torch.bmm(L21, T11))
    T[:, h:, h:] = T22
    return T


def spd_inverse(M: torch.Tensor, leaf_n: int | None = None) -> torch.Tensor:
    """Inverse of a batch of SPD matrices (B, n, n) at any n >= 1,
    polished by one Newton-Schulz step, as the JAX package's default; NaN
    over an instance that is not PD.  Above max_n the recursion's leaves
    are at most ``leaf_n``, by default :func:`leaf_size`'s."""
    if M.shape[-1] <= max_n(M.dtype):
        return newton_schulz(M, chol_inverse(M))
    # Jacobi equilibration, exact: inv(M) = d inv(dMd) d (the JAX
    # package's spd_inverse:176-179)
    dg = torch.diagonal(M, dim1=-2, dim2=-1)
    pos = dg > 0
    d = torch.where(pos, 1.0 / torch.sqrt(torch.where(pos, dg, 1.0)), float("nan"))
    Ms = M * d[:, :, None] * d[:, None, :]
    T = chol_inv(Ms, leaf_n)
    return newton_schulz(Ms, torch.bmm(T.mT, T)) * d[:, :, None] * d[:, None, :]
