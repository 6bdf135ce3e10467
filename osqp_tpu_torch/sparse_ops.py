"""Device-side sparse operands in ELL format, for large problems
(counterpart of ``osqp_tpu/sparse_ops.py``).

ELL (padded-row) storage pads every row to the largest count of
nonzeros per row, so that a product is a gather over a fixed number of
slots per row:

    A x   = sum_k val[:, i, k] * x[:, idx[i, k]]          (row gather)
    A' y  = sum_k t_val[:, j, k] * y[:, t_idx[j, k]]      (gather on A')

The transpose is stored explicitly, so both products gather and none
scatters.  Values carry a leading batch axis (scenario batches share
one sparsity pattern); ``idx`` and ``t_idx`` are the unbatched pattern.
Padded slots hold ``val = 0, idx = 0``: they add 0 to every sum and to
every non-negative maximum, so no product masks by count.  P is stored
with its full symmetric pattern.

This module builds the operands on the host (numpy and scipy) and holds
the value maps that put new nonzero values into a fixed pattern, with
which :func:`ell_gather_values` assembles operands from value tensors on
the device.  The products are K5 (:mod:`osqp_tpu_torch.ops.ell`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch


@dataclasses.dataclass(frozen=True)
class ELLMatrix:
    """Batched-values ELL matrix with explicit transpose.

    val:   (B, m, k)  row-padded values
    idx:   (m, k)     int32 column index per slot (0 where padded; val = 0)
    t_val: (B, n, kt) values of A' (row-padded over A's columns)
    t_idx: (n, kt)    int32 row index of A per slot
    shape: (m, n)     logical shape
    """

    val: torch.Tensor
    idx: torch.Tensor
    t_val: torch.Tensor
    t_idx: torch.Tensor
    shape: tuple

    @property
    def dtype(self) -> torch.dtype:
        return self.val.dtype

    @property
    def device(self) -> torch.device:
        return self.val.device

    @property
    def batch(self) -> int:
        return self.val.shape[0]

    def contiguous(self) -> "ELLMatrix":
        """The same matrix with contiguous values: the form K5 takes.
        Values broadcast over the batch become B copies."""
        return dataclasses.replace(self, val=self.val.contiguous(), t_val=self.t_val.contiguous())


def _to_ell_rows(M: "sp.csr_matrix"):
    """(idx (m, k) int32, val (m, k) float64) from a CSR matrix, built
    without a loop over rows."""
    m = M.shape[0]
    counts = np.diff(M.indptr)
    k = max(int(counts.max()) if m else 0, 1)
    idx = np.zeros((m, k), np.int32)
    val = np.zeros((m, k), np.float64)
    if M.nnz:
        slot = np.arange(k)[None, :] < counts[:, None]  # (m, k) bool
        idx[slot] = M.indices
        val[slot] = M.data
    return idx, val


def _symmetric_from_triu(M: "sp.csr_matrix") -> "sp.csr_matrix":
    U = sp.triu(M, format="csr")
    return (U + U.T - sp.diags(U.diagonal())).tocsr()


def _broadcast(a: np.ndarray, dtype, batch: int, device) -> torch.Tensor:
    t = torch.as_tensor(a, dtype=dtype, device=device)
    return t[None].expand((batch,) + tuple(t.shape))


def ell_from_scipy(M, dtype, batch: int = 1, sym_from_triu: bool = False, device="cpu") -> ELLMatrix:
    """An ELLMatrix from a scipy sparse (or dense) matrix.

    ``sym_from_triu``: treat M as the upper triangle of a symmetric
    matrix and store the full symmetric pattern (P's convention).
    Values are broadcast over ``batch`` (a view, not B copies: see
    :meth:`ELLMatrix.contiguous`).
    """
    M = sp.csr_matrix(M)
    if sym_from_triu:
        M = _symmetric_from_triu(M)
    idx, val = _to_ell_rows(M)
    t_idx, t_val = _to_ell_rows(M.T.tocsr())
    return ELLMatrix(
        val=_broadcast(val, dtype, batch, device),
        idx=torch.as_tensor(idx, device=device),
        t_val=_broadcast(t_val, dtype, batch, device),
        t_idx=torch.as_tensor(t_idx, device=device),
        shape=tuple(M.shape),
    )


# ---------------------------------------------------------------------------
# Value maps: CSC nnz index -> ELL slot (value updates on a fixed pattern)
# ---------------------------------------------------------------------------
def _tag_matrix(M):
    """Copy of ``M`` whose data are 1-based nnz indices (tags)."""
    T = M.copy()
    T.data = np.arange(1, M.nnz + 1, dtype=np.float64)
    return T


def _tag_ell(M, sym_from_triu: bool):
    T = sp.csr_matrix(_tag_matrix(M))
    if sym_from_triu:
        # diagonal tags survive exactly: t + t - t = t
        T = _symmetric_from_triu(T)
    return T, _to_ell_rows(T), _to_ell_rows(T.T.tocsr())


def ell_value_maps(M, sym_from_triu: bool = False):
    """Host-side gather maps from a CSC/CSR matrix's nnz order into ELL
    slots, so that new values go onto the device operand without
    rebuilding the pattern (the reference's in-place numeric update,
    osqp.c:1052-1062, with the PtoKKT/AtoKKT maps of kkt.c:184-212).

    Returns ``(src (m, k) int32, t_src (n, kt) int32)`` with -1 in
    padding slots, such that for values ``v`` (in ``M.data`` order)

        val[i, s]   = v[src[i, s]]    (0 where src < 0)
        t_val[j, s] = v[t_src[j, s]]  (0 where t_src < 0)

    reproduces ``ell_from_scipy(M_with_values)`` exactly: a tag matrix
    goes through the same structural steps (CSR conversion, symmetric
    completion, transpose), and those order the result by pattern only.
    ``sym_from_triu`` puts each off-diagonal upper entry in both
    symmetric slots (one shared source index).
    """
    _, (_, val_t), (_, t_val_t) = _tag_ell(M, sym_from_triu)
    src = np.rint(val_t).astype(np.int32) - 1
    t_src = np.rint(t_val_t).astype(np.int32) - 1
    return src, t_src


def ell_pattern_from_scipy(M, sym_from_triu: bool = False):
    """The unbatched integer pattern ``(idx, t_idx, shape)`` that goes
    with :func:`ell_value_maps`.

    The pattern comes from the tag matrix (data = 1..nnz), not from the
    values: an explicitly stored zero (the reference's placeholder for a
    later ``update_P``/``update_A``, osqp.c:1031-1062) must keep its
    slot, and scipy's arithmetic on the values could drop it from the
    pattern while the maps keep it."""
    T, (idx, _), (t_idx, _) = _tag_ell(M, sym_from_triu)
    return idx, t_idx, tuple(T.shape)


def ell_with_values(idx, t_idx, shape, src, t_src, values, dtype, batch: int = 1, device="cpu") -> ELLMatrix:
    """An :class:`ELLMatrix` assembled by gathering ``values`` (1-D, CSC
    nnz order, any array) through the maps on ``device``: O(nnz) gathers,
    no pattern work (:func:`ell_gather_values` on the pattern, maps and
    values as tensors)."""
    on = lambda a: torch.as_tensor(a, device=device)
    v = torch.as_tensor(np.asarray(values, np.float64), dtype=dtype, device=device)
    return ell_gather_values(on(idx), on(t_idx), shape, on(src), on(t_src), v, batch)


def ell_gather_values(idx, t_idx, shape, src, t_src, values: torch.Tensor, batch: int = 1) -> ELLMatrix:
    """An :class:`ELLMatrix` from tensors (JAX: osqp_tpu/sparse_ops.py:
    239-256): ``values`` (1-D, CSC nnz order) in the operand's dtype, the
    pattern and the maps int32 tensors on its device.  The values are
    gathered there and copied over the batch, contiguous as K5 takes them,
    with no host read: the form in which the traced sparse program
    assembles its operands."""
    if src.shape != idx.shape or t_src.shape != t_idx.shape:
        raise ValueError(
            f"value maps {tuple(src.shape)}/{tuple(t_src.shape)} disagree with the pattern "
            f"{tuple(idx.shape)}/{tuple(t_idx.shape)}: pattern and maps must come from the same matrix "
            "(explicit zeros included)"
        )
    zero = torch.zeros((), dtype=values.dtype, device=values.device)
    gather = lambda s: torch.where(s >= 0, values[s.clamp(min=0)] if values.numel() else zero, zero)
    copies = lambda v: v[None].expand((batch,) + tuple(v.shape)).contiguous()
    return ELLMatrix(val=copies(gather(src)), idx=idx, t_val=copies(gather(t_src)), t_idx=t_idx, shape=tuple(shape))
