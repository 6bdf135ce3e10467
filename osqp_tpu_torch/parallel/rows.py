"""The row-sharded constraint matrix of one QP (the operand of
:mod:`osqp_tpu_torch.parallel.intra`).

A's m rows are split in equal blocks over the ranks of a process group,
one process a device: rank r holds rows ``row0 = r R`` to ``row0 + R``
(R = m / W, m padded to a multiple of W by the caller).  A dense operand
is the (B, R, n) block; an ELL operand is the block's rows and the whole
transpose, which every rank keeps (it is nnz-sized), as the JAX package
lays it out (``osqp_tpu/parallel/intra.py:112-113,155-161``).
:class:`RowSharded` records the group, the block and the padding, and
its ``shape`` is the global (B, m, n).

**Every vector of length m stays whole on every rank** (z, y, l, u, rho,
E, the residuals); only A's storage is split.  So the collectives live in
the products alone, and termination, rho adaptation, finalize and the
certificates run unchanged on every rank.  (The JAX package shards y as
well and lets XLA place the collectives.)  Each rank must hold the same
bits of that replicated state: every rank's host loop takes the same
decision at each check and each CG stop test, and ranks that decided
apart would wait on each other for ever.  An all-gather copies; an
all-reduce of NCCL or gloo hands one result to every rank; nothing is
summed in an order that depends on the rank.

The products, each reached from the dispatch point named:

* A x (``linalg.mat_vec``): the block's rows, then an all-gather;
* A'y (``linalg.mat_tvec``): dense, the block's partial A_r' y_r, then an
  all-reduce (SUM); ELL, the replicated transpose over the whole y, no
  collective, the unsharded bits;
* the termination products (``termination.compute_products``): K3 once
  on the block with y's and dy's rows, then an all-gather of A x, one of
  A dx, and one all-reduce of A'y and A'dy (ELL: K5's grouped launch, and
  only the gathers);
* the cg backend's diagonal sum_i rho_i A_ij^2 (``linsys/cg.init``):
  dense, the block's sum and an all-reduce; ELL, the replicated
  transpose;
* the CG's products (``ops/cg._operator``): dense, V p = all-reduce of
  A_r'(rho_r A_r p), an n-vector a step; ELL, the all-gather of A_r p,
  then the replicated transpose, an m-vector a step.  A callable, not an
  ``EllOperator``, so the card takes K6's step kernels
  (``pcg_solve_stepwise``): the device loop's one launch cannot wait on
  another rank;
* Ruiz (``scaling.scale_data``): dense, K4 step by step
  (:func:`osqp_tpu_torch.ops.ruiz.ruiz_sweeps`) with an all-reduce (MAX)
  of the column maxima' bits and an all-gather of the row maxima a
  sweep; ELL, K5's column norms on the replicated transpose, its row
  norms on the block and an all-gather, the scaling of the block and of
  the transpose (``ops.ell.ell_scale_rows``);
* polish (``polish.polish``) keeps A's rows sharded: the mask scales the
  block (:meth:`masked`; ELL, K5's scale on the block and the
  transpose); a dense A's Schur complement takes the block's
  (MA)'(MA) and one all-reduce of the (B, n, n) (:meth:`gram`); an ELL
  A's PCG runs the operator of :meth:`schur_products`; the refinement's
  products are :meth:`term_products`' with its collectives.

``collectives`` counts the collectives by kind, in the style of the
kernel wrappers' launch counts, and ``largest_gather`` records the
elements of the largest all-gather since :func:`reset_collectives`: an
m-vector an instance at most, never A.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops import ell
from ..sparse_ops import ELLMatrix

collectives = {"all_gather": 0, "all_reduce_sum": 0, "all_reduce_max": 0}
largest_gather = 0  # elements of the largest all-gather's output


def reset_collectives() -> None:
    global largest_gather
    for kind in collectives:
        collectives[kind] = 0
    largest_gather = 0


def all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim``, in rank order: one
    gather along the first axis (``all_gather_single``, named
    ``all_gather_into_tensor`` before torch 2.13), then one reshape."""
    global largest_gather
    t = t.contiguous()
    W = dist.get_world_size(group)
    out = torch.empty((W * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, t, group=group)
    collectives["all_gather"] += 1
    largest_gather = max(largest_gather, out.numel())
    if dim == 0:
        return out
    if dim == 1 and t.shape[0] == 1:  # one instance: the first-axis gather is already in row order
        return out.view((1, W * t.shape[1]) + tuple(t.shape[2:]))
    return out.view((W,) + tuple(t.shape)).movedim(0, dim).flatten(dim, dim + 1)


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    t = t.contiguous()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    collectives["all_reduce_sum"] += 1
    return t


def all_reduce_max_bits(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum over the ranks of non-negative values,
    taken on their bits as signed integers (which order as the values do,
    NaN above inf), a type that NCCL and gloo both reduce exactly."""
    view = torch.int32 if t.dtype == torch.float32 else torch.int64
    bits = t.contiguous().view(view)
    dist.all_reduce(bits, op=dist.ReduceOp.MAX, group=group)
    collectives["all_reduce_max"] += 1
    return bits.view(t.dtype)


def all_reduce_max(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum over the ranks of an integer tensor."""
    t = t.contiguous()
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    collectives["all_reduce_max"] += 1
    return t


class RowSharded:
    """A's rows ``row0`` to ``row0 + R`` of m on this rank of ``group``
    (R = m / the group's size), dense or ELL, with ``pad`` loose zero rows
    at the end of the m.  ``shape`` is (B, m, n).

    ``local`` is the dense (B, R, n) block, or for ELL operands ``rows``,
    the block's rows as an :class:`ELLMatrix` of shape (R, n), whose
    products are the row gathers (A_r x, row norms), and ``t``, the same
    storage with shape (m, n), whose products are the transposed gathers
    over the whole transpose (A'y, column norms and sums).  Both carry
    the block's rows and the whole transpose; neither may take the other's
    products."""

    def __init__(self, local, m: int, row0: int, group, pad: int = 0, t: ELLMatrix | None = None):
        self.local = local
        self.ell = isinstance(local, ELLMatrix)
        self.t = t
        self.m = int(m)
        self.row0 = int(row0)
        self.group = group
        self.pad = int(pad)
        if self.ell:
            self.rows_count, self.n = local.shape
            self.B = local.batch
        else:
            self.B, self.rows_count, self.n = local.shape
        if self.rows_count * dist.get_world_size(group) != self.m:
            raise ValueError(f"RowSharded: {self.rows_count} rows a rank over {dist.get_world_size(group)} ranks "
                             f"is not m = {self.m}")

    @classmethod
    def from_ell(cls, val, idx, t_val, t_idx, m: int, row0: int, group, pad: int = 0) -> "RowSharded":
        """From a block of an ELL matrix's rows (val (B, R, k), idx (R, k))
        and its whole transpose (t_val (B, n, kt), t_idx (n, kt))."""
        R, n = idx.shape[0], t_idx.shape[0]
        rows = ELLMatrix(val=val, idx=idx, t_val=t_val, t_idx=t_idx, shape=(R, n))
        t = ELLMatrix(val=val, idx=idx, t_val=t_val, t_idx=t_idx, shape=(m, n))
        return cls(rows, m, row0, group, pad, t)

    # -- what the solve path reads of an operand --------------------------
    @property
    def shape(self) -> tuple:
        return (self.B, self.m, self.n)

    @property
    def dtype(self) -> torch.dtype:
        return self.local.dtype

    @property
    def device(self) -> torch.device:
        return self.local.device

    def to(self, dtype: torch.dtype) -> "RowSharded":
        """The same rows with their values cast to ``dtype``."""
        if not self.ell:
            return RowSharded(self.local.to(dtype), self.m, self.row0, self.group, self.pad)
        r = self.local
        return RowSharded.from_ell(r.val.to(dtype), r.idx, r.t_val.to(dtype), r.t_idx, self.m, self.row0, self.group,
                                   self.pad)

    def block(self, v: torch.Tensor) -> torch.Tensor:
        """This rank's rows of an m-vector (B, m) -> (B, R)."""
        return v[:, self.row0:self.row0 + self.rows_count].contiguous()

    def gather_rows(self, v: torch.Tensor) -> torch.Tensor:
        """(B, R) of every rank -> (B, m)."""
        return all_gather(v, self.group, dim=1)

    # -- products ----------------------------------------------------------
    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """A x: (B, n) -> (B, m)."""
        if self.ell:
            return self.gather_rows(ell.ell_matvec(self.local, x))
        return self.gather_rows(torch.bmm(self.local, x.unsqueeze(-1)).squeeze(-1))

    def tmatvec(self, y: torch.Tensor) -> torch.Tensor:
        """A'y: (B, m) -> (B, n)."""
        if self.ell:
            return ell.ell_tmatvec(self.t, y)
        return all_reduce_sum(torch.bmm(self.block(y).unsqueeze(-2), self.local).squeeze(-2), self.group)

    def term_products(self, P, x, y, dx=None, dy=None):
        """A x, P x, A'y and, with dx and dy, A'dy, P dx, A dx, as
        :class:`~osqp_tpu_torch.ops.term_products.TermProducts`."""
        from ..ops.term_products import TermProducts, term_products

        cert = dx is not None
        if self.ell:
            calls = [(ell.ell_matvec, self.local, x), (ell.ell_matvec, P, x), (ell.ell_tmatvec, self.t, y)]
            if cert:
                calls += [(ell.ell_tmatvec, self.t, dy), (ell.ell_matvec, P, dx), (ell.ell_matvec, self.local, dx)]
            out = ell.ell_products(*calls)
            Ax, Px, Aty = out[:3]
            Atdy, Pdx, Adx = out[3:] if cert else (None, None, None)
        else:
            tp = term_products(P, self.local, x, self.block(y), dx, self.block(dy) if cert else None)
            Ax, Px, Aty, Atdy, Pdx, Adx = tp
            # one all-reduce for the transposed products
            sums = all_reduce_sum(torch.stack([Aty, Atdy]) if cert else Aty, self.group)
            Aty, Atdy = (sums[0], sums[1]) if cert else (sums, None)
        # an all-gather for each row product: an m-vector an instance a gather
        Ax = self.gather_rows(Ax)
        if cert:
            Adx = self.gather_rows(Adx)
        return TermProducts(Ax, Px, Aty, Atdy, Pdx, Adx)

    def cg_colsums(self, w: torch.Tensor) -> torch.Tensor:
        """sum_i w_i A_ij^2 (B, n), the Jacobi diagonal's term of the dense
        cg backend (ELL operands take K5's on ``t``)."""
        return all_reduce_sum(torch.einsum("bm,bmn->bn", self.block(w), self.local * self.local), self.group)

    def products(self, P, w):
        """p -> (P p, A'(w A p)): the CG's operator."""
        if self.ell:
            def products(p):
                return ell.ell_matvec(P, p), ell.ell_tmatvec(self.t, self.matvec(p), w)
        else:
            w_r = self.block(w)

            def products(p):
                Ap = torch.bmm(self.local, p.unsqueeze(-1)).squeeze(-1)
                Vp = torch.bmm((w_r * Ap).unsqueeze(-2), self.local).squeeze(-2)
                return torch.bmm(P, p.unsqueeze(-1)).squeeze(-1), all_reduce_sum(Vp, self.group)

        return products

    # -- scaling -------------------------------------------------------------
    def ruiz(self, P, q, l, u, n_iters: int):
        """K4 step by step on a dense operand (``ops.ruiz.ruiz_sweeps``): the
        block's maxima merged over the ranks at every sweep.  Returns (c,
        D, E, c DPD, c Dq, the scaled operand, E l, E u)."""
        from ..ops import ruiz as k4

        def a_maxima(E, D):
            col, row = k4.sweep_a(self.local, self.block(E), D)
            return all_reduce_max_bits(col, self.group), self.gather_rows(row)

        c, D, E = k4.ruiz_sweeps(P, q, self.m, n_iters, a_maxima)
        As = RowSharded(k4.apply(self.local, self.block(E), D), self.m, self.row0, self.group, self.pad)
        qs, ls, us = k4.apply_vectors(q, l, u, c, D, E)
        return c, D, E, k4.apply(P, D, D, c), qs, As, ls, us

    def ell_norms(self, P, D, E, sweep: bool):
        """The norms of one ELL Ruiz sweep (``scaling._scale_data_ell``):
        P's column norms under D and, for a sweep to come, A's column norms
        under E (the replicated transpose) and its row norms under D (the
        block, then an all-gather).  One K5 launch."""
        calls = [(ell.ell_col_norms, P, D)]
        if sweep:
            calls += [(ell.ell_col_norms, self.t, E), (ell.ell_row_norms, self.local, D)]
        out = ell.ell_products(*calls)
        if not sweep:
            return out + [None, None]
        return [out[0], out[1], self.gather_rows(out[2])]

    def ell_scale(self, E, D) -> "RowSharded":
        """diag(E) A diag(D) on the block's rows and the whole transpose."""
        r = self.local
        val, t_val = ell.ell_scale_rows(r.val, r.idx, r.t_val, r.t_idx, self.block(E), E, D)
        return RowSharded.from_ell(val, r.idx, t_val, r.t_idx, self.m, self.row0, self.group, self.pad)

    # -- polish ----------------------------------------------------------------
    def masked(self, mask: torch.Tensor) -> "RowSharded":
        """diag(mask) A for a (B, m) mask: the block's rows times their part
        of it; an ELL operand through K5's scale (``ops.ell.ell_scale_rows``)
        on the block and the whole transpose, each value the bits
        ``ell_scale`` gives it on the whole A."""
        if not self.ell:
            return RowSharded(self.block(mask)[:, :, None] * self.local, self.m, self.row0, self.group, self.pad)
        r = self.local
        ones = torch.ones((self.B, self.n), dtype=mask.dtype, device=mask.device)
        val, t_val = ell.ell_scale_rows(r.val, r.idx, r.t_val, r.t_idx, self.block(mask), mask, ones)
        return RowSharded.from_ell(val, r.idx, t_val, r.t_idx, self.m, self.row0, self.group, self.pad)

    def gram(self) -> torch.Tensor:
        """A'A (B, n, n) of a dense operand: the block's A_r'A_r, then one
        all-reduce (SUM)."""
        return all_reduce_sum(torch.bmm(self.local.mT, self.local), self.group)

    def schur_products(self, P: ELLMatrix, d: torch.Tensor):
        """p -> (P p, A'(A p) / d) on ELL operands, polish's Schur
        operator: the block's rows, an all-gather of A p, the replicated
        transpose, then a division by ``d`` (a 0-d host tensor) copied to
        the device, elementwise and correctly rounded, as
        :class:`~osqp_tpu_torch.ops.cg.EllOperator` divides.  A callable,
        so the card steps it (``ops.cg.pcg_solve_stepwise``)."""
        d_dev = torch.as_tensor(d, dtype=self.dtype).to(self.device)

        def products(p):
            return ell.ell_matvec(P, p), ell.ell_tmatvec(self.t, self.matvec(p)) / d_dev

        return products
