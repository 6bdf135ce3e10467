"""K5: the row-gather products of ELL operands (counterpart of
``osqp_tpu/sparse_ops.py:120-177``), and the start of the cg backend's
CG on them (``osqp_tpu/linsys/cg.py:129-137``).

Each public function is the kernels' wrapper: for CUDA operands it
launches ``csrc/ell_ops.cu``; for CPU operands it runs its ``_plain``
twin, the same function in plain PyTorch: a gather, then the sum over the
slot axis taken in slot order, as the kernel takes it, so that the two
agree bit for bit (the JAX package writes the same gather and
reduction).

- :func:`ell_products` runs several independent products, each given as
  ``(function, *arguments)`` of the product functions below, in one
  launch of the grouped reduction kernel (:data:`MAX_JOBS` a launch);
  each result has the bits of the function's own call, which is a
  one-job launch of the same kernel.  :func:`plan` deals the launch's
  CTAs to its jobs.
- :func:`ell_cg_start` computes the CG's right-hand side and its start
  from x0 in two launches: P x0 and A x0 grouped, then one kernel.
- :func:`ell_scale` runs the scaling kernel on both copies of the values;
  :func:`ell_scale_rows` on a block of the rows and the whole transpose
  (A's rows spread over processes, :mod:`osqp_tpu_torch.parallel.rows`).

An operand is checked once, at its first product, and what a launch
needs of it is kept on the :class:`ELLMatrix` (:func:`_operand`); a call
checks its vectors.  The kernels take contiguous tensors and raise on
anything else: values broadcast over the batch are made contiguous once
at set-up (:meth:`ELLMatrix.contiguous`), never here.  Operands with no
rows or no columns take the short cuts of the JAX package: an empty
product is zeros, and nothing is launched.

Under tracing (``torch.export``) a CUDA operand has no pointers: the
wrappers call the kernels' ``torch.library`` operators (``ell_group``,
``ell_cg_start``, ``ell_scale``; ``csrc/torch_ops.cpp``), the same C
entries on the same plans, so the same bits.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, NamedTuple

import torch

from .. import _build
from ..sparse_ops import ELLMatrix

launches = 0  # every K5 launch
launches_group = 0  # launches of the grouped reduction, one-job launches included
launches_start = 0  # launches of the CG start
launches_scale = 0  # launches of the scaling

_SUM, _WSUM, _SQ, _MAX, _DIAG = range(5)

# The grouped kernel's limits (csrc/ell_ops.cu: kMaxJobs, kThreads): jobs
# a launch, threads a CTA; a row tile is a warp at the least.
MAX_JOBS = 8
THREADS = 256
MIN_ROWS = 32
# CTAs per SM a launch aims at, where its batch can be split into runs.
CTAS_PER_SM = 8


class Plan(NamedTuple):
    """How one launch of the grouped kernel cuts its jobs: tiles of
    ``rows`` rows, ``ipar`` instances side by side in a CTA of rows x ipar
    threads, runs of ``run`` instances (a multiple of ipar), ``tiles[j]``
    tiles of job j and its CTAs from ``cta0[j]`` on, ``ctas`` in all."""

    rows: int
    ipar: int
    run: int
    tiles: tuple
    cta0: tuple
    ctas: int


@functools.lru_cache(maxsize=1024)
def plan(R: tuple, B: int, sm_count: int, ctas_per_sm: int = CTAS_PER_SM) -> Plan:
    """The plan of a launch whose jobs have ``R`` rows each (all >= 1)
    over ``B`` instances on a card of ``sm_count`` SMs.  Row tiles shrink
    from 256 rows towards a warp until the tiles give every SM a CTA;
    then the batch is cut into runs until there are ``ctas_per_sm`` CTAs
    an SM, or as many runs as groups of ipar instances.  A run's CTA reads
    its tile's pattern once for all its instances."""
    if not R or min(R) < 1 or B < 1:
        raise ValueError(f"plan takes jobs of at least one row over at least one instance, not {R} over {B}")
    tiles_of = lambda rows: tuple(-(-r // rows) for r in R)
    rows = THREADS
    while rows > MIN_ROWS and sum(tiles_of(rows)) < sm_count:
        rows //= 2
    tiles = tiles_of(rows)
    ipar = min(THREADS // rows, B)
    groups = -(-B // ipar)
    runs = min(max(-(-ctas_per_sm * sm_count // sum(tiles)), 1), groups)
    run = -(-groups // runs) * ipar
    runs = -(-B // run)
    cta0, ctas = [], 0
    for t in tiles:
        cta0.append(ctas)
        ctas += t * runs
    return Plan(rows, ipar, run, tiles, tuple(cta0), ctas)


def plan_tiles(p: Plan, R: tuple, B: int):
    """(job, r0, r1, b0, b1) of every CTA of the plan, as the kernel reads
    its block index: the job is the last whose first CTA is at or below
    it; then the tile, then the run."""
    for cta in range(p.ctas):
        j = max(i for i in range(len(R)) if p.cta0[i] <= cta)
        run, tile = divmod(cta - p.cta0[j], p.tiles[j])
        r0, b0 = tile * p.rows, run * p.run
        yield j, r0, min(r0 + p.rows, R[j]), b0, min(b0 + p.run, B)


# ---------------------------------------------------------------------------
# Operands and vectors
# ---------------------------------------------------------------------------
class _Operand(NamedTuple):
    """What a launch needs of an ELLMatrix, checked once."""

    cuda: bool
    dtype: torch.dtype
    device: torch.device
    B: int
    rows: tuple  # (values pointer, pattern pointer, k) of A's copy
    t: tuple  # the same of the transpose's
    code: int  # the dtype's code and the card's SMs (CUDA only)
    sms: int


def _take(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """v[:, idx], (B, R, k); an empty ``v`` gathers zeros (every slot is
    padding then)."""
    if v.shape[-1] == 0:
        return v.new_zeros((v.shape[0],) + tuple(idx.shape))
    return v[:, idx]


def _check_operand(val, idx, name):
    if val.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: ELL values must be float32 or float64, not {val.dtype}")
    if val.ndim != 3 or idx.ndim != 2 or tuple(val.shape[1:]) != tuple(idx.shape):
        raise ValueError(f"{name}: values {tuple(val.shape)} do not fit the pattern {tuple(idx.shape)}")
    if idx.dtype != torch.int32:
        raise TypeError(f"{name}: the ELL pattern must be int32, not {idx.dtype}")
    if idx.device != val.device:
        raise ValueError(f"{name}: pattern on {idx.device}, values on {val.device}")


def _operand(A: ELLMatrix, name: str) -> _Operand:
    """A's launch descriptor, made and checked at its first use and kept
    on A (a new matrix, such as :func:`ell_scale`'s result, has none; a
    copy whose values moved, such as a deep copy's, makes its own).  A
    traced operand has no pointers: its descriptor is made at each use,
    with ``rows`` and ``t`` None, and its products take the operators."""
    d = A.__dict__.get("_k5_operand")
    if d is not None and (not d.cuda or d.rows[0] == A.val.data_ptr()):
        return d
    traced = _build.tracing(A.val)
    _check_operand(A.val, A.idx, name)
    _check_operand(A.t_val, A.t_idx, name)
    if A.t_val.dtype != A.val.dtype or A.t_val.device != A.val.device or A.t_val.shape[0] != A.val.shape[0]:
        raise ValueError(f"{name}: the transpose's values differ from A's in dtype, device or batch")
    dev = A.val.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on CPU or CUDA tensors, not {dev}")
    cuda = dev.type == "cuda"
    copies = ((A.val, A.idx), (A.t_val, A.t_idx))
    if cuda and not all(t.is_contiguous() for c in copies for t in c):
        raise ValueError(f"{name} takes contiguous tensors (make the operand so with ELLMatrix.contiguous)")
    ptrs = [(v.data_ptr(), i.data_ptr(), i.shape[1]) if cuda and not traced else None for v, i in copies]
    d = _Operand(cuda, A.val.dtype, dev, A.val.shape[0], ptrs[0], ptrs[1],
                 _build.dtype_code(A.val.dtype) if cuda else -1, _build.sm_count(dev) if cuda else 0)
    if not traced:
        object.__setattr__(A, "_k5_operand", d)
    return d


def _check_vector(v, B, G, d: _Operand, name):
    if v.dtype != d.dtype or v.device != d.device or v.shape != (B, G):
        raise ValueError(
            f"{name}: vector {tuple(v.shape)} {v.dtype} on {v.device}, expected ({B}, {G}) {d.dtype} on {d.device}"
        )
    if d.cuda and not v.is_contiguous():
        raise ValueError(f"{name} takes contiguous tensors")


def _call(lib_fn, device, *args) -> int:
    """A launcher's call on the current stream of ``device``, under it
    unless it is the current device."""
    if device.index == torch.cuda.current_device():
        return lib_fn(*args, _build.raw_stream(device.index))
    with torch.cuda.device(device):
        return lib_fn(*args, _build.raw_stream(device.index))


# ---------------------------------------------------------------------------
# Jobs of the grouped kernel
# ---------------------------------------------------------------------------
class _Job(NamedTuple):
    op: _Operand
    mode: int
    copy: tuple | None  # (values pointer, pattern pointer, k) of the copy reduced (CUDA)
    g: torch.Tensor | None
    w: torch.Tensor | None
    R: int  # rows of the output
    empty: bool  # no rows or no columns: zeros, no launch
    plain: Callable[[], torch.Tensor]
    mat: tuple  # (values, pattern) of the copy reduced, as the operator takes it


def _gathering(name, mode, A, copy_t, g, G, R, plain, w=None):
    """The job of a product that gathers g (and w) of G entries into R
    rows of A's copy (of its transpose's with ``copy_t``)."""
    d = _operand(A, name)
    _check_vector(g, d.B, G, d, name)
    if w is not None:
        _check_vector(w, d.B, G, d, name)
    return _Job(d, mode, d.t if copy_t else d.rows, g, w, R, A.shape[0] == 0 or A.shape[1] == 0, plain,
                (A.t_val, A.t_idx) if copy_t else (A.val, A.idx))


def _job_matvec(A, x):
    m, n = A.shape
    return _gathering("ell_matvec", _SUM, A, False, x, n, m, lambda: ell_matvec_plain(A, x))


def _job_tmatvec(A, y, w=None):
    m, n = A.shape
    mode = _SUM if w is None else _WSUM
    return _gathering("ell_tmatvec", mode, A, True, y, m, n, lambda: ell_tmatvec_plain(A, y, w), w)


def _job_diagonal(P):
    d = _operand(P, "ell_diagonal")
    n = P.shape[0]
    return _Job(d, _DIAG, d.rows, None, None, n, n == 0, lambda: ell_diagonal_plain(P), (P.val, P.idx))


def _job_sq_colsums(A, w):
    m, n = A.shape
    return _gathering("ell_sq_colsums", _SQ, A, True, w, m, n, lambda: ell_sq_colsums_plain(A, w))


def _job_row_norms(A, col_w):
    m, n = A.shape
    return _gathering("ell_row_norms", _MAX, A, False, col_w, n, m, lambda: ell_row_norms_plain(A, col_w))


def _job_col_norms(A, row_w):
    m, n = A.shape
    return _gathering("ell_col_norms", _MAX, A, True, row_w, m, n, lambda: ell_col_norms_plain(A, row_w))


def _run(jobs) -> list:
    """The jobs' results: zeros for empty products, the plain versions on
    the CPU, one grouped launch per MAX_JOBS of the rest on the card: a
    ctypes launch, or for traced operands a call of the operator."""
    d = jobs[0].op
    if any(j.op.device != d.device or j.op.dtype != d.dtype or j.op.B != d.B for j in jobs):
        raise ValueError("ell_products: the operands differ in device, dtype or batch")
    zeros = lambda R: torch.zeros((d.B, R), dtype=d.dtype, device=d.device)
    if not d.cuda:
        return [zeros(j.R) if j.empty else j.plain() for j in jobs]
    op = any(j.op.rows is None for j in jobs)
    outs = [zeros(j.R) if j.empty or not d.B else None if op else
            torch.empty((d.B, j.R), dtype=d.dtype, device=d.device) for j in jobs]
    live = [i for i, j in enumerate(jobs) if not j.empty]
    if d.B:
        for c in range(0, len(live), MAX_JOBS):
            chunk = live[c:c + MAX_JOBS]
            if op:
                for i, out in zip(chunk, _group_op([jobs[i] for i in chunk], d)):
                    outs[i] = out
            else:
                _launch_group([jobs[i] for i in chunk], [outs[i] for i in chunk], d)
    return outs


def _group_op(jobs, d: _Operand) -> list:
    """One grouped launch through the operator
    (``torch.ops.osqp_tpu_torch.ell_group``): the jobs as tensor and int
    lists, from which the C++ side writes the launch's job words, and the
    plan of :func:`plan`; returns the jobs' outputs."""
    p = plan(tuple(j.R for j in jobs), d.B, d.sms)
    return list(_build.ops().ell_group(
        [j.mat[0] for j in jobs], [j.mat[1] for j in jobs], [j.g for j in jobs], [j.w for j in jobs],
        [j.mode for j in jobs], [j.R for j in jobs], list(p.tiles), list(p.cta0), p.rows, p.ipar, p.run, p.ctas,
        d.sms,
    ))


def _launch_group(jobs, outs, d: _Operand) -> None:
    global launches, launches_group
    p = plan(tuple(j.R for j in jobs), d.B, d.sms)
    words = []
    for j, out, tiles, cta0 in zip(jobs, outs, p.tiles, p.cta0):
        val, idx, k = j.copy
        if j.g is None:
            words += (val, idx, 0, 0, out.data_ptr(), j.R, k, 0, j.mode, tiles, cta0)
        else:
            w = j.w.data_ptr() if j.w is not None else 0
            words += (val, idx, j.g.data_ptr(), w, out.data_ptr(), j.R, k, j.g.shape[1], j.mode, tiles, cta0)
    code = _call(_build.library().osqp_ell_group, d.device, d.code, (ctypes.c_longlong * len(words))(*words),
                 len(jobs), d.B, p.rows, p.ipar, p.run, p.ctas)
    _build.check(code, "ell_group")
    launches += 1
    launches_group += 1


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------
def ell_matvec(A: ELLMatrix, x: torch.Tensor) -> torch.Tensor:
    """A x: (B, n) -> (B, m)."""
    return _run((_job_matvec(A, x),))[0]


def ell_tmatvec(A: ELLMatrix, y: torch.Tensor, w: torch.Tensor | None = None) -> torch.Tensor:
    """A'y through the stored transpose: (B, m) -> (B, n).  With ``w``
    (B, m), A'(w * y), the product w * y taken per slot and rounded as
    the elementwise product would be."""
    return _run((_job_tmatvec(A, y, w),))[0]


def ell_diagonal(P: ELLMatrix) -> torch.Tensor:
    """(B, n) diagonal of a square ELL matrix."""
    return _run((_job_diagonal(P),))[0]


def ell_sq_colsums(A: ELLMatrix, w: torch.Tensor) -> torch.Tensor:
    """(B, n) column sums  sum_i w_i A_ij^2  (the Jacobi preconditioner's
    term) through the transpose copy."""
    return _run((_job_sq_colsums(A, w),))[0]


def ell_row_norms(A: ELLMatrix, col_w: torch.Tensor) -> torch.Tensor:
    """(B, m) row inf-norms under a column weight: max_j |A_ij| col_w_j."""
    return _run((_job_row_norms(A, col_w),))[0]


def ell_col_norms(A: ELLMatrix, row_w: torch.Tensor) -> torch.Tensor:
    """(B, n) column inf-norms under a row weight: max_i row_w_i |A_ij|
    (through the transpose)."""
    return _run((_job_col_norms(A, row_w),))[0]


_JOBS = {ell_matvec: _job_matvec, ell_tmatvec: _job_tmatvec, ell_diagonal: _job_diagonal,
         ell_sq_colsums: _job_sq_colsums, ell_row_norms: _job_row_norms, ell_col_norms: _job_col_norms}


def ell_products(*calls) -> list:
    """Independent products in one launch: each call is ``(function,
    *arguments)`` of :func:`ell_matvec`, :func:`ell_tmatvec`,
    :func:`ell_diagonal`, :func:`ell_sq_colsums`, :func:`ell_row_norms` or
    :func:`ell_col_norms`, all on one device, dtype and batch.  Returns
    the results in order, each the bits of the function's own call (up
    to MAX_JOBS products a launch)."""
    jobs = []
    for f, *args in calls:
        if f not in _JOBS:
            raise TypeError(f"ell_products takes K5's product functions, not {f!r}")
        jobs.append(_JOBS[f](*args))
    return _run(jobs) if jobs else []


def ell_cg_start(P: ELLMatrix, A: ELLMatrix, w, x0, dinv, sigma, rhs_x, rhs_z=None, rho=None):
    """The CG's start from ``x0`` on M = P + sigma I + A' diag(w) A: returns
    (b, r, z) with b = rhs_x + A'(rho * rhs_z) (b = rhs_x without
    ``rhs_z``), r = b - M x0 and z = dinv r, each rounded as
    :func:`ell_cg_start_plain` composes them.  ``sigma`` is a host number
    (a float or a 0-d CPU tensor), rounded to the operands' dtype as
    PyTorch rounds a CPU scalar.  A must have rows (else M has no V p).
    On the card: P x0 and A x0 in one grouped launch, then one launch of
    the start kernel; traced, both through their operators (sigma as a
    one-element host tensor)."""
    global launches, launches_start
    name = "ell_cg_start"
    dA, dP = _operand(A, name), _operand(P, name)
    m, n = A.shape
    if m == 0 or tuple(P.shape) != (n, n) or dP.device != dA.device or dP.dtype != dA.dtype or dP.B != dA.B:
        raise ValueError(f"{name}: A {tuple(A.shape)} must have rows and P {tuple(P.shape)} be ({n}, {n}), "
                         "both on one device, dtype and batch")
    if (rhs_z is None) != (rho is None):
        raise ValueError(f"{name} takes rhs_z and rho together")
    B = dA.B
    vectors = [(x0, n), (dinv, n), (rhs_x, n), (w, m)] + ([(rhs_z, m), (rho, m)] if rhs_z is not None else [])
    for v, G in vectors:
        _check_vector(v, B, G, dA, name)
    if not dA.cuda or n == 0:
        return ell_cg_start_plain(P, A, w, x0, dinv, sigma, rhs_x, rhs_z, rho)
    Px0, Ax0 = _run((_job_matvec(P, x0), _job_matvec(A, x0)))
    if dA.rows is None or dP.rows is None:
        b, r, z = _build.ops().ell_cg_start(A.t_val, A.t_idx, rhs_x, rhs_z, rho, w, Ax0, Px0, x0, dinv,
                                            _build.setting(sigma), dA.sms)
        return (rhs_x if rhs_z is None else b), r, z
    r, z = torch.empty_like(x0), torch.empty_like(x0)
    b = rhs_x if rhs_z is None else torch.empty_like(x0)
    sig = float(sigma)
    if dA.dtype == torch.float32:
        sig = ctypes.c_float(sig).value
    t_val, t_idx, kt = dA.t
    ptr = lambda t: t.data_ptr() if t is not None else 0
    code = _call(_build.library().osqp_ell_cg_start, dA.device, dA.code, t_val, t_idx, kt, rhs_x.data_ptr(),
                 ptr(rhs_z), ptr(rho), w.data_ptr(), Ax0.data_ptr(), Px0.data_ptr(), x0.data_ptr(), dinv.data_ptr(),
                 sig, b.data_ptr(), r.data_ptr(), z.data_ptr(), B, n, m, dA.sms)
    _build.check(code, name)
    launches += 1
    launches_start += 1
    return b, r, z


def ell_scale(A: ELLMatrix, row_s: torch.Tensor, col_s: torch.Tensor, c: torch.Tensor | None = None) -> ELLMatrix:
    """diag(row_s) A diag(col_s), times c (B,) where given, on both
    copies of the values; traced, through the operator."""
    global launches, launches_scale
    m, n = A.shape
    d = _operand(A, "ell_scale")
    _check_vector(row_s, d.B, m, d, "ell_scale")
    _check_vector(col_s, d.B, n, d, "ell_scale")
    if c is not None:
        _check_vector(c[:, None], d.B, 1, d, "ell_scale")
    if m == 0 or n == 0:
        # every slot is padding: the scaled values are the zeros they were
        return dataclasses.replace(A, val=torch.zeros_like(A.val), t_val=torch.zeros_like(A.t_val))
    if not d.cuda:
        return ell_scale_plain(A, row_s, col_s, c)
    if d.rows is None:
        val, t_val = _build.ops().ell_scale(A.val, A.idx, A.t_val, A.t_idx, row_s, col_s, c)
        return dataclasses.replace(A, val=val, t_val=t_val)
    val = torch.empty_like(A.val)
    t_val = torch.empty_like(A.t_val)
    (v, i, ka), (tv, ti, kt) = d.rows, d.t
    code = _call(_build.library().osqp_ell_scale, d.device, d.code, v, i, tv, ti, row_s.data_ptr(),
                 col_s.data_ptr(), c.data_ptr() if c is not None else 0, val.data_ptr(), t_val.data_ptr(), d.B, m, ka,
                 n, kt)
    _build.check(code, "ell_scale")
    launches += 1
    launches_scale += 1
    return dataclasses.replace(A, val=val, t_val=t_val)


def ell_scale_rows(val, idx, t_val, t_idx, row_s_block, row_s, col_s, c=None):
    """:func:`ell_scale` of a matrix whose rows this caller holds only in
    part: ``val``, ``idx`` are a block of its rows (B, R, ka), ``t_val``,
    ``t_idx`` its whole transpose (B, n, kt), indexing all m rows;
    ``row_s_block`` (B, R) is the block's part of ``row_s`` (B, m).
    Returns the scaled (val, t_val), each value the bits :func:`ell_scale`
    gives it on the whole matrix.  On the card two launches of the scaling
    kernel, one over each copy."""
    global launches, launches_scale
    (B, R, ka), (n, kt), m = val.shape, t_idx.shape, row_s.shape[1]
    d = _operand(ELLMatrix(val, idx, t_val, t_idx, (R, n)), "ell_scale_rows")
    for v, G in ((row_s_block, R), (row_s, m), (col_s, n)) + (((c[:, None], 1),) if c is not None else ()):
        _check_vector(v, d.B, G, d, "ell_scale_rows")
    if not d.cuda:
        return ell_scale_rows_plain(val, idx, t_val, t_idx, row_s_block, row_s, col_s, c)
    outs = torch.empty_like(val), torch.empty_like(t_val)
    cp = c.data_ptr() if c is not None else 0
    # the block's rows (no transpose), then the transpose (no rows)
    for args in ((val, idx, t_val, t_idx, row_s_block, R, ka, 0), (val, idx, t_val, t_idx, row_s, m, 0, kt)):
        v, i, tv, ti, rs, rows, k_a, k_t = args
        code = _call(_build.library().osqp_ell_scale, d.device, d.code, v.data_ptr(), i.data_ptr(), tv.data_ptr(),
                     ti.data_ptr(), rs.data_ptr(), col_s.data_ptr(), cp, outs[0].data_ptr(), outs[1].data_ptr(), B,
                     rows, k_a, n, k_t)
        _build.check(code, "ell_scale_rows")
        launches += 1
        launches_scale += 1
    return outs


# ---------------------------------------------------------------------------
# Plain versions (an operand with no rows or columns gathers zeros: _take)
# ---------------------------------------------------------------------------
def _slot_sum(v: torch.Tensor) -> torch.Tensor:
    """(B, R, k) -> (B, R): the sum over the slots in slot order, from 0,
    as the kernel's thread adds them, so that the two agree bit for bit."""
    acc = torch.zeros(v.shape[:-1], dtype=v.dtype, device=v.device)
    for s in range(v.shape[-1]):
        acc = acc + v[..., s]
    return acc


def ell_matvec_plain(A: ELLMatrix, x: torch.Tensor) -> torch.Tensor:
    return _slot_sum(A.val * _take(x, A.idx))


def ell_tmatvec_plain(A: ELLMatrix, y: torch.Tensor, w: torch.Tensor | None = None) -> torch.Tensor:
    g = y if w is None else w * y
    return _slot_sum(A.t_val * _take(g, A.t_idx))


def ell_diagonal_plain(P: ELLMatrix) -> torch.Tensor:
    rows = torch.arange(P.shape[0], dtype=P.idx.dtype, device=P.idx.device)[:, None]
    return (P.val * (P.idx == rows).to(P.dtype)).sum(-1)


def ell_sq_colsums_plain(A: ELLMatrix, w: torch.Tensor) -> torch.Tensor:
    return _slot_sum(A.t_val * A.t_val * _take(w, A.t_idx))


def ell_row_norms_plain(A: ELLMatrix, col_w: torch.Tensor) -> torch.Tensor:
    return (A.val.abs() * _take(col_w, A.idx)).amax(-1)


def ell_col_norms_plain(A: ELLMatrix, row_w: torch.Tensor) -> torch.Tensor:
    return (A.t_val.abs() * _take(row_w, A.t_idx)).amax(-1)


def ell_cg_start_plain(P: ELLMatrix, A: ELLMatrix, w, x0, dinv, sigma, rhs_x, rhs_z=None, rho=None):
    """Plain version of :func:`ell_cg_start`: the cg backend's right-hand
    side (``linsys/cg.py:solve``) and the CG's start (``ops/cg.py:_start``)
    as they compose K5's plain products."""
    b = rhs_x if rhs_z is None else rhs_x + ell_tmatvec_plain(A, rhs_z, rho)
    Mx = ell_matvec_plain(P, x0) + sigma * x0
    Mx = Mx + ell_tmatvec_plain(A, ell_matvec_plain(A, x0), w)
    r = b - Mx
    return b, r, dinv * r


def ell_scale_plain(A: ELLMatrix, row_s, col_s, c=None) -> ELLMatrix:
    val = A.val * row_s[..., None] * _take(col_s, A.idx)
    t_val = A.t_val * col_s[..., None] * _take(row_s, A.t_idx)
    if c is not None:
        val = val * c[:, None, None]
        t_val = t_val * c[:, None, None]
    return dataclasses.replace(A, val=val, t_val=t_val)


def ell_scale_rows_plain(val, idx, t_val, t_idx, row_s_block, row_s, col_s, c=None):
    """Plain version of :func:`ell_scale_rows`: the two halves of
    :func:`ell_scale_plain`."""
    val = val * row_s_block[..., None] * _take(col_s, idx)
    t_val = t_val * col_s[..., None] * _take(row_s, t_idx)
    if c is not None:
        val = val * c[:, None, None]
        t_val = t_val * c[:, None, None]
    return val, t_val
