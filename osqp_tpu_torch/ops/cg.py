"""K6: the batched Jacobi-preconditioned conjugate gradient of the ``cg``
backend and of polish on ELL operands (counterpart of the loop of
``osqp_tpu/linsys/cg.py:122-169`` and of ``osqp_tpu/polish.py:_pcg``,
``:65-102``).

:func:`pcg_solve` solves M x = b for every instance, from ``x0`` (zeros
when None), to the relative tolerance ``tol_rel`` (B,) or ``max_iter``
steps, where M p = P p + sigma p + V p and ``products(p)`` returns
(P p, V p); V p is None where V is 0.  An instance whose r'r is at or
below its tolerance is frozen (alpha = 0), so its x stops changing bit
for bit.  :func:`cg_solve` is the ``cg`` backend's case,
M = P + sigma I + A' diag(rho) A; polish passes its own operator
(``osqp_tpu_torch.polish``).  On ELL operands the operator is an
:class:`EllOperator`, which names its form (the cg backend's
V p = A'(rho * A p) or polish's V p = A'(A p) / d); on dense ones a
:class:`DenseOperator` of batched GEMVs.

For CUDA tensors the path follows the operator's type, and each of the
two device loops runs the whole solve in one launch: each instance's
solve on one thread-block cluster, the products, the step and the stop
test on the device, and the host reads nothing until the end.

* An :class:`EllOperator` runs the loop in ``csrc/cg.cu``
  (:func:`pcg_solve_loop`, counted in ``launches_loop``): the instance's
  state in the cluster's shared memory, two cluster barriers and two
  waits for the partial sums a step.  :func:`loop_plan` cuts the batch
  over the card: the cluster size, the CTAs' width, whether the
  operands' rows stay in shared memory too, and the clusters at once.
* A :class:`DenseOperator` runs the loop in ``csrc/cg_dense.cu``
  (:func:`pcg_solve_dense_loop`, counted in ``launches_dense_loop``):
  each CTA's rows of P and A in its shared memory, brought in once per
  CG solve by bulk copies (or read from device memory at each step
  where they do not fit), the start's product too, one exchange of the
  products a step.  :func:`dense_loop_plan` cuts the batch; its products
  are summed in an order fixed by n and m (:meth:`DenseOperator.ordered`
  renders it), so every plan gives the same bits.

Each instance stops on its own, at its freeze or at ``max_iter``: a
frozen instance of a batch loop keeps its x, r and r'r bit for bit and
only its p moves, and the solve returns x and the steps alone, so this
changes no bit of the result (``csrc/cg.cu`` states the argument and,
for its loop, the one exception, a start whose r'r lies within a few
ulps of the tolerance).  Any other operator (a row-sharded A's products
and collectives, which a launch cannot wait on) takes
:func:`pcg_solve_stepwise`: each step's vector work is one call of the
step kernels (:func:`cg_step`, counted in ``launches``), and the host
tests "is any instance still live" once per :data:`CHUNK` steps, each
chunk clipped to the steps left below ``max_iter``.  A step taken after
every instance has converged has alpha = 0 everywhere and leaves x
unchanged, so both equal the JAX loop, which tests at every step.  For
CPU tensors :func:`pcg_solve_plain` runs the same loop in plain PyTorch,
testing at every step (or, with ``chunk``, as the stepwise path does).
With ``dot=kernel_dot`` it sums its inner products in the kernels'
order, so that over the same products the kernels and the plain loop
take the same steps to the same bits: the reference the card's tests
hold K6 to (the dense loop's with ``op.ordered`` as the products and
``start_dot=kernel_dot``, since that loop sums its start too).  By
default it sums as PyTorch does, the order the CPU path's parity with
the JAX package was set on: the CG is inexact, and the ADMM point moves
with the rounding of its sums (by 2e-6 in y at CVXQP2_S in float64 under
the kernel's order, past the 1e-6 those tests hold).

All return ``(x, steps)``: ``steps`` (B,) int32 counts the steps in
which each instance was live, so its maximum is the JAX loop's count.

In the traced program (:mod:`osqp_tpu_torch.program`) each device loop
is a call of its ``torch.library`` operator, ``cg_loop``
(:func:`pcg_solve_loop_op`: the same C entry on the same plan, sigma and
polish's ``div`` as one-element host tensors) or ``cg_dense_loop``
(:func:`pcg_solve_dense_loop_op`), and the plain loop a
:func:`osqp_tpu_torch.flow.while_loop` with the same stop test and
steps.  :func:`pcg_solve_stepwise_program` renders the stepwise path as
device control flow: a :func:`flow.while_loop` whose turn is
:data:`CHUNK` steps of the step operator ``cg_step`` (:func:`cg_step_op`,
functional: copies in, the new state out) with the stop test before it,
then the steps left below ``max_iter`` (fewer than :data:`CHUNK`) under a
:func:`flow.cond` on the same test, so the steps and bits of the live
chunks; no traced path calls it since the dense loop took the dense
operators.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from .. import _build, flow
from ..linalg import host_read, mat_tvec, mat_vec, vec_dot
from ..parallel.rows import RowSharded
from ..sparse_ops import ELLMatrix
from . import ell

# Steps between two host reads of the stop test.
CHUNK = 8
# The kernel's block size and its cap on the blocks of one instance
# (csrc/cg.cu: kThreads, kMaxParts), which fix the order of its sums.
_THREADS = 256
_MAX_PARTS = 64

launches = 0  # step launches (pcg_solve_stepwise)
launches_loop = 0  # loop launches, one per solve (pcg_solve_loop)
last_plan = None  # the plan of the last loop launch
launches_dense_loop = 0  # dense loop launches, one per solve (pcg_solve_dense_loop)
last_dense_plan = None  # the plan of the last dense loop launch


@dataclasses.dataclass(frozen=True)
class EllOperator:
    """p -> (P p, V p) on ELL operands, V p None when A has no rows: with
    ``w`` (B, m) the cg backend's V p = A'(w * A p) (K5's weighted
    transpose), else polish's V p = A'(A p) / ``div``, divided after the
    transposed product.  ``div`` is a host number (a float or a 0-d CPU
    tensor) in the operands' dtype; the products divide by a copy of it
    on the operands' device, elementwise and correctly rounded, as the
    loop divides (PyTorch would multiply a CUDA tensor by the reciprocal
    of a CPU scalar)."""

    P: ELLMatrix
    A: ELLMatrix
    w: torch.Tensor | None = None
    div: float | torch.Tensor | None = None

    def __post_init__(self):
        if (self.w is None) == (self.div is None):
            raise ValueError("EllOperator takes exactly one of w (the cg form) and div (polish's form)")
        if self.div is not None:
            if isinstance(self.div, torch.Tensor) and (self.div.device.type != "cpu" or self.div.ndim):
                raise ValueError("EllOperator: div is a host number")
            object.__setattr__(self, "_div", torch.as_tensor(self.div, dtype=self.P.dtype).to(self.P.device))

    def __call__(self, p):
        return self._products(p, ell.ell_matvec, ell.ell_tmatvec)

    def plain(self, p):
        """The same products through K5's plain versions."""
        return self._products(p, ell.ell_matvec_plain, ell.ell_tmatvec_plain)

    def _products(self, p, mv, tv):
        u = mv(self.P, p)
        if not self.A.shape[0]:
            return u, None
        if self.w is not None:
            return u, tv(self.A, mv(self.A, p), self.w)
        return u, tv(self.A, mv(self.A, p)) / self._div


def _operator(P, A, rho_vec, plain: bool):
    """p -> (P p, A'(rho * A p), None when A has no rows): an
    :class:`EllOperator` on ELL operands (with ``plain``, its plain
    products), a :class:`DenseOperator` on dense ones, and on a
    row-sharded A its products and collectives (a function, so the card
    steps it)."""
    if isinstance(A, RowSharded):
        return A.products(P, rho_vec)
    if isinstance(P, ELLMatrix) and isinstance(A, ELLMatrix):
        op = EllOperator(P, A, w=rho_vec)
        return op.plain if plain else op
    return DenseOperator(P, A, rho_vec)


@dataclasses.dataclass(frozen=True)
class DenseOperator:
    """p -> (P p, A'(w * A p)) on dense operands by batched GEMVs, V p
    None when A has no rows: the cg backend's form.  A dataclass and not a
    closure, so that a traced loop gets its tensors as operands."""

    P: torch.Tensor
    A: torch.Tensor
    w: torch.Tensor

    def __call__(self, p):
        return mat_vec(self.P, p), (mat_tvec(self.A, self.w * mat_vec(self.A, p)) if self.A.shape[-2] else None)

    def ordered(self, p):
        """The same products summed in the dense loop's order
        (csrc/cg_dense.cu), each product and sum rounded on its own: P p and
        A p a row at a time (:func:`_row_dots`), w * (A p), then
        A'(w * A p) over :func:`dense_slabs`' sub-slabs of A's rows, each
        column of a sub-slab summed over its rows in order, and the
        sub-slabs' partials, the 16 leaves of a pairwise tree (those past
        the sub-slabs +0), summed level by level.  The dense loop's plain
        twin: pcg_solve_plain(op.ordered, ..., dot=kernel_dot,
        start_dot=kernel_dot) takes its steps to its bits."""
        u = _row_dots(self.P, p)
        B, n = p.shape
        m = self.A.shape[-2]
        if not m:
            return u, None
        v = self.w * _row_dots(self.A, p)
        S, RS = dense_slabs(m)
        prod = torch.nn.functional.pad(self.A * v[:, :, None], (0, 0, 0, S * RS - m)).reshape(B, S, RS, n)
        acc = prod.new_zeros((B, S, n))
        for j in range(RS):
            acc = acc + prod[:, :, j]
        leaves = torch.nn.functional.pad(acc, (0, 0, 0, DENSE_SLABS - S))
        while leaves.shape[1] > 1:
            leaves = leaves[:, 0::2] + leaves[:, 1::2]
        return u, leaves[:, 0]


# A's rows fall in at most this many sub-slabs, the leaves of their
# partials' pairwise sum (csrc/cg_dense.cu: kSlabs); a CTA of a cluster of
# C (a power of two) takes 16 / C of them, a subtree
DENSE_SLABS = 16


def dense_slabs(m: int) -> tuple[int, int]:
    """(S, RS): the dense loop's S = min(16, m) sub-slabs of A's m rows,
    of RS = ceil(m / S) rows each (the last shorter); (0, 0) at m = 0."""
    if not m:
        return 0, 0
    S = min(DENSE_SLABS, m)
    return S, -(-m // S)


def _row_dots(M: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(B, R, n) x (B, n) -> (B, R), each row by one warp of the dense
    loop: lane l adds the products of entries l, l + 32, ... in order
    (+0 past n), then the warp's xor butterfly, lane 0's sum."""
    B, R, n = M.shape
    K = -(-n // 32)
    prod = torch.nn.functional.pad(M * p[:, None, :], (0, 32 * K - n)).reshape(B, R, K, 32)
    acc = prod.new_zeros((B, R, 32))
    for k in range(K):
        acc = acc + prod[:, :, k]
    return _lane0_of_butterfly(acc)


def _tol2(b, tol_rel):
    """The squared tolerances max((tol_rel |b|)^2, 1e-30)."""
    tol = tol_rel * torch.linalg.vector_norm(b, dim=-1)
    return torch.clamp(tol * tol, min=1e-30)


def _start(products, sigma, dinv, b, x0, tol_rel, start=None, dot=vec_dot):
    """x, r = b - M x, z = dinv r, p = z, rz, r'r (summed by ``dot``) and
    the squared tolerance max((tol_rel |b|)^2, 1e-30).  From x0 = None,
    x = 0 and r = b, with no product; from x0, (r, z) is ``start`` where
    the caller computed it, else K5's fused start
    (:func:`ell.ell_cg_start`) on the cg form of an :class:`EllOperator`
    with rows in A, else ``products(x0)`` composed with the vector work,
    to the same bits."""
    if x0 is None:
        x, r = torch.zeros_like(b), b.clone()
        z = dinv * r
    else:
        x = x0.clone()
        if start is None and isinstance(products, EllOperator) and products.w is not None and products.A.shape[0]:
            start = ell.ell_cg_start(products.P, products.A, products.w, x0, dinv, sigma, b)[1:]
        if start is None:
            u, v = products(x)
            Mx = u + sigma * x
            if v is not None:
                Mx = Mx + v
            r = b - Mx
            z = dinv * r
        else:
            r, z = start
    return x, r, z, z.clone(), dot(r, z), dot(r, r), _tol2(b, tol_rel)


def _validate(P, A, rho_vec, dinv, b, x0, tol_rel):
    dtype, dev = b.dtype, b.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"cg_solve takes float32 or float64, not {dtype}")
    if b.ndim != 2:
        raise ValueError(f"cg_solve takes b (B, n), not {tuple(b.shape)}")
    B, n = b.shape
    for name, t, shape in (("dinv", dinv, (B, n)), ("x0", x0, (B, n)), ("tol_rel", tol_rel, (B,)),
                           ("rho_vec", rho_vec, (B, A.shape[-2]))):
        if t is None:
            continue
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != dev:
            raise ValueError(f"cg_solve: {name} is {tuple(t.shape)} {t.dtype} on {t.device}, "
                             f"expected {shape} {dtype} on {dev}")
    for name, M in (("P", P), ("A", A)):
        if M.dtype != dtype or M.device != dev:
            raise ValueError(f"cg_solve: {name} is {M.dtype} on {M.device}, b is {dtype} on {dev}")


def cg_solve(P, A, sigma, rho_vec, dinv, b, x0, tol_rel, max_iter: int, start=None):
    """PCG on M = P + sigma I + A' diag(rho) A from ``x0`` (zeros when
    None); returns ``(x, steps)``.  ``sigma`` is a number or a 0-d host
    tensor; P and A are both dense or both ELL.  ``start``: (r, z) at x0
    where the caller computed them (:func:`ell.ell_cg_start`)."""
    _validate(P, A, rho_vec, dinv, b, x0, tol_rel)
    return pcg_solve(_operator(P, A, rho_vec, plain=b.device.type == "cpu"), sigma, dinv, b, tol_rel, max_iter, x0,
                     start)


def pcg_solve(products, sigma, dinv, b, tol_rel, max_iter: int, x0=None, start=None):
    """PCG on M p = P p + sigma p + V p with ``products(p)`` = (P p, V p)
    from ``x0`` (zeros when None, ``start`` as :func:`_start` takes it);
    returns ``(x, steps)``.  On a CPU ``b`` the plain loop; on a CUDA one
    the device loop for an :class:`EllOperator`, the dense loop for a
    :class:`DenseOperator`, else the step kernels step by step."""
    route = _route(products, b.device.type, _build.tracing(b))
    return route(products, sigma, dinv, b, tol_rel, max_iter, x0, start=start)


def _route(products, device_type: str, traced: bool = False):
    """The loop that :func:`pcg_solve` runs for ``products`` on a device
    of this type, in a trace where ``traced``."""
    if device_type == "cpu":
        return pcg_solve_plain
    if device_type != "cuda":
        raise ValueError(f"cg_solve runs on CPU or CUDA tensors, not {device_type}")
    if isinstance(products, EllOperator):
        return pcg_solve_loop
    if isinstance(products, DenseOperator):
        return pcg_solve_dense_loop_op if traced else pcg_solve_dense_loop
    return pcg_solve_stepwise_program if traced else pcg_solve_stepwise


def _check_cuda(name, tensors) -> None:
    if any(t.device.type != "cuda" for t in tensors):
        raise ValueError(f"{name} runs on CUDA tensors")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} takes contiguous tensors")


def pcg_solve_stepwise(products, sigma, dinv, b, tol_rel, max_iter: int, x0=None, start=None):
    """The solve on the card step by step: one :func:`cg_step` per step
    after ``products(p)``, the stop test read by the host once per
    :data:`CHUNK` steps (``linalg.host_read``, counted).  Takes any
    operator (a row-sharded A's products, dense GEMVs, or an
    :class:`EllOperator`'s K5 launches)."""
    _check_cuda("pcg_solve_stepwise", (b, dinv, tol_rel) + ((x0,) if x0 is not None else ()))
    x, r, z, p, rz, rr, tol2 = _start(products, sigma, dinv, b, x0, tol_rel, start)
    B, n = b.shape
    sigma = float(sigma)
    steps = torch.zeros(B, dtype=torch.int32, device=b.device)
    if n == 0:
        return x, steps
    rz_pair = torch.stack([rz, torch.empty_like(rz)])
    rr_pair = torch.stack([rr, torch.empty_like(rr)])
    Mp = torch.empty_like(b)
    parts = torch.empty((3, B, _build.library().osqp_cg_parts(n)), dtype=b.dtype, device=b.device)
    k, cur = 0, 0
    while k < max_iter and host_read((rr_pair[cur] > tol2).any()):
        for _ in range(min(CHUNK, max_iter - k)):
            u, v = products(p)
            cg_step(p, u, v, sigma, dinv, tol2, rz_pair, rr_pair, cur, Mp, x, r, z, parts, steps)
            cur = 1 - cur
            k += 1
    return x, steps


def pcg_solve_stepwise_program(products, sigma, dinv, b, tol_rel, max_iter: int, x0=None, start=None, step=None):
    """:func:`pcg_solve_stepwise` with its host reads as device control
    flow, as a traced program runs it: a :func:`flow.while_loop` of
    :data:`CHUNK` steps a turn while ``k`` lies below the last whole
    chunk and an instance is live, then the ``max_iter % CHUNK`` steps
    left under a :func:`flow.cond` on the same test: the live path's
    chunks, its steps and its bits.  ``step(p, u, v, sigma, dinv, tol2,
    rz, rr, x, r, z, steps)`` returns the new (p, x, r, z, rz, rr, steps):
    the step operator (:func:`cg_step_op`) by default.  Run eagerly, it
    reads the stop test on the host before each turn, once to leave the
    loop and, where ``max_iter % CHUNK`` > 0, once for the tail: the live
    path's reads and one more a solve with a tail."""
    x, r, z, p, rz, rr, tol2 = _start(products, sigma, dinv, b, x0, tol_rel, start)
    B, n = b.shape
    steps = torch.zeros(B, dtype=torch.int32, device=b.device)
    if n == 0:
        return x, steps
    step = cg_step_op if step is None else step
    whole, tail = divmod(int(max_iter), CHUNK)

    def run(count):
        def body(c, products, sigma, dinv, tol2):
            k, p, x, r, z, rz, rr, steps = c
            for _ in range(count):
                u, v = products(p)
                p, x, r, z, rz, rr, steps = step(p, u, v, sigma, dinv, tol2, rz, rr, x, r, z, steps)
            return k + count, p, x, r, z, rz, rr, steps

        return body

    def more(c, products, sigma, dinv, tol2):
        return (c[0] < whole * CHUNK) & (c[6] > tol2).any()

    consts = (products, sigma, dinv, tol2)
    c = (torch.zeros((), dtype=torch.int64, device=b.device), p, x, r, z, rz, rr, steps)
    if whole:
        c = flow.while_loop(more, run(CHUNK), c, consts)
    if tail:
        c = flow.cond((c[6] > tol2).any(), run(tail), lambda c, *_: c, (c, *consts))
    return c[2], c[7]


def cg_step_op(p, u, v, sigma, dinv, tol2, rz, rr, x, r, z, steps):
    """One step of K6 through its operator (``torch.ops.osqp_tpu_torch.
    cg_step``), functional: returns the new (p, x, r, z, rz, r'r, steps),
    the bits :func:`cg_step` writes in place and to the pairs' other
    slots; ``sigma`` a one-element host tensor.  Launches are not counted:
    a traced program runs it after the trace."""
    return tuple(_build.ops().cg_step(p, u, v, dinv, tol2, rz, rr, x, r, z, steps, _build.setting(sigma)))


def _ell_fields(M: ELLMatrix, name: str, B: int, rows: int, cols: int, dtype, device):
    if not isinstance(M, ELLMatrix):
        raise TypeError(f"pcg_solve_loop: {name} must be an ELLMatrix, not {type(M).__name__}")
    if tuple(M.shape) != (rows, cols) or M.batch != B:
        raise ValueError(f"pcg_solve_loop: {name} is {tuple(M.shape)} over {M.batch} instances, "
                         f"expected ({rows}, {cols}) over {B}")
    for t in (M.val, M.t_val):
        if t.dtype != dtype or t.device != device:
            raise ValueError(f"pcg_solve_loop: {name}'s values are {t.dtype} on {t.device}, expected {dtype} on {device}")
    for t in (M.idx, M.t_idx):
        if t.dtype != torch.int32 or t.device != device:
            raise ValueError(f"pcg_solve_loop: {name}'s pattern is {t.dtype} on {t.device}, expected int32 on {device}")
    return M.val, M.idx, M.t_val, M.t_idx


def pcg_solve_loop(op: EllOperator, sigma, dinv, b, tol_rel, max_iter: int, x0=None, start=None,
                   plan: "LoopPlan | None" = None):
    """The solve on the card in one launch of the loop kernel, for an
    :class:`EllOperator`: each instance on a thread-block cluster, its
    products, every step and its stop test on the device.  The start
    (from ``x0``, one product) is the stepwise path's.  ``plan``: the
    loop's cut of the batch, :func:`loop_plan`'s for this card by
    default."""
    global launches_loop, last_plan
    if not isinstance(op, EllOperator):
        raise TypeError(f"pcg_solve_loop takes an EllOperator, not {type(op).__name__}")
    B, n = b.shape
    m = op.A.shape[0] if isinstance(op.A, ELLMatrix) else op.A.shape[-2]
    dtype, dev = b.dtype, b.device
    operands = _ell_fields(op.P, "P", B, n, n, dtype, dev) + _ell_fields(op.A, "A", B, m, n, dtype, dev)
    vectors = [("dinv", dinv, (B, n)), ("tol_rel", tol_rel, (B,)), ("x0", x0, (B, n)), ("w", op.w, (B, m))]
    for name, t, shape in vectors:
        if t is not None and (tuple(t.shape) != shape or t.dtype != dtype or t.device != dev):
            raise ValueError(f"pcg_solve_loop: {name} is {tuple(t.shape)} {t.dtype} on {t.device}, "
                             f"expected {shape} {dtype} on {dev}")
    _check_cuda("pcg_solve_loop", (b,) + operands + tuple(t for _, t, _ in vectors if t is not None))
    if _build.tracing(b):
        return pcg_solve_loop_op(op, sigma, dinv, b, tol_rel, max_iter, x0, start, plan)
    x, r, z, p, rz, rr, tol2 = _start(op, sigma, dinv, b, x0, tol_rel, start)
    steps = torch.zeros(B + 1, dtype=torch.int32, device=dev)  # and the kernel's instance counter
    if B == 0 or n == 0 or max_iter <= 0:
        return x, steps[:B]
    P, A = op.P, op.A
    kp, ka, kt = P.idx.shape[1], A.idx.shape[1], A.t_idx.shape[1]
    plan = plan or _default_plan(op, b)
    Ap, Mp = torch.empty((B, m), dtype=dtype, device=dev), torch.empty_like(b)
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.osqp_cg_loop(
            _build.dtype_code(dtype), P.val.data_ptr(), P.idx.data_ptr(), kp, A.val.data_ptr(), A.idx.data_ptr(), ka,
            A.t_val.data_ptr(), A.t_idx.data_ptr(), kt, op.w.data_ptr() if op.w is not None else 0, float(sigma),
            float(op.div) if op.div is not None else 0.0, dinv.data_ptr(), tol2.data_ptr(), rz.data_ptr(),
            rr.data_ptr(), x.data_ptr(), r.data_ptr(), z.data_ptr(), p.data_ptr(), Ap.data_ptr(), Mp.data_ptr(),
            steps.data_ptr(), B, n, m, int(max_iter), plan.cluster, plan.threads, int(plan.resident),
            int(plan.vectors), plan.clusters, _build.stream(),
        )
    _build.check(code, "cg_loop")
    launches_loop += 1
    last_plan = plan
    return x, steps[:B]


def _default_plan(op: EllOperator, b) -> "LoopPlan":
    """:func:`loop_plan` for this solve on the card of ``b``."""
    B, n = b.shape
    dev = b.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return _planned(B, n, op.A.shape[0], op.P.idx.shape[1], op.A.idx.shape[1], op.A.t_idx.shape[1],
                    _build.dtype_code(b.dtype), index)


def pcg_solve_loop_op(op: EllOperator, sigma, dinv, b, tol_rel, max_iter: int, x0=None, start=None,
                      plan: "LoopPlan | None" = None):
    """:func:`pcg_solve_loop` through its operator
    (``torch.ops.osqp_tpu_torch.cg_loop``), as a traced program calls it:
    the same start, then the same C entry, which the operator gives
    copies of the start to write and a zeroed instance counter; sigma and
    polish's ``div`` reach it as one-element host tensors.  Returns
    ``(x, steps)``, the loop's bits.  Launches are not counted: the
    program runs it after the trace."""
    B, n = b.shape
    x, r, z, p, rz, rr, tol2 = _start(op, sigma, dinv, b, x0, tol_rel, start)
    if B == 0 or n == 0 or max_iter <= 0:
        return x, torch.zeros(B, dtype=torch.int32, device=b.device)
    plan = plan or _default_plan(op, b)
    P, A = op.P, op.A
    div = _build.setting(op.div) if op.div is not None else None
    x, steps = _build.ops().cg_loop(
        P.val, P.idx, A.val, A.idx, A.t_val, A.t_idx, op.w, _build.setting(sigma), div, dinv, tol2, rz, rr, x, r,
        z, p, int(max_iter), plan.cluster, plan.threads, int(plan.resident), int(plan.vectors), plan.clusters,
    )
    return x, steps


@dataclasses.dataclass(frozen=True)
class LoopPlan:
    """How the device loop cuts a batch over the card: clusters of
    ``cluster`` CTAs of ``threads`` threads and ``smem`` bytes of shared
    memory each, an instance's solve a cluster, ``clusters`` clusters at
    once; the operands' rows in shared memory when ``resident``, the
    vectors when ``vectors`` (else in device memory: n beyond the
    cluster's shared memory)."""

    cluster: int
    threads: int
    resident: bool
    vectors: bool
    smem: int
    clusters: int


# The cluster sizes the plan starts from, largest first (above 8 CTAs a
# cluster is non-portable).
LOOP_CLUSTERS = (16, 8, 4, 2, 1)
_MAX_PARTS_AT_ONCE = 4  # a CTA of 1024 threads


def loop_smem(n: int, m: int, kp: int, ka: int, kt: int, cluster: int, resident: bool, vectors: bool,
              itemsize: int) -> int:
    """Bytes of shared memory of one CTA of the loop (csrc/cg.cu:
    loop_smem): two mbarriers, the partials of every part, the warps'
    sums of the CTA's parts and 8 scalars; with ``vectors`` x, r, z, p,
    dinv and Mp of its entries and the weights and A p of its rows of A;
    with ``resident`` those rows of P, A' and A, values and int32
    pattern."""
    parts = parts_of(n)
    rounds = -(-n // (parts * _THREADS))
    qmax = -(-parts // cluster)
    E = qmax * _THREADS * rounds
    Rp = (-(-m // cluster) + 3) // 4 * 4 if m else 0
    vals = 3 * _MAX_PARTS + 2 * qmax * (_THREADS // 32) + 8
    pats = 0
    if vectors:
        vals += 6 * E + 2 * Rp
    if resident:
        pats = E * (kp + kt) + Rp * ka
        vals += pats
    return 16 + vals * itemsize + 4 * pats


def _clusters_estimate(cluster: int, threads: int, smem: int, sm_count: int) -> int:
    """Clusters the card holds at once, by its SMs' shared memory and
    threads alone (the card's own query also places clusters in GPCs)."""
    per_sm = min(_build.SMEM_PER_SM // (smem + _build.SMEM_RESERVED_PER_BLOCK), 2048 // threads, 32)
    return sm_count * per_sm // cluster


def loop_plan(B: int, n: int, m: int, kp: int, ka: int, kt: int, dtype, sm_count: int, active=None) -> LoopPlan:
    """The device loop's plan for B instances of n variables and m rows of
    A (ELL widths kp, ka and kt) in ``dtype`` on a card of ``sm_count``
    SMs; ``active(cluster, threads, smem, resident, vectors)`` gives the
    clusters the card holds at once (the CUDA occupancy query), estimated
    from the SMs' shared memory and threads without it.

    From each of :data:`LOOP_CLUSTERS` not above the parts, the fewest
    CTAs that keep its most parts a CTA (40 parts: 14 for 16); with it
    the first of operands and vectors resident, vectors alone, neither
    that fits a CTA's shared memory, and 256 threads a part up to four.
    Of those whose vectors fit (the vectors go to device memory only
    where no cluster holds them) the plan takes the fewest waves of
    clusters over the batch, and among them the largest cluster: at B = 1
    the widest spread of one instance, at large B clusters small enough
    that the batch runs at once.  Raises where no cluster fits the card."""
    itemsize = torch.empty((), dtype=getattr(torch, dtype) if isinstance(dtype, str) else dtype).element_size()
    parts = parts_of(n)
    plans = []
    for start in LOOP_CLUSTERS:
        if start > parts and start > 1:
            continue
        cluster = -(-parts // -(-parts // start))
        for resident, vectors in ((True, True), (False, True), (False, False)):
            smem = loop_smem(n, m, kp, ka, kt, cluster, resident, vectors, itemsize)
            if smem <= _build.SMEM_BYTES:
                break
        threads = _THREADS * min(_MAX_PARTS_AT_ONCE, -(-parts // cluster))
        fit = (active(cluster, threads, smem, resident, vectors) if active is not None
               else _clusters_estimate(cluster, threads, smem, sm_count))
        if fit < 1:
            continue
        plans.append(LoopPlan(cluster, threads, resident, vectors, smem, min(fit, B)))
    if not plans:
        raise RuntimeError(f"no plan of K6's device loop fits the card at n={n}, m={m}")
    if any(plan.vectors for plan in plans):
        plans = [plan for plan in plans if plan.vectors]
    return min(plans, key=lambda plan: (-(-B // plan.clusters), -plan.cluster))


@functools.lru_cache(maxsize=256)
def _planned(B: int, n: int, m: int, kp: int, ka: int, kt: int, code: int, index: int) -> LoopPlan:
    def active(cluster, threads, smem, resident, vectors):
        with torch.cuda.device(index):
            return _build.library().osqp_cg_loop_clusters(code, cluster, threads, smem, resident, vectors)

    dtype = torch.float32 if code == 0 else torch.float64
    return loop_plan(B, n, m, kp, ka, kt, dtype, _build.sm_count(index), active)


def _dense_fields(op: DenseOperator, name: str, dinv, b, tol_rel, x0):
    """Check the dense loop's operands and vectors; returns (B, n, m)."""
    if not isinstance(op, DenseOperator):
        raise TypeError(f"{name} takes a DenseOperator, not {type(op).__name__}")
    B, n = b.shape
    m = op.A.shape[-2]
    dtype, dev = b.dtype, b.device
    for t_name, t, shape in (("P", op.P, (B, n, n)), ("A", op.A, (B, m, n)), ("w", op.w, (B, m)),
                             ("dinv", dinv, (B, n)), ("tol_rel", tol_rel, (B,)), ("x0", x0, (B, n))):
        if t is not None and (tuple(t.shape) != shape or t.dtype != dtype or t.device != dev):
            raise ValueError(f"{name}: {t_name} is {tuple(t.shape)} {t.dtype} on {t.device}, "
                             f"expected {shape} {dtype} on {dev}")
    _check_cuda(name, (b, op.P, op.A, op.w, dinv, tol_rel) + ((x0,) if x0 is not None else ()))
    return B, n, m


def pcg_solve_dense_loop(op: DenseOperator, sigma, dinv, b, tol_rel, max_iter: int, x0=None, start=None,
                         plan: "LoopPlan | None" = None):
    """The solve on the card in one launch of the dense loop
    (csrc/cg_dense.cu), for a :class:`DenseOperator`: each instance on a
    thread-block cluster, its rows of P and A in shared memory where
    ``plan`` keeps them there, the start's product, every step and its
    stop test on the device.  ``plan``: :func:`dense_loop_plan`'s for
    this card by default.  The loop computes its own start: ``start``
    must be None."""
    global launches_dense_loop, last_dense_plan
    if start is not None:
        raise ValueError("pcg_solve_dense_loop computes its start on the device: start must be None")
    B, n, m = _dense_fields(op, "pcg_solve_dense_loop", dinv, b, tol_rel, x0)
    if _build.tracing(b):
        return pcg_solve_dense_loop_op(op, sigma, dinv, b, tol_rel, max_iter, x0, plan=plan)
    steps = torch.zeros(B + 1, dtype=torch.int32, device=b.device)  # and the kernel's instance counter
    if B == 0 or n == 0 or max_iter <= 0:
        return (x0.clone() if x0 is not None else torch.zeros_like(b)), steps[:B]
    tol2 = _tol2(b, tol_rel)
    plan = plan or _default_dense_plan(b, m)
    clusters = min(plan.clusters, B)
    lib = _build.library()
    code = _build.dtype_code(b.dtype)
    scratch = torch.empty(lib.osqp_cg_dense_loop_scratch(code, n, m, plan.cluster, int(plan.vectors), clusters),
                          dtype=torch.uint8, device=b.device)
    x = torch.empty_like(b)
    with torch.cuda.device(b.device):
        err = lib.osqp_cg_dense_loop(
            code, op.P.data_ptr(), op.A.data_ptr(), op.w.data_ptr(), float(sigma), dinv.data_ptr(), b.data_ptr(),
            x0.data_ptr() if x0 is not None else 0, tol2.data_ptr(), x.data_ptr(), steps.data_ptr(),
            scratch.data_ptr(), B, n, m, int(max_iter), plan.cluster, plan.threads, int(plan.resident),
            int(plan.vectors), clusters, _build.stream(),
        )
    _build.check(err, "cg_dense_loop")
    launches_dense_loop += 1
    last_dense_plan = plan
    return x, steps[:B]


def pcg_solve_dense_loop_op(op: DenseOperator, sigma, dinv, b, tol_rel, max_iter: int, x0=None, start=None,
                            plan: "LoopPlan | None" = None):
    """:func:`pcg_solve_dense_loop` through its operator
    (``torch.ops.osqp_tpu_torch.cg_dense_loop``), as a traced program
    calls it: the same squared tolerances, then the same C entry on the
    same plan, sigma as a one-element host tensor.  Returns ``(x,
    steps)``, the loop's bits.  Launches are not counted: the program runs
    it after the trace."""
    if start is not None:
        raise ValueError("pcg_solve_dense_loop_op computes its start on the device: start must be None")
    B, n = b.shape
    if B == 0 or n == 0 or max_iter <= 0:
        return (x0.clone() if x0 is not None else torch.zeros_like(b)), torch.zeros(B, dtype=torch.int32,
                                                                                     device=b.device)
    plan = plan or _default_dense_plan(b, op.A.shape[-2])
    x, steps = _build.ops().cg_dense_loop(
        op.P, op.A, op.w, _build.setting(sigma), dinv, b, x0, _tol2(b, tol_rel), int(max_iter), plan.cluster,
        plan.threads, int(plan.resident), int(plan.vectors), plan.clusters,
    )
    return x, steps


def _default_dense_plan(b, m: int) -> "LoopPlan":
    """:func:`dense_loop_plan` for this solve on the card of ``b``."""
    B, n = b.shape
    dev = b.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return _dense_planned(B, n, m, _build.dtype_code(b.dtype), index)


# Multiply-adds of a step that a CTA of the dense loop takes at least: a
# cluster spreads an instance no wider (n (n + 2 m) of them a step).
DENSE_MIN_WORK = 8192
# Threads an SM runs of the dense loop (csrc/cg_dense.cu: kDenseMaxThreads,
# also a CTA's most): up to 80 registers a thread in the SM's 65536.
_DENSE_THREADS_PER_SM = 768


def dense_loop_smem(n: int, m: int, cluster: int, resident: bool, vectors: bool, itemsize: int) -> int:
    """Bytes of shared memory of one CTA of the dense loop
    (csrc/cg_dense.cu: dense_smem): two mbarriers, 8 scalars, the partials
    and the warps' sums of two inner products by part; with ``vectors``
    x, r, z, p, dinv and Mp of all n entries, the weights and w * A p of
    its rows of A and its 16 / C leaves' partials; in a cluster of one the
    published products (P p and the tree's root); with ``resident`` its
    rows of P and of A, each in a 16-byte aligned buffer with 32 bytes to
    spare for the bulk copy's aligned window."""
    S, RS = dense_slabs(m)
    leaves = DENSE_SLABS // cluster
    rows_p, rows_a = -(-n // cluster), leaves * RS
    align = lambda v: -(-v // 16) * 16  # noqa: E731
    vals = 8 + 2 * _MAX_PARTS + 2 * parts_of(n) * (_THREADS // 32)
    if vectors:
        vals += (6 + leaves) * n + 2 * rows_a
    if cluster == 1:
        vals += 2 * n
    nbytes = align(16 + vals * itemsize)
    if resident:
        nbytes += align(itemsize * rows_p * n + 32) + align(itemsize * rows_a * n + 32)
    return nbytes


def dense_loop_plan(B: int, n: int, m: int, dtype, sm_count: int, active=None) -> LoopPlan:
    """The dense loop's plan for B instances of n variables and m rows of A
    in ``dtype`` on a card of ``sm_count`` SMs; ``active(cluster, threads,
    smem, resident, vectors)`` gives the clusters the card holds at once
    (the CUDA occupancy query), estimated from the SMs' shared memory and
    registers without it.

    Each of :data:`LOOP_CLUSTERS` that leaves a CTA at least
    :data:`DENSE_MIN_WORK` multiply-adds a step takes the first of rows
    and vectors resident, vectors alone, neither that fits a CTA's shared
    memory, and the widest CTA (256 threads up to 768) that keeps the
    CTAs an SM runs at once within its 768 threads.  Of those whose
    vectors fit the plan takes, as :func:`loop_plan` does, the fewest waves
    of clusters over the batch and among them the largest cluster, but a
    plan that holds the operands' rows goes first: it reads them once a
    CG solve, a streamed one at every step.  Raises where no cluster fits
    the card."""
    itemsize = torch.empty((), dtype=getattr(torch, dtype) if isinstance(dtype, str) else dtype).element_size()
    cap = max(1, n * (n + 2 * m) // DENSE_MIN_WORK)
    plans = []
    for cluster in LOOP_CLUSTERS:
        if cluster > cap:
            continue
        for resident, vectors in ((True, True), (False, True), (False, False)):
            smem = dense_loop_smem(n, m, cluster, resident, vectors, itemsize)
            if smem <= _build.SMEM_BYTES:
                break
        else:
            continue
        per_sm = _build.SMEM_PER_SM // (smem + _build.SMEM_RESERVED_PER_BLOCK)
        busy = min(per_sm, -(-B * cluster // sm_count))
        threads = _THREADS * max(1, _DENSE_THREADS_PER_SM // (_THREADS * busy))
        fit = (active(cluster, threads, smem, resident, vectors) if active is not None
               else sm_count * min(per_sm, _DENSE_THREADS_PER_SM // threads, 32) // cluster)
        if fit < 1:
            continue
        plans.append(LoopPlan(cluster, threads, resident, vectors, smem, min(fit, B)))
    if not plans:
        raise RuntimeError(f"no plan of K6's dense loop fits the card at n={n}, m={m}")
    if any(plan.vectors for plan in plans):
        plans = [plan for plan in plans if plan.vectors]
    return min(plans, key=lambda plan: (not plan.resident, -(-B // plan.clusters), -plan.cluster))


@functools.lru_cache(maxsize=256)
def _dense_planned(B: int, n: int, m: int, code: int, index: int) -> LoopPlan:
    def active(cluster, threads, smem, resident, vectors):
        with torch.cuda.device(index):
            return _build.library().osqp_cg_dense_loop_clusters(code, cluster, threads, smem, resident, vectors)

    dtype = torch.float32 if code == 0 else torch.float64
    return dense_loop_plan(B, n, m, dtype, _build.sm_count(index), active)


def cg_step(p, u, v, sigma, dinv, tol2, rz_pair, rr_pair, cur, Mp, x, r, z, parts, steps) -> None:
    """One launch of K6: the vector work of one step.  ``p``, ``x``,
    ``r``, ``z`` are updated in place; rz and r'r go to slot ``1 - cur``
    of their pairs."""
    global launches
    B, n = p.shape
    nxt = 1 - cur
    lib = _build.library()
    with torch.cuda.device(p.device):
        code = lib.osqp_cg_step(
            _build.dtype_code(p.dtype), p.data_ptr(), u.data_ptr(), v.data_ptr() if v is not None else 0,
            dinv.data_ptr(), tol2.data_ptr(), rz_pair[cur].data_ptr(), rr_pair[cur].data_ptr(), Mp.data_ptr(),
            x.data_ptr(), r.data_ptr(), z.data_ptr(), rz_pair[nxt].data_ptr(), rr_pair[nxt].data_ptr(),
            parts.data_ptr(), steps.data_ptr(), sigma, B, n, _build.stream(),
        )
    _build.check(code, "cg_step")
    launches += 1


def cg_solve_plain(P, A, sigma, rho_vec, dinv, b, x0, tol_rel, max_iter: int, chunk: int = 1, dot=vec_dot):
    """Plain PyTorch version of :func:`cg_solve`: :func:`pcg_solve_plain`
    over K5's plain products."""
    return pcg_solve_plain(_operator(P, A, rho_vec, plain=True), sigma, dinv, b, tol_rel, max_iter, x0, chunk, dot)


def pcg_solve_plain(products, sigma, dinv, b, tol_rel, max_iter: int, x0=None, chunk: int = 1, dot=vec_dot,
                    start=None, start_dot=vec_dot):
    """Plain PyTorch version of :func:`pcg_solve`.  The stop test runs
    before every ``chunk``-th step (every step by default, as the JAX
    loops have it; ``chunk=CHUNK`` as the kernel path has it); ``dot``
    sums the steps' inner products and ``start_dot`` the start's
    (:func:`kernel_dot`: in the kernel's order; the dense loop sums both
    so, the other paths the steps' alone)."""
    x, r, z, p, rz, rr, tol2 = _start(products, sigma, dinv, b, x0, tol_rel, start, start_dot)
    steps = torch.zeros(b.shape[0], dtype=torch.int32, device=b.device)
    if flow.in_program():
        return _plain_program(products, sigma, dinv, tol2, int(max_iter), chunk, dot, (x, r, z, p, rz, rr, steps))
    for k in range(int(max_iter)):
        if k % chunk == 0 and not bool((rr > tol2).any()):
            break
        steps += (rr > tol2).to(torch.int32)
        x, r, z, p, rz, rr = cg_step_plain(p, *products(p), sigma, dinv, x, r, rz, rr, tol2, dot)
    return x, steps


def _plain_program(products, sigma, dinv, tol2, max_iter: int, chunk: int, dot, state):
    """The loop of :func:`pcg_solve_plain` in the traced program: a
    :func:`flow.while_loop` with the same stop test (before every
    ``chunk``-th step) and the same steps, so the same bits.  The
    operator, sigma, dinv and the tolerances are the loop's constants."""

    def more(c, products, sigma, dinv, tol2):
        k, rr = c[0], c[6]
        go = (rr > tol2).any()
        if chunk > 1:
            go = go | (k % chunk != 0)
        return (k < max_iter) & go

    def body(c, products, sigma, dinv, tol2):
        k, x, r, z, p, rz, rr, steps = c
        steps = steps + (rr > tol2).to(torch.int32)
        x, r, z, p, rz, rr = cg_step_plain(p, *products(p), sigma, dinv, x, r, rz, rr, tol2, dot)
        return k + 1, x, r, z, p, rz, rr, steps

    k = torch.zeros((), dtype=torch.int64, device=dinv.device)
    out = flow.while_loop(more, body, (k, *state), (products, sigma, dinv, tol2))
    return out[1], out[7]


def parts_of(n: int) -> int:
    """Blocks over which the kernel cuts one instance of n variables."""
    return min(max(-(-n // _THREADS), 1), _MAX_PARTS)


def _lane0_of_butterfly(v: torch.Tensor) -> torch.Tensor:
    """(..., 32) -> (...,): lane 0's value after a warp's xor butterfly
    of sums, each lane adding its partner's value at offsets 16..1."""
    lanes = torch.arange(32, device=v.device)
    for off in (16, 8, 4, 2, 1):
        v = v + v[..., lanes ^ off]
    return v[..., 0]


def _block_sum(v: torch.Tensor) -> torch.Tensor:
    """(..., 256) -> (...,): the kernel's block_sum, a butterfly in each
    warp and then over the warps' sums."""
    w = _lane0_of_butterfly(v.reshape(v.shape[:-1] + (_THREADS // 32, 32)))
    return _lane0_of_butterfly(torch.cat([w, w.new_zeros(w.shape[:-1] + (32 - w.shape[-1],))], -1))


def kernel_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched inner product (B, n) x (B, n) -> (B,), summed in the order
    of csrc/cg.cu: each thread adds its products in a grid-stride loop,
    each block sums its threads, and the blocks' partials are summed in a
    fixed order.  Each product and sum is rounded on its own."""
    B, n = a.shape
    parts = parts_of(n)
    stride = parts * _THREADS
    steps = -(-n // stride)
    prod = torch.nn.functional.pad(a * b, (0, steps * stride - n)).reshape(B, steps, parts, _THREADS)
    acc = torch.zeros((B, parts, _THREADS), dtype=a.dtype, device=a.device)
    for k in range(steps):
        acc = acc + prod[:, k]
    partials = _block_sum(acc)
    return _block_sum(torch.nn.functional.pad(partials, (0, _THREADS - parts)))


def cg_step_plain(p, u, v, sigma, dinv, x, r, rz, rr, tol2, dot=vec_dot):
    """Plain PyTorch version of one K6 step (:func:`cg_step`): from the
    direction ``p`` and its products ``u`` = P p and ``v`` = A'(rho A p)
    (None without constraints), returns the next (x, r, z, p, rz, r'r).
    With ``dot=kernel_dot`` its inner products are summed in the kernel's
    order, and from the same products the two give the same bits."""
    Mp = u + sigma * p
    if v is not None:
        Mp = Mp + v
    denom = dot(p, Mp)
    alpha = rz / torch.where(denom > 0, denom, torch.ones_like(denom))
    alpha = torch.where(rr > tol2, alpha, torch.zeros_like(alpha))[:, None]
    x = x + alpha * p
    r = r - alpha * Mp
    z = dinv * r
    rz_new = dot(r, z)
    beta = (rz_new / torch.where(rz > 0, rz, torch.ones_like(rz)))[:, None]
    return x, r, z, z + beta * p, rz_new, dot(r, r)
