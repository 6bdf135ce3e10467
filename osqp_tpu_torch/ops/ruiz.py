"""K4: modified Ruiz equilibration, dense (counterpart of
``osqp_tpu/scaling.py:51-130``; reference src/scaling.c:44-156).

:func:`ruiz` is the kernel's wrapper: for CUDA tensors it launches the
hand-written kernels in ``csrc/ruiz.cu``, which take each sweep's
column and row maxima of the scaled KKT matrix straight from P and A
(no scaled temporaries) and write c·DPD, EAD, c·Dq, El and Eu in one
final pass; for CPU tensors it runs :func:`ruiz_plain`, the same
function in plain PyTorch.

Two paths on the card.  Where one instance's P and A fit the shared
memory of a thread-block cluster (:func:`cluster_size` > 0), the
resident path holds them there through all sweeps and reads each value
from device memory once; otherwise the split path spreads an instance
over blocks and re-reads P and A each sweep.  ``launches`` counts every
launch, ``launches_resident`` those that took the resident path.

The maxima do not depend on their order, and the cost normalisation's
mean is taken as the same pairwise sum (:func:`tree_sum`) in both
versions, so c, D and E come out equal bit for bit on one device.

The split path's kernels also run one step at a time, each behind a C
entry of its own (:func:`sweep_a`, :func:`update_de`, :func:`sweep_p`,
:func:`apply`, :func:`apply_vectors`, counted in ``launches_sweep``), for
a caller whose A is cut into row blocks that no one launch sees:
:func:`ruiz_sweeps` runs the sweeps from the host and asks the caller for
the maxima over all of A's rows at each sweep
(:mod:`osqp_tpu_torch.parallel.rows` merges them across processes).  The
maxima do not depend on how the rows are cut, so the steps give the
split path's c, D and E bit for bit.  Each step's plain version is the
same step of :func:`ruiz_plain`, so that composed they give its bits.
"""

from __future__ import annotations

import torch

from .. import _build
from ..constants import MAX_SCALING, MIN_SCALING

# Shared-memory bound of the kernel's pairwise sum: one value per
# column, padded to a power of two.
_MAX_N = 16384
# The resident path: a lane keeps up to 16 columns (n <= 512), clusters
# of 1, 2, 4 or 8 CTAs (8 is the portable limit), and a CTA's share of
# shared memory small enough that two fit one SM.
_RESIDENT_MAX_N = 512
_WARPS = 8  # warps of a CTA (csrc/common.cuh kWarps)
_CLUSTERS = (1, 2, 4, 8)
CTA_BUDGET = _build.SMEM_PER_SM // 2 - _build.SMEM_RESERVED_PER_BLOCK

launches = 0
launches_resident = 0
launches_sweep = 0  # launches of the step entries (sweep_a, update_de, sweep_p, apply, apply_vectors)


def _resident_bytes(n: int, m: int, k: int, elt: int) -> int:
    """Shared memory of one CTA of the resident path with clusters of k
    CTAs (``Resident`` in csrc/ruiz.cu): a 16-byte mbarrier slot, then
    regions of values, each rounded up to 16 bytes: the shares of P and A
    (with 16 bytes of slack on each side for their aligned bulk copies),
    D, Pcol, |q|, two sets of column maxima of A and of P, the pairwise
    sum's n values padded to a power of two, E and the row maxima of the
    CTA's rows of A, and a value per warp."""
    pad = 16 // elt
    rows_p, rows_a = -(-n // k), -(-m // k)
    width = 1 << max(n - 1, 0).bit_length()
    regions = (rows_p * n + 2 * pad, rows_a * n + 2 * pad, n, n, n, 2 * n, 2 * n, width, rows_a, rows_a, _WARPS)
    return 16 + elt * sum(-(-r // pad) * pad for r in regions)


def fits(n: int, m: int, k: int, dtype) -> bool:
    """Can the resident path run with clusters of k CTAs at all (one CTA
    per SM at most, where the share is above :data:`CTA_BUDGET`)?"""
    elt = torch.empty((), dtype=dtype).element_size()
    return k in _CLUSTERS and 1 <= n <= _RESIDENT_MAX_N and _resident_bytes(n, m, k, elt) <= _build.SMEM_BYTES


def resident_clusters(n: int, m: int, k: int, dtype) -> int:
    """How many clusters of k CTAs of the resident path the current CUDA
    card holds at once (the CUDA occupancy query)."""
    return _build.library().osqp_ruiz_resident_clusters(_build.dtype_code(dtype), n, m, k)


def cluster_size(n: int, m: int, dtype) -> int:
    """CTAs per cluster of K4's resident path for instances of n
    variables and m constraints: the smallest of 1, 2, 4, 8 whose
    per-CTA share fits :data:`CTA_BUDGET`, or 0 where none does (the
    split path)."""
    elt = torch.empty((), dtype=dtype).element_size()
    if not 1 <= n <= _RESIDENT_MAX_N:
        return 0
    for k in _CLUSTERS:
        if _resident_bytes(n, m, k, elt) <= CTA_BUDGET:
            return k
    return 0


def limit_scaling(v: torch.Tensor) -> torch.Tensor:
    """scaling.c:7-14: values below MIN_SCALING -> 1, above MAX_SCALING -> MAX."""
    v = torch.where(v < MIN_SCALING, torch.ones_like(v), v)
    return torch.clamp(v, max=MAX_SCALING)


def tree_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis as a fixed pairwise tree: zero-padded to a
    power of two, then the upper half added onto the lower half until
    one value is left.  The kernel sums in this order too."""
    n = v.shape[-1]
    width = 1 << max(n - 1, 0).bit_length()
    if width > n:
        v = torch.nn.functional.pad(v, (0, width - n))
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = v[..., :h] + v[..., h:]
    return v[..., 0]


def _validate(P, q, A, l, u) -> None:
    dtype = q.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"ruiz takes float32 or float64, not {dtype}")
    if q.ndim != 2 or l.ndim != 2:
        raise ValueError("ruiz takes q (B, n) and l (B, m)")
    (B, n), m = q.shape, l.shape[1]
    shapes = {"P": (P, (B, n, n)), "A": (A, (B, m, n)), "l": (l, (B, m)), "u": (u, (B, m))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"ruiz: {name} has shape {tuple(t.shape)}, expected {shape}")
        if t.device != q.device:
            raise ValueError(f"ruiz: {name} is on {t.device}, q on {q.device}")
        if t.dtype != dtype:
            raise TypeError(f"ruiz: {name} is {t.dtype}, q is {dtype}")
    if not 1 <= n <= _MAX_N:
        raise ValueError(f"ruiz takes 1 <= n <= {_MAX_N}, got n = {n}")


def ruiz(P, q, A, l, u, n_iters: int):
    """``n_iters`` Ruiz sweeps and the final scaling.  Returns
    (c (B,), D (B, n), E (B, m), c·DPD, c·Dq, EAD, El, Eu)."""
    _validate(P, q, A, l, u)
    if q.device.type == "cpu":
        return ruiz_plain(P, q, A, l, u, n_iters)
    if q.device.type != "cuda":
        raise ValueError(f"ruiz runs on CPU or CUDA tensors, not {q.device}")
    if not all(t.is_contiguous() for t in (P, q, A, l, u)):
        raise ValueError("ruiz takes contiguous tensors")
    (B, n), m = q.shape, l.shape[1]
    cluster = cluster_size(n, m, q.dtype)
    if _build.tracing(q):
        return ruiz_op(P, q, A, l, u, n_iters, cluster)
    return launch(P, q, A, l, u, n_iters, cluster)


def ruiz_op(P, q, A, l, u, n_iters: int, cluster: int):
    """:func:`launch` through the operator ``torch.ops.osqp_tpu_torch.ruiz``
    (what a traced program calls; the same C entry, the same bits)."""
    (B, n), m = q.shape, l.shape[1]
    _, rows_a, rows_p = (0, 0, 0) if cluster else _build.split_geometry(B, n, m, q.device)
    return tuple(_build.ops().ruiz(P, q, A, l, u, int(n_iters), int(cluster), rows_a, rows_p))


def launch(P, q, A, l, u, n_iters: int, cluster: int):
    """The kernel on validated contiguous CUDA tensors: the resident path
    with clusters of ``cluster`` CTAs, or the split path where it is 0.
    :func:`ruiz` chooses; a caller may name another cluster size that
    fits (``chip_smoke.py`` times them)."""
    global launches, launches_resident
    B, n = q.shape
    m = l.shape[1]
    dtype, dev = q.dtype, q.device
    if dev.type != "cuda":
        raise ValueError(f"ruiz.launch runs the kernel on CUDA tensors, not {dev}")
    if cluster and not fits(n, m, cluster, dtype):
        raise ValueError(f"ruiz: no resident path with clusters of {cluster} at n = {n}, m = {m} in {dtype}")
    c = torch.ones(B, dtype=dtype, device=dev)
    D = torch.ones((B, n), dtype=dtype, device=dev)
    E = torch.ones((B, m), dtype=dtype, device=dev)
    outs = tuple(torch.empty_like(t) for t in (P, q, A, l, u))
    if cluster:
        scratch, rows_a, rows_p = (None,) * 4, 0, 0
    else:
        # Scratch: the maxima as bit patterns (zero = +0.0) and P's column norm.
        col_a, col_p, p_col = (torch.zeros((B, n), dtype=dtype, device=dev) for _ in range(3))
        row_a = torch.zeros((B, m), dtype=dtype, device=dev)
        scratch = tuple(t.data_ptr() for t in (col_a, row_a, col_p, p_col))
        _, rows_a, rows_p = _build.split_geometry(B, n, m, dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.osqp_ruiz(
            _build.dtype_code(dtype),
            *(t.data_ptr() for t in (P, q, A, l, u)),
            *(t.data_ptr() for t in (c, D, E)),
            *(t.data_ptr() for t in outs),
            *scratch,
            int(n_iters), B, n, m, rows_a, rows_p, int(cluster), _build.stream(),
        )
    _build.check(code, "ruiz")
    launches += 1
    launches_resident += bool(cluster)
    Ps, qs, As, ls, us = outs
    return c, D, E, Ps, qs, As, ls, us


def ruiz_plain(P, q, A, l, u, n_iters: int):
    """Plain PyTorch version of :func:`ruiz`.  The sweeps only read P and
    A: the accumulated (c, D, E) are folded into the norms, and the
    cost-normalisation norm of one sweep is the P norm of the next."""
    B, n = q.shape
    m = l.shape[-1]
    dtype, dev = q.dtype, q.device
    absP = P.abs()
    absA = A.abs()
    ones = lambda *s: torch.ones(s, dtype=dtype, device=dev)

    def p_colmax(D):
        """colmax_j(D_i |P_ij|) * D_j, the c-free column norm of DPD."""
        return (absP * D[:, :, None]).amax(-2) * D

    c, D, E = ones(B), ones(B, n), ones(B, m)
    Pcol = p_colmax(D)
    for _ in range(n_iters):
        Pn = Pcol * c[:, None]
        if m:
            An_col = (absA * E[:, :, None]).amax(-2) * D
            e_norm = (absA * D[:, None, :]).amax(-1) * E
            d_norm = torch.maximum(Pn, An_col)
        else:
            e_norm = torch.zeros((B, m), dtype=dtype, device=dev)
            d_norm = Pn
        D = D * (1.0 / torch.sqrt(limit_scaling(d_norm)))
        E = E * (1.0 / torch.sqrt(limit_scaling(e_norm)))

        # Cost normalisation (scaling.c:110-141) on the scaled P, q.
        Pcol = p_colmax(D)
        # Divided by a tensor: PyTorch multiplies by the reciprocal of a
        # Python-number divisor on the card, which may round differently.
        c_temp = tree_sum(Pcol * c[:, None]) / torch.full_like(c, n)
        inf_norm_q = limit_scaling((q.abs() * D).amax(-1) * c)
        c_temp = limit_scaling(torch.maximum(c_temp, inf_norm_q))
        c = c / c_temp

    return (
        c,
        D,
        E,
        c[:, None, None] * (D[:, :, None] * P * D[:, None, :]),
        c[:, None] * (D * q),
        E[:, :, None] * A * D[:, None, :],
        E * l,
        E * u,
    )


# ---------------------------------------------------------------------------
# The split path one step at a time
# ---------------------------------------------------------------------------
def _step(name: str, fn, device, *args) -> None:
    """One C entry of the step kernels on the current stream of ``device``."""
    global launches_sweep
    with torch.cuda.device(device):
        code = fn(*args, _build.stream())
    _build.check(code, name)
    launches_sweep += 1


def _on_card(name: str, tensors) -> bool:
    """True for CUDA tensors (contiguous, checked), False for CPU ones."""
    dev = tensors[0].device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA tensors, not {dev}")
    if any(t.device != dev or t.dtype != tensors[0].dtype or not t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} takes contiguous tensors of one dtype on one device")
    return True


def _ptr(t) -> int:
    return t.data_ptr() if t is not None else 0


def sweep_a(A, E, D):
    """The maxima over a block of R rows of A, (B, R, n), with E's rows of
    the block (B, R) and D (B, n): ``(col, row)`` with col (B, n) =
    max_i E_i |A_ij| over the block's rows and row (B, R) = max_j |A_ij| D_j.
    Both are non-negative, so their bits order as integers do."""
    if not _on_card("ruiz.sweep_a", (A, E, D)):
        return sweep_a_plain(A, E, D)
    B, R, n = A.shape
    col = torch.zeros((B, n), dtype=A.dtype, device=A.device)
    row = torch.zeros((B, R), dtype=A.dtype, device=A.device)
    _, rows, _ = _build.split_geometry(B, n, R, A.device)
    _step("ruiz_sweep_a", _build.library().osqp_ruiz_sweep_a, A.device, _build.dtype_code(A.dtype), A.data_ptr(),
          E.data_ptr(), D.data_ptr(), col.data_ptr(), row.data_ptr(), B, R, n, rows)
    return col, row


def update_de(c, p_col, col, row, D, E):
    """One sweep's (D, E) from c, P's column norm ``p_col`` and the maxima
    over all of A's rows, ``col`` (B, n) and ``row`` (B, m) (None without
    rows).  On the card the kernel zeroes ``col`` and ``row``."""
    if not _on_card("ruiz.update_de", (c, p_col, D, E) + tuple(t for t in (col, row) if t is not None)):
        return update_de_plain(c, p_col, col, row, D, E)
    D, E = D.clone(), E.clone()
    (B, n), m = D.shape, E.shape[1]
    _step("ruiz_update", _build.library().osqp_ruiz_update, D.device, _build.dtype_code(D.dtype), c.data_ptr(),
          p_col.data_ptr(), _ptr(col), _ptr(row), D.data_ptr(), E.data_ptr(), B, n, m)
    return D, E


def sweep_p(P, q, D, c, update_cost: bool):
    """P's column norm under D, (max_i D_i |P_ij|) D_j, and with
    ``update_cost`` the cost normalisation of c: returns (p_col, c)."""
    if not _on_card("ruiz.sweep_p", (P, q, D, c)):
        return sweep_p_plain(P, q, D, c, update_cost)
    B, n = q.shape
    col_p = torch.zeros((B, n), dtype=q.dtype, device=q.device)
    p_col = torch.empty_like(col_p)
    c = c.clone()
    _, _, rows_p = _build.split_geometry(B, n, n, q.device)
    _step("ruiz_sweep_p", _build.library().osqp_ruiz_sweep_p, q.device, _build.dtype_code(q.dtype), P.data_ptr(),
          q.data_ptr(), D.data_ptr(), col_p.data_ptr(), p_col.data_ptr(), c.data_ptr(), B, n, rows_p,
          int(update_cost))
    return p_col, c


def apply(M, left, right, scale=None):
    """scale_b ((left_i M_ij) right_j) over (B, R, C); ``scale`` (B,) or None."""
    if not _on_card("ruiz.apply", (M, left, right) + ((scale,) if scale is not None else ())):
        return apply_plain(M, left, right, scale)
    B, R, C = M.shape
    out = torch.empty_like(M)
    _step("ruiz_apply", _build.library().osqp_ruiz_apply, M.device, _build.dtype_code(M.dtype), M.data_ptr(),
          left.data_ptr(), right.data_ptr(), _ptr(scale), out.data_ptr(), B, R, C)
    return out


def apply_vectors(q, l, u, c, D, E):
    """(c (D q), E l, E u)."""
    if not _on_card("ruiz.apply_vectors", (q, l, u, c, D, E)):
        return apply_vectors_plain(q, l, u, c, D, E)
    (B, n), m = q.shape, l.shape[1]
    qs, ls, us = torch.empty_like(q), torch.empty_like(l), torch.empty_like(u)
    _step("ruiz_apply_vectors", _build.library().osqp_ruiz_apply_vectors, q.device, _build.dtype_code(q.dtype),
          *(t.data_ptr() for t in (q, l, u, c, D, E, qs, ls, us)), B, n, m)
    return qs, ls, us


def ruiz_sweeps(P, q, m: int, n_iters: int, a_maxima):
    """``n_iters`` sweeps of the split path, step by step: returns (c, D,
    E).  ``a_maxima(E, D)`` returns the maxima over all m rows of A,
    ``(col (B, n), row (B, m))`` as :func:`sweep_a` gives them for a block;
    it is not called when m is 0."""
    B, n = q.shape
    ones = lambda *s: torch.ones(s, dtype=q.dtype, device=q.device)
    c, D, E = ones(B), ones(B, n), ones(B, m)
    p_col, _ = sweep_p(P, q, D, c, update_cost=False)
    for _ in range(n_iters):
        col, row = a_maxima(E, D) if m else (None, None)
        D, E = update_de(c, p_col, col, row, D, E)
        p_col, c = sweep_p(P, q, D, c, update_cost=True)
    return c, D, E


def merge_maxima(a, b):
    """The larger of two sets of maxima, taken on their bits as an
    all-reduce of a signed-integer view takes it."""
    view = torch.int32 if a.dtype == torch.float32 else torch.int64
    return torch.maximum(a.view(view), b.view(view)).view(a.dtype)


def ruiz_blocks(P, q, blocks, l, u, n_iters: int):
    """:func:`ruiz` with A given as row blocks (a list of (B, R_k, n)),
    the steps run on each block and their maxima merged in one process
    as :mod:`osqp_tpu_torch.parallel.rows` merges them across processes.
    Returns (c, D, E, c·DPD, c·Dq, [E_k A_k D], El, Eu), the scaled A as
    the list of its scaled blocks."""
    starts = [0]
    for blk in blocks:
        starts.append(starts[-1] + blk.shape[1])
    m = starts[-1]

    def a_maxima(E, D):
        col, rows = None, []
        for blk, r0, r1 in zip(blocks, starts, starts[1:]):
            c_k, row = sweep_a(blk, E[:, r0:r1].contiguous(), D)
            col = c_k if col is None else merge_maxima(col, c_k)
            rows.append(row)
        return col, torch.cat(rows, dim=1)

    c, D, E = ruiz_sweeps(P, q, m, n_iters, a_maxima)
    As = [apply(blk, E[:, r0:r1].contiguous(), D) for blk, r0, r1 in zip(blocks, starts, starts[1:])]
    qs, ls, us = apply_vectors(q, l, u, c, D, E)
    return c, D, E, apply(P, D, D, c), qs, As, ls, us


def sweep_a_plain(A, E, D):
    """Plain PyTorch version of :func:`sweep_a`."""
    if A.shape[1] == 0:
        return A.new_zeros(A.shape[0], A.shape[2]), A.new_zeros(A.shape[:2])
    absA = A.abs()
    return (absA * E[:, :, None]).amax(-2), (absA * D[:, None, :]).amax(-1)


def update_de_plain(c, p_col, col, row, D, E):
    """Plain PyTorch version of :func:`update_de`: a sweep of :func:`ruiz_plain`."""
    Pn = p_col * c[:, None]
    if col is not None:
        e_norm = row * E
        d_norm = torch.maximum(Pn, col * D)
    else:
        e_norm = torch.zeros_like(E)
        d_norm = Pn
    return D * (1.0 / torch.sqrt(limit_scaling(d_norm))), E * (1.0 / torch.sqrt(limit_scaling(e_norm)))


def sweep_p_plain(P, q, D, c, update_cost: bool):
    """Plain PyTorch version of :func:`sweep_p`, as :func:`ruiz_plain`
    computes the cost normalisation."""
    Pcol = (P.abs() * D[:, :, None]).amax(-2) * D
    if not update_cost:
        return Pcol, c
    c_temp = tree_sum(Pcol * c[:, None]) / torch.full_like(c, q.shape[1])
    inf_norm_q = limit_scaling((q.abs() * D).amax(-1) * c)
    c_temp = limit_scaling(torch.maximum(c_temp, inf_norm_q))
    return Pcol, c / c_temp


def apply_plain(M, left, right, scale=None):
    """Plain PyTorch version of :func:`apply`."""
    out = left[:, :, None] * M * right[:, None, :]
    return out if scale is None else scale[:, None, None] * out


def apply_vectors_plain(q, l, u, c, D, E):
    """Plain PyTorch version of :func:`apply_vectors`."""
    return c[:, None] * (D * q), E * l, E * u
