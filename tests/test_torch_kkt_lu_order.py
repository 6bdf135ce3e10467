"""K8's factor order on batches below the SM count, rendered in plain
PyTorch, against ``kkt_lu_factor_plain``: the same ``lu`` and ``perm``
bit for bit.

On the card a batch that cannot fill the SMs (polish's B = 1) factors
K in panels of 32 columns (``csrc/kkt_lu.cu``): each panel in a
thread-block cluster whose CTAs keep their rows in place and relabel the
pivot row and the row it displaces; then the panel's row exchanges,
composed, on every other column and the triangular solve for U12; then
the trailing update of the next panel's columns and, beside the next
panel, of the rest.  :func:`factor_by_panels` takes the same steps in the
same order with the same rounding, one elementwise operation at a time,
and the tests hold it to the unblocked right-looking plain version on
K_delta (the polish form), with a tie in |pivot| that only the "first
row of largest |value|" rule settles.
"""

import numpy as np
import pytest
import torch

from osqp_tpu_torch.ops import kkt_lu as k8

torch.set_num_threads(2)


def factor_by_panels(K: torch.Tensor, nb: int = 32):
    """(lu, perm) of K in the cluster path's order: panels of ``nb``
    columns with labels, the composed exchanges and U12, the next panel's
    columns of the trailing update, then the rest."""
    B, N, _ = K.shape
    lu = K.clone()
    inst = torch.arange(B)[:, None]
    piv = torch.zeros((B, N), dtype=torch.long)
    for k0 in range(0, N, nb):
        w = min(nb, N - k0)
        k1 = k0 + w
        rows = N - k0
        # the panel, its rows staged in place: label[r] is staged row r's
        # logical row, where[i] the staged row of logical row i
        pan = lu[:, k0:, k0:k1].clone()
        label = torch.arange(rows).repeat(B, 1)
        where = torch.arange(rows).repeat(B, 1)
        for j in range(w):
            live = label >= j
            score = torch.where(live, pan[:, :, j].abs(), torch.full_like(pan[:, :, j], -1.0))
            best = score.amax(1, keepdim=True)
            pr = torch.where((score == best) & live, label, torch.full_like(label, rows)).amin(1)
            sp = where[inst[:, 0], pr]
            top = pan[inst[:, 0], sp]  # the pivot row, (B, w)
            piv[:, k0 + j] = k0 + pr
            sj = where[:, j].clone()
            where[:, j] = sp
            where[inst[:, 0], pr] = sj
            label[inst[:, 0], sj] = pr
            label[inst[:, 0], sp] = j
            below = (label > j)[:, :, None]
            l = pan[:, :, j] / top[:, j, None]
            pan[:, :, j] = torch.where(below[:, :, 0], l, pan[:, :, j])
            upd = pan[:, :, j + 1:] - l[:, :, None] * top[:, None, j + 1:]
            pan[:, :, j + 1:] = torch.where(below, upd, pan[:, :, j + 1:])
        out = torch.empty_like(pan)
        out[inst, label] = pan
        lu[:, k0:, k0:k1] = out
        # the exchanges, composed, on the columns outside the panel
        outside = torch.cat([torch.arange(k0), torch.arange(k1, N)])
        lu[:, k0:, outside] = lu[:, k0:, outside][inst, where]
        # U12 = L11^-1 A12, by columns of L11 in order
        for j in range(w - 1):
            lu[:, k0 + j + 1:k1, k1:] -= lu[:, k0 + j + 1:k1, k0 + j, None] * lu[:, k0 + j, None, k1:]
        # the trailing update: the next panel's columns first, then the rest
        wn = min(nb, N - k1)
        for cb, ce in ((k1, k1 + wn), (k1 + wn, N)):
            for k in range(k0, k1):
                lu[:, k1:, cb:ce] -= lu[:, k1:, k, None] * lu[:, k, None, cb:ce]
    perm = torch.arange(N).repeat(B, 1)
    for k in range(N):
        p = piv[:, k]
        a, c = perm[:, k].clone(), perm[inst[:, 0], p].clone()
        perm[:, k] = c
        perm[inst[:, 0], p] = a
    return lu, perm.to(torch.int32)


def _k_delta_with_tie(B, n, m, dtype, seed, delta=1e-6):
    """The polish form K_delta of random data, about half of A's rows
    masked, and two rows of A equal up to sign whose first entry is the
    largest of column 0: the first pivot ties in |value| between them."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((B, n, n))
    P = G @ G.transpose(0, 2, 1) / n + 0.1 * np.eye(n)
    A = rng.standard_normal((B, m, n)) / np.sqrt(n)
    A *= (rng.random((B, m)) > 0.5)[:, :, None]
    A[:, 1] = 0.0
    A[:, 1, 0] = 10.0 * (np.abs(P[:, :, 0]).max() + 1.0)
    A[:, 1, 1:] = rng.standard_normal((B, n - 1))
    A[:, m - 2] = -A[:, 1]
    T = lambda a: torch.as_tensor(a, dtype=torch.float64)
    K = k8.form_kkt(T(P), T(A), delta, torch.full((B, m), delta, dtype=torch.float64))
    return K.to(dtype).contiguous()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n,m", [(25, 50), (100, 200)])
def test_panel_order_equals_the_plain_factor(n, m, dtype):
    """N = 75 and N = 300: lu and perm bit for bit, in both dtypes, with
    the first pivot settled by the tie rule."""
    K = _k_delta_with_tie(2, n, m, dtype, seed=n)
    col = K[:, :, 0].abs()
    top2 = col.topk(2, dim=1).values
    assert torch.equal(top2[:, 0], top2[:, 1])  # the tie is there
    lp, pp = k8.kkt_lu_factor_plain(K)
    assert torch.equal(pp[:, 0], torch.full((2,), n + 1, dtype=torch.int32))  # the first of the two rows
    lu, perm = factor_by_panels(K)
    assert torch.equal(perm, pp)
    assert torch.equal(lu, lp)


@pytest.mark.parametrize("nb", [8, 16])
def test_narrower_panels_give_the_same_bits(nb):
    """The widths the cluster path falls to where 32 columns do not fit a
    cluster's shared memory: the same bits."""
    K = _k_delta_with_tie(1, 40, 60, torch.float64, seed=nb)
    lp, pp = k8.kkt_lu_factor_plain(K)
    lu, perm = factor_by_panels(K, nb)
    assert torch.equal(perm, pp) and torch.equal(lu, lp)


def factor_batched_order(K: torch.Tensor, W: int = 64, S: int = 16):
    """(lu, perm) of K in the batched path's order (B at or above the SM
    count): panels of ``W`` columns factored with their rows in place and
    relabelled, by sub-panels of ``S`` columns (a column's update reaching
    its sub-panel only, then the sub-panel's U12 on the panel's later
    columns and the rank-S update of the rows below); then the panel's
    moved rows on every other column, U12 of the panel and the trailing
    update, each value's updates in increasing k."""
    B, N, _ = K.shape
    lu = K.clone()
    inst = torch.arange(B)[:, None]
    b0 = inst[:, 0]
    perm = torch.arange(N).repeat(B, 1)
    for k0 in range(0, N, W):
        w = min(W, N - k0)
        k1, rows = k0 + w, N - k0
        pan = lu[:, k0:, k0:k1].clone()  # physical rows
        label = torch.arange(rows).repeat(B, 1)
        where = torch.zeros((B, rows), dtype=torch.long)
        for q0 in range(0, w, S):
            q1 = min(q0 + S, w)
            for j in range(q0, q1):
                live = label >= j
                score = torch.where(live, pan[:, :, j].abs(), torch.full_like(pan[:, :, j], -1.0))
                best = score.amax(1, keepdim=True)
                pr = torch.where((score == best) & live, label, torch.full_like(label, rows)).amin(1)
                sp = (label == pr[:, None]).float().argmax(1)  # the pivot's physical row
                top = pan[b0, sp].clone()
                label = torch.where(label == pr[:, None], j, torch.where(label == j, pr[:, None], label))
                where[:, j] = sp
                below = label > j
                l = pan[:, :, j] / top[:, j, None]
                pan[:, :, j] = torch.where(below, l, pan[:, :, j])
                upd = pan[:, :, j + 1:q1] - l[:, :, None] * top[:, None, j + 1:q1]
                pan[:, :, j + 1:q1] = torch.where(below[:, :, None], upd, pan[:, :, j + 1:q1])
            if q1 == w:
                break
            # the sub-panel's U12 on the columns [q1, w), then the rows below
            for k in range(q0, q1 - 1):
                for i in range(k + 1, q1):
                    ri, rk = where[:, i], where[:, k]
                    pan[b0, ri, q1:] = pan[b0, ri, q1:] - pan[b0, ri, k, None] * pan[b0, rk, q1:]
            below = (label >= q1)[:, :, None]
            for k in range(q0, q1):
                u = pan[b0, where[:, k], q1:]
                upd = pan[:, :, q1:] - pan[:, :, k, None] * u[:, None, :]
                pan[:, :, q1:] = torch.where(below, upd, pan[:, :, q1:])
        order = torch.empty_like(label)
        order[inst, label] = torch.arange(rows).repeat(B, 1)  # order[i]: physical row of logical row i
        lu[:, k0:, k0:k1] = pan[inst, order]
        outside = torch.cat([torch.arange(k0), torch.arange(k1, N)])
        lu[:, k0:, outside] = lu[:, k0:, outside][inst, order]
        perm[:, k0:] = perm[:, k0:][inst, order]
        for j in range(w - 1):
            lu[:, k0 + j + 1:k1, k1:] -= lu[:, k0 + j + 1:k1, k0 + j, None] * lu[:, k0 + j, None, k1:]
        for k in range(k0, k1):
            lu[:, k1:, k1:] -= lu[:, k1:, k, None] * lu[:, k, None, k1:]
    return lu, perm.to(torch.int32)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n,m", [(1, 0), (5, 10), (10, 21), (11, 22), (21, 42), (25, 40), (25, 50), (50, 80)])
def test_batched_order_equals_the_plain_factor(n, m, dtype):
    """N = 1, 15, 31, 33, 63, 65, 75 and 130: one column, part of a
    sub-panel, ragged and whole panels of 64 in sub-panels of 16, three
    panels; lu and perm bit for bit with the first pivot tied where N
    allows it."""
    if m >= 3:
        K = _k_delta_with_tie(2, n, m, dtype, seed=n + m)
    else:
        K = torch.as_tensor(np.random.default_rng(n).standard_normal((2, n + m, n + m)), dtype=dtype)
    lp, pp = k8.kkt_lu_factor_plain(K)
    lu, perm = factor_batched_order(K)
    assert torch.equal(perm, pp)
    assert torch.equal(lu, lp)


@pytest.mark.parametrize("W", [32, 16, 8])
def test_narrower_batched_panels_give_the_same_bits(W):
    """The batched widths that f64, or a larger N, leaves to the shared
    memory: the same bits, sub-panels of 16 or the whole panel."""
    K = _k_delta_with_tie(1, 40, 60, torch.float64, seed=W)
    lp, pp = k8.kkt_lu_factor_plain(K)
    lu, perm = factor_batched_order(K, W=W)
    assert torch.equal(perm, pp) and torch.equal(lu, lp)
