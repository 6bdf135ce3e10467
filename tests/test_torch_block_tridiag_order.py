"""K7's cluster path, rendered in plain PyTorch, against
``bt_factor_plain``: the same C and G bit for bit.

Above ``block_tridiag.WARP_MAX`` the factor spreads one instance over
a thread-block cluster (``csrc/block_tridiag.cu:cluster_factor_kernel``):
CTA q holds rows [q s, q s + s) of each stage block, s = ceil(b / k),
and every step runs by panels of 16 columns.  G_i's panel of columns
takes the earlier columns' products first (a thread per row and column),
then the panel's own columns row by row; D_i - G_i G_i' subtracts G_i's
columns a panel at a time from the strip's rows left of their diagonal
block and from the diagonal band (every CTA's own copy of the diagonal
blocks); the Cholesky factors each diagonal block from the band, solves
the strip's rows below it and updates the trailing rows and the later
diagonal blocks from the panel's broadcast columns.
:func:`factor_by_clusters` takes the same steps in the same order with
the same rounding, one elementwise operation at a time, so that each
entry sees its products and differences in the kernel's order; the
tests hold it to the plain version, which runs column by column.
"""

import numpy as np
import pytest
import torch

from osqp_tpu_torch.linsys.dense_chol import form_schur
from osqp_tpu_torch.ops import block_tridiag as k7

torch.set_num_threads(2)
PANEL = k7.PANEL


def band_schur(B, Nb, b, dtype, seed=0):
    """M = P + sigma I + A' diag(rho) A of a random block-tridiagonal
    problem (block-diagonal P, rows of A on two adjacent stages)."""
    rng = np.random.default_rng(seed)
    n = Nb * b
    P = np.zeros((B, n, n))
    for i in range(Nb):
        W = rng.standard_normal((B, b, b))
        P[:, i * b:(i + 1) * b, i * b:(i + 1) * b] = W @ W.transpose(0, 2, 1) / b + 0.5 * np.eye(b)
    A = np.zeros((B, (Nb - 1) * b, n))
    for i in range(Nb - 1):
        A[:, i * b:(i + 1) * b, i * b:(i + 2) * b] = rng.standard_normal((B, b, 2 * b))
    rho = np.abs(rng.standard_normal((B, A.shape[1]))) + 0.1
    t = lambda a: torch.as_tensor(a, dtype=dtype)
    return form_schur(t(P), t(A), 1e-6, t(rho))


def panels(b):
    return [(j0, min(PANEL, b - j0)) for j0 in range(0, b, PANEL)]


def left_of_block(b):
    """mask[r, c]: c lies left of row r's diagonal block, the entries a
    strip keeps for itself (the band holds the diagonal blocks)."""
    r = torch.arange(b)[:, None]
    return torch.arange(b)[None, :] < (r // PANEL) * PANEL


def factor_block(Dp):
    """The warp's factor of a diagonal block, column by column; the flag
    of a pivot that is not positive."""
    kb = Dp.shape[-1]
    bad = torch.zeros(Dp.shape[0], dtype=torch.bool)
    for jj in range(kb):
        piv = Dp[:, jj, jj].clone()
        d = torch.sqrt(piv)
        bad |= ~(piv > 0)
        Dp[:, jj + 1:, jj] = Dp[:, jj + 1:, jj] / d[:, None]
        Dp[:, jj, jj] = d
        for cc in range(jj + 1, kb):  # lanes r >= cc
            Dp[:, cc:, cc] = Dp[:, cc:, cc] - Dp[:, cc:, jj] * Dp[:, cc, jj, None]
    return bad


def solve_panel(rows, Dp):
    """A thread per row: the panel's columns against the factored block,
    the 16 values in registers (right-looking within the panel)."""
    for jj in range(Dp.shape[-1]):
        x = rows[:, :, jj] / Dp[:, jj, jj, None]
        rows[:, :, jj] = x
        for kk in range(jj + 1, Dp.shape[-1]):
            rows[:, :, kk] = rows[:, :, kk] - x * Dp[:, None, kk, jj]
    return rows


def factor_by_clusters(M, b, k):
    """(C, G) of M in the cluster path's order with clusters of k CTAs."""
    D, O = k7.band_blocks(M, b)
    B, Nb = D.shape[:2]
    s = -(-b // k)
    strips = [(q * s, min(b, q * s + s)) for q in range(k) if q * s < b]
    left = left_of_block(b)
    C = torch.empty((B, Nb, b, b), dtype=M.dtype)
    G = torch.empty((B, Nb - 1, b, b), dtype=M.dtype)
    for i in range(Nb):
        S = D[:, i].clone()
        band = [S[:, j0:j0 + kb, j0:j0 + kb].clone() for j0, kb in panels(b)]
        if i > 0:
            Cp, W = C[:, i - 1], O[:, i - 1].clone()
            for j0, kb in panels(b):
                crow = Cp[:, j0:j0 + kb, :]  # the panel's rows of C_{i-1}, from their CTAs
                for a, e in strips:
                    blk = W[:, a:e, j0:j0 + kb].clone()
                    for t in range(j0):  # a thread per row and column
                        blk = blk - W[:, a:e, t, None] * crow[:, None, :, t]
                    for jj in range(kb):  # a thread per row
                        x = blk[:, :, jj] / crow[:, jj, j0 + jj, None]
                        blk[:, :, jj] = x
                        for kk in range(jj + 1, kb):
                            blk[:, :, kk] = blk[:, :, kk] - x * crow[:, None, kk, j0 + jj]
                    W[:, a:e, j0:j0 + kb] = blk
            G[:, i - 1] = W
            for t0, kt in panels(b):  # G_i's columns, all rows, from their CTAs
                for a, e in strips:
                    blk = S[:, a:e, :]
                    for tt in range(kt):
                        blk = blk - W[:, a:e, t0 + tt, None] * W[:, None, :, t0 + tt]
                    S[:, a:e, :] = torch.where(left[a:e], blk, S[:, a:e, :])
                for (j0, kb), Dd in zip(panels(b), band):
                    for tt in range(kt):
                        g = W[:, j0:j0 + kb, t0 + tt]
                        Dd.copy_(torch.tril(Dd - g[:, :, None] * g[:, None, :]) + torch.triu(Dd, 1))
        bad = torch.zeros(B, dtype=torch.bool)
        for p, (j0, kb) in enumerate(panels(b)):
            base = j0 + kb
            bad |= factor_block(band[p])
            for a, e in strips:
                lo = max(a, base)
                if lo < e:
                    S[:, lo:e, j0:base] = solve_panel(S[:, lo:e, j0:base].clone(), band[p])
            S[:, j0:base, j0:base] = torch.tril(band[p])
            if base == b:
                break
            pan = S[:, base:, j0:base].clone()  # the panel's columns below the block, from their CTAs
            for a, e in strips:
                lo = max(a, base)
                if lo >= e:
                    continue
                mine = S[:, lo:e, j0:base]
                blk = S[:, lo:e, base:]
                for jj in range(kb):
                    blk = blk - mine[:, :, jj, None] * pan[:, None, :, jj]
                S[:, lo:e, base:] = torch.where(left[lo:e, base:], blk, S[:, lo:e, base:])
            for q, (d0, kd) in enumerate(panels(b)):
                if q > p:
                    rows = pan[:, d0 - base:d0 - base + kd]
                    Dd = band[q]
                    for jj in range(kb):
                        Dd.copy_(torch.tril(Dd - rows[:, :, jj, None] * rows[:, None, :, jj]) + torch.triu(Dd, 1))
        C[:, i] = torch.tril(torch.where(bad[:, None, None], float("nan"), S))
    return C, G


def _equal(C, G, Cp, Gp):
    same_nan = torch.equal(torch.isnan(C), torch.isnan(Cp))
    return same_nan and torch.equal(torch.nan_to_num(C), torch.nan_to_num(Cp)) and torch.equal(G, Gp)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b,k", [(33, 1), (33, 4), (140, 2), (140, 16), (256, 5), (256, 16)])
def test_cluster_order_is_the_plain_factor_bit_for_bit(dtype, b, k):
    M = band_schur(2, 3, b, dtype, seed=b)
    C, G = factor_by_clusters(M, b, k)
    Cp, Gp = k7.bt_factor_plain(M, b)
    assert bool(torch.isfinite(C).all())
    assert _equal(C, G, Cp, Gp)


def test_cluster_order_gives_nan_where_a_stage_is_not_positive_definite():
    M = band_schur(2, 3, 40, torch.float64, seed=3)
    M[1, 40 + 21, 40 + 21] = -1e6
    C, G = factor_by_clusters(M, 40, 4)
    Cp, Gp = k7.bt_factor_plain(M, 40)
    assert torch.isnan(C[1, 1:]).any() and bool(torch.isfinite(C[0]).all())
    assert torch.equal(torch.isnan(C), torch.isnan(Cp))
    assert torch.equal(torch.nan_to_num(C), torch.nan_to_num(Cp))
    assert torch.equal(torch.isnan(G), torch.isnan(Gp)) and torch.equal(torch.nan_to_num(G), torch.nan_to_num(Gp))
