"""K7's cluster and device paths and its wide solve, rendered in plain
PyTorch, against ``bt_factor_plain`` and ``bt_solve_plain``: the same C,
G and x bit for bit.

Above ``block_tridiag.WARP_MAX`` the factor spreads one instance over
a thread-block cluster (``csrc/block_tridiag.cu:cluster_factor_kernel``):
CTA q holds rows q, q + k, q + 2k, ... of each stage block, and every
step runs by panels of 16 columns.  G_i's panel of columns
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
tests hold it to the plain version, which runs column by column.  The
device path takes the same steps with the strips in C's and G's own
rows, so the same rendering holds it at its strip sizes.

Above ``WARP_MAX`` the solve runs one CTA an instance
(``csrc/block_tridiag.cu:wide_solve_kernel``) by rounds of 16 columns:
in round p warp 0 brings panel p's rows up to date with the panel before
and solves the panel's diagonal block column by column, while the other
warps bring the rows beyond the panel up to date with the panel before.
:func:`solve_by_panels` takes those steps in that order.
"""

from fractions import Fraction

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
    """(C, G) of M in the cluster path's order with clusters of k CTAs.
    Every row takes the same steps whichever CTA holds it, so G's panels,
    whose products run longest, take all rows together; the band, every
    CTA's copy of the diagonal blocks, is one tensor of 16 x 16 blocks
    (the last padded with zeros), each block updated by the same
    elementwise steps as the kernel's."""
    D, O = k7.band_blocks(M, b)
    B, Nb = D.shape[:2]
    strips = [torch.arange(q, b, k) for q in range(min(k, b))]  # CTA q's rows
    left = left_of_block(b)
    pn = panels(b)
    nblk, pad = len(pn), len(pn) * PANEL - b
    tril = torch.ones(PANEL, PANEL, dtype=torch.bool).tril()
    C = torch.empty((B, Nb, b, b), dtype=M.dtype)
    G = torch.empty((B, Nb - 1, b, b), dtype=M.dtype)

    def rank1(band, g):  # band - g g' on the lower triangle of each block
        return torch.where(tril, band - g[..., :, None] * g[..., None, :], band)

    for i in range(Nb):
        S = D[:, i].clone()
        Sp = torch.nn.functional.pad(S, (0, pad, 0, pad))
        band = torch.stack([Sp[:, j0:j0 + PANEL, j0:j0 + PANEL] for j0, _ in pn], 1)
        if i > 0:
            Cp, W = C[:, i - 1], O[:, i - 1].clone()
            for j0, kb in pn:
                crow = Cp[:, j0:j0 + kb, :]  # the panel's rows of C_{i-1}, from their CTAs
                blk = W[:, :, j0:j0 + kb].clone()
                for t in range(j0):  # a thread per row and column
                    blk = blk - W[:, :, t, None] * crow[:, None, :, t]
                for jj in range(kb):  # a thread per row
                    x = blk[:, :, jj] / crow[:, jj, j0 + jj, None]
                    blk[:, :, jj] = x
                    for kk in range(jj + 1, kb):
                        blk[:, :, kk] = blk[:, :, kk] - x * crow[:, None, kk, j0 + jj]
                W[:, :, j0:j0 + kb] = blk
            G[:, i - 1] = W
            Wb = torch.nn.functional.pad(W, (0, 0, 0, pad)).reshape(B, nblk, PANEL, b)
            for t0, kt in pn:  # G_i's columns, all rows, from their CTAs
                for rows in strips:
                    blk = S[:, rows, :]
                    for tt in range(kt):
                        blk = blk - W[:, rows, t0 + tt, None] * W[:, None, :, t0 + tt]
                    S[:, rows, :] = torch.where(left[rows], blk, S[:, rows, :])
                for tt in range(kt):
                    band = rank1(band, Wb[..., t0 + tt])
        bad = torch.zeros(B, dtype=torch.bool)
        for p, (j0, kb) in enumerate(pn):
            base = j0 + kb
            blockp = band[:, p, :kb, :kb].clone()
            bad |= factor_block(blockp)
            for rows in strips:
                below = rows[rows >= base]
                if len(below):
                    S[:, below, j0:base] = solve_panel(S[:, below, j0:base].clone(), blockp)
            S[:, j0:base, j0:base] = torch.tril(blockp)
            if base == b:
                break
            pan = S[:, base:, j0:base].clone()  # the panel's columns below the block, from their CTAs
            for rows in strips:
                below = rows[rows >= base]
                if not len(below):
                    continue
                mine = S[:, below, j0:base]
                blk = S[:, below, base:]
                for jj in range(kb):
                    blk = blk - mine[:, :, jj, None] * pan[:, None, :, jj]
                S[:, below, base:] = torch.where(left[below][:, base:], blk, S[:, below, base:])
            # the later diagonal blocks take the panel's columns
            rows = torch.nn.functional.pad(pan, (0, 0, 0, pad)).reshape(B, nblk - p - 1, PANEL, kb)
            later = band[:, p + 1:]
            for jj in range(kb):
                later = rank1(later, rows[..., jj])
            band = torch.cat([band[:, :p + 1], later], 1)
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


def solve_by_panels(C, G, r):
    """x = M^-1 r in the wide solve's order: per stage the product with G
    (each entry's terms t ascending), then one round a panel.  Forward,
    round p: panel p's rows take the panel before (warp 0), the panel's
    column steps run, and the rows beyond the panel take the panel before
    (the other warps); backward the same from the last panel down, the
    rows above the panel taking the panel after."""
    B, Nb, b, _ = C.shape
    pn = panels(b)
    x = torch.empty_like(r)
    for i in range(Nb):
        v = r[:, i * b:(i + 1) * b].clone()
        if i > 0:
            yp = x[:, (i - 1) * b:i * b]
            for t in range(b):
                v = v - G[:, i - 1, :, t] * yp[:, t, None]
        c = C[:, i]
        for p, (j0, kb) in enumerate(pn):
            if p > 0:
                jp = j0 - PANEL
                for jj in range(PANEL):  # warp 0: panel p's rows take panel p - 1
                    v[:, j0:j0 + kb] = v[:, j0:j0 + kb] - c[:, j0:j0 + kb, jp + jj] * v[:, jp + jj, None]
            for jj in range(kb):  # the diagonal block, column by column
                q = v[:, j0 + jj] / c[:, j0 + jj, j0 + jj]
                v[:, j0 + jj] = q
                v[:, j0 + jj + 1:j0 + kb] = v[:, j0 + jj + 1:j0 + kb] - c[:, j0 + jj + 1:j0 + kb, j0 + jj] * q[:, None]
            if p > 0:
                for jj in range(PANEL):  # the other warps: rows beyond panel p take panel p - 1
                    v[:, j0 + kb:] = v[:, j0 + kb:] - c[:, j0 + kb:, jp + jj] * v[:, jp + jj, None]
        x[:, i * b:(i + 1) * b] = v
    for i in reversed(range(Nb)):
        v = x[:, i * b:(i + 1) * b].clone()
        if i < Nb - 1:
            xn = x[:, (i + 1) * b:(i + 2) * b]
            for t in range(b):
                v = v - G[:, i, t, :] * xn[:, t, None]
        c = C[:, i]
        for p in reversed(range(len(pn))):
            j0, kb = pn[p]
            if p + 1 < len(pn):
                jn, kn = pn[p + 1]
                for u in reversed(range(kn)):  # warp 0: panel p's rows take panel p + 1
                    v[:, j0:j0 + kb] = v[:, j0:j0 + kb] - c[:, jn + u, j0:j0 + kb] * v[:, jn + u, None]
            for jj in reversed(range(kb)):
                q = v[:, j0 + jj] / c[:, j0 + jj, j0 + jj]
                v[:, j0 + jj] = q
                v[:, j0:j0 + jj] = v[:, j0:j0 + jj] - c[:, j0 + jj, j0:j0 + jj] * q[:, None]
            if p + 1 < len(pn):
                for u in reversed(range(kn)):  # the other warps: rows above panel p take panel p + 1
                    v[:, :j0] = v[:, :j0] - c[:, jn + u, :j0] * v[:, jn + u, None]
        x[:, i * b:(i + 1) * b] = v
    return x


@pytest.mark.parametrize("dtype,b", [(torch.float64, 362), (torch.float32, 559)])
def test_device_path_order_at_its_strip_sizes(dtype, b):
    """The device path, just above cluster_max_block, in the clusters of
    16 CTAs that device_plan gives the large-stage batches (B = 4 on 132
    SMs): strips of 23 (f64) and 35 (f32) rows, the kernel's order, the
    plain version's bits."""
    assert k7.factor_path(b, dtype) == "device" and k7.factor_path(b - 1, dtype) == "cluster"
    assert k7.device_plan(4, 132) == 16
    M = band_schur(1, 2, b, dtype, seed=b)
    C, G = factor_by_clusters(M, b, 16)
    Cp, Gp = k7.bt_factor_plain(M, b)
    assert bool(torch.isfinite(C).all())
    assert _equal(C, G, Cp, Gp)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b", [33, 140, 362])
def test_wide_solve_order_is_the_plain_solve_bit_for_bit(dtype, b):
    """The wide solve's rounds (one panel of 16 a round, the last ragged
    at b = 33, 140, 362) give bt_solve_plain's x bit for bit."""
    assert k7.solve_plan(b, dtype)[0] == "wide"
    M = band_schur(2, 3, b, dtype, seed=b)
    C, G = k7.bt_factor_plain(M, b)
    r = torch.as_tensor(np.random.default_rng(b).standard_normal((2, 3 * b)), dtype=dtype)
    x = solve_by_panels(C, G, r)
    assert bool(torch.isfinite(x).all())
    assert torch.equal(x, k7.bt_solve_plain(C, G, r))


def _round(x: Fraction, p: int, emin: int) -> Fraction:
    """x rounded to nearest, ties to even, in binary with p-bit
    significands and least exponent emin (subnormals below)."""
    if x == 0:
        return Fraction(0)
    sign, x = (-1 if x < 0 else 1), abs(x)
    e = x.numerator.bit_length() - x.denominator.bit_length()
    if Fraction(2) ** e > x:
        e -= 1
    ulp = Fraction(2) ** (max(e, emin) - p + 1)
    m, rest = divmod(x, ulp)
    if rest > ulp / 2 or (rest == ulp / 2 and m % 2):
        m += 1
    return sign * m * ulp


@pytest.mark.parametrize("p,emin,lo", [(24, -126, -30), (53, -1022, -400)])
def test_route_quotient_is_the_division_in_exact_arithmetic(p, emin, lo):
    """The wide solve's quotient route (csrc/block_tridiag.cu:
    route_quotient), in exact arithmetic with each step rounded as the
    card rounds it: rd = RN(1 / d), q0 = RN(a rd), then twice q <- RN(q +
    RN(a - q d) rd), the residual and the sum in one fused rounding each.
    It gives RN(a / d) on random pairs across the route's exponent range
    and on pairs near the hard cases (significands of d all ones, a near
    a multiple of d)."""
    rnd = lambda x: _round(x, p, emin)
    rng = np.random.default_rng(p)

    def draw(exp_lo, exp_hi):
        m = Fraction(int(rng.integers(2 ** (p - 1), 2**p)), 2 ** (p - 1))
        return m * Fraction(2) ** int(rng.integers(exp_lo, exp_hi)) * (1 if rng.random() < 0.5 else -1)

    ones = Fraction(2**p - 1, 2 ** (p - 1))
    pairs = [(draw(lo // 2, -lo // 2), draw(lo // 2, -lo // 2)) for _ in range(600)]
    pairs += [(draw(-4, 4), ones * Fraction(2) ** int(rng.integers(-8, 8))) for _ in range(100)]
    for _ in range(200):
        d = draw(-4, 4)
        k = int(rng.integers(1, 2**p))
        pairs.append((rnd(d * k * Fraction(2) ** -p + Fraction(int(rng.integers(-3, 4)), 2 ** (2 * p))), d))
    for a, d in pairs:
        rd = rnd(1 / d)
        q = rnd(a * rd)
        for _ in range(2):
            q = rnd(q + rnd(a - q * d) * rd)
        assert q == rnd(a / d), (a, d)
