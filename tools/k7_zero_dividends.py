#!/usr/bin/env python3
"""How often K7's factor meets a zero dividend in its row solves, on the CPU.

    python3 tools/k7_zero_dividends.py

The factor's row solves (G_i = O_i C_{i-1}^-T, csrc/block_tridiag.cu:
solve_row) take each quotient by the reciprocal route, which does not
take a zero dividend: a row's 16-column panel with one is run again by
the division.  For the reduced matrices of ``chip_smoke.py``'s
large-stage MPC batches (b = 99 float64, b = 140 float32: its
``large_stage_mpc``, scaled and formed as its ``k7_device`` phase forms
them) and for the random band matrices of its ``band_schur`` at the same
b, this runs the plain row solves (``bt_factor_plain``'s order) and
prints the share of (row, panel) pairs over the stages after the first
that meet an exact zero dividend.  Imports nothing of JAX.
"""

from __future__ import annotations

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def zero_share(M, b: int) -> float:
    import torch

    from osqp_tpu_torch.ops import block_tridiag as k7

    D, O = k7.band_blocks(M, b)
    C, _ = k7.bt_factor_plain(M, b)
    B, Nb = D.shape[:2]
    pairs = zero = 0
    for i in range(1, Nb):
        Cp, W = C[:, i - 1], O[:, i - 1].clone()
        hit = torch.zeros(B, b, -(-b // k7.PANEL), dtype=torch.bool)
        for j in range(b):
            hit[:, :, j // k7.PANEL] |= W[:, :, j] == 0
            W[:, :, j] = W[:, :, j] / Cp[:, j, j, None]
            if j + 1 < b:
                W[:, :, j + 1:] = W[:, :, j + 1:] - W[:, :, j, None] * Cp[:, None, j + 1:, j]
        pairs += hit.numel()
        zero += int(hit.sum())
    return zero / pairs


def main() -> int:
    import torch

    import chip_smoke as cs
    from osqp_tpu_torch import batch, solver
    from osqp_tpu_torch.linsys.dense_chol import form_schur
    from osqp_tpu_torch.types import DynSettings

    dev = torch.device("cpu")
    for dtype, b in ((torch.float64, 99), (torch.float32, 140)):
        _, *arrays = cs.large_stage_mpc(b)
        P, q, A, l, u = cs.on_device(arrays, dtype, dev)
        B, n, m = P.shape[0], P.shape[1], A.shape[1]
        s = solver.Settings(**cs.MPC_KW, dtype=dtype, linsys_solver="block_tridiag", block_size=b)
        cfg = solver.make_config(n, m, s, dtype)
        dyn = DynSettings.make(dtype)
        rho0 = torch.full((B,), s.rho, dtype=dtype, device=dev)
        scaled, _, rs, _, _ = batch._prepare(cfg, s.scaling, P, q, A, l, u, rho0, dyn, None, None)
        M = form_schur(scaled.P, scaled.A, dyn.sigma, rs.rho_vec).contiguous()
        R, _ = cs.band_schur(B, 3, b, dtype, dev)
        print(f"b={b} {cs.dtype_name(dtype)}: (row, panel) pairs of G's row solves with a zero dividend: "
              f"MPC batch {zero_share(M, b):.3f}, random band matrix {zero_share(R, b):.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
