"""Model-predictive-control QP builder (copy of ``osqp_tpu/models/mpc.py``,
numpy only; reference docs/examples/mpc.rst).

The reference example stacks variables as ``(x_0..x_N, u_0..u_{N-1})``,
which is fine for a general sparse solver but scatters the coupling all
over the KKT.  Here the decision vector is *stage-interleaved*,

    v = (x_0, u_0, x_1, u_1, ..., x_{N-1}, u_{N-1}, x_N, u_pad)

with a zero-pinned padding input after the terminal state so every stage
block has identical size ``b = nx + nu``.  Under this ordering the Schur
complement ``P + sigma I + A' rho A`` is block tridiagonal and the
``block_tridiag`` backend factors it in O(N b^3) (K7,
:mod:`osqp_tpu_torch.ops.block_tridiag`).

The QP (same formulation as the reference example):

    minimize    sum_k 0.5 (x_k - xr)' Q (x_k - xr) + 0.5 u_k' R u_k
                + 0.5 (x_N - xr)' QN (x_N - xr)
    subject to  x_{k+1} = Ad x_k + Bd u_k
                x_0 = xinit
                xmin <= x_k <= xmax,   umin <= u_k <= umax
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class MPCProblem:
    P: np.ndarray  # (nv, nv)
    q: np.ndarray  # (nv,)
    A: np.ndarray  # (mc, nv)
    l: np.ndarray  # (mc,)
    u: np.ndarray  # (mc,)
    nx: int
    nu: int
    horizon: int
    block_size: int  # nx + nu

    def split_solution(self, v: np.ndarray):
        """(xs: (N+1, nx), us: (N, nu)) from a stacked solution."""
        b = self.block_size
        N = self.horizon
        stages = np.asarray(v).reshape(N + 1, b)
        xs = stages[:, : self.nx]
        us = stages[:-1, self.nx :]
        return xs, us

    def update_xinit(self, solver, xinit):
        """Move the initial-state equality for a receding-horizon step
        (the parametric update the reference MPC example performs with
        osqp_update_bounds, osqp.c:797-846)."""
        l = np.array(self.l)
        u = np.array(self.u)
        l[: self.nx] = xinit
        u[: self.nx] = xinit
        self.l, self.u = l, u
        solver.update_bounds(l=l, u=u)


def build_mpc_qp(
    Ad,
    Bd,
    Q,
    R,
    QN=None,
    xinit=None,
    xr=None,
    horizon: int = 10,
    xmin=None,
    xmax=None,
    umin=None,
    umax=None,
) -> MPCProblem:
    Ad = np.asarray(Ad, np.float64)
    Bd = np.asarray(Bd, np.float64)
    Q = np.asarray(Q, np.float64)
    R = np.asarray(R, np.float64)
    QN = Q if QN is None else np.asarray(QN, np.float64)
    nx, nu = Bd.shape
    N = int(horizon)
    b = nx + nu
    nv = (N + 1) * b

    xinit = np.zeros(nx) if xinit is None else np.asarray(xinit, np.float64)
    xr = np.zeros(nx) if xr is None else np.asarray(xr, np.float64)
    inf = np.inf
    xmin = np.full(nx, -inf) if xmin is None else np.asarray(xmin, np.float64)
    xmax = np.full(nx, inf) if xmax is None else np.asarray(xmax, np.float64)
    umin = np.full(nu, -inf) if umin is None else np.asarray(umin, np.float64)
    umax = np.full(nu, inf) if umax is None else np.asarray(umax, np.float64)

    # ---- objective -------------------------------------------------------
    P = np.zeros((nv, nv))
    q = np.zeros(nv)
    for k in range(N):
        o = k * b
        P[o : o + nx, o : o + nx] = Q
        P[o + nx : o + b, o + nx : o + b] = R
        q[o : o + nx] = -Q @ xr
    oT = N * b
    P[oT : oT + nx, oT : oT + nx] = QN
    q[oT : oT + nx] = -QN @ xr
    # Padding input: unit cost, pinned to zero below.
    P[oT + nx : oT + b, oT + nx : oT + b] = np.eye(nu)

    # ---- constraints -----------------------------------------------------
    rows = []
    lo = []
    hi = []

    def add(row, lv, uv):
        rows.append(row)
        lo.append(lv)
        hi.append(uv)

    # x_0 = xinit
    for i in range(nx):
        r = np.zeros(nv)
        r[i] = 1.0
        add(r, xinit[i], xinit[i])
    # dynamics: -x_{k+1} + Ad x_k + Bd u_k = 0
    for k in range(N):
        o = k * b
        for i in range(nx):
            r = np.zeros(nv)
            r[o : o + nx] = Ad[i]
            r[o + nx : o + b] = Bd[i]
            r[o + b + i] = -1.0
            add(r, 0.0, 0.0)
    # state bounds x_1..x_N
    for k in range(1, N + 1):
        o = k * b
        for i in range(nx):
            r = np.zeros(nv)
            r[o + i] = 1.0
            add(r, xmin[i], xmax[i])
    # input bounds u_0..u_{N-1}
    for k in range(N):
        o = k * b + nx
        for i in range(nu):
            r = np.zeros(nv)
            r[o + i] = 1.0
            add(r, umin[i], umax[i])
    # padding input pinned to zero
    for i in range(nu):
        r = np.zeros(nv)
        r[oT + nx + i] = 1.0
        add(r, 0.0, 0.0)

    A = np.stack(rows)
    return MPCProblem(
        P=P,
        q=q,
        A=A,
        l=np.asarray(lo),
        u=np.asarray(hi),
        nx=nx,
        nu=nu,
        horizon=N,
        block_size=b,
    )
