"""Independent optimality verification — solver-external ground truth.

The reference defers accuracy benchmarking to the external
osqp_benchmarks repo (README.md:42-43), whose pass criterion is the
unscaled KKT residuals of the returned solution at the ORIGINAL data
(the same quantities OSQP's own termination checks, auxil.c:240-359,
but recomputed outside the solver).  This module implements that
criterion in float64 NumPy with no solver code in the loop: scaling,
termination, or dtype bugs inside the solver cannot fool it.  A copy of
``osqp_tpu/verify.py``, which imports nothing of jax: the port's
pass criterion, on the CPU whatever device solved.

For a convex QP, (x, y) with small primal/dual residuals certifies
near-optimality directly — no second solver needed.  Infeasibility
certificates are likewise verifiable algebraically (auxil.c:361-512).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from . import constants as con


def _to_dense64(M):
    if sp.issparse(M):
        M = M.toarray()
    return np.asarray(M, np.float64)


def _matvec(M, v):
    if sp.issparse(M):
        return np.asarray(M @ v).ravel()
    return np.asarray(M, np.float64) @ v


def kkt_check(P, q, A, l, u, x, y, eps_abs=1e-3, eps_rel=1e-3):
    """Verify (x, y) against the OSQP optimality criterion in f64.

    ``P`` may be upper-triangular (sparse) or full symmetric; residuals
    use the symmetrized operator.  Returns a dict with unscaled
    ``pri_res``, ``dua_res``, their tolerances (auxil.c:256-285 /
    320-359 formulas), a complementarity diagnostic, and ``ok``.
    """
    q = np.asarray(q, np.float64).ravel()
    x = np.asarray(x, np.float64).ravel()
    y = np.asarray(y, np.float64).ravel()
    l = np.clip(np.asarray(l, np.float64).ravel(), -con.OSQP_INFTY, con.OSQP_INFTY)
    u = np.clip(np.asarray(u, np.float64).ravel(), -con.OSQP_INFTY, con.OSQP_INFTY)
    if not (np.all(np.isfinite(x)) and np.all(np.isfinite(y))):
        return dict(ok=False, pri_res=np.inf, dua_res=np.inf,
                    pri_tol=0.0, dua_tol=0.0, comp=np.inf, obj=np.nan)

    if sp.issparse(P):
        # Stay sparse: densifying P is O(n^2) host memory and OOMs the
        # checker at the n ~ 1e5 sizes the sparse path solves (the
        # check itself only needs matvecs).
        Pu = sp.triu(sp.csr_matrix(P).astype(np.float64))
        Psym = Pu + Pu.T - sp.diags(Pu.diagonal())
        Px = np.asarray(Psym @ x).ravel() if Pu.shape[0] else np.zeros_like(x)
    else:
        Pd = _to_dense64(P)
        if Pd.size:
            # accept triu or full: symmetrize via triu
            Pu = np.triu(Pd)
            Pd = Pu + Pu.T - np.diag(np.diag(Pu))
        Px = Pd @ x if Pd.size else np.zeros_like(x)
    Ax = _matvec(A, x) if y.size else np.zeros(0)
    Aty = _matvec(sp.csr_matrix(A).T if sp.issparse(A)
                  else np.asarray(A, np.float64).T, y) if y.size else np.zeros_like(x)

    ninf = lambda v: float(np.max(np.abs(v))) if v.size else 0.0

    # Primal: distance of Ax from [l, u] (auxil.c:240-254 uses z; the
    # projection of Ax is the tightest admissible z).
    z = np.clip(Ax, l, u)
    pri_res = ninf(Ax - z)
    pri_tol = eps_abs + eps_rel * max(ninf(Ax), ninf(z))

    # Dual: stationarity (auxil.c:287-318).
    dua_res = ninf(Px + q + Aty)
    dua_tol = eps_abs + eps_rel * max(ninf(Px), ninf(Aty), ninf(q))

    # Complementarity diagnostic (not part of OSQP's criterion; implied
    # by its z-projection + y-update structure, reported for evidence):
    # y_i > 0 requires Ax_i at u_i, y_i < 0 at l_i; loose rows need y=0.
    if y.size:
        up_gap = np.where(u < con.OSQP_INFTY * con.MIN_SCALING, u - Ax, 0.0)
        lo_gap = np.where(l > -con.OSQP_INFTY * con.MIN_SCALING, Ax - l, 0.0)
        both_inf = (u >= con.OSQP_INFTY * con.MIN_SCALING) & (
            l <= -con.OSQP_INFTY * con.MIN_SCALING
        )
        comp = ninf(
            np.where(
                both_inf,
                np.abs(y),
                np.maximum(y, 0.0) * np.abs(up_gap)
                + np.maximum(-y, 0.0) * np.abs(lo_gap),
            )
        )
    else:
        comp = 0.0

    obj = float(0.5 * x @ Px + q @ x)
    return dict(
        ok=(pri_res <= pri_tol) and (dua_res <= dua_tol),
        pri_res=pri_res, pri_tol=pri_tol,
        dua_res=dua_res, dua_tol=dua_tol,
        comp=comp, obj=obj,
    )


def primal_infeasibility_check(A, l, u, v, eps=1e-4):
    """Certificate of primal infeasibility (auxil.c:361-424): v with
    ||A'v||inf <= eps ||v||inf and u'[v]+ + l'[v]- < -eps ||v||inf."""
    v = np.asarray(v, np.float64).ravel()
    nrm = float(np.max(np.abs(v))) if v.size else 0.0
    if nrm == 0 or not np.all(np.isfinite(v)):
        return dict(ok=False, Atv=np.inf, support=np.inf)
    v = v / nrm
    l = np.clip(np.asarray(l, np.float64).ravel(), -con.OSQP_INFTY, con.OSQP_INFTY)
    u = np.clip(np.asarray(u, np.float64).ravel(), -con.OSQP_INFTY, con.OSQP_INFTY)
    Atv = float(np.max(np.abs(_matvec(
        sp.csr_matrix(A).T if sp.issparse(A) else np.asarray(A, np.float64).T, v
    ))))
    support = float(u @ np.maximum(v, 0.0) + l @ np.minimum(v, 0.0))
    return dict(ok=(Atv <= eps) and (support < -eps), Atv=Atv, support=support)


def dual_infeasibility_check(P, q, A, l, u, dx, eps=1e-4):
    """Certificate of dual infeasibility / unboundedness
    (auxil.c:426-512): dx with P dx ~ 0, q'dx < 0, and A dx in the
    recession cone of [l, u]."""
    dx = np.asarray(dx, np.float64).ravel()
    nrm = float(np.max(np.abs(dx))) if dx.size else 0.0
    if nrm == 0 or not np.all(np.isfinite(dx)):
        return dict(ok=False)
    dx = dx / nrm
    Pd = _to_dense64(P)
    if Pd.size:
        Pu = np.triu(Pd)
        Pd = Pu + Pu.T - np.diag(np.diag(Pu))
    Pdx = float(np.max(np.abs(Pd @ dx))) if Pd.size else 0.0
    qdx = float(np.asarray(q, np.float64) @ dx)
    Adx = _matvec(A, dx)
    l = np.asarray(l, np.float64).ravel()
    u = np.asarray(u, np.float64).ravel()
    thresh = con.OSQP_INFTY * con.MIN_SCALING
    cone_ok = bool(
        np.all((u >= thresh) | (Adx <= eps))
        and np.all((l <= -thresh) | (Adx >= -eps))
    )
    return dict(ok=(Pdx <= eps) and (qdx < -eps) and cone_ok,
                Pdx=Pdx, qdx=qdx)
