"""Host-side exact polish (a numpy/scipy copy of ``osqp_tpu/polish_host.py``,
with the cost measure of ``_ruiz`` capped as ``limit_scaling`` caps it).

In the port it is the Maros harness's rescue of dense rows whose device
polish failed (:func:`osqp_tpu_torch.maros.run_maros`) and a numpy
cross-check; sparse solves polish on the device at every B
(:mod:`osqp_tpu_torch.large`).  The JAX package's account of why it
exists follows.

The reference's polish is a one-time DIRECT factorization of the
reduced KKT (polish.c:212-350: fresh LDL at delta = 1e-6).  On the
device, the never-densifying sparse path must solve that system with
matrix-free CG — and on hard problems (DTOC3's masked Schur needs
~24-40k Jacobi-CG iterations) the one fused final dispatch becomes a
multi-minute device program that the TPU worker's watchdog kills
(round-4 AUG2D incident).  Polish is setup-class work, not hot-loop
work, so for B = 1 sparse solves it runs HERE: an exact scipy splu of
the true dynamic-shape reduced KKT in f64 — the same division of labor
as problem ingestion (host scipy -> device ELL).

Math follows src/polish.c exactly (active-set guess, reduced KKT with
delta regularization, ``polish_refine_iter`` refinement steps against
the unregularized system, normal-cone projection, accept iff both
residuals improve), plus the package's multi-pass re-guess loop
(polish.polish): the set is re-guessed at the polished point up to
``passes`` times and the best pass kept — pass 0 is the reference
behaviour.

Round 5: the polish runs on the RUIZ-SCALED problem, like the
reference's (its workspace is scaled) — this is load-bearing, not
cosmetic: delta = 1e-6 is a relative perturbation of the unit-normed
scaled operators, and on raw CVXQP-scale data the same delta leaves
the reduced KKT numerically singular (every guess fails at pri ~ 9.9
on CVXQP1_M; the identical machinery on the scaled problem polishes
the same point to the oracle's exact objective).  Keep-best and the
acceptance test evaluate UNSCALED residuals, which is what the solve
results carry.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla


def _ruiz(P, A, q, n_iter=10):
    """Ruiz equilibration vectors (c, D, E) of the UNSCALED problem —
    numpy port of scaling.c:44-156 (same recursion as the solver's
    scaling, the cost measure capped as limit_scaling caps it)."""
    MIN_S, MAX_S = 1e-4, 1e4
    n = P.shape[0]
    m = A.shape[0]
    c = 1.0
    D = np.ones(n)
    E = np.ones(m)
    Pw = P.copy()
    Aw = A.copy()
    qw = q.copy()
    for _ in range(n_iter):
        Pa = np.abs(Pw)
        Aa = np.abs(Aw)
        dP = np.asarray(Pa.max(axis=0).todense()).ravel()
        dA = (np.asarray(Aa.max(axis=0).todense()).ravel()
              if Aw.shape[0] else np.zeros(n))
        d = np.maximum(dP, dA)
        d = np.where(d < MIN_S, 1.0, np.minimum(d, MAX_S))
        d = 1.0 / np.sqrt(d)
        e = (np.asarray(Aa.max(axis=1).todense()).ravel()
             if Aw.shape[0] else np.zeros(0))
        e = np.where(e < MIN_S, 1.0, np.minimum(e, MAX_S))
        e = 1.0 / np.sqrt(e)
        Dm = sp.diags(d)
        Em = sp.diags(e)
        Pw = (Dm @ Pw @ Dm).tocsc()
        Aw = (Em @ Aw @ Dm).tocsc()
        qw = d * qw
        D *= d
        E *= e
        # cost scalar (scaling.c:122-152)
        pcol = np.asarray(np.abs(Pw).max(axis=0).todense()).ravel()
        mean_pcol = pcol.mean() if n else 0.0
        qn = np.linalg.norm(qw, np.inf)
        qn = 1.0 if qn < MIN_S else min(qn, MAX_S)
        # limit_scaling(max(mean_pcol, qn)) before the inversion, as the
        # solver's scaling does (scaling.c:122-152): uncapped, a
        # P-dominated problem's measure above MAX_S gives g < 1 / MAX_S.
        c_meas = max(mean_pcol, qn)
        c_meas = 1.0 if c_meas < MIN_S else min(c_meas, MAX_S)
        g = 1.0 / c_meas
        Pw = Pw * g
        qw = qw * g
        c *= g
    return c, D, E


def _reduced_kkt_polish(
    P, A, q, l, u, x, z, y, delta, refine_iter, unscale=None
):
    """One polish pass (polish.c:19-350) with true dynamic shapes.

    Inputs are the SCALED problem and iterates when ``unscale`` is
    given (the reference pipeline: polish.c runs on the scaled
    workspace, where delta = 1e-6 is a relative perturbation of
    unit-normed operators; on raw CVXQP-scale data the same delta
    leaves the reduced KKT numerically singular and the pass fails —
    measured, round 5).  ``unscale = (c, D, E, Pu, Au, qu, lu_, uu)``
    maps each candidate back to the original space, where the
    residuals that drive keep-best and acceptance are evaluated.
    Returns (x_s, z_s, y_s, x_u, y_u, pri, dua) or None."""
    n = P.shape[0]
    m = A.shape[0]
    lower = (z - l) < -y
    upper = (u - z) < y
    act = lower | upper
    k = int(act.sum())
    Ared = A[act]
    rhs_red = np.where(lower, l, np.where(upper, u, 0.0))[act]
    K = sp.bmat(
        [
            [P + delta * sp.eye(n), Ared.T],
            [Ared, -delta * sp.eye(k) if k else None],
        ],
        format="csc",
    )
    try:
        lu = spla.splu(K)
    except RuntimeError:
        return None
    b = np.concatenate([-q, rhs_red])
    sol = lu.solve(b)
    if not np.all(np.isfinite(sol)):
        return None
    K0 = sp.bmat(
        [[P, Ared.T], [Ared, sp.csc_matrix((k, k)) if k else None]],
        format="csc",
    )

    def eval_point(sol):
        x_p = sol[:n]
        y_p = np.zeros(m)
        y_p[act] = sol[n:]
        zy = A @ x_p + y_p
        z_p = np.clip(zy, l, u)
        y_p = zy - z_p
        if unscale is None:
            pri = float(np.linalg.norm(A @ x_p - z_p, np.inf)) if m else 0.0
            dua = float(np.linalg.norm(P @ x_p + q + A.T @ y_p, np.inf))
            return x_p, z_p, y_p, x_p, y_p, pri, dua
        c, D, E, Pu, Au, qu, lu_, uu = unscale
        x_u = D * x_p
        y_u = (E / c) * y_p
        z_u = np.clip(Au @ x_u, lu_, uu) if m else np.zeros(0)
        pri = float(np.linalg.norm(Au @ x_u - z_u, np.inf)) if m else 0.0
        dua = float(np.linalg.norm(Pu @ x_u + qu + Au.T @ y_u, np.inf))
        return x_p, z_p, y_p, x_u, y_u, pri, dua

    # Keep the best refinement step INCLUDING step 0: the refinement
    # target K0 drops the delta regularization (polish.c:161-177), and
    # when the guessed Ared has dependent rows (degenerate actives —
    # the CVXQP/LISWET classes) K0 is singular and refinement DIVERGES,
    # while the delta-regularized step-0 solution already has
    # O(delta)-level true residuals.  Measured on CVXQP2_M: step 3
    # dua = 6.3e+2, step 0 of the re-guessed pass dua = 1.6e-2
    # (accepted); see tools/polish_lab.py.
    best = eval_point(sol)
    for _ in range(refine_iter):
        if not np.all(np.isfinite(sol)):
            break
        sol = sol + lu.solve(b - K0 @ sol)
        cand = eval_point(sol)
        if np.isfinite(max(cand[5], cand[6])) and max(cand[5], cand[6]) < max(
            best[5], best[6]
        ):
            best = cand
    return best


def polish_host(
    P,
    A,
    q,
    l,
    u,
    x,
    y,
    admm_pri_res: float,
    admm_dua_res: float,
    delta: float = 1e-6,
    refine_iter: int = 3,
    passes: int = 4,
):
    """Exact multi-pass polish of one UNSCALED solution.

    ``P``/``A`` scipy sparse (P upper-triangular or full symmetric);
    ``x``/``y`` the solver's unscaled solution.  Returns
    (success, x, y, obj, pri_res, dua_res); on failure the inputs and
    the ADMM residuals come back unchanged (graceful degradation,
    polish.c:334-339)."""
    P = sp.csc_matrix(P, dtype=np.float64)
    if (abs(P - P.T) > 0).nnz:
        P = (sp.triu(P) + sp.triu(P, 1).T).tocsc()
    A = sp.csc_matrix(A, dtype=np.float64)
    q = np.asarray(q, np.float64).ravel()
    l = np.asarray(l, np.float64).ravel()
    u = np.asarray(u, np.float64).ravel()
    x = np.asarray(x, np.float64).ravel()
    y = np.asarray(y, np.float64).ravel()
    # The solve's results don't carry the ADMM z; at a solved point
    # the projection of Ax reproduces it to within pri_res, and the
    # multi-pass re-guess self-corrects residual misclassification.
    z = np.clip(A @ x, l, u)

    # The REFERENCE pipeline polishes the SCALED problem (polish.c runs
    # on the scaled workspace): there delta = 1e-6 is a relative
    # perturbation of unit-normed operators and the active-set guess is
    # made on scaled quantities.  Both matter on badly-scaled problems:
    # on raw CVXQP-scale data the same delta leaves the reduced KKT
    # numerically singular (measured pri ~ 9.9 on CVXQP1_M under EVERY
    # guess, while the identical machinery on the Ruiz-scaled problem
    # polishes the same point to acceptance — round-5 tools history).
    # Scale with a host Ruiz pass, polish in scaled space, evaluate
    # keep-best and acceptance on UNSCALED residuals.
    try:
        c_s, D_s, E_s = _ruiz(P, A, q)
    except Exception:
        c_s, D_s, E_s = 1.0, np.ones(P.shape[0]), np.ones(A.shape[0])
    Dm = sp.diags(D_s)
    Em = sp.diags(E_s) if A.shape[0] else sp.csc_matrix((0, 0))
    Ps = (c_s * (Dm @ P @ Dm)).tocsc()
    As = (Em @ A @ Dm).tocsc() if A.shape[0] else A
    qs = c_s * D_s * q
    ls = E_s * l
    us = E_s * u

    best = None  # (score, x_u, y_u, pri, dua)
    cx, cz, cy = x / D_s, E_s * z, (c_s / E_s) * y if A.shape[0] else y
    for _ in range(max(1, int(passes))):
        out = _reduced_kkt_polish(
            Ps, As, qs, ls, us, cx, cz, cy, float(delta), int(refine_iter),
            unscale=(c_s, D_s, E_s, P, A, q, l, u),
        )
        if out is None:
            break
        x_s, z_s, y_s, x_u, y_u, pri, dua = out
        score = max(pri, dua)
        if np.isfinite(score) and (best is None or score < best[0]):
            best = (score, x_u, y_u, pri, dua)
        cx, cz, cy = x_s, z_s, y_s

    if best is None:
        return False, x, y, None, admm_pri_res, admm_dua_res
    _, x_p, y_p, pri, dua = best
    # Acceptance (polish.c:301-314)
    ok = (
        (pri < admm_pri_res and dua < admm_dua_res)
        or (pri < admm_pri_res and admm_dua_res < 1e-10)
        or (dua < admm_dua_res and admm_pri_res < 1e-10)
    )
    if not ok:
        return False, x, y, None, admm_pri_res, admm_dua_res
    obj = float(0.5 * x_p @ (P @ x_p) + q @ x_p)
    return True, x_p, y_p, obj, pri, dua
