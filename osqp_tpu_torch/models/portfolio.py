"""Markowitz portfolio QP (copy of ``osqp_tpu/models/portfolio.py``, numpy
only; reference docs/examples/portfolio.rst).

    maximize mu'x - gamma x' (F F' + D) x
    subject to 1'x = 1, x >= 0

QP form over z = (x, y) with the factor trick y = F'x:

    minimize    gamma (x'Dx + y'y) - mu'x
    subject to  F'x - y = 0
                1'x = 1
                x >= 0
"""

from __future__ import annotations

import numpy as np


def build_portfolio(mu, F, D_diag, gamma=1.0):
    """(P, q, A, l, u) of the QP above over z = (x, y), with n + k
    variables and k + 1 + n constraints, for F of shape (n, k)."""
    mu = np.asarray(mu, np.float64)
    F = np.asarray(F, np.float64)
    D_diag = np.asarray(D_diag, np.float64)
    n, k = F.shape
    nv = n + k
    g = float(gamma)
    P = np.zeros((nv, nv))
    P[:n, :n] = 2.0 * g * np.diag(D_diag)
    P[n:, n:] = 2.0 * g * np.eye(k)
    q = np.zeros(nv)
    q[:n] = -mu

    inf = np.inf
    A = np.zeros((k + 1 + n, nv))
    l = np.zeros(k + 1 + n)
    u = np.zeros(k + 1 + n)
    # F'x - y = 0
    A[:k, :n] = F.T
    A[:k, n:] = -np.eye(k)
    # 1'x = 1
    A[k, :n] = 1.0
    l[k] = 1.0
    u[k] = 1.0
    # x >= 0
    A[k + 1 :, :n] = np.eye(n)
    l[k + 1 :] = 0.0
    u[k + 1 :] = inf
    return P, q, A, l, u
