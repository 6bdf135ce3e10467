"""Lasso as a QP (copy of ``osqp_tpu/models/lasso.py``, numpy only;
reference docs/examples/lasso.rst).

    minimize 0.5 ||Ad x - b||^2 + gamma ||x||_1

QP form over z = (x, y, t), y = Ad x - b, |x| <= t:

    minimize    0.5 y'y + gamma 1't
    subject to  Ad x - y = b
                -t <= x <= t
"""

from __future__ import annotations

import numpy as np


def build_lasso(Ad, b, gamma):
    Ad = np.asarray(Ad, np.float64)
    b = np.asarray(b, np.float64)
    m, n = Ad.shape
    nv = n + m + n
    P = np.zeros((nv, nv))
    P[n : n + m, n : n + m] = np.eye(m)
    q = np.zeros(nv)
    q[n + m :] = float(gamma)

    inf = np.inf
    A = np.zeros((m + 2 * n, nv))
    l = np.zeros(m + 2 * n)
    u = np.zeros(m + 2 * n)
    # Ad x - y = b
    A[:m, :n] = Ad
    A[:m, n : n + m] = -np.eye(m)
    l[:m] = b
    u[:m] = b
    # x - t <= 0
    A[m : m + n, :n] = np.eye(n)
    A[m : m + n, n + m :] = -np.eye(n)
    l[m : m + n] = -inf
    u[m : m + n] = 0.0
    # x + t >= 0
    A[m + n :, :n] = np.eye(n)
    A[m + n :, n + m :] = np.eye(n)
    l[m + n :] = 0.0
    u[m + n :] = inf
    return P, q, A, l, u
