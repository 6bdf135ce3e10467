"""Box-constrained least squares (copy of ``osqp_tpu/models/least_squares.py``, numpy only;
reference docs/examples/least_squares.rst).

    minimize 0.5 ||Ad x - b||^2   subject to 0 <= x <= 1

QP form over z = (x, y) with y = Ad x - b:

    minimize    0.5 y'y
    subject to  Ad x - y = b
                0 <= x <= 1
"""

from __future__ import annotations

import numpy as np


def build_least_squares(Ad, b, lb=0.0, ub=1.0):
    Ad = np.asarray(Ad, np.float64)
    b = np.asarray(b, np.float64)
    m, n = Ad.shape
    nv = n + m
    P = np.zeros((nv, nv))
    P[n:, n:] = np.eye(m)
    q = np.zeros(nv)

    A = np.zeros((m + n, nv))
    l = np.zeros(m + n)
    u = np.zeros(m + n)
    A[:m, :n] = Ad
    A[:m, n:] = -np.eye(m)
    l[:m] = b
    u[:m] = b
    A[m:, :n] = np.eye(n)
    l[m:] = lb
    u[m:] = ub
    return P, q, A, l, u
