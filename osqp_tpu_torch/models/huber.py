"""Huber fitting as a QP (copy of ``osqp_tpu/models/huber.py``, numpy only;
reference docs/examples/huber.rst).

    minimize sum_i huber_M(a_i' x - b_i)

with huber_M(t) = t^2 for |t| <= M and M(2|t| - M) beyond.  QP form over
z = (x, w, r, s):

    minimize    w'w + 2 M 1'(r + s)
    subject to  Ad x - b - w = r - s
                r >= 0,  s >= 0
"""

from __future__ import annotations

import numpy as np


def build_huber(Ad, b, M=1.0):
    Ad = np.asarray(Ad, np.float64)
    b = np.asarray(b, np.float64)
    m, n = Ad.shape
    nv = n + 3 * m
    P = np.zeros((nv, nv))
    P[n : n + m, n : n + m] = 2.0 * np.eye(m)
    q = np.zeros(nv)
    q[n + m :] = 2.0 * float(M)

    inf = np.inf
    A = np.zeros((3 * m, nv))
    l = np.zeros(3 * m)
    u = np.zeros(3 * m)
    # Ad x - w - r + s = b
    A[:m, :n] = Ad
    A[:m, n : n + m] = -np.eye(m)
    A[:m, n + m : n + 2 * m] = -np.eye(m)
    A[:m, n + 2 * m :] = np.eye(m)
    l[:m] = b
    u[:m] = b
    # r >= 0
    A[m : 2 * m, n + m : n + 2 * m] = np.eye(m)
    l[m : 2 * m] = 0.0
    u[m : 2 * m] = inf
    # s >= 0
    A[2 * m :, n + 2 * m :] = np.eye(m)
    l[2 * m :] = 0.0
    u[2 * m :] = inf
    return P, q, A, l, u
