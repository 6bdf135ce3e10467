"""Support-vector-machine hinge-loss QP (copy of ``osqp_tpu/models/svm.py``, numpy only;
reference docs/examples/svm.rst).

    minimize 0.5 x'x + lam * sum_i max(0, 1 - b_i a_i' x)

QP form over z = (x, t):

    minimize    0.5 x'x + lam 1't
    subject to  t >= 1 - diag(b) Ad x   (i.e. diag(b) Ad x + t >= 1)
                t >= 0
"""

from __future__ import annotations

import numpy as np


def build_svm(Ad, b, lam=1.0):
    Ad = np.asarray(Ad, np.float64)
    b = np.asarray(b, np.float64)
    m, n = Ad.shape
    nv = n + m
    P = np.zeros((nv, nv))
    P[:n, :n] = np.eye(n)
    q = np.zeros(nv)
    q[n:] = float(lam)

    inf = np.inf
    A = np.zeros((2 * m, nv))
    l = np.zeros(2 * m)
    u = np.zeros(2 * m)
    # diag(b) Ad x + t >= 1  (hinge)
    A[:m, :n] = b[:, None] * Ad
    A[:m, n:] = np.eye(m)
    l[:m] = 1.0
    u[:m] = inf
    # t >= 0
    A[m:, n:] = np.eye(m)
    l[m:] = 0.0
    u[m:] = inf
    return P, q, A, l, u
