"""QPS (MPS + QUADOBJ) writer for OSQP-form QPs.

A copy of ``osqp_tpu/io/qps_write.py`` (numpy and scipy only).  Inverse
of :mod:`osqp_tpu_torch.io.qps`: serializes

    minimize    0.5 x' P x + q' x  (+ obj_constant)
    subject to  l <= A x <= u

with free variables (all box structure lives in A, the form the solver
uses).  Row mapping: l == u -> E;  only u finite -> L;  only l finite
-> G;  both finite -> G with a RANGES entry of (u - l)  (the reader
widens G rows upward by |range|).  Fully-loose rows (both bounds
infinite) are dropped — they do not constrain the QP.

Used to generate QPS fixtures from the benchmark families so the parser
/ heterogeneous-bucketing harness is exercised at scale (the reference's
Maros-Meszaros role, README.md:42-43).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..constants import OSQP_INFTY

_INF_THRESH = 0.5 * OSQP_INFTY


def _fmt(v: float) -> str:
    return f"{float(v):.17g}"


def write_qps(name, P, q, A, l, u, obj_constant=0.0, path=None) -> str:
    """Serialize a QP to QPS text; optionally write to ``path``."""
    q = np.asarray(q, np.float64).ravel()
    n = q.shape[0]
    l = np.asarray(l, np.float64).ravel()
    u = np.asarray(u, np.float64).ravel()
    A = sp.csc_matrix(A) if not sp.issparse(A) else A.tocsc()
    P = sp.csc_matrix(P) if not sp.issparse(P) else P.tocsc()
    Pu = sp.triu(P, format="coo")

    vname = [f"X{j+1:07d}" for j in range(n)]
    keep = [
        i for i in range(A.shape[0])
        if (l[i] > -_INF_THRESH) or (u[i] < _INF_THRESH)
    ]
    rname = {i: f"C{k+1:07d}" for k, i in enumerate(keep)}

    lines = [f"NAME          {name}", "ROWS", " N  OBJ"]
    ranges = []
    rhs = []
    for i in keep:
        li, ui = l[i], u[i]
        nm = rname[i]
        if li > -_INF_THRESH and ui < _INF_THRESH:
            if li == ui:
                lines.append(f" E  {nm}")
                if li != 0.0:
                    rhs.append((nm, li))
            else:
                lines.append(f" G  {nm}")
                if li != 0.0:
                    rhs.append((nm, li))
                ranges.append((nm, ui - li))
        elif ui < _INF_THRESH:
            lines.append(f" L  {nm}")
            if ui != 0.0:
                rhs.append((nm, ui))
        else:
            lines.append(f" G  {nm}")
            if li != 0.0:
                rhs.append((nm, li))

    lines.append("COLUMNS")
    Ac = A.tocsc()
    for j in range(n):
        entries = []
        if q[j] != 0.0:
            entries.append(("OBJ", q[j]))
        s, e = Ac.indptr[j], Ac.indptr[j + 1]
        for ptr in range(s, e):
            i = Ac.indices[ptr]
            if i in rname and Ac.data[ptr] != 0.0:
                entries.append((rname[i], Ac.data[ptr]))
        if not entries:
            # emit a zero objective entry so the column (variable) exists
            entries.append(("OBJ", 0.0))
        for k in range(0, len(entries), 2):
            chunk = entries[k : k + 2]
            body = "   ".join(f"{rn}   {_fmt(v)}" for rn, v in chunk)
            lines.append(f"    {vname[j]}  {body}")

    lines.append("RHS")
    if obj_constant:
        # reader maps obj_constant = -RHS(OBJ)
        rhs.append(("OBJ", -float(obj_constant)))
    for nm, v in rhs:
        lines.append(f"    RHS1  {nm}   {_fmt(v)}")

    if ranges:
        lines.append("RANGES")
        for nm, v in ranges:
            lines.append(f"    RNG1  {nm}   {_fmt(v)}")

    lines.append("BOUNDS")
    for j in range(n):
        lines.append(f" FR BND  {vname[j]}")

    if Pu.nnz:
        lines.append("QUADOBJ")
        order = np.lexsort((Pu.row, Pu.col))
        for t in order:
            i, j, v = Pu.row[t], Pu.col[t], Pu.data[t]
            if v != 0.0:
                lines.append(f"    {vname[i]}  {vname[j]}   {_fmt(v)}")

    lines.append("ENDATA")
    text = "\n".join(lines) + "\n"
    if path is not None:
        with open(path, "w") as f:
            f.write(text)
    return text
