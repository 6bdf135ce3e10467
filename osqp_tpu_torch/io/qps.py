"""QPS (MPS + quadratic extension) reader -> OSQP-form QP.

The Maros-Meszaros benchmark set — the reference's headline accuracy
benchmark (README.md:42-43 via the osqp_benchmarks repo) — is
distributed as QPS files.  This reader produces the OSQP form

    minimize    0.5 x' P x + q' x  (+ obj_constant)
    subject to  l <= A x <= u

Constraint rows map as: E -> [rhs, rhs], L -> [-inf, rhs],
G -> [rhs, +inf]; RANGES widen them MPS-style.  Variable bounds
(default 0 <= x) are appended to A as identity rows, matching how the
osqp_benchmarks harness feeds boxes to OSQP.

A copy of the reader of ``osqp_tpu/io/qps.py``, which imports nothing
of jax: the pure-Python parser and its C++ fast path
(:func:`parse_qps_fast`, ``native/qps_parser.cpp`` built at first use by
:mod:`osqp_tpu_torch.io.native`), which ``load_qps`` takes by default and
which falls back to the Python parser when the library cannot be built.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import scipy.sparse as sp

INF = math.inf


@dataclass
class QPSProblem:
    name: str
    P: "sp.csc_matrix"  # (n, n) upper-triangular
    q: np.ndarray
    A: "sp.csc_matrix"  # (m, n) constraints + appended bound rows
    l: np.ndarray
    u: np.ndarray
    obj_constant: float = 0.0
    n: int = 0
    m: int = 0
    var_names: list = field(default_factory=list)
    row_names: list = field(default_factory=list)

    def as_tuple(self):
        return self.P, self.q, self.A, self.l, self.u


def _tokens(line: str):
    return line.split()


def parse_qps(text: str, name_hint: str = "") -> QPSProblem:
    """Parse QPS text.  Sections: NAME, ROWS, COLUMNS, RHS, RANGES,
    BOUNDS, QUADOBJ/QMATRIX, ENDATA."""
    name = name_hint
    section = None
    obj_row = None

    row_type: dict[str, str] = {}
    row_order: list[str] = []
    col_order: list[str] = []
    col_index: dict[str, int] = {}

    a_entries: list[tuple[int, int, float]] = []  # (row, col, val)
    q_lin: dict[int, float] = {}
    rhs: dict[str, float] = {}
    ranges: dict[str, float] = {}
    obj_rhs = 0.0
    q_entries: list[tuple[int, int, float]] = []  # quadratic (i, j, val)

    # variable bounds state: default [0, +inf)
    lo: dict[int, float] = {}
    up: dict[int, float] = {}
    explicit_lo: set[int] = set()

    row_index: dict[str, int] = {}

    def col_id(cname: str) -> int:
        if cname not in col_index:
            col_index[cname] = len(col_order)
            col_order.append(cname)
        return col_index[cname]

    for raw in text.splitlines():
        if not raw.strip() or raw.lstrip().startswith("*"):
            continue
        is_header = not raw[0].isspace()
        toks = _tokens(raw)
        if is_header:
            head = toks[0].upper()
            if head == "NAME":
                name = toks[1] if len(toks) > 1 else name
                section = "NAME"
            elif head in (
                "ROWS",
                "COLUMNS",
                "RHS",
                "RANGES",
                "BOUNDS",
                "QUADOBJ",
                "QMATRIX",
                "ENDATA",
                "OBJSENSE",
            ):
                section = head
            else:
                raise ValueError(f"unknown QPS section {head!r}")
            continue

        if section == "ROWS":
            rt, rname = toks[0].upper(), toks[1]
            if rt == "N":
                if obj_row is None:
                    obj_row = rname
            else:
                row_type[rname] = rt
                row_index[rname] = len(row_order)
                row_order.append(rname)

        elif section == "COLUMNS":
            cname = toks[0]
            j = col_id(cname)
            for rname, val in zip(toks[1::2], toks[2::2]):
                v = float(val)
                if rname == obj_row:
                    q_lin[j] = q_lin.get(j, 0.0) + v
                else:
                    a_entries.append((row_index[rname], j, v))

        elif section == "RHS":
            # first token is the RHS set name
            for rname, val in zip(toks[1::2], toks[2::2]):
                v = float(val)
                if rname == obj_row:
                    obj_rhs = v
                else:
                    rhs[rname] = v

        elif section == "RANGES":
            for rname, val in zip(toks[1::2], toks[2::2]):
                ranges[rname] = float(val)

        elif section == "BOUNDS":
            btype = toks[0].upper()
            # toks[1] = bounds set name, toks[2] = column
            j = col_id(toks[2])
            v = float(toks[3]) if len(toks) > 3 else 0.0
            if btype == "UP":
                up[j] = v
                # classic MPS quirk: UP with negative value and no
                # explicit lower bound implies lower = -inf
                if v < 0 and j not in explicit_lo:
                    lo[j] = -INF
            elif btype == "LO":
                lo[j] = v
                explicit_lo.add(j)
            elif btype == "FX":
                lo[j] = v
                up[j] = v
                explicit_lo.add(j)
            elif btype == "FR":
                lo[j] = -INF
                up[j] = INF
            elif btype == "MI":
                lo[j] = -INF
            elif btype == "PL":
                up[j] = INF
            elif btype == "BV":
                lo[j] = 0.0
                up[j] = 1.0
                explicit_lo.add(j)
            else:
                raise ValueError(f"unsupported bound type {btype!r}")

        elif section in ("QUADOBJ", "QMATRIX"):
            i = col_id(toks[0])
            j = col_id(toks[1])
            v = float(toks[2])
            q_entries.append((i, j, v))

        elif section in ("NAME", "OBJSENSE", "ENDATA", None):
            continue

    n = len(col_order)
    m_rows = len(row_order)

    # ---- constraint bounds from row types + RHS + RANGES ------------------
    l_rows = np.empty(m_rows)
    u_rows = np.empty(m_rows)
    for rname in row_order:
        i = row_index[rname]
        b = rhs.get(rname, 0.0)
        rt = row_type[rname]
        if rt == "E":
            lb, ub = b, b
        elif rt == "L":
            lb, ub = -INF, b
        elif rt == "G":
            lb, ub = b, INF
        else:
            raise ValueError(f"unknown row type {rt}")
        if rname in ranges:
            r = ranges[rname]
            if rt == "L":
                lb = b - abs(r)
            elif rt == "G":
                ub = b + abs(r)
            else:  # E
                if r >= 0:
                    ub = b + r
                else:
                    lb = b + r
        l_rows[i], u_rows[i] = lb, ub

    lo_arr = np.zeros(n)
    up_arr = np.full(n, INF)
    for j, v in lo.items():
        lo_arr[j] = v
    for j, v in up.items():
        up_arr[j] = v

    q = np.zeros(n)
    for j, v in q_lin.items():
        q[j] = v

    a_trip = (
        np.fromiter((i for (i, _, _) in a_entries), np.int64, len(a_entries)),
        np.fromiter((j for (_, j, _) in a_entries), np.int64, len(a_entries)),
        np.fromiter((v for (_, _, v) in a_entries), np.float64, len(a_entries)),
    )
    q_trip = (
        np.fromiter((min(i, j) for (i, j, _) in q_entries), np.int64, len(q_entries)),
        np.fromiter((max(i, j) for (i, j, _) in q_entries), np.int64, len(q_entries)),
        np.fromiter((v for (_, _, v) in q_entries), np.float64, len(q_entries)),
    )
    return _assemble(
        name or "qps", n, m_rows, a_trip, q_trip, q, l_rows, u_rows,
        lo_arr, up_arr, obj_rhs, col_order, row_order,
    )


def _assemble(
    name, n, m_rows, a_trip, q_trip, q, l_rows, u_rows, lo_arr, up_arr,
    obj_rhs, var_names=(), row_names=(),
) -> QPSProblem:
    """Build the OSQP-form QPSProblem from parsed raw pieces."""
    # Variable bounds appended as identity rows
    bounded = np.flatnonzero((lo_arr > -INF) | (up_arr < INF))
    A_c = sp.coo_matrix(
        (a_trip[2], (a_trip[0], a_trip[1])), shape=(m_rows, n)
    ).tocsc()
    if bounded.size:
        I_rows = sp.coo_matrix(
            (np.ones(bounded.size), (np.arange(bounded.size), bounded)),
            shape=(bounded.size, n),
        ).tocsc()
        A_full = sp.vstack([A_c, I_rows], format="csc")
        l_full = np.concatenate([l_rows, lo_arr[bounded]])
        u_full = np.concatenate([u_rows, up_arr[bounded]])
    else:
        A_full, l_full, u_full = A_c, l_rows, u_rows

    # Quadratic part: QUADOBJ gives one triangle of Q; objective is
    # 0.5 x' Q x, matching OSQP's P convention directly.
    if q_trip[2].size:
        P = sp.coo_matrix((q_trip[2], (q_trip[0], q_trip[1])), shape=(n, n)).tocsc()
        P = sp.triu(P, format="csc")
    else:
        P = sp.csc_matrix((n, n))

    return QPSProblem(
        name=name,
        P=P,
        q=q,
        A=A_full,
        l=l_full,
        u=u_full,
        obj_constant=-obj_rhs,  # MPS RHS on objective row is subtracted
        n=n,
        m=A_full.shape[0],
        var_names=list(var_names),
        row_names=list(row_names),
    )


def parse_qps_fast(text: str, name_hint: str = "") -> QPSProblem:
    """Parse with the native C++ tokenizer when available, else Python."""
    from .native import parse_qps_native

    raw = parse_qps_native(text, name_hint)
    if raw is None:
        return parse_qps(text, name_hint)
    return _assemble(
        raw["name"] or "qps",
        raw["n"],
        raw["m"],
        raw["a_trip"],
        raw["q_trip"],
        raw["q_lin"],
        raw["l_rows"],
        raw["u_rows"],
        raw["lo"],
        raw["up"],
        raw["obj_rhs"],
    )


def load_qps(path: str, native: bool = True) -> QPSProblem:
    """Read a QPS file (gzip if it ends in .gz) into OSQP form, with the
    native parser unless ``native`` is False."""
    import gzip
    import os

    if path.endswith(".gz"):
        with gzip.open(path, "rt") as f:
            text = f.read()
    else:
        with open(path) as f:
            text = f.read()
    hint = os.path.splitext(os.path.basename(path))[0]
    return (parse_qps_fast if native else parse_qps)(text, name_hint=hint)
