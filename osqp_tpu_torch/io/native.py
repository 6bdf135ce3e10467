"""ctypes binding for the native C++ QPS parser (``native/qps_parser.cpp``),
a copy of ``osqp_tpu/io/native.py`` that builds into the port's own
build directory.

The shared library is compiled with g++ at first use (a plain C ABI and
ctypes, no pybind) from the repository's ``native/`` directory into
``osqp_tpu_torch/_build/``, never into the package directory.  Several
processes may build at once (pytest-xdist workers): each compiles to a
name of its own and moves the result into place with ``os.replace``.
Every caller tolerates ``load_native() is None`` and falls back to the
pure-Python parser of :mod:`osqp_tpu_torch.io.qps`; ``OSQP_TPU_NO_NATIVE=1``
forces that fallback.  This is host parsing: no device path depends on it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import time

import numpy as np

_LOCK = threading.Lock()
_LIB = None
_TRIED = False
# Seconds the last compile took (0.0 when the library was already built).
build_seconds = 0.0

_HERE = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.normpath(os.path.join(_HERE, "..", "_build"))
_SO_PATH = os.path.join(_BUILD, "qps_native.so")
_SRC = os.path.normpath(os.path.join(_HERE, "..", "..", "native", "qps_parser.cpp"))


def _compile() -> bool:
    global build_seconds
    if not os.path.exists(_SRC):
        return False
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{_SO_PATH}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-o", tmp, _SRC]
    t0 = time.perf_counter()
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO_PATH)
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.remove(tmp)
        return False
    build_seconds = time.perf_counter() - t0
    return True


def load_native():
    """Return the loaded CDLL, compiling it first if needed, or None."""
    global _LIB, _TRIED
    if _LIB is not None:
        return _LIB
    if _TRIED or os.environ.get("OSQP_TPU_NO_NATIVE"):
        return _LIB
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        src_newer = (
            os.path.exists(_SRC)
            and os.path.exists(_SO_PATH)
            and os.path.getmtime(_SRC) > os.path.getmtime(_SO_PATH)
        )
        if (not os.path.exists(_SO_PATH) or src_newer) and not _compile():
            return None
        try:
            lib = ctypes.CDLL(_SO_PATH)
        except OSError:
            return None
        i64 = ctypes.c_int64
        p_i64 = ctypes.POINTER(i64)
        p_f64 = ctypes.POINTER(ctypes.c_double)
        lib.qps_parse.restype = ctypes.c_void_p
        lib.qps_parse.argtypes = [ctypes.c_char_p, i64]
        lib.qps_last_error.restype = ctypes.c_char_p
        lib.qps_dims.argtypes = [ctypes.c_void_p] + [p_i64] * 5
        lib.qps_fill.argtypes = [
            ctypes.c_void_p,
            p_i64, p_i64, p_f64,  # A triplets
            p_i64, p_i64, p_f64,  # Q triplets
            p_f64, p_f64, p_f64,  # q_lin, l_rows, u_rows
            p_f64, p_f64,         # lo, up
            p_f64,                # obj_rhs
            ctypes.c_char_p,      # name
        ]
        lib.qps_free.argtypes = [ctypes.c_void_p]
        _LIB = lib
        return _LIB


def parse_qps_native(text: str, name_hint: str = ""):
    """Parse QPS text with the C++ parser; returns the same raw pieces the
    Python tokenizer produces, or None when the library is unavailable."""
    lib = load_native()
    if lib is None:
        return None
    raw = text.encode()
    h = lib.qps_parse(raw, len(raw))
    if not h:
        raise ValueError("QPS parse error: " + lib.qps_last_error().decode(errors="replace"))
    try:
        i64 = ctypes.c_int64
        n = i64(); m = i64(); nnz_a = i64(); nnz_q = i64(); name_len = i64()  # noqa: E702
        lib.qps_dims(
            h,
            ctypes.byref(n), ctypes.byref(m), ctypes.byref(nnz_a),
            ctypes.byref(nnz_q), ctypes.byref(name_len),
        )
        n, m, nnz_a, nnz_q = n.value, m.value, nnz_a.value, nnz_q.value
        a_i = np.empty(nnz_a, np.int64)
        a_j = np.empty(nnz_a, np.int64)
        a_v = np.empty(nnz_a, np.float64)
        q_i = np.empty(nnz_q, np.int64)
        q_j = np.empty(nnz_q, np.int64)
        q_v = np.empty(nnz_q, np.float64)
        q_lin = np.zeros(n, np.float64)
        l_rows = np.empty(m, np.float64)
        u_rows = np.empty(m, np.float64)
        lo = np.empty(n, np.float64)
        up = np.empty(n, np.float64)
        obj_rhs = ctypes.c_double()
        name_buf = ctypes.create_string_buffer(max(name_len.value, 1))

        ptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))  # noqa: E731
        iptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))  # noqa: E731
        lib.qps_fill(
            h,
            iptr(a_i), iptr(a_j), ptr(a_v),
            iptr(q_i), iptr(q_j), ptr(q_v),
            ptr(q_lin), ptr(l_rows), ptr(u_rows),
            ptr(lo), ptr(up), ctypes.byref(obj_rhs), name_buf,
        )
        name = name_buf.raw[: name_len.value].decode(errors="replace")
        return {
            "name": name or name_hint,
            "n": n,
            "m": m,
            "a_trip": (a_i, a_j, a_v),
            "q_trip": (q_i, q_j, q_v),
            "q_lin": q_lin,
            "l_rows": l_rows,
            "u_rows": u_rows,
            "lo": lo,
            "up": up,
            "obj_rhs": obj_rhs.value,
        }
    finally:
        lib.qps_free(h)
