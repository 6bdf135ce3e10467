"""osqp_tpu_torch's QPS I/O against the JAX package's: the native C++
parser (``io/native.py``, built from ``native/qps_parser.cpp`` into
``osqp_tpu_torch/_build/``), ``parse_qps_fast``, ``load_qps`` with its
native default and ``write_qps``.  Problems must be equal exactly: the
same matrices, vectors and objective constant."""

import os
import threading

import numpy as np
import pytest
import scipy.sparse as sp

from osqp_tpu.io.qps import load_qps as jload_qps
from osqp_tpu.io.qps_write import write_qps as jwrite_qps
from osqp_tpu_torch.benchmarks import generate_suite
from osqp_tpu_torch.io import native
from osqp_tpu_torch.io.qps import load_qps, parse_qps, parse_qps_fast
from osqp_tpu_torch.io.qps_write import write_qps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
MAROS = os.path.join(DATA, "maros_mm")
FILES = [os.path.join(DATA, f"{n}.qps") for n in ("HS21", "HS35", "HS51", "HS76")] + [
    os.path.join(MAROS, f"{n}.qps") for n in ("HS118", "GENHS28", "CVXQP2_M")
]


def _assert_equal(a, b):
    assert (a.name, a.n, a.m) == (b.name, b.n, b.m)
    for M, N in ((a.P, b.P), (a.A, b.A)):
        assert M.shape == N.shape and (sp.csc_matrix(M) != sp.csc_matrix(N)).nnz == 0
    for v, w in ((a.q, b.q), (a.l, b.l), (a.u, b.u)):
        np.testing.assert_array_equal(v, w)
    assert a.obj_constant == b.obj_constant


@pytest.fixture(scope="module")
def lib():
    lib = native.load_native()
    assert lib is not None, "the native QPS parser did not build"
    return lib


def test_native_library_lands_in_the_build_directory(lib):
    build = os.path.join(REPO, "osqp_tpu_torch", "_build")
    assert os.path.dirname(native._SO_PATH) == build and os.path.isfile(native._SO_PATH)
    assert not any(f.endswith(".so") for f in os.listdir(os.path.join(REPO, "osqp_tpu_torch", "io")))


def test_concurrent_builds_leave_one_library(lib, tmp_path, monkeypatch):
    """Builds racing for the library (xdist workers) each compile to a
    name of their own and move it into place: the result loads, and no
    temporary file is left behind."""
    monkeypatch.setattr(native, "_BUILD", str(tmp_path))
    monkeypatch.setattr(native, "_SO_PATH", str(tmp_path / "qps_native.so"))
    ok = []
    threads = [threading.Thread(target=lambda: ok.append(native._compile())) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert ok == [True] * 3 and os.listdir(tmp_path) == ["qps_native.so"]


@pytest.mark.parametrize("path", FILES, ids=lambda p: os.path.basename(p))
def test_parse_qps_fast_matches_python(lib, path):
    text = open(path).read()
    hint = os.path.splitext(os.path.basename(path))[0]
    _assert_equal(parse_qps_fast(text, hint), parse_qps(text, hint))


def test_native_error_reporting(lib):
    with pytest.raises(ValueError, match="unknown QPS section"):
        native.parse_qps_native("GARBAGE_SECTION\n x y z\n")


def test_no_native_switch_falls_back(monkeypatch):
    monkeypatch.setenv("OSQP_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    assert native.parse_qps_native(open(FILES[0]).read()) is None
    text = open(FILES[1]).read()
    _assert_equal(parse_qps_fast(text, "HS35"), parse_qps(text, "HS35"))


@pytest.mark.parametrize("name", ["HS21", "CVXQP2_S", "QPTEST"])
def test_load_qps_native_matches_jax(lib, name):
    path = os.path.join(DATA if name == "HS21" else MAROS, f"{name}.qps")
    _assert_equal(load_qps(path), jload_qps(path, native=True))
    _assert_equal(load_qps(path, native=True), load_qps(path, native=False))


@pytest.mark.parametrize("family", ["huber", "lasso", "portfolio", "primal_infeasible"])
def test_write_qps_matches_jax_bytes(lib, family, tmp_path):
    name, _, P, q, A, l, u = generate_suite(dims=(10,), instances=1, families=[family])[0]
    text = write_qps(name, P, q, A, l, u, obj_constant=1.5, path=str(tmp_path / "p.qps"))
    assert text == jwrite_qps(name, P, q, A, l, u, obj_constant=1.5)
    assert (tmp_path / "p.qps").read_text() == text
    back = load_qps(str(tmp_path / "p.qps"))
    assert back.obj_constant == 1.5 and back.n == q.shape[0]
