"""osqp_tpu_torch.export, the fixed-shape solver artifact, on the CPU.

The counterparts of tests/test_export.py's cases: the round trip against
the live solve (status and iterations equal, x within 1e-10),
``Solver.export`` writing what it returns, and the sparse round trip with
a P-value update; then the port's loaded callable against the JAX
package's loaded callable on the same inputs (float64: statuses and
iterations equal, x and y within 1e-6), and the refusals.  The sparse
tests share one format-2 blob (:func:`sparse_blob`: a trace, save and
load take ~20 s here); tests/test_torch_sparse_program.py holds the
sparse program to the live solve bit for bit.
"""

import io

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from osqp_tpu import export as jexport
import osqp_tpu_torch
from osqp_tpu_torch import export as texport
from osqp_tpu_torch.batch import solve_batch

torch.set_num_threads(2)


def _problems(B, n, m, seed=0):
    """tests/test_export.py's problems."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((B, n, n))
    P = np.einsum("bij,bkj->bik", M, M) / n + 0.2 * np.eye(n)
    q = rng.standard_normal((B, n))
    A = rng.standard_normal((B, m, n))
    x0 = rng.standard_normal((B, n))
    Ax = np.einsum("bmn,bn->bm", A, x0)
    l = Ax - 0.5 - np.abs(rng.standard_normal((B, m)))
    u = Ax + 0.5 + np.abs(rng.standard_normal((B, m)))
    return P, q, A, l, u


def _sparse_problem():
    """tests/test_export.py's sparse problem (n = 80)."""
    n = 80
    rng = np.random.default_rng(5)
    P = sp.diags(np.abs(rng.standard_normal(n)) + 1.0).tocsc()
    A = sp.vstack([sp.eye(n), sp.diags([1.0] * (n - 1), 1).tocsr()[: n - 1]]).tocsc()
    q = rng.standard_normal(n)
    m = A.shape[0]
    return P, q, A, -np.ones(m), np.ones(m)


# The shared sparse blob's batch and settings.
SPARSE_B = 2
SPARSE_KW = dict(dtype="float64", verbose=False)


@pytest.fixture(scope="module")
def sparse_blob(tmp_path_factory):
    """(SparseSolver, the path it wrote, the blob, its loaded callable):
    SparseSolver.export of the sparse problem for SPARSE_B instances, on
    the CPU."""
    P, q, A, l, u = _sparse_problem()
    s = osqp_tpu_torch.SparseSolver(P=P, q=q, A=A, l=l, u=u, device="cpu", **SPARSE_KW)
    path = tmp_path_factory.mktemp("sparse") / "sparse.bin"
    blob = s.export(path=str(path), B=SPARSE_B)
    return s, path, blob, texport.load_sparse_solver(blob, device="cpu")


def _sparse_inputs(q, l, u, qscale=(1.0, 0.5)):
    return np.stack([c * q for c in qscale]), np.stack([l] * SPARSE_B), np.stack([u] * SPARSE_B)


def test_export_roundtrip_matches_live_solve():
    B, n, m = 4, 6, 9
    args = _problems(B, n, m)
    blob = texport.export_solver(B, n, m, dtype="float64", platforms=["cpu"], polish=True, verbose=False)
    assert isinstance(blob, bytes) and len(blob) > 500
    out = texport.load_solver(blob, device="cpu")(*args)
    live = solve_batch(*args, device="cpu", dtype="float64", polish=True, verbose=False)
    assert list(out) == list(texport._FIELDS)
    assert (out["status_val"] == 1).all() and (out["status_polish"] == 1).all()
    assert out["iter"].tolist() == live.iter.tolist()
    for f in ("x", "y", "obj_val"):
        np.testing.assert_allclose(out[f].numpy(), getattr(live, f).numpy(), rtol=0, atol=1e-10, err_msg=f)


def test_solver_export_method(tmp_path):
    """Solver.export writes a loadable artifact, the bytes it returns, that
    matches the live solve."""
    P, q, A, l, u = (v[:1] for v in _problems(1, 5, 8, seed=4))
    s = osqp_tpu_torch.Solver(P=P[0], q=q[0], A=A[0], l=l[0], u=u[0], device="cpu", verbose=False, polish=True,
                              dtype="float64")
    live = s.solve()
    path = tmp_path / "solver.bin"
    blob = s.export(str(path))
    assert path.read_bytes() == blob
    out = texport.load_solver(blob, device="cpu")(P, q, A, l, u)
    assert int(out["status_val"][0]) == 1 and int(out["iter"][0]) == live.info.iter
    np.testing.assert_allclose(out["x"][0].numpy(), live.x, rtol=0, atol=1e-9)


def test_sparse_pattern_export_roundtrip(sparse_blob):
    """SparseSolver.export bakes the ELL pattern and value maps into the
    blob's program; the callable takes CSC-order value vectors, matches
    the live solver, and again after a P-value update pushed through
    both."""
    s, path, blob, fn = sparse_blob
    P, q, A, l, u = _sparse_problem()
    assert path.read_bytes() == blob
    Pu = sp.triu(P, format="csc")
    qs, ls, us = _sparse_inputs(q, l, u, (1.0, 1.0))
    out = fn(Pu.data, qs, A.data, ls, us)
    r = s.solve()
    assert out["status_val"].tolist() == [1, 1]
    np.testing.assert_allclose(out["x"].numpy()[0], r.x, atol=1e-6)
    out2 = fn(Pu.data * 2.0, qs, A.data, ls, us)
    s.update_P(Px=Pu.data * 2.0)
    r2 = s.solve()
    np.testing.assert_allclose(out2["x"].numpy()[0], r2.x, atol=1e-5)


@pytest.mark.parametrize("polish", [False, True])
def test_loaded_callable_matches_jax_artifact(polish):
    """The port's artifact against the JAX package's on the same inputs."""
    B, n, m = 4, 6, 9
    args = _problems(B, n, m, seed=2)
    kw = dict(dtype="float64", polish=polish, verbose=False, eps_abs=1e-6, eps_rel=1e-6)
    jout = jexport.load_solver(jexport.export_solver(B, n, m, **kw))(*args)
    tout = texport.load_solver(texport.export_solver(B, n, m, platforms=["cpu"], **kw), device="cpu")(*args)
    for f in ("status_val", "iter", "status_polish", "rho_updates"):
        assert tout[f].tolist() == np.asarray(jout[f]).tolist(), f
    for f in ("x", "y"):
        np.testing.assert_allclose(tout[f].numpy(), np.asarray(jout[f]), rtol=0, atol=1e-6, err_msg=f)


def test_sparse_loaded_callable_matches_jax_artifact(sparse_blob):
    P, q, A, l, u = _sparse_problem()
    Pu = sp.triu(P, format="csc")
    inputs = (Pu.data, *_sparse_inputs(q, l, u)[:1], A.data, *_sparse_inputs(q, l, u)[1:])
    jout = jexport.load_sparse_solver(jexport.export_sparse_solver(P, A, B=SPARSE_B, **SPARSE_KW))(*inputs)
    tout = sparse_blob[3](*inputs)
    assert tout["status_val"].tolist() == np.asarray(jout["status_val"]).tolist()
    assert tout["iter"].tolist() == np.asarray(jout["iter"]).tolist()
    for f in ("x", "y"):
        np.testing.assert_allclose(tout[f].numpy(), np.asarray(jout[f]), rtol=0, atol=1e-6, err_msg=f)


def test_blob_is_plain_data(sparse_blob):
    """The blob loads with torch.load(weights_only=True) and carries its
    format, the port's version, the shape, dtype, platforms and the full
    settings, and (format 2) the traced program and the torch that traced
    it; the sparse blob (format 2 too) also the pattern and value maps.
    A blob with a card program is test_torch_cuda.py's
    test_blob_is_plain_data_with_a_card_program."""
    blob = texport.export_solver(2, 3, 4, platforms=["cpu"], eps_abs=1e-5)
    spec = torch.load(io.BytesIO(blob), weights_only=True)
    assert spec["format"] == texport.FORMAT and spec["version"] == osqp_tpu_torch.__version__
    assert (spec["B"], spec["n"], spec["m"], spec["dtype"]) == (2, 3, 4, "float32")
    assert spec["platforms"] == ["cpu"] and spec["settings"]["eps_abs"] == 1e-5
    assert spec["format_version"] == 2 and spec["fields"] == list(texport._FIELDS)
    assert list(spec["programs"]) == ["cpu"] and isinstance(spec["programs"]["cpu"], bytes)
    assert spec["torch_version"] == str(torch.__version__) and "ops_library" not in spec
    P, q, A, l, u = _sparse_problem()
    spec = torch.load(io.BytesIO(sparse_blob[2]), weights_only=True)
    assert spec["format_version"] == 2 and spec["kind"] == "sparse" and spec["fields"] == list(texport._FIELDS)
    assert (spec["B"], spec["n"], spec["m"], spec["dtype"]) == (SPARSE_B, P.shape[0], A.shape[0], "float64")
    assert list(spec["programs"]) == ["cpu"] and isinstance(spec["programs"]["cpu"], bytes)
    assert spec["torch_version"] == str(torch.__version__) and "ops_library" not in spec
    assert spec["operands"]["A"]["nnz"] == A.nnz and spec["settings"]["linsys_solver"] == "cg"
    assert all(isinstance(t, torch.Tensor) for op in spec["operands"].values() for t in op["pattern"] + op["maps"])


def test_shape_dtype_and_platform_refused(sparse_blob):
    B, n, m = 2, 3, 4
    P, q, A, l, u = _problems(B, n, m)
    blob = texport.export_solver(B, n, m, dtype="float64", platforms=["cpu"])
    fn = texport.load_solver(blob, device="cpu")
    with pytest.raises(ValueError, match="q"):
        fn(P, q[:1], A, l, u)
    with pytest.raises(ValueError, match="A"):
        fn(P, q, A[:, :3], l, u)
    with pytest.raises(ValueError, match="float64"):
        fn(P.astype(np.float32), q, A, l, u)
    with pytest.raises(ValueError, match="float64"):
        fn(*(torch.tensor(v, dtype=torch.float32) for v in (P, q, A, l, u)))
    Pm, qm, Am, lm, um = _sparse_problem()
    sfn = sparse_blob[3]
    with pytest.raises(ValueError, match="P_val"):
        sfn(np.ones(3), *_sparse_inputs(qm, lm, um)[:1], Am.data, *_sparse_inputs(qm, lm, um)[1:])
    with pytest.raises(ValueError, match="float64"):
        sfn(sp.triu(Pm, format="csc").data.astype(np.float32), *_sparse_inputs(qm, lm, um)[:1], Am.data,
            *_sparse_inputs(qm, lm, um)[1:])
    # a blob for the card alone is refused on the CPU, and a card program
    # is traced on a card only; a blob of another torch is refused; a
    # dense blob by the sparse loader
    spec = torch.load(io.BytesIO(blob), weights_only=True)
    relabel = lambda **kw: texport._dump({k: v for k, v in spec.items() if k not in ("format", "format_version",
                                                                                  "version")} | kw, 2)
    with pytest.raises(ValueError, match="cuda"):
        texport.load_solver(relabel(platforms=["cuda"], programs={"cuda": spec["programs"]["cpu"]}), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            texport.export_solver(B, n, m, platforms=["cuda"])
    with pytest.raises(ValueError, match="torch 0.0"):
        texport.load_solver(relabel(torch_version="0.0"), device="cpu")
    with pytest.raises(ValueError, match="platforms"):
        texport.export_solver(B, n, m, platforms=["tpu"])
    with pytest.raises(ValueError, match="a dense artifact: load it with load_solver"):
        texport.load_sparse_solver(blob, device="cpu")
    with pytest.raises(osqp_tpu_torch.OSQPError):
        texport.export_sparse_solver(Pm, Am, linsys_solver="dense_inv")
