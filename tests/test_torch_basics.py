"""osqp_tpu_torch: constants, settings, version and import hygiene,
held against the JAX package where it has a counterpart."""

import os
import subprocess
import sys
import tomllib

import pytest
import torch

import osqp_tpu.constants as jcon
import osqp_tpu.solver as jsolver
import osqp_tpu_torch
import osqp_tpu_torch.constants as tcon
from osqp_tpu_torch import linsys as tlinsys
from osqp_tpu_torch import solver as tsolver
from test_batch import random_qps

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _public(mod):
    return {k: v for k, v in vars(mod).items() if k.isupper() or k in ("ErrorCode",)}


def test_constants_equal_name_by_name():
    j, t = _public(jcon), _public(tcon)
    assert sorted(j) == sorted(t)
    for name, value in j.items():
        if name == "ErrorCode":
            assert {e.name: e.value for e in value} == {e.name: e.value for e in t[name]}
        elif name == "ERROR_MESSAGE":
            assert {k.name: v for k, v in value.items()} == {k.name: v for k, v in t[name].items()}
        elif isinstance(value, float) and value != value:
            assert t[name] != t[name], name
        else:
            assert t[name] == value, name


def test_import_leaves_jax_out():
    code = (
        "import sys, osqp_tpu_torch, osqp_tpu_torch.convert, osqp_tpu_torch.io.qps, osqp_tpu_torch.sparse;"
        "import osqp_tpu_torch.ops.admm_iter, osqp_tpu_torch.ops.ruiz, osqp_tpu_torch.ops.term_products;"
        "import numpy as np; e = np.eye(1);"
        "s = osqp_tpu_torch.Solver(2 * e, [1.0], e, [-1.0], [1.0], device='cpu', verbose=False, dtype='float64');"
        "assert s.solve().info.status == 'solved';"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'osqp_tpu')];"
        "assert not bad, bad"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr


def test_version_is_pyproject_version():
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        assert osqp_tpu_torch.__version__ == tomllib.load(f)["project"]["version"]


def test_import_pins_full_f32_matmuls():
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"


@pytest.mark.parametrize(
    "kw",
    [
        {},
        {"check_termination": 0},
        {"check_termination": 10},
        {"adaptive_rho": False},
        {"adaptive_rho_interval": 7},
        {"scaled_termination": True, "max_iter": 99},
        {"linsys_solver": "cg", "eps_abs": 1e-6, "eps_rel": 1e-7, "cg_max_iter": 9},
    ],
)
def test_make_config_matches_reference(kw):
    js, ts = jsolver.Settings(**kw), tsolver.Settings(**kw)
    jc = jsolver.make_config(5, 7, js, "float64")
    tc = tsolver.make_config(5, 7, ts, torch.float64)
    for f in ("n", "m", "max_iter", "check_termination", "adaptive_rho",
              "adaptive_rho_interval", "scaled_termination", "linsys_solver", "dtype",
              "cg_max_iter", "cg_tol_fraction", "block_size"):
        assert getattr(tc, f) == getattr(jc, f), f


@pytest.mark.parametrize(
    "kw",
    [
        {"rho": 0.0},
        {"sigma": -1.0},
        {"alpha": 2.0},
        {"eps_abs": 0.0, "eps_rel": 0.0},
        {"max_iter": 0},
        {"adaptive_rho_tolerance": 0.5},
        {"linsys_solver": "nope"},
        {"time_limit": -1.0},
        {"polish_dtype": "int32"},
    ],
)
def test_settings_validation_matches_reference(kw):
    with pytest.raises(jcon.OSQPError) as je:
        jsolver.validate_settings(jsolver.Settings(**kw))
    with pytest.raises(tcon.OSQPError) as te:
        tsolver.validate_settings(tsolver.Settings(**kw))
    assert int(te.value.code) == int(je.value.code)
    assert str(te.value) == str(je.value)


def test_linsys_registry():
    assert tlinsys.get("qdldl") is tlinsys.get("dense_inv")
    assert tlinsys.get("mkl pardiso") is tlinsys.get("kkt_lu") is tlinsys.get("KKT_LU")
    assert tlinsys.get("dense_chol") is not tlinsys.get("dense_inv")
    assert tlinsys.get("CG") is tlinsys.get("cg") and "cg" in tlinsys.available()
    assert tlinsys.get("block_tridiag") is tlinsys.block_tridiag and "block_tridiag" in tlinsys.available()
    with pytest.raises(KeyError):
        tlinsys.get("nope")


@pytest.mark.parametrize(
    "kw",
    [{"sparse": True, "polish": True}, {"linsys_solver": "block_tridiag", "block_size": 3},
     {"compact": True, "min_compact_batch": 1}],
    ids=["sparse_polish", "block_tridiag", "compact"],
)
def test_formerly_unported_options_run(kw):
    """Polish on the sparse path (item 12), block_tridiag (item 11) and
    instance compaction (item 14), which raised until they were ported,
    now solve and give the JAX package's statuses."""
    import scipy.sparse as sp

    from osqp_tpu.batch import solve_batch as jsolve_batch
    from osqp_tpu.large import solve_sparse as jsolve_sparse

    P, q, A, l, u = random_qps(2, 3, 4)
    kw = dict(kw, dtype="float64", verbose=False)
    if kw.pop("sparse", False):
        args = (sp.csc_matrix(P[0]), q[0], sp.csc_matrix(A[0]), l[0], u[0])
        rt, rj = osqp_tpu_torch.solve_sparse(*args, device="cpu", **kw), jsolve_sparse(*args, **kw)
    else:
        rt, rj = osqp_tpu_torch.solve_batch(P, q, A, l, u, device="cpu", **kw), jsolve_batch(P, q, A, l, u, **kw)
    assert rt.status_val.tolist() == [int(v) for v in rj.status_val] and (rt.status_val == tcon.OSQP_SOLVED).all()
    assert rt.status_polish.tolist() == [int(v) for v in rj.status_polish]


@pytest.mark.parametrize("kw", [{"polish": True}, {"linsys_solver": "kkt_lu"}, {"linsys_solver": "dense_chol"},
                                {"linsys_solver": "mkl pardiso", "polish": True}, {"linsys_solver": "cg"},
                                {"linsys_solver": "cg", "polish": True}])
def test_ported_options_run(kw):
    """Polish and the dense and cg backends, which used to raise, solve."""
    P, q, A, l, u = random_qps(2, 3, 4)
    res = osqp_tpu_torch.solve_batch(P, q, A, l, u, device="cpu", dtype="float64", verbose=False, **kw)
    assert (res.status_val == tcon.OSQP_SOLVED).all()
    assert (res.status_polish == (1 if kw.get("polish") else 0)).all()


def test_time_based_rho_rejected():
    P, q, A, l, u = random_qps(2, 3, 4)
    with pytest.raises(tcon.OSQPError):
        osqp_tpu_torch.solve_batch(P, q, A, l, u, device="cpu", adaptive_rho_time=True)
