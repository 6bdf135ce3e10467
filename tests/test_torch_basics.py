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
        "s = osqp_tpu_torch.Solver(2 * e, [1.0], e, [-1.0], [1.0], verbose=False, dtype='float64');"
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
    ],
)
def test_make_config_matches_reference(kw):
    js, ts = jsolver.Settings(**kw), tsolver.Settings(**kw)
    jc = jsolver.make_config(5, 7, js, "float64")
    tc = tsolver.make_config(5, 7, ts, torch.float64)
    for f in ("n", "m", "max_iter", "check_termination", "adaptive_rho",
              "adaptive_rho_interval", "scaled_termination", "linsys_solver", "dtype"):
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
    for name in ("dense_chol", "kkt_lu", "cg", "block_tridiag", "mkl pardiso"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tlinsys.get(name)
    with pytest.raises(KeyError):
        tlinsys.get("nope")


@pytest.mark.parametrize("kw", [{"polish": True}, {"compact": True}, {"linsys_solver": "kkt_lu"}])
def test_unported_options_raise(kw):
    P, q, A, l, u = random_qps(2, 3, 4)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        osqp_tpu_torch.solve_batch(P, q, A, l, u, verbose=False, **kw)


def test_time_based_rho_rejected():
    P, q, A, l, u = random_qps(2, 3, 4)
    with pytest.raises(tcon.OSQPError):
        osqp_tpu_torch.solve_batch(P, q, A, l, u, adaptive_rho_time=True)
