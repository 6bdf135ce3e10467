"""osqp_tpu_torch.benchmarks and the four model generators it brings
(``huber``, ``lasso``, ``least_squares``, ``svm``) against the JAX
package on the CPU.  The generators are numpy on both sides, so a seed
gives bit-identical data; the suite's solves (float64, polish on) are
held to the JAX package's ``run_suite`` on the default suite in
``tests/data/torch_goldens/families.npz`` (``tools/make_torch_goldens.py
families``): the same status, pass and iterations per instance."""

import os

import numpy as np
import pytest
import torch

import osqp_tpu.benchmarks as jbench
import osqp_tpu.models as jmodels
import osqp_tpu_torch.benchmarks as tbench
import osqp_tpu_torch.models as tmodels

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(REPO, "tests", "data", "torch_goldens", "families.npz")


def _equal(a, b):
    if hasattr(a, "toarray"):
        a, b = a.toarray(), b.toarray()
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert np.asarray(a).dtype == np.asarray(b).dtype


@pytest.mark.parametrize("family", list(jbench.FAMILIES))
def test_generate_suite_bit_identical(family):
    assert list(tbench.FAMILIES) == list(jbench.FAMILIES)
    got = tbench.generate_suite(dims=(10, 30), families=[family])
    want = jbench.generate_suite(dims=(10, 30), families=[family])
    assert [g[:2] for g in got] == [w[:2] for w in want] and len(got) == 4
    for g, w in zip(got, want):
        for a, b in zip(g[2:], w[2:]):
            _equal(a, b)


def test_stable_seed_matches():
    for parts in (("lasso", 10, 0, 0), ("control", 250, 1, 7)):
        assert tbench.stable_seed(*parts) == jbench.stable_seed(*parts)


@pytest.mark.parametrize("name", ["build_huber", "build_lasso", "build_least_squares", "build_svm"])
def test_generators_match_jax(name):
    rng = np.random.default_rng(3)
    Ad, b = rng.standard_normal((14, 6)), rng.standard_normal(14)
    args = {"build_huber": (Ad, b, 0.7), "build_lasso": (Ad, b, 0.3), "build_least_squares": (Ad, b, -1.0, 2.0),
            "build_svm": (Ad, np.sign(b), 0.5)}[name]
    for a, w in zip(getattr(tmodels, name)(*args), getattr(jmodels, name)(*args)):
        _equal(a, w)
    assert sorted(tmodels.__all__) == sorted(jmodels.__all__)


def test_run_suite_matches_jax_goldens():
    """run_suite at dims (10, 30), one instance each, on the CPU: each
    instance is instance 0 of the default suite, whose JAX results
    families.npz holds."""
    g = np.load(GOLDENS)
    rows, summary = tbench.run_suite(tbench.generate_suite(dims=(10, 30), instances=1), dtype="float64",
                                     device="cpu", verbose=False)
    assert len(rows) == 20 and summary["pass_rate"] == 1.0
    for r in rows:
        want = (int(g[f"{r['name']}/status_val"]), int(g[f"{r['name']}/iter"]), bool(g[f"{r['name']}/pass"]))
        assert (r["status_val"], r["iter"], r["pass"]) == want, r["name"]
        np.testing.assert_allclose(r["obj"], float(g[f"{r['name']}/obj"]), rtol=1e-6, atol=1e-6, err_msg=r["name"])


def test_run_suite_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tbench.run_suite(tbench.generate_suite(dims=(10,), instances=1, families=["eq_qp"]), verbose=False)
