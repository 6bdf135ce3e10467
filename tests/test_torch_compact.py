"""Instance compaction of osqp_tpu_torch.solve_batch on the CPU.

Compaction only changes which instances share a launch, never the
per-instance arithmetic, so on CPU tensors (the kernels' plain versions)
``compact=True`` gives the plain path's results within 1e-10 with equal
iteration counts (tests/test_compact.py's rule), and the JAX package's
``compact=True`` statuses and iterations with x and y within 1e-6.  The
problems are tests/test_compact.py's.
"""

import re

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from osqp_tpu import constants as jcon
from osqp_tpu.batch import solve_batch as jsolve_batch
import osqp_tpu_torch
from osqp_tpu_torch import admm as tadmm
from osqp_tpu_torch import batch as tbatch
from osqp_tpu_torch import constants as tcon
from osqp_tpu_torch import large
from test_batch import random_qps

torch.set_num_threads(2)

FIELDS = ("x", "y", "status_val", "iter", "obj_val", "pri_res", "dua_res", "rho_updates", "status_polish",
          "prim_inf_cert", "dual_inf_cert")


def _infeasible(B, n, m, seed):
    """test_compact.py's batch with instances 3 and 9 made primal
    infeasible by contradictory duplicate rows."""
    P, q, A, l, u = random_qps(B, n, m, seed=seed)
    for i in (3, 9):
        A[i, 1] = A[i, 0]
        l[i, 0], u[i, 0] = 1.0, 2.0
        l[i, 1], u[i, 1] = 3.0, 4.0
    return P, q, A, l, u


CASES = {
    "dispersed": (lambda: random_qps(32, 8, 12, seed=11), dict(polish=True), 4),
    "infeasible": (lambda: _infeasible(16, 6, 8, seed=13), {}, 4),
    "max_iter": (lambda: random_qps(8, 6, 8, seed=17), dict(max_iter=30), 2),
}


def _widths(monkeypatch):
    """Record the working batch of every segment the driver runs."""
    seen = []
    real = tadmm.run_segment

    def spy(cfg, data, scl, dyn, c, end):
        seen.append(c.active.shape[0])
        return real(cfg, data, scl, dyn, c, end)

    monkeypatch.setattr(tadmm, "run_segment", spy)
    return seen


def _compare(a, b, atol=1e-10):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        np.testing.assert_allclose(np.asarray(x, np.float64), np.asarray(y, np.float64), rtol=0, atol=atol,
                                   err_msg=f)


@pytest.mark.parametrize("case", list(CASES))
def test_compact_equals_plain(case, monkeypatch):
    """compact=True against compact=False: every field within 1e-10,
    iterations equal, and the working batch did shrink."""
    make, kw, min_batch = CASES[case]
    args = make()
    kw = dict(kw, verbose=False, dtype="float64", device="cpu")
    plain = osqp_tpu_torch.solve_batch(*args, **kw)
    widths = _widths(monkeypatch)
    comp = osqp_tpu_torch.solve_batch(*args, compact=True, min_compact_batch=min_batch, **kw)
    _compare(comp, plain)
    assert comp.iter.tolist() == plain.iter.tolist()
    B = args[1].shape[0]
    assert widths[0] == B and (min(widths) < B or case == "max_iter"), widths  # 30 iterations: one poll
    assert all(w == B or (w & (w - 1) == 0 and w >= min_batch) for w in widths), widths
    if case == "dispersed":
        assert (plain.status_val == tcon.OSQP_SOLVED).all() and plain.iter.max() > plain.iter.min()
    if case == "infeasible":
        assert comp.status_val[3] == comp.status_val[9] == tcon.OSQP_PRIMAL_INFEASIBLE
    if case == "max_iter":
        assert (comp.status_val == tcon.OSQP_MAX_ITER_REACHED).any()


@pytest.mark.parametrize("case", list(CASES))
def test_compact_matches_jax_compact(case):
    """The port's compact=True against the JAX package's: statuses,
    status_polish and iterations equal, x and y within 1e-6, the
    certificates of infeasible instances too."""
    make, kw, min_batch = CASES[case]
    args = make()
    kw = dict(kw, verbose=False, dtype="float64")
    rt = osqp_tpu_torch.solve_batch(*args, compact=True, min_compact_batch=min_batch, device="cpu", **kw)
    rj = jsolve_batch(*args, compact=True, min_compact_batch=min_batch, **kw)
    for f in ("status_val", "iter", "status_polish", "rho_updates"):
        assert getattr(rt, f).tolist() == np.asarray(getattr(rj, f)).tolist(), f
    for f in ("x", "y", "prim_inf_cert", "dual_inf_cert"):
        np.testing.assert_allclose(getattr(rt, f).numpy(), np.asarray(getattr(rj, f)), rtol=0, atol=1e-6,
                                   err_msg=f)


@pytest.mark.parametrize("backend", ["kkt_lu", "cg", "dense_chol"])
def test_compact_every_dense_backend(backend, monkeypatch):
    """Each backend's factor goes through the gather: kkt_lu's integer
    perm, cg's 0-d leaves (max_iter, tol_frac) and its per-instance
    tolerance, dense_chol's factor; results as without compaction."""
    args = random_qps(16, 6, 8, seed=11)
    kw = dict(verbose=False, dtype="float64", device="cpu", linsys_solver=backend)
    plain = osqp_tpu_torch.solve_batch(*args, **kw)
    widths = _widths(monkeypatch)
    comp = osqp_tpu_torch.solve_batch(*args, compact=True, min_compact_batch=2, **kw)
    _compare(comp, plain)
    assert min(widths) < 16


def test_gather_shares_what_fields_share_and_passes_scalars():
    """dense_inv's factor keeps the scaled P: gathered once, still one
    tensor; 0-d leaves and host values pass through unchanged."""
    P, q, A, l, u = random_qps(4, 3, 5, seed=7)
    s = osqp_tpu_torch.Settings(dtype="float64")
    cfg = tbatch.make_config(3, 5, s, torch.float64)
    dyn = tbatch.DynSettings.make(torch.float64)
    t = [torch.as_tensor(v) for v in (P, q, A, l, u)]
    scaled, scl, rs, factor, it = tbatch._prepare(cfg, 10, *t, torch.full((4,), 0.1, dtype=torch.float64), dyn,
                                                  None, None)
    c = tadmm.init_carry(cfg, scaled, rs, factor, it)
    assert c.factor["P"] is scaled.P
    idx = torch.tensor([2, 0])
    memo = {}
    data2, c2 = (tbatch._gather(v, idx, memo) for v in (scaled, c))
    assert c2.factor["P"] is data2.P and torch.equal(data2.P, scaled.P[[2, 0]])
    assert c2.factor["sigma"] is c.factor["sigma"] and c2.k == c.k and c2.y_lo is None
    assert torch.equal(c2.factor["Minv"], c.factor["Minv"][[2, 0]])


def test_compact_verbose_prints_header_and_footer_only(capsys):
    """As in the JAX package: the live rows need a stable instance 0,
    which compaction re-indexes; the header and footer are printed, and
    the JAX package's compact output has the same lines (times aside)."""
    args = random_qps(32, 8, 12, seed=11)
    kw = dict(verbose=True, dtype="float64", compact=True, min_compact_batch=4)
    osqp_tpu_torch.solve_batch(*args, device="cpu", **kw)
    port = capsys.readouterr().out
    jsolve_batch(*args, **kw)
    jax_out = capsys.readouterr().out
    # the banner's two lines name the package; the run time differs
    strip = lambda t: [ln for i, ln in enumerate(t.strip().splitlines()) if i not in (1, 2) and "run time" not in ln]
    assert strip(port) == strip(jax_out)
    assert "status:               solved" in port and not re.search(r"^\s*(25|50|75)\s", port, re.M)


def test_compact_time_limit():
    """A time limit already spent stops at the first poll with
    TIME_LIMIT_REACHED, as the plain driver does."""
    args = random_qps(8, 6, 8, seed=17)
    res = osqp_tpu_torch.solve_batch(*args, device="cpu", dtype="float64", verbose=False, compact=True,
                                     min_compact_batch=2, time_limit=1e-9, eps_abs=1e-12, eps_rel=1e-12)
    assert (res.status_val == tcon.OSQP_TIME_LIMIT_REACHED).all()
    assert (res.iter == 25).all()


def test_compact_rejects_ell_operands():
    """compact=True with ELL (sparse) operands fails fast: the gather would
    corrupt the unbatched pattern (tests/test_compact.py)."""
    Pm = sp.eye(4, format="csr") * 2.0
    Am = sp.eye(4, format="csr")
    s, dtype, cfg, dyn, P_ell, A_ell, q, l, u = large.prepare_sparse(Pm, np.ones(4), Am, -np.ones(4),
                                                                    np.ones(4), {}, "cpu")
    with pytest.raises(tcon.OSQPError, match="compaction") as te:
        osqp_tpu_torch.solve_batch(P_ell, q, A_ell, l, u, compact=True, device="cpu")
    assert int(te.value.code) == int(jcon.ErrorCode.DATA_VALIDATION_ERROR)
