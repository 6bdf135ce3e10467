"""K8's blocks entry point, ``kkt_lu_factor_blocks``, on the CPU.

The entry factors K = [[P + s I, A'], [A, -diag(d)]] from its blocks;
on the card the factor's first pass reads the blocks where it would
read K.  Each entry of K is the blocks' entry or one rounding of it
(``csrc/kkt_lu.cu``, ``Source::at``): P + s on the diagonal and P + 0
off it, A, -d.  Polish hands it A with the inactive rows zeroed, M A for
M = diag(mask).  Here that rule, rendered elementwise in
numpy, gives form_kkt's K bit for bit and the JAX package's by value; the
plain entry gives the bits of factoring form_kkt's K; and polish and the
``kkt_lu`` backend factor through the entry.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import osqp_tpu_torch
from osqp_tpu.linsys import kkt_lu as jkkt_lu
from osqp_tpu_torch.linsys import kkt_lu
from osqp_tpu_torch.ops import kkt_lu as k8
from osqp_tpu_torch.ops.kkt_lu import form_kkt
from test_batch import random_qps

torch.set_num_threads(2)


def _blocks(B, n, m, dtype, seed, masked):
    """Blocks from random data, with negative zeros among P's and A's
    entries; masked: polish's form (s = d = 1e-6, about half the rows of
    A zeroed by its mask), else the ADMM form (s = 1e-6, d = 1/rho)."""
    rng = np.random.default_rng(seed)
    P, _, A, _, _ = random_qps(B, n, m, seed=seed)
    P[:, 0, -1] = P[:, -1, 0] = -0.0
    if m:
        A[:, 0, 0] = -0.0
    T = lambda a: torch.as_tensor(a, dtype=dtype)
    if masked:
        mask = T(rng.random((B, m)) > 0.5)
        return T(P), mask[:, :, None] * T(A), 1e-6, T(np.full((B, m), 1e-6))
    return T(P), T(A), 1e-6, T(1.0 / (0.1 + np.abs(rng.standard_normal((B, m)))))


def _source_at(P, A, s, d):
    """K entry by entry as the kernels' first pass reads it, in numpy in
    the blocks' dtype: one rounding per entry."""
    P, A, d = P.numpy(), A.numpy(), d.numpy()
    B, n, _ = P.shape
    m = A.shape[1]
    t = P.dtype.type
    K = np.empty((B, n + m, n + m), dtype=P.dtype)
    K[:, :n, :n] = P + np.where(np.eye(n, dtype=bool), t(s), t(0))
    K[:, :n, n:] = A.transpose(0, 2, 1)
    K[:, n:, :n] = A
    K[:, n:, n:] = np.where(np.eye(m, dtype=bool)[None], -d[:, :, None], t(0))
    return K


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint32 if a.dtype == np.float32 else np.uint64)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("n,m", [(1, 0), (4, 6), (12, 20)])
def test_blocks_entry_matches_the_factor_of_form_kkt(dtype, masked, n, m):
    """lu and perm of the blocks entry (on CPU tensors its plain version)
    bit for bit those of kkt_lu_factor_plain on form_kkt's K."""
    P, A, s, d = _blocks(3, n, m, dtype, seed=n + m, masked=masked)
    lp, pp = k8.kkt_lu_factor_plain(form_kkt(P, A, s, d))
    lu, perm = k8.kkt_lu_factor_blocks(P, A, s, d)
    assert torch.equal(perm, pp) and torch.equal(lu, lp)
    assert np.array_equal(_bits(lu.numpy()), _bits(lp.numpy()))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("masked", [True, False])
def test_entry_rule_gives_form_kkt_and_the_reference_bit_for_bit(dtype, masked):
    """The first pass's rule for an entry of K against form_kkt bit for
    bit (signs of zeros included), and against the JAX package's
    form_kkt by value (its (2,2) block holds -0 off the diagonal)."""
    P, A, s, d = _blocks(2, 7, 9, dtype, seed=4, masked=masked)
    mine = _source_at(P, A, s, d)
    K = form_kkt(P, A, s, d).numpy()
    jd = jnp.float64 if dtype == torch.float64 else jnp.float32
    jK = np.asarray(jkkt_lu.form_kkt(jnp.asarray(P.numpy()), jnp.asarray(A.numpy()), jnp.asarray(s, jd),
                                     jnp.asarray(d.numpy())))
    assert np.array_equal(_bits(mine), _bits(K))
    assert np.array_equal(mine, jK)


@pytest.mark.parametrize("change,error", [
    (lambda P, A, d: (P.float(), A, d), ValueError),
    (lambda P, A, d: (P, A[:, :, :-1], d), ValueError),
    (lambda P, A, d: (P, A, d[:, :-1]), ValueError),
    (lambda P, A, d: (P[:, :, :-1], A, d), ValueError),
    (lambda P, A, d: (P.to(torch.float16), A.to(torch.float16), d.to(torch.float16)), TypeError),
])
def test_blocks_entry_rejects_bad_input(change, error):
    P, A, s, d = _blocks(2, 4, 6, torch.float64, seed=1, masked=True)
    P, A, d = change(P, A, d)
    with pytest.raises(error):
        k8.kkt_lu_factor_blocks(P, A, s, d)


@pytest.mark.parametrize("backend", ["dense_inv", "kkt_lu"])
def test_polish_and_the_kkt_lu_backend_factor_through_the_blocks_entry(monkeypatch, backend):
    """Polish (every pass) and the kkt_lu backend (setup and each rho
    update) hand the blocks to the entry; nothing forms K outside it."""
    calls = []
    real = kkt_lu.kkt_lu_factor_blocks

    def spy(P, A, s, d):
        calls.append(bool((d == s).all()))  # polish's K_delta: d = delta = the shift
        return real(P, A, s, d)

    monkeypatch.setattr(kkt_lu, "kkt_lu_factor_blocks", spy)
    P, q, A, l, u = random_qps(3, 6, 9, seed=2)
    r = osqp_tpu_torch.solve_batch(P, q, A, l, u, device="cpu", dtype="float64", polish=True, linsys_solver=backend,
                                   verbose=False)
    assert (r.status_polish == 1).all()
    assert calls.count(True) == 4  # polish: one factor a pass
    assert calls.count(False) == (0 if backend == "dense_inv" else 1 + int(r.rho_updates.max()))
