"""osqp_tpu_torch.make_qp_layer against osqp_tpu.make_qp_layer on the CPU.

The same problems (``test_batch.random_qps`` at the seeds of
``tests/test_diff.py``) go through both packages' layers in float64.
On CPU tensors the backward pass runs K8's and K3's plain versions.
Gradients are held to ``jax.grad`` within 1e-6 max(1, |g|), the adjoint
solve to the JAX package's on the same inputs, and the layer to finite
differences: ``torch.autograd.gradcheck`` on q, A, l and u, and the JAX
test's symmetric differences on P, whose gradient is symmetrized.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osqp_tpu import diff as jdiff
import osqp_tpu_torch
from osqp_tpu_torch import diff as tdiff
from osqp_tpu_torch.ops import kkt_lu as k8
from osqp_tpu_torch.ops import term_products as k3
from test_batch import random_qps

torch.set_num_threads(2)

TIGHT = dict(eps_abs=1e-10, eps_rel=1e-10)
NAMES = ("P", "q", "A", "l", "u")


def _tensors(*arrays, grad=()):
    out = [torch.tensor(a, dtype=torch.float64) for a in arrays]
    for i in grad:
        out[i].requires_grad_(True)
    return out


def _port_grads(layer, args, w, argnums=range(5)):
    ts = _tensors(*args, grad=argnums)
    (torch.as_tensor(w) * layer(*ts)).sum().backward()
    return [ts[i].grad.numpy() for i in argnums]


def _assert_grads(got, want, names):
    for g, j, name in zip(got, want, names):
        j = np.asarray(j)
        assert np.all(np.abs(g - j) <= 1e-6 * np.maximum(1.0, np.abs(j))), (name, np.abs(g - j).max())


def test_gradients_match_jax():
    """dP, dq, dA, dl and du of sum(w x*) against jax.grad of the JAX
    layer (tests/test_diff.py's problem: B=2, n=4, m=6, seed 37)."""
    B, n, m = 2, 4, 6
    args = random_qps(B, n, m, seed=37)
    w = np.random.default_rng(1).standard_normal((B, n))
    jlayer = jdiff.make_qp_layer(**TIGHT)
    want = jax.grad(lambda *a: jnp.sum(jnp.asarray(w) * jlayer(*a)), argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(v) for v in args))
    got = _port_grads(osqp_tpu_torch.make_qp_layer(**TIGHT), args, w)
    _assert_grads(got, want, NAMES)
    # some rows active at each bound, so that dl and du are both exercised
    assert np.abs(got[3]).max() > 0 and np.abs(got[4]).max() > 0


@pytest.mark.parametrize("masked", ["solution", "random", "none"])
def test_adjoint_solve_matches_jax(masked):
    """_adjoint_solve on the same (P, A, mask, g, delta) as the JAX
    package's: the active set of a solution, a random mask, and none."""
    B, n, m = 3, 5, 7
    P, q, A, l, u = random_qps(B, n, m, seed=41)
    rng = np.random.default_rng(2)
    if masked == "solution":
        y = np.asarray(osqp_tpu_torch.solve_batch(P, q, A, l, u, device="cpu", dtype="float64",
                                                  verbose=False, polish=True, **TIGHT).y)
        mask = (np.abs(y) > 1e-8).astype(np.float64)
        assert mask.sum() > 0
    elif masked == "random":
        mask = (rng.random((B, m)) < 0.5).astype(np.float64)
    else:
        mask = np.zeros((B, m))
    g = rng.standard_normal((B, n))
    ju, jv = jdiff._adjoint_solve(*(jnp.asarray(v) for v in (P, A, mask, g)), 1e-9)
    tu, tv = tdiff._adjoint_solve(*_tensors(P, A, mask, g), 1e-9)
    for got, want in ((tu, ju), (tv, jv)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10 * max(1.0, np.abs(want).max()))
    assert np.all(tv.numpy()[mask == 0] == 0)


def test_adjoint_solve_runs_k8_blocks_and_k3():
    """The backward pass factors through K8's blocks entry once, solves
    1 + 3 times and takes the 3 refinement products from K3 (on CPU
    tensors their wrappers run the plain versions and count nothing, so
    the wrappers are spied on)."""
    P, q, A, l, u = random_qps(2, 4, 6, seed=37)
    seen = []
    real = (k8.kkt_lu_factor_blocks, k8.kkt_lu_solve, k3.term_products)

    def spy(name, f):
        def g(*a, **k):
            seen.append(name)
            return f(*a, **k)
        return g

    from osqp_tpu_torch.linsys import kkt_lu as backend
    try:
        backend.kkt_lu_factor_blocks = spy("factor", real[0])
        backend.kkt_lu_solve = spy("solve", real[1])
        tdiff.term_products = spy("k3", real[2])
        tdiff._adjoint_solve(*_tensors(P, A, np.ones((2, 6)), q), 1e-9)
    finally:
        backend.kkt_lu_factor_blocks, backend.kkt_lu_solve, tdiff.term_products = real
    assert seen == ["factor", "solve"] + ["k3", "solve"] * 3


def test_gradcheck_q_A_l_u():
    """torch.autograd.gradcheck on q, A, l and u at a point where polish
    succeeded (x* is piecewise linear there, so central differences are
    exact up to the solve's accuracy)."""
    P, q, A, l, u = random_qps(1, 3, 4, seed=43)
    res = osqp_tpu_torch.solve_batch(P, q, A, l, u, device="cpu", dtype="float64", verbose=False,
                                     polish=True, **TIGHT)
    assert res.status_polish.tolist() == [1]
    y = res.y.numpy()
    assert (np.abs(y) > 1e-6).any() and (np.abs(y) > 1e-6).sum() < 3  # some rows active, not all
    layer = osqp_tpu_torch.make_qp_layer(**TIGHT)
    Pt, qt, At, lt, ut = _tensors(P, q, A, l, u, grad=(1, 2, 3, 4))
    assert torch.autograd.gradcheck(lambda q_, A_, l_, u_: layer(Pt, q_, A_, l_, u_), (qt, At, lt, ut),
                                    eps=1e-6, atol=1e-6, rtol=1e-4)


def test_dP_matches_symmetric_finite_differences():
    """P is a symmetric parameter: perturbing (i, j) and (j, i) together
    moves the loss by g_ij + g_ji (tests/test_diff.py's check on P)."""
    B, n, m = 2, 4, 6
    P, q, A, l, u = random_qps(B, n, m, seed=37)
    w = np.random.default_rng(1).standard_normal((B, n))
    layer = osqp_tpu_torch.make_qp_layer(**TIGHT)
    (dP,) = _port_grads(layer, (P, q, A, l, u), w, argnums=(0,))
    np.testing.assert_allclose(dP, np.swapaxes(dP, -1, -2), atol=1e-12)
    loss = lambda P_: float((torch.as_tensor(w) * layer(*_tensors(P_, q, A, l, u))).sum())
    eps = 1e-6
    rng = np.random.default_rng(3)
    for _ in range(6):
        b, i, j = rng.integers(B), rng.integers(n), rng.integers(n)
        pert = np.zeros_like(P)
        pert[b, i, j] = pert[b, j, i] = eps
        an = dP[b, i, j] + dP[b, j, i] if i != j else dP[b, i, i]
        fd = (loss(P + pert) - loss(P - pert)) / (2 * eps)
        assert abs(fd - an) < 5e-4 * max(1.0, abs(fd)), (i, j, fd, an)


def test_inactive_bounds_get_zero_gradient():
    """With every bound far away, dl and du vanish (tests/test_diff.py)."""
    P, q, A, l, u = random_qps(1, 3, 4, seed=43)
    layer = osqp_tpu_torch.make_qp_layer(**TIGHT)
    dl, du = _port_grads(layer, (P, q, A, l - 100.0, u + 100.0), np.ones((1, 3)), argnums=(3, 4))
    assert np.all(dl == 0) and np.all(du == 0)


def test_only_requested_gradients_and_first_order_only():
    """Inputs that need no gradient get none; a gradient of the gradient
    raises (once_differentiable)."""
    P, q, A, l, u = random_qps(1, 3, 4, seed=43)
    layer = osqp_tpu_torch.make_qp_layer(**TIGHT)
    ts = _tensors(P, q, A, l, u, grad=(1,))
    x = layer(*ts)
    (gq,) = torch.autograd.grad(x.sum(), ts[1], create_graph=True)
    assert all(t.grad is None for t in ts)
    with pytest.raises(RuntimeError):
        torch.autograd.grad(gq.sum(), ts[1])


def test_neither_package_differentiates_twice():
    """A gradient of a gradient raises in both layers: the JAX package's
    backward pass runs its solve through a while_loop, which reverse mode
    refuses (ValueError), and the port's is once_differentiable
    (RuntimeError)."""
    P, q, A, l, u = random_qps(1, 3, 4, seed=43)
    jlayer = jdiff.make_qp_layer(**TIGHT)
    jargs = [jnp.asarray(v) for v in (P, q, A, l, u)]
    # loss = sum(x*^2): its dL/dx* = 2 x* carries q into the backward pass
    dq = lambda qq: jax.grad(lambda q_: jnp.sum(jlayer(jargs[0], q_, *jargs[2:]) ** 2))(qq)
    with pytest.raises(ValueError, match="Reverse-mode differentiation does not work"):
        jax.grad(lambda qq: jnp.sum(dq(qq)))(jargs[1])
    ts = _tensors(P, q, A, l, u, grad=(1,))
    x = osqp_tpu_torch.make_qp_layer(**TIGHT)(*ts)
    (gq,) = torch.autograd.grad((x ** 2).sum(), ts[1], create_graph=True)
    with pytest.raises(RuntimeError):
        torch.autograd.grad(gq.sum(), ts[1])


def test_layer_in_a_training_step():
    """q = Linear(features) feeds the layer inside an nn.Module; the
    Linear's weight and bias gradients equal the chain rule applied by
    hand to the layer's dq."""
    B, n, m, k = 2, 4, 6, 3
    P, _, A, l, u = random_qps(B, n, m, seed=37)
    torch.manual_seed(0)

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = torch.nn.Linear(k, n, dtype=torch.float64)
            self.qp = osqp_tpu_torch.make_qp_layer(**TIGHT)

        def forward(self, feats):
            return self.qp(*_tensors(P), self.lin(feats), *_tensors(A, l, u))

    net = Net()
    feats = torch.randn(B, k, dtype=torch.float64)
    w = torch.randn(B, n, dtype=torch.float64)
    opt = torch.optim.SGD(net.parameters(), lr=0.0)
    opt.zero_grad()
    (w * net(feats)).sum().backward()
    q = net.lin(feats).detach()
    (dq,) = _port_grads(net.qp, (P, q.numpy(), A, l, u), w.numpy(), argnums=(1,))
    np.testing.assert_allclose(net.lin.weight.grad.numpy(), dq.T @ feats.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(net.lin.bias.grad.numpy(), dq.sum(0), rtol=0, atol=1e-12)
    opt.step()
