"""Linear-system backends behind one protocol (counterpart of
``osqp_tpu/linsys/__init__.py``; reference lin_sys.c:15-75).

Every backend module provides ``init(P, A, sigma, rho_vec)`` returning a
factor (a dict of tensors) and ``solve(factor, A, rho_vec, rhs_x, rhs_z)``
returning ``(x_tilde, z_tilde)``.  ``dense_inv`` also brings its own fused
loop bodies (K1, K1r); ``dense_chol`` and ``kkt_lu`` run the generic body
of :func:`osqp_tpu_torch.admm.run_segment` over their ``solve``.  The
reference names ``qdldl`` and ``mkl pardiso`` map onto ``dense_inv`` and
``kkt_lu``, as in the JAX package.  ``cg`` and ``block_tridiag`` are not
ported yet and raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

from . import dense_chol, dense_inv, kkt_lu

_REGISTRY = {"dense_inv": dense_inv, "dense_chol": dense_chol, "kkt_lu": kkt_lu}

_ALIASES = {"qdldl": "dense_inv", "mkl pardiso": "kkt_lu"}

_NOT_PORTED = {
    "block_tridiag": "ROADMAP queue 1, item 11",
    "cg": "ROADMAP queue 1, items 11-12",
}


def available() -> list[str]:
    return sorted(_REGISTRY)


def get(name: str):
    """Factory: init_linsys_solver (lin_sys.c:56-75)."""
    key = _ALIASES.get(str(name).lower(), str(name).lower())
    if key in _NOT_PORTED:
        raise NotImplementedError(
            f"linsys solver {name!r} is not ported to osqp_tpu_torch yet ({_NOT_PORTED[key]})"
        )
    if key not in _REGISTRY:
        raise KeyError(f"unknown linsys solver {name!r}; available: {available()}")
    return _REGISTRY[key]


def init_factor(cfg, P, A, sigma, rho_vec):
    """Factorize with the backend selected by ``cfg`` (StaticConfig)."""
    return get(cfg.linsys_solver).init(P, A, sigma, rho_vec)
