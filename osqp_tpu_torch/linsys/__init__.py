"""Linear-system backends behind one protocol (counterpart of
``osqp_tpu/linsys/__init__.py``; reference lin_sys.c:15-75).

Every backend module provides ``init(P, A, sigma, rho_vec, **options)``
returning a factor (a dict of tensors) and
``solve(factor, A, rho_vec, rhs_x, rhs_z, x0=None)`` returning
``(x_tilde, z_tilde)``; ``x0``, the previous iterate, warm-starts the
iterative ``cg`` and is ignored by the direct backends.  ``dense_inv``
also brings its own fused loop bodies (K1, K1r); ``dense_chol``,
``kkt_lu``, ``cg`` and ``block_tridiag`` run the generic body of
:func:`osqp_tpu_torch.admm.run_segment` over their ``solve``, and ``cg``
retunes its inner tolerance at each check (``update_tolerance``).
``block_tridiag`` takes the ``block_size`` setting (K7).  The reference
names ``qdldl`` and ``mkl pardiso`` map onto ``dense_inv`` and
``kkt_lu``, as in the JAX package.
"""

from __future__ import annotations

from . import block_tridiag, cg, dense_chol, dense_inv, kkt_lu

_REGISTRY = {
    "dense_inv": dense_inv,
    "dense_chol": dense_chol,
    "kkt_lu": kkt_lu,
    "cg": cg,
    "block_tridiag": block_tridiag,
}

_ALIASES = {"qdldl": "dense_inv", "mkl pardiso": "kkt_lu"}


def available() -> list[str]:
    return sorted(_REGISTRY)


def get(name: str):
    """Factory: init_linsys_solver (lin_sys.c:56-75)."""
    key = _ALIASES.get(str(name).lower(), str(name).lower())
    if key not in _REGISTRY:
        raise KeyError(f"unknown linsys solver {name!r}; available: {available()}")
    return _REGISTRY[key]


def init_factor(cfg, P, A, sigma, rho_vec):
    """Factorize with the backend and options selected by ``cfg``
    (StaticConfig): the one entry of setup, rho updates and bound-class
    changes."""
    return get(cfg.linsys_solver).init(
        P, A, sigma, rho_vec,
        cg_max_iter=cfg.cg_max_iter, cg_tol_fraction=cfg.cg_tol_fraction, block_size=cfg.block_size,
    )
