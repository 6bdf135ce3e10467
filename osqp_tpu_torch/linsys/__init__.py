"""Linear-system backends behind one protocol (counterpart of
``osqp_tpu/linsys/__init__.py``; reference lin_sys.c:15-75).

Only ``dense_inv`` is ported.  The reference name ``qdldl`` maps onto
it, as in the JAX package.  The other backends of the JAX package raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

from . import dense_inv

_REGISTRY = {"dense_inv": dense_inv}

_ALIASES = {"qdldl": "dense_inv", "mkl pardiso": "kkt_lu"}

_NOT_PORTED = {
    "dense_chol": "ROADMAP queue 1, item 11",
    "kkt_lu": "ROADMAP queue 1, item 11",
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
