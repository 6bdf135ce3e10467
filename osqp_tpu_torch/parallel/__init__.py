"""Several devices, one process each, on ``torch.distributed``
(counterpart of ``osqp_tpu/parallel``): the instance batch sharded over
a mesh (:mod:`.mesh`), one QP's constraint rows sharded over it
(:mod:`.intra` on the operand of :mod:`.rows`), and the helpers of a run
over several hosts (:mod:`.multihost`).

The names load at their first use: the solve path's modules import
:mod:`.rows`, and :mod:`.mesh` and :mod:`.intra` import the solve path.
"""

import importlib

_NAMES = {
    "solve_single_sharded": "intra",
    "solve_single_sharded_sparse": "intra",
    "make_mesh": "mesh",
    "solve_batch_sharded": "mesh",
    "allreduce_summary": "multihost",
    "global_batch_mesh": "multihost",
    "host_shard": "multihost",
    "initialize": "multihost",
}

__all__ = sorted(_NAMES)


def __getattr__(name):
    if name not in _NAMES:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f".{_NAMES[name]}", __name__), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
