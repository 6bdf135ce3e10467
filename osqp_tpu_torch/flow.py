"""Device control flow for the traced solve (:mod:`osqp_tpu_torch.program`).

The live solve decides on the host: it reads a device value
(``linalg.host_read``) and branches in Python.  The program makes the
same decisions without a host read where it is traced:

* :func:`cond` is ``torch.ops.higher_order.cond`` under tracing and, run
  eagerly, one counted host read and a Python branch, as the live path;
* :func:`while_loop` is ``torch.ops.higher_order.while_loop`` under
  tracing and a Python loop that reads its predicate once a turn
  eagerly;
* :func:`program` marks the code that runs as the program, for the few
  places whose form differs there (``dense_inv``'s residual guard, the
  check's read of the active mask).

The operators are called themselves, not through ``torch.cond`` and
``torch._higher_order_ops.while_loop``: those wrappers compile their
arguments with dynamo, while the operators trace the branches and bodies
with ``make_fx``, which runs the solver's Python (dataclasses, the
backend registry, the kernels' plans) as it is.  So a branch or body must
be handed every tensor it reads: the operands here are nested structures
(tuples, dicts, dataclasses) flattened to their tensors, and a tensor
caught from an enclosing scope would be baked into the branch as a
constant, which ``torch.export.save`` refuses.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import types

import torch

from ._build import tracing
from .linalg import host_read

_in_program = contextvars.ContextVar("osqp_tpu_torch_program", default=False)


@contextlib.contextmanager
def program():
    """Run the enclosed code as the program (:func:`in_program`)."""
    token = _in_program.set(True)
    try:
        yield
    finally:
        _in_program.reset(token)


def in_program() -> bool:
    return _in_program.get()


# ---------------------------------------------------------------------------
# Nested operands as flat tensors
# ---------------------------------------------------------------------------
def _flatten(obj, leaves: list, seen: dict):
    """The tensors of ``obj`` appended to ``leaves`` once each (``seen``
    maps a tensor's id to its place), and a spec of the rest.  Tuples,
    lists, dicts and dataclasses nest, and a bound method nests as its
    object (an operator's ``plain`` products); any other value is
    static.  A tensor met twice (dense_inv's factor keeps the scaled P)
    is one operand: an operator's subgraph names its inputs after the
    operands, and two inputs of one name do not compile."""
    if isinstance(obj, torch.Tensor):
        if id(obj) not in seen:
            seen[id(obj)] = len(leaves)
            leaves.append(obj)
        return ("t", seen[id(obj)])
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return ("d", type(obj), tuple((f.name, _flatten(getattr(obj, f.name), leaves, seen))
                                      for f in dataclasses.fields(obj)))
    if isinstance(obj, types.MethodType):
        return ("b", obj.__func__, _flatten(obj.__self__, leaves, seen))
    if isinstance(obj, dict):
        return ("m", tuple((k, _flatten(v, leaves, seen)) for k, v in obj.items()))
    if isinstance(obj, (tuple, list)):
        return ("s", type(obj), tuple(_flatten(v, leaves, seen) for v in obj))
    return ("v", obj)


def _rebuild(spec, leaves):
    """``obj`` from :func:`_flatten`'s spec and its tensors."""
    kind = spec[0]
    if kind == "t":
        return leaves[spec[1]]
    if kind == "d":
        return spec[1](**{name: _rebuild(s, leaves) for name, s in spec[2]})
    if kind == "b":
        return types.MethodType(spec[1], _rebuild(spec[2], leaves))
    if kind == "m":
        return {k: _rebuild(s, leaves) for k, s in spec[1]}
    if kind == "s":
        return spec[1](_rebuild(s, leaves) for s in spec[2])
    return spec[1]


def flatten(obj, leaves=None, seen=None):
    """(tensors, spec) of ``obj``; ``leaves`` and ``seen`` continue an
    earlier flattening, whose tensors ``obj`` may share."""
    leaves = [] if leaves is None else leaves
    spec = _flatten(obj, leaves, {} if seen is None else seen)
    return leaves, spec


def rebuild(spec, leaves):
    return _rebuild(spec, list(leaves))


def _like(spec, obj, out: list) -> None:
    """``obj``'s tensors placed in ``out`` as ``spec`` (a flattening of the
    same structure) places its own; raises where the structure differs."""
    kind = spec[0]
    if kind == "t":
        if not isinstance(obj, torch.Tensor) or (out[spec[1]] is not None and out[spec[1]] is not obj):
            raise RuntimeError("while_loop: the body changes the carry's structure")
        out[spec[1]] = obj
    elif kind == "d":
        if type(obj) is not spec[1]:
            raise RuntimeError("while_loop: the body changes the carry's structure")
        for name, s in spec[2]:
            _like(s, getattr(obj, name), out)
    elif kind == "m":
        if list(obj) != [k for k, _ in spec[1]]:
            raise RuntimeError("while_loop: the body changes the carry's structure")
        for k, s in spec[1]:
            _like(s, obj[k], out)
    elif kind == "s":
        if type(obj) is not spec[1] or len(obj) != len(spec[2]):
            raise RuntimeError("while_loop: the body changes the carry's structure")
        for v, s in zip(obj, spec[2]):
            _like(s, v, out)
    elif obj != spec[1]:
        raise RuntimeError("while_loop: the body changes the carry's structure")


def _branch(fn, in_spec, out_specs):
    """``fn`` over rebuilt operands, its result flattened; the result's
    spec is kept in ``out_specs``."""

    def flat(*xs):
        out_leaves, out_spec = flatten(fn(*rebuild(in_spec, xs)))
        out_specs.append(out_spec)
        return tuple(out_leaves)

    return flat


# ---------------------------------------------------------------------------
# The two constructs
# ---------------------------------------------------------------------------
def cond(pred: torch.Tensor, true_fn, false_fn, operands: tuple):
    """``true_fn(*operands)`` where the one-element bool tensor ``pred`` is
    set, else ``false_fn(*operands)``.  Both return the same structure."""
    if not tracing(pred):
        return true_fn(*operands) if host_read(pred) else false_fn(*operands)
    leaves, spec = flatten(tuple(operands))
    specs: list = []
    out = torch.ops.higher_order.cond(
        pred.reshape(()), _branch(true_fn, spec, specs), _branch(false_fn, spec, specs), tuple(leaves)
    )
    if len(specs) != 2 or specs[0] != specs[1]:
        raise RuntimeError("cond: the branches return different structures")
    return rebuild(specs[0], out)


def while_loop(cond_fn, body_fn, carry, consts: tuple = ()):
    """``carry = body_fn(carry, *consts)`` while ``cond_fn(carry, *consts)``,
    a one-element bool tensor, is set; the body returns the carry's
    structure.  ``consts`` are read and not carried."""
    if not tracing():
        while host_read(cond_fn(carry, *consts)):
            carry = body_fn(carry, *consts)
        return carry
    c_leaves, c_spec = flatten(carry)
    seen = {id(t): i for i, t in enumerate(c_leaves)}
    leaves, k_spec = flatten(tuple(consts), list(c_leaves), seen)
    n = len(c_leaves)

    def flat_cond(*xs):
        return cond_fn(rebuild(c_spec, xs[:n]), *rebuild(k_spec, xs)).reshape(())

    def flat_body(*xs):
        out = [None] * n
        _like(c_spec, body_fn(rebuild(c_spec, xs[:n]), *rebuild(k_spec, xs)), out)
        return tuple(out)

    out = torch.ops.higher_order.while_loop(flat_cond, flat_body, tuple(c_leaves), tuple(leaves[n:]))
    return rebuild(c_spec, out)
