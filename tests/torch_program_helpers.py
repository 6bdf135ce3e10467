"""Shared pieces of the CPU tests of osqp_tpu_torch's traced programs for
the dense backends (``tests/test_torch_program_kkt.py``, ``_bt.py``,
``_cg.py``): bitwise comparison of a program's outputs with the live
solve, a spy on the rho refactors, and a process with torch alone that
runs format-2 blobs."""

import io
import os
import subprocess
import sys

import torch

from osqp_tpu_torch import admm, program

FIELDS = program.FIELDS


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1).view(torch.uint8) if t.dtype.is_floating_point else t


def differ(got, want) -> list:
    """Fields of ``got`` (the program's tuple, or a dict of fields) not bit
    for bit ``want``'s (a results tuple or a dict)."""
    got = got if isinstance(got, dict) else dict(zip(FIELDS, got))
    w = want if isinstance(want, dict) else want._asdict()
    return [f for f in FIELDS if not (got[f].dtype == w[f].dtype and torch.equal(bits(got[f]), bits(w[f])))]


def tensors(args, dtype: str):
    return [torch.as_tensor(v, dtype=getattr(torch, dtype)) for v in args]


def refactors(monkeypatch) -> list:
    """The ``upd`` masks (lists of bools) of every rho refactor that runs
    from here on (``admm._refactor``), eager solves only."""
    seen = []
    real = admm._refactor

    def spy(cfg, data, dyn, c, upd):
        seen.append(upd.tolist())
        return real(cfg, data, dyn, c, upd)

    monkeypatch.setattr(admm, "_refactor", spy)
    return seen


def partial(masks) -> bool:
    """Did some refactor update some instances and keep others?"""
    return any(any(m) and not all(m) for m in masks)


def graph_targets(module) -> set:
    return {n.target for _, g in module.named_modules() if hasattr(g, "graph")
            for n in g.graph.nodes if n.op == "call_function"}


def loaded_program(blob: bytes):
    spec = torch.load(io.BytesIO(blob), weights_only=True)
    return spec, torch.export.load(io.BytesIO(spec["programs"]["cpu"])).module()


# A process with torch alone: the two packages cannot be imported.  For
# each (blob, inputs, outputs) triple it runs the blob's CPU program and
# saves its outputs; it prints the osqp packages it imported.
_CHILD = """
import io, sys
sys.modules["osqp_tpu_torch"] = None
sys.modules["osqp_tpu"] = None
import torch
for blob, inputs, outputs in zip(*[iter(sys.argv[1:])] * 3):
    spec = torch.load(blob, weights_only=True)
    solve = torch.export.load(io.BytesIO(spec["programs"]["cpu"])).module()
    with torch.no_grad():
        out = solve(*torch.load(inputs))
    torch.save(dict(zip(spec["fields"], out)), outputs)
print(sorted(k for k, v in sys.modules.items() if k.startswith("osqp") and v is not None))
"""


def run_torch_alone(cases, tmp_path) -> list:
    """Run each (blob, input tensors) of ``cases`` in one process that
    cannot import either package; returns their outputs (dicts)."""
    argv = []
    for i, (blob, inputs) in enumerate(cases):
        paths = [tmp_path / f"{i}.{kind}" for kind in ("blob", "inputs", "outputs")]
        paths[0].write_bytes(blob)
        torch.save(list(inputs), paths[1])
        argv += [str(p) for p in paths]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _CHILD, *argv], capture_output=True, text=True, cwd=tmp_path,
                          env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "[]"
    return [torch.load(argv[3 * i + 2]) for i in range(len(cases))]
