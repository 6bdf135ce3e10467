"""The instance batch sharded over devices (counterpart of
``osqp_tpu/parallel/mesh.py``), one process a device on
``torch.distributed``.

A mesh is a one-dimensional ``torch.distributed.device_mesh.DeviceMesh``
named by its axis; its collectives go through ``mesh.get_group(axis)``,
NCCL on the cards and gloo on the CPU.  :func:`solve_batch_sharded` gives
each rank a contiguous share of the B instances to solve on its own
device with :func:`osqp_tpu_torch.solve_batch`, with no collective in the
loop (every operation is per instance), then gathers every field so that
each rank returns the whole batch in order.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from ..batch import BatchSolveResults, solve_batch
from .multihost import local_rank
from .rows import all_gather


def make_mesh(n_devices: int | None = None, axis_name: str = "batch", device=None):
    """A one-dimensional mesh of ``n_devices`` ranks (every rank of the
    group by default), named ``axis_name``.  Each process drives the card
    ``cuda:LOCAL_RANK``, made current here, unless ``device="cpu"``.

    With no process group and one rank asked for, it starts a one-rank
    group itself on an in-process store: the single-card path, with no
    launcher (NCCL, or gloo for the CPU).  That group keeps no flight
    recorder (``TORCH_NCCL_TRACE_BUFFER_SIZE=0`` while it is made, unless
    the caller set the variable): with no peer to wait on, the record that
    would explain a hang costs ~0.4 ms of host time a collective on an
    H100's host, more than the collective itself.  More ranks than the group
    holds raise: start one process a device (``torchrun
    --nproc-per-node=K``) and call :func:`~osqp_tpu_torch.parallel.initialize`
    first.  A CUDA mesh needs NCCL in the group's backend: nothing is
    carried through gloo or the CPU instead."""
    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu and not torch.cuda.is_available():
        raise RuntimeError('make_mesh: no CUDA device; pass device="cpu" for a mesh on the CPU')
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise RuntimeError(f"make_mesh: {n_devices} ranks asked for and no process group: start one process "
                               f"a device with torchrun --nproc-per-node={n_devices} and call "
                               "osqp_tpu_torch.parallel.initialize()")
        _init_one_rank("gloo" if cpu else "nccl")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise RuntimeError(f"make_mesh: {n} ranks asked for, the process group holds {world}: start {n} processes "
                           f"with torchrun --nproc-per-node={n}")
    backend = str(dist.get_backend())
    if not cpu:
        if "nccl" not in backend:
            raise RuntimeError(f"make_mesh: a CUDA mesh needs NCCL, the process group's backend is {backend}")
        torch.cuda.set_device(local_rank())
    elif "gloo" not in backend:
        raise RuntimeError(f"make_mesh: a CPU mesh needs gloo, the process group's backend is {backend}")
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh("cpu" if cpu else "cuda", list(range(n)), mesh_dim_names=(axis_name,))


def _init_one_rank(backend: str) -> None:
    key = "TORCH_NCCL_TRACE_BUFFER_SIZE"
    before = os.environ.get(key)
    os.environ.setdefault(key, "0")
    try:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    finally:
        if before is None:
            del os.environ[key]


def mesh_group(mesh, axis_name: str, device=None):
    """(group, size, this rank in it, this rank's device) of a mesh; a rank
    outside the mesh raises."""
    if mesh.get_coordinate() is None:
        raise RuntimeError(f"rank {dist.get_rank()} is not in the mesh {mesh}")
    group = mesh.get_group(axis_name)
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device()) if mesh.device_type == "cuda" else "cpu"
    device = torch.device(device)
    if device.type != mesh.device_type:
        raise ValueError(f"device {device} is not of the mesh's type {mesh.device_type}")
    return group, dist.get_world_size(group), dist.get_rank(group), device


def solve_batch_sharded(P, q, A, l, u, mesh=None, axis_name: str = "batch", device=None, **settings
                        ) -> BatchSolveResults:
    """Solve B instances with B / W of them on each of the mesh's W ranks.

    B must be a multiple of W.  Rank r solves instances r B/W to (r + 1)
    B/W on its own device (``device``, else the mesh's card of this
    process) with :func:`~osqp_tpu_torch.solve_batch` and ``settings``
    (``x0``, ``y0`` split as the data are); then every field is gathered,
    so each rank returns the whole batch's :class:`BatchSolveResults` in
    order.  Every rank calls it with the same arguments."""
    mesh = mesh if mesh is not None else make_mesh(axis_name=axis_name, device=device)
    group, W, rank, dev = mesh_group(mesh, axis_name, device)
    B = (q.shape if isinstance(q, torch.Tensor) else np.shape(q))[0]
    if B % W != 0:
        raise ValueError(f"batch size {B} not divisible by mesh size {W}")
    k = B // W
    take = lambda v: v[rank * k:(rank + 1) * k] if v is not None else None
    for name in ("x0", "y0"):
        if name in settings:
            settings[name] = take(settings[name])
    res = solve_batch(*(take(v) for v in (P, q, A, l, u)), device=dev, **settings)
    return BatchSolveResults(*(all_gather(t, group, dim=0) for t in res))
