"""Runs over several processes and hosts (counterpart of
``osqp_tpu/parallel/multihost.py``), on ``torch.distributed``.

One process drives one device.  A launcher starts them and tells each
its rank, the world's size and the rendezvous through the environment
(``torchrun --nproc-per-node=K script.py`` sets ``RANK``,
``LOCAL_RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``);
:func:`initialize` joins the group.  A Maros-Meszaros run split over the
processes, each solving its share of the files on its own card:

    from osqp_tpu_torch.maros import run_maros
    from osqp_tpu_torch.parallel import allreduce_summary, host_shard, initialize

    initialize()
    rank, world = host_shard()
    rows, summary = run_maros(paths, shard=(rank, world))
    total = allreduce_summary(summary)    # the counts of every process

The batch and the rows of one QP shard over a mesh of the group's ranks
(:func:`global_batch_mesh`, :mod:`.mesh`, :mod:`.intra`).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def local_rank() -> int:
    """The device index of this process on its host: ``LOCAL_RANK`` where
    the launcher sets it, else the rank modulo the host's CUDA devices."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    count = torch.cuda.device_count()
    return dist.get_rank() % count if count and dist.is_initialized() else 0


def initialize(**kwargs) -> None:
    """``torch.distributed.init_process_group`` with the environment's
    defaults (``init_method="env://"``; backend NCCL where CUDA is
    present, else gloo), and under NCCL this process's card made current
    (``LOCAL_RANK``).  A no-op when a group exists.  A real start-up
    failure (an unreachable rendezvous, a bad address) propagates:
    swallowing it would leave each process solving the whole workload
    alone."""
    if dist.is_initialized():
        return
    kwargs.setdefault("backend", "nccl" if torch.cuda.is_available() else "gloo")
    dist.init_process_group(**kwargs)
    if "nccl" in str(kwargs["backend"]):
        torch.cuda.set_device(local_rank())


def host_shard() -> tuple[int, int]:
    """(rank, world size) for splitting a work list; (0, 1) without a group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def _collective_device() -> torch.device:
    """Where the default group's collectives take their tensors: the
    current card under NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def global_batch_mesh(axis_name: str = "batch"):
    """A one-dimensional mesh over every rank of the job, on the cards
    under NCCL and on the CPU under gloo."""
    from torch.distributed.device_mesh import DeviceMesh

    device_type = _collective_device().type
    return DeviceMesh(device_type, list(range(dist.get_world_size())), mesh_dim_names=(axis_name,))


def allreduce_summary(summary: dict) -> dict:
    """Sum the count fields of each process's summary (``run_maros``'s)
    with one all-reduce, the only communication of such a run, and
    recompute ``pass_rate`` from the sums as final over problems (not a
    sum of the processes' rates).  Without a group, the summary as it
    is."""
    derived = {"pass_rate"}
    keys = sorted(k for k, v in summary.items() if isinstance(v, (int, float)) and k not in derived)
    out = dict(summary)
    if dist.is_initialized():
        vals = torch.tensor([float(summary[k]) for k in keys], dtype=torch.float64, device=_collective_device())
        dist.all_reduce(vals, op=dist.ReduceOp.SUM)
        for k, v in zip(keys, vals.cpu().tolist()):
            out[k] = int(round(v)) if isinstance(summary[k], int) else float(v)
    if "problems" in out:
        # run_maros's pass_rate is final / problems ("final": solved, or a
        # correctly certified infeasibility)
        num = out.get("final", out.get("solved", 0))
        out["pass_rate"] = num / max(out["problems"], 1)
    return out
