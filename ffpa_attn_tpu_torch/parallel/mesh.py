"""Process-group bootstrap and device meshes over ``torch.distributed``.

* ``initialize_distributed``: ``torch.distributed.init_process_group`` from
  the variables ``torchrun`` sets (``MASTER_ADDR``, ``MASTER_PORT``,
  ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``); nothing happens when they are
  unset, so library code can call it unconditionally.
* ``make_mesh``: a ``DeviceMesh`` whose LAST axis holds adjacent ranks.
  ``torchrun`` numbers a host's processes consecutively, so that axis stays
  within one host, where its ranks share NVLink; put the sequence ring (sp)
  there and let the axis that crosses hosts be dp, whose gradient
  all-reduce is the traffic that tolerates the slower link.
* ``axis_group`` / ``axis_size`` / ``axis_rank``: one named axis's process
  group (None at size 1), size and this process's index along it.

Two hosts of 8 GPUs each, dp across the hosts and sp within one::

    # on each host
    torchrun --nnodes 2 --nproc-per-node 8 --rdzv-backend c10d \\
        --rdzv-endpoint host0:29500 train.py

    # train.py
    initialize_distributed()                      # NCCL on CUDA
    mesh = make_mesh((2, 8), ("dp", "sp"))
    model = shard_params(model, mesh, cfg)        # no tp axis: replicated
    step = make_train_step(cfg, opt, mesh=mesh, sp_axis="sp")

The ring's exchanges then stay on NVLink and only dp's all-reduce crosses
the network.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..env import resolve_device

_TORCHRUN_VARS = ("RANK", "WORLD_SIZE")


def initialize_distributed(
    backend: Optional[str] = None,
    timeout: Optional[timedelta] = None,
    *,
    init_method: str = "env://",
) -> None:
    """Start the default process group (idempotent).

    ``RANK`` and ``WORLD_SIZE`` come from the environment; with either
    unset this does nothing (one process, no group). ``backend`` defaults
    to ``nccl`` where CUDA is available and ``gloo`` otherwise; nothing
    switches it by itself. ``init_method`` is the rendezvous:
    ``env://`` (``MASTER_ADDR`` / ``MASTER_PORT``, as ``torchrun`` sets
    them) or another URL ``init_process_group`` takes, such as
    ``file://<path>``. Where CUDA is available the process's device is
    ``LOCAL_RANK`` modulo the cards the process sees, so that several
    ranks may share one card.
    """
    if dist.is_initialized():
        return
    if any(os.environ.get(v) is None for v in _TORCHRUN_VARS):
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if torch.cuda.is_available():
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")) % torch.cuda.device_count())
        # Initialised now, so that a DeviceMesh keeps this device and does
        # not set LOCAL_RANK's, which a card shared by several ranks lacks.
        torch.cuda.init()
    kwargs = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(
        backend, init_method=init_method, rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]), **kwargs,
    )


def make_mesh(
    axis_sizes: Sequence[int],
    axis_names: Sequence[str],
    *,
    device=None,
) -> DeviceMesh:
    """A ``DeviceMesh`` of ``axis_sizes`` over every rank of the default
    group, ranks laid out row-major so that the last axis holds adjacent
    ranks. ``device`` names the mesh's device type (CUDA unless the caller
    asks for another). Example: ``make_mesh((1, 2, 2), ("dp", "tp",
    "sp"))`` over 4 ranks."""
    if len(axis_sizes) != len(axis_names):
        raise ValueError(f"{len(axis_sizes)} axis sizes for {len(axis_names)} names")
    n = 1
    for s in axis_sizes:
        n *= int(s)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n != world:
        raise ValueError(f"mesh needs {n} devices, the process group has {world}")
    dev = resolve_device(device)
    return init_device_mesh(dev.type, tuple(int(s) for s in axis_sizes),
                            mesh_dim_names=tuple(axis_names))


def axis_size(mesh: Optional[DeviceMesh], name: Optional[str]) -> int:
    """The size of axis ``name`` (1 for no mesh, no name or a name the mesh
    lacks, as the JAX model's ``mesh.shape.get(axis, 1)``)."""
    if mesh is None or name is None or name not in (mesh.mesh_dim_names or ()):
        return 1
    return int(mesh.shape[mesh.mesh_dim_names.index(name)])


def axis_group(mesh: Optional[DeviceMesh], name: Optional[str]):
    """The process group of the ranks that differ only along ``name``, or
    None where the axis has size 1 (the collectives over it are then the
    identity)."""
    return mesh.get_group(name) if axis_size(mesh, name) > 1 else None


def axis_rank(mesh: Optional[DeviceMesh], name: Optional[str]) -> int:
    """This process's index along ``name`` (0 where ``axis_size`` is 1)."""
    if axis_size(mesh, name) == 1:
        return 0
    return int(mesh.get_local_rank(name))


__all__ = ["initialize_distributed", "make_mesh", "axis_group", "axis_size", "axis_rank"]
