"""Process groups, device meshes and the collectives of a sharded solve.

The counterpart of ``pytorch_mppi_tpu/parallel/mesh.py``.  JAX builds a
``jax.sharding.Mesh`` over its devices and lets XLA insert collectives; the
port builds a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
a process group, one rank a card, and the solves call the collectives on
the process group of a mesh axis (:func:`axis_group`).  Every rank runs the
same program on its own share of the samples or plants.
"""
from __future__ import annotations

import logging
from typing import NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

logger = logging.getLogger(__name__)

__all__ = ["make_mesh", "initialize_multihost", "axis_group", "axis_rank", "axis_size",
           "Shard", "all_gather_cat"]


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("data", "k"), device=None):
    """A ``DeviceMesh`` over every rank of the process group.

    :param shape: the mesh's shape; by default every rank on the last axis
        (``(1, world)`` for the axis names ("data", "k")), as JAX's.
    :param axis_names: the axes' names; the solvers split plants over
        "data" and samples over "k" by convention.
    :param device: the ranks' device type: ``None`` means the card
        (``"cuda"``), ``"cpu"`` the CPU.
    :raises ValueError: a shape that does not cover the world, or no
        process group (:func:`initialize_multihost` makes one).
    """
    if not dist.is_initialized():
        raise ValueError("make_mesh needs a process group: call initialize_multihost "
                         "(or torch.distributed.init_process_group) first")
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    axis_names = tuple(axis_names)
    if shape is None:
        shape = (1,) * (len(axis_names) - 1) + (n,)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} and axis names {axis_names} differ in length")
    if int(torch.tensor(shape).prod()) != n:
        raise ValueError(f"mesh shape {shape} does not cover {n} devices")
    device = resolve_device(device, "make_mesh")
    if device.type == "cuda":
        # one rank a card, chosen before the mesh binds its communicators
        torch.cuda.set_device(device.index if device.index is not None
                              else dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(device.type, shape, mesh_dim_names=axis_names)


def initialize_multihost(coordinator_address=None, num_processes=None, process_id=None,
                         device=None):
    """Join (or form) the process group of a multi-process run:
    ``torch.distributed.init_process_group`` with NCCL on the card and Gloo
    on the CPU, a no-op when a group already exists.

    :param coordinator_address: ``"host:port"`` (TCP, as JAX's), or an
        ``init_method`` URL (``"tcp://..."``, ``"file://..."``); ``None``
        reads ``MASTER_ADDR``/``MASTER_PORT`` from the environment.
    :param num_processes: the world size; :param process_id: this rank.
    :param device: ``None`` (the card: NCCL) or ``"cpu"`` (Gloo), the one
        selector of the backend.  Gloo also carries CUDA tensors, so ranks
        that share one card (which NCCL refuses) join with ``"cpu"`` and
        build their mesh with ``make_mesh(device="cuda")``.
    """
    if dist.is_initialized():
        logger.info("multihost initialize skipped: a process group already exists "
                    "(rank %d of %d)", dist.get_rank(), dist.get_world_size())
        return
    device = resolve_device(device, "initialize_multihost")
    backend = "nccl" if device.type == "cuda" else "gloo"
    init_method = coordinator_address
    if init_method is not None and "://" not in init_method:
        init_method = f"tcp://{init_method}"
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id)


def _axis_index(mesh, name: str) -> int:
    names = tuple(mesh.mesh_dim_names or ())
    if name not in names:
        raise ValueError(f"mesh has no axis {name!r}; its axes are {names}")
    return names.index(name)


def axis_size(mesh, name: str) -> int:
    """The ranks along the mesh axis ``name``."""
    return int(mesh.size(_axis_index(mesh, name)))


def axis_rank(mesh, name: str) -> int:
    """This rank's index along the mesh axis ``name`` (JAX's
    ``axis_index``)."""
    _axis_index(mesh, name)
    return int(mesh.get_local_rank(name))


def axis_group(mesh, name: str):
    """The process group of this rank's ranks along the mesh axis ``name``,
    over which its collectives run."""
    _axis_index(mesh, name)
    return mesh.get_group(name)


def all_gather_cat(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' ``t`` of one group joined along ``dim`` in rank order
    (every rank's ``t`` of the same shape)."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class Shard(NamedTuple):
    """A rank's slice of a result that is split along ``dim`` over
    ``group``, of ``size`` items in all (the ranks' slices joined, then cut
    to ``size``): what an artifact of a sharded command holds until it is
    read.  :meth:`gather` is a collective: every rank of the group calls it,
    in the same order."""

    local: torch.Tensor
    dim: int
    group: object
    size: int

    def gather(self) -> torch.Tensor:
        local = self.local.gather() if isinstance(self.local, Shard) else self.local
        return all_gather_cat(local, self.dim, self.group).narrow(self.dim, 0, self.size)
