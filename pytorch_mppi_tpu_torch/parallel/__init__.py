"""Mesh-parallel MPPI over ``torch.distributed``.

The counterpart of ``pytorch_mppi_tpu/parallel``: the same solvers split
over the ranks of a process group, one rank a card.

* :func:`make_mesh` / :func:`initialize_multihost`: the process group and
  the ``DeviceMesh`` over it;
* ``MPPI(..., mesh=mesh)`` (also SMPPI and KMPPI): the K samples split over
  the ``sample_axis`` ranks; the fused kernel's per-rank statistics merge
  with three collectives (``ops/solve.make_sharded_transposed_solve``);
* ``MPPI_Batched(..., mesh=mesh)``: the N plants split over ``env_axis``
  (and optionally the K samples over ``sample_axis``).

Where JAX inserts collectives from sharding annotations, the port calls
them itself on the mesh axis's process group (:mod:`.mesh`).
"""
from .mesh import (Shard, all_gather_cat, axis_group, axis_rank, axis_size,
                   initialize_multihost, make_mesh)

__all__ = ["make_mesh", "initialize_multihost", "axis_group", "axis_rank", "axis_size",
           "Shard", "all_gather_cat"]
