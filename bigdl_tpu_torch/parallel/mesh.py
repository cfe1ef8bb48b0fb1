"""The device mesh of the port (counterpart of bigdl_tpu/parallel/mesh.py
:19-45).

The JAX mesh names axes over the devices of one SPMD program; here each
device is one rank, and the ``data`` axis is a ``torch.distributed``
process group: one replica of the model a rank, the batch split over
the ranks.  The ``model``, ``seq``, ``pipe`` and ``expert`` axes (tensor,
sequence, pipeline and expert parallelism) come with a later slice
(ROADMAP queue 1, item 6) and raise.
"""
from __future__ import annotations

import torch.distributed as dist

from bigdl_tpu_torch.utils.engine import Engine

LATER_AXES = ("model", "seq", "pipe", "expert")
LATER = ("tensor, sequence, pipeline and expert parallelism come with a "
         "later slice of the port (ROADMAP queue 1, item 6)")


class Mesh:
    """A ``data`` axis over a process group: ``shape``, ``axis_names``,
    the group and this process's index on the axis."""

    def __init__(self, group, size: int):
        self.group = group
        self.axis_names = ("data",)
        self.shape = {"data": int(size)}
        self.size = int(size)

    def rank(self) -> int:
        return dist.get_rank(self.group)

    def __repr__(self):
        return f"Mesh({self.shape})"


def make_mesh(axis_sizes: dict, device="cuda") -> Mesh:
    """A mesh from ``{"data": n}``; ``-1`` takes the world size.  The
    world (the default group, formed by ``Engine.ensure_group`` for
    ``device`` when there is none) must hold exactly ``n`` ranks."""
    later = [a for a in axis_sizes if a in LATER_AXES]
    if later:
        raise NotImplementedError(f"mesh axes {later}: {LATER}")
    if set(axis_sizes) != {"data"}:
        raise ValueError(f"a mesh of the port has one 'data' axis, got "
                         f"{list(axis_sizes)}")
    group = Engine.ensure_group(device)
    world = dist.get_world_size(group)
    n = axis_sizes["data"]
    n = world if n == -1 else int(n)
    if n != world:
        raise ValueError(f"mesh {{'data': {n}}} needs {n} ranks, the "
                         f"world has {world}")
    return Mesh(group, n)


def data_parallel_mesh(device="cuda") -> Mesh:
    """Pure data parallelism over every rank: the reference
    DistriOptimizer's topology."""
    return make_mesh({"data": -1}, device)


def hybrid_mesh(dp: int = -1, mp: int = 1, device="cuda"):
    """(data, model) meshes need tensor parallelism: not ported yet."""
    raise NotImplementedError(f"hybrid_mesh: {LATER}")
