"""The device mesh of the port (counterpart of bigdl_tpu/parallel/mesh.py
:19-45).

The JAX mesh names axes over the devices of one SPMD program; here each
device is one rank, and each axis is a ``torch.distributed`` process
group.  The axes:

- ``data``: one replica of the model a data slice, the batch split over
  the slices;
- ``seq``: the time dimension split over the ranks of a data slice
  (sequence parallelism: ring attention, ``nn/attention.py``);
- ``expert``: the experts of every ``nn.MoE`` split over the ranks of a
  data slice (expert parallelism, ``parallel/moe.py``);
- ``model``: the leaves that ``sharding.shard_params_rule`` shards split
  on dim 0 over the ranks of a data slice (tensor parallelism); the
  serving decoder (``ContinuousDecoder(mesh=)``) splits its heads and
  FFN hidden rows over it, a mesh without it, or with it of size 1,
  serving on one device;
- ``pipe``: the stages of a ``Sequential`` model, one a rank
  (pipeline parallelism, ``parallel/pipeline.py``).

A mesh is ``{"data"}`` alone or with one of ``seq``, ``expert`` and
``model``, or ``{"pipe"}`` with an optional ``data`` axis.  A rank's
coordinates follow the JAX mesh's device order, row-major over the
dict's axes (``devices.reshape(sizes)``): in ``{"data": d, "seq": s}``
rank r sits at data r // s and seq r % s.
"""
from __future__ import annotations

import numpy as np
import torch.distributed as dist

from bigdl_tpu_torch.utils.engine import Engine

AXES = ("data", "seq", "expert", "model", "pipe")
#: the axis sets a mesh of the port may have
MESHES = ({"data"}, {"data", "seq"}, {"data", "expert"}, {"data", "model"},
          {"pipe"}, {"data", "pipe"})


class Axis:
    """This rank's line along one axis of a mesh: the process group of the
    ranks that differ from it only there, its ``size``, this rank's
    ``index`` on it and the members' global ranks (``ranks``, by index)."""

    def __init__(self, name: str, group, ranks, index: int):
        self.name = name
        self.group = group
        self.ranks = tuple(int(r) for r in ranks)
        self.size = len(self.ranks)
        self.index = int(index)

    def __repr__(self):
        return f"Axis({self.name!r}, {self.index} of {self.size})"


class Mesh:
    """Named axes over the ranks of a process group (``group``: all of
    them, the world for a mesh of the whole world).  ``shape`` maps each
    axis to its size, ``size`` is their product; :meth:`axis` gives this
    rank's :class:`Axis` along one of them."""

    def __init__(self, group, shape: dict, axes: dict):
        self.group = group
        self.axis_names = tuple(shape)
        self.shape = {k: int(v) for k, v in shape.items()}
        self.size = int(np.prod(list(self.shape.values()), dtype=np.int64))
        self._axes = axes

    def rank(self) -> int:
        return dist.get_rank(self.group)

    def axis(self, name: str) -> Axis:
        if name not in self._axes:
            raise ValueError(f"mesh {self.shape} has no {name!r} axis")
        return self._axes[name]

    def coords(self) -> dict:
        """This rank's index on every axis."""
        return {k: a.index for k, a in self._axes.items()}

    def __repr__(self):
        return f"Mesh({self.shape})"


def make_mesh(axis_sizes: dict, device="cuda") -> Mesh:
    """A mesh from ``{axis: size}`` over one of the axis sets of
    ``MESHES``; one size may be ``-1`` (the world over the others').
    The world (the default group, formed by ``Engine.ensure_group`` for
    ``device`` when there is none) must hold exactly the product.  Every
    rank calls this together: each axis line is a new process group
    (``dist.new_group`` is a collective over the world)."""
    if set(axis_sizes) not in MESHES:
        raise ValueError(f"a mesh of the port has a 'data' axis alone or "
                         f"with one of 'seq', 'expert' and 'model', or a "
                         f"'pipe' axis with an optional 'data' axis; got "
                         f"{list(axis_sizes)}")
    group = Engine.ensure_group(device)
    world = dist.get_world_size(group)
    names = list(axis_sizes)
    sizes = [int(s) for s in axis_sizes.values()]
    if sizes.count(-1) > 1:
        raise ValueError(f"mesh {axis_sizes}: one size may be -1")
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        if known < 1 or world % known:
            raise ValueError(f"mesh {axis_sizes}: {world} ranks do not "
                             f"divide by {known}")
        sizes[sizes.index(-1)] = world // known
    total = int(np.prod(sizes))
    if min(sizes) < 1 or total != world:
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs {total} "
                         f"ranks, the world has {world}")
    rank = dist.get_rank(group)
    grid = np.arange(world).reshape(sizes)
    coords = np.unravel_index(rank, sizes)
    axes = {}
    for i, name in enumerate(names):
        if sizes[i] == world:
            # the whole world lies on this axis: its group is the world's
            axes[name] = Axis(name, group, range(world), coords[i])
            continue
        mine = None
        # every line of the axis, in one order on every rank
        moved = np.moveaxis(grid, i, -1).reshape(-1, sizes[i])
        for line in moved:
            g = dist.new_group([int(r) for r in line])
            if rank in line:
                mine = (g, line)
        axes[name] = Axis(name, mine[0], mine[1], coords[i])
    return Mesh(group, dict(zip(names, sizes)), axes)


def data_parallel_mesh(device="cuda") -> Mesh:
    """Pure data parallelism over every rank: the reference
    DistriOptimizer's topology."""
    return make_mesh({"data": -1}, device)


def hybrid_mesh(dp: int = -1, mp: int = 1, device="cuda") -> Mesh:
    """The (data, model) mesh of DP x TP hybrid sharding."""
    return make_mesh({"data": dp, "model": mp}, device)
