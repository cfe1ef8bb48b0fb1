"""The flat partition of the parameters and the tensor-parallel rules
(counterpart of bigdl_tpu/parallel/sharding.py ``shard_params_rule``
:34-47, ``zero1_rule`` :50-62 and ``zero1_tp_rule`` :64-83; ref
parameters/AllReduceParameter.scala:100-117).

The reference compacts every weight into one flat vector
(``getParameters``) and gives each of N partitions one contiguous slice
of it to update; the JAX package's compressed ZeRO-1 path ravels the
parameter tree and pads it to a multiple of N (``_z1c_flat``,
distri_optimizer.py:630-635).  :class:`FlatPartition` is that layout:
each leaf at an offset, the length padded to a multiple of the world
size, rank r owning ``[r·L/N, (r+1)·L/N)``: the owner partition of the
ZeRO-1 update, each rank updating its slice of the flat parameters with
its slice of the optimizer state (the reference's "update on MY slice",
DistriOptimizer.scala:232).

Leaves are packed end to end, the JAX ravel's layout, except where
``align`` asks for each leaf to start on a boundary: on the card a leaf
starts every 128 floats (512 bytes, the caching allocator's own
alignment), because cuDNN and cuBLAS choose their algorithms by a
pointer's alignment (PyTorch keys its cuDNN plans on it) and
``fused_sgd`` vectorises 16-byte-aligned leaves; a view into the flat
buffer then computes what a tensor of its own computes, bit for bit.

The rules give, leaf by leaf, the decision the JAX rule's
``PartitionSpec`` gives, as its tuple of axis names: ``("model",)``
(dim 0 split over the ``model`` axis), ``("model", "data")`` (and dim 1
over ``data``), ``("data",)`` (dim 0 over ``data``) or ``()``
(replicated).  Under tensor parallelism each rank holds rows ``[i·n/mp,
(i+1)·n/mp)`` of a leaf the first rule shards (``model_slice``).
"""
from __future__ import annotations

import math

def _sizes(mesh) -> dict:
    """Axis sizes of a ``Mesh`` or of a plain ``{axis: size}`` dict."""
    return dict(getattr(mesh, "shape", mesh))


def shard_params_rule(mesh, model_axis: str = "model"):
    """``rule(leaf) -> spec``: a leaf of two or more dims whose dim 0
    divides by the model axis splits dim 0 over it; any other leaf, and
    every leaf where the mesh has no model axis or one of size 1, is
    replicated.  ``leaf`` is a tensor, an array or a shape."""
    size = _sizes(mesh).get(model_axis, 1)
    if size == 1:
        return lambda x: ()

    def rule(x):
        shape = tuple(getattr(x, "shape", x))
        if len(shape) >= 2 and shape[0] % size == 0:
            return (model_axis,)
        return ()

    return rule


def zero1_tp_rule(mesh, data_axis: str = "data", model_axis: str = "model"):
    """ZeRO-1 composed with tensor parallelism: an optimizer-state leaf
    keeps its parameter's layout under :func:`shard_params_rule` and is
    split over ``data`` besides where divisible, on dim 1 for a leaf split
    over ``model`` and on dim 0 otherwise."""
    tp = shard_params_rule(mesh, model_axis)
    dsize = _sizes(mesh)[data_axis]

    def rule(x):
        shape = tuple(getattr(x, "shape", x))
        s = tp(shape)
        if s and s[0] == model_axis:
            if len(shape) >= 2 and shape[1] % dsize == 0:
                return (model_axis, data_axis)
            return s
        if len(shape) >= 1 and shape[0] % dsize == 0:
            return (data_axis,)
        return s

    return rule


def model_slice(rows: int, index: int, size: int) -> slice:
    """Rank ``index``'s rows of a dim 0 of ``rows`` split over ``size``."""
    n = rows // size
    return slice(index * n, (index + 1) * n)


#: the first element of each leaf is a multiple of this, by device kind
LEAF_ALIGN = {"cuda": 128}


def leaf_align(device) -> int:
    import torch

    return LEAF_ALIGN.get(torch.device(device).type, 1)


class FlatPartition:
    """Leaves of ``shapes`` packed into one flat vector of ``length``
    elements, a multiple of ``world``, each of the ``world`` ranks owning
    ``slice_len`` of them."""

    def __init__(self, shapes, world: int, align: int = 1):
        if world < 1 or align < 1:
            raise ValueError(f"world {world} and align {align} must be "
                             f">= 1")
        self.shapes = [tuple(s) for s in shapes]
        self.numels = [math.prod(s) for s in self.shapes]
        self.offsets = []
        end = 0
        for n in self.numels:
            start = -(-end // align) * align
            self.offsets.append(start)
            end = start + n
        #: parameters in the vector (the JAX ravel's length)
        self.n_params = sum(self.numels)
        #: the end of the last leaf
        self.total = end
        self.world = int(world)
        #: the padded flat length: ``total`` rounded up to the world
        self.length = -(-end // world) * world
        self.slice_len = self.length // world

    def owned(self, rank: int) -> slice:
        """Rank ``rank``'s elements of the flat vector."""
        if not 0 <= rank < self.world:
            raise ValueError(f"rank {rank} outside a world of {self.world}")
        return slice(rank * self.slice_len, (rank + 1) * self.slice_len)

    def views(self, flat) -> list:
        """Each leaf's view into ``flat`` (a tensor or an array of at
        least ``total`` elements), in its shape."""
        return [flat[o:o + n].reshape(s)
                for o, n, s in zip(self.offsets, self.numels, self.shapes)]

    def __repr__(self):
        return (f"FlatPartition({len(self.shapes)} leaves, {self.n_params} "
                f"params, length {self.length} = {self.world} x "
                f"{self.slice_len})")

