"""The flat partition of the parameters (counterpart of
bigdl_tpu/parallel/sharding.py ``zero1_rule`` :50-62; ref
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
``shard_params_rule`` and ``zero1_tp_rule`` come with tensor
parallelism.
"""
from __future__ import annotations

import math

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

