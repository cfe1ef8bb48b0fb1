"""Collectives over the ``data`` axis (counterpart of
bigdl_tpu/parallel/collectives.py :15-74).

The reference builds its all-reduce by hand on Spark's block manager
(parameters/AllReduceParameter.scala): ``putGradients`` +
``aggregrateGradientPartition`` is a reduce-scatter, ``sendWeightPartition``
+ ``getWeights`` an all-gather.  Here each is one ``torch.distributed``
call over a process group (a ``Mesh``'s, or the default group): NCCL on
the card, gloo on the CPU.  ``ppermute``, ``ring_shift`` and
``all_to_all`` come with ring attention and mixture-of-experts.

The flat forms take ``reduce_scatter_tensor`` and
``all_gather_into_tensor``, the names every torch since 2.0 has.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _group(group):
    return getattr(group, "group", group)


def axis_index(group=None) -> int:
    """This rank's index on the axis."""
    return dist.get_rank(_group(group))


def axis_size(group=None) -> int:
    return dist.get_world_size(_group(group))


def all_reduce(x: torch.Tensor, group=None, op=dist.ReduceOp.SUM):
    """Sum (or ``op``) across the axis, in place; returns ``x`` (the
    reference's whole AllReduceParameter cycle)."""
    dist.all_reduce(x, op=op, group=_group(group))
    return x


def all_reduce_mean(x: torch.Tensor, group=None):
    """The mean across the axis, in place: the sum, then a division in
    ``x``'s dtype (``lax.pmean``'s arithmetic)."""
    all_reduce(x, group)
    return x.div_(axis_size(group))


def reduce_scatter(x: torch.Tensor, group=None, out=None):
    """Sum and shard a flat tensor whose length divides by the axis
    size: rank r keeps the sum of ``x[r·L/N:(r+1)·L/N]`` (the reference's
    putGradients + aggregrateGradientPartition,
    AllReduceParameter.scala:202/162)."""
    n = axis_size(group)
    if x.dim() != 1 or x.numel() % n:
        raise ValueError(f"reduce_scatter: a flat tensor whose length "
                         f"divides by {n}, got {tuple(x.shape)}")
    if out is None:
        out = x.new_empty(x.numel() // n)
    dist.reduce_scatter_tensor(out, x, group=_group(group))
    return out


def all_gather(part: torch.Tensor, group=None, out=None):
    """Every rank's flat ``part``, concatenated in rank order (the
    reference's sendWeightPartition + getWeights,
    AllReduceParameter.scala:218/135).  ``part`` may be this rank's slice
    of ``out`` itself: NCCL gathers in place, and so does gloo (torch
    2.13; ``tests/test_torch_collectives.py`` holds it)."""
    g = _group(group)
    n = axis_size(group)
    if out is None:
        out = part.new_empty(part.numel() * n)
    if out.numel() != part.numel() * n:
        raise ValueError(f"all_gather: out holds {out.numel()}, the parts "
                         f"{part.numel()} x {n}")
    dist.all_gather_into_tensor(out, part, group=g)
    return out


def broadcast(x: torch.Tensor, src: int = 0, group=None):
    """Rank ``src``'s ``x`` on every rank, in place."""
    dist.broadcast(x, src, group=_group(group))
    return x
