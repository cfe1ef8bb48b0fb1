"""Collectives over a mesh axis (counterpart of
bigdl_tpu/parallel/collectives.py :15-74).

The reference builds its all-reduce by hand on Spark's block manager
(parameters/AllReduceParameter.scala): ``putGradients`` +
``aggregrateGradientPartition`` is a reduce-scatter, ``sendWeightPartition``
+ ``getWeights`` an all-gather.  Here each is one ``torch.distributed``
call over a process group (a ``Mesh``'s or an ``Axis``'s, or the
default group): NCCL on the card, gloo on the CPU.  Ring attention and
mixture-of-experts add ``ppermute``, ``ring_shift``, ``RingSend`` (one
hop of a ring, in flight while the caller computes) and a
differentiable ``all_to_all``, and the sums and gathers whose backward
a sharded layer needs (``psum``, ``sum_grad``, ``all_gather_own_grad``).
Tensor parallelism adds ``gather_dim`` / ``split_dim`` (a gather or an
own slice along any dim, the other as its backward) and ``sum_forward``
(a sum whose backward is the identity); pipeline parallelism the
stage-to-stage ``exchange`` (one ``batch_isend_irecv`` a tick).

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
    reference's whole AllReduceParameter cycle; the tensor-parallel
    decode step's no-grad merge of a branch's partial projection)."""
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


# -- point to point and all-to-all (ring attention, mixture of experts) -----

def _members(group):
    """(this rank's index on the axis, its size, the members' global
    ranks by index) of an ``Axis``, a ``Mesh`` or a process group."""
    ranks = getattr(group, "ranks", None)
    if ranks is not None:
        return group.index, len(ranks), ranks
    g = _group(group)
    n = dist.get_world_size(g)
    if g is None or g is dist.group.WORLD:
        return dist.get_rank(), n, tuple(range(n))
    return (dist.get_rank(g), n,
            tuple(dist.get_global_rank(g, i) for i in range(n)))


def ppermute(x: torch.Tensor, group, perm):
    """``lax.ppermute``: ``perm`` lists (source, destination) pairs of
    indices on the axis; each rank sends ``x`` to its destination and
    returns what its source sent (zeros where no pair names it as a
    destination).  One ``batch_isend_irecv``; no gradient."""
    idx, n, ranks = _members(group)
    dst = [d % n for s, d in perm if s % n == idx]
    src = [s % n for s, d in perm if d % n == idx]
    if len(dst) > 1 or len(src) > 1:
        raise ValueError(f"ppermute: rank {idx} appears twice in {perm}")
    x = x.contiguous()
    out = torch.zeros_like(x)
    if dst and src and dst[0] == idx and src[0] == idx:
        return out.copy_(x)
    p2p = []
    if dst:
        p2p.append(dist.P2POp(dist.isend, x, ranks[dst[0]]))
    if src:
        p2p.append(dist.P2POp(dist.irecv, out, ranks[src[0]]))
    if p2p:
        for work in dist.batch_isend_irecv(p2p):
            work.wait()
    return out


def ring_shift(x: torch.Tensor, group, shift: int = 1):
    """Shift values around the axis ring by ``shift`` positions: rank i's
    ``x`` lands on rank i + shift."""
    _, n, _ = _members(group)
    return ppermute(x, group, [(i, (i + shift) % n) for i in range(n)])


class RingSend:
    """One hop of a ring in flight: every rank sends a tensor to the next
    rank and receives the previous rank's into a new buffer.  Started on
    construction, so that the caller computes while it moves;
    :meth:`wait` returns the received tensor.  Two hops in flight at once
    take different ``tag``s."""

    def __init__(self, x: torch.Tensor, group, tag: int = 0):
        idx, n, ranks = _members(group)
        self.out = torch.empty_like(x)
        self.works = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, x, ranks[(idx + 1) % n], tag=tag),
            dist.P2POp(dist.irecv, self.out, ranks[(idx - 1) % n],
                       tag=tag)])
        self._x = x   # kept alive until the send completes

    def wait(self) -> torch.Tensor:
        for work in self.works:
            work.wait()
        self._x = None
        return self.out


def _all_to_all(x, group, split_axis, concat_axis, tiled):
    _, n, _ = _members(group)
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of {tuple(x.shape)} "
                         f"does not divide by {n}")
    if not tiled and x.shape[split_axis] != n:
        raise ValueError(f"all_to_all(tiled=False): dim {split_axis} must "
                         f"be the axis size {n}, got {tuple(x.shape)}")
    # chunk j (along split_axis) goes to rank j: move that axis first
    send = x.movedim(split_axis, 0).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=_group(group))
    if not tiled:
        # received chunk s (from rank s) at index s of a new leading axis,
        # which replaces split_axis and moves to concat_axis
        return recv.movedim(0, split_axis).movedim(split_axis, concat_axis)
    parts = recv.reshape(n, send.shape[0] // n, *send.shape[1:])
    parts = parts.movedim(1, split_axis + 1)
    return torch.cat(list(parts), dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis, tiled):
        ctx.args = (group, split_axis, concat_axis, tiled)
        return _all_to_all(x, group, split_axis, concat_axis, tiled)

    @staticmethod
    def backward(ctx, g):
        group, split_axis, concat_axis, tiled = ctx.args
        # the transpose moves every chunk back to where it came from
        return (_all_to_all(g.contiguous(), group, concat_axis, split_axis,
                            tiled), None, None, None, None)


def all_to_all(x: torch.Tensor, group, split_axis: int, concat_axis: int,
               tiled: bool = True):
    """``lax.all_to_all``: ``x`` split along ``split_axis`` into one chunk
    a rank, chunk j sent to rank j, the received chunks concatenated
    along ``concat_axis`` in rank order (``tiled``), or, with
    ``tiled=False`` (``split_axis`` of the axis size), stacked at
    ``concat_axis``.  Differentiable: the backward is the all-to-all that
    returns each chunk's gradient to its sender."""
    return _AllToAll.apply(x, group, split_axis, concat_axis, tiled)


# -- differentiable sums and gathers -------------------------------------

class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the axis on every rank, differentiable: each rank's
    copy of the sum feeds its own loss, so the backward sums the ranks'
    gradients too (``lax.psum``'s transpose)."""
    return _Psum.apply(x, group)


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


def sum_grad(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` unchanged; its gradient summed over the axis.  Where the
    ranks of an axis hold one value and each computes a different part of
    what depends on it (each its own experts), the value's gradient is
    the sum of the parts."""
    return _SumGrad.apply(x, group)


class _GatherOwn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        idx, n, _ = _members(group)
        ctx.part = (idx, x.shape[0])
        x = x.contiguous()
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=_group(group))
        return out

    @staticmethod
    def backward(ctx, g):
        idx, rows = ctx.part
        return g[idx * rows:(idx + 1) * rows], None


def all_gather_own_grad(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0 in rank order; the
    backward hands each rank its own rows of its own gradient.  That is
    the gradient where every rank of the axis holds the same loss (the
    same tokens): the other ranks' rows are theirs to differentiate, and
    a sum over the axis would count the loss once a rank."""
    return _GatherOwn.apply(x, group)


# -- tensor parallelism over the ``model`` axis ---------------------------
#
# The ranks of one model line compute the same loss from the same
# activations, each holding its slice of the sharded weights.  A value
# every rank holds whole has the same gradient on every rank; a slice
# has its own rows' gradient; a partial result's gradient is the whole
# value's.  ``sum_grad`` (identity forward, sum backward) enters a
# column-parallel product, whose input every slice of the output reads.

def _gather_along(x, group, dim):
    _, n, _ = _members(group)
    part = x.movedim(dim, 0).contiguous()
    out = part.new_empty((n * part.shape[0],) + tuple(part.shape[1:]))
    dist.all_gather_into_tensor(out, part, group=_group(group))
    return out.movedim(0, dim)


def _own_part(x, group, dim):
    idx, n, _ = _members(group)
    k = x.shape[dim] // n
    return x.narrow(dim, idx * k, k)


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.args = (group, dim)
        return _gather_along(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        group, dim = ctx.args
        return _own_part(g, group, dim).contiguous(), None, None


def gather_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order; the
    backward hands each rank its own part of the gradient (the output of
    a column-parallel product: each rank computed its columns)."""
    return _GatherDim.apply(x, group, dim % x.dim())


class _SplitDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.args = (group, dim)
        return _own_part(x, group, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        group, dim = ctx.args
        return _gather_along(g.contiguous(), group, dim), None, None


def split_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's part of ``x`` along ``dim`` (dim / n columns, in rank
    order); the backward gathers every rank's part of the gradient (the
    input of a row-parallel product: each part feeds one rank's rows)."""
    return _SplitDim.apply(x, group, dim % x.dim())


class _SumForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_forward(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of the ranks' partial ``x`` on every rank; the backward is
    the identity (the output of a row-parallel product: the sum is one
    value the one loss reads)."""
    return _SumForward.apply(x, group)


# -- pipeline parallelism: one exchange a tick ----------------------------

def exchange(sends, recvs, group=None):
    """Post the sends ``[(tensor, peer)]`` and receives ``[(buffer,
    peer)]`` (peers by their index on ``group``, an ``Axis``, or global
    ranks when it is None) in one ``batch_isend_irecv`` and wait for all
    of them: the NCCL sends block until received, so two stages that
    each sent first would wait on each other."""
    ranks = None if group is None else _members(group)[2]
    ops = [dist.P2POp(dist.isend, t.contiguous(),
                      p if ranks is None else ranks[p]) for t, p in sends]
    ops += [dist.P2POp(dist.irecv, b, p if ranks is None else ranks[p])
            for b, p in recvs]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
