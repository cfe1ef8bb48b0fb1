"""Pipeline parallelism: the GPipe and 1F1B schedules over a ``pipe`` mesh
axis (counterpart of bigdl_tpu/parallel/pipeline.py ``pipeline_apply``
:46-158 and ``pipeline_train_1f1b`` :165-379).

The JAX package runs one stage function on every device inside
``shard_map``, a ``lax.scan`` of ticks with ``ppermute`` hops.  Here each
rank of the ``pipe`` axis is a process holding its own stage:
``stage_fn(x, m)`` runs this rank's modules on microbatch ``m``, the
activations move stage to stage by point-to-point sends, and eager
autograd runs each microbatch's backward through the graph its forward
kept (no recompute: a stage's graph stays alive while its microbatch is
in flight).

A schedule is a list of actions a stage, ``("F", m)`` and ``("B", m)``:

- **GPipe**: every microbatch's forward, then every backward (last
  first); at most M microbatches in flight.  With ``remat=True`` the
  stage runs under ``torch.utils.checkpoint`` and keeps only its input.
- **1F1B**: ``P - r - 1`` warm-up forwards on stage r, then one forward
  and one backward in turn, then the remaining backwards: at most
  ``P - r`` microbatches in flight, P on stage 0.

:func:`timeline` places every stage's actions on ticks, each at the
first tick after what it depends on (the previous stage's forward of the
microbatch, the next stage's backward of it).  Every rank computes the
same timeline, so at the end of a tick each rank posts exactly the
sends its action produced and the receives its neighbours' actions of
that tick produce for it, all in one ``batch_isend_irecv``
(``collectives.exchange``): both sides of every transfer post it at the
same tick, and no rank waits for another's later tick.  Idle ticks are
the schedule's bubble.

The loss of microbatch m is ``loss_fn(y, t) / (M · d)`` on the last
stage (d the ``data`` axis size), as the JAX engines take it; summed
over the microbatches (and the data replicas) it is the global batch's
mean loss.  State carried by a stage (batch normalisation's running
statistics) moves once per forward microbatch in forward order, under
either schedule: the forward order is the same.
"""
from __future__ import annotations

import functools

import torch

from bigdl_tpu_torch.parallel import collectives as coll
from bigdl_tpu_torch.utils.random import RNG

FWD, BWD = "F", "B"


def gpipe_order(stage: int, n_stages: int, n_micro: int,
                backward: bool = True) -> list:
    """GPipe's actions on ``stage``: every forward, then every backward,
    the last microbatch's first (the order of the JAX scan's
    transpose)."""
    acts = [(FWD, m) for m in range(n_micro)]
    if backward:
        acts += [(BWD, m) for m in reversed(range(n_micro))]
    return acts


def one_f_one_b_order(stage: int, n_stages: int, n_micro: int) -> list:
    """1F1B's actions on ``stage``: ``P - stage - 1`` warm-up forwards,
    then a forward and a backward in turn, then the backwards left."""
    warm = min(n_stages - stage - 1, n_micro)
    acts = [(FWD, m) for m in range(warm)]
    for i in range(n_micro - warm):
        acts += [(FWD, warm + i), (BWD, i)]
    acts += [(BWD, m) for m in range(n_micro - warm, n_micro)]
    return acts


ORDERS = {"gpipe": gpipe_order, "1f1b": one_f_one_b_order}


@functools.lru_cache(maxsize=64)
def timeline(schedule: str, n_stages: int, n_micro: int,
             backward: bool = True) -> tuple:
    """The ticks of ``schedule``: a tuple of ``{stage: action}``, each
    action at the first tick after the one its input came from."""
    if schedule == "gpipe" or not backward:
        orders = [gpipe_order(s, n_stages, n_micro, backward)
                  for s in range(n_stages)]
    else:
        orders = [ORDERS[schedule](s, n_stages, n_micro)
                  for s in range(n_stages)]
    done, pos, ticks = {}, [0] * n_stages, []
    while any(pos[s] < len(orders[s]) for s in range(n_stages)):
        row = {}
        for s in range(n_stages):
            if pos[s] == len(orders[s]):
                continue
            kind, m = orders[s][pos[s]]
            dep = ((FWD, m, s - 1) if kind == FWD and s > 0 else
                   (BWD, m, s + 1) if kind == BWD and s < n_stages - 1
                   else None)
            if dep is None or done.get(dep, len(ticks)) < len(ticks):
                row[s] = (kind, m)
        if not row:
            raise RuntimeError(f"{schedule} schedule stalled at tick "
                               f"{len(ticks)}")
        for s, (kind, m) in row.items():
            done[(kind, m, s)] = len(ticks)
            pos[s] += 1
        ticks.append(row)
    return tuple(ticks)


def bubble(ticks) -> float:
    """Idle ticks over ticks, of every stage together."""
    n_stages = 1 + max(s for row in ticks for s in row)
    idle = sum(n_stages - len(row) for row in ticks)
    return idle / (len(ticks) * n_stages)


def stage_function(modules, stage: int, step: int, device):
    """The stage function of ``modules`` (stage ``stage``) at training step
    ``step``: before microbatch m it seeds the package generator on
    ``device`` from (step, m, stage) (``RNG.derived_seed``, the JAX
    ``fold_in(fold_in(key, m), stage)``), so the stage's dropout draws
    one set of masks under either schedule and in a checkpoint's
    recompute."""
    gen = RNG.generator(device)

    def run(x, m):
        gen.manual_seed(RNG.derived_seed(step, m, stage))
        for mod in modules:
            x = mod(x)
        return x

    return run


class PipeResult:
    """What a schedule gave this rank: ``loss`` (the sum over the
    microbatches of the scaled losses: the last stage's, 0 elsewhere, or
    the pipe's sum when the loss was reduced), ``outputs`` (the last
    stage's outputs by microbatch, else None), the peak count of
    microbatches in flight on this stage, and the timeline."""

    def __init__(self, loss, outputs, peak_in_flight, ticks):
        self.loss = loss
        self.outputs = outputs
        self.peak_in_flight = peak_in_flight
        self.ticks = ticks

    @property
    def bubble(self) -> float:
        return bubble(self.ticks)


def run_schedule(schedule, stage_fn, axis, x_micro, in_shapes, dtypes=None,
                 loss_fn=None, t_micro=None, data_size=1, remat=False,
                 state_buffers=(), device=None, reduce_loss=True):
    """This rank's part of ``schedule`` (``"gpipe"`` or ``"1f1b"``) over
    the ``pipe`` ``axis``: ``stage_fn(x, m)`` is its stage; ``x_micro``
    the M microbatch inputs (stage 0 reads them; every rank passes a
    sequence of M, entries may be None elsewhere); ``in_shapes[s]`` /
    ``dtypes[s]`` stage s's input at a microbatch.  With ``loss_fn`` the
    last stage takes ``loss_fn(y, t_micro[m]) / (M · data_size)`` and
    every stage runs the backward, its gradients accumulating where
    autograd puts them; without it, the forwards alone.  The loss is
    summed over the pipe (every rank holds it) unless ``reduce_loss`` is
    False.  With ``remat`` each forward runs under ``torch.utils.
    checkpoint``, the recompute leaving ``state_buffers`` as the forward
    left them."""
    # the optimizer package imports this module: its helper comes late
    from bigdl_tpu_torch.optim.local_optimizer import remat as remat_

    idx, n_stages, _ = coll._members(axis)
    n_micro = len(x_micro)
    backward = loss_fn is not None
    ticks = timeline(schedule, n_stages, n_micro, backward)
    dtypes = dtypes or [torch.float32] * n_stages
    if device is None:
        known = [t for t in list(x_micro) + list(t_micro or []) if
                 isinstance(t, torch.Tensor)]
        device = known[0].device if known else torch.device("cpu")
    last = idx == n_stages - 1
    scale = 1.0 / (n_micro * data_size)
    inbox_x, inbox_g, held, outputs = {}, {}, {}, {}
    loss = torch.zeros((), dtype=torch.float32, device=device)
    peak = 0

    def forward(m):
        nonlocal loss, peak
        if idx == 0:
            x = x_micro[m]
        else:
            x = inbox_x.pop(m)
            if backward:
                x.requires_grad_(True)
        y = (remat_(lambda xx: stage_fn(xx, m), x, state_buffers)
             if remat else stage_fn(x, m))
        if last:
            if backward:
                lm = loss_fn(y, t_micro[m]) * scale
                loss = loss + lm.detach().float()
                held[m] = (x, lm)
            else:
                outputs[m] = y
        elif backward:
            held[m] = (x, y)
        peak = max(peak, len(held))
        return y

    def backward_(m):
        x, out = held.pop(m)
        grad = None if last else inbox_g.pop(m)
        if out.requires_grad:
            torch.autograd.backward(out, grad)
        if idx == 0:
            return None
        return x.grad if x.grad is not None else torch.zeros_like(x)

    for row in ticks:
        act = row.get(idx)
        sends = []
        if act is not None:
            kind, m = act
            if kind == FWD:
                y = forward(m)
                if not last:
                    sends.append((y.detach(), idx + 1))
            else:
                gx = backward_(m)
                if idx > 0:
                    sends.append((gx, idx - 1))
        recvs = []
        prev, nxt = row.get(idx - 1), row.get(idx + 1)
        if idx > 0 and prev is not None and prev[0] == FWD:
            buf = torch.empty(in_shapes[idx], dtype=dtypes[idx],
                              device=device)
            inbox_x[prev[1]] = buf
            recvs.append((buf, idx - 1))
        if not last and nxt is not None and nxt[0] == BWD:
            buf = torch.empty(in_shapes[idx + 1], dtype=dtypes[idx + 1],
                              device=device)
            inbox_g[nxt[1]] = buf
            recvs.append((buf, idx + 1))
        coll.exchange(sends, recvs, axis)
    if reduce_loss and n_stages > 1:
        coll.all_reduce(loss, axis)
    return PipeResult(loss, [outputs.get(m) for m in range(n_micro)]
                      if last else None, peak, ticks)


def pipeline_apply(stage_fn, x_micro, axis, in_shapes, dtypes=None,
                   remat=False, loss_fn=None, t_micro=None,
                   device=None) -> PipeResult:
    """GPipe over ``axis``: every microbatch's forward, the last stage's
    outputs in ``.outputs``; with ``loss_fn``, then every backward
    through autograd (``remat``: each stage under
    ``torch.utils.checkpoint``)."""
    return run_schedule("gpipe", stage_fn, axis, x_micro, in_shapes, dtypes,
                        loss_fn, t_micro, remat=remat, device=device)


def pipeline_train_1f1b(stage_fn, loss_fn, x_micro, t_micro, axis,
                        in_shapes, dtypes=None, device=None) -> PipeResult:
    """1F1B over ``axis``: forwards and backwards interleaved, at most P
    microbatches in flight on stage 0; the same loss and gradients as
    GPipe."""
    return run_schedule("1f1b", stage_fn, axis, x_micro, in_shapes, dtypes,
                        loss_fn, t_micro, device=device)


def merge_state_over(buffers, data_axis):
    """The replicas' carried state merged after a step (the JAX
    ``_merge_state_over``): float buffers (running statistics) take their
    mean over ``data_axis``, the others their maximum."""
    if data_axis is None or coll.axis_size(data_axis) == 1:
        return
    floats = [b for b in buffers if b.is_floating_point()]
    if floats:
        flat = torch.cat([b.reshape(-1).float() for b in floats])
        coll.all_reduce_mean(flat, data_axis)
        parts = flat.split([b.numel() for b in floats])
        with torch.no_grad():
            for b, p in zip(floats, parts):
                b.copy_(p.view(b.shape))
    for b in buffers:
        if not b.is_floating_point():
            coll.all_reduce(b, data_axis, op=torch.distributed.ReduceOp.MAX)
