"""Stage partition of a ``Sequential`` model for pipeline training through
the Optimizer API (counterpart of bigdl_tpu/parallel/pipeline_model.py).

``DistriOptimizer(pipeline_stages=P)`` gives pipeline parallelism the
front door of every other mode (ref optim/Optimizer.scala:151-186).
:func:`partition_sequential` splits the top-level modules into P
contiguous stages balanced by the JAX package's analytic cost
(``_module_cost``: a matrix or convolution layer ~2·|W|·spatial_out·mb,
every module its output's elements besides) through the same linear
partition (``_linear_partition``), so that the port's stage ranges are
the JAX package's for every model.

The JAX package stacks every stage's parameters into one ``(P, max_p)``
array and selects a stage with ``lax.switch``.  Here each rank holds its
own stage's modules, on its own card, and runs them as they are; the
plan keeps what every rank must agree on: the ranges, the boundary
shapes and dtypes (every receive is posted with its shape), each stage's
parameter count, and the JAX ravel order of a stage's leaves
(``jax_leaves``), the layout of the stage-stacked optimizer state a
checkpoint carries.

Boundary shapes come from one forward of a microbatch of zeros on the
CPU in evaluation mode without gradients (the ``eval_shape`` sweep of
the JAX package): no kernel launches, no random draw, no running
statistic moves.
"""
from __future__ import annotations

import numpy as np
import torch


def _module_cost(module, mb, out_shape):
    """Analytic per-module cost for stage balancing: matmul/conv-style
    modules cost ~2·|W|·spatial_out·mb FLOPs, everything else is
    bandwidth, counted as output elements; only relative magnitudes
    matter (the JAX ``_module_cost``)."""
    psize = int(sum(p.numel() for p in module.parameters()))
    spatial = int(np.prod(out_shape[2:])) if len(out_shape) > 2 else 1
    out_elems = int(np.prod(out_shape))
    return 2.0 * psize * spatial * mb + out_elems


def _linear_partition(costs, n_stages):
    """Split ``costs`` into ``n_stages`` contiguous non-empty groups
    minimizing the max group sum (O(n² P) DP; n is the module count)."""
    n = len(costs)
    prefix = np.concatenate([[0.0], np.cumsum(costs)])
    INF = float("inf")
    dp = np.full((n + 1, n_stages + 1), INF)
    par = np.zeros((n + 1, n_stages + 1), np.int64)
    dp[0, 0] = 0.0
    for p in range(1, n_stages + 1):
        for i in range(p, n + 1):
            for j in range(p - 1, i):
                c = max(dp[j, p - 1], prefix[i] - prefix[j])
                if c < dp[i, p]:
                    dp[i, p] = c
                    par[i, p] = j
    ranges = []
    i = n
    for p in range(n_stages, 0, -1):
        j = int(par[i, p])
        ranges.append((j, i))
        i = j
    return ranges[::-1]


def jax_leaves(module) -> list:
    """``module``'s parameters in the order the JAX package ravels its
    ``params()`` tree: a dict's keys sorted, so the children ``'0'``,
    ``'1'``, ``'10'``, ... before the module's own ``'~'`` leaves, those
    by name."""
    out = []
    for key in sorted(["~"] + list(module._modules)):
        if key == "~":
            out += [module._parameters[k] for k in sorted(module._parameters)
                    if module._parameters[k] is not None]
        else:
            out += jax_leaves(module._modules[key])
    return out


class StagePlan:
    """What every rank of a pipeline agrees on: the stage ranges over the
    top-level modules, each stage's input shape at the microbatch
    (``in_shapes``, batch first) and dtype, the model's output shape,
    and each stage's parameter count (``p_sizes``; ``max_p`` the
    largest, the width of the stage-stacked optimizer state)."""

    def __init__(self, model, n_stages, ranges, in_shapes, out_shape,
                 dtypes=None):
        self.modules = list(model._modules.values())
        self.n_stages = n_stages
        self.ranges = ranges
        self.in_shapes = in_shapes
        self.out_shape = out_shape
        self.dtypes = dtypes or [torch.float32] * n_stages
        self.mb = in_shapes[0][0]
        self.p_sizes = [sum(p.numel() for p in self.leaves(i))
                        for i in range(n_stages)]
        self.max_p = max(self.p_sizes)

    def stage_modules(self, i) -> list:
        a, b = self.ranges[i]
        return self.modules[a:b]

    def leaves(self, i) -> list:
        """Stage ``i``'s parameters in ``parameters()`` order."""
        return [p for m in self.stage_modules(i) for p in m.parameters()]

    def jax_leaves(self, i) -> list:
        """Stage ``i``'s parameters in the JAX ravel order of its stage
        row (the list of its modules' trees, each raveled as
        :func:`jax_leaves` says)."""
        return [p for m in self.stage_modules(i) for p in jax_leaves(m)]

    def boundary(self, i, rows) -> tuple:
        """Stage ``i``'s input shape for ``rows`` samples."""
        return (int(rows),) + tuple(self.in_shapes[i][1:])

    def describe(self):
        lines = []
        for i, (a, b) in enumerate(self.ranges):
            names = [type(self.modules[j]).__name__ for j in range(a, b)]
            lines.append(f"stage {i}: modules [{a}:{b}) "
                         f"({self.p_sizes[i]:,} params) {names}")
        return "\n".join(lines)


def _probe(module, x):
    """``module(x)`` on the CPU with CPU copies of its parameters and
    buffers, in evaluation mode, without gradients."""
    values = {k: v.detach().cpu() for k, v in
              list(module.named_parameters()) + list(module.named_buffers())}
    was = module.training
    module.eval()
    try:
        with torch.no_grad():
            return torch.func.functional_call(module, values, (x,))
    finally:
        module.train(was)


def partition_sequential(model, n_stages, micro_shape, dtype=torch.float32):
    """Partition a ``Sequential`` model into ``n_stages`` pipeline stages.

    ``micro_shape`` is the shape of ONE microbatch including its batch dim
    ``(mb, ...)``.  Boundary shapes come from one forward of zeros on the
    CPU; stages are balanced by the analytic cost model.  Every stage
    boundary must be a single tensor (true of the Sequential model zoo;
    Table-valued boundaries would need a table-flattening hop)."""
    from bigdl_tpu_torch.nn.containers import Sequential

    if not isinstance(model, Sequential):
        raise ValueError(
            f"pipeline_stages requires a Sequential model, got "
            f"{type(model).__name__}")
    modules = list(model._modules.values())
    if len(modules) < n_stages:
        raise ValueError(f"model has {len(modules)} top-level modules, "
                         f"cannot make {n_stages} stages")
    cur = torch.zeros(tuple(micro_shape), dtype=dtype)
    shapes, dtypes, costs = [tuple(cur.shape)], [cur.dtype], []
    for m in modules:
        cur = _probe(m, cur)
        if not isinstance(cur, torch.Tensor):
            raise ValueError(
                f"stage boundary after {type(m).__name__} is not a single "
                "array; pipeline partitioning needs tensor boundaries")
        shapes.append(tuple(cur.shape))
        dtypes.append(cur.dtype)
        costs.append(_module_cost(m, micro_shape[0], cur.shape))
    ranges = _linear_partition(costs, n_stages)
    return StagePlan(model, n_stages, ranges, [shapes[a] for a, _ in ranges],
                     shapes[-1], [dtypes[a] for a, _ in ranges])
