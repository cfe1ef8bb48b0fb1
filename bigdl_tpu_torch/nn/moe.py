"""Mixture-of-experts FFN as a model-zoo module (counterpart of
bigdl_tpu/nn/moe.py :30-80).

Top-1 switch routing with a static capacity (``parallel/moe.py``, index
form): tokens over an expert's capacity are dropped to a zero output
(pair it with a residual connection).  A data-parallel optimizer tells
the module where the rest of its batch and its experts are:

- ``gate_axis``: the ``data`` axis.  The JAX step under ``jit`` gates
  the global batch, so each rank takes the capacity from the global
  token count and offsets its places by the tokens the ranks before it
  sent to each expert (``DistriOptimizer`` sets it on its plain path and
  under ``expert_parallel``; the bf16-wire and straggler paths gate each
  rank's tokens alone, as the JAX ``shard_map`` builder does).
- ``expert_axis``: the ``expert`` axis (``expert_parallel``).  The ranks
  of one data slice hold the same tokens; each runs its own E/e experts
  (``moe_apply``'s form) from its rows of the expert-stacked parameters,
  and the outputs are gathered over the axis.

Both are None outside a data-parallel run.
"""
from __future__ import annotations

import torch

from bigdl_tpu_torch.nn import init as init_
from bigdl_tpu_torch.nn.module import TensorModule
from bigdl_tpu_torch.parallel import collectives as coll
from bigdl_tpu_torch.parallel import moe as pmoe
from bigdl_tpu_torch.utils.device import resolve_device

#: the parameters whose leading dimension is the expert
EXPERT_STACKED = ("w1", "b1", "w2", "b2")


class MoE(TensorModule):
    """Top-1 switch-routed expert FFN: (..., D) -> (..., D).

    Params: ``router`` (D, E); expert-stacked ``w1`` (E, D, H), ``b1``
    (E, H), ``w2`` (E, H, D), ``b2`` (E, D): the leading expert dimension
    is what ``expert_parallel`` splits."""

    def __init__(self, d_model: int, hidden: int, n_experts: int,
                 capacity_factor: float = 1.25, device="cuda",
                 generator=None):
        super().__init__()
        self.d_model = d_model
        self.hidden = hidden
        self.n_experts = n_experts
        self.capacity_factor = capacity_factor
        device = resolve_device(device)
        for k, v in self._draw(generator).items():
            self._add_param(k, v, device)
        self.gate_axis = None
        self.expert_axis = None
        #: tokens dropped by the last forward (a device scalar), and its
        #: token count
        self.dropped = None
        self.tokens = 0

    def _draw(self, generator=None) -> dict:
        """The initial values (``Module.reset`` draws them again)."""
        d, h, e = self.d_model, self.hidden, self.n_experts
        router = init_.default_linear((d, e), d, generator)
        w1 = init_.default_linear((e, d, h), d, generator)
        b1 = torch.zeros(e, h)
        w2 = init_.default_linear((e, h, d), h, generator)
        return {"router": router, "w1": w1, "b1": b1, "w2": w2,
                "b2": torch.zeros(e, d)}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d, e = x.shape[-1], self.n_experts
        xt = x.reshape(-1, d)
        n_tok = xt.shape[0]
        gate = self.gate_axis
        ranks = 1 if gate is None else gate.size
        cap = pmoe.expert_capacity(n_tok * ranks, e, self.capacity_factor)
        route = pmoe.top1_route(pmoe.router_logits(xt, self.router), e, cap,
                                gate)
        ep = self.expert_axis
        if ep is None or ep.size == 1:
            xe, flat = pmoe.dispatch(xt, route, e, cap)
            ye = pmoe.experts(xe, self.w1, self.b1, self.w2, self.b2)
        else:
            # this rank's experts on the tokens every rank of the axis
            # holds; the tokens' gradient sums the experts' parts
            xe, flat = pmoe.dispatch(coll.sum_grad(xt, ep), route, e, cap)
            own = self.owned(ep)
            out = pmoe.experts(xe[own], self.w1[own], self.b1[own],
                               self.w2[own], self.b2[own])
            ye = coll.all_gather_own_grad(out, ep)
        self.dropped, self.tokens = n_tok - route.keep.sum(), n_tok
        return pmoe.combine(ye, flat, route).reshape(x.shape)

    def owned(self, axis) -> slice:
        """The experts a rank of ``axis`` owns: rows index·E/e on."""
        if self.n_experts % axis.size:
            raise ValueError(f"MoE: {self.n_experts} experts do not divide "
                             f"over an expert axis of {axis.size}")
        k = self.n_experts // axis.size
        return slice(axis.index * k, (axis.index + 1) * k)

    def extra_repr(self) -> str:
        return (f"{self.d_model}, hidden={self.hidden}, "
                f"experts={self.n_experts}")
