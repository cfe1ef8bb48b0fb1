"""Top-1 mixture of experts over a process group (counterpart of
bigdl_tpu/parallel/moe.py: ``expert_capacity`` :29, ``top1_gating`` :37,
``moe_apply`` :54, ``moe_apply_sharded_tokens`` :99).

Routing is GShard/Switch top-1 with a static capacity: a token goes to
the expert of its largest gate, takes the next place in that expert's
queue in token order, and is dropped (its output 0) when the place is at
or past the capacity; a kept token's output is its expert's FFN times
its gate.

The JAX package writes the dispatch and the combine as einsums against a
dense one-hot (T, E, C) tensor, the form XLA's static shapes want.  The
port routes by index instead: each token's (expert, place) is computed,
its row copied into an (E, C + 1, D) buffer at that place (a dropped
token into the extra place, which no expert reads), and the outputs
gathered back from the same places.  The one non-zero term of each
einsum sum is the function, so the two forms agree; the index form
moves T·D values where the einsums touch T·E·C·D (at the MoE classifier's
width, 8,192 tokens, 8 experts and 1,280 places a layer: 8.4e6 values
against 8.6e10 multiply-adds a dispatch).  :func:`top1_gating` still
returns the dense pair, for the tests and for callers of the JAX form.

Global gating.  Where the tokens of one batch lie on several ranks (a
data axis), the JAX step under ``jit`` gates the whole batch: capacity
from the global token count and places counted in global token order.
:func:`top1_route` takes that group and offsets each place by the
expert's tokens on the ranks before this one (an exclusive prefix over
an all-gather of the (E,) counts, :func:`global_offset`), so that a
rank's places are the global ones.

Under a reduced dtype policy (bigdl_tpu/nn/moe.py:58-76) the router's
logits are a product in the compute dtype cast to f32, the tokens are
dispatched in the compute dtype, each expert's two products take compute
operands and add their f32 biases in f32, and the combine multiplies the
expert's output and the gate, both in the compute dtype.
"""
from __future__ import annotations

import collections

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.parallel import collectives as coll
from bigdl_tpu_torch.tensor import policy

Route = collections.namedtuple(
    "Route", ["expert", "place", "local", "keep", "gate"])


def expert_capacity(n_tokens: int, n_experts: int,
                    capacity_factor: float) -> int:
    """Per-expert token capacity: one formula shared by every MoE front
    door, as in the JAX package."""
    return max(int(capacity_factor * n_tokens / n_experts), 1)


def top1_route(logits: torch.Tensor, n_experts: int, capacity: int,
               group=None) -> Route:
    """(T, E) router logits -> each token's expert (its largest gate, the
    first on a tie, as ``jnp.argmax``), its place in that expert's queue,
    its place among this rank's tokens alone (``local``: where it sits in
    this rank's buffer), whether the place is under ``capacity`` and its
    gate (differentiable).  With ``group``
    (the ranks holding the rest of the batch, in token order) a place
    counts the tokens the ranks before this one sent to the expert too
    (:func:`global_offset`)."""
    gates = torch.softmax(logits, dim=-1)
    expert = gates.argmax(dim=-1)
    gate = gates.gather(1, expert[:, None])[:, 0]
    onehot = F.one_hot(expert, n_experts)
    local = (onehot.cumsum(0) * onehot).sum(1) - 1
    place = local
    if group is not None and coll._members(group)[1] > 1:
        place = local + global_offset(onehot.sum(0), group)[expert]
    return Route(expert, place, local, place < capacity, gate)


def global_offset(counts: torch.Tensor, group) -> torch.Tensor:
    """Each expert's tokens on the ranks of ``group`` before this one: an
    all-gather of the (E,) counts and an exclusive prefix over them."""
    idx, n, _ = coll._members(group)
    every = coll.all_gather(counts.contiguous(), group).view(n, -1)
    return every[:idx].sum(0)


def top1_gating(logits: torch.Tensor, n_experts: int, capacity: int):
    """The JAX form: (dispatch (T, E, C) one-hot, combine (T, E, C)
    weights); token t goes to expert e at place c."""
    r = top1_route(logits, n_experts, capacity)
    t = logits.shape[0]
    dispatch = logits.new_zeros(t, n_experts, capacity + 1)
    place = torch.where(r.keep, r.place, capacity)
    dispatch[torch.arange(t, device=logits.device), r.expert, place] = \
        r.keep.to(logits.dtype)
    dispatch = dispatch[..., :capacity]
    return dispatch, dispatch * r.gate[:, None, None]


def dispatch(x: torch.Tensor, route: Route, n_experts: int, capacity: int):
    """x (T, D) into an (E, C, D) buffer at each kept token's local place
    (zeros elsewhere: this rank's buffer holds its own tokens, the global
    place only decides what is dropped), and the flat index of each
    token's place (a dropped token's is the extra place of its
    expert)."""
    place = torch.where(route.keep, route.local, capacity)
    flat = route.expert * (capacity + 1) + place
    buf = x.new_zeros(n_experts * (capacity + 1), x.shape[1])
    buf = buf.index_copy(0, flat, x)
    return buf.view(n_experts, capacity + 1, -1)[:, :capacity], flat


def router_logits(x: torch.Tensor, router_w: torch.Tensor) -> torch.Tensor:
    """(T, E) logits x · router, under a reduced policy a product in the
    compute dtype cast to f32."""
    p = policy()
    if not p.reduced:
        return x @ router_w
    return (p.cast_compute(x) @ p.cast_compute(router_w)).float()


def experts(xe, w1, b1, w2, b2):
    """Each expert's FFN on its (C, D) rows: relu(x W1 + b1) W2 + b2; under
    a reduced policy each product's operands in the compute dtype, its
    result in f32 before the bias."""
    p = policy()
    if not p.reduced:
        h = torch.relu(torch.bmm(xe, w1) + b1[:, None])
        return torch.bmm(h, w2) + b2[:, None]
    cc = p.cast_compute
    h = torch.relu(torch.bmm(cc(xe), cc(w1)).float() + b1[:, None])
    return torch.bmm(cc(h), cc(w2)).float() + b2[:, None]


def combine(ye: torch.Tensor, flat: torch.Tensor, route: Route):
    """Each token's expert output at its place times its gate; 0 for a
    dropped token.  Under a reduced policy both factors in the compute
    dtype, the product in the output dtype."""
    p = policy()
    gate = route.gate * route.keep
    if p.reduced:
        ye, gate = p.cast_compute(ye), p.cast_compute(gate)
    ye = F.pad(ye, (0, 0, 0, 1))            # the extra place, zeros
    y = ye.reshape(-1, ye.shape[-1]).index_select(0, flat) * gate[:, None]
    return y.to(p.output_dtype) if p.reduced else y


def moe_apply(router_w, expert_w1, expert_b1, expert_w2, expert_b2, x,
              group, capacity_factor: float = 1.25):
    """Distributed top-1 MoE FFN with the tokens ``x`` (T, D) the same on
    every rank of ``group`` and the experts split over it: each rank
    holds ``expert_w1`` (E/P, D, H), ``expert_b1`` (E/P, H), ``expert_w2``
    (E/P, H, D), ``expert_b2`` (E/P, D), the experts from rank·E/P on.
    Every rank routes every token, runs its own experts on their tokens,
    and gathers every expert's outputs over the group.  Returns (T, D) on
    every rank.  Differentiable: each rank's gradient of its experts
    counts the loss once (the gather's backward is its own rows), and the
    tokens' gradient sums the experts' parts over the group."""
    idx, n, _ = coll._members(group)
    e_local = expert_w1.shape[0]
    n_expert = e_local * n
    cap = expert_capacity(x.shape[0], n_expert, capacity_factor)
    route = top1_route(router_logits(x, router_w), n_expert, cap)
    xe, flat = dispatch(coll.sum_grad(x, group), route, n_expert, cap)
    own = xe[idx * e_local:(idx + 1) * e_local]
    out = experts(own, expert_w1, expert_b1, expert_w2, expert_b2)
    return combine(coll.all_gather_own_grad(out, group), flat, route)


def moe_apply_sharded_tokens(router_w, expert_w1, expert_b1, expert_w2,
                             expert_b2, x, group,
                             capacity_factor: float = 1.25):
    """MoE with each rank's own tokens ``x`` (T_local, D) and the experts
    split over ``group`` (shards as in :func:`moe_apply`): local routing
    (capacity from T_local), then an ``all_to_all`` carries each rank's
    dispatched tokens to the experts' owners and a second one brings the
    outputs back.  Both all-to-alls are differentiable."""
    _, n, _ = coll._members(group)
    e_local = expert_w1.shape[0]
    n_expert = e_local * n
    cap = expert_capacity(x.shape[0], n_expert, capacity_factor)
    route = top1_route(router_logits(x, router_w), n_expert, cap)
    xe, flat = dispatch(x, route, n_expert, cap)
    d = x.shape[1]
    # (owner, e_local, C, D) -> every owner receives (source, e_local, C, D)
    recv = coll.all_to_all(xe.reshape(n, e_local, cap, d), group, 0, 0,
                           tiled=False)
    rows = recv.transpose(0, 1).reshape(e_local, n * cap, d)
    out = experts(rows, expert_w1, expert_b1, expert_w2, expert_b2)
    back = out.reshape(e_local, n, cap, d).transpose(0, 1).contiguous()
    ye = coll.all_to_all(back, group, 0, 0, tiled=False)
    return combine(ye.reshape(n_expert, cap, d), flat, route)
