"""Full softmax attention and the exact blockwise ring (counterpart of
bigdl_tpu/parallel/ring_attention.py: ``full_attention`` :120,
``_block_attn`` :36, ``ring_attention`` :62).  Plain tensor code and
``torch.matmul``, (B, T, H, hd) layout at the entry points.

Sequence parallelism splits the time dimension over the ranks of a
``seq`` axis: rank i holds the (B, T/s, H, hd) block i of q, k and v.
:func:`ring_attention` computes the attention of its queries over the
whole sequence while K and V travel around the ring, one hop a block
(``batch_isend_irecv`` to the next rank, the next block's transfer in
flight while the held one is computed), merged with an online softmax
(running max m, normaliser l, unnormalised output o).  The causal mask
takes global positions: the queries start at ``i·t``, and the block held
at hop h came from rank (i − h) mod s; a block wholly above the diagonal
adds nothing and is skipped.

The gradient is an autograd function with a ring of its own, never
autograd through the sends (they have none): each hop recomputes the
block's probabilities from the saved per-row log-sum-exp, and the
gradients of K and V travel with their block, one hop more than the
forward's s − 1, which brings them home to the block's owner.  No rank
ever holds more than two blocks of K and V.

:func:`block_forward` and :func:`block_backward` are the per-hop step
that the ranks call; :func:`ring_attention_blocks` runs the same steps in
one process over P blocks, the rotation done by indexing, which is how
the card checks the step without a second card.
"""
from __future__ import annotations

import math

import torch

from bigdl_tpu_torch.parallel.collectives import RingSend, _members


def _up(t: torch.Tensor) -> torch.Tensor:
    """``t`` in f32 at least: bf16 scores, probabilities' products and
    softmax statistics are taken in f32 (a product of two bf16 values is
    exact in f32, so this is a bf16 product accumulated in f32, the JAX
    ``preferred_element_type=float32``)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = False) -> torch.Tensor:
    """Softmax attention over (B, T, H, hd) q, k, v: the scores and the
    softmax in f32 at least, the probabilities cast to v's dtype for the
    product with v (bigdl_tpu/parallel/ring_attention.py:120-130)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", _up(q), _up(k)) * scale
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        mask = (torch.arange(tq, device=q.device)[:, None]
                >= torch.arange(tk, device=q.device)[None, :])
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


def _visible(q_off, tq, k_off, tk, causal):
    """"all", "none" or "some": how much of a (q-block, k-block) pair the
    causal mask lets through."""
    if not causal or k_off + tk - 1 <= q_off:
        return "all"
    if k_off > q_off + tq - 1:
        return "none"
    return "some"


def _scores(q, k, q_off, k_off, causal, scale):
    """(B, H, Tq, Tk) scores of a block pair, -inf where the causal mask
    hides a key; q and k in (B, H, T, hd)."""
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if _visible(q_off, q.shape[2], k_off, k.shape[2], causal) == "some":
        qi = q_off + torch.arange(q.shape[2], device=q.device)[:, None]
        ki = k_off + torch.arange(k.shape[2], device=q.device)[None, :]
        s = s.masked_fill(qi < ki, float("-inf"))
    return s


def block_forward(q, k, v, q_off, k_off, causal, scale, state=None):
    """One hop: the held block's scores, merged into the running
    ``state`` = (m, l, o) (None before the first block) as the JAX
    ``ring_attention`` step merges them (``_block_attn`` and its
    rescales).  q, k, v in (B, H, T, hd); m, l (B, H, Tq) and o (B, H,
    Tq, hd) in fp32 at least.  Returns the new state."""
    s = _scores(_up(q), _up(k), q_off, k_off, causal, scale)
    bm = s.amax(dim=-1)
    # a row the mask hides wholly keeps a finite shift: its p is 0
    bm = torch.where(torch.isinf(bm), torch.zeros_like(bm), bm)
    p = torch.exp(s - bm[..., None])
    bl = p.sum(dim=-1)
    bpv = torch.matmul(_up(p.to(v.dtype)), _up(v))
    if state is None:
        return bm, bl, bpv
    m, l, o = state
    m_new = torch.maximum(m, bm)
    alpha = torch.exp(m - m_new)
    beta = torch.exp(bm - m_new)
    return (m_new, l * alpha + bl * beta,
            o * alpha[..., None] + bpv * beta[..., None])


def finish(state):
    """(output o / l, per-row log-sum-exp m + log l) of a merged state."""
    m, l, o = state
    l = torch.clamp_min(l, 1e-20)
    return o / l[..., None], m + torch.log(l)


def block_backward(q, k, v, do, lse, delta, q_off, k_off, causal, scale):
    """One hop of the backward: the held block's probabilities recomputed
    from the saved log-sum-exp, then its parts of dq, dk and dv.  ``do``
    is the output's gradient and ``delta`` the row sums of ``do · out``,
    all in (B, H, T, ·); q, k and v are taken in f32 at least."""
    q, k, v = _up(q), _up(k), _up(v)
    s = _scores(q, k, q_off, k_off, causal, scale)
    p = torch.exp(s - lse[..., None])
    dv = torch.matmul(p.transpose(-1, -2), do)
    dp = torch.matmul(do, v.transpose(-1, -2))
    ds = p * (dp - delta[..., None])
    dq = torch.matmul(ds, k) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q) * scale
    return dq, dk, dv


def _heads_first(t):
    return t.transpose(1, 2).contiguous()


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, causal):
        idx, n, _ = _members(group)
        t = q.shape[2]
        scale = 1.0 / math.sqrt(q.shape[-1])
        kv = torch.stack([k, v])
        state = None
        for hop in range(n):
            send = RingSend(kv, group) if hop < n - 1 else None
            src = (idx - hop) % n
            if _visible(idx * t, t, src * t, t, causal) != "none":
                state = block_forward(q, kv[0], kv[1], idx * t, src * t,
                                      causal, scale, state)
            if send is not None:
                kv = send.wait()
        out, lse = finish(state)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (group, causal, idx, n, scale)
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        group, causal, idx, n, scale = ctx.args
        t = q.shape[2]
        do = dout.to(out.dtype).contiguous()
        delta = (do * out).sum(dim=-1)
        dq = torch.zeros_like(q)
        kv, dkv = torch.stack([k, v]), torch.zeros((2,) + k.shape,
                                                   dtype=k.dtype,
                                                   device=k.device)
        for hop in range(n):
            # K and V leave as soon as the hop starts; their gradients
            # after the hop's part is added
            send = RingSend(kv, group) if hop < n - 1 else None
            src = (idx - hop) % n
            if _visible(idx * t, t, src * t, t, causal) != "none":
                dq_p, dk_p, dv_p = block_backward(
                    q, kv[0], kv[1], do, lse, delta, idx * t, src * t,
                    causal, scale)
                dq += dq_p
                dkv[0] += dk_p
                dkv[1] += dv_p
            if n > 1:
                # the last hop's accumulators go to the block's owner
                dkv = RingSend(dkv, group, tag=1).wait()
            if send is not None:
                kv = send.wait()
        return dq, dkv[0], dkv[1], None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group, causal: bool = False) -> torch.Tensor:
    """Exact attention of this rank's (B, T/s, H, hd) block of queries
    over the whole sequence, held in (B, T/s, H, hd) blocks by the ranks
    of ``group`` (a mesh ``Axis``, or a process group) in rank order.
    Differentiable, with its own backward ring."""
    out = _Ring.apply(_heads_first(q), _heads_first(k), _heads_first(v),
                      group, causal)
    return out.transpose(1, 2)


class _Blocks(torch.autograd.Function):
    """The ring's steps for P ranks in one process: rank i's held block at
    hop h is block (i − h) mod P, and each block's gradients are summed
    where its owner would receive them."""

    @staticmethod
    def forward(ctx, q, k, v, n, causal):
        t = q.shape[2] // n
        scale = 1.0 / math.sqrt(q.shape[-1])
        qs, ks, vs = (x.split(t, dim=2) for x in (q, k, v))
        outs, lses = [], []
        for i in range(n):
            state = None
            for hop in range(n):
                j = (i - hop) % n
                if _visible(i * t, t, j * t, t, causal) != "none":
                    state = block_forward(qs[i], ks[j], vs[j], i * t, j * t,
                                          causal, scale, state)
            out, lse = finish(state)
            outs.append(out)
            lses.append(lse)
        out, lse = torch.cat(outs, dim=2), torch.cat(lses, dim=2)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (n, causal, scale)
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        n, causal, scale = ctx.args
        t = q.shape[2] // n
        do = dout.to(out.dtype).contiguous()
        delta = (do * out).sum(dim=-1)
        qs, ks, vs, dos, lses, deltas = (
            x.split(t, dim=2) for x in (q, k, v, do, lse, delta))
        dq = [torch.zeros_like(x) for x in qs]
        dk = [torch.zeros_like(x) for x in ks]
        dv = [torch.zeros_like(x) for x in vs]
        for i in range(n):
            for hop in range(n):
                j = (i - hop) % n
                if _visible(i * t, t, j * t, t, causal) == "none":
                    continue
                dq_p, dk_p, dv_p = block_backward(
                    qs[i], ks[j], vs[j], dos[i], lses[i], deltas[i], i * t,
                    j * t, causal, scale)
                dq[i] += dq_p
                dk[j] += dk_p
                dv[j] += dv_p
        return (torch.cat(dq, dim=2), torch.cat(dk, dim=2),
                torch.cat(dv, dim=2), None, None)


def ring_attention_blocks(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          n_blocks: int, causal: bool = False) -> torch.Tensor:
    """:func:`ring_attention` of ``n_blocks`` ranks computed in one
    process on the whole (B, T, H, hd) q, k and v (T divisible by
    ``n_blocks``): the same per-hop steps, the rotation done by
    indexing.  Differentiable."""
    if q.shape[1] % n_blocks:
        raise ValueError(f"ring_attention_blocks: T {q.shape[1]} does not "
                         f"divide into {n_blocks} blocks")
    out = _Blocks.apply(_heads_first(q), _heads_first(k), _heads_first(v),
                        n_blocks, causal)
    return out.transpose(1, 2)
