"""The attention family: the encoder classifier, the causal Transformer
LM and its paged decode step (counterpart of
bigdl_tpu/models/transformer.py).

Structure per block (pre-LN): x + Attn(LN(x)); x + FFN(LN(x)), the FFN
two Linears or an ``nn.MoE`` (``moe_experts``), with the
residuals spelled ConcatTable(Identity, branch) + CAddTable exactly as in
the JAX package, so the nested parameter trees of the two packages line
up path for path (``load_jax_params`` / ``export_params``, shared by
every port model in nn/module.py and re-exported here).

The decode step (:func:`_lm_forward_window`) reads the KV cache, fp32 or
int8 (``quant/kv.py``), through ``ops.paged_attention``: on the card that
is the hand-written CUDA page walk, always — the port has no
gathered-view attention path on the card.  Under tensor parallelism it
runs on one rank's shard of the weights (its heads, its FFN hidden
rows) and sums each branch's output projection over the ``model`` axis
(``group``).
"""
from __future__ import annotations

import collections

import numpy as np
import torch

import bigdl_tpu_torch.nn as nn
from bigdl_tpu_torch.nn.module import export_params, load_jax_params  # noqa: F401
from bigdl_tpu_torch.nn.normalization import layer_norm
from bigdl_tpu_torch.ops import paged_attention
from bigdl_tpu_torch.parallel.collectives import all_reduce
from bigdl_tpu_torch.quant import kv as kvq
from bigdl_tpu_torch.utils.device import pin_fp32, resolve_device

#: tokens per KV page, for the serving decoder and ``lm_decode`` alike
DEFAULT_PAGE_SIZE = 16


def _residual(branch: nn.Module) -> nn.Module:
    return nn.Sequential(nn.ConcatTable(nn.Identity(), branch),
                         nn.CAddTable())


def _ffn(d_model: int, hidden: int, dropout: float, moe_experts: int,
         **kw) -> nn.Module:
    if moe_experts > 0:
        return nn.Sequential(nn.MoE(d_model, hidden, moe_experts, **kw),
                             nn.Dropout(dropout))
    return nn.Sequential(
        nn.TimeDistributed(nn.Linear(d_model, hidden, **kw)),
        nn.ReLU(),
        nn.Dropout(dropout),
        nn.TimeDistributed(nn.Linear(hidden, d_model, **kw)),
    )


def encoder_block(d_model: int, n_heads: int, hidden: int,
                  dropout: float = 0.1, causal: bool = False,
                  moe_experts: int = 0, device="cuda",
                  generator=None) -> nn.Module:
    """One pre-LN block, its FFN an ``nn.MoE`` of ``moe_experts`` experts
    when that is positive (the JAX ``encoder_block``), on ``device``: the
    card unless the caller asks for the CPU."""
    device = resolve_device(device)
    kw = dict(device=device, generator=generator)
    return nn.Sequential(
        _residual(nn.Sequential(
            nn.LayerNorm(d_model, device=device),
            nn.MultiHeadSelfAttention(d_model, n_heads, causal=causal, **kw),
            nn.Dropout(dropout),
        )),
        _residual(nn.Sequential(
            nn.LayerNorm(d_model, device=device),
            _ffn(d_model, hidden, dropout, moe_experts, **kw),
        )),
    )


def TransformerLM(vocab_size: int, d_model: int = 128, n_heads: int = 4,
                  n_layers: int = 2, hidden: int = 256,
                  dropout: float = 0.1, device="cuda", generator=None):
    """Causal word LM over (B, T, vocab) one-hot input -> per-token
    log-probs.  Weights are drawn on the CPU from ``generator`` and placed
    on ``device``: the card unless the caller asks for the CPU."""
    device = resolve_device(device)
    kw = dict(device=device, generator=generator)
    m = nn.Sequential(
        nn.TimeDistributed(nn.Linear(vocab_size, d_model, **kw)),
        nn.SinusoidalPositionalEncoding(d_model),
    )
    for _ in range(n_layers):
        m.add(encoder_block(d_model, n_heads, hidden, dropout, causal=True,
                            **kw))
    m.add(nn.LayerNorm(d_model, device=device))
    m.add(nn.TimeDistributed(nn.Sequential(
        nn.Linear(d_model, vocab_size, **kw), nn.LogSoftMax())))
    return m


def TransformerClassifier(class_num: int, d_model: int = 128,
                          n_heads: int = 4, n_layers: int = 2,
                          hidden: int = 256, dropout: float = 0.1,
                          causal: bool = False, moe_experts: int = 0,
                          device="cuda", generator=None):
    """(B, T, d_model) embeddings -> class log-probs (the JAX
    ``TransformerClassifier``, bigdl_tpu/models/transformer.py:594-613):
    ``n_layers`` encoder blocks (causal attention with ``causal``, MoE
    FFNs of ``moe_experts`` experts when positive), then LayerNorm, the
    mean over time, Linear and LogSoftMax.  Weights are drawn on the CPU
    from ``generator`` and placed on ``device``: the card unless the
    caller asks for the CPU."""
    device = resolve_device(device)
    kw = dict(device=device, generator=generator)
    m = nn.Sequential()
    for _ in range(n_layers):
        m.add(encoder_block(d_model, n_heads, hidden, dropout,
                            causal=causal, moe_experts=moe_experts, **kw))
    m.add(nn.LayerNorm(d_model, device=device))
    m.add(nn.Mean(1, n_input_dims=2))
    m.add(nn.Linear(d_model, class_num, **kw))
    m.add(nn.LogSoftMax())
    return m


_LMHandles = collections.namedtuple(
    "_LMHandles", ["mods", "n_layers", "emb", "d_model", "blocks",
                   "block_eps", "n_heads", "hd", "ln_f", "eps_f", "head",
                   "vocab"])


def _lm_handles(model) -> _LMHandles:
    """Structural handle extraction: walk each block for its LayerNorm /
    attention / Linear instances (count-checked, so a restructured
    ``encoder_block`` fails loudly).  Every handle is a dict of the
    model's own parameter tensors (detached views, no copies)."""
    def walk(mod):
        yield mod
        for ch in mod.children():
            yield from walk(ch)

    def find(mod, cls):
        return [m for m in walk(mod) if isinstance(m, cls)]

    def own(m):
        return {k: p.detach() for k, p in m.named_parameters(recurse=False)}

    mods = list(model.children())
    n_layers = len(mods) - 4
    if (n_layers < 1
            or not isinstance(mods[1], nn.SinusoidalPositionalEncoding)):
        raise ValueError("expected a TransformerLM-built model (embedding, "
                         "positional encoding, blocks, final LayerNorm, "
                         "head)")
    emb_lin = find(mods[0], nn.Linear)
    if len(emb_lin) != 1:
        raise ValueError("embedding stage must hold exactly one Linear")
    emb = own(emb_lin[0])                    # weight (d, vocab)
    blocks, block_eps, n_heads = [], [], None
    for li in range(n_layers):
        blk = mods[2 + li]
        attn = find(blk, nn.MultiHeadSelfAttention)
        lns = find(blk, nn.LayerNorm)
        lins = find(blk, nn.Linear)
        if len(attn) != 1 or len(lns) != 2 or len(lins) != 2:
            raise ValueError(
                f"block {li} must hold exactly one attention, two "
                f"LayerNorms and two FFN Linears; found {len(attn)}/"
                f"{len(lns)}/{len(lins)}")
        n_heads = attn[0].n_heads
        blocks.append((own(lns[0]), own(attn[0]), own(lns[1]),
                       own(lins[0]), own(lins[1])))
        block_eps.append((lns[0].eps, lns[1].eps))
    d_model = int(emb["weight"].shape[0])
    head_lin = find(mods[3 + n_layers], nn.Linear)
    if len(head_lin) != 1:
        raise ValueError("head stage must hold exactly one Linear")
    head = own(head_lin[0])                  # weight (vocab, d)
    return _LMHandles(mods, n_layers, emb, d_model, blocks, block_eps,
                      n_heads, d_model // n_heads, own(mods[2 + n_layers]),
                      mods[2 + n_layers].eps, head,
                      int(head["weight"].shape[0]))


def _handles_to(h: _LMHandles, device) -> _LMHandles:
    """The handles with every tensor on ``device`` (no copy where it
    already lives there)."""
    def mv(d):
        return {k: v.to(device) for k, v in d.items()}
    return h._replace(emb=mv(h.emb), ln_f=mv(h.ln_f), head=mv(h.head),
                      blocks=[tuple(mv(d) for d in b) for b in h.blocks])


def new_pools(handles: _LMHandles, n_pages: int, page_size: int,
              device, kv_quant: str = "off") -> tuple:
    """Zeroed K and V pools (layers, n_pages + 1, page_size, H, hd): fp32,
    or under ``kv_quant="int8"`` four arrays, int8 pools and their f32
    scales (layers, n_pages + 1, page_size, H) (``quant/kv.py``).  Page
    ``n_pages`` is the scratch page that gated writes land on; no page
    table ever points at it.  H is ``handles.n_heads``: a tensor-parallel
    rank's handles hold its own heads, so its pools are its own
    contiguous arrays of them."""
    shape = (handles.n_layers, n_pages + 1, page_size, handles.n_heads,
             handles.hd)
    if kv_quant == "int8":
        sshape = kvq.scale_shape(shape)
        return (torch.zeros(shape, dtype=kvq.storage_dtype, device=device),
                torch.zeros(shape, dtype=kvq.storage_dtype, device=device),
                torch.zeros(sshape, dtype=kvq.scale_dtype, device=device),
                torch.zeros(sshape, dtype=kvq.scale_dtype, device=device))
    return (torch.zeros(shape, device=device),
            torch.zeros(shape, device=device))


def _lm_forward_window(tok, i, caches, handles, pe, pages, valid=None,
                       group=None):
    """Paged multi-position forward: token ids (B, S) at per-row
    positions ``i`` (B, S) against block-paged KV pools.

    ``pages`` is ``(page_table, page_size)``; ``caches`` the ``(kpool,
    vpool)`` pair of :func:`new_pools`, (layers, n_pages + 1, page_size,
    H, hd), updated IN PLACE (the pools are the decoder's largest tensors;
    a functional copy per layer would double their traffic) and returned.
    Four arrays ``(kpool, vpool, kscale, vscale)`` select int8 KV storage
    (``quant/kv.py``): each written K and V head-row is quantized with
    its own scale (amax/127), values and scales written at the same
    ``phys``/``off`` (so a gated write sends both to the scratch page),
    and the attention dequantizes in its page walk.
    The window's K/V writes land before the attention reads, so window
    position j attends to positions j' <= j and the committed past through
    one causal mask ``t <= i[b, j]``.

    ``valid`` (B, S) gates the writes: an invalid position (a frozen row,
    or a window position past the row's pages) writes to the scratch page
    instead of its own, and attends to nothing (its output is the
    caller's to discard; the kernel reads no page for it).  The JAX package routes such writes out of bounds,
    where XLA drops them; PyTorch would raise or fault there, so the port
    keeps one page no table references.  The gate is a correctness
    contract: a stale write from a finished row must never reach a page
    another request owns.

    ``group`` (a ``model`` axis, or None) makes the call one rank's part
    of a tensor-parallel step: ``handles`` hold the rank's heads and FFN
    hidden rows (``serve.decode._tp_local``), and each branch's output
    projection is summed over the group by one in-place all-reduce
    before its bias, ``x + allreduce(o @ wo) + bo`` and ``x +
    allreduce(hid @ lin2ᵀ) + lin2.bias``: two all-reduces a block, the
    JAX ``psum`` merges in their order.  Every rank of the group gets the
    same sums, so the same log-probs."""
    h_ = handles
    quantized = len(caches) == 4
    kpool, vpool = caches[:2]
    kscale, vscale = caches[2:] if quantized else (None, None)
    ptab, ps = pages
    bsz, S = tok.shape
    scratch = kpool.shape[1] - 1
    if valid is None:
        valid = torch.ones(tok.shape, dtype=torch.bool, device=tok.device)
    rows = torch.arange(bsz, device=tok.device)[:, None]
    phys = torch.where(valid, ptab[rows, i // ps], scratch).long()
    off = (i % ps).long()
    pos = torch.where(valid, i, -1).to(torch.int32)

    x = h_.emb["weight"].t()[tok] + h_.emb["bias"] + pe[i]   # (B, S, d)
    for li, (ln1, m, ln2, lin1, lin2) in enumerate(h_.blocks):
        a = layer_norm(x, ln1["weight"], ln1["bias"], h_.block_eps[li][0])
        q = (a @ m["wq"] + m["bq"]).reshape(bsz, S, h_.n_heads, h_.hd)
        k = (a @ m["wk"] + m["bk"]).reshape(bsz, S, h_.n_heads, h_.hd)
        v = (a @ m["wv"] + m["bv"]).reshape(bsz, S, h_.n_heads, h_.hd)
        if quantized:
            qk, sk = kvq.quantize_rows(k)
            qv, sv = kvq.quantize_rows(v)
            kpool[li, phys, off] = qk
            vpool[li, phys, off] = qv
            kscale[li, phys, off] = sk
            vscale[li, phys, off] = sv
            o = paged_attention(q, kpool[li], vpool[li], ptab, pos,
                                kscale[li], vscale[li])
        else:
            kpool[li, phys, off] = k
            vpool[li, phys, off] = v
            o = paged_attention(q, kpool[li], vpool[li], ptab, pos)
        proj = o.reshape(bsz, S, h_.n_heads * h_.hd) @ m["wo"]
        if group is not None:
            all_reduce(proj, group)
        x = x + proj + m["bo"]
        a2 = layer_norm(x, ln2["weight"], ln2["bias"], h_.block_eps[li][1])
        hid = torch.relu(a2 @ lin1["weight"].t() + lin1["bias"])
        proj = hid @ lin2["weight"].t()
        if group is not None:
            all_reduce(proj, group)
        x = x + proj + lin2["bias"]
    xf = layer_norm(x, h_.ln_f["weight"], h_.ln_f["bias"], h_.eps_f)
    logp = torch.log_softmax(xf @ h_.head["weight"].t() + h_.head["bias"],
                             dim=-1)
    return logp, tuple(caches)


def _lm_forward_one(tok, i, caches, handles, pe, pages, valid=None,
                    group=None):
    """One decode position for all rows: token ids (B,) at per-row
    positions ``i`` (B,) -> (log-probs (B, vocab), caches).  The paged
    branch of the JAX ``_lm_forward_one``: the window at S = 1."""
    v = None if valid is None else valid[:, None]
    logp, caches = _lm_forward_window(tok[:, None], i[:, None], caches,
                                      handles, pe, pages, valid=v,
                                      group=group)
    return logp[:, 0], caches


def _copy_pages(caches, src, dst):
    """Every pool array's pages ``src`` copied onto pages ``dst`` (both
    int64 index tensors), all layers at once."""
    for c in caches:
        c[:, dst] = c[:, src]


@torch.no_grad()
def lm_decode(model, seed_ids, n_words, greedy: bool = True, key=None,
              temperature: float = 1.0, top_k: int = 0, top_p: float = 0.0,
              device="cuda"):
    """KV-cached decoding for a ``TransformerLM`` model.

    ``seed_ids`` is a flat id list (returns the extended list) or a
    rectangular batch of seed rows (returns the extended rows).  The
    cache is the paged pool of the serving decoder: ``DEFAULT_PAGE_SIZE``
    pages, ``ceil((n_seed + n_words - 1) / DEFAULT_PAGE_SIZE)`` of them
    per row, so every step runs the paged attention at the decoder's
    shapes.

    ``greedy=True`` takes the argmax; otherwise every token is drawn
    through ``serve.sampling.sample_tokens`` (the served decoder's
    sampler) from the log-probs scaled by ``temperature`` and truncated
    by ``top_k`` / ``top_p``.  ``key`` is an int seed where the JAX
    package takes a PRNG key: row ``b`` draws the stream a served request
    with ``SamplingParams(seed=key + b)`` and the same filters draws (the
    generated index and ``TAG_MAIN`` folded into its key), so one key
    gives one row, and the offline and served paths agree."""
    # the serve package imports this module: a top-level import would
    # be circular
    from bigdl_tpu_torch.serve import sampling as smp

    if not greedy and key is None:
        raise ValueError("sampling (greedy=False) needs a key (an int seed)")
    if temperature <= 0:
        raise ValueError("temperature must be > 0")
    if not 0.0 <= top_p <= 1.0:
        raise ValueError("top_p must be in [0, 1] (0 or 1 = off)")
    dev = resolve_device(device)
    pin_fp32(dev)
    seed_np = np.atleast_2d(np.asarray(seed_ids, np.int64))
    if seed_np.ndim != 2 or seed_np.size == 0:
        raise ValueError("seed_ids must be a flat id list or a "
                         "rectangular batch of non-empty seed rows")
    flat = np.asarray(seed_ids).ndim == 1
    handles = _handles_to(_lm_handles(model), dev)
    bsz, n_seed = seed_np.shape
    n_pos = n_seed + int(n_words) - 1
    pe = handles.mods[1].table(n_pos).to(dev)
    seed = torch.from_numpy(seed_np).to(dev)
    ps = DEFAULT_PAGE_SIZE
    per_row = -(-n_pos // ps)
    caches = new_pools(handles, bsz * per_row, ps, dev)
    pages = (torch.arange(bsz * per_row, dtype=torch.int32,
                          device=dev).reshape(bsz, per_row), ps)
    if not greedy:
        keys = torch.tensor([smp.key_words(int(key) + b) for b in
                             range(bsz)], dtype=torch.int64, device=dev)
    preds, nxt = [], None
    for t in range(n_pos):
        tok = seed[:, t] if t < n_seed else nxt
        logp, caches = _lm_forward_one(
            tok, torch.full((bsz,), t, dtype=torch.int64, device=dev),
            caches, handles, pe, pages)
        if greedy or t < n_seed - 1:
            nxt = logp.argmax(dim=-1)
        else:
            sub = smp.fold_in_rows(
                keys, smp.DRAW_TAGS * (t - (n_seed - 1)) + smp.TAG_MAIN)
            nxt = smp.sample_tokens(logp, sub, temperature, top_k, top_p)
        preds.append(nxt)
    gen = torch.stack(preds[n_seed - 1:], dim=1).cpu().numpy()
    rows = [[int(t) for t in seed_np[b]] + [int(t) for t in gen[b]]
            for b in range(bsz)]
    return rows[0] if flat else rows


@torch.no_grad()
def lm_beam_search(model, seed_ids, n_words, beam_size: int = 4,
                   return_all: bool = False, device="cuda"):
    """Beam-search decoding over ``lm_decode``'s paged KV cache.

    The seed is consumed at batch 1 (beams share the prefix), then its
    pages are copied to every beam's pages; each step scores the
    ``beam_size * vocab`` continuations, keeps the joint top ``beam_size``
    and reorders the cache by parent (a page copy of every layer's pools,
    the pages up to the step's position).  Beams have equal length, so
    the winner is the highest total log-probability; ``return_all=True``
    also returns every beam's row and score, best first."""
    if beam_size < 1:
        raise ValueError("beam_size must be >= 1")
    seed_np = np.asarray(seed_ids, np.int64)
    if seed_np.ndim != 1 or seed_np.size == 0:
        raise ValueError("lm_beam_search takes one flat non-empty seed "
                         "id list")
    dev = resolve_device(device)
    pin_fp32(dev)
    handles = _handles_to(_lm_handles(model), dev)
    K, V = int(beam_size), handles.vocab
    n_seed = int(seed_np.size)
    n_pos = n_seed + int(n_words) - 1
    pe = handles.mods[1].table(n_pos).to(dev)
    seed = torch.from_numpy(seed_np).to(dev)
    ps = DEFAULT_PAGE_SIZE
    per_row = -(-n_pos // ps)
    caches = new_pools(handles, K * per_row, ps, dev)
    ptab = torch.arange(K * per_row, dtype=torch.int32,
                        device=dev).reshape(K, per_row)

    def at(i, n):
        return torch.full((n,), i, dtype=torch.int64, device=dev)

    # the seed at batch 1, in beam 0's pages; then those pages tiled
    for i in range(n_seed - 1):
        _, caches = _lm_forward_one(seed[i:i + 1], at(i, 1), caches,
                                    handles, pe, (ptab[:1], ps))
    written = -(-(n_seed - 1) // ps)
    if written and K > 1:
        _copy_pages(caches, ptab[0, :written].long().repeat(K - 1),
                    ptab[1:, :written].reshape(-1).long())

    # only beam 0 is live at the first expansion, else the top-k would
    # pick the same token K times from identical beams
    scores = torch.full((K,), float("-inf"), device=dev)
    scores[0] = 0.0
    gen = torch.zeros((K, int(n_words)), dtype=torch.int64, device=dev)
    tok = seed[-1].repeat(K)
    for i in range(n_seed - 1, n_pos):
        logp, caches = _lm_forward_one(tok, at(i, K), caches, handles, pe,
                                       (ptab, ps))
        scores, flat = torch.topk((scores[:, None] + logp).reshape(-1), K)
        beam_idx, tok = flat // V, flat % V
        n = i // ps + 1                   # the pages written so far
        _copy_pages(caches, ptab[beam_idx, :n].reshape(-1).long(),
                    ptab[:, :n].reshape(-1).long())
        gen = gen[beam_idx]
        gen[:, i - (n_seed - 1)] = tok
    scores, gen = scores.cpu().numpy(), gen.cpu().numpy()
    order = np.argsort(-scores, kind="stable")
    rows = [[int(t) for t in seed_np] + [int(t) for t in gen[b]]
            for b in order]
    if return_all:
        return rows, [float(scores[b]) for b in order]
    return rows[0]
