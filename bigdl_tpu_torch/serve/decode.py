"""Continuous-batching decode over a paged KV pool (counterpart of
bigdl_tpu/serve/decode.py).

The rows of a fixed-width device batch are **slots**: each consumes its
own seed and generates its own continuation at its own position.
Requests are admitted into free slots and retired at step boundaries
only; positions, previous tokens and generated tokens stay on the device
between boundaries and feed back there.  The host reads the device every
``sync_interval`` steps at most: once per boundary that retires a
request or streams tokens (the generated-token slab), and, under
speculative decode or a stop list, the (B,) positions once a boundary.

KV storage is a block-paged pool (``models.transformer.new_pools``): a
request holds only the ``ceil(steps / page_size)`` pages its own length
needs, and a per-slot slot->page table on the device maps its positions
to pool pages.  Attention over the pool is ``ops.paged_attention``, the
hand-written CUDA kernel on the card, at S = 1 for a decode step and at
S = k+1 for a speculative verify window.  On top of the pool:

- **int8 KV** (``kv_quant="int8"``, default from
  ``BIGDL_SERVE_KV_QUANT``): int8 pools with per-page-row, per-head
  scales (``quant/kv.py``); the page walk is the kernel's int8 variant.
- **The prefix cache** (``serve/prefix.py``, env
  ``BIGDL_SERVE_PREFIX_CACHE``, on by default): a retiring request
  donates the full pages inside its seed to a token-hash chain cache; a
  new request whose seed matches maps those pages read-only into its
  table and starts at the divergence point.
- **Self-speculative decode** (``spec_k`` > 0, env
  ``BIGDL_SERVE_SPEC_K``): the model drafts ``k`` tokens a step with its
  own first ``draft_layers`` blocks, then one verify window of ``k+1``
  positions through the full model accepts the longest prefix whose
  drafts equal the verify argmax (sampled rows: the lossless
  accept/reject rule), so greedy rows commit exactly the
  non-speculative stream.
- **Sampled decode and stop sequences** (``serve/sampling.py``): each
  slot's temperature, top-k, top-p and key ride the step as tensors, so
  a batch mixing greedy and sampled requests is one step; greedy rows
  take the unchanged argmax and stay byte-identical to a greedy-only
  run.  Draws are keyed by the request's seed and generated index,
  never by slot or companions (under speculative decode the committed
  draws also follow where the windows fall, which a prefix hit's start
  moves; their distribution does not).  A stop sequence matched on the
  device
  freezes its row, which retires at the next boundary with its row cut
  just past the match.
- **Streaming** (``serve/streaming.py``): :meth:`ContinuousDecoder.submit`
  returns a :class:`~bigdl_tpu_torch.serve.streaming.StreamFuture`;
  ``on_tokens(cb)`` turns on delivery of the new tokens at each boundary
  from the boundary's one slab read, the callbacks on a delivery thread.

**Tensor-parallel serving** (``mesh=``, a ``parallel.mesh`` mesh with a
``model`` axis, e.g. ``hybrid_mesh(1, tp)``): Megatron sharding of the
decode step over that axis, as in the JAX decoder.  Each rank holds
whole attention heads (wq/wk/wv by output columns, wo by input rows)
and its rows of every FFN's hidden dim (lin1 rows, lin2 columns); the
embeddings, LayerNorms and the LM head are whole on every rank
(:func:`_tp_weight_specs`, :func:`_tp_local`).  Its KV pools are its own
contiguous arrays of H/tp heads (int8: scales too), and
``ops.paged_attention`` walks them.  Each branch's output projection is
summed over the axis by one all-reduce before its bias: two a block.
The mesh's other axes replicate.

The port runs one process a rank, so TP serving is SPMD: every rank of
the axis builds the decoder on the same weights and submits the same
requests in the same order, and then runs the same host loop
(admission, pages, prefix cache, boundaries).  An all-reduce hands every
rank the same sums, so the same log-probs, tokens and host decisions;
each rank's futures resolve to the same rows, and each rank delivers
its own stream (the caller picks the rank that answers).  Only the
submissions can part the ranks, so at every boundary, after admission,
the ranks compare a digest of the requests admitted so far and of the
queue's length: one int64 all-reduce (MAX of the digest and of its
negation) on the axis.  A mismatch fails every open future and raises
:class:`ReplicaMismatchError` naming this rank's digest and the group's
range, on every rank at the same boundary, before a step: the decoder
neither hangs nor serves on.  The check runs at every boundary, not only
at the ones that admit, because whether a boundary admits is itself
what parted ranks may disagree on.  A sampled request under TP names
its seed: one drawn at submit would differ from rank to rank.

**Telemetry** (``bigdl_tpu_torch.obs``, the JAX decoder's): every
counter, gauge and histogram of the JAX decoder in the process metrics
registry under ``decoder=<name>`` (steps, admissions, retirements, host
syncs, slots, pages, prefix hits, the speculative acceptance lengths,
TTFT and ITL), from which :meth:`ContinuousDecoder.stats` reads;
``decode_model_flops_util`` and ``decode_tokens_per_s`` set once a sync
boundary (the step's flops counted once a step shape on an eager step,
over an NVIDIA card's data-sheet peak: no utilization gauge on the CPU);
a request submitted with ``trace=`` (an ``obs.trace.Trace``) gains
``decode_admit``, ``first_token`` and ``retire`` hops and flight-recorder
notes (its replay recipe and committed row); ``serve`` events of kinds
``stream`` (a streamed request at retire) and ``decode`` (at the end of
:meth:`ContinuousDecoder.run`).

Not ported yet (ROADMAP.md queue 1, item 7): the host KV tier and
prefill page adoption (``adopt_pages``).
"""
from __future__ import annotations

import hashlib
import itertools
import os
import time
import weakref
from collections import deque

import numpy as np
import torch
import torch.distributed as dist

from bigdl_tpu_torch.obs import events as obs_events
from bigdl_tpu_torch.obs import ledger as obs_ledger
from bigdl_tpu_torch.obs import metrics as obs_metrics
from bigdl_tpu_torch.obs import recorder as obs_recorder
from bigdl_tpu_torch.models.transformer import (DEFAULT_PAGE_SIZE,
                                                _handles_to, _lm_forward_one,
                                                _lm_forward_window,
                                                _lm_handles, new_pools)
from bigdl_tpu_torch.parallel.collectives import all_reduce
from bigdl_tpu_torch.parallel.sharding import model_slice
from bigdl_tpu_torch.quant import kv_mode_default, normalize_mode
from bigdl_tpu_torch.quant import kv as kvq
from bigdl_tpu_torch.serve import sampling as smp
from bigdl_tpu_torch.serve.paging import PagePool, RequestTooLongError
from bigdl_tpu_torch.serve.prefix import PrefixCache
from bigdl_tpu_torch.serve.streaming import StreamFuture, TokenDelivery
from bigdl_tpu_torch.utils.device import pin_fp32, resolve_device

DEFAULT_SYNC = 8
ENV_PREFIX = "BIGDL_SERVE_PREFIX_CACHE"
ENV_SPEC_K = "BIGDL_SERVE_SPEC_K"
ENV_STOP_SEQS = "BIGDL_SERVE_MAX_STOP_SEQS"
DEFAULT_STOP_SEQS = 2
ENV_STOP_LEN = "BIGDL_SERVE_MAX_STOP_LEN"
DEFAULT_STOP_LEN = 8
_DECODER_SEQ = itertools.count()


def _env_int(name, default):
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def _pages_needed(steps: int, page_size: int) -> int:
    """Pages a request's full lifetime reserves: ``ceil(steps /
    page_size)``.  The one spot for the reservation math, shared by
    ``submit``'s too-long check and admission.  Speculative decode adds
    no page: window positions past a slot's capacity are gated to the
    scratch page."""
    return -(-steps // page_size)


class ReplicaMismatchError(RuntimeError):
    """The ranks of a tensor-parallel decoder were handed different
    requests: their admission digests part at a boundary."""


#: the dim each attention leaf splits on over the model axis (None: whole
#: on every rank): wq/wk/wv by output columns, head-major, so that a rank
#: holds whole heads, their biases to match; wo by input rows; bo whole
#: (added once, after the sum)
_TP_ATTN = {"wq": 1, "wk": 1, "wv": 1, "bq": 0, "bk": 0, "bv": 0,
            "wo": 0, "bo": None}


def _tp_weight_specs(handles) -> dict:
    """The counterpart of the JAX decoder's ``_tp_weight_specs``
    (bigdl_tpu/serve/decode.py:172-201), as the dim each decode weight
    splits on over the ``model`` axis, None where it is whole: the
    attention by :data:`_TP_ATTN`; lin1 (hidden, d) by its hidden rows
    and bias, lin2 (d, hidden) by its hidden columns, its bias whole; the
    embeddings, LayerNorms and the LM head whole."""
    def whole(d):
        return dict.fromkeys(d)

    blocks = []
    for (ln1, m, ln2, lin1, lin2) in handles.blocks:
        if set(m) != set(_TP_ATTN):
            raise ValueError(
                f"attention param keys {sorted(m)} diverged from the TP "
                f"sharding map {sorted(_TP_ATTN)} — update _tp_weight_specs")
        blocks.append((whole(ln1), dict(_TP_ATTN), whole(ln2),
                       {"weight": 0, "bias": 0}, {"weight": 1, "bias": None}))
    return {"emb": whole(handles.emb), "blocks": blocks,
            "ln_f": whole(handles.ln_f), "head": whole(handles.head)}


def _tp_local(handles, index: int, tp: int):
    """Rank ``index``'s handles of ``tp``: each leaf :func:`_tp_weight_specs`
    splits cut to the rank's ``parallel.sharding.model_slice`` of that dim
    (a contiguous tensor of its own), the rest whole, and ``n_heads`` the
    rank's H / tp.  Raises the JAX decoder's errors where tp divides
    neither the heads nor an FFN's hidden dim (decode.py:636-648)."""
    H = handles.n_heads
    if H % tp:
        raise ValueError(f"tensor parallelism {tp} must divide "
                         f"n_heads={H}")
    for li, (_, _, _, lin1, _) in enumerate(handles.blocks):
        hidden = int(lin1["weight"].shape[0])
        if hidden % tp:
            raise ValueError(
                f"tensor parallelism {tp} must divide the FFN hidden dim "
                f"({hidden}, block {li})")
    specs = _tp_weight_specs(handles)

    def cut(d, spec):
        out = {}
        for k, t in d.items():
            if spec[k] is None:
                out[k] = t
                continue
            sl = model_slice(t.shape[spec[k]], index, tp)
            out[k] = t.narrow(spec[k], sl.start,
                              sl.stop - sl.start).contiguous()
        return out

    blocks = [tuple(cut(d, sp) for d, sp in zip(b, sb))
              for b, sb in zip(handles.blocks, specs["blocks"])]
    return handles._replace(blocks=blocks, n_heads=H // tp)


def _digest_step(prev: bytes, *parts) -> bytes:
    """The admission chain's next link: 8 bytes of blake2b over the last
    link and ``parts`` (the same on every process, unlike ``hash``)."""
    return hashlib.blake2b(prev + repr(parts).encode(),
                           digest_size=8).digest()


def _decoder_gc_cleanup(reg, name, box):
    """``weakref.finalize`` target for a decoder nobody closed: stop its
    delivery thread and drop its series from the metrics registry."""
    for d in box:
        try:
            d.close(timeout=2.0)
        except Exception:  # pragma: no cover - teardown
            pass
    reg.drop_series(decoder=name)


class _DecodeReq:
    __slots__ = ("seed", "n_words", "params", "future", "slot",
                 "steps_needed", "start_pos", "pos", "pages", "t_submit",
                 "first_ts", "streamed", "rid", "trace", "t_admit",
                 "last_ts", "timeline", "stop_retired")

    def __init__(self, seed, n_words, params, trace=None):
        self.seed = [int(t) for t in seed]
        self.n_words = int(n_words)
        self.params = params
        self.future = StreamFuture()
        self.slot = None
        # positions fed through = n_seed + n_words - 1 (lm_decode's n_pos)
        self.steps_needed = len(self.seed) + self.n_words - 1
        self.start_pos = 0       # > 0 on a prefix-cache hit
        self.pos = 0             # the position at the boundary's start
        self.pages = []          # pool page ids, logical order
        self.rid = 0
        self.trace = trace       # obs.trace.Trace of a traced request
        self.t_submit = time.perf_counter()
        self.t_admit = None      # slot admission boundary
        self.first_ts = None     # first-token boundary
        self.last_ts = None      # last boundary that delivered tokens
        self.streamed = 0        # generated tokens delivered so far
        self.timeline = []       # [(perf_counter ts, n new tokens)]
        self.stop_retired = False


class ContinuousDecoder:
    """Continuous-batching decoder for one ``TransformerLM``.

    ``max_slots`` is the device batch width B; ``n_pos`` the per-request
    position capacity -- a request needs ``len(seed) + n_words - 1 <=
    n_pos``, and one that does not fit fails ITS OWN future with
    :class:`RequestTooLongError`.  The pool holds ``n_pages`` pages of
    ``page_size`` tokens (default: ``ceil(n_pos / page_size) *
    max_slots``).  :meth:`submit` queues a request and returns a
    :class:`~bigdl_tpu_torch.serve.streaming.StreamFuture` of the full
    token row (seed included, ``lm_decode``'s output for a greedy
    request); :meth:`run` drives the slots until every request has
    resolved.

    ``prefix_cache`` (None: ``BIGDL_SERVE_PREFIX_CACHE``, default on)
    reuses donated seed pages; ``spec_k`` (None: ``BIGDL_SERVE_SPEC_K``,
    default 0) > 0 drafts that many tokens a step with the first
    ``draft_layers`` blocks (default ``max(1, L // 2)``);
    ``max_stop_seqs`` / ``max_stop_len`` (defaults 2 / 8, env
    ``BIGDL_SERVE_MAX_STOP_SEQS`` / ``BIGDL_SERVE_MAX_STOP_LEN``) size
    each slot's packed stop buffer.  ``kv_quant`` is ``"off"`` (fp32
    pools) or ``"int8"``; ``None`` reads ``BIGDL_SERVE_KV_QUANT`` (default
    off), and an unknown mode raises ``ValueError`` naming it.

    ``device`` defaults to ``"cuda"`` and raises when there is no card;
    the weights are used on that device (moved there once if the model
    lives elsewhere).  :meth:`close` stops the delivery thread and
    releases the prefix cache's pages.

    ``name`` labels the decoder's series in the metrics registry
    (``decoder=<name>``; default ``decoder<N>``); :meth:`close`, or the
    decoder's collection, drops them.

    ``mesh`` (a ``parallel.mesh.Mesh``; None: one device) serves tensor
    parallel over its ``model`` axis, SPMD as the module docstring sets
    out: every rank of the axis constructs the decoder and submits the
    same requests in the same order.  A mesh with no ``model`` axis, or
    one of size 1, is ``tp == 1``.  The rank's handles (its shards and
    the whole leaves) are cut once here and only they are moved to
    ``device``; the axis's process group is used as given (gloo takes
    CUDA tensors too, staging through the host)."""

    def __init__(self, model, max_slots: int = 4, n_pos: int = 64,
                 sync_interval: int | None = None,
                 page_size: int | None = None, n_pages: int | None = None,
                 prefix_cache: bool | None = None,
                 spec_k: int | None = None, draft_layers: int | None = None,
                 kv_quant: str | None = None,
                 max_stop_seqs: int | None = None,
                 max_stop_len: int | None = None, device="cuda",
                 mesh=None, name: str | None = None):
        self.kv_quant = (kv_mode_default() if kv_quant is None else
                         normalize_mode(kv_quant, kvq.ON_MODES, "kv_quant"))
        self.device = dev = resolve_device(device)
        pin_fp32(dev)
        self.B = B = int(max_slots)
        self.n_pos = int(n_pos)
        self.sync_interval = (DEFAULT_SYNC if sync_interval is None
                              else max(1, int(sync_interval)))
        self.page_size = ps = max(1, DEFAULT_PAGE_SIZE if page_size is None
                                  else int(page_size))
        self.pages_per_slot = -(-self.n_pos // ps)
        if n_pages is None:
            n_pages = self.pages_per_slot * B
        self.spec_k = max(0, _env_int(ENV_SPEC_K, 0) if spec_k is None
                          else int(spec_k))
        self.max_stop_seqs = max(1, _env_int(ENV_STOP_SEQS,
                                             DEFAULT_STOP_SEQS)
                                 if max_stop_seqs is None
                                 else int(max_stop_seqs))
        self.max_stop_len = max(1, _env_int(ENV_STOP_LEN, DEFAULT_STOP_LEN)
                                if max_stop_len is None
                                else int(max_stop_len))
        use_prefix = (bool(_env_int(ENV_PREFIX, 1)) if prefix_cache is None
                      else bool(prefix_cache))
        self._pool = PagePool(int(n_pages), ps)
        self._prefix = PrefixCache(self._pool) if use_prefix else None
        self._n_view = n_view = self.pages_per_slot * ps
        whole = _lm_handles(model)
        self.mesh = mesh
        axis = (mesh.axis("model") if mesh is not None
                and "model" in mesh.axis_names else None)
        self.tp = axis.size if axis is not None else 1
        # the model axis the step's all-reduces run over (None: tp == 1)
        self._tp_group = axis if self.tp > 1 else None
        if self._tp_group is not None:
            whole = _tp_local(whole, axis.index, self.tp)
            # the admission digest: a CPU tensor for gloo, which reads no
            # device for it; NCCL takes the card's
            self._digest_dev = (torch.device("cpu")
                                if dist.get_backend(axis.group) == "gloo"
                                else dev)
            self._admit_chain = b""
            self.tp_checks = 0
        self._handles = h = _handles_to(whole, dev)
        L = h.n_layers
        self.draft_layers = Ld = (max(1, L // 2) if draft_layers is None
                                  else min(L, max(1, int(draft_layers))))
        self._draft = h._replace(blocks=h.blocks[:Ld],
                                 block_eps=h.block_eps[:Ld], n_layers=Ld)
        self._pe = h.mods[1].table(n_view).to(dev)
        self._caches = new_pools(h, self._pool.n_pages, ps, dev,
                                 self.kv_quant)
        # the whole model's, as in the JAX decoder: every rank's pools
        # together hold a token at this cost
        self.kv_bytes_per_token = kvq.bytes_per_token(
            L, h.n_heads * self.tp, h.hd, self.kv_quant)

        def z(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        NS, LS = self.max_stop_seqs, self.max_stop_len
        self._rows = torch.arange(B, device=dev)
        self._pos = z(B)
        self._prev = z(B)
        self._active = z(B, dtype=torch.bool)
        self._finished = z(B, dtype=torch.bool)
        self._seeds = z(B, n_view)
        self._seed_len = z(B)
        # column n_view takes the writes of rows that commit nothing
        self._gen = z(B, n_view + 1)
        self._ptab = z(B, self.pages_per_slot)
        self._ptab_live = self._ptab     # the columns a cycle reads
        # a never-admitted slot clips to position -1 (it wraps in every
        # index and is never live); admission sets the real capacity
        self._cap = z(B)
        # per-slot sampling state (zeros: greedy, no stop sequence)
        self._temp = z(B, dtype=torch.float32)
        self._topk = z(B, dtype=torch.int64)
        self._topp = z(B, dtype=torch.float32)
        self._keys = z(B, 2, dtype=torch.int64)
        self._stop_buf = z(B, NS, LS)
        self._stop_len = z(B, NS)
        # the live requests' lanes, set at each boundary from the host's
        # own view of them (no device read): which of the sampled lane,
        # top-k, top-p and the stop match the cycle computes
        self._lanes = (False, False, False, False)
        if self.spec_k:
            self._acc_hist = z(self.spec_k + 1, dtype=torch.int64)
            self.accept_counts = np.zeros(self.spec_k + 1, np.int64)

        self._pending: "deque[_DecodeReq]" = deque()
        self._slots: list = [None] * B
        self._delivery = None
        self._delivery_box: list = []
        self.name = name or f"decoder{next(_DECODER_SEQ)}"
        self._flags_cache = None
        self._peak_flops = obs_ledger.device_peak_flops(dev)
        #: the served weights' version, where the caller keeps one; the
        #: flight recorder notes it a traced request
        self.weights_version = None
        self._instruments(self.name)
        # a decoder nobody closes: its delivery thread stops and its
        # series leave the registry at collection
        self._finalize = weakref.finalize(
            self, _decoder_gc_cleanup, self._reg, self.name,
            self._delivery_box)
        self._req_seq = itertools.count(1)
        self.live_hwm = 0
        self.spec_windows = 0
        self.spec_accepted = 0
        self.stream_boundaries = 0
        # the utilization gauges' window; the step's flops key
        self._step_fn_key = ("decode_step", self.name)
        self._util_t_last = time.perf_counter()
        obs_ledger.note_tenant(
            "kv_pool", obs_ledger.tree_nbytes(self._caches),
            decoder=self.name, kv_quant=self.kv_quant)

    def _instruments(self, name):
        """The JAX decoder's registry series (bigdl_tpu/serve/decode.py
        :933-1010), labelled ``decoder=<name>``."""
        reg = self._reg = obs_metrics.get()
        lab = {"decoder": name}
        self._m_steps = reg.counter(
            "decode_steps_total", "decode steps driven", **lab)
        self._m_admitted = reg.counter(
            "decode_admitted_total", "requests admitted into slots", **lab)
        self._m_retired = reg.counter(
            "decode_retired_total", "requests retired from slots", **lab)
        self._m_syncs = reg.counter(
            "decode_host_syncs_total", "boundary device->host fetches",
            **lab)
        self._m_slots = reg.gauge(
            "decode_slots_active", "occupied decode slots", **lab)
        self._m_slots_hwm = reg.gauge(
            "decode_slots_hwm", "live-request high-water mark", agg="max",
            **lab)
        reg.gauge("decode_kv_bytes_per_token",
                  "KV bytes per pooled token incl. scales",
                  **lab).set(self.kv_bytes_per_token)
        # only where the card has a data-sheet peak: no gauge on the CPU
        self._m_util = (reg.gauge(
            "decode_model_flops_util",
            "model flops utilization of the decode step over the last "
            "sync-boundary window", agg="max", **lab)
            if self._peak_flops else None)
        self._m_toks = reg.gauge(
            "decode_tokens_per_s",
            "committed tokens per second over the last sync-boundary "
            "window", **lab)
        self._m_pages = reg.gauge(
            "decode_pages_in_use", "allocated KV pool pages", **lab)
        reg.gauge("decode_pages_total", "KV pool size in pages",
                  **lab).set(self._pool.n_pages)
        self._m_pfx_hit = reg.counter(
            "decode_prefix_hits_total",
            "requests admitted with >=1 cached prefix page", **lab)
        self._m_pfx_miss = reg.counter(
            "decode_prefix_misses_total",
            "requests admitted with no cached prefix page", **lab)
        self._m_pfx_pages = reg.counter(
            "decode_prefix_pages_total",
            "prefill pages served from the prefix cache", **lab)
        if self.spec_k:
            self._m_accept = reg.histogram(
                "decode_spec_accept_len",
                "accepted draft tokens per speculative window",
                bounds=obs_metrics.SPEC_ACCEPT_BUCKETS, **lab)
        self._m_ttft = reg.histogram(
            "decode_ttft_seconds",
            "submit-to-first-streamed-token latency", **lab)
        self._m_itl = reg.histogram(
            "decode_itl_seconds",
            "inter-token gap of streamed tokens (per-token, averaged "
            "within a boundary)", bounds=obs_metrics.ITL_BUCKETS, **lab)
        self._m_stream_toks = reg.counter(
            "decode_stream_tokens_total",
            "tokens delivered incrementally at sync boundaries", **lab)
        self._m_sampled = reg.counter(
            "decode_sampled_total",
            "sampled (temperature > 0) requests admitted", **lab)
        self._m_stop_retired = reg.counter(
            "decode_stop_retired_total",
            "requests retired early on a stop-sequence match", **lab)
        self._m_steps_saved = reg.counter(
            "decode_steps_saved_total",
            "decode step-slots reclaimed by stop-sequence early "
            "retirement", **lab)

    # the decoder's counts: its registry series (the instruments it
    # holds, which a registry reset or ``close`` does not clear)
    steps = property(lambda self: int(self._m_steps.value))
    host_syncs = property(lambda self: int(self._m_syncs.value))
    admitted = property(lambda self: int(self._m_admitted.value))
    retired = property(lambda self: int(self._m_retired.value))
    sampled = property(lambda self: int(self._m_sampled.value))
    stop_retired = property(lambda self: int(self._m_stop_retired.value))
    steps_saved = property(lambda self: int(self._m_steps_saved.value))
    streams = property(lambda self: self._m_ttft.state()[2])
    stream_tokens = property(lambda self: int(self._m_stream_toks.value))

    def decode_flags(self) -> dict:
        """The constructor recipe a replay needs to rebuild an equivalent
        decoder for a recorded request (the flight recorder notes it a
        traced request)."""
        if self._flags_cache is None:
            self._flags_cache = {
                "max_slots": self.B, "n_pos": self.n_pos,
                "sync_interval": self.sync_interval, "paged": True,
                "page_size": self.page_size, "n_pages": self._pool.n_pages,
                "prefix_cache": self._prefix is not None,
                "spec_k": self.spec_k, "draft_layers": self.draft_layers,
                "kv_quant": self.kv_quant,
                "max_stop_seqs": self.max_stop_seqs,
                "max_stop_len": self.max_stop_len}
        return self._flags_cache

    # -- the device step ------------------------------------------------------
    def _filters(self):
        """(temperature, top-k, top-p) of the sampled lane: the per-slot
        tensors, a filter no live request uses passed as its off value."""
        _, topk, topp, _ = self._lanes
        return (self._temp, self._topk if topk else 0,
                self._topp if topp else 0.0)

    def _next_token(self, logp, pos):
        """The committed token at write position ``pos``: greedy rows take
        the unchanged argmax (the byte-identity lane), sampled rows draw
        from their filtered distribution under their request's key at
        this generated index."""
        greedy = logp.argmax(dim=-1).to(torch.int32)
        if not self._lanes[0]:
            return greedy
        gidx = (pos - (self._seed_len - 1)).clamp(min=0).long()
        sub = smp.fold_in_rows(self._keys,
                               smp.DRAW_TAGS * gidx + smp.TAG_MAIN)
        samp = smp.sample_tokens(logp, sub, *self._filters())
        return torch.where(self._temp > 0, samp.to(torch.int32), greedy)

    def _stop_hit(self, ends):
        """Does a stop sequence of the slot end exactly at write position
        ``ends[b, s]``?  ``ends`` (B, S) -> (B, S) bool.  The match looks
        backward only and must lie wholly in the output (write positions
        >= seed_len - 1: a seed never matches); right-aligned buffers make
        it one fixed-shape comparison whatever each sequence's length."""
        LS, n_view = self.max_stop_len, self._n_view
        idx = (ends[:, :, None] - (LS - 1)
               + torch.arange(LS, device=ends.device))          # (B,S,LS)
        tok = self._gen[self._rows[:, None, None], idx.clamp(0, n_view - 1)]
        out_ok = idx >= (self._seed_len - 1)[:, None, None]
        eq = ((tok[:, :, None, :] == self._stop_buf[:, None, :, :])
              & out_ok[:, :, None, :])                       # (B,S,NS,LS)
        need = (torch.arange(LS, device=ends.device)
                >= (LS - self._stop_len)[:, None, :, None])
        hit = torch.where(need, eq, True).all(dim=-1)           # (B,S,NS)
        return ((self._stop_len > 0)[:, None, :] & hit).any(dim=-1)

    @torch.no_grad()
    def _run_step(self):
        """One position for every slot (decode.py ``paged_step_body``):
        parked and finished slots neither advance nor write, and their
        attention reads no page."""
        rows, pos = self._rows, self._pos
        live = self._active & ~self._finished & (pos < self._cap)
        wp = torch.minimum(pos.clamp(min=0), self._cap - 1)
        tok = torch.where(pos < self._seed_len, self._seeds[rows, wp],
                          self._prev)
        logp, self._caches = _lm_forward_one(
            tok, wp, self._caches, self._handles, self._pe,
            (self._ptab_live, self.page_size), valid=live,
            group=self._tp_group)
        nxt = self._next_token(logp, pos)
        self._gen[rows, torch.where(live, wp, self._n_view)] = nxt
        self._prev = torch.where(live, nxt, self._prev)
        self._pos = torch.where(live, pos + 1, pos)
        if self._lanes[3]:
            hit = self._stop_hit(wp[:, None])[:, 0]
            self._finished = self._finished | (live & hit)

    @torch.no_grad()
    def _run_spec_step(self):
        """One speculative step (decode.py ``spec_step_body``): ``k``
        draft steps through the first ``draft_layers`` blocks, one verify
        window of ``k+1`` positions through the full model (its attention
        ``paged_attention`` at S = k+1; it rewrites the draft's K/V at
        every position it covers before any query reads them), then the
        greedy or lossless sampled acceptance."""
        k, B, ps, n_view = self.spec_k, self.B, self.page_size, self._n_view
        rows, pos, cap = self._rows, self._pos, self._cap
        seed_len, keys, temp = self._seed_len, self._keys, self._temp
        sampled_lane = self._lanes[0]
        pages = (self._ptab_live, ps)
        live = self._active & ~self._finished & (pos < cap)
        sampled = temp > 0 if sampled_lane else None

        def clip(p):
            # into the slot's pages: a position past them is gated to the
            # scratch page, and the clip keeps its table index in range
            c = cap if p.dim() == 1 else cap[:, None]
            return torch.minimum(p, c - 1).clamp(min=0)

        # -- k drafts with the shallow pass; seed positions stay forced;
        # sampled rows DRAW their draft from the filtered shallow
        # distribution, which is the q of the acceptance below
        t0 = torch.where(pos < seed_len, self._seeds[rows, clip(pos)],
                         self._prev)
        toks, qs, d_tok, d_pos = [t0], [], t0, pos
        for _ in range(k):
            dlogp, self._caches = _lm_forward_one(
                d_tok, clip(d_pos), self._caches, self._draft, self._pe,
                pages, valid=live & (d_pos < cap), group=self._tp_group)
            d_draft = dlogp.argmax(dim=-1).to(torch.int32)
            if sampled_lane:
                lq = smp.filter_logits(dlogp, *self._filters())
                gq = (d_pos - (seed_len - 1)).clamp(min=0).long()
                d_smp = smp.categorical(smp.fold_in_rows(
                    keys, smp.DRAW_TAGS * gq + smp.TAG_DRAFT), lq)
                qs.append(torch.softmax(lq, dim=-1))
                d_draft = torch.where(sampled, d_smp.to(torch.int32),
                                      d_draft)
            d_pos = d_pos + 1
            d_tok = torch.where(d_pos < seed_len,
                                self._seeds[rows, d_pos.clamp(max=n_view - 1)],
                                d_draft)
            toks.append(d_tok)
        W = torch.stack(toks, dim=1)                           # (B, k+1)
        span = torch.arange(k + 1, device=pos.device)
        p_idx = pos[:, None] + span
        valid = live[:, None] & (p_idx < cap[:, None])
        wp = clip(p_idx)
        # -- one verify window through the full model
        logp, self._caches = _lm_forward_window(
            W, wp, self._caches, self._handles, self._pe, pages,
            valid=valid, group=self._tp_group)
        g = logp.argmax(dim=-1).to(torch.int32)               # (B, k+1)
        # greedy lane: draft j+1 survives iff it equals the verify argmax
        # at j (seed-forced positions always survive), so the committed
        # stream is exactly the non-speculative greedy stream
        forced = p_idx[:, 1:] < seed_len[:, None]
        match = valid[:, 1:] & (forced | (W[:, 1:] == g[:, :k]))
        if sampled_lane:
            # the Leviathan accept u * q(x) < p(x), p filtered with the
            # same per-row parameters as the draft's q
            tf, kf, pf = self._filters()
            pp = torch.softmax(smp.filter_logits(
                logp, tf, kf, pf), dim=-1)                 # (B, k+1, V)
            qs = torch.stack(qs, dim=1)                       # (B, k, V)
            ga = (p_idx[:, :k] - (seed_len - 1)[:, None]).clamp(min=0)
            u = smp.uniform_rows(smp.fold_in_rows(
                keys[:, None, :].expand(B, k, 2),
                smp.DRAW_TAGS * ga.long() + smp.TAG_ACCEPT))
            x = W[:, 1:, None].long()
            p_x = pp[:, :k].gather(-1, x)[..., 0]
            q_x = qs.gather(-1, x)[..., 0]
            match_s = valid[:, 1:] & (forced | (u * q_x < p_x))
            match = torch.where(sampled[:, None], match_s, match)
        acc = torch.cumprod(match.to(torch.int64), dim=1).sum(dim=1)
        consumed = torch.where(live, torch.minimum(acc + 1, cap - pos), 0)
        commit = span[None, :] < consumed[:, None]
        C = g
        if sampled_lane:
            # sampled rows commit their accepted drafts, the slot at
            # ``acc`` replaced by the residual draw (a rejection) or, at
            # slot k with q = 0, a fresh draw from p (the bonus token)
            ai = acc.clamp(0, k)
            qa = torch.cat([qs, torch.zeros_like(qs[:, :1])], dim=1)[rows, ai]
            pa = pp[rows, ai]
            gfix = (pos + acc - (seed_len - 1)).clamp(min=0)
            c = smp.categorical(smp.fold_in_rows(
                keys, smp.DRAW_TAGS * gfix + smp.TAG_FIX),
                torch.log(smp.spec_residual(pa, qa))).to(torch.int32)
            Sx = torch.cat([W[:, 1:], torch.zeros_like(W[:, :1])], dim=1)
            Sx = torch.where(span[None, :] == acc[:, None], c[:, None], Sx)
            C = torch.where(sampled[:, None], Sx, g)
        self._gen[rows[:, None], torch.where(commit, wp, n_view)] = C
        if self._lanes[3]:
            # the first committed slot that ends a stop sequence cuts the
            # run there and freezes the row for boundary retirement
            hit = self._stop_hit(wp) & commit
            any_hit = hit.any(dim=1)
            first = hit.to(torch.int32).argmax(dim=1)
            consumed = torch.where(any_hit,
                                   torch.minimum(consumed, first + 1),
                                   consumed)
            self._finished = self._finished | (any_hit & live)
        self._prev = torch.where(
            consumed > 0, C[rows, (consumed - 1).clamp(0, k)], self._prev)
        # the acceptance histogram covers pure decode windows only:
        # seed-forced windows accept by construction
        rec = live & (p_idx[:, 1] >= seed_len)
        self._pos = (pos + consumed).to(torch.int32)
        self._acc_hist += torch.where(
            rec[:, None],
            torch.nn.functional.one_hot(acc, k + 1), 0).sum(dim=0)

    # -- admission and retirement ----------------------------------------
    def _apply_admit(self, slot: int, req: _DecodeReq):
        """Load one request's state into ``slot`` (decode.py ``admit``):
        one host->device copy of a packed int32 row (the float parameters
        as their bits), then device-side writes."""
        P, n_view = self.pages_per_slot, self._n_view
        NS, LS = self.max_stop_seqs, self.max_stop_len
        p = req.params
        head = 8
        o_sl, o_sb = head, head + NS
        o_pt = o_sb + NS * LS
        o_sd = o_pt + P
        pack = np.zeros(o_sd + n_view, np.int32)
        pack[:4] = (req.start_pos, len(req.seed),
                    len(req.pages) * self.page_size, p.top_k)
        pack[4:6] = np.asarray(smp.key_words(p.seed), np.uint32).view(
            np.int32)
        pack[6:8] = np.asarray([p.temperature, p.top_p], np.float32).view(
            np.int32)
        for j, seq in enumerate(p.stop):
            pack[o_sl + j] = len(seq)
            pack[o_sb + j * LS + LS - len(seq):o_sb + (j + 1) * LS] = seq
        pack[o_pt:o_pt + len(req.pages)] = req.pages
        pack[o_sd:o_sd + len(req.seed)] = req.seed
        row = torch.from_numpy(pack).to(self.device)
        self._pos[slot] = row[0]
        self._seed_len[slot] = row[1]
        self._cap[slot] = row[2]
        self._topk[slot] = row[3]
        self._keys[slot] = row[4:6].long() & 0xFFFFFFFF
        self._temp[slot] = row[6:7].view(torch.float32)[0]
        self._topp[slot] = row[7:8].view(torch.float32)[0]
        self._stop_len[slot] = row[o_sl:o_sb]
        self._stop_buf[slot] = row[o_sb:o_pt].reshape(NS, LS)
        self._ptab[slot] = row[o_pt:o_sd]
        self._seeds[slot] = row[o_sd:]
        self._active[slot] = True
        self._finished[slot] = False
        self._gen[slot] = 0

    def _apply_retire(self, slot: int):
        """decode.py ``retire``: frozen rows' writes are already gated to
        the scratch page, so the table reset is hygiene.  The slot goes
        back to a never-admitted one's position -1, so its dead row reads
        the table at no column past a live request's pages."""
        self._ptab[slot] = 0
        self._pos[slot] = 0
        self._cap[slot] = 0
        self._active[slot] = False

    # -- submit -------------------------------------------------------------
    def submit(self, seed_ids, n_words: int, sampling=None,
               trace=None) -> StreamFuture:
        """Queue one request; the future resolves to the full token row
        (seed + up to ``n_words`` generated ids), ``lm_decode``'s greedy
        output for the same seed by default.

        ``sampling`` (a :class:`~bigdl_tpu_torch.serve.sampling.SamplingParams`,
        its ``to_dict`` form or None for greedy) selects the sampled lane:
        temperature / top-k / top-p draws keyed by the request's (resolved)
        seed, stop token sequences that retire the request at the boundary
        after a match (the row then ends just past the matched sequence),
        and ``max_tokens`` capping ``n_words``.  A stop list past this
        decoder's packed capacity (``max_stop_seqs`` x ``max_stop_len``)
        fails its own future with ``ValueError``; a request that can never
        fit fails its own with :class:`RequestTooLongError`.

        The future streams too: ``on_tokens(cb)`` (or ``request_stream``)
        turns on delivery of the generated tokens at each boundary, equal
        to the resolved row's tail.  ``trace`` (an ``obs.trace.Trace``)
        gains ``decode_admit`` / ``first_token`` / ``retire`` hops as the
        request moves, and the flight recorder notes its replay recipe
        and committed row under its trace id."""
        seed = np.asarray(seed_ids, np.int64)
        if seed.ndim != 1 or seed.size == 0:
            raise ValueError("seed_ids must be one flat non-empty id row")
        if n_words < 1:
            raise ValueError("n_words must be >= 1")
        asked = smp.SamplingParams.of(sampling)
        params = asked.resolved()
        if params.max_tokens is not None:
            n_words = min(int(n_words), params.max_tokens)
        req = _DecodeReq(seed.tolist(), n_words, params, trace=trace)
        req.rid = next(self._req_seq)
        if trace is not None:
            # the flight recorder's identity of the request: what a replay
            # needs to rebuild an equivalent decoder (host dict merges)
            obs_recorder.note(
                trace.trace_id, rid=f"{self.name}/{req.rid}",
                decoder=self.name,
                seed_hash=obs_recorder.seed_hash(req.seed),
                seed_len=len(req.seed), n_words=req.n_words,
                flags=self.decode_flags(),
                weights_version=self.weights_version)
            if not params.is_default:
                obs_recorder.note(trace.trace_id, sampling=params.to_dict())
        if self.tp > 1 and not asked.greedy and asked.seed is None:
            req.future.set_exception(ValueError(
                "a sampled request under tensor parallelism names its "
                "seed (SamplingParams(seed=...)): a seed drawn at submit "
                "differs from rank to rank"))
            return req.future
        if (len(params.stop) > self.max_stop_seqs
                or any(len(s) > self.max_stop_len for s in params.stop)):
            req.future.set_exception(ValueError(
                f"stop list exceeds this decoder's packed capacity "
                f"({self.max_stop_seqs} sequences x {self.max_stop_len} "
                f"tokens); raise max_stop_seqs/max_stop_len at "
                f"construction"))
            return req.future
        if (req.steps_needed > self.n_pos
                or _pages_needed(req.steps_needed, self.page_size)
                > self._pool.n_pages):
            req.future.set_exception(RequestTooLongError(
                f"request needs {req.steps_needed} positions "
                f"(len(seed)={len(req.seed)} + n_words={req.n_words} - 1)"
                f" but this decoder holds n_pos={self.n_pos} across "
                f"{self._pool.n_pages} pages of {self.page_size}; raise "
                f"n_pos/the pool or split the request"))
            return req.future
        self._pending.append(req)
        return req.future

    # -- drive --------------------------------------------------------------
    def _alloc_pages(self, n):
        """``n`` fresh pool pages, evicting cache-only prefix pages on
        demand (one LRU scan); None when the pool cannot give them yet."""
        short = n - self._pool.free_count
        if short > 0 and (self._prefix is None
                          or self._prefix.evict(short) < short):
            return None
        return [self._pool.alloc_one() for _ in range(n)]

    def _try_admit(self, req) -> bool:
        """Pages for ``req``: its prefix-cache match mapped read-only, the
        rest fresh; it starts at the first position it does not share."""
        shared = (self._prefix.match(req.seed) if self._prefix is not None
                  else [])
        fresh = self._alloc_pages(
            _pages_needed(req.steps_needed, self.page_size) - len(shared))
        if fresh is None:
            for pid in shared:
                self._pool.release(pid)
            return False
        req.pages = shared + fresh
        req.start_pos = req.pos = len(shared) * self.page_size
        if self._prefix is not None:
            self._prefix.note_request(len(shared))
            if shared:
                self._m_pfx_hit.inc()
                self._m_pfx_pages.inc(len(shared))
            else:
                self._m_pfx_miss.inc()
        return True

    def _admit_waiting(self):
        for slot in range(self.B):
            if self._slots[slot] is not None or not self._pending:
                continue
            req = self._pending[0]
            if not self._try_admit(req):
                break   # head-of-line: wait for retirements to free pages
            self._pending.popleft()
            req.slot = slot
            if self._tp_group is not None:
                self._admit_chain = _digest_step(
                    self._admit_chain, slot, req.seed, req.n_words,
                    req.params.to_dict(), req.start_pos)
            self._apply_admit(slot, req)
            self._slots[slot] = req
            req.t_admit = time.perf_counter()
            if req.trace is not None:
                req.trace.stamp("decode_admit", req.t_admit)
                obs_recorder.note(req.trace.trace_id,
                                  start_pos=req.start_pos,
                                  kv_pages=len(req.pages),
                                  prefix_pages=req.start_pos
                                  // self.page_size)
            self._m_admitted.inc()
            if not req.params.greedy:
                self._m_sampled.inc()
        self._m_pages.set(self._pool.in_use)

    def _retire_req(self, req: _DecodeReq):
        """Free the slot; donate the full pages inside the seed to the
        prefix cache (their K/V is a pure function of the seed prefix;
        shared pages just drop this slot's reference) and release the
        rest."""
        self._apply_retire(req.slot)
        donate = 0
        if self._prefix is not None:
            donate = min(len(req.seed) // self.page_size, len(req.pages))
            self._prefix.insert(req.seed, req.pages[:donate])
        for pid in req.pages[donate:]:
            self._pool.release(pid)
        self._m_pages.set(self._pool.in_use)
        self._slots[req.slot] = None
        self._m_retired.inc()

    def _set_lanes(self, live):
        sampled = [r.params for r in live if not r.params.greedy]
        self._lanes = (bool(sampled),
                       any(p.top_k for p in sampled),
                       any(0 < p.top_p < 1 for p in sampled),
                       any(r.params.stop for r in live))

    def _check_replicas(self):
        """The tensor-parallel ranks' admissions agree: one int64
        all-reduce (MAX) of this rank's digest and of its negation over
        the model axis gives the group's largest and smallest digest.
        Where they differ, every open future fails and the call raises,
        on every rank of the group alike."""
        d = int.from_bytes(_digest_step(self._admit_chain,
                                        len(self._pending)), "big") >> 2
        t = torch.tensor([d, -d], dtype=torch.int64,
                         device=self._digest_dev)
        all_reduce(t, self._tp_group, op=dist.ReduceOp.MAX)
        hi, neg_lo = t.tolist()
        lo = -neg_lo
        self.tp_checks += 1
        if hi == lo:
            return
        err = ReplicaMismatchError(
            f"tensor-parallel ranks admitted different requests: this "
            f"rank (model index {self._tp_group.index} of {self.tp}) has "
            f"admission digest {d:#018x}, the model group's digests "
            f"range from {lo:#018x} to {hi:#018x}; every rank must submit "
            f"the same requests in the same order")
        for r in list(self._pending) + [r for r in self._slots
                                        if r is not None]:
            if not r.future.done():
                r.future.set_exception(err)
        self._pending.clear()
        raise err

    def step_boundary(self) -> int:
        """One admit -> ``sync_interval`` steps -> retire cycle.  Returns
        the number of slots served (0: nothing admissible)."""
        spec = self.spec_k > 0
        w0, a0 = self.spec_windows, self.spec_accepted
        self._admit_waiting()
        if self._tp_group is not None:
            self._check_replicas()
        live = [r for r in self._slots if r is not None]
        if not live:
            # an idle boundary restarts the utilization window: the wait
            # between submissions is not the next boundary's
            self._util_t_last = time.perf_counter()
            if self._pending:   # pragma: no cover - defensive
                # submit() guarantees every queued request fits an empty
                # pool; fail the futures loudly rather than drop them
                for req in self._pending:
                    req.future.set_exception(RuntimeError(
                        "decoder stalled with no admissible request"))
                self._pending.clear()
            return 0
        self.live_hwm = max(self.live_hwm, len(live))
        self._m_slots.set(len(live))
        self._m_slots_hwm.set(self.live_hwm)
        self._set_lanes(live)
        has_stop = self._lanes[3]
        # the cycle's steps read no page past their rows' reach: a row
        # advances at most k+1 positions a step, so the table passed is as
        # wide as those pages (its shared head pages among them), and the
        # attention's split walk follows the contexts served, not the
        # n_pos reservation
        reach = (self.spec_k + 1) * self.sync_interval
        width = max(_pages_needed(min(r.pos + reach,
                                      len(r.pages) * self.page_size),
                                  self.page_size) for r in live)
        self._ptab_live = self._ptab[:, :width].contiguous()
        step = self._run_spec_step if spec else self._run_step
        if self._m_util is not None:
            # the step's flops, counted on its first run of this shape:
            # the utilization gauge's numerator (none without a peak)
            key = (self._step_fn_key, self.B, self.spec_k,
                   self.draft_layers, self.kv_quant, self._lanes)
            obs_ledger.get().counted(self._step_fn_key, key, step)
        else:
            step()
        for _ in range(self.sync_interval - 1):
            step()
        self._m_steps.inc(self.sync_interval)
        pos_host = fin_host = None
        if spec or has_stop:
            # positions (and stop flags, and the acceptance counts) in one
            # read: completion is data-dependent here
            parts = [self._pos.long(), self._finished.long()]
            if spec:
                parts.append(self._acc_hist)
            got = torch.cat(parts).cpu().numpy()
            self._m_syncs.inc()
            pos_host, fin_host = got[:self.B], got[self.B:2 * self.B]
            if spec:
                self._drain_accept_hist(got[2 * self.B:])
            for r in live:
                r.pos = int(pos_host[r.slot])
        else:
            # no read: each row advanced one position a step, to its cap
            for r in live:
                r.pos = min(r.pos + self.sync_interval,
                            len(r.pages) * self.page_size)
        done = [r for r in live if r.pos >= r.steps_needed
                or (fin_host is not None and bool(fin_host[r.slot]))]
        # one slab read a boundary, shared by streaming and retirement
        streaming = [r for r in live if r.future.streaming]
        gen_host = None
        if done or streaming:
            gen_host = self._gen.cpu().numpy()
            if pos_host is None:
                self._m_syncs.inc()
        ts = time.perf_counter()
        delivered = False
        for r in streaming:
            delivered |= self._feed_stream(r, gen_host, r.pos, ts)
        for r in done:
            s = len(r.seed)
            # a stop-retired row froze early: it ends just past the match
            # (a normal row's overshoot is cut back to n_words)
            n_gen = max(1, min(r.n_words, r.pos - (s - 1)))
            row = r.seed + [int(t) for t in
                            gen_host[r.slot, s - 1:s - 1 + n_gen]]
            if n_gen < r.n_words:
                r.stop_retired = True
                saved = r.steps_needed - r.pos
                self._m_stop_retired.inc()
                self._m_steps_saved.inc(saved)
            if r.trace is not None:
                # the committed row, from the boundary's one slab read
                obs_recorder.note(r.trace.trace_id, tokens=row)
                if r.stop_retired:
                    obs_recorder.note(r.trace.trace_id, stop_retired=True)
                if self.spec_k:
                    obs_recorder.note(r.trace.trace_id,
                                      spec_windows=self.spec_windows,
                                      spec_accepted=self.spec_accepted)
            # retire before resolving: a client woken by the future must
            # see the slot free
            self._retire_req(r)
            if r.future.streaming:
                # the catch-up to the row's final length, the stream's
                # epilogue, then the resolution, through the delivery
                # FIFO: the last chunk lands before result() returns
                delivered |= self._feed_stream(
                    r, gen_host, min(r.pos, r.steps_needed), ts)
                self._finish_stream(r, ts)
                self._ensure_delivery().resolve(r.future, row)
            else:
                r.future.set_result(row)
        if done:
            self._m_slots.set(sum(1 for r in self._slots if r is not None))
        if delivered:
            self.stream_boundaries += 1
        if spec:
            # a window commits its accepted drafts and the verify token
            tokens = ((self.spec_windows - w0)
                      + (self.spec_accepted - a0))
        else:
            tokens = len(live) * self.sync_interval
        self._note_util(tokens)
        return len(live)

    def _note_util(self, tokens: int):
        """``decode_tokens_per_s`` and ``decode_model_flops_util``, set
        once a sync boundary (never a token or a step): the window runs
        from boundary entry to boundary entry, so queued device work
        spreads over boundaries without a read of its own."""
        now = time.perf_counter()
        wall, self._util_t_last = now - self._util_t_last, now
        if wall <= 0:
            return
        self._m_toks.set(tokens / wall)
        flops = obs_ledger.get().flops_for(self._step_fn_key)
        if flops and self._m_util is not None:
            self._m_util.set(flops * self.sync_interval
                             / (wall * self._peak_flops))

    def _drain_accept_hist(self, counts):
        """Fold the device-accumulated acceptance counts, read with the
        boundary's positions, into the host histogram."""
        delta = counts - self.accept_counts
        self.accept_counts = counts.astype(np.int64)
        self.spec_windows += int(delta.sum())
        self.spec_accepted += int((delta * np.arange(len(delta))).sum())
        for a, n in enumerate(delta):
            if int(n) > 0:
                self._m_accept.observe_n(float(a), int(n))

    # -- streaming delivery -------------------------------------------------
    def _ensure_delivery(self) -> TokenDelivery:
        if self._delivery is None:
            self._delivery = TokenDelivery(name=self.name)
            self._delivery_box.append(self._delivery)
        return self._delivery

    def _feed_stream(self, req, gen_host, consumed: int, ts: float) -> bool:
        """Deliver the tokens this boundary made visible for one streaming
        request, from the boundary's slab read; the consumer callbacks
        run on the delivery thread.  Returns whether anything new was
        delivered."""
        s = len(req.seed)
        avail = min(int(consumed), req.steps_needed) - (s - 1)
        if avail <= req.streamed:
            return False
        toks = [int(t) for t in
                gen_host[req.slot, s - 1 + req.streamed:s - 1 + avail]]
        new = avail - req.streamed
        start, req.streamed = req.streamed, avail
        if req.first_ts is None:
            req.first_ts = ts
            self._m_ttft.observe(ts - req.t_submit)
            if req.trace is not None:
                req.trace.stamp("first_token", ts)
        else:
            # n tokens landing dt after the previous delivery are n
            # observations of dt / n (the first boundary's are TTFT's)
            gap = ts - req.last_ts
            if gap > 0:
                self._m_itl.observe_n(gap / new, new)
        req.last_ts = ts
        req.timeline.append((ts, new))
        self._m_stream_toks.inc(len(toks))
        self._ensure_delivery().enqueue(req.future, toks, start, ts)
        return True

    def _finish_stream(self, req, ts: float):
        """A streamed request's epilogue at retire: the ``retire`` hop and
        one ``serve`` event of kind ``stream`` with its token timeline
        (ms since submit, tokens a boundary)."""
        if req.trace is not None:
            req.trace.stamp("retire", ts)
        if req.first_ts is None:   # pragma: no cover - n_words >= 1
            return
        rel = req.t_submit
        obs_events.emit(
            "serve", kind="stream", request=f"{self.name}/{req.rid}",
            decoder=self.name, tokens=req.streamed, n_seed=len(req.seed),
            admit_ms=(None if req.t_admit is None
                      else round((req.t_admit - rel) * 1e3, 3)),
            ttft_ms=round((req.first_ts - rel) * 1e3, 3),
            retire_ms=round((ts - rel) * 1e3, 3),
            boundaries=len(req.timeline),
            timeline=[[round((t - rel) * 1e3, 3), n]
                      for t, n in req.timeline])

    def run(self) -> "ContinuousDecoder":
        """Drive the decoder until every submitted request has retired (a
        streaming request's future resolves on the delivery thread right
        after its last chunk)."""
        while self._pending or any(r is not None for r in self._slots):
            if self.step_boundary() == 0:
                break
        self.emit_decode_event()
        return self

    def emit_decode_event(self):
        """The decoder's ``serve`` event of kind ``decode`` (``run`` emits
        one a drain), the JAX event's fields."""
        ps = self._pool.stats()
        extra = dict(paged=True, page_size=self.page_size,
                     pages=ps["pages"], pages_hwm=ps["in_use_hwm"],
                     live_hwm=self.live_hwm)
        if self._prefix is not None:
            pf = self._prefix.stats()
            extra.update(prefix_hits=pf["hits"], prefix_misses=pf["misses"],
                         prefix_pages=pf["pages_reused"])
        if self.kv_quant != "off":
            extra.update(kv_quant=self.kv_quant,
                         kv_bytes_per_token=self.kv_bytes_per_token)
        if self.spec_k:
            extra.update(spec_k=self.spec_k, spec_windows=self.spec_windows,
                         accept_mean=(self.spec_accepted
                                      / max(1, self.spec_windows)))
        if self.sampled:
            extra.update(sampled=self.sampled,
                         greedy=self.admitted - self.sampled)
        if self.stop_retired:
            extra.update(stop_retired=self.stop_retired,
                         steps_saved=self.steps_saved)
        if self.streams:
            # required where a decode event reports streaming (schema v4)
            extra.update(streaming=True, streams=self.streams,
                         stream_tokens=self.stream_tokens,
                         stream_boundaries=self.stream_boundaries,
                         first_token_ms=self._ttft_mean_ms())
        obs_events.emit("serve", kind="decode", decoder=self.name,
                        steps=self.steps, host_syncs=self.host_syncs,
                        admitted=self.admitted, retired=self.retired,
                        slots=self.B, **extra)
        return self

    def _ttft_mean_ms(self):
        _, total, n = self._m_ttft.state()
        return total / n * 1e3 if n else None

    def close(self):
        """Stop the delivery thread (after everything queued on it),
        release the prefix cache's pages and drop this decoder's series
        from the metrics registry.  Idempotent."""
        if self._delivery is not None:
            self._delivery.close()
            self._delivery_box.clear()
            self._delivery = None
        if self._prefix is not None:
            self._prefix.drop_all()
        self._finalize()

    def stats(self) -> dict:
        """The decoder's counts, from its registry series."""
        out = {"steps": self.steps, "host_syncs": self.host_syncs,
               "admitted": self.admitted, "retired": self.retired,
               "slots": self.B, "live_hwm": self.live_hwm,
               "n_pos": self.n_pos, "sync_interval": self.sync_interval,
               "tp": self.tp,
               "kv_quant": self.kv_quant,
               "kv_bytes_per_token": self.kv_bytes_per_token,
               "name": self.name,
               "sampled": self.sampled, "stop_retired": self.stop_retired,
               "steps_saved": self.steps_saved,
               "pool": self._pool.stats()}
        if self._prefix is not None:
            out["prefix"] = self._prefix.stats()
        if self.tp > 1:
            out["tp_checks"] = self.tp_checks
        ttft_counts, _, n_ttft = self._m_ttft.state()
        if n_ttft:
            out["stream"] = {
                "streams": n_ttft, "tokens": self.stream_tokens,
                "boundaries": self.stream_boundaries,
                "ttft_mean_ms": self._ttft_mean_ms(),
                "ttft_p50_ms": obs_metrics.quantile(
                    self._m_ttft.bounds, ttft_counts, 50) * 1e3}
        if self.spec_k:
            total = int(self.accept_counts.sum())
            out.update(
                spec_k=self.spec_k, draft_layers=self.draft_layers,
                spec_windows=self.spec_windows,
                spec_accepted=self.spec_accepted,
                accept_hist=[int(c) for c in self.accept_counts],
                accept_p50=(int(np.searchsorted(
                    np.cumsum(self.accept_counts), (total + 1) // 2))
                    if total else None),
                accept_mean=self.spec_accepted / max(1, self.spec_windows))
        return out


def continuous_decode(model, seed_rows, n_words, max_slots: int = 4,
                      n_pos: int | None = None,
                      sync_interval: int | None = None, device="cuda",
                      sampling=None, mesh=None, **decoder_kwargs):
    """One-shot: decode every seed row with a shared decoder.  ``n_pos``
    defaults to the largest request's need; ``sampling`` is None (greedy),
    one ``SamplingParams`` (or its dict) for every row, or a list of one
    per row; ``mesh`` (with a ``model`` axis) serves tensor parallel,
    every rank of it calling this alike; other keyword arguments
    (``page_size``, ``n_pages``, ``prefix_cache``, ``spec_k``,
    ``draft_layers``, ``kv_quant``, ...) pass through to
    :class:`ContinuousDecoder`.  Returns the extended rows in submission
    order (``lm_decode`` greedy semantics per greedy row)."""
    reqs = [np.asarray(s, np.int64) for s in seed_rows]
    per_row = (list(sampling) if isinstance(sampling, (list, tuple))
               else [sampling] * len(reqs))
    if len(per_row) != len(reqs):
        raise ValueError(f"sampling has {len(per_row)} entries for "
                         f"{len(reqs)} seed rows")
    if n_pos is None:
        n_pos = max(int(s.size) + int(n_words) - 1 for s in reqs)
    dec = ContinuousDecoder(model, max_slots=max_slots, n_pos=n_pos,
                            sync_interval=sync_interval, device=device,
                            mesh=mesh, **decoder_kwargs)
    try:
        futs = [dec.submit(s, n_words, sampling=sp)
                for s, sp in zip(reqs, per_row)]
        dec.run()
        return [f.result() for f in futs]
    finally:
        dec.close()
