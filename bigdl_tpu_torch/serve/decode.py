"""Continuous-batching greedy decode over a paged KV pool (counterpart of
bigdl_tpu/serve/decode.py, restricted to this slice).

The rows of a fixed-width device batch are **slots**: each consumes its
own seed and generates its own continuation at its own position.
Requests are admitted into free slots and retired at step boundaries
only; the host reads the device every ``sync_interval`` steps at most —
once per boundary that retires a request, to fetch the generated-token
slab.  Positions, previous tokens and generated tokens stay on the
device between boundaries and feed back there.

KV storage is a block-paged pool (``models.transformer.new_pools``): a
request holds only the ``ceil(steps / page_size)`` pages its own length
needs, and a per-slot slot->page table on the device maps its positions
to pool pages.  Attention over the pool is ``ops.paged_attention``, the
hand-written CUDA kernel on the card.

``kv_quant="int8"`` (default from ``BIGDL_SERVE_KV_QUANT``) stores the
pool's K and V in int8 with per-page-row, per-head scales
(``quant/kv.py``), about a quarter of the fp32 pool's bytes; the page
walk is then the kernel's int8 variant, ``ops.paged_attention_int8``.

Not in this slice (each is listed in ROADMAP.md): the prefix cache,
speculative decode, tensor parallelism, the host KV tier, streaming
delivery, sampled decode, stop sequences, the flight recorder and the
metrics registry.
"""
from __future__ import annotations

from collections import deque
from concurrent.futures import Future

import numpy as np
import torch

from bigdl_tpu_torch.models.transformer import (DEFAULT_PAGE_SIZE,
                                                _handles_to, _lm_forward_one,
                                                _lm_handles, new_pools)
from bigdl_tpu_torch.quant import kv_mode_default, normalize_mode
from bigdl_tpu_torch.quant import kv as kvq
from bigdl_tpu_torch.serve.paging import PagePool, RequestTooLongError
from bigdl_tpu_torch.utils.device import pin_fp32, resolve_device

DEFAULT_SYNC = 8


def _pages_needed(steps: int, page_size: int) -> int:
    """Pages a request's full lifetime reserves: ``ceil(steps /
    page_size)``.  The one spot for the reservation math, shared by
    ``submit``'s too-long check and admission."""
    return -(-steps // page_size)


def _temperature(sampling) -> float:
    if sampling is None:
        return 0.0
    if isinstance(sampling, dict):
        return float(sampling.get("temperature", 0.0) or 0.0)
    return float(getattr(sampling, "temperature", 0.0) or 0.0)


class _DecodeReq:
    __slots__ = ("seed", "n_words", "future", "slot", "steps_needed",
                 "steps_run", "start_pos", "pages")

    def __init__(self, seed, n_words):
        self.seed = [int(t) for t in seed]
        self.n_words = int(n_words)
        self.future = Future()
        self.slot = None
        # positions fed through = n_seed + n_words - 1 (lm_decode's n_pos)
        self.steps_needed = len(self.seed) + self.n_words - 1
        self.steps_run = 0
        self.start_pos = 0
        self.pages = []          # pool page ids, logical order


class ContinuousDecoder:
    """Continuous-batching greedy decoder for one ``TransformerLM``.

    ``max_slots`` is the device batch width B; ``n_pos`` the per-request
    position capacity — a request needs ``len(seed) + n_words - 1 <=
    n_pos``, and one that does not fit fails ITS OWN future with
    :class:`RequestTooLongError`.  The pool holds ``n_pages`` pages of
    ``page_size`` tokens (default: ``ceil(n_pos / page_size) *
    max_slots``).  :meth:`submit` queues a request and returns a future
    of the full token row (seed included, ``lm_decode``'s output);
    :meth:`run` drives the slots until every request has resolved.

    ``kv_quant`` is ``"off"`` (fp32 pools) or ``"int8"``; ``None`` reads
    ``BIGDL_SERVE_KV_QUANT`` (default off), and an unknown mode raises
    ``ValueError`` naming it.

    ``device`` defaults to ``"cuda"`` and raises when there is no card;
    the weights are used on that device (moved there once if the model
    lives elsewhere)."""

    def __init__(self, model, max_slots: int = 4, n_pos: int = 64,
                 sync_interval: int | None = None,
                 page_size: int | None = None, n_pages: int | None = None,
                 kv_quant: str | None = None, device="cuda"):
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
        self._pool = PagePool(int(n_pages), ps)
        self._n_view = n_view = self.pages_per_slot * ps
        self._handles = _handles_to(_lm_handles(model), dev)
        self._pe = self._handles.mods[1].table(n_view).to(dev)
        self._caches = new_pools(self._handles, self._pool.n_pages, ps, dev,
                                 self.kv_quant)
        self.kv_bytes_per_token = kvq.bytes_per_token(
            self._handles.n_layers, self._handles.n_heads, self._handles.hd,
            self.kv_quant)

        def z(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self._rows = torch.arange(B, device=dev)
        self._pos = z(B)
        self._prev = z(B)
        self._active = z(B, dtype=torch.bool)
        self._seeds = z(B, n_view)
        self._seed_len = z(B)
        self._gen = z(B, n_view)
        self._ptab = z(B, self.pages_per_slot)
        self._ptab_live = self._ptab     # the columns a cycle reads
        # a never-admitted slot clips to position -1 (it wraps in every
        # index and is never live); admission sets the real capacity
        self._cap = z(B)

        self._pending: "deque[_DecodeReq]" = deque()
        self._slots: list = [None] * B
        self.steps = 0
        self.host_syncs = 0
        self.admitted = 0
        self.retired = 0
        self.live_hwm = 0

    # -- the device step ------------------------------------------------------
    @torch.no_grad()
    def _run_step(self):
        """One position for every slot (decode.py ``paged_step_body``):
        parked and finished slots neither advance nor write, and their
        attention reads no page."""
        rows = self._rows
        live = self._active & (self._pos < self._cap)
        wp = torch.minimum(self._pos.clamp(min=0), self._cap - 1)
        tok = torch.where(self._pos < self._seed_len,
                          self._seeds[rows, wp], self._prev)
        logp, self._caches = _lm_forward_one(
            tok, wp, self._caches, self._handles, self._pe,
            (self._ptab_live, self.page_size), valid=live)
        nxt = logp.argmax(dim=-1).to(torch.int32)
        # rows are distinct, so a masked read-modify-write is exact here
        self._gen[rows, wp] = torch.where(live, nxt, self._gen[rows, wp])
        self._prev = torch.where(live, nxt, self._prev)
        self._pos = torch.where(live, self._pos + 1, self._pos)

    def _apply_admit(self, slot: int, req: _DecodeReq):
        """Load one request's state into ``slot`` (decode.py ``admit``):
        one host->device copy of a packed row, then device-side writes."""
        P, n_view = self.pages_per_slot, self._n_view
        pack = np.zeros(3 + P + n_view, np.int32)
        pack[:3] = (req.start_pos, len(req.seed),
                    len(req.pages) * self.page_size)
        pack[3:3 + len(req.pages)] = req.pages
        pack[3 + P:3 + P + len(req.seed)] = req.seed
        row = torch.from_numpy(pack).to(self.device)
        self._pos[slot] = row[0]
        self._seed_len[slot] = row[1]
        self._cap[slot] = row[2]
        self._ptab[slot] = row[3:3 + P]
        self._seeds[slot] = row[3 + P:]
        self._active[slot] = True
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
    def submit(self, seed_ids, n_words: int, sampling=None) -> Future:
        """Queue one request; the future resolves to the full token row
        (seed + ``n_words`` generated ids), ``lm_decode``'s greedy output
        for the same seed.  A request that can never fit fails only its
        own future with :class:`RequestTooLongError`.  ``sampling`` with
        ``temperature > 0`` raises: sampled decode comes with the
        sampled-decode slice."""
        if _temperature(sampling) > 0:
            raise NotImplementedError(
                "sampled decode (temperature > 0) comes with the "
                "sampled-decode slice of the port; this decoder is greedy")
        seed = np.asarray(seed_ids, np.int64)
        if seed.ndim != 1 or seed.size == 0:
            raise ValueError("seed_ids must be one flat non-empty id row")
        if n_words < 1:
            raise ValueError("n_words must be >= 1")
        req = _DecodeReq(seed.tolist(), n_words)
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
    def _admit_waiting(self):
        for slot in range(self.B):
            if self._slots[slot] is not None or not self._pending:
                continue
            req = self._pending[0]
            need = _pages_needed(req.steps_needed, self.page_size)
            if need > self._pool.free_count:
                break   # head-of-line: wait for retirements to free pages
            self._pending.popleft()
            req.pages = [self._pool.alloc_one() for _ in range(need)]
            req.slot = slot
            self._apply_admit(slot, req)
            self._slots[slot] = req
            self.admitted += 1

    def _retire_req(self, req: _DecodeReq):
        self._apply_retire(req.slot)
        for pid in req.pages:
            self._pool.release(pid)
        self._slots[req.slot] = None
        self.retired += 1

    def step_boundary(self) -> int:
        """One admit -> ``sync_interval`` steps -> retire cycle.  Returns
        the number of slots served (0: nothing admissible)."""
        self._admit_waiting()
        live = [r for r in self._slots if r is not None]
        if not live:
            if self._pending:   # pragma: no cover - defensive
                # submit() guarantees every queued request fits an empty
                # pool; fail the futures loudly rather than drop them
                for req in self._pending:
                    req.future.set_exception(RuntimeError(
                        "decoder stalled with no admissible request"))
                self._pending.clear()
            return 0
        self.live_hwm = max(self.live_hwm, len(live))
        # the cycle's steps read no page past their rows' positions: the
        # table it passes is as wide as those pages, so the attention's
        # split walk follows the contexts served, not the n_pos reservation
        width = max(_pages_needed(min(r.start_pos + r.steps_run
                                      + self.sync_interval, r.steps_needed),
                                  self.page_size) for r in live)
        self._ptab_live = self._ptab[:, :width].contiguous()
        for _ in range(self.sync_interval):
            self._run_step()
        self.steps += self.sync_interval
        for r in live:
            r.steps_run += self.sync_interval
        done = [r for r in live
                if r.start_pos + r.steps_run >= r.steps_needed]
        if done:
            gen_host = self._gen.cpu().numpy()   # the boundary host sync
            self.host_syncs += 1
            for r in done:
                s = len(r.seed)
                row = r.seed + [int(t) for t in
                                gen_host[r.slot, s - 1:s - 1 + r.n_words]]
                # retire before resolving: a client woken by the future
                # must see the slot free
                self._retire_req(r)
                r.future.set_result(row)
        return len(live)

    def run(self) -> "ContinuousDecoder":
        """Drive the decoder until every submitted request has resolved."""
        while self._pending or any(r is not None for r in self._slots):
            if self.step_boundary() == 0:
                break
        return self

    def stats(self) -> dict:
        return {"steps": self.steps, "host_syncs": self.host_syncs,
                "admitted": self.admitted, "retired": self.retired,
                "slots": self.B, "live_hwm": self.live_hwm,
                "n_pos": self.n_pos, "sync_interval": self.sync_interval,
                "kv_quant": self.kv_quant,
                "kv_bytes_per_token": self.kv_bytes_per_token,
                "pool": self._pool.stats()}


def continuous_decode(model, seed_rows, n_words, max_slots: int = 4,
                      n_pos: int | None = None,
                      sync_interval: int | None = None, device="cuda",
                      **decoder_kwargs):
    """One-shot: decode every seed row with a shared decoder.  ``n_pos``
    defaults to the largest request's need; other keyword arguments
    (``page_size``, ``n_pages``, ``kv_quant``) pass through to
    :class:`ContinuousDecoder`.  Returns the extended rows in submission
    order (``lm_decode`` greedy semantics per row)."""
    reqs = [np.asarray(s, np.int64) for s in seed_rows]
    if n_pos is None:
        n_pos = max(int(s.size) + int(n_words) - 1 for s in reqs)
    dec = ContinuousDecoder(model, max_slots=max_slots, n_pos=n_pos,
                            sync_interval=sync_interval, device=device,
                            **decoder_kwargs)
    futs = [dec.submit(s, n_words) for s in reqs]
    dec.run()
    return [f.result() for f in futs]
