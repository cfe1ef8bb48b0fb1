"""Streaming decode futures: incremental per-token delivery with
callback safety (counterpart of bigdl_tpu/serve/streaming.py).

:class:`StreamFuture` is the decoder's future grown a stream:

- :meth:`StreamFuture.on_tokens` registers an incremental consumer fed
  at each sync boundary (the decoder reads its token slab there anyway,
  so delivery adds no device sync and never happens per token);
- chunks carry an absolute **start index**, so a re-delivered stream is
  deduplicated: consumers see every token exactly once, byte-identical
  to the all-at-once result, and a gap raises;
- consumer callbacks run on a dedicated delivery thread
  (:class:`TokenDelivery`), never the decode step loop, so a slow or
  raising consumer cannot stall the device;
- a raising consumer (``on_tokens`` or ``add_done_callback``) fails only
  its own registration: it is dropped with a logged warning and an obs
  ``serve`` event of kind ``error``, and the stream, its future and the
  delivery thread keep running (:class:`SafeFuture` is the
  ``add_done_callback`` half).

Do not block inside an
``on_tokens`` callback on the same future's ``result()``: the result is
resolved on the delivery thread the callback occupies.

Under tensor parallelism (``ContinuousDecoder(mesh=)``) every rank of the
model axis runs its own decoder, futures and delivery thread, and every
rank's stream carries the same tokens at the same boundaries.  The
caller picks the rank that answers a client (rank 0 in the smoke and the
tests) and leaves the other ranks' streams unconsumed or for checks.
"""
from __future__ import annotations

import logging
import queue
import threading
import time
from concurrent.futures import Future

logger = logging.getLogger("bigdl_tpu_torch.serve")


def _consumer_error(where: str, exc: BaseException):
    """One warning and one obs ``serve`` error event per raising user
    callback: the callback is the failure, never the stream machinery
    around it."""
    logger.warning("serve %s callback raised: %s: %s", where,
                   type(exc).__name__, exc)
    try:
        from bigdl_tpu_torch.obs import events
        events.emit("serve", kind="error",
                    error=f"{type(exc).__name__}: {exc}", callback=where)
    except Exception:  # pragma: no cover - telemetry must not mask
        pass


class SafeFuture(Future):
    """A Future whose user callbacks can never kill the resolving thread:
    every ``add_done_callback`` call -- at set-time on the delivery
    thread, or inline when the future is already done -- is guarded, and
    a raise (``BaseException`` included) is logged and lands in the event
    stream instead of propagating."""

    def add_done_callback(self, fn):
        # CPython's implementation, so the already-done inline call raises
        # into this guard
        with self._condition:
            if self._state not in ("CANCELLED", "CANCELLED_AND_NOTIFIED",
                                   "FINISHED"):
                self._done_callbacks.append(fn)
                return
        try:
            fn(self)
        except BaseException as e:
            _consumer_error("done_callback", e)

    def _invoke_callbacks(self):
        callbacks, self._done_callbacks = self._done_callbacks, []
        for fn in callbacks:
            try:
                fn(self)
            except BaseException as e:
                _consumer_error("done_callback", e)


class StreamFuture(SafeFuture):
    """A decode future that can ALSO deliver its generated tokens
    incrementally.

    Producers call :meth:`feed` with each boundary's new tokens and the
    chunk's absolute start index; consumers register with
    :meth:`on_tokens` (``cb(tokens)``) and are replayed the backlog on
    registration, so a consumer attached after the first boundary still
    sees every token once.  :meth:`pipe_to` chains futures, keeping the
    start-index dedup.  ``streaming`` tells the producer to deliver per
    boundary: true once a consumer is registered or after
    :meth:`request_stream`.  The future resolves with the full token row
    either way."""

    def __init__(self):
        super().__init__()
        self._slock = threading.Lock()
        self._stream_tokens: list = []
        #: consumer entries [cb, indexed, sent, draining]: ``sent`` is how
        #: many tokens this consumer has been handed, ``draining`` marks
        #: the one thread delivering to it
        self._consumers: list = []
        self._want_stream = False
        self.t_create = time.perf_counter()
        self.t_first_token: float | None = None
        self.stream_chunks = 0

    # -- consumer side ------------------------------------------------------
    @property
    def streaming(self) -> bool:
        # lock-free: the step loop polls this per live request per
        # boundary and must never wait behind a consumer callback
        return self._want_stream or bool(self._consumers)

    def request_stream(self) -> "StreamFuture":
        """Ask for per-boundary delivery before any consumer is attached
        (chunks buffer and replay)."""
        with self._slock:
            self._want_stream = True
        return self

    def on_tokens(self, cb) -> "StreamFuture":
        """Register ``cb(tokens)`` for every delivered chunk, after the
        backlog already delivered.  A raising ``cb`` is dropped: it fails
        only its own registration."""
        return self._register(cb, indexed=False)

    def on_tokens_indexed(self, cb) -> "StreamFuture":
        """Like :meth:`on_tokens` but ``cb(tokens, start)``, the chunk's
        absolute index in the generated stream."""
        return self._register(cb, indexed=True)

    def _register(self, cb, indexed: bool):
        entry = [cb, indexed, 0, False]
        with self._slock:
            self._consumers.append(entry)
        self._drain(entry)          # replay any backlog (outside lock)
        return self

    def pipe_to(self, dst: "StreamFuture") -> "StreamFuture":
        """Forward every chunk into ``dst``, index-preserving."""
        dst.request_stream()
        return self.on_tokens_indexed(dst.feed)

    # -- producer side ------------------------------------------------------
    def feed(self, tokens, start: int | None = None,
             ts: float | None = None) -> int:
        """Deliver a chunk whose first token is index ``start`` of the
        generated stream (``None``: the current end).  Overlap already
        delivered is trimmed; a chunk past the end raises ``ValueError``.
        Returns the number of new tokens.  Callbacks run outside the
        stream lock."""
        tokens = [int(t) for t in tokens]
        with self._slock:
            n = len(self._stream_tokens)
            if start is None:
                start = n
            if start > n:   # a gap would silently corrupt the stream
                raise ValueError(
                    f"stream chunk starts at {start} but only {n} "
                    f"tokens were delivered")
            tokens = tokens[n - start:]
            if not tokens:
                return 0
            if self.t_first_token is None:
                self.t_first_token = (time.perf_counter() if ts is None
                                      else float(ts))
            self.stream_chunks += 1
            self._stream_tokens.extend(tokens)
            consumers = list(self._consumers)
        for entry in consumers:
            self._drain(entry)
        return len(tokens)

    def _drain(self, entry):
        """Hand ``entry`` everything past its ``sent`` mark, one drainer
        at a time per consumer, callbacks outside the lock.  The empty
        check and the flag clear share one lock hold, so a chunk fed
        during the last iteration lands in this loop or finds the flag
        clear and drains itself."""
        cb, indexed = entry[0], entry[1]
        with self._slock:
            if entry[3] or entry not in self._consumers:
                return              # another thread is delivering
            entry[3] = True
        while True:
            with self._slock:
                sent = entry[2]
                pending = list(self._stream_tokens[sent:])
                if not pending:
                    entry[3] = False
                    return
                entry[2] = sent + len(pending)
            try:
                if indexed:
                    cb(pending, sent)
                else:
                    cb(pending)
            except BaseException as e:
                # drop ONLY this registration, so one broken consumer
                # cannot re-raise on every later boundary
                with self._slock:
                    if entry in self._consumers:
                        self._consumers.remove(entry)
                    entry[3] = False
                _consumer_error("on_tokens", e)
                return

    # -- introspection ------------------------------------------------------
    def tokens_streamed(self) -> int:
        with self._slock:
            return len(self._stream_tokens)

    def streamed(self) -> list:
        """Every token delivered so far (a copy, in order)."""
        with self._slock:
            return list(self._stream_tokens)

    @property
    def ttft_s(self) -> float | None:
        """Seconds from this future's creation to its first streamed
        token (None until the first chunk lands)."""
        t = self.t_first_token
        return None if t is None else t - self.t_create


class TokenDelivery:
    """The decoder's delivery thread: a FIFO of chunk feeds and final
    resolutions, so user callbacks (and ``set_result``'s done-callbacks
    for streaming futures) run here and the step loop never waits on a
    consumer.  FIFO order delivers a stream's last chunk before its
    future resolves."""

    def __init__(self, name: str = "stream"):
        self._q: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"bigdl-torch-serve-{name}-delivery")
        self._thread.start()

    def enqueue(self, fut: StreamFuture, tokens, start: int, ts: float):
        self._q.put(("feed", fut, tokens, start, ts))

    def resolve(self, fut: Future, value):
        self._q.put(("result", fut, value, None, None))

    def _loop(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            try:
                if item[0] == "feed":
                    _, fut, tokens, start, ts = item
                    fut.feed(tokens, start=start, ts=ts)
                else:
                    fut = item[1]
                    if not fut.done():
                        fut.set_result(item[2])
            except BaseException as e:  # pragma: no cover - defensive
                logger.warning("token delivery failed: %s: %s",
                               type(e).__name__, e)

    def close(self, timeout: float = 10.0):
        """Drain everything already queued, then stop (the sentinel lands
        after every pending chunk and resolution)."""
        self._q.put(None)
        self._thread.join(timeout=timeout)
