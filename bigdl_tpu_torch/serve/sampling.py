"""Sampling for serving and offline decode (counterpart of
bigdl_tpu/serve/sampling.py).

One sampler for both decode paths: ``models.transformer.lm_decode`` and
the served :class:`~bigdl_tpu_torch.serve.decode.ContinuousDecoder` step
call the same :func:`filter_logits` / :func:`sample_tokens`, so the two
cannot drift.  Every parameter is either a Python scalar (``lm_decode``'s
keyword arguments) or a per-row (B,) tensor (the served step: each slot
carries its request's temperature, top-k, top-p and key as data, so a
batch mixing greedy and any number of sampling configurations runs one
step).

**Keys (the replay contract).**  A request's draws are a pure function
of its own seed, the generated-token index and a tag: the subkey of one
draw is ``fold_in_rows(key, DRAW_TAGS * gen_index + tag)`` -- never of
the slot, the batch companions, a prefix hit's start position or the
sync cadence.  The tags separate the draws one generated position may
consume:

====================  ====================================================
``TAG_MAIN``          the non-speculative per-step draw
``TAG_DRAFT``         speculative draft proposal at this position
``TAG_ACCEPT``        the accept/reject uniform for that proposal
``TAG_FIX``           the residual (rejection) / bonus (all-accepted) draw
====================  ====================================================

**The counter-based generator.**  PyTorch has no per-row ``fold_in``, and
one ``torch.Generator`` a row would tie the draws to call order and cost
host work, so the port hashes on the device: a key is two 32-bit words
held in int64 (the layout of the JAX key row), mixed with a 32-bit
avalanche function (``_mix32``, Wellons' lowbias32) whose products are
split into 16-bit halves so no intermediate leaves int64 (torch's uint32
arithmetic is incomplete on CUDA).  A categorical draw is Gumbel-max over
one hashed uniform per (key, vocabulary id): the form of
``jax.random.categorical``.  The streams are NOT bit-equal to JAX's
threefry streams; the distributions are, and the tests hold them by
chi-squared tests at fixed seeds.

**Lossless speculative sampling** (Leviathan et al.): accept the draft
token ``x`` with probability ``min(1, p(x)/q(x))`` -- evaluated
division-free as ``u * q(x) < p(x)`` -- and on rejection resample from
the normalised residual ``max(p - q, 0)`` (:func:`spec_residual`); the
committed marginal is exactly ``p``.  :func:`spec_accept_one` is the
single-position reference chain the decoder's speculative step
vectorises.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import torch

#: draw-stream tags: one generated position may consume up to
#: DRAW_TAGS independent subkeys (see the module docstring)
TAG_MAIN, TAG_DRAFT, TAG_ACCEPT, TAG_FIX = 0, 1, 2, 3
DRAW_TAGS = 4

_M32 = 0xFFFFFFFF
# distinct odd 32-bit constants that separate the hash's roles
_C_DATA, _C_MIX, _C_KEY, _C_CTR = 0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35, \
    0x27D4EB2F


@dataclass(frozen=True)
class SamplingParams:
    """Per-request decode sampling recipe.

    ``temperature <= 0`` is greedy (argmax: byte-identical to the
    sampling-free decode stream); ``top_k``/``top_p`` truncate the scaled
    distribution (0 disables either; ``top_p`` in (0, 1)); ``seed`` pins
    the request's key (resolved to a fresh random seed at submit when
    left None on a sampled request, so a resubmission with the resolved
    params redraws the same stream).  ``stop`` is a tuple of token-id
    sequences: generation retires at the sync boundary after any of them
    is produced, the resolved row truncated just past the match.
    ``max_tokens`` caps ``n_words`` at submit when set."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 0.0
    seed: int | None = None
    stop: tuple = ()
    max_tokens: int | None = None

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError("temperature must be >= 0 (0 = greedy)")
        if self.top_k < 0:
            raise ValueError("top_k must be >= 0 (0 = off)")
        if not 0.0 <= self.top_p <= 1.0:
            raise ValueError("top_p must be in [0, 1] (0 or 1 = off)")
        if self.max_tokens is not None and self.max_tokens < 1:
            raise ValueError("max_tokens must be >= 1 when set")
        stop = tuple(tuple(int(t) for t in s) for s in (self.stop or ()))
        if any(len(s) == 0 for s in stop):
            raise ValueError("stop sequences must be non-empty")
        object.__setattr__(self, "stop", stop)

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0

    @property
    def is_default(self) -> bool:
        """True for the plain greedy request (nothing worth recording)."""
        return (self.greedy and not self.stop and not self.top_k
                and not self.top_p and self.max_tokens is None)

    @classmethod
    def of(cls, val) -> "SamplingParams":
        """Coerce ``None`` (greedy), a dict (``to_dict``'s form) or an
        instance."""
        if val is None:
            return GREEDY
        if isinstance(val, cls):
            return val
        if isinstance(val, dict):
            known = ("temperature", "top_k", "top_p", "seed", "stop",
                     "max_tokens")
            kw = {k: val[k] for k in known if val.get(k) is not None}
            if "stop" in kw:
                kw["stop"] = tuple(tuple(s) for s in kw["stop"])
            return cls(**kw)
        raise TypeError(
            f"sampling must be SamplingParams, dict or None, "
            f"got {type(val).__name__}")

    def resolved(self) -> "SamplingParams":
        """Pin the seed: a sampled request with ``seed=None`` gets a
        fresh random one here, once."""
        if self.greedy or self.seed is not None:
            return self
        seed = int.from_bytes(os.urandom(4), "big")
        return SamplingParams(self.temperature, self.top_k, self.top_p,
                              seed, self.stop, self.max_tokens)

    def to_dict(self) -> dict:
        """Plain-JSON form (``of`` round-trips it)."""
        return {"temperature": self.temperature, "top_k": self.top_k,
                "top_p": self.top_p, "seed": self.seed,
                "stop": [list(s) for s in self.stop],
                "max_tokens": self.max_tokens}


GREEDY = SamplingParams()


def key_words(seed) -> tuple:
    """The two 32-bit words of one request seed (high, low), the layout
    of the JAX key row, computed on the host."""
    s = int(seed or 0) & 0xFFFFFFFFFFFFFFFF
    return (s >> 32) & _M32, s & _M32


def key_data(seed, device="cpu") -> torch.Tensor:
    """The (2,) int64 key row of one request seed."""
    return torch.tensor(key_words(seed), dtype=torch.int64, device=device)


def _mul32(x, c: int):
    """``x * c mod 2**32`` for ``x`` in [0, 2**32) held in int64 and a
    32-bit constant ``c``: c split into 16-bit halves, so every product
    stays below 2**49."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    """lowbias32: a 32-bit avalanche mix of int64 lanes in [0, 2**32)
    (every shift is of a non-negative value, so logical)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def fold_in_rows(keys, data):
    """Per-row fold: ``(..., 2)`` int64 keys x ``(...)`` int data ->
    ``(..., 2)`` subkeys, each word depending on both key words and the
    data (the counterpart of ``jax.random.fold_in``)."""
    d = torch.as_tensor(data, device=keys.device).to(torch.int64) & _M32
    k0, k1 = keys[..., 0], keys[..., 1]
    a = _mix32(k0 ^ _mix32(d ^ _C_DATA))
    b = _mix32(k1 ^ _mix32(a ^ _C_MIX))
    c = _mix32(a ^ _mix32(b ^ _C_KEY))
    return torch.stack([b, c], dim=-1)


_COUNTERS: dict = {}


def _counters(n: int, device) -> torch.Tensor:
    """``_mix32`` of the counters 0 .. n-1 (key-independent, so made
    once per size and device)."""
    key = (n, str(device))
    t = _COUNTERS.get(key)
    if t is None:
        t = _mix32(torch.arange(n, dtype=torch.int64, device=device)
                   ^ _C_CTR)
        _COUNTERS[key] = t
    return t


def _unit(bits):
    """32 hashed bits -> a float32 uniform in (0, 1): the top 23 bits,
    centred in their cell, exact in float32 (24 bits would round the top
    cell's centre up to 1.0, whose Gumbel noise is infinite)."""
    return ((bits >> 9).to(torch.float32) + 0.5) * (1.0 / (1 << 23))


def _uniform(keys, counters):
    """One uniform in (0, 1) per (key row, counter)."""
    return _unit(_mix32(keys[..., 1:2] ^ _mix32(keys[..., 0:1] ^ counters)))


def uniform_rows(keys):
    """One uniform (0, 1) draw per ``(..., 2)`` key row."""
    return _uniform(keys, _counters(1, keys.device))[..., 0]


def categorical(keys, logits):
    """Gumbel-max draw of one index per row of ``logits`` (..., V) under
    ``keys`` (..., 2), one key a row (broadcast against the logits' rows),
    or one (2,) key for the whole array (each element its own counter).
    ``-inf`` logits are never drawn."""
    V = logits.shape[-1]
    if keys.dim() == 1:
        n = logits.numel()
        u = _uniform(keys, _counters(n, keys.device)).reshape(logits.shape)
    else:
        lead = torch.broadcast_shapes(keys.shape[:-1], logits.shape[:-1])
        keys = keys.expand(lead + (2,))
        u = _uniform(keys, _counters(V, keys.device))
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def _param(v, lp):
    """A scalar or ``(B,)`` parameter broadcast against ``(..., V)``
    logits: trailing singleton dims up to ``lp.dim()``."""
    t = torch.as_tensor(v, device=lp.device)
    return t.reshape(tuple(t.shape) + (1,) * (lp.dim() - t.dim()))


def _off(v, *, below: float) -> bool:
    """A Python scalar that disables its filter (nothing to compute)."""
    return not torch.is_tensor(v) and not 0 < v < below


def filter_logits(logp, temperature=1.0, top_k=0, top_p=0.0):
    """Temperature-scale, then top-k / top-p truncate log-probs.

    ``logp`` is ``(..., V)``; each parameter a scalar or a per-row
    tensor broadcast against the leading dims.  Rows with ``temperature
    <= 0`` pass through unscaled (the greedy lane takes the argmax);
    ``top_k`` keeps the k highest logits (0 or >= V disables; ties at the
    k-th value all survive); ``top_p`` keeps the smallest
    descending-probability prefix whose mass reaches p (0 or 1 disables;
    the top token always survives)."""
    V = logp.shape[-1]
    t = _param(temperature, logp).to(logp.dtype)
    lp = logp / torch.where(t > 0, t, torch.ones_like(t))
    neg = torch.tensor(float("-inf"), dtype=lp.dtype, device=lp.device)
    if not _off(top_k, below=V):
        kk = _param(top_k, logp).to(torch.int64)
        srt = torch.sort(lp, dim=-1).values
        idx = (V - kk).clamp(0, V - 1).expand(lp.shape[:-1] + (1,))
        kth = srt.gather(-1, idx)
        lp = torch.where((kk > 0) & (kk < V) & (lp < kth), neg, lp)
    if not _off(top_p, below=1.0):
        pp = _param(top_p, logp).to(logp.dtype)
        probs = torch.softmax(lp, dim=-1)
        sp = torch.sort(probs, dim=-1, descending=True).values
        cum = torch.cumsum(sp, dim=-1)
        keep = (cum - sp) < pp        # mass before this token still short
        inf = torch.tensor(float("inf"), dtype=lp.dtype, device=lp.device)
        thr = torch.where(keep, sp, inf).amin(dim=-1, keepdim=True)
        lp = torch.where((pp > 0) & (pp < 1) & (probs < thr), neg, lp)
    return lp


def sample_tokens(logits, keys, temperature=1.0, top_k=0, top_p=0.0):
    """One sampled token per row from filtered logits -- the sampler both
    decode paths call.  ``keys`` is one (2,) key for the whole batch or a
    ``(B, 2)`` per-row key array (the served step: each row draws from
    its own request-keyed stream)."""
    return categorical(keys, filter_logits(logits, temperature, top_k,
                                           top_p))


def spec_residual(p, q):
    """The rejection distribution ``max(p - q, 0)`` normalised, ``p``
    where the residual has no mass (draft == target)."""
    r = torch.clamp(p - q, min=0.0)
    z = r.sum(dim=-1, keepdim=True)
    return torch.where(z > 0, r / torch.where(z > 0, z, torch.ones_like(z)),
                       p)


def spec_accept_one(key, p_logits, q_logits):
    """Single-position reference of the lossless accept/reject chain
    (what the decoder's speculative step vectorises): draft ``x ~ q``,
    accept iff ``u * q(x) < p(x)``, else resample the residual.  ``key``
    is (2,) or a batch (N, 2) of keys against one (V,) pair of logits;
    the committed marginal is exactly ``softmax(p_logits)``."""
    n = torch.zeros(key.shape[:-1], dtype=torch.int64, device=key.device)
    kd, ka, kr = (fold_in_rows(key, n + i) for i in range(3))
    x = categorical(kd, q_logits)
    p = torch.softmax(p_logits, dim=-1)
    q = torch.softmax(q_logits, dim=-1)
    u = uniform_rows(ka)
    y = categorical(kr, torch.log(spec_residual(p, q)))
    return torch.where(u * q[x] < p[x], x, y)
