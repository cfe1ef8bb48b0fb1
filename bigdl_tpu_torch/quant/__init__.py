"""Quantized serving (counterpart of bigdl_tpu/quant/__init__.py, the KV
part): the mode knobs every quantized path resolves through.

:mod:`bigdl_tpu_torch.quant.kv` stores the paged decoder's K and V pages
in int8 with per-page-row, per-head scales; ``ContinuousDecoder(kv_quant=
"int8")`` or ``BIGDL_SERVE_KV_QUANT=int8`` selects it.  Weight
quantization (``BIGDL_SERVE_QUANT``, ``quant/weights.py`` and
``quant/calibrate.py`` of the JAX package) is not ported yet.
"""
from __future__ import annotations

import os

#: KV-page quantization mode for the paged decoder: off | int8
ENV_KV_QUANT = "BIGDL_SERVE_KV_QUANT"

#: greedy-decode drift budget for int8 KV pages: the fraction of
#: generated tokens allowed to diverge from the fp-KV stream on the
#: bench model
KV_TOKEN_DRIFT_BUDGET = 0.10


def normalize_mode(raw, allowed: tuple, what: str) -> str:
    """One normalizer for every quant-mode knob (env vars and
    ``ContinuousDecoder(kv_quant=)``): off-ish spellings collapse to
    ``"off"``, anything else must be in ``allowed``.  ``what`` names the
    knob in the error."""
    raw = str(raw).strip().lower()
    if raw in ("", "0", "off", "none"):
        return "off"
    if raw in allowed:
        return raw
    raise ValueError(
        f"{what}={raw!r} is not a known quantization mode "
        f"(expected one of {('off',) + allowed})")


def kv_mode_default() -> str:
    """``BIGDL_SERVE_KV_QUANT`` resolved to off/int8 (default off)."""
    from bigdl_tpu_torch.quant.kv import ON_MODES
    return normalize_mode(os.environ.get(ENV_KV_QUANT, ""), ON_MODES,
                          ENV_KV_QUANT)


__all__ = ["ENV_KV_QUANT", "KV_TOKEN_DRIFT_BUDGET", "kv_mode_default",
           "normalize_mode"]
