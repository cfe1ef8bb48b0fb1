"""int8 KV-page storage for the block-paged decode pool (counterpart of
bigdl_tpu/quant/kv.py).

The paged KV pools are ``(layers, n_pages, page_size, H, hd)``; at
serving batch sizes they are the device-memory budget, so int8 storage
holds about four times the pooled tokens in the same bytes.

Scheme: **per-page-row, per-head scales**, one float32 scale per
``(layer, page, in-page position, head)`` covering that row's ``hd``
values, in parallel ``(layers, n_pages, page_size, H)`` arrays beside
the pools.  A write never touches a neighbouring row (no requantizing of
a page), and the scales are indexed by the physical page id exactly like
the values, so whatever moves a page moves its scales.  Under tensor
parallelism a rank quantizes its own heads' rows: its scales are its
pools' (..., H/tp), with no traffic between ranks.

Write: ``q = clip(round(k / s), +-127)`` with ``s = max|k|_hd / 127``
(``torch.round`` rounds half to even, as ``jnp.round`` does, and the
order of operations is the JAX package's, so the int8 values are the
same bits); read: the attention multiplies the scale rows back in.  The
worst-case error is ``amax / 254`` per head-row.
"""
from __future__ import annotations

import torch

QMAX = 127.0
EPS = 1e-8
#: modes the paged decoder accepts: the source of truth for
#: ``kv_mode_default()`` and ``ContinuousDecoder(kv_quant=)``
MODES = ("off", "int8")
#: MODES minus "off": what ``normalize_mode`` accepts beyond off-ish
ON_MODES = tuple(m for m in MODES if m != "off")

scale_dtype = torch.float32
storage_dtype = torch.int8


def quantize_rows(x: torch.Tensor) -> tuple:
    """Quantize ``(..., H, hd)`` K/V rows per head: ``(q int8 (..., H,
    hd), scales f32 (..., H))``."""
    s = x.abs().amax(dim=-1).clamp_min(EPS) / QMAX
    q = torch.round(x / s[..., None]).clamp_(-QMAX, QMAX)
    return q.to(storage_dtype), s.to(scale_dtype)


def dequantize_view(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Dequantize a gathered view: ``q`` int8 ``(..., H, hd)`` with
    scales ``(..., H)`` back to float32."""
    return q.to(torch.float32) * s[..., None]


def scale_shape(pool_shape) -> tuple:
    """Scale-array shape for a ``(..., page_size, H, hd)`` pool: the same
    shape minus the ``hd`` dim."""
    return tuple(pool_shape[:-1])


def bytes_per_token(n_layers: int, n_heads: int, head_dim: int,
                    mode: str = "off") -> int:
    """KV bytes one pooled token costs across all layers (K and V, scales
    included)."""
    if mode == "int8":
        per_layer = 2 * (n_heads * head_dim * 1 + n_heads * 4)
    else:
        per_layer = 2 * n_heads * head_dim * 4
    return n_layers * per_layer
