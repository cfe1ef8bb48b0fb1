"""Model broadcast (counterpart of bigdl_tpu/parallel/broadcast.py :16-38;
ref models/utils/ModelBroadcast.scala:33).

When training starts, rank 0's parameters and buffers go to every rank,
so ranks whose initial draws differed still start from one model (the
driver-to-executor broadcast of the reference).  One broadcast a dtype:
the tensors are packed into one flat buffer, sent, and copied back in
place (a view or a captured graph keeps its address).
"""
from __future__ import annotations

import torch

from bigdl_tpu_torch.parallel.collectives import broadcast


def broadcast_from_host0(tensors, group=None):
    """Every rank takes rank 0's values of ``tensors`` (a list), in
    place; returns the list."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for ts in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            broadcast(flat, 0, group)
            parts = flat.split([t.numel() for t in ts])
            torch._foreach_copy_(ts, [p.view(t.shape)
                                      for p, t in zip(parts, ts)])
    return tensors


def model_broadcast(model, mesh=None):
    """Rank 0's parameters and buffers on every rank of ``mesh`` (the
    default group when None), in place; returns the model (the
    ModelBroadcast.value() role)."""
    tensors = [p.data for p in model.parameters()] + list(model.buffers())
    if tensors:
        broadcast_from_host0(tensors, mesh)
    return model
