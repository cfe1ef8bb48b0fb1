"""Causal attention over a paged KV pool (counterpart of
bigdl_tpu/ops/pallas_kernels.py ``paged_attention``, :1391).

On a CUDA tensor :func:`paged_attention` launches the hand-written
``csrc/paged_attention.cu`` kernel or raises; on a CPU tensor it runs
:func:`paged_attention_reference`, the gathered-view version of the same
function.  There is no other path.  ``paged_attention.launches`` counts
kernel launches (never reference calls).
"""
from __future__ import annotations

import ctypes
import math

import torch

from bigdl_tpu_torch.ops import _build

_VP = ctypes.c_void_p
_I = ctypes.c_int
_lib_cache = []


def _lib() -> ctypes.CDLL:
    if not _lib_cache:
        lib = _build.load("paged_attention")
        lib.bigdl_paged_attention_f32.argtypes = [
            _VP, _VP, _VP, _VP, _VP, _VP,       # q kpool vpool ptab pos out
            _I, _I, _I, _I, _I, _I, _I, _I,     # B S H hd ps P n_pages vec
            _I, _VP]                            # device, stream
        lib.bigdl_paged_attention_f32.restype = _I
        lib.bigdl_paged_attention_stages.argtypes = [_I, _I, _I, _I]
        lib.bigdl_paged_attention_stages.restype = _I
        lib.bigdl_cuda_error_string.argtypes = [_I]
        lib.bigdl_cuda_error_string.restype = ctypes.c_char_p
        _lib_cache.append(lib)
    return _lib_cache[0]


def paged_attention_reference(q, kpool, vpool, ptab, pos):
    """Plain PyTorch version: gather each row's page view, mask keys past
    ``pos``, softmax (tests/test_paged_attention.py ``_ref_attention``).
    A row with ``pos < 0`` attends to nothing and comes out NaN."""
    bsz, S, H, hd = q.shape
    ps = kpool.shape[1]
    n_view = ptab.shape[1] * ps
    ptab = ptab.long()
    kview = kpool[ptab].reshape(bsz, n_view, H, hd)
    vview = vpool[ptab].reshape(bsz, n_view, H, hd)
    s = torch.einsum("bshd,bthd->bhst", q, kview) * (1.0 / math.sqrt(hd))
    mask = (torch.arange(n_view, device=q.device)[None, None, None, :]
            <= pos[:, None, :, None])
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhst,bthd->bshd", p, vview)


def paged_attention(q, kpool, vpool, ptab, pos, kscale=None, vscale=None):
    """Causal paged attention, one layer.

    ``q`` (B, S, H, hd) f32 queries at absolute positions ``pos`` (B, S)
    int; ``kpool``/``vpool`` (n_pages, ps, H, hd) f32 the layer's page
    pool; ``ptab`` (B, P) int the slot->page table.  Key position t of
    row b lives at ``pool[ptab[b, t // ps], t % ps]`` and attends when
    ``t <= pos[b, s]``; the scale is ``1/sqrt(hd)``.  Any S >= 1 and any
    ``ps``.  Returns (B, S, H, hd) f32.  Rows whose window entry is dead
    are the caller's to discard.  int8 pools (``kscale``/``vscale``)
    raise: they come with the KV-quantisation slice."""
    if (kscale is not None or vscale is not None
            or kpool.dtype == torch.int8 or vpool.dtype == torch.int8):
        raise NotImplementedError(
            "paged_attention: int8 KV pools come with the KV-quantisation "
            "slice; this port takes fp32 pools")
    if q.device.type == "cpu":
        return paged_attention_reference(q, kpool, vpool, ptab, pos)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: no kernel for device "
                         f"{q.device}")
    return _launch(q, kpool, vpool, ptab, pos)


paged_attention.launches = 0


def _launch(q, kpool, vpool, ptab, pos):
    bsz, S, H, hd = q.shape
    n_pages, ps = kpool.shape[0], kpool.shape[1]
    P = ptab.shape[1]
    for name, t in (("kpool", kpool), ("vpool", vpool), ("ptab", ptab),
                    ("pos", pos)):
        if t.device != q.device:
            raise ValueError(f"paged_attention: {name} on {t.device}, "
                             f"q on {q.device}")
    for name, t in (("q", q), ("kpool", kpool), ("vpool", vpool)):
        if t.dtype != torch.float32:
            raise TypeError(f"paged_attention: {name} must be float32, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} must be contiguous")
    if (tuple(kpool.shape) != (n_pages, ps, H, hd)
            or vpool.shape != kpool.shape
            or tuple(ptab.shape) != (bsz, P)
            or tuple(pos.shape) != (bsz, S)):
        raise ValueError(
            f"paged_attention: shapes q {tuple(q.shape)}, kpool "
            f"{tuple(kpool.shape)}, vpool {tuple(vpool.shape)}, ptab "
            f"{tuple(ptab.shape)}, pos {tuple(pos.shape)} do not agree")
    ptab = ptab.to(torch.int32).contiguous()
    pos = pos.to(torch.int32).contiguous()
    lib = _lib()
    if lib.bigdl_paged_attention_stages(S, hd, ps, P) == 0:
        raise ValueError(f"paged_attention: S={S}, hd={hd}, ps={ps}, P={P} "
                         f"need more than 227 KB of shared memory for one "
                         f"page")
    vec = 4 if (hd % 4 == 0 and kpool.data_ptr() % 16 == 0
                and vpool.data_ptr() % 16 == 0) else 1
    out = torch.empty_like(q)
    err = lib.bigdl_paged_attention_f32(
        q.data_ptr(), kpool.data_ptr(), vpool.data_ptr(), ptab.data_ptr(),
        pos.data_ptr(), out.data_ptr(), bsz, S, H, hd, ps, P, n_pages, vec,
        *_build.device_stream(q.device))
    if err != 0:
        raise RuntimeError("paged_attention kernel launch failed: "
                           + lib.bigdl_cuda_error_string(err).decode())
    paged_attention.launches += 1
    return out
