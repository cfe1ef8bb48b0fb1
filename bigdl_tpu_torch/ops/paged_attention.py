"""Causal attention over a paged KV pool (counterpart of
bigdl_tpu/ops/pallas_kernels.py ``paged_attention``, :1391).

On a CUDA tensor :func:`paged_attention` launches the hand-written
``csrc/paged_attention.cu`` kernel or raises; on a CPU tensor it runs
:func:`paged_attention_reference`, the gathered-view version of the same
function.  There is no other path.  int8 pools with their per-row,
per-head scales (``quant/kv.py``) go to :func:`paged_attention_int8`,
the kernel's int8 variant, whose plain version dequantizes the gathered
view first.  ``paged_attention.launches`` and
``paged_attention_int8.launches`` count kernel launches (never reference
calls), each of its own variant.
"""
from __future__ import annotations

import ctypes
import math

import torch

from bigdl_tpu_torch.ops import _build
from bigdl_tpu_torch.quant.kv import dequantize_view, scale_shape

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
        lib.bigdl_paged_attention_int8.argtypes = [
            _VP, _VP, _VP, _VP, _VP,            # q kpool vpool kscale vscale
            _VP, _VP, _VP,                      # ptab pos out
            _I, _I, _I, _I, _I, _I, _I, _I,     # B S H hd ps P n_pages vec
            _I, _VP]                            # device, stream
        lib.bigdl_paged_attention_int8.restype = _I
        lib.bigdl_paged_attention_stages.argtypes = [_I, _I, _I, _I, _I]
        lib.bigdl_paged_attention_stages.restype = _I
        lib.bigdl_cuda_error_string.argtypes = [_I]
        lib.bigdl_cuda_error_string.restype = ctypes.c_char_p
        _lib_cache.append(lib)
    return _lib_cache[0]


def _attend(q, kview, vview, pos):
    """Softmax attention of ``q`` (B, S, H, hd) over gathered views
    (B, P, ps, H, hd), keys past ``pos`` masked."""
    bsz, S, H, hd = q.shape
    n_view = kview.shape[1] * kview.shape[2]
    kview = kview.reshape(bsz, n_view, H, hd)
    vview = vview.reshape(bsz, n_view, H, hd)
    s = torch.einsum("bshd,bthd->bhst", q, kview) * (1.0 / math.sqrt(hd))
    mask = (torch.arange(n_view, device=q.device)[None, None, None, :]
            <= pos[:, None, :, None])
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhst,bthd->bshd", p, vview)


def paged_attention_reference(q, kpool, vpool, ptab, pos):
    """Plain PyTorch version: gather each row's page view, mask keys past
    ``pos``, softmax (tests/test_paged_attention.py ``_ref_attention``).
    A row with ``pos < 0`` attends to nothing and comes out NaN."""
    ptab = ptab.long()
    return _attend(q, kpool[ptab], vpool[ptab], pos)


def paged_attention_int8_reference(q, kpool, vpool, ptab, pos, kscale,
                                   vscale):
    """Plain version of the int8 variant: gather each row's page view of
    the int8 pools and their scales, dequantize it
    (``quant.kv.dequantize_view``), then attend as
    :func:`paged_attention_reference` does."""
    ptab = ptab.long()
    return _attend(q, dequantize_view(kpool[ptab], kscale[ptab]),
                   dequantize_view(vpool[ptab], vscale[ptab]), pos)


def _check_pools(kpool, vpool, kscale, vscale) -> bool:
    """Whether the pools are int8 with their scales; raises on a mix of
    int8 and fp32 inputs or on scales of the wrong shape or type."""
    int8 = (kpool.dtype == torch.int8, vpool.dtype == torch.int8)
    scales = (kscale is not None, vscale is not None)
    if not any(int8) and not any(scales):
        return False
    if not (all(int8) and all(scales)):
        raise ValueError(
            f"paged_attention: int8 pools come with both scale arrays and "
            f"scales with int8 pools; got kpool {kpool.dtype}, vpool "
            f"{vpool.dtype}, kscale {'given' if scales[0] else 'None'}, "
            f"vscale {'given' if scales[1] else 'None'}")
    want = scale_shape(kpool.shape)
    for name, s in (("kscale", kscale), ("vscale", vscale)):
        if tuple(s.shape) != want:
            raise ValueError(f"paged_attention: {name} must have the "
                             f"pool's scale shape {want}, got "
                             f"{tuple(s.shape)}")
        if s.dtype != torch.float32:
            raise TypeError(f"paged_attention: {name} must be float32, "
                            f"got {s.dtype}")
    return True


def paged_attention(q, kpool, vpool, ptab, pos, kscale=None, vscale=None):
    """Causal paged attention, one layer.

    ``q`` (B, S, H, hd) f32 queries at absolute positions ``pos`` (B, S)
    int; ``kpool``/``vpool`` (n_pages, ps, H, hd) the layer's page pool,
    f32, or int8 with ``kscale``/``vscale`` (n_pages, ps, H) f32 (then
    the call is :func:`paged_attention_int8`'s); ``ptab`` (B, P) int the
    slot->page table.  Key position t of row b lives at
    ``pool[ptab[b, t // ps], t % ps]`` and attends when ``t <= pos[b,
    s]``; the scale is ``1/sqrt(hd)``.  Any S >= 1 and any ``ps``.
    Returns (B, S, H, hd) f32.  Rows whose window entry is dead are the
    caller's to discard.  A mix of int8 and fp32 inputs raises."""
    if _check_pools(kpool, vpool, kscale, vscale):
        return _int8(q, kpool, vpool, ptab, pos, kscale, vscale)
    if q.device.type == "cpu":
        return paged_attention_reference(q, kpool, vpool, ptab, pos)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: no kernel for device "
                         f"{q.device}")
    out, ptab, pos, dims = _prepare(q, kpool, vpool, ptab, pos,
                                    torch.float32)
    vec = 4 if (dims[3] % 4 == 0 and kpool.data_ptr() % 16 == 0
                and vpool.data_ptr() % 16 == 0) else 1
    lib = _lib()
    _raise_on(lib, lib.bigdl_paged_attention_f32(
        q.data_ptr(), kpool.data_ptr(), vpool.data_ptr(), ptab.data_ptr(),
        pos.data_ptr(), out.data_ptr(), *dims, vec,
        *_build.device_stream(q.device)))
    paged_attention.launches += 1
    return out


def paged_attention_int8(q, kpool, vpool, ptab, pos, kscale, vscale):
    """:func:`paged_attention` over int8 pools ``kpool``/``vpool``
    (n_pages, ps, H, hd) with their f32 scales ``kscale``/``vscale``
    (n_pages, ps, H), one per (page row, head): the kernel dequantizes
    in its page walk.  On a CPU tensor, the plain version."""
    if not _check_pools(kpool, vpool, kscale, vscale):
        raise ValueError("paged_attention_int8: the pools must be int8")
    return _int8(q, kpool, vpool, ptab, pos, kscale, vscale)


def _int8(q, kpool, vpool, ptab, pos, kscale, vscale):
    """:func:`paged_attention_int8` on pools ``_check_pools`` has passed;
    its launches count on ``paged_attention_int8.launches``."""
    if q.device.type == "cpu":
        return paged_attention_int8_reference(q, kpool, vpool, ptab, pos,
                                              kscale, vscale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_int8: no kernel for device "
                         f"{q.device}")
    for name, t in (("kscale", kscale), ("vscale", vscale)):
        if t.device != q.device:
            raise ValueError(f"paged_attention_int8: {name} on {t.device}, "
                             f"q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"paged_attention_int8: {name} must be "
                             f"contiguous")
    out, ptab, pos, dims = _prepare(q, kpool, vpool, ptab, pos, torch.int8)
    hd, ptrs = dims[3], (kpool.data_ptr(), vpool.data_ptr())
    vec = (16 if hd % 16 == 0 and all(p % 16 == 0 for p in ptrs)
           else 4 if hd % 4 == 0 and all(p % 4 == 0 for p in ptrs) else 1)
    lib = _lib()
    _raise_on(lib, lib.bigdl_paged_attention_int8(
        q.data_ptr(), *ptrs, kscale.data_ptr(), vscale.data_ptr(),
        ptab.data_ptr(), pos.data_ptr(), out.data_ptr(), *dims, vec,
        *_build.device_stream(q.device)))
    paged_attention_int8.launches += 1
    return out


paged_attention.launches = 0
paged_attention_int8.launches = 0


def _prepare(q, kpool, vpool, ptab, pos, pool_dtype):
    """Checks a launch's inputs; (the output, ptab and pos as contiguous
    int32, (B, S, H, hd, ps, P, n_pages))."""
    bsz, S, H, hd = q.shape
    n_pages, ps = kpool.shape[0], kpool.shape[1]
    P = ptab.shape[1]
    for name, t in (("kpool", kpool), ("vpool", vpool), ("ptab", ptab),
                    ("pos", pos)):
        if t.device != q.device:
            raise ValueError(f"paged_attention: {name} on {t.device}, "
                             f"q on {q.device}")
    for name, t, dtype in (("q", q, torch.float32),
                           ("kpool", kpool, pool_dtype),
                           ("vpool", vpool, pool_dtype)):
        if t.dtype != dtype:
            raise TypeError(f"paged_attention: {name} must be {dtype}, "
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
    elem = kpool.element_size()
    if _lib().bigdl_paged_attention_stages(S, hd, ps, P, elem) == 0:
        raise ValueError(f"paged_attention: S={S}, hd={hd}, ps={ps}, P={P} "
                         f"need more than 227 KB of shared memory for one "
                         f"page of {pool_dtype}")
    return (torch.empty_like(q), ptab, pos,
            (bsz, S, H, hd, ps, P, n_pages))


def _raise_on(lib, err):
    if err != 0:
        raise RuntimeError("paged_attention kernel launch failed: "
                           + lib.bigdl_cuda_error_string(err).decode())
