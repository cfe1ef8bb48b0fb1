"""Causal attention over a paged KV pool (counterpart of
bigdl_tpu/ops/pallas_kernels.py ``paged_attention``, :1391).

On a CUDA tensor :func:`paged_attention` launches the hand-written
``csrc/paged_attention.cu`` kernel or raises; on a CPU tensor it runs
:func:`paged_attention_reference`, the gathered-view version of the same
function.  There is no other path.  int8 pools with their per-row,
per-head scales (``quant/kv.py``) go to :func:`paged_attention_int8`,
the kernel's int8 variant, whose plain version dequantizes the gathered
view first.

The kernel cuts each row's page walk into :func:`split_count` page
ranges, one block each, and merges their partial softmaxes in a second
launch; :func:`paged_attention_split_reference` is the plain version of
that split and merge.  ``paged_attention.launches`` and
``paged_attention_int8.launches`` count calls that launch the kernel
(never reference calls), each of its own variant: one a call, the walk
and its merge together.
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

# csrc/paged_attention.cu: the card's SMs, the shortest table that is
# split, the walks an SM the split aims at and the fewest pages a split
SMS, SPLIT_FROM_PAGES, SPLIT_BLOCKS, MIN_SPLIT_PAGES = 132, 8, 4, 4


def split_count(bsz, heads, n_pages_row):
    """csrc/paged_attention.cu ``split_count``: the page ranges a call's
    walk is cut into at (B, H, P) -- one below SPLIT_FROM_PAGES pages;
    else enough (b, h, split) blocks for SPLIT_BLOCKS an SM, at least
    MIN_SPLIT_PAGES pages a split, then as few splits as give that many
    pages each."""
    if n_pages_row < SPLIT_FROM_PAGES:
        return 1
    rows = max(bsz * heads, 1)
    n = min(-(-SPLIT_BLOCKS * SMS // rows),
            -(-n_pages_row // MIN_SPLIT_PAGES))
    if n < 1:
        return 1
    per = -(-n_pages_row // n)
    return -(-n_pages_row // per)


def _lib() -> ctypes.CDLL:
    if not _lib_cache:
        lib = _build.load("paged_attention")
        lib.bigdl_paged_attention_f32.argtypes = [
            _VP, _VP, _VP, _VP, _VP, _VP,       # q kpool vpool ptab pos out
            _VP, _VP, _VP,                      # m l acc (splits > 1)
            _I, _I, _I, _I, _I, _I, _I,         # B S H hd ps P n_pages
            _I, _I, _I, _VP]                    # splits vec device stream
        lib.bigdl_paged_attention_f32.restype = _I
        lib.bigdl_paged_attention_int8.argtypes = [
            _VP, _VP, _VP, _VP, _VP,            # q kpool vpool kscale vscale
            _VP, _VP, _VP,                      # ptab pos out
            _VP, _VP, _VP,                      # m l acc (splits > 1)
            _I, _I, _I, _I, _I, _I, _I,         # B S H hd ps P n_pages
            _I, _I, _I, _VP]                    # splits vec device stream
        lib.bigdl_paged_attention_int8.restype = _I
        lib.bigdl_paged_attention_stages.argtypes = [_I, _I, _I, _I, _I]
        lib.bigdl_paged_attention_stages.restype = _I
        lib.bigdl_paged_attention_splits.argtypes = [_I, _I, _I]
        lib.bigdl_paged_attention_splits.restype = _I
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


def paged_attention_split_reference(q, kpool, vpool, ptab, pos,
                                    splits=None, kscale=None, vscale=None):
    """Plain version of the kernel's split walk: each row's page view
    (dequantized where the pools are int8) cut into ``splits`` ranges of
    ceil(P / splits) pages (:func:`split_count`'s by default), each
    range's unnormalised softmax -- max m, denominator l, accumulator --
    over its keys up to ``pos``, then merged in split order.  A range with
    no live key has m = -inf and l = 0 and adds nothing; a query with
    ``pos < 0`` comes out 0, as from the kernel."""
    bsz, S, H, hd = q.shape
    P, ps = ptab.shape[1], kpool.shape[1]
    n = split_count(bsz, H, P) if splits is None else int(splits)
    per = -(-P // n)
    idx = ptab.long()
    kview, vview = kpool[idx], vpool[idx]            # (B, P, ps, H, hd)
    if kscale is not None:
        kview = dequantize_view(kview, kscale[idx])
        vview = dequantize_view(vview, vscale[idx])
    keys, pad = P * ps, (n * per - P) * ps
    s = torch.einsum("bshd,bthd->bhst", q, kview.reshape(bsz, keys, H, hd))
    s = s * (1.0 / math.sqrt(hd))
    t = torch.arange(keys, device=q.device)
    s = s.masked_fill(t[None, None, None, :] > pos[:, None, :, None],
                      float("-inf"))
    s = torch.nn.functional.pad(s, (0, pad), value=float("-inf"))
    s = s.reshape(bsz, H, S, n, per * ps)
    v = torch.nn.functional.pad(vview.reshape(bsz, keys, H, hd),
                                (0, 0, 0, 0, 0, pad))
    v = v.reshape(bsz, n, per * ps, H, hd)
    m = s.amax(dim=-1)                                 # (B, H, S, n)
    w = torch.exp(s - torch.where(torch.isinf(m), 0.0, m)[..., None])
    l = w.sum(dim=-1)
    acc = torch.einsum("bhsnk,bnkhd->bhsnd", w, v)
    mx = m.amax(dim=-1, keepdim=True)
    f = torch.exp(m - torch.where(torch.isinf(mx), 0.0, mx))
    den = (l * f).sum(dim=-1)[..., None]
    num = (acc * f[..., None]).sum(dim=-2)
    out = torch.where(den > 0, num / torch.where(den > 0, den, 1.0), 0.0)
    return out.permute(0, 2, 1, 3).contiguous()


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
    caller's to discard.  A mix of int8 and fp32 inputs raises.  The
    kernel's walk is cut into :func:`split_count`'s page ranges."""
    return _launch(q, kpool, vpool, ptab, pos, kscale, vscale)


def _launch(q, kpool, vpool, ptab, pos, kscale=None, vscale=None,
            splits=None):
    """:func:`paged_attention` with its walk cut into ``splits`` page
    ranges (None: :func:`split_count`'s): the kernel checks hold it at
    counts the plan does not give through this."""
    if _check_pools(kpool, vpool, kscale, vscale):
        return _int8(q, kpool, vpool, ptab, pos, kscale, vscale, splits)
    if q.device.type == "cpu":
        return paged_attention_reference(q, kpool, vpool, ptab, pos)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: no kernel for device "
                         f"{q.device}")
    out, ptab, pos, dims = _prepare(q, kpool, vpool, ptab, pos,
                                    torch.float32)
    vec = 4 if (dims[3] % 4 == 0 and kpool.data_ptr() % 16 == 0
                and vpool.data_ptr() % 16 == 0) else 1
    n, part = _partials(q, dims, splits)
    lib = _lib()
    _raise_on(lib, lib.bigdl_paged_attention_f32(
        q.data_ptr(), kpool.data_ptr(), vpool.data_ptr(), ptab.data_ptr(),
        pos.data_ptr(), out.data_ptr(), *_ptrs(part), *dims, n, vec,
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
    return _int8(q, kpool, vpool, ptab, pos, kscale, vscale, None)


def _int8(q, kpool, vpool, ptab, pos, kscale, vscale, splits):
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
    n, part = _partials(q, dims, splits)
    lib = _lib()
    _raise_on(lib, lib.bigdl_paged_attention_int8(
        q.data_ptr(), *ptrs, kscale.data_ptr(), vscale.data_ptr(),
        ptab.data_ptr(), pos.data_ptr(), out.data_ptr(), *_ptrs(part), *dims, n,
        vec, *_build.device_stream(q.device)))
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


def _partials(q, dims, splits):
    """(splits, the m, l and acc scratch) of a launch: none for one
    split, whose walk writes the output itself."""
    bsz, S, H, hd, _, P, _ = dims
    n = split_count(bsz, H, P) if splits is None else int(splits)
    if n < 1:
        raise ValueError(f"paged_attention: splits must be >= 1, got {n}")
    if n == 1:
        return n, (None, None, None)
    rows = bsz * S * H * n
    return n, (q.new_empty(rows), q.new_empty(rows), q.new_empty(rows * hd))


def _ptrs(tensors):
    return [None if t is None else t.data_ptr() for t in tensors]


def _raise_on(lib, err):
    if err != 0:
        raise RuntimeError("paged_attention kernel launch failed: "
                           + lib.bigdl_cuda_error_string(err).decode())
