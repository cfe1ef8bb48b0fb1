"""Stride-1 NCHW max pooling whose backward recomputes the first maximum
from x (counterpart of bigdl_tpu/ops/pallas_kernels.py ``maxpool2d``,
:311).

:func:`maxpool2d_s1` is the differentiable entry point.  Its only residual
is x itself, which the layer after an Inception module's pool (a 1x1
convolution of the same input) keeps anyway: no argmax tensor is stored.
On CUDA tensors :func:`maxpool2d_s1_forward` and
:func:`maxpool2d_s1_backward` launch the hand-written
``csrc/maxpool2d_s1.cu`` kernels or raise; on CPU tensors they run the
plain versions, written on those of ``ops.maxpool`` at stride 1.  There
is no other path.  The tie and NaN rules are those of ``ops.maxpool``:
the first max in row-major window order wins, a NaN counts only at a
window's first tap.  The ``launches`` counts count kernel launches
only.  :func:`plan` mirrors how the kernels cut a launch into groups
(whole planes, row bands, or the unstaged kernels), so that the CPU tests
reach it; :func:`kernel_plan` asks the built library itself.
"""
from __future__ import annotations

import ctypes

import torch

from bigdl_tpu_torch.ops import _build
from bigdl_tpu_torch.ops.maxpool import (maxpool2d_backward_reference,
                                         maxpool2d_forward_reference,
                                         out_size)

_VP = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_GEOM = [_LL, *[_I] * 9, _VP]  # NC, H W OH OW kh kw plh plw dev, stream
_S1 = (1, 1)
_lib_cache = []

# csrc/maxpool2d_s1.cu's constants: a block's threads (a group's tasks),
# the rows a task slides down, the ring's stages, a bulk copy's alignment
# in bytes, the shared bytes a block takes at most while two fit an SM,
# and where a band needs more, at most
MAX_THREADS = 512
STRIP_ROWS = 8
STAGES = 3
ALIGN = 16
SMEM_CAP = 113 * 1024 - 64
SMEM_MAX = 227 * 1024 - 64
PATHS = ("direct", "planes", "bands")
_PLAN_KEYS = ("path", "planes", "rows", "xrows", "grows", "threads",
              "groups", "smem_bytes")


def _lib() -> ctypes.CDLL:
    if not _lib_cache:
        lib = _build.load("maxpool2d_s1")
        lib.bigdl_maxpool2d_s1_fwd_f32.argtypes = [_VP, _VP, *_GEOM]
        lib.bigdl_maxpool2d_s1_fwd_f32.restype = _I
        lib.bigdl_maxpool2d_s1_bwd_f32.argtypes = [_VP, _VP, _VP, *_GEOM]
        lib.bigdl_maxpool2d_s1_bwd_f32.restype = _I
        lib.bigdl_maxpool2d_s1_plan.argtypes = [_LL, *[_I] * 7, _VP]
        lib.bigdl_maxpool2d_s1_plan.restype = None
        lib.bigdl_cuda_error_string.argtypes = [_I]
        lib.bigdl_cuda_error_string.restype = ctypes.c_char_p
        _lib_cache.append(lib)
    return _lib_cache[0]


def _round4(n):
    return (n + 3) // 4 * 4


def _strips(n):
    return -(-n // STRIP_ROWS)


def _tap_bytes(kh, kw):
    """Bytes of a first-max tap in the backward's shared array; 0: too
    many taps for two bytes (the unstaged kernel)."""
    return 1 if kh * kw <= 256 else (2 if kh * kw <= 65536 else 0)


def _sized(nc, h, w, oh, ow, kh, kw, bwd, planes, rows):
    """(tasks of a group, plan sizes) at ``planes`` planes and ``rows``
    rows of the pass's own output a group, as ``size_plan``."""
    total = h if bwd else oh
    bands = -(-total // rows)
    if bands == 1:
        xrows, grows = h, (oh if bwd else 0)
    elif not bwd:
        xrows, grows = min(h, rows + kh - 1), 0
    else:
        grows = min(oh, rows + kh - 1)
        xrows = min(h, grows + kh - 1)
    tasks = planes * ow * _strips(grows if bwd else rows)
    if bwd:
        tasks = max(tasks, planes * w * _strips(rows))
    xbuf = _round4(planes * xrows * w + 3)
    obuf = _round4(planes * rows * (w if bwd else ow) + 3)
    if bwd:
        gbuf = _round4(planes * grows * ow + 3)
        taps = -(-planes * grows * ow * _tap_bytes(kh, kw) // ALIGN) * ALIGN
        smem = 4 * (STAGES * (xbuf + gbuf) + obuf) + taps
    else:
        smem = 4 * (STAGES * xbuf + 2 * obuf)
    return tasks, {"planes": planes, "rows": rows, "xrows": xrows,
                   "grows": grows,
                   "threads": (min(tasks, MAX_THREADS) + 31) // 32 * 32,
                   "groups": -(-nc // planes) * bands, "smem_bytes": smem}


def plan(shape, window, pads, backward=False):
    """How csrc/maxpool2d_s1.cu cuts a forward (or backward) launch on x
    of ``shape``, as its ``make_plan``: a dict of ``path`` ("planes":
    ``planes`` whole planes a group; "bands": one band of ``rows`` rows of
    one plane; "direct": the unstaged kernels), ``rows`` (of y forward, dx
    backward, a group), ``xrows`` / ``grows`` (staged rows of x and g a
    plane), ``threads``, ``groups``, ``stages`` and ``smem_bytes``."""
    n, c, h, w = shape
    kh, kw = window
    oh, ow = out_size(h, w, window, _S1, pads)
    nc = n * c
    out = {"path": "direct", "planes": 0, "rows": 0, "xrows": 0,
           "grows": 0, "threads": 0, "groups": 0, "smem_bytes": 0,
           "stages": STAGES}
    if backward and _tap_bytes(kh, kw) == 0:
        return out
    total = h if backward else oh
    tasks, sized = _sized(nc, h, w, oh, ow, kh, kw, backward, 1, total)
    if tasks <= MAX_THREADS and sized["smem_bytes"] <= SMEM_CAP:
        planes = min(MAX_THREADS // tasks, nc)
        while True:
            _, sized = _sized(nc, h, w, oh, ow, kh, kw, backward, planes,
                              total)
            if planes == 1 or sized["smem_bytes"] <= SMEM_CAP:
                break
            planes -= 1
        return out | sized | {"path": "planes"}
    cols = max(w, ow) if backward else ow
    first = min(total, STRIP_ROWS * max(1, MAX_THREADS // cols))
    for cap in (SMEM_CAP, SMEM_MAX):
        rows = first
        while True:
            _, sized = _sized(nc, h, w, oh, ow, kh, kw, backward, 1, rows)
            if rows == 1 or sized["smem_bytes"] <= cap:
                break
            rows -= 1
        if sized["smem_bytes"] <= cap:
            return out | sized | {"path": "bands"}
    return out | sized | {"path": "direct"}


def kernel_plan(shape, window, pads, backward=False):
    """The plan the built library computes (needs nvcc), to hold
    :func:`plan` to it on the card."""
    n, c, h, w = shape
    oh, ow = out_size(h, w, window, _S1, pads)
    got = (ctypes.c_longlong * 8)()
    _lib().bigdl_maxpool2d_s1_plan(n * c, h, w, oh, ow, *window,
                                   int(backward), got)
    out = dict(zip(_PLAN_KEYS, got)) | {"stages": STAGES}
    out["path"] = PATHS[out["path"]]
    return out


def maxpool2d_s1_forward_reference(x, window, pads):
    """Plain version of the forward: ``y``."""
    return maxpool2d_forward_reference(x, window, _S1, pads)[0]


def maxpool2d_s1_backward_reference(x, g, window, pads):
    """Plain version of the backward: the first max recomputed from x,
    then the cotangents gathered onto it."""
    _, arg = maxpool2d_forward_reference(x, window, _S1, pads)
    return maxpool2d_backward_reference(arg, g, window, _S1, pads, x.shape)


def maxpool2d_s1_forward(x, window, pads):
    """Stride-1 max pool of ``x`` (N, C, H, W) f32 over ``window`` =
    (kh, kw) with ``pads`` = ((lo_h, hi_h), (lo_w, hi_w))."""
    if x.device.type == "cpu":
        return maxpool2d_s1_forward_reference(x, window, pads)
    if x.device.type != "cuda":
        raise ValueError(f"maxpool2d_s1: no kernel for device {x.device}")
    _check(x, "x")
    n, c, h, w = x.shape
    oh, ow = out_size(h, w, window, _S1, pads)
    y = torch.empty(n, c, oh, ow, dtype=x.dtype, device=x.device)
    _run("fwd", (x, y), x.shape, (oh, ow), window, pads)
    maxpool2d_s1_forward.launches += 1
    return y


def maxpool2d_s1_backward(x, g, window, pads):
    """dx (the shape of ``x``) from the forward's input ``x`` and the
    cotangent ``g`` (N, C, OH, OW)."""
    if g.device.type == "cpu":
        return maxpool2d_s1_backward_reference(x, g, window, pads)
    if g.device.type != "cuda":
        raise ValueError(f"maxpool2d_s1: no kernel for device {g.device}")
    _check(x, "x")
    _check(g, "g")
    n, c, h, w = x.shape
    oh, ow = out_size(h, w, window, _S1, pads)
    if tuple(g.shape) != (n, c, oh, ow) or x.device != g.device:
        raise ValueError(f"maxpool2d_s1: g {tuple(g.shape)} on {g.device} "
                         f"does not match the output {(n, c, oh, ow)} on "
                         f"{x.device}")
    dx = torch.empty_like(x)
    _run("bwd", (x, g, dx), x.shape, (oh, ow), window, pads)
    maxpool2d_s1_backward.launches += 1
    return dx


maxpool2d_s1_forward.launches = 0
maxpool2d_s1_backward.launches = 0


def _check(t, name):
    if t.dtype != torch.float32:
        raise TypeError(f"maxpool2d_s1: {name} must be float32, got "
                        f"{t.dtype}")
    if t.dim() != 4 or not t.is_contiguous():
        raise ValueError(f"maxpool2d_s1: {name} must be a contiguous NCHW "
                         f"tensor, got shape {tuple(t.shape)}")


def _run(which, tensors, xshape, oshape, window, pads):
    n, c, h, w = xshape
    (plh, _), (plw, _) = pads
    lib = _lib()
    fn = (lib.bigdl_maxpool2d_s1_fwd_f32 if which == "fwd"
          else lib.bigdl_maxpool2d_s1_bwd_f32)
    err = fn(*[t.data_ptr() for t in tensors], n * c, h, w, *oshape,
             *window, plh, plw, *_build.device_stream(tensors[0].device))
    if err != 0:
        raise RuntimeError(f"maxpool2d_s1 {which} kernel launch failed: "
                           + lib.bigdl_cuda_error_string(err).decode())


class _MaxPool2dS1(torch.autograd.Function):
    """Stride-1 first-max pool whose residual is x (the JAX ``maxpool2d``
    custom VJP)."""

    @staticmethod
    def forward(ctx, x, window, pads):
        ctx.save_for_backward(x)
        ctx.geom = (window, pads)
        return maxpool2d_s1_forward(x, window, pads)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return (maxpool2d_s1_backward(x, g.contiguous(), *ctx.geom),
                None, None)


def maxpool2d_s1(x, window, pads):
    """Stride-1 NCHW max pool, differentiable."""
    window = tuple(int(k) for k in window)
    pads = tuple(tuple(int(p) for p in pad) for pad in pads)
    if torch.is_grad_enabled() and x.requires_grad:
        return _MaxPool2dS1.apply(x, window, pads)
    return maxpool2d_s1_forward(x, window, pads)
