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

Each kernel has an f32 and a bf16 form (``FORMS``), picked by the
tensors' dtype (a ``TypeError`` for any other): the bf16 form reads and
writes bf16 and compares and sums in f32, as the JAX kernel does
(pallas_kernels.py:196-246).  Both forms run the same staged design:
the bulk-copy ring's runs, leads and vector stores are counted in
elements, so a bf16 plane (98 bytes at Inception's 7x7) takes one copy as
an f32 one does, and ``plan(..., dtype=torch.bfloat16)`` sizes the stages
in 2-byte elements (the same groups as f32 at Inception's planes, in half
the shared memory).  The unstaged kernels stay for windows too tall for a
band of one row, in both forms; :func:`unstaged_forward` and
:func:`unstaged_backward` launch them in bf16 at any shape (the bf16
form's kernels before it was staged), to hold the staged bf16 forms to
them bit for bit on the card (no count).  ``launches`` counts the f32
form's launches, ``launches_bf16`` the bf16 form's.
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

FORMS = _build.FORMS
_EBYTES = {torch.float32: 4, torch.bfloat16: 2}

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


def entry(which: str, dtype: torch.dtype) -> str:
    """The C entry of the ``which`` ("fwd" or "bwd") kernel's form for
    ``dtype``; a ``TypeError`` where the kernel has none."""
    return _build.form_entry("maxpool2d_s1", which, dtype)


def _lib() -> ctypes.CDLL:
    if not _lib_cache:
        lib = _build.load("maxpool2d_s1")
        for dtype, sfx in ((torch.float32, ""), (torch.bfloat16, ""),
                           (torch.bfloat16, "_unstaged")):
            fwd, bwd = (getattr(lib, entry(w, dtype) + sfx)
                        for w in ("fwd", "bwd"))
            fwd.argtypes = [_VP, _VP, *_GEOM]
            bwd.argtypes = [_VP, _VP, _VP, *_GEOM]
            fwd.restype = bwd.restype = _I
        lib.bigdl_maxpool2d_s1_plan.argtypes = [_LL, *[_I] * 8, _VP]
        lib.bigdl_maxpool2d_s1_plan.restype = None
        lib.bigdl_cuda_error_string.argtypes = [_I]
        lib.bigdl_cuda_error_string.restype = ctypes.c_char_p
        _lib_cache.append(lib)
    return _lib_cache[0]


def _round_up(n, v):
    return (n + v - 1) // v * v


def _strips(n):
    return -(-n // STRIP_ROWS)


def _tap_bytes(kh, kw):
    """Bytes of a first-max tap in the backward's shared array; 0: too
    many taps for two bytes (the unstaged kernel)."""
    return 1 if kh * kw <= 256 else (2 if kh * kw <= 65536 else 0)


def _sized(nc, h, w, oh, ow, kh, kw, bwd, planes, rows, eb):
    """(tasks of a group, plan sizes) at ``planes`` planes and ``rows``
    rows of the pass's own output a group, elements of ``eb`` bytes, as
    ``size_plan``."""
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
    v = ALIGN // eb
    xbuf = _round_up(planes * xrows * w + v - 1, v)
    obuf = _round_up(planes * rows * (w if bwd else ow) + v - 1, v)
    if bwd:
        gbuf = _round_up(planes * grows * ow + v - 1, v)
        taps = -(-planes * grows * ow * _tap_bytes(kh, kw) // ALIGN) * ALIGN
        smem = eb * (STAGES * (xbuf + gbuf) + obuf) + taps
    else:
        smem = eb * (STAGES * xbuf + 2 * obuf)
    return tasks, {"planes": planes, "rows": rows, "xrows": xrows,
                   "grows": grows,
                   "threads": (min(tasks, MAX_THREADS) + 31) // 32 * 32,
                   "groups": -(-nc // planes) * bands, "smem_bytes": smem}


def plan(shape, window, pads, backward=False, dtype=torch.float32):
    """How csrc/maxpool2d_s1.cu cuts a forward (or backward) launch on x
    of ``shape`` and ``dtype``, as its ``make_plan``: a dict of ``path``
    ("planes": ``planes`` whole planes a group; "bands": one band of
    ``rows`` rows of one plane; "direct": the unstaged kernels), ``rows``
    (of y forward, dx backward, a group), ``xrows`` / ``grows`` (staged
    rows of x and g a plane), ``threads``, ``groups``, ``stages`` and
    ``smem_bytes``."""
    n, c, h, w = shape
    kh, kw = window
    oh, ow = out_size(h, w, window, _S1, pads)
    nc = n * c
    out = {"path": "direct", "planes": 0, "rows": 0, "xrows": 0,
           "grows": 0, "threads": 0, "groups": 0, "smem_bytes": 0,
           "stages": STAGES}
    entry("fwd", dtype)
    eb = _EBYTES[dtype]
    if backward and _tap_bytes(kh, kw) == 0:
        return out
    total = h if backward else oh
    tasks, sized = _sized(nc, h, w, oh, ow, kh, kw, backward, 1, total, eb)
    if tasks <= MAX_THREADS and sized["smem_bytes"] <= SMEM_CAP:
        planes = min(MAX_THREADS // tasks, nc)
        while True:
            _, sized = _sized(nc, h, w, oh, ow, kh, kw, backward, planes,
                              total, eb)
            if planes == 1 or sized["smem_bytes"] <= SMEM_CAP:
                break
            planes -= 1
        return out | sized | {"path": "planes"}
    cols = max(w, ow) if backward else ow
    first = min(total, STRIP_ROWS * max(1, MAX_THREADS // cols))
    for cap in (SMEM_CAP, SMEM_MAX):
        rows = first
        while True:
            _, sized = _sized(nc, h, w, oh, ow, kh, kw, backward, 1, rows,
                              eb)
            if rows == 1 or sized["smem_bytes"] <= cap:
                break
            rows -= 1
        if sized["smem_bytes"] <= cap:
            return out | sized | {"path": "bands"}
    return out | sized | {"path": "direct"}


def kernel_plan(shape, window, pads, backward=False, dtype=torch.float32):
    """The plan the built library computes (needs nvcc), to hold
    :func:`plan` to it on the card."""
    n, c, h, w = shape
    oh, ow = out_size(h, w, window, _S1, pads)
    got = (ctypes.c_longlong * 8)()
    _lib().bigdl_maxpool2d_s1_plan(n * c, h, w, oh, ow, *window,
                                   int(backward), _EBYTES[dtype], got)
    out = dict(zip(_PLAN_KEYS, got)) | {"stages": STAGES}
    out["path"] = PATHS[out["path"]]
    return out


def maxpool2d_s1_forward_reference(x, window, pads):
    """Plain version of the forward: ``y``."""
    return maxpool2d_forward_reference(x, window, _S1, pads)[0]


def maxpool2d_s1_backward_reference(x, g, window, pads):
    """Plain version of the backward: the first max recomputed from x,
    then the cotangents gathered onto it (in f32 for bf16, rounded
    once)."""
    _, arg = maxpool2d_forward_reference(x, window, _S1, pads)
    return maxpool2d_backward_reference(arg, g, window, _S1, pads, x.shape)


def maxpool2d_s1_forward(x, window, pads):
    """Stride-1 max pool of ``x`` (N, C, H, W) f32 or bf16 over
    ``window`` = (kh, kw) with ``pads`` = ((lo_h, hi_h), (lo_w, hi_w))."""
    if x.device.type == "cpu":
        return maxpool2d_s1_forward_reference(x, window, pads)
    if x.device.type != "cuda":
        raise ValueError(f"maxpool2d_s1: no kernel for device {x.device}")
    _check(x, "x")
    n, c, h, w = x.shape
    oh, ow = out_size(h, w, window, _S1, pads)
    y = torch.empty(n, c, oh, ow, dtype=x.dtype, device=x.device)
    _run("fwd", (x, y), x.shape, (oh, ow), window, pads)
    _build.count_launch(maxpool2d_s1_forward, x.dtype)
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
    if (tuple(g.shape) != (n, c, oh, ow) or x.device != g.device
            or x.dtype != g.dtype):
        raise ValueError(f"maxpool2d_s1: g {tuple(g.shape)} {g.dtype} on "
                         f"{g.device} does not match the output "
                         f"{(n, c, oh, ow)} {x.dtype} on {x.device}")
    dx = torch.empty_like(x)
    _run("bwd", (x, g, dx), x.shape, (oh, ow), window, pads)
    _build.count_launch(maxpool2d_s1_backward, x.dtype)
    return dx


maxpool2d_s1_forward.launches = maxpool2d_s1_forward.launches_bf16 = 0
maxpool2d_s1_backward.launches = maxpool2d_s1_backward.launches_bf16 = 0


def unstaged_forward(x, window, pads):
    """The bf16 forward on the unstaged kernel at any shape (CUDA tensors;
    no launch count): the reference the staged bf16 form equals bit for
    bit."""
    _check_unstaged(x)
    n, c, h, w = x.shape
    oh, ow = out_size(h, w, window, _S1, pads)
    y = torch.empty(n, c, oh, ow, dtype=x.dtype, device=x.device)
    _run("fwd", (x, y), x.shape, (oh, ow), window, pads, unstaged=True)
    return y


def unstaged_backward(x, g, window, pads):
    """The bf16 backward on the unstaged kernel, as
    :func:`unstaged_forward`."""
    _check_unstaged(x)
    _check(g, "g")
    oh, ow = out_size(*x.shape[2:], window, _S1, pads)
    dx = torch.empty_like(x)
    _run("bwd", (x, g, dx), x.shape, (oh, ow), window, pads, unstaged=True)
    return dx


def _check_unstaged(x):
    if x.dtype != torch.bfloat16 or x.device.type != "cuda":
        raise TypeError(f"maxpool2d_s1: the unstaged entries take bf16 CUDA "
                        f"tensors, got {x.dtype} on {x.device}")
    _check(x, "x")


def _check(t, name):
    entry("fwd", t.dtype)   # a TypeError where the kernels have no form
    if t.dim() != 4 or not t.is_contiguous():
        raise ValueError(f"maxpool2d_s1: {name} must be a contiguous NCHW "
                         f"tensor, got shape {tuple(t.shape)}")


def _run(which, tensors, xshape, oshape, window, pads, unstaged=False):
    n, c, h, w = xshape
    (plh, _), (plw, _) = pads
    lib = _lib()
    fn = getattr(lib, entry(which, tensors[0].dtype)
                 + ("_unstaged" if unstaged else ""))
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
