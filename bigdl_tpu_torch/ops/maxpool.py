"""NCHW max pooling with a stored window argmax (counterpart of
bigdl_tpu/ops/pallas_kernels.py ``mosaic_maxpool2d``, :1259).

:func:`maxpool2d` is the differentiable entry point.  Under autograd it
runs :func:`maxpool2d_forward` with the int32 argmax (``i * kw + j``,
first max in row-major window order) as the only residual, and its
backward is :func:`maxpool2d_backward`, a gather over that argmax; a
forward that needs no gradient writes no argmax.  On CUDA tensors the two
wrappers launch the hand-written ``csrc/maxpool2d.cu`` kernels or raise;
on CPU tensors they run the plain versions beside them.  There is no other
path.  ``maxpool2d_forward.launches`` and ``maxpool2d_backward.launches``
count kernel launches only.

Each kernel has an f32 and a bf16 form (``FORMS``; the bf16 form is the
pool a reduced dtype policy runs): bf16 in and out, the compares in f32
(exact for bf16 values), the argmax int32, and the backward's sums of
overlapping windows taken in f32 in (oh, ow) order and rounded once, as
the JAX kernel's (pallas_kernels.py:1118-1142).  Both forms of the
backward are the one staged tile kernel (g staged in its own dtype, dx
out in 16-byte vectors).  The wrappers pick the form by the tensor's
dtype and raise a ``TypeError`` for any other; the plain versions
compute the same function in each dtype (the backward's sums in
``F.fold``'s order: within one bf16 ulp of the kernel's).  ``launches``
counts the f32 form's launches, ``launches_bf16`` the bf16 form's.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.ops import _build

_VP = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_GEOM = [_LL, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I]  # NC H W OH OW k s pad
_lib_cache = []

FORMS = _build.FORMS


def entry(which: str, dtype: torch.dtype) -> str:
    """The C entry of the ``which`` ("fwd" or "bwd") kernel's form for
    ``dtype``; a ``TypeError`` where the kernel has none."""
    return _build.form_entry("maxpool2d", which, dtype)


def _lib() -> ctypes.CDLL:
    if not _lib_cache:
        lib = _build.load("maxpool2d")
        for which in ("fwd", "bwd"):
            for dtype in FORMS:
                fn = getattr(lib, entry(which, dtype))
                fn.argtypes = [_VP, _VP, _VP, *_GEOM, _I, _VP]
                fn.restype = _I
        lib.bigdl_maxpool2d_bwd_plan.argtypes = [*_GEOM, _I, _VP]
        lib.bigdl_maxpool2d_bwd_plan.restype = None
        lib.bigdl_cuda_error_string.argtypes = [_I]
        lib.bigdl_cuda_error_string.restype = ctypes.c_char_p
        _lib_cache.append(lib)
    return _lib_cache[0]


_BWD_PLAN_KEYS = ("staged", "planes", "rows", "threads", "mr", "mc",
                  "smem_bytes")


def kernel_plan(xshape, window, strides, pads, dtype=torch.float32):
    """How the built library (needs nvcc) cuts a backward launch of
    ``dtype`` onto x of ``xshape``: a dict of ``staged`` (g and the
    argmax staged in shared memory, else read through L1), ``planes`` a
    block, ``rows`` a tile, ``threads``, the unrolled covering bounds
    ``mr`` x ``mc`` (0 x 0: any window) and ``smem_bytes``."""
    entry("bwd", dtype)
    n, c, h, w = xshape
    (plh, _), (plw, _) = pads
    oh, ow = out_size(h, w, window, strides, pads)
    got = (ctypes.c_longlong * len(_BWD_PLAN_KEYS))()
    _lib().bigdl_maxpool2d_bwd_plan(n * c, h, w, oh, ow, *window, *strides,
                                    plh, plw, torch.finfo(dtype).bits // 8,
                                    got)
    return dict(zip(_BWD_PLAN_KEYS, got))


def out_size(h: int, w: int, window, strides, pads):
    """(OH, OW) of a pool over the frame padded by ``pads`` =
    ((lo_h, hi_h), (lo_w, hi_w)) (``_mosaic_pool_geom``)."""
    (kh, kw), (sh, sw) = window, strides
    (plh, phh), (plw, phw) = pads
    oh = (h + plh + phh - kh) // sh + 1
    ow = (w + plw + phw - kw) // sw + 1
    if oh < 1 or ow < 1:
        raise ValueError(f"maxpool2d: window {tuple(window)} does not fit "
                         f"the padded {h}x{w} frame")
    return oh, ow


def maxpool2d_forward_reference(x, window, strides, pads):
    """Plain version: pad with -inf, unfold the windows, ``argmax`` (the
    first max) and gather.  Returns ``(y, argmax int32)``; its own autograd
    routes the gradient to the same first max.

    NaN follows the kernels' rule (the Mosaic kernel's too): taps are
    walked in row-major order with a strict >, so a NaN at a window's
    first tap is kept and a NaN at any later tap never wins.  ``argmax``
    ranks NaN highest, so a NaN past the first tap is ranked as -inf."""
    (kh, kw), (sh, sw) = window, strides
    (plh, phh), (plw, phw) = pads
    n, c, h, w = x.shape
    oh, ow = out_size(h, w, window, strides, pads)
    xp = F.pad(x, (plw, phw, plh, phh), value=float("-inf"))
    cols = F.unfold(xp, (kh, kw), stride=(sh, sw))
    cols = cols.view(n, c, kh * kw, oh * ow)
    later_nan = cols.isnan()
    later_nan[:, :, 0] = False
    arg = cols.masked_fill(later_nan, float("-inf")).argmax(dim=2,
                                                            keepdim=True)
    y = cols.gather(2, arg).view(n, c, oh, ow)
    return y, arg.view(n, c, oh, ow).to(torch.int32)


def maxpool2d_backward_reference(argmax, g, window, strides, pads, xshape):
    """Plain version of the backward: each output's cotangent goes to the
    tap its argmax names (a one-hot scatter into the unfolded windows),
    and ``fold`` sums the windows back onto the padded frame, in f32 at
    least (a bf16 g's sums are taken in f32 and rounded once)."""
    if g.dtype == torch.bfloat16:
        return maxpool2d_backward_reference(argmax, g.float(), window,
                                            strides, pads, xshape).to(g.dtype)
    (kh, kw), (sh, sw) = window, strides
    (plh, phh), (plw, phw) = pads
    n, c, h, w = xshape
    oh, ow = argmax.shape[2:]
    cols = torch.zeros(n, c, kh * kw, oh * ow, dtype=g.dtype,
                       device=g.device)
    cols.scatter_(2, argmax.reshape(n, c, 1, -1).long(),
                  g.reshape(n, c, 1, -1))
    dxp = F.fold(cols.view(n, c * kh * kw, -1),
                 (h + plh + phh, w + plw + phw), (kh, kw), stride=(sh, sw))
    return dxp[:, :, plh:plh + h, plw:plw + w].contiguous()


def maxpool2d_forward(x, window, strides, pads, with_argmax=True):
    """Max pool of ``x`` (N, C, H, W) f32 or bf16 over ``window`` = (kh,
    kw) with ``strides`` = (sh, sw) and ``pads`` = ((lo_h, hi_h), (lo_w,
    hi_w)).
    Returns ``(y, argmax)``, or ``y`` alone when ``with_argmax`` is
    False."""
    if x.device.type == "cpu":
        y, arg = maxpool2d_forward_reference(x, window, strides, pads)
        return (y, arg) if with_argmax else y
    if x.device.type != "cuda":
        raise ValueError(f"maxpool2d: no kernel for device {x.device}")
    _check(x, "x")
    n, c, h, w = x.shape
    oh, ow = out_size(h, w, window, strides, pads)
    y = torch.empty(n, c, oh, ow, dtype=x.dtype, device=x.device)
    arg = (torch.empty(n, c, oh, ow, dtype=torch.int32, device=x.device)
           if with_argmax else None)
    _run("fwd", x, y, arg, x.shape, (oh, ow), window, strides, pads)
    _build.count_launch(maxpool2d_forward, x.dtype)
    return (y, arg) if with_argmax else y


def maxpool2d_backward(argmax, g, window, strides, pads, xshape):
    """dx of shape ``xshape`` from the forward's ``argmax`` and the
    cotangent ``g`` (both (N, C, OH, OW))."""
    if g.device.type == "cpu":
        return maxpool2d_backward_reference(argmax, g, window, strides, pads,
                                            xshape)
    if g.device.type != "cuda":
        raise ValueError(f"maxpool2d: no kernel for device {g.device}")
    _check(g, "g")
    _check(argmax, "argmax", torch.int32)
    n, c, h, w = xshape
    oh, ow = out_size(h, w, window, strides, pads)
    if (tuple(g.shape) != (n, c, oh, ow) or argmax.shape != g.shape
            or argmax.device != g.device):
        raise ValueError(f"maxpool2d: g {tuple(g.shape)} and argmax "
                         f"{tuple(argmax.shape)} on {argmax.device} do not "
                         f"match the output {(n, c, oh, ow)} on {g.device}")
    dx = torch.empty(xshape, dtype=g.dtype, device=g.device)
    _run("bwd", g, argmax, dx, xshape, (oh, ow), window, strides, pads)
    _build.count_launch(maxpool2d_backward, g.dtype)
    return dx


maxpool2d_forward.launches = maxpool2d_forward.launches_bf16 = 0
maxpool2d_backward.launches = maxpool2d_backward.launches_bf16 = 0


def _check(t, name, dtype=None):
    """A contiguous NCHW tensor of ``dtype``, or (None) of a dtype the
    kernels have a form for."""
    if dtype is None:
        entry("fwd", t.dtype)
    elif t.dtype != dtype:
        raise TypeError(f"maxpool2d: {name} must be {dtype}, got {t.dtype}")
    if t.dim() != 4 or not t.is_contiguous():
        raise ValueError(f"maxpool2d: {name} must be a contiguous NCHW "
                         f"tensor, got shape {tuple(t.shape)}")


def _run(which, a, b, c, xshape, oshape, window, strides, pads):
    n, ch, h, w = xshape
    (plh, _), (plw, _) = pads
    lib = _lib()
    fn = getattr(lib, entry(which, a.dtype))
    err = fn(a.data_ptr(), b.data_ptr(),
             None if c is None else c.data_ptr(), n * ch, h, w, *oshape,
             *window, *strides, plh, plw, *_build.device_stream(a.device))
    if err != 0:
        raise RuntimeError(f"maxpool2d {which} kernel launch failed: "
                           + lib.bigdl_cuda_error_string(err).decode())


class _MaxPool2d(torch.autograd.Function):
    """First-max pool whose only residual is the argmax (the JAX
    ``_mosaic_maxpool`` custom VJP)."""

    @staticmethod
    def forward(ctx, x, window, strides, pads):
        y, arg = maxpool2d_forward(x, window, strides, pads)
        ctx.save_for_backward(arg)
        ctx.geom = (window, strides, pads, tuple(x.shape))
        return y

    @staticmethod
    def backward(ctx, g):
        (arg,) = ctx.saved_tensors
        return (maxpool2d_backward(arg, g.contiguous(), *ctx.geom),
                None, None, None)


def maxpool2d(x, window, strides, pads):
    """NCHW max pool, differentiable; a forward that needs no gradient
    (``torch.no_grad()``, or ``x`` not requiring one) writes no
    argmax."""
    window = tuple(int(k) for k in window)
    strides = tuple(int(s) for s in strides)
    pads = tuple(tuple(int(p) for p in pad) for pad in pads)
    if torch.is_grad_enabled() and x.requires_grad:
        return _MaxPool2d.apply(x, window, strides, pads)
    return maxpool2d_forward(x, window, strides, pads, with_argmax=False)
