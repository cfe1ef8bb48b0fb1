"""Cross-channel local response normalisation (counterpart of
bigdl_tpu/ops/pallas_kernels.py ``lrn_channel``, :438).

:func:`lrn_channel` is the differentiable entry point.  Under autograd it
runs :func:`lrn_forward` with z = k + alpha/size * (window sum of x^2) as
the only residual besides x, and its backward is :func:`lrn_backward`, one
pass with a single adjoint window sum; a forward that needs no gradient
writes no z.  On CUDA tensors the two wrappers launch the hand-written
``csrc/lrn.cu`` kernels or raise; on CPU tensors they run the plain
versions beside them.  There is no other path.  ``lrn_forward.launches``
and ``lrn_backward.launches`` count kernel launches only.

``F.local_response_norm`` is not this function: it pads the channel window
(size//2, (size-1)//2), the mirror of the JAX window for even sizes.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.ops import _build

_VP = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_D = ctypes.c_double
_HYPER = [_LL, _I, _I, _I, _D, _D, _D, _I, _VP]  # N C HW size a b k dev st
_lib_cache = []


def _lib() -> ctypes.CDLL:
    if not _lib_cache:
        lib = _build.load("lrn")
        lib.bigdl_lrn_fwd_f32.argtypes = [_VP, _VP, _VP, *_HYPER]
        lib.bigdl_lrn_fwd_f32.restype = _I
        lib.bigdl_lrn_bwd_f32.argtypes = [_VP, _VP, _VP, _VP, *_HYPER]
        lib.bigdl_lrn_bwd_f32.restype = _I
        lib.bigdl_cuda_error_string.argtypes = [_I]
        lib.bigdl_cuda_error_string.restype = ctypes.c_char_p
        _lib_cache.append(lib)
    return _lib_cache[0]


def _window_sum(v, size: int, adjoint: bool = False):
    """Sum over the ``size``-channel window of each channel of NCHW ``v``,
    zero padding (lo, hi) = ((size-1)//2, size-1-lo), tap by tap in the
    JAX order (``_lrn_win_sum``); ``adjoint`` pads (hi, lo), the
    transposed window the backward needs for even sizes."""
    lo = (size - 1) // 2
    hi = size - 1 - lo
    if adjoint:
        lo, hi = hi, lo
    c = v.shape[1]
    vp = F.pad(v, (0, 0, 0, 0, lo, hi))
    acc = vp[:, :c]
    for s in range(1, size):
        acc = acc + vp[:, s:s + c]
    return acc


def _pow(z, beta: float):
    """z ** beta; at 0.75 as sqrt(sqrt(z)) cubed (``_lrn_pow``)."""
    if beta == 0.75:
        zb = torch.sqrt(torch.sqrt(z))
        return zb * zb * zb
    return z ** beta


def lrn_forward_reference(x, size, alpha, beta, k):
    """Plain version of the forward: ``(y, z)``."""
    z = k + (alpha / size) * _window_sum(x * x, size)
    return x / _pow(z, beta), z


def lrn_backward_reference(x, z, g, size, alpha, beta, k):
    """Plain version of the backward from the stored z:
    dx = g z^-b - (2 a b / size) x * adjoint-window-sum(g x z^(-b-1))."""
    zpow = _pow(z, beta)
    u = g * x / (zpow * z)
    return (g / zpow - (2.0 * alpha * beta / size) * x
            * _window_sum(u, size, adjoint=True))


def lrn_forward(x, size, alpha, beta, k, with_z=True):
    """LRN of ``x`` (N, C, H, W) f32 over ``size`` channels.  Returns
    ``(y, z)``, or ``y`` alone when ``with_z`` is False."""
    _check_hyper(size)
    if x.device.type == "cpu":
        y, z = lrn_forward_reference(x, size, alpha, beta, k)
        return (y, z) if with_z else y
    if x.device.type != "cuda":
        raise ValueError(f"lrn: no kernel for device {x.device}")
    _check(x, "x")
    y = torch.empty_like(x)
    z = torch.empty_like(x) if with_z else None
    _run("fwd", (x, y, z), x.shape, size, alpha, beta, k)
    lrn_forward.launches += 1
    return (y, z) if with_z else y


def lrn_backward(x, z, g, size, alpha, beta, k):
    """dx from the forward's input ``x``, its residual ``z`` and the
    cotangent ``g``, all (N, C, H, W) f32."""
    _check_hyper(size)
    if g.device.type == "cpu":
        return lrn_backward_reference(x, z, g, size, alpha, beta, k)
    if g.device.type != "cuda":
        raise ValueError(f"lrn: no kernel for device {g.device}")
    for t, name in ((x, "x"), (z, "z"), (g, "g")):
        _check(t, name)
        if t.shape != g.shape or t.device != g.device:
            raise ValueError(f"lrn: {name} {tuple(t.shape)} on {t.device} "
                             f"does not match g {tuple(g.shape)} on "
                             f"{g.device}")
    dx = torch.empty_like(g)
    _run("bwd", (x, z, g, dx), g.shape, size, alpha, beta, k)
    lrn_backward.launches += 1
    return dx


lrn_forward.launches = 0
lrn_backward.launches = 0


def _check_hyper(size):
    if int(size) != size or size < 1:
        raise ValueError(f"lrn: size must be a positive int, got {size}")


def _check(t, name):
    if t.dtype != torch.float32:
        raise TypeError(f"lrn: {name} must be float32, got {t.dtype}")
    if t.dim() != 4 or not t.is_contiguous():
        raise ValueError(f"lrn: {name} must be a contiguous NCHW tensor, "
                         f"got shape {tuple(t.shape)}")


def _run(which, tensors, shape, size, alpha, beta, k):
    n, c, h, w = shape
    lib = _lib()
    fn = lib.bigdl_lrn_fwd_f32 if which == "fwd" else lib.bigdl_lrn_bwd_f32
    ptrs = [None if t is None else t.data_ptr() for t in tensors]
    err = fn(*ptrs, n, c, h * w, int(size), float(alpha), float(beta),
             float(k), *_build.device_stream(tensors[0].device))
    if err != 0:
        raise RuntimeError(f"lrn {which} kernel launch failed: "
                           + lib.bigdl_cuda_error_string(err).decode())


class _LRN(torch.autograd.Function):
    """LRN whose residuals are x and z (the JAX ``lrn_channel`` custom
    VJP)."""

    @staticmethod
    def forward(ctx, x, size, alpha, beta, k):
        y, z = lrn_forward(x, size, alpha, beta, k)
        ctx.save_for_backward(x, z)
        ctx.hyper = (size, alpha, beta, k)
        return y

    @staticmethod
    def backward(ctx, g):
        x, z = ctx.saved_tensors
        return (lrn_backward(x, z, g.contiguous(), *ctx.hyper),
                None, None, None, None)


def lrn_channel(x, size, alpha, beta, k):
    """Cross-channel LRN of NCHW ``x``, differentiable; a forward that
    needs no gradient (``torch.no_grad()``, or ``x`` not requiring one)
    writes no z."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _LRN.apply(x, size, alpha, beta, k)
    return lrn_forward(x, size, alpha, beta, k, with_z=False)
