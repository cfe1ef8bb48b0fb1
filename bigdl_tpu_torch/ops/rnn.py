"""Direction-batched RNN recurrence under an element-wise activation over
a hoisted input projection (counterpart of bigdl_tpu/ops/pallas_kernels.py
``rnn_recurrence``, :998, whose activation is tanh, and of the JAX
package's ``lax.scan`` of an ``RnnCell`` with any other element-wise one).

:func:`rnn_recurrence` is the differentiable entry point: zx (T, D, B, H),
the projection plus both biases of D directions, and wht (D, H, H) give
the h stack (T, D, B, H) of h' = act(zx[t] + h . wht) from the initial
state h0 (D, B, H), or zeros as in the JAX kernel.  ``act`` is an
``ops._activation.Act``, tanh by default: one of twenty kinds with up
to three parameters.  h0 is a carried state (a truncated run's chunk
boundary) and is never differentiated.  Under autograd it runs
:func:`rnn_forward` with wht, hs and h0 as residuals (the JAX
``_rnn_vjp_fwd`` keeps wht and hs), and zx too where act is not tanh;
its backward is :func:`rnn_backward` (dzx = (gout + dh) act'(pre), in
reverse time: tanh's 1 - h^2 from the h stack alone, any other kind's
from the pre-activation zx + hprev . wht, recomputed for every step at
once) then :func:`rnn_dwh` (dwht = sum_t hprev^T . dz, hprev h0 at t =
0).  On CUDA tensors the three wrappers launch the
hand-written ``csrc/rnn.cu`` kernels (the bf16-weight form's in
``csrc/rnn_bf16.cu``) or raise; on CPU tensors they run
the plain versions beside them.  Each wrapper's ``launches`` counts its
kernel calls only.  The kernels are cluster recurrences
(``csrc/recurrence_cluster.cuh``) whose plan :func:`plan` mirrors: H <=
``MAX_HIDDEN``, a larger H is refused before a launch.

The forward and backward kernels have an f32 and a bf16-weight form
(``FORMS``, picked by wht's dtype; a ``TypeError`` for any other): the
recurrence of ``Recurrent(RnnCell)`` under a reduced dtype policy, wht
bf16 and zx f32, as the JAX kernels compute it (pallas_kernels.py:912,
:935).  The state is rounded to bf16 only where it meets the weight (pre
= zx + bf16(h) . wht, dh = bf16(dz) . wht^T, each sum of exact products
taken in f32); h0, the carries and the hs and dzx stacks stay f32, and
the weight gradient is the f32 product of the f32 stacks
(:func:`rnn_dwh`, one form), cast to wht's dtype by the autograd function
as the JAX VJP does.  A bf16 weight's slice takes half the f32 bytes of
shared memory, so its plans are their own (``plan(..., dtype=
torch.bfloat16)``); ``MAX_HIDDEN`` holds for both, since the largest H
reads its weight through L2 either way.  ``launches`` counts the f32
form's launches, ``launches_bf16`` the bf16 form's.
"""
from __future__ import annotations

import ctypes

import torch

from bigdl_tpu_torch.ops import _activation, _build
from bigdl_tpu_torch.ops import _recurrence as rec
from bigdl_tpu_torch.ops._activation import TANH

_KERNEL = "rnn"
# the bf16-weight form's library (csrc/rnn_bf16.cu: its own source, so
# that nvcc builds the two forms in parallel)
_LIBRARY = {torch.float32: "rnn", torch.bfloat16: "rnn_bf16"}


# (G, E, kHasC) of csrc/rnn.cu's RnnFwd and RnnBwd cells
FWD_CELL, BWD_CELL = (1, 1, False), (1, 2, False)

#: the forms of the forward and backward kernels, by wht's dtype
FORMS = _build.FORMS
_WBYTES = {torch.float32: 4, torch.bfloat16: 2}


def entry(which: str, dtype: torch.dtype) -> str:
    """The C entry of the ``which`` ("fwd" or "bwd") kernel's form for a
    wht of ``dtype``; a ``TypeError`` where the kernel has none."""
    return _build.form_entry(_KERNEL, which, dtype)


def plan(nd, b, hdim, backward=False, dtype=torch.float32):
    """The forward's (or backward's) cluster plan at (D, B, H) for a wht
    of ``dtype``, as csrc/rnn.cu's ``plan_of`` computes it: a dict of
    ``_recurrence.PLAN_FIELDS``."""
    entry("fwd", dtype)
    return rec.cluster_plan(*(BWD_CELL if backward else FWD_CELL), nd, b,
                            hdim, wbytes=_WBYTES[dtype])


def smem_bytes(hdim, rows=1):
    """(forward, backward) shared memory of a block of ``rows`` batch rows
    in a 16-block cluster at H = ``hdim``, with the weight read through L2
    and the shallowest ring: the least any plan at ``rows`` needs."""
    return tuple(4 * rec.cluster_smem_floats(*cell, hdim, rows,
                                             rec.CLUSTER_SIZES[-1], False,
                                             rec.MIN_DEPTH)
                 for cell in (FWD_CELL, BWD_CELL))


#: the largest H the kernels take (a 16-block cluster of one batch row)
MAX_HIDDEN = rec.max_hidden(smem_bytes)


def _setup_form(lib, dtype):
    # T D B H, then C R (0 0: the plan of the shape), the activation's
    # code and three parameters, device, stream
    act = [rec.I, ctypes.c_float, ctypes.c_float, ctypes.c_float]
    dims = rec.PLANNED_DIMS[:6] + act + rec.PLANNED_DIMS[6:]
    fwd, bwd = (getattr(lib, entry(w, dtype)) for w in ("fwd", "bwd"))
    fwd.argtypes = [rec.VP] * 4 + dims
    bwd.argtypes = [rec.VP] * 6 + dims
    fwd.restype = bwd.restype = rec.I


def _setup(lib):
    _setup_form(lib, torch.float32)
    lib.bigdl_rnn_dwh_f32.argtypes = ([rec.VP] * 5 + [rec.I] * 5
                                      + [rec.LL] + rec.DIMS[4:])
    lib.bigdl_rnn_dwh_f32.restype = rec.I
    for fn in (lib.bigdl_rnn_plan, lib.bigdl_rnn_plan_bf16):
        fn.argtypes = [rec.I] * 4 + [rec.VP]
        fn.restype = None


def _lib(dtype=torch.float32):
    """The library of the form for a wht of ``dtype`` (f32's: the plans
    and the weight gradient too)."""
    if dtype == torch.float32:
        return rec.load(_KERNEL, _setup)
    return rec.load(_LIBRARY[dtype],
                    lambda lib: _setup_form(lib, torch.bfloat16))


def kernel_plan(nd, b, hdim, backward=False, dtype=torch.float32):
    """The plan csrc/rnn.cu itself computes for a wht of ``dtype`` (the
    library built and loaded), to hold :func:`plan` to it on the card."""
    lib = _lib()
    fn = lib.bigdl_rnn_plan if _WBYTES[dtype] == 4 else lib.bigdl_rnn_plan_bf16
    return rec.kernel_plan(fn, int(backward), nd, b, hdim)


def rnn_forward_reference(zx, wht, h0=None, act=TANH):
    """Plain version of the forward: a loop over T with ``torch.matmul``
    (against a bf16 wht, h rounded to bf16 at the product)."""
    t, nd, b, hdim = zx.shape
    h = zx.new_zeros(nd, b, hdim) if h0 is None else h0
    hs = []
    for step in range(t):
        h = _activation.apply(act, zx[step] + rec.product(h, wht))
        hs.append(h)
    return torch.stack(hs) if hs else zx.new_zeros(0, nd, b, hdim)


def rnn_backward_reference(wht, hs, gout, act=TANH, zx=None, h0=None):
    """Plain version of the backward: dzx from a reverse loop over T, the
    derivative from the h stack (tanh) or from the pre-activation zx +
    hprev . wht (hprev h0 or zeros at t = 0); against a bf16 wht, hprev
    and dz rounded to bf16 at their products."""
    pre = (None if act.from_h
           else zx + rec.product(rec.shift_prev(hs, h0), wht))
    dh = hs.new_zeros(hs.shape[1:])
    dzx = torch.empty_like(hs)
    wh = wht.transpose(1, 2)
    for step in reversed(range(hs.shape[0])):
        grad = _activation.derivative(act, None if pre is None
                                      else pre[step], hs[step])
        dz = (gout[step] + dh) * grad
        dzx[step] = dz
        dh = rec.product(dz, wh)
    return dzx


def rnn_dwh_reference(hs, dzx, h0=None):
    """Plain version of the weight gradient: one einsum of the h stack
    read at t - 1 (h0 or zeros at t = 0) and dzx."""
    return torch.einsum("tdbk,tdbj->dkj", rec.shift_prev(hs, h0), dzx)


def rnn_forward(zx, wht, h0=None, act=TANH):
    """The h stack (T, D, B, H) f32 over ``zx`` (T, D, B, H) f32 and
    ``wht`` (D, H, H) f32 or bf16 (``FORMS``) from ``h0`` (D, B, H) f32 or
    zeros, under ``act``."""
    if zx.device.type == "cpu":
        return rnn_forward_reference(zx, wht, h0, act)
    t, nd, b, hdim = _check_inputs(zx, wht, "zx")
    rec.check_states(_KERNEL, zx.device, (nd, b, hdim), h0=h0)
    hs = zx.new_empty(t, nd, b, hdim)
    lib = _lib(wht.dtype)
    err = getattr(lib, entry("fwd", wht.dtype))(
        zx.data_ptr(), wht.data_ptr(), rec.ptr(h0), hs.data_ptr(), t, nd, b,
        hdim, 0, 0, *act.entry_args, *_build.device_stream(zx.device))
    rec.raise_on(lib, err, _KERNEL, "fwd", hdim)
    _build.count_launch(rnn_forward, wht.dtype)
    return hs


def rnn_backward(wht, hs, gout, act=TANH, zx=None, h0=None):
    """dzx (T, D, B, H) from ``wht``, the forward's ``hs`` and the
    cotangent ``gout`` of hs under ``act``; an activation other than tanh
    also takes the forward's ``zx`` and ``h0`` (None: zeros), from which
    the kernel recomputes the pre-activations."""
    if hs.device.type == "cpu":
        return rnn_backward_reference(wht, hs, gout, act, zx, h0)
    t, nd, b, hdim = _check_inputs(hs, wht, "hs")
    _check(gout, "gout", hs.device, (t, nd, b, hdim))
    if not act.from_h:
        if zx is None:
            raise ValueError(f"rnn_backward: {act.kind} needs zx")
        _check(zx, "zx", hs.device, (t, nd, b, hdim))
        rec.check_states(_KERNEL, hs.device, (nd, b, hdim), h0=h0)
    else:
        zx = h0 = None
    dzx = torch.empty_like(hs)
    lib = _lib(wht.dtype)
    err = getattr(lib, entry("bwd", wht.dtype))(
        rec.ptr(zx), wht.data_ptr(), hs.data_ptr(), rec.ptr(h0),
        gout.data_ptr(), dzx.data_ptr(), t, nd, b, hdim, 0, 0,
        *act.entry_args, *_build.device_stream(hs.device))
    rec.raise_on(lib, err, _KERNEL, "bwd", hdim)
    _build.count_launch(rnn_backward, wht.dtype)
    return dzx


def rnn_dwh(hs, dzx, h0=None):
    """dwht (D, H, H) = sum over t and b of hprev^T . dz, from the h stack
    ``hs`` (T, D, B, H) read at t - 1, ``h0`` (or zeros) at t = 0, and
    ``dzx`` (T, D, B, H)."""
    if hs.device.type == "cpu":
        return rnn_dwh_reference(hs, dzx, h0)
    rec.check_device(_KERNEL, hs)
    t, nd, b, hdim = hs.shape
    _check(hs, "hs", hs.device, (t, nd, b, hdim))
    _check(dzx, "dzx", hs.device, (t, nd, b, hdim))
    rec.check_states(_KERNEL, hs.device, (nd, b, hdim), h0=h0)
    s, rows = rec.dwh_slices(t, b, hdim, hdim, nd)
    part = hs.new_empty(s, nd, hdim, hdim)
    dwht = hs.new_empty(nd, hdim, hdim)
    lib = _lib()
    err = lib.bigdl_rnn_dwh_f32(hs.data_ptr(), rec.ptr(h0), dzx.data_ptr(),
                                part.data_ptr(),
                                dwht.data_ptr(), t, nd, b, hdim, s, rows,
                                *_build.device_stream(hs.device))
    rec.raise_on(lib, err, _KERNEL, "dwh", hdim)
    rnn_dwh.launches += 1
    return dwht


rnn_forward.launches = rnn_forward.launches_bf16 = 0
rnn_backward.launches = rnn_backward.launches_bf16 = 0
rnn_dwh.launches = 0


def _check(v, name, device, shape):
    rec.check(_KERNEL, v, name, device, shape)


def _check_inputs(x, wht, name):
    """(T, D, B, H) of a (T, D, B, H) stack ``x`` and ``wht`` (D, H, H)."""
    if x.dim() != 4:
        raise ValueError(f"rnn: expected a (T, D, B, H) tensor, got "
                         f"{tuple(x.shape)}")
    t, nd, b, hdim = x.shape
    rec.check_hidden(_KERNEL, hdim, MAX_HIDDEN, smem_bytes)
    rec.check_device(_KERNEL, x)
    entry("fwd", wht.dtype)
    _check(x, name, x.device, (t, nd, b, hdim))
    rec.check(_KERNEL, wht, "wht", x.device, (nd, hdim, hdim), wht.dtype)
    return t, nd, b, hdim


class _RNN(torch.autograd.Function):
    """The recurrence whose residuals are wht, hs and h0, and zx where the
    activation's derivative needs the pre-activation (the JAX
    ``rnn_recurrence`` custom VJP keeps wht and hs; h0 is a detached
    carry); the weight gradient in wht's dtype, as the JAX VJP returns
    it."""

    @staticmethod
    def forward(ctx, zx, wht, h0, act):
        hs = rnn_forward(zx, wht, h0, act)
        ctx.act = act
        ctx.save_for_backward(wht, hs, h0, None if act.from_h else zx)
        return hs

    @staticmethod
    def backward(ctx, gout):
        wht, hs, h0, zx = ctx.saved_tensors
        dzx = rnn_backward(wht, hs, gout.contiguous(), ctx.act, zx, h0)
        return dzx, rnn_dwh(hs, dzx, h0).to(wht.dtype), None, None


def rnn_recurrence(zx, wht, h0=None, act=TANH):
    """The h stack (T, D, B, H) of the RNN recurrence under ``act`` (an
    ``Act``, tanh by default) over ``zx`` (T, D, B, H) f32 and ``wht`` (D,
    H, H) f32 or bf16 from ``h0`` (D, B, H) or zeros, differentiable in zx
    and wht; ``h0`` is taken as a constant."""
    if h0 is not None:
        h0 = h0.detach()
    if torch.is_grad_enabled() and (zx.requires_grad or wht.requires_grad):
        return _RNN.apply(zx, wht, h0, act)
    return rnn_forward(zx, wht, h0, act)
