"""Momentum SGD over a parameter list in one pass (counterpart of
bigdl_tpu/ops/pallas_kernels.py ``fused_sgd``, :90).

On CUDA tensors :func:`fused_sgd` launches the hand-written
``csrc/fused_sgd.cu`` kernel once over every leaf of the list, or raises;
on CPU tensors it runs :func:`fused_sgd_reference`, the unfused update of
``SGD.update`` leaf by leaf.  There is no other path.  Both update ``p``
and ``v`` in place (the JAX function is pure; in place saves a
model-sized copy) and leave them as they were where ``finite`` is a
False flag.  ``fused_sgd.launches`` counts kernel launches only.

The kernel reads its leaves from a device table of pointers and sizes.
A table is built, checked and uploaded once for a set of tensors and
reused while every pointer and size stays the same (a training loop whose
gradients persist across steps); a leaf that moves costs a rebuild.  So a
step captured in a CUDA graph after one eager step uploads nothing.

``lr`` is a host float, or a one-element float32 tensor on the leaves'
device that the kernel reads when it runs: the form a captured graph
needs, since a scheduled lr changes between replays.  Both forms give
the same bits.

``scales`` (per-parameter learning rates, the reference's
``learningRates``): one float32 tensor a leaf, of the leaf's shape or
broadcastable to it, on its device; the step direction is multiplied by
it before the rate, the velocity is not.  The kernel's scaled form reads
them from the same leaf table, one launch a step as before;
``fused_sgd.launches_scaled`` counts its launches apart from
``launches``.  The scales are checked when a table is built, and a
broadcast one is materialised then and kept with the table: a table's
key holds each scale's address and version counter, so a scale written
in place gets a new table.

``taps`` (the training-health taps, ``obs/taps.py``): a float64 tensor
of 4 on the leaves' device; the kernel's taps form adds the step's sums
g^2, p^2, (p' - p)^2 and the count of non-finite g into it as it
updates (p' and v' keep the bits of the form without taps; on a step
whose ``finite`` is False it sums and writes nothing else).  Its
launches count in ``launches`` (``launches_scaled``) as before and apart
in ``launches_taps``.  The plain version adds the same sums, leaf by
leaf (``obs.taps.sums``).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from bigdl_tpu_torch.ops import _build

#: elements of one leaf that one block updates (a multiple of 4)
CHUNK = 4096

_VP = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_lib_cache = []
#: device leaf tables, keyed by the device and every leaf's pointers and
#: sizes (a table is a function of these alone); the oldest goes first
_tables: dict = {}
_MAX_TABLES = 8


def _lib() -> ctypes.CDLL:
    if not _lib_cache:
        lib = _build.load("fused_sgd")
        lib.bigdl_fused_sgd_f32.argtypes = [
            _VP, _I, _I, _I,            # table n_leaves n_chunks chunk
            _F, _VP, _F, _F, _F, _I,    # lr lr_dev mom wd damp nesterov
            _I, _VP, _VP, _I, _VP]      # scaled finite taps device stream
        lib.bigdl_fused_sgd_f32.restype = _I
        lib.bigdl_cuda_error_string.argtypes = [_I]
        lib.bigdl_cuda_error_string.restype = ctypes.c_char_p
        _lib_cache.append(lib)
    return _lib_cache[0]


def fused_sgd_reference(params, grads, velocity, lr, momentum=0.0,
                        weight_decay=0.0, dampening=0.0, nesterov=False,
                        finite=None, scales=None, taps=None):
    """Plain version: the unfused math of ``SGD.update``
    (bigdl_tpu/optim/optim_method.py:135-150) leaf by leaf, written into
    ``params`` and ``velocity``; with ``momentum == 0`` the velocity is
    untouched.  ``lr`` is a float or a one-element float32 tensor.
    ``finite`` (a bool tensor or None) keeps every leaf as it was where it
    is False.  ``scales`` (None, or one tensor a leaf, broadcastable to
    it) multiply the step direction before the rate.  ``taps`` (None, or
    4 float64) gains the step's sums g^2, p^2, (p' - p)^2 and non-finite
    g (``obs.taps.sums``; p' is p where ``finite`` is False)."""
    from bigdl_tpu_torch.obs.taps import leaf_sums

    if scales is None:
        scales = [None] * len(params)
    with torch.no_grad():
        for p, g, v, s in zip(params, grads, velocity, scales):
            g_raw, p_old = g, (p.clone() if taps is not None else None)
            if weight_decay != 0.0:
                g = g + weight_decay * p
            if momentum != 0.0:
                v_new = momentum * v + (1 - dampening) * g
                step = g + momentum * v_new if nesterov else v_new
            else:
                v_new, step = v, g
            if s is not None:
                step = step * s
            p_new = p - lr * step
            if finite is not None:
                p_new = torch.where(finite, p_new, p)
                v_new = torch.where(finite, v_new, v)
            p.copy_(p_new)
            if momentum != 0.0:
                v.copy_(v_new)
            if taps is not None:
                taps += leaf_sums(g_raw, p_old, p).to(taps.device)
    return params, velocity


def fused_sgd(params, grads, velocity, lr, momentum=0.0, weight_decay=0.0,
              dampening=0.0, nesterov=False, finite=None, scales=None,
              taps=None):
    """One momentum-SGD step over lists of leaves ``params``, ``grads``,
    ``velocity`` (f32, one shape per triple), in place; returns
    ``(params, velocity)``.  ``lr``: a float, or a one-element float32
    tensor on the leaves' device, read when the kernel runs.  ``finite``:
    None, or a one-element bool tensor on the leaves' device; where it is
    False nothing changes.  ``scales``: None, or one float32 tensor a
    leaf (the leaf's shape or broadcastable to it, on its device), the
    per-parameter learning rates.  ``taps``: None, or a float64 tensor of
    4 on the leaves' device that gains the step's taps sums."""
    dev = params[0].device
    if taps is not None and (taps.device != dev
                             or taps.dtype != torch.float64
                             or taps.numel() != 4
                             or not taps.is_contiguous()):
        raise ValueError(f"fused_sgd: taps must be 4 contiguous float64 on "
                         f"{dev}, got {taps.dtype} {tuple(taps.shape)} on "
                         f"{taps.device}")
    if dev.type == "cpu":
        return fused_sgd_reference(
            params, grads, velocity, lr, momentum, weight_decay, dampening,
            nesterov, finite,
            None if scales is None else _checked_scales(params, scales),
            taps)
    if dev.type != "cuda":
        raise ValueError(f"fused_sgd: no kernel for device {dev}")
    _launch(params, grads, velocity, lr, momentum, weight_decay, dampening,
            nesterov, finite, scales, taps)
    return params, velocity


fused_sgd.launches = fused_sgd.launches_scaled = fused_sgd.launches_taps = 0


def _checked_scales(params, scales):
    """One float32 scale a leaf, on the leaf's device, of its shape: a
    scale of the leaf's shape as it is (contiguous), a broadcastable one
    materialised."""
    scales = list(scales)
    if len(scales) != len(params):
        raise ValueError(f"fused_sgd: {len(scales)} scales for "
                         f"{len(params)} params")
    out = []
    for k, (p, s) in enumerate(zip(params, scales)):
        if not isinstance(s, torch.Tensor):
            raise TypeError(f"fused_sgd: scale {k} must be a tensor, got "
                            f"{type(s).__name__}")
        if s.dtype != torch.float32:
            raise TypeError(f"fused_sgd: scale {k} must be float32, got "
                            f"{s.dtype}")
        if s.device != p.device:
            raise ValueError(f"fused_sgd: scale {k} on {s.device}, param "
                             f"on {p.device}")
        if s.shape == p.shape and s.is_contiguous():
            out.append(s)
            continue
        try:
            shape = torch.broadcast_shapes(s.shape, p.shape)
        except RuntimeError:
            shape = None
        if shape != p.shape:
            raise ValueError(f"fused_sgd: scale {k} of shape "
                             f"{tuple(s.shape)} does not broadcast to "
                             f"{tuple(p.shape)}")
        out.append(s.expand(p.shape).contiguous())
    return out


def _leaf_table(params, grads, velocity, scales=None):
    """(n_leaves, 7) int64 rows (p, g, v, s, n, first chunk, vec; s 0
    without scales), and the number of chunks, after checking every
    leaf's device, dtype, layout and shapes."""
    if not (len(params) == len(grads) == len(velocity)) or not params:
        raise ValueError(f"fused_sgd: {len(params)} params, {len(grads)} "
                         f"grads, {len(velocity)} velocities")
    dev = params[0].device
    if scales is None:
        scales = [None] * len(params)
    rows, first = [], 0
    for k, (p, g, v, s) in enumerate(zip(params, grads, velocity, scales)):
        for name, t in (("param", p), ("grad", g), ("velocity", v)):
            if t.device != dev:
                raise ValueError(f"fused_sgd: {name} {k} on {t.device}, "
                                 f"param 0 on {dev}")
            if t.dtype != torch.float32:
                raise TypeError(f"fused_sgd: {name} {k} must be float32, "
                                f"got {t.dtype}")
            if not t.is_contiguous():
                raise ValueError(f"fused_sgd: {name} {k} must be "
                                 f"contiguous")
        if not (p.shape == g.shape == v.shape):
            raise ValueError(f"fused_sgd: leaf {k} shapes {tuple(p.shape)}, "
                             f"{tuple(g.shape)}, {tuple(v.shape)} differ")
        ptrs = (p.data_ptr(), g.data_ptr(), v.data_ptr())
        if s is not None:
            ptrs += (s.data_ptr(),)
        n = p.numel()
        vec = int(all(a % 16 == 0 for a in ptrs))
        rows.append((*ptrs[:3], 0 if s is None else ptrs[3], n, first, vec))
        first += -(-n // CHUNK)
    return np.asarray(rows, np.int64), first


def _device_table(params, grads, velocity, scales=None):
    """(table on the card, n_leaves, n_chunks): the cached table when
    every leaf's pointers and sizes, and each scale's pointer and
    version, are those it was built for, else a new one, checked and
    uploaded (with the scales it reads, materialised where they
    broadcast)."""
    sp = None
    if scales is not None and all(isinstance(s, torch.Tensor)
                                  for s in scales):
        sp = tuple((s.data_ptr(), s._version) for s in scales)
    key = (params[0].device, len(params), len(grads), len(velocity), sp,
           *((p.data_ptr(), g.data_ptr(), v.data_ptr(),
              p.numel(), g.numel(), v.numel())
             for p, g, v in zip(params, grads, velocity)))
    hit = _tables.get(key) if scales is None or sp is not None else None
    if hit is not None:
        return hit[:3]
    full = None if scales is None else _checked_scales(params, scales)
    rows, n_chunks = _leaf_table(params, grads, velocity, full)
    if n_chunks >= 2**31:
        raise ValueError(f"fused_sgd: {n_chunks} chunks exceed one grid")
    # pinned and non-blocking: the host does not wait for the card; the
    # caching host allocator keeps the buffer until the copy has run
    table = torch.from_numpy(rows).pin_memory().to(params[0].device,
                                                   non_blocking=True)
    if len(_tables) >= _MAX_TABLES:
        del _tables[next(iter(_tables))]
    _tables[key] = (table, len(rows), n_chunks, full)
    return _tables[key][:3]


def _launch(params, grads, velocity, lr, momentum, weight_decay, dampening,
            nesterov, finite, scales=None, taps=None):
    dev = params[0].device
    if finite is not None and (finite.device != dev
                               or finite.dtype != torch.bool
                               or finite.numel() != 1):
        raise ValueError(f"fused_sgd: finite must be one bool on {dev}, "
                         f"got {finite.dtype} {tuple(finite.shape)} on "
                         f"{finite.device}")
    lr_dev = None
    if isinstance(lr, torch.Tensor):
        if (lr.device != dev or lr.dtype != torch.float32
                or lr.numel() != 1):
            raise ValueError(f"fused_sgd: a tensor lr must be one float32 "
                             f"on {dev}, got {lr.dtype} {tuple(lr.shape)} "
                             f"on {lr.device}")
        lr_dev, lr = lr.data_ptr(), 0.0
    table, n_leaves, n_chunks = _device_table(params, grads, velocity,
                                              scales)
    if n_chunks == 0:
        return
    lib = _lib()
    err = lib.bigdl_fused_sgd_f32(
        table.data_ptr(), n_leaves, n_chunks, CHUNK, float(lr), lr_dev,
        float(momentum), float(weight_decay), float(dampening),
        int(bool(nesterov)), int(scales is not None),
        None if finite is None else finite.data_ptr(),
        None if taps is None else taps.data_ptr(),
        *_build.device_stream(dev))
    if err != 0:
        raise RuntimeError("fused_sgd kernel launch failed: "
                           + lib.bigdl_cuda_error_string(err).decode())
    if scales is None:
        fused_sgd.launches += 1
    else:
        fused_sgd.launches_scaled += 1
    if taps is not None:
        fused_sgd.launches_taps += 1
