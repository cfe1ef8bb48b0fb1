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
gradients persist across steps); a leaf that moves costs a rebuild.
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
            _F, _F, _F, _F, _I,         # lr mom wd damp nesterov
            _VP, _I, _VP]               # finite device stream
        lib.bigdl_fused_sgd_f32.restype = _I
        lib.bigdl_cuda_error_string.argtypes = [_I]
        lib.bigdl_cuda_error_string.restype = ctypes.c_char_p
        _lib_cache.append(lib)
    return _lib_cache[0]


def fused_sgd_reference(params, grads, velocity, lr, momentum=0.0,
                        weight_decay=0.0, dampening=0.0, nesterov=False,
                        finite=None):
    """Plain version: the unfused math of ``SGD.update``
    (bigdl_tpu/optim/optim_method.py:135-147) leaf by leaf, written into
    ``params`` and ``velocity``; with ``momentum == 0`` the velocity is
    untouched.  ``finite`` (a bool tensor or None) keeps every leaf as it
    was where it is False."""
    with torch.no_grad():
        for p, g, v in zip(params, grads, velocity):
            if weight_decay != 0.0:
                g = g + weight_decay * p
            if momentum != 0.0:
                v_new = momentum * v + (1 - dampening) * g
                step = g + momentum * v_new if nesterov else v_new
            else:
                v_new, step = v, g
            p_new = p - lr * step
            if finite is not None:
                p_new = torch.where(finite, p_new, p)
                v_new = torch.where(finite, v_new, v)
            p.copy_(p_new)
            if momentum != 0.0:
                v.copy_(v_new)
    return params, velocity


def fused_sgd(params, grads, velocity, lr, momentum=0.0, weight_decay=0.0,
              dampening=0.0, nesterov=False, finite=None):
    """One momentum-SGD step over lists of leaves ``params``, ``grads``,
    ``velocity`` (f32, one shape per triple), in place; returns
    ``(params, velocity)``.  ``finite``: None, or a one-element bool
    tensor on the leaves' device; where it is False nothing changes."""
    dev = params[0].device
    if dev.type == "cpu":
        return fused_sgd_reference(params, grads, velocity, lr, momentum,
                                   weight_decay, dampening, nesterov, finite)
    if dev.type != "cuda":
        raise ValueError(f"fused_sgd: no kernel for device {dev}")
    _launch(params, grads, velocity, lr, momentum, weight_decay, dampening,
            nesterov, finite)
    return params, velocity


fused_sgd.launches = 0


def _leaf_table(params, grads, velocity):
    """(n_leaves, 6) int64 rows (p, g, v, n, first chunk, vec), and the
    number of chunks, after checking every leaf's device, dtype, layout
    and shapes."""
    if not (len(params) == len(grads) == len(velocity)) or not params:
        raise ValueError(f"fused_sgd: {len(params)} params, {len(grads)} "
                         f"grads, {len(velocity)} velocities")
    dev = params[0].device
    rows, first = [], 0
    for k, (p, g, v) in enumerate(zip(params, grads, velocity)):
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
        n = p.numel()
        vec = int(all(a % 16 == 0 for a in ptrs))
        rows.append((*ptrs, n, first, vec))
        first += -(-n // CHUNK)
    return np.asarray(rows, np.int64), first


def _device_table(params, grads, velocity):
    """(table on the card, n_leaves, n_chunks): the cached table when
    every leaf's pointers and sizes are those it was built for, else a new
    one, checked and uploaded."""
    key = (params[0].device, len(params), len(grads), len(velocity),
           *((p.data_ptr(), g.data_ptr(), v.data_ptr(),
              p.numel(), g.numel(), v.numel())
             for p, g, v in zip(params, grads, velocity)))
    hit = _tables.get(key)
    if hit is not None:
        return hit
    rows, n_chunks = _leaf_table(params, grads, velocity)
    if n_chunks >= 2**31:
        raise ValueError(f"fused_sgd: {n_chunks} chunks exceed one grid")
    # pinned and non-blocking: the host does not wait for the card; the
    # caching host allocator keeps the buffer until the copy has run
    table = torch.from_numpy(rows).pin_memory().to(params[0].device,
                                                   non_blocking=True)
    if len(_tables) >= _MAX_TABLES:
        del _tables[next(iter(_tables))]
    _tables[key] = (table, len(rows), n_chunks)
    return _tables[key]


def _launch(params, grads, velocity, lr, momentum, weight_decay, dampening,
            nesterov, finite):
    dev = params[0].device
    if finite is not None and (finite.device != dev
                               or finite.dtype != torch.bool
                               or finite.numel() != 1):
        raise ValueError(f"fused_sgd: finite must be one bool on {dev}, "
                         f"got {finite.dtype} {tuple(finite.shape)} on "
                         f"{finite.device}")
    table, n_leaves, n_chunks = _device_table(params, grads, velocity)
    if n_chunks == 0:
        return
    lib = _lib()
    err = lib.bigdl_fused_sgd_f32(
        table.data_ptr(), n_leaves, n_chunks, CHUNK, float(lr),
        float(momentum), float(weight_decay), float(dampening),
        int(bool(nesterov)),
        None if finite is None else finite.data_ptr(),
        *_build.device_stream(dev))
    if err != 0:
        raise RuntimeError("fused_sgd kernel launch failed: "
                           + lib.bigdl_cuda_error_string(err).decode())
    fused_sgd.launches += 1
