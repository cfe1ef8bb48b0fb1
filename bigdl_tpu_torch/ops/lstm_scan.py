"""Forward-only, single-direction LSTM from a given state (counterpart of
bigdl_tpu/ops/pallas_kernels.py ``lstm_scan``, :148).

:func:`lstm_scan` follows the JAX contract: zx (T, B, 4H), the input
projection with its bias added, wht (H, 4H) and the state h0, c0 (B, H)
give the h stack (T, B, H), gates i, f, g, o in that order.  It takes no
gradient (the JAX kernel has no VJP): validation and inference of a
``Recurrent(LSTMCell)`` (``nn/recurrent.py``) run it, training keeps
``bilstm_recurrence``.  On a CUDA tensor it launches the hand-written
``csrc/lstm_scan.cu`` kernel or raises; on a CPU tensor it runs
:func:`lstm_scan_reference`, the plain step loop.  ``lstm_scan.launches``
counts kernel launches only.  The block follows the row rule of
``ops._recurrence`` over its one (forward) block: H <= ``MAX_HIDDEN``
(5,811), a larger H is refused before a launch.
"""
from __future__ import annotations

import torch

from bigdl_tpu_torch.ops import _build
from bigdl_tpu_torch.ops import _recurrence as rec
from bigdl_tpu_torch.ops.bilstm import _gates

_KERNEL = "lstm_scan"


def smem_bytes(hdim, rows=8):
    """(bytes,) of the block of ``rows`` batch rows at H = ``hdim``, as
    csrc/lstm_scan.cu's ``scan_smem_floats`` sizes it: bilstm.cu's forward
    block, and no backward block beside it."""
    g = rec.groups(hdim, 4 * hdim)
    return (4 * (rows * 10 * hdim + (g * rows * 4 * hdim if g > 1 else 0)),)


def rows_for(hdim):
    """The batch rows of the block at H = ``hdim``."""
    return rec.rows_for(hdim, smem_bytes)


#: the largest H the kernel takes (one batch row a block)
MAX_HIDDEN = rec.max_hidden(smem_bytes)


def _setup(lib):
    lib.bigdl_lstm_scan_f32.argtypes = [rec.VP] * 5 + [rec.I] * 3 + [rec.I,
                                                                     rec.VP]
    lib.bigdl_lstm_scan_f32.restype = rec.I


def lstm_scan_reference(zx, wht, h0, c0):
    """Plain version: a loop over T with ``torch.matmul``."""
    hdim = wht.shape[0]
    h, c, hs = h0, c0, []
    for step in range(zx.shape[0]):
        i, f, g, o = _gates(zx[step] + torch.matmul(h, wht), hdim)
        c = f * c + i * g
        h = o * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs) if hs else zx.new_zeros(0, zx.shape[1], hdim)


@torch.no_grad()
def lstm_scan(zx, wht, h0, c0):
    """The h stack (T, B, H) over ``zx`` (T, B, 4H) f32 and ``wht``
    (H, 4H) f32 from ``h0``, ``c0`` (B, H) f32.  No gradient flows
    through it."""
    if zx.device.type == "cpu":
        return lstm_scan_reference(zx, wht, h0, c0)
    if zx.dim() != 3 or zx.shape[-1] % 4:
        raise ValueError(f"lstm_scan: zx must be (T, B, 4H), got "
                         f"{tuple(zx.shape)}")
    t, b, h4 = zx.shape
    hdim = h4 // 4
    rec.check_hidden(_KERNEL, hdim, MAX_HIDDEN, smem_bytes)
    rec.check_device(_KERNEL, zx)
    for v, name, shape in ((zx, "zx", (t, b, h4)), (wht, "wht", (hdim, h4)),
                           (h0, "h0", (b, hdim)), (c0, "c0", (b, hdim))):
        rec.check(_KERNEL, v, name, zx.device, shape)
    hs = zx.new_empty(t, b, hdim)
    lib = rec.load(_KERNEL, _setup)
    err = lib.bigdl_lstm_scan_f32(zx.data_ptr(), wht.data_ptr(),
                                  h0.data_ptr(), c0.data_ptr(),
                                  hs.data_ptr(), t, b, hdim,
                                  *_build.device_stream(zx.device))
    rec.raise_on(lib, err, _KERNEL, "fwd", hdim)
    lstm_scan.launches += 1
    return hs


lstm_scan.launches = 0
