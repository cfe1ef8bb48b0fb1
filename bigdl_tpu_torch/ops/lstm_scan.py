"""Forward-only, single-direction LSTM from a given state (counterpart of
bigdl_tpu/ops/pallas_kernels.py ``lstm_scan``, :148).

:func:`lstm_scan` follows the JAX contract: zx (T, B, 4H), the input
projection with its bias added, wht (H, 4H) and the state h0, c0 (B, H)
give the h stack (T, B, H), gates i, f, g, o in that order.  It takes no
gradient (the JAX kernel has no VJP): validation and inference of a
``Recurrent(LSTMCell)`` (``nn/recurrent.py``) run it, training keeps
``bilstm_recurrence``.  On a CUDA tensor it launches the hand-written
forward of ``csrc/bilstm.cu`` from h0 and c0 at D = 1, the kernel that
``bilstm_forward`` launches from zero state, or raises; on a CPU tensor
it runs :func:`lstm_scan_reference`, the plain step loop.
``lstm_scan.launches`` counts its own kernel launches only.  The kernel
is a cluster recurrence (``csrc/recurrence_cluster.cuh``) whose plan
:func:`plan` mirrors: H <= ``MAX_HIDDEN``, a larger H is refused before
a launch.
"""
from __future__ import annotations

import torch

from bigdl_tpu_torch.ops import _recurrence as rec
from bigdl_tpu_torch.ops import bilstm
from bigdl_tpu_torch.ops.bilstm import _gates

_KERNEL = "lstm_scan"


# (G, E, kHasC) of csrc/bilstm.cu's LstmFwd cell
CELL = bilstm.FWD_CELL


def plan(b, hdim):
    """The cluster plan at (B, H): ``bilstm.plan`` of the forward at D =
    1, a dict of ``_recurrence.PLAN_FIELDS``."""
    return bilstm.plan(1, b, hdim)


def smem_bytes(hdim, rows=1):
    """(bytes,) of a block of ``rows`` batch rows in a 16-block cluster at
    H = ``hdim``, with wht read through L2 and the shallowest ring: the
    least any plan at ``rows`` needs."""
    return (4 * rec.cluster_smem_floats(*CELL, hdim, rows,
                                        rec.CLUSTER_SIZES[-1], False,
                                        rec.MIN_DEPTH),)


#: the largest H the kernel takes (a 16-block cluster of one batch row)
MAX_HIDDEN = rec.max_hidden(smem_bytes)


def kernel_plan(b, hdim):
    """The plan csrc/bilstm.cu itself computes for the forward at D = 1
    (the library built and loaded), to hold :func:`plan` to it on the
    card."""
    return bilstm.kernel_plan(1, b, hdim)


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
    bilstm._run("fwd", [zx, wht, h0, c0, hs, None], t, 1, b, hdim,
                kernel=_KERNEL)
    lstm_scan.launches += 1
    return hs


lstm_scan.launches = 0
