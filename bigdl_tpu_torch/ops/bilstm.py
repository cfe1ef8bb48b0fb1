"""Direction-batched LSTM recurrence over a hoisted input projection
(counterpart of bigdl_tpu/ops/pallas_kernels.py ``bilstm_recurrence``,
:664).

:func:`bilstm_recurrence` is the differentiable entry point: zx
(T, D, B, 4H), the projection plus bias of D directions (the backward
direction's input already flipped in time), and wht (D, H, 4H) give the h
stack (T, D, B, H) from h = c = 0, gates i, f, g, o in that order.  Under
autograd it runs :func:`bilstm_forward` with the c stack as a residual
beside zx, wht and hs, and its backward is :func:`bilstm_backward` (dzx,
in reverse time) then :func:`bilstm_dwh` (dwht = sum_t hprev^T . dz); a
forward that needs no gradient writes no c stack.  On CUDA tensors the
three wrappers launch the hand-written ``csrc/bilstm.cu`` kernels or
raise; on CPU tensors they run the plain versions beside them.  There is
no other path.  Each wrapper's ``launches`` counts its kernel calls only.

The recurrence blocks keep their batch rows' state in shared memory:
8 rows up to H = 558, then 4, 2 and 1 as H grows (the row rule of
``ops._recurrence``), so the kernels run H <= ``MAX_HIDDEN`` (4,470) and
a larger H raises ``NotImplementedError`` before any launch (the plain
versions on the CPU have no such limit).
"""
from __future__ import annotations

import torch

from bigdl_tpu_torch.ops import _build
from bigdl_tpu_torch.ops import _recurrence as rec

_KERNEL = "bilstm"


def smem_bytes(hdim, rows=8):
    """(forward, backward) shared memory of a recurrence block of
    ``rows`` batch rows at H = ``hdim``, as csrc/bilstm.cu's
    ``fwd_smem_floats``/``bwd_smem_floats`` size it."""
    g_f, g_b = rec.groups(hdim, 4 * hdim), rec.groups(4 * hdim, hdim)
    fwd = rows * 10 * hdim + (g_f * rows * 4 * hdim if g_f > 1 else 0)
    bwd = rows * 13 * hdim + (g_b * rows * hdim if g_b > 1 else 0)
    return 4 * fwd, 4 * bwd


def rows_for(hdim):
    """The batch rows of a recurrence block at H = ``hdim``."""
    return rec.rows_for(hdim, smem_bytes)


#: the largest H the kernels take (one batch row a block)
MAX_HIDDEN = rec.max_hidden(smem_bytes)


def _setup(lib):
    lib.bigdl_lstm_fwd_f32.argtypes = [rec.VP] * 4 + rec.DIMS
    lib.bigdl_lstm_fwd_f32.restype = rec.I
    lib.bigdl_lstm_bwd_f32.argtypes = [rec.VP] * 7 + rec.DIMS
    lib.bigdl_lstm_bwd_f32.restype = rec.I
    lib.bigdl_lstm_dwh_f32.argtypes = ([rec.VP] * 4 + [rec.I] * 5
                                       + [rec.LL] + rec.DIMS[4:])
    lib.bigdl_lstm_dwh_f32.restype = rec.I


def _lib():
    return rec.load(_KERNEL, _setup)


def _gates(z, hdim):
    """i, f, g, o activated: the four H-wide slices of z, in order."""
    return (torch.sigmoid(z[..., :hdim]), torch.sigmoid(z[..., hdim:2 * hdim]),
            torch.tanh(z[..., 2 * hdim:3 * hdim]),
            torch.sigmoid(z[..., 3 * hdim:]))


def bilstm_forward_reference(zx, wht, with_c=True):
    """Plain version of the forward: a loop over T with ``torch.matmul``;
    ``(hs, cs)``, or ``hs`` alone when ``with_c`` is False."""
    t, nd, b, h4 = zx.shape
    hdim = h4 // 4
    h = zx.new_zeros(nd, b, hdim)
    c = zx.new_zeros(nd, b, hdim)
    hs, cs = [], []
    for step in range(t):
        i, f, g, o = _gates(zx[step] + torch.matmul(h, wht), hdim)
        c = f * c + i * g
        h = o * torch.tanh(c)
        hs.append(h)
        cs.append(c)
    hs = torch.stack(hs) if hs else zx.new_zeros(0, nd, b, hdim)
    cs = torch.stack(cs) if cs else zx.new_zeros(0, nd, b, hdim)
    return (hs, cs) if with_c else hs


def bilstm_backward_reference(zx, wht, hs, cs, gout):
    """Plain version of the backward: dzx, from a reverse loop over T that
    recomputes the gates from zx[t] + hprev . wht."""
    hdim = wht.shape[1]
    hprev, cprev = rec.shift_prev(hs), rec.shift_prev(cs)
    dh = zx.new_zeros(hs.shape[1:])
    dc = zx.new_zeros(hs.shape[1:])
    dzx = torch.empty_like(zx)
    wh = wht.transpose(1, 2)
    for step in reversed(range(zx.shape[0])):
        i, f, g, o = _gates(zx[step] + torch.matmul(hprev[step], wht), hdim)
        tc = torch.tanh(cs[step])
        dh_tot = gout[step] + dh
        dc_tot = dc + dh_tot * o * (1.0 - tc * tc)
        dz = torch.cat([dc_tot * g * i * (1.0 - i),
                        dc_tot * cprev[step] * f * (1.0 - f),
                        dc_tot * i * (1.0 - g * g),
                        dh_tot * tc * o * (1.0 - o)], dim=-1)
        dzx[step] = dz
        dh = torch.matmul(dz, wh)
        dc = dc_tot * f
    return dzx


def bilstm_dwh_reference(hs, dzx):
    """Plain version of the weight gradient: one einsum of the h stack
    read at t - 1 and dzx."""
    return torch.einsum("tdbk,tdbj->dkj", rec.shift_prev(hs), dzx)


def bilstm_forward(zx, wht, with_c=True):
    """The recurrence over ``zx`` (T, D, B, 4H) f32 and ``wht`` (D, H, 4H)
    f32.  Returns ``(hs, cs)``, each (T, D, B, H), or ``hs`` alone when
    ``with_c`` is False."""
    if zx.device.type == "cpu":
        return bilstm_forward_reference(zx, wht, with_c)
    t, nd, b, hdim = _check_inputs(zx, wht)
    hs = zx.new_empty(t, nd, b, hdim)
    cs = zx.new_empty(t, nd, b, hdim) if with_c else None
    _run("fwd", [zx, wht, hs, cs], t, nd, b, hdim)
    bilstm_forward.launches += 1
    return (hs, cs) if with_c else hs


def bilstm_backward(zx, wht, hs, cs, gout):
    """dzx (T, D, B, 4H) from the forward's ``zx``, ``wht``, ``hs`` and
    ``cs`` and the cotangent ``gout`` of hs."""
    if zx.device.type == "cpu":
        return bilstm_backward_reference(zx, wht, hs, cs, gout)
    t, nd, b, hdim = _check_inputs(zx, wht)
    for v, name in ((hs, "hs"), (cs, "cs"), (gout, "gout")):
        _check(v, name, zx.device, (t, nd, b, hdim))
    dzx = torch.empty_like(zx)
    wh = zx.new_empty(nd, 4 * hdim, hdim)   # scratch: wht^T
    _run("bwd", [zx, wht, hs, cs, gout, dzx, wh], t, nd, b, hdim)
    bilstm_backward.launches += 1
    return dzx


def dwh_slices(t, b, hdim, nd):
    """(S, rows a slice) of the weight gradient's split over the
    time*batch axis (``ops._recurrence.dwh_slices`` at J = 4H)."""
    return rec.dwh_slices(t, b, hdim, 4 * hdim, nd)


def bilstm_dwh(hs, dzx):
    """dwht (D, H, 4H) = sum over t and b of hprev^T . dz, from the h
    stack ``hs`` (T, D, B, H) and ``dzx`` (T, D, B, 4H)."""
    if hs.device.type == "cpu":
        return bilstm_dwh_reference(hs, dzx)
    rec.check_device(_KERNEL, hs)
    t, nd, b, h4 = dzx.shape
    hdim = h4 // 4
    _check(dzx, "dzx", hs.device, (t, nd, b, h4))
    _check(hs, "hs", hs.device, (t, nd, b, hdim))
    s, rows = dwh_slices(t, b, hdim, nd)
    part = hs.new_empty(s, nd, hdim, h4)
    dwht = hs.new_empty(nd, hdim, h4)
    lib = _lib()
    err = lib.bigdl_lstm_dwh_f32(hs.data_ptr(), dzx.data_ptr(),
                                 part.data_ptr(), dwht.data_ptr(), t, nd, b,
                                 hdim, s, rows,
                                 *_build.device_stream(hs.device))
    rec.raise_on(lib, err, _KERNEL, "dwh", hdim)
    bilstm_dwh.launches += 1
    return dwht


bilstm_forward.launches = 0
bilstm_backward.launches = 0
bilstm_dwh.launches = 0


def _check(v, name, device, shape):
    rec.check(_KERNEL, v, name, device, shape)


def _check_inputs(zx, wht):
    if zx.dim() != 4 or zx.shape[-1] % 4:
        raise ValueError(f"bilstm: zx must be (T, D, B, 4H), got "
                         f"{tuple(zx.shape)}")
    t, nd, b, h4 = zx.shape
    rec.check_hidden(_KERNEL, h4 // 4, MAX_HIDDEN, smem_bytes)
    rec.check_device(_KERNEL, zx)
    _check(zx, "zx", zx.device, (t, nd, b, h4))
    _check(wht, "wht", zx.device, (nd, h4 // 4, h4))
    return t, nd, b, h4 // 4


def _run(which, tensors, t, nd, b, hdim):
    lib = _lib()
    fn = lib.bigdl_lstm_fwd_f32 if which == "fwd" else lib.bigdl_lstm_bwd_f32
    ptrs = [None if v is None else v.data_ptr() for v in tensors]
    err = fn(*ptrs, t, nd, b, hdim, *_build.device_stream(tensors[0].device))
    rec.raise_on(lib, err, _KERNEL, which, hdim)


class _BiLSTM(torch.autograd.Function):
    """The recurrence whose residuals are zx, wht, hs and cs (the JAX
    ``bilstm_recurrence`` custom VJP)."""

    @staticmethod
    def forward(ctx, zx, wht):
        hs, cs = bilstm_forward(zx, wht)
        ctx.save_for_backward(zx, wht, hs, cs)
        return hs

    @staticmethod
    def backward(ctx, gout):
        zx, wht, hs, cs = ctx.saved_tensors
        dzx = bilstm_backward(zx, wht, hs, cs, gout.contiguous())
        return dzx, bilstm_dwh(hs, dzx)


def bilstm_recurrence(zx, wht):
    """The h stack (T, D, B, H) of the LSTM recurrence over ``zx``
    (T, D, B, 4H) and ``wht`` (D, H, 4H), differentiable in both; a
    forward that needs no gradient writes no c stack."""
    if torch.is_grad_enabled() and (zx.requires_grad or wht.requires_grad):
        return _BiLSTM.apply(zx, wht)
    return bilstm_forward(zx, wht, with_c=False)
