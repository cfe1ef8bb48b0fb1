"""Direction-batched LSTM recurrence over a hoisted input projection
(counterpart of bigdl_tpu/ops/pallas_kernels.py ``bilstm_recurrence``,
:664).

:func:`bilstm_recurrence` is the differentiable entry point: zx
(T, D, B, 4H), the projection plus bias of D directions (the backward
direction's input already flipped in time), and wht (D, H, 4H) give the h
stack (T, D, B, H) from h0, c0 (D, B, H) or h = c = 0, gates i, f, g, o
in that order; with ``with_last_c`` it also hands back the last step's c,
detached: the next chunk's c0 in a truncated run.  h0 and c0 are carried
states, taken as constants (the carried dc starts at 0 in every chunk).
Under autograd it runs :func:`bilstm_forward` with the c stack as a
residual beside zx, wht, hs, h0 and c0, and its backward is
:func:`bilstm_backward` (dzx, in reverse time, hprev and cprev h0 and c0
at t = 0) then :func:`bilstm_dwh` (dwht = sum_t hprev^T . dz); a forward
that needs no gradient writes no c stack unless it is asked for the last
c.  On CUDA tensors the
three wrappers launch the hand-written ``csrc/bilstm.cu`` kernels or
raise; on CPU tensors they run the plain versions beside them.  There is
no other path.  Each wrapper's ``launches`` counts its kernel calls only.

The serial forward and backward are cluster recurrences
(``csrc/recurrence_cluster.cuh``) whose plans :func:`plan` mirrors; the
forward is the one ``ops.lstm_scan`` launches.  The kernels run H <=
``MAX_HIDDEN``, the largest H whose forward and backward 16-block
clusters of one batch row fit shared memory, and a larger H raises
``NotImplementedError`` before any launch (the plain versions on the CPU
have no such limit).
"""
from __future__ import annotations

import torch

from bigdl_tpu_torch.ops import _build
from bigdl_tpu_torch.ops import _recurrence as rec

_KERNEL = "bilstm"

# (G, E, kHasC) of csrc/bilstm.cu's LstmFwd and LstmBwd cells, and the
# backward's V: it exchanges dz, four values a unit
FWD_CELL, BWD_CELL, BWD_VALUES = (4, 4, True), (1, 7, True), 4


def _cell(backward):
    return (BWD_CELL, BWD_VALUES) if backward else (FWD_CELL, 1)


def plan(nd, b, hdim, backward=False):
    """The forward's (or backward's) cluster plan at (D, B, H), as
    csrc/bilstm.cu's ``plan_of`` computes it: a dict of
    ``_recurrence.PLAN_FIELDS``."""
    cell, v = _cell(backward)
    return rec.cluster_plan(*cell, nd, b, hdim, v=v)


def smem_bytes(hdim, rows=1):
    """(forward, backward) shared memory of a block of ``rows`` batch rows
    in a 16-block cluster at H = ``hdim``, with wht read through L2 and
    the shallowest ring: the least any plan at ``rows`` needs."""
    return tuple(4 * rec.cluster_smem_floats(*cell, hdim, rows,
                                             rec.CLUSTER_SIZES[-1], False,
                                             rec.MIN_DEPTH, v)
                 for cell, v in map(_cell, (False, True)))


#: the largest H the kernels take (16-block clusters of one batch row)
MAX_HIDDEN = rec.max_hidden(smem_bytes)


def _setup(lib):
    # T D B H, then C R (0 0: the plan of the shape), device, stream
    lib.bigdl_lstm_fwd_f32.argtypes = [rec.VP] * 6 + rec.PLANNED_DIMS
    lib.bigdl_lstm_fwd_f32.restype = rec.I
    lib.bigdl_lstm_bwd_f32.argtypes = [rec.VP] * 8 + rec.PLANNED_DIMS
    lib.bigdl_lstm_bwd_f32.restype = rec.I
    lib.bigdl_lstm_dwh_f32.argtypes = ([rec.VP] * 5 + [rec.I] * 5
                                       + [rec.LL] + rec.DIMS[4:])
    lib.bigdl_lstm_dwh_f32.restype = rec.I
    lib.bigdl_lstm_plan.argtypes = [rec.I] * 4 + [rec.VP]
    lib.bigdl_lstm_plan.restype = None


def _lib():
    return rec.load(_KERNEL, _setup)


def kernel_plan(nd, b, hdim, backward=False):
    """The plan csrc/bilstm.cu itself computes (the library built and
    loaded), to hold :func:`plan` to it on the card."""
    return rec.kernel_plan(_lib().bigdl_lstm_plan, int(backward), nd, b,
                           hdim)


def _gates(z, hdim):
    """i, f, g, o activated: the four H-wide slices of z, in order."""
    return (torch.sigmoid(z[..., :hdim]), torch.sigmoid(z[..., hdim:2 * hdim]),
            torch.tanh(z[..., 2 * hdim:3 * hdim]),
            torch.sigmoid(z[..., 3 * hdim:]))


def bilstm_forward_reference(zx, wht, with_c=True, h0=None, c0=None):
    """Plain version of the forward: a loop over T with ``torch.matmul``
    from ``h0``, ``c0`` (zeros where None); ``(hs, cs)``, or ``hs`` alone
    when ``with_c`` is False."""
    t, nd, b, h4 = zx.shape
    hdim = h4 // 4
    h = zx.new_zeros(nd, b, hdim) if h0 is None else h0
    c = zx.new_zeros(nd, b, hdim) if c0 is None else c0
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


def bilstm_backward_reference(zx, wht, hs, cs, gout, h0=None, c0=None):
    """Plain version of the backward: dzx, from a reverse loop over T that
    recomputes the gates from zx[t] + hprev . wht (hprev, cprev h0, c0 or
    zeros at t = 0)."""
    hdim = wht.shape[1]
    hprev, cprev = rec.shift_prev(hs, h0), rec.shift_prev(cs, c0)
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


def bilstm_dwh_reference(hs, dzx, h0=None):
    """Plain version of the weight gradient: one einsum of the h stack
    read at t - 1 (h0 or zeros at t = 0) and dzx."""
    return torch.einsum("tdbk,tdbj->dkj", rec.shift_prev(hs, h0), dzx)


def bilstm_forward(zx, wht, with_c=True, h0=None, c0=None):
    """The recurrence over ``zx`` (T, D, B, 4H) f32 and ``wht`` (D, H, 4H)
    f32 from ``h0``, ``c0`` (D, B, H) f32 (zeros where None).  Returns
    ``(hs, cs)``, each (T, D, B, H), or ``hs`` alone when ``with_c`` is
    False."""
    if zx.device.type == "cpu":
        return bilstm_forward_reference(zx, wht, with_c, h0, c0)
    t, nd, b, hdim = _check_inputs(zx, wht)
    rec.check_states(_KERNEL, zx.device, (nd, b, hdim), h0=h0, c0=c0)
    hs = zx.new_empty(t, nd, b, hdim)
    cs = zx.new_empty(t, nd, b, hdim) if with_c else None
    _run("fwd", [zx, wht, h0, c0, hs, cs], t, nd, b, hdim)
    bilstm_forward.launches += 1
    return (hs, cs) if with_c else hs


def bilstm_backward(zx, wht, hs, cs, gout, h0=None, c0=None):
    """dzx (T, D, B, 4H) from the forward's ``zx``, ``wht``, ``hs``, ``cs``,
    ``h0`` and ``c0`` (zeros where None) and the cotangent ``gout`` of
    hs."""
    if zx.device.type == "cpu":
        return bilstm_backward_reference(zx, wht, hs, cs, gout, h0, c0)
    t, nd, b, hdim = _check_inputs(zx, wht)
    for v, name in ((hs, "hs"), (cs, "cs"), (gout, "gout")):
        _check(v, name, zx.device, (t, nd, b, hdim))
    rec.check_states(_KERNEL, zx.device, (nd, b, hdim), h0=h0, c0=c0)
    dzx = torch.empty_like(zx)
    _run("bwd", [zx, wht, hs, cs, h0, c0, gout, dzx], t, nd, b, hdim)
    bilstm_backward.launches += 1
    return dzx


def dwh_slices(t, b, hdim, nd):
    """(S, rows a slice) of the weight gradient's split over the
    time*batch axis (``ops._recurrence.dwh_slices`` at J = 4H)."""
    return rec.dwh_slices(t, b, hdim, 4 * hdim, nd)


def bilstm_dwh(hs, dzx, h0=None):
    """dwht (D, H, 4H) = sum over t and b of hprev^T . dz, from the h
    stack ``hs`` (T, D, B, H) read at t - 1, ``h0`` (or zeros) at t = 0,
    and ``dzx`` (T, D, B, 4H)."""
    if hs.device.type == "cpu":
        return bilstm_dwh_reference(hs, dzx, h0)
    rec.check_device(_KERNEL, hs)
    t, nd, b, h4 = dzx.shape
    hdim = h4 // 4
    _check(dzx, "dzx", hs.device, (t, nd, b, h4))
    _check(hs, "hs", hs.device, (t, nd, b, hdim))
    rec.check_states(_KERNEL, hs.device, (nd, b, hdim), h0=h0)
    s, rows = dwh_slices(t, b, hdim, nd)
    part = hs.new_empty(s, nd, hdim, h4)
    dwht = hs.new_empty(nd, hdim, h4)
    lib = _lib()
    err = lib.bigdl_lstm_dwh_f32(hs.data_ptr(), rec.ptr(h0),
                                 dzx.data_ptr(), part.data_ptr(),
                                 dwht.data_ptr(), t, nd, b, hdim, s, rows,
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


def _run(which, tensors, t, nd, b, hdim, kernel=_KERNEL):
    """One launch of the forward (``fwd``) or backward entry under the
    plan of the shape; ``kernel`` names the wrapper in an error."""
    lib = _lib()
    fn = lib.bigdl_lstm_fwd_f32 if which == "fwd" else lib.bigdl_lstm_bwd_f32
    ptrs = [rec.ptr(v) for v in tensors]
    err = fn(*ptrs, t, nd, b, hdim, 0, 0,
             *_build.device_stream(tensors[0].device))
    rec.raise_on(lib, err, kernel, which, hdim)


class _BiLSTM(torch.autograd.Function):
    """The recurrence whose residuals are zx, wht, hs and cs (the JAX
    ``bilstm_recurrence`` custom VJP), and the constants h0 and c0; its
    second output, the last step's c, takes no gradient."""

    @staticmethod
    def forward(ctx, zx, wht, h0, c0):
        hs, cs = bilstm_forward(zx, wht, h0=h0, c0=c0)
        ctx.save_for_backward(zx, wht, hs, cs, h0, c0)
        last_c = cs[-1].clone()
        ctx.mark_non_differentiable(last_c)
        return hs, last_c

    @staticmethod
    def backward(ctx, gout, _):
        zx, wht, hs, cs, h0, c0 = ctx.saved_tensors
        dzx = bilstm_backward(zx, wht, hs, cs, gout.contiguous(), h0, c0)
        return dzx, bilstm_dwh(hs, dzx, h0), None, None


def bilstm_recurrence(zx, wht, h0=None, c0=None, with_last_c=False):
    """The h stack (T, D, B, H) of the LSTM recurrence over ``zx``
    (T, D, B, 4H) and ``wht`` (D, H, 4H) from ``h0``, ``c0`` (D, B, H) or
    zeros, differentiable in zx and wht; h0 and c0 are taken as
    constants.  With ``with_last_c``, ``(hs, c)``: the last step's c
    (D, B, H), detached.  A forward that needs no gradient writes no c
    stack unless it is asked for c."""
    h0, c0 = (None if v is None else v.detach() for v in (h0, c0))
    if torch.is_grad_enabled() and (zx.requires_grad or wht.requires_grad):
        hs, last_c = _BiLSTM.apply(zx, wht, h0, c0)
    elif with_last_c:
        hs, cs = bilstm_forward(zx, wht, h0=h0, c0=c0)
        last_c = cs[-1]
    else:
        return bilstm_forward(zx, wht, with_c=False, h0=h0, c0=c0)
    return (hs, last_c) if with_last_c else hs
