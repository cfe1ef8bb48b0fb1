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

The recurrence blocks keep their 8 batch rows' state in shared memory,
which grows with H: the kernels run H <= ``MAX_HIDDEN`` (558), and a
larger H raises ``NotImplementedError`` before any launch (the plain
versions on the CPU have no such limit).
"""
from __future__ import annotations

import ctypes

import torch

from bigdl_tpu_torch.ops import _build

_VP = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_DIMS = [_I, _I, _I, _I, _I, _VP]  # T D B H, device, stream
_lib_cache = []
# csrc/bilstm.cu's kRows, kThreads and kMaxSmem (a block's shared memory
# on sm_90, bytes)
_ROWS, _THREADS, _MAX_SMEM = 8, 512, 232448


def _groups(m, n):
    """csrc/bilstm.cu ``groups``: the split of an m-long reduction of an
    n-wide product across a recurrence block."""
    return 1 if n >= _THREADS else min(_THREADS // n, m)


def smem_bytes(hdim):
    """(forward, backward) shared memory of a recurrence block at H =
    ``hdim``, as csrc/bilstm.cu's ``fwd_smem_floats``/``bwd_smem_floats``
    size it."""
    g_f, g_b = _groups(hdim, 4 * hdim), _groups(4 * hdim, hdim)
    fwd = _ROWS * 10 * hdim + (g_f * _ROWS * 4 * hdim if g_f > 1 else 0)
    bwd = _ROWS * 13 * hdim + (g_b * _ROWS * hdim if g_b > 1 else 0)
    return 4 * fwd, 4 * bwd


# the largest H whose blocks fit; every smaller H fits too (tested)
MAX_HIDDEN = max(h for h in range(1, 4096)
                 if max(smem_bytes(h)) <= _MAX_SMEM)


def _lib() -> ctypes.CDLL:
    if not _lib_cache:
        lib = _build.load("bilstm")
        lib.bigdl_lstm_fwd_f32.argtypes = [_VP] * 4 + _DIMS
        lib.bigdl_lstm_fwd_f32.restype = _I
        lib.bigdl_lstm_bwd_f32.argtypes = [_VP] * 7 + _DIMS
        lib.bigdl_lstm_bwd_f32.restype = _I
        lib.bigdl_lstm_dwh_f32.argtypes = ([_VP] * 4 + [_I] * 5 + [_LL]
                                           + _DIMS[4:])
        lib.bigdl_lstm_dwh_f32.restype = _I
        lib.bigdl_cuda_error_string.argtypes = [_I]
        lib.bigdl_cuda_error_string.restype = ctypes.c_char_p
        _lib_cache.append(lib)
    return _lib_cache[0]


def _gates(z, hdim):
    """i, f, g, o activated: the four H-wide slices of z, in order."""
    return (torch.sigmoid(z[..., :hdim]), torch.sigmoid(z[..., hdim:2 * hdim]),
            torch.tanh(z[..., 2 * hdim:3 * hdim]),
            torch.sigmoid(z[..., 3 * hdim:]))


def _shift_prev(xs):
    """xs[t] -> xs[t-1] along time, zeros at t = 0 (the initial state)."""
    return torch.cat([torch.zeros_like(xs[:1]), xs[:-1]])


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
    hprev, cprev = _shift_prev(hs), _shift_prev(cs)
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
    return torch.einsum("tdbk,tdbj->dkj", _shift_prev(hs), dzx)


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
    time*batch axis: enough 64x64 output tiles to give two waves of
    blocks on 132 SMs, slices a multiple of 16 rows; a function of the
    shape alone, so the sum's order is too."""
    rows = t * b
    if rows == 0 or nd * hdim == 0:
        return 1, 16
    tiles = nd * -(-hdim // 64) * -(-4 * hdim // 64)
    s = max(1, min(-(-264 // tiles), -(-rows // 64)))
    per = -(-rows // s)
    per = -(-per // 16) * 16
    return -(-rows // per), per


def bilstm_dwh(hs, dzx):
    """dwht (D, H, 4H) = sum over t and b of hprev^T . dz, from the h
    stack ``hs`` (T, D, B, H) and ``dzx`` (T, D, B, 4H)."""
    if hs.device.type == "cpu":
        return bilstm_dwh_reference(hs, dzx)
    if hs.device.type != "cuda":
        raise ValueError(f"bilstm: no kernel for device {hs.device}")
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
    _raise_on(err, "dwh", hdim)
    bilstm_dwh.launches += 1
    return dwht


bilstm_forward.launches = 0
bilstm_backward.launches = 0
bilstm_dwh.launches = 0


def _check(v, name, device, shape):
    if v.device != device:
        raise ValueError(f"bilstm: {name} on {v.device}, expected {device}")
    if v.dtype != torch.float32:
        raise TypeError(f"bilstm: {name} must be float32, got {v.dtype}")
    if tuple(v.shape) != tuple(shape) or not v.is_contiguous():
        raise ValueError(f"bilstm: {name} must be a contiguous "
                         f"{tuple(shape)} tensor, got {tuple(v.shape)}")


def _check_inputs(zx, wht):
    if zx.dim() != 4 or zx.shape[-1] % 4:
        raise ValueError(f"bilstm: zx must be (T, D, B, 4H), got "
                         f"{tuple(zx.shape)}")
    t, nd, b, h4 = zx.shape
    if h4 // 4 > MAX_HIDDEN:
        raise NotImplementedError(
            f"bilstm: H={h4 // 4} needs {max(smem_bytes(h4 // 4))} bytes of "
            f"shared memory a block, more than the card's {_MAX_SMEM}; the "
            f"recurrence kernels run H <= {MAX_HIDDEN} (ROADMAP, queue 3)")
    if zx.device.type != "cuda":
        raise ValueError(f"bilstm: no kernel for device {zx.device}")
    _check(zx, "zx", zx.device, (t, nd, b, h4))
    _check(wht, "wht", zx.device, (nd, h4 // 4, h4))
    return t, nd, b, h4 // 4


def _run(which, tensors, t, nd, b, hdim):
    lib = _lib()
    fn = lib.bigdl_lstm_fwd_f32 if which == "fwd" else lib.bigdl_lstm_bwd_f32
    ptrs = [None if v is None else v.data_ptr() for v in tensors]
    err = fn(*ptrs, t, nd, b, hdim, *_build.device_stream(tensors[0].device))
    _raise_on(err, which, hdim)


def _raise_on(err, which, hdim):
    if err != 0:
        msg = _lib().bigdl_cuda_error_string(err).decode()
        raise RuntimeError(f"bilstm {which} kernel launch failed at "
                           f"H={hdim}: {msg}")


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
