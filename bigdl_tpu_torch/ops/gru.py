"""Direction-batched GRU recurrence over hoisted input projections
(counterpart of bigdl_tpu/ops/pallas_kernels.py ``gru_recurrence``,
:857).

:func:`gru_recurrence` is the differentiable entry point: zrz
(T, D, B, 2H) and zn (T, D, B, H), the projections plus biases of D
directions, and wrz (D, H, 2H) and wh (D, H, H) give the h stack
(T, D, B, H) from h0 (D, B, H), a truncated run's carried state taken as
a constant, or h = 0:

    r, z = sig(zrz[t] + h . wrz),  n = tanh(zn[t] + (r o h) . wh),
    h' = (1 - z) n + z h

(``_gru_gates``/``_gru_fwd_kernel``).  Under autograd it runs
:func:`gru_forward` with its inputs, h0 and hs as residuals (the JAX
``_gru_vjp_fwd``), and its backward is :func:`gru_backward` (dzrz and
dzn in reverse time, r, z and n recomputed from the h stack, hprev h0 at
t = 0, and the r o hprev stack) then :func:`gru_dwh` (dwrz = sum_t
hprev^T . dzrz, dwh = sum_t (r o hprev)^T . dzn).  On CUDA tensors the
three wrappers launch the hand-written ``csrc/gru.cu`` kernels or raise;
on CPU tensors they run the plain versions beside them.  Each wrapper's
``launches`` counts its kernel calls only.

The serial forward and backward are two-phase cluster recurrences
(``csrc/recurrence_cluster.cuh``) whose plans :func:`plan` mirrors.  The
kernels run H <= ``MAX_HIDDEN``, the largest H whose forward and
backward 16-block clusters of one batch row fit shared memory, and a
larger H raises ``NotImplementedError`` before any launch (the plain
versions on the CPU have no such limit).
"""
from __future__ import annotations

import torch

from bigdl_tpu_torch.ops import _build
from bigdl_tpu_torch.ops import _recurrence as rec

_KERNEL = "gru"


# (G, E, local values) and V of csrc/gru.cu's GruFwd and GruBwd cells'
# phase 0, and (G, V) of their phase 1: the forward exchanges r o h, then
# h; the backward dn, then dr and dz (two values a unit)
FWD_CELL, FWD_VALUES, FWD_PHASE1 = (2, 3, 2), 1, (1, 1)
BWD_CELL, BWD_VALUES, BWD_PHASE1 = (1, 5, 2), 1, (1, 2)


def _cell(backward):
    return ((BWD_CELL, dict(v=BWD_VALUES, phase1=BWD_PHASE1)) if backward
            else (FWD_CELL, dict(v=FWD_VALUES, phase1=FWD_PHASE1)))


def plan(nd, b, hdim, backward=False):
    """The forward's (or backward's) cluster plan at (D, B, H), as
    csrc/gru.cu's ``plan_of`` computes it: a dict of
    ``_recurrence.PLAN_FIELDS``."""
    cell, kw = _cell(backward)
    return rec.cluster_plan(*cell, nd, b, hdim, **kw)


def smem_bytes(hdim, rows=1):
    """(forward, backward) shared memory of a block of ``rows`` batch rows
    in a 16-block cluster at H = ``hdim``, with the weights read through
    L2 and the shallowest ring: the least any plan at ``rows`` needs."""
    return tuple(4 * rec.cluster_smem_floats(*cell, hdim, rows,
                                             rec.CLUSTER_SIZES[-1], False,
                                             rec.MIN_DEPTH, **kw)
                 for cell, kw in map(_cell, (False, True)))


#: the largest H the kernels take (16-block clusters of one batch row)
MAX_HIDDEN = rec.max_hidden(smem_bytes)


def _setup(lib):
    # T D B H, then C R (0 0: the plan of the shape), device, stream
    lib.bigdl_gru_fwd_f32.argtypes = [rec.VP] * 6 + rec.PLANNED_DIMS
    lib.bigdl_gru_fwd_f32.restype = rec.I
    lib.bigdl_gru_bwd_f32.argtypes = [rec.VP] * 10 + rec.PLANNED_DIMS
    lib.bigdl_gru_bwd_f32.restype = rec.I
    lib.bigdl_gru_dwh_f32.argtypes = ([rec.VP] * 8 + [rec.I] * 5
                                      + [rec.LL, rec.I, rec.LL]
                                      + rec.DIMS[4:])
    lib.bigdl_gru_dwh_f32.restype = rec.I
    lib.bigdl_gru_plan.argtypes = [rec.I] * 4 + [rec.VP]
    lib.bigdl_gru_plan.restype = None


def _lib():
    return rec.load(_KERNEL, _setup)


def kernel_plan(nd, b, hdim, backward=False):
    """The plan csrc/gru.cu itself computes (the library built and
    loaded), to hold :func:`plan` to it on the card."""
    return rec.kernel_plan(_lib().bigdl_gru_plan, int(backward), nd, b, hdim)


def _gates(zrz_t, zn_t, h, wrz, wh):
    """r, z and n of one step from the carried h (``_gru_gates``)."""
    hdim = h.shape[-1]
    rz = torch.sigmoid(zrz_t + torch.matmul(h, wrz))
    r, z = rz[..., :hdim], rz[..., hdim:]
    return r, z, torch.tanh(zn_t + torch.matmul(r * h, wh))


def gru_forward_reference(zrz, zn, wrz, wh, h0=None):
    """Plain version of the forward: a loop over T with ``torch.matmul``
    from ``h0`` (zeros when None)."""
    t, nd, b, hdim = zn.shape
    h = zn.new_zeros(nd, b, hdim) if h0 is None else h0
    hs = []
    for step in range(t):
        _, z, n = _gates(zrz[step], zn[step], h, wrz, wh)
        h = (1.0 - z) * n + z * h
        hs.append(h)
    return torch.stack(hs) if hs else zn.new_zeros(0, nd, b, hdim)


def gru_backward_reference(zrz, zn, wrz, wh, hs, gout, h0=None):
    """Plain version of the backward (``_gru_bwd_kernel``): (dzrz, dzn,
    rh) from a reverse loop over T that recomputes r, z and n from
    zrz[t], zn[t] and hprev (h0 or zeros at t = 0); rh is the r o hprev
    stack."""
    hprev = rec.shift_prev(hs, h0)
    dh = hs.new_zeros(hs.shape[1:])
    dzrz, dzn, rh = torch.empty_like(zrz), torch.empty_like(zn), \
        torch.empty_like(hs)
    wh_t, wrz_t = wh.transpose(1, 2), wrz.transpose(1, 2)
    for step in reversed(range(hs.shape[0])):
        hp = hprev[step]
        r, z, n = _gates(zrz[step], zn[step], hp, wrz, wh)
        dh_tot = gout[step] + dh
        dz = dh_tot * (hp - n)
        dn = dh_tot * (1.0 - z) * (1.0 - n * n)
        drh = torch.matmul(dn, wh_t)
        d_rz = torch.cat([drh * hp * r * (1.0 - r), dz * z * (1.0 - z)],
                         dim=-1)
        dzrz[step], dzn[step], rh[step] = d_rz, dn, r * hp
        dh = dh_tot * z + drh * r + torch.matmul(d_rz, wrz_t)
    return dzrz, dzn, rh


def gru_dwh_reference(hs, rh, dzrz, dzn, h0=None):
    """Plain version of the weight gradients: dwrz from the h stack read
    at t - 1 (h0 or zeros at t = 0) and dzrz, dwh from the r o hprev stack
    and dzn."""
    return (torch.einsum("tdbk,tdbj->dkj", rec.shift_prev(hs, h0), dzrz),
            torch.einsum("tdbk,tdbj->dkj", rh, dzn))


def gru_forward(zrz, zn, wrz, wh, h0=None):
    """The h stack (T, D, B, H) over ``zrz`` (T, D, B, 2H), ``zn``
    (T, D, B, H), ``wrz`` (D, H, 2H) and ``wh`` (D, H, H) from ``h0``
    (D, B, H) or zeros, all f32."""
    if zn.device.type == "cpu":
        return gru_forward_reference(zrz, zn, wrz, wh, h0)
    t, nd, b, hdim = _check_inputs(zrz, zn, wrz, wh)
    rec.check_states(_KERNEL, zn.device, (nd, b, hdim), h0=h0)
    hs = zn.new_empty(t, nd, b, hdim)
    lib = _lib()
    err = lib.bigdl_gru_fwd_f32(zrz.data_ptr(), zn.data_ptr(),
                                wrz.data_ptr(), wh.data_ptr(), rec.ptr(h0),
                                hs.data_ptr(), t, nd, b, hdim, 0, 0,
                                *_build.device_stream(zn.device))
    rec.raise_on(lib, err, _KERNEL, "fwd", hdim)
    gru_forward.launches += 1
    return hs


def gru_backward(zrz, zn, wrz, wh, hs, gout, h0=None):
    """(dzrz (T, D, B, 2H), dzn (T, D, B, H), rh (T, D, B, H)) from the
    forward's inputs, its ``hs``, its ``h0`` (zeros when None) and the
    cotangent ``gout`` of hs; rh is the r o hprev stack the weight
    gradient of wh reads."""
    if zn.device.type == "cpu":
        return gru_backward_reference(zrz, zn, wrz, wh, hs, gout, h0)
    t, nd, b, hdim = _check_inputs(zrz, zn, wrz, wh)
    for v, name in ((hs, "hs"), (gout, "gout")):
        _check(v, name, zn.device, (t, nd, b, hdim))
    rec.check_states(_KERNEL, zn.device, (nd, b, hdim), h0=h0)
    dzrz, dzn, rh = torch.empty_like(zrz), torch.empty_like(zn), \
        torch.empty_like(zn)
    lib = _lib()
    err = lib.bigdl_gru_bwd_f32(*(rec.ptr(v) for v in (
        zrz, zn, wrz, wh, hs, h0, gout, dzrz, dzn, rh)),
        t, nd, b, hdim, 0, 0, *_build.device_stream(zn.device))
    rec.raise_on(lib, err, _KERNEL, "bwd", hdim)
    gru_backward.launches += 1
    return dzrz, dzn, rh


def gru_dwh(hs, rh, dzrz, dzn, h0=None):
    """(dwrz (D, H, 2H), dwh (D, H, H)): sums over t and b of hprev^T .
    dzrz (the h stack ``hs`` read at t - 1, ``h0`` or zeros at t = 0) and
    of rh^T . dzn."""
    if hs.device.type == "cpu":
        return gru_dwh_reference(hs, rh, dzrz, dzn, h0)
    rec.check_device(_KERNEL, hs)
    t, nd, b, hdim = hs.shape
    for v, name, width in ((hs, "hs", hdim), (rh, "rh", hdim),
                           (dzrz, "dzrz", 2 * hdim), (dzn, "dzn", hdim)):
        _check(v, name, hs.device, (t, nd, b, width))
    rec.check_states(_KERNEL, hs.device, (nd, b, hdim), h0=h0)
    s1, rows1 = rec.dwh_slices(t, b, hdim, 2 * hdim, nd)
    s2, rows2 = rec.dwh_slices(t, b, hdim, hdim, nd)
    part = hs.new_empty(max(2 * s1, s2), nd, hdim, hdim)
    dwrz = hs.new_empty(nd, hdim, 2 * hdim)
    dwh = hs.new_empty(nd, hdim, hdim)
    lib = _lib()
    err = lib.bigdl_gru_dwh_f32(*(rec.ptr(v) for v in (
        hs, h0, rh, dzrz, dzn, part, dwrz, dwh)), t, nd, b, hdim, s1, rows1,
        s2, rows2, *_build.device_stream(hs.device))
    rec.raise_on(lib, err, _KERNEL, "dwh", hdim)
    gru_dwh.launches += 1
    return dwrz, dwh


gru_forward.launches = 0
gru_backward.launches = 0
gru_dwh.launches = 0


def _check(v, name, device, shape):
    rec.check(_KERNEL, v, name, device, shape)


def _check_inputs(zrz, zn, wrz, wh):
    if zn.dim() != 4:
        raise ValueError(f"gru: zn must be (T, D, B, H), got "
                         f"{tuple(zn.shape)}")
    t, nd, b, hdim = zn.shape
    rec.check_hidden(_KERNEL, hdim, MAX_HIDDEN, smem_bytes)
    rec.check_device(_KERNEL, zn)
    _check(zrz, "zrz", zn.device, (t, nd, b, 2 * hdim))
    _check(zn, "zn", zn.device, (t, nd, b, hdim))
    _check(wrz, "wrz", zn.device, (nd, hdim, 2 * hdim))
    _check(wh, "wh", zn.device, (nd, hdim, hdim))
    return t, nd, b, hdim


class _GRU(torch.autograd.Function):
    """The recurrence whose residuals are zrz, zn, wrz, wh, hs and the
    constant h0 (the JAX ``gru_recurrence`` custom VJP)."""

    @staticmethod
    def forward(ctx, zrz, zn, wrz, wh, h0):
        hs = gru_forward(zrz, zn, wrz, wh, h0)
        ctx.save_for_backward(zrz, zn, wrz, wh, hs, h0)
        return hs

    @staticmethod
    def backward(ctx, gout):
        zrz, zn, wrz, wh, hs, h0 = ctx.saved_tensors
        dzrz, dzn, rh = gru_backward(zrz, zn, wrz, wh, hs, gout.contiguous(),
                                     h0)
        return (dzrz, dzn) + gru_dwh(hs, rh, dzrz, dzn, h0) + (None,)


def gru_recurrence(zrz, zn, wrz, wh, h0=None):
    """The h stack (T, D, B, H) of the GRU recurrence over ``zrz``
    (T, D, B, 2H), ``zn`` (T, D, B, H), ``wrz`` (D, H, 2H) and ``wh``
    (D, H, H) from ``h0`` (D, B, H) or zeros, differentiable in all four;
    ``h0`` is taken as a constant."""
    if h0 is not None:
        h0 = h0.detach()
    if torch.is_grad_enabled() and any(
            v.requires_grad for v in (zrz, zn, wrz, wh)):
        return _GRU.apply(zrz, zn, wrz, wh, h0)
    return gru_forward(zrz, zn, wrz, wh, h0)
