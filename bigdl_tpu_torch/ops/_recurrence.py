"""What the recurrence wrappers (``ops.bilstm``, ``ops.rnn``, ``ops.gru``,
``ops.lstm_scan``) share: the cluster plan of
``csrc/recurrence_cluster.cuh``, the weight gradient's slices
(``csrc/recurrence_dwh.cuh``) and their argument checks.

A cluster recurrence is planned by :func:`cluster_plan`, the mirror of
the header's ``make_plan``; its limit (:func:`max_hidden`) is the
largest H a 16-block cluster of one row holds, and the wrappers refuse a
larger H before any launch.  A cell is described by (G, E, L) -- its
gate columns, its inputs a unit and a step, its local values a unit
(an LSTM's c: ``True``) -- and V, the values a unit holds in the
exchanged state (the LSTM backward's 4); a two-phase cell (the GRU's)
adds its second phase's (G, V) as ``phase1``, and a cell whose weight is
held in bf16 (the LSTM's bf16 forms) its weight's bytes an element as
``wbytes`` (2: half the f32 slice).
"""
from __future__ import annotations

import ctypes

import torch

from bigdl_tpu_torch.ops import _build

# a block's shared memory on sm_90, bytes (recurrence_cluster.cuh kMaxSmem)
MAX_SMEM = 232448
VP, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
DIMS = [I, I, I, I, I, VP]   # T D B H, device, stream
PLANNED_DIMS = [I] * 6 + [I, VP]   # T D B H, C R, device, stream


def max_hidden(smem_bytes):
    """The largest H a kernel takes: the last whose ``smem_bytes(h, 1)``
    (forward and backward bytes at one batch row) fit (every smaller H
    fits too; the tests check it)."""
    lo, hi = 1, 1
    while max(smem_bytes(hi, 1)) <= MAX_SMEM:
        lo, hi = hi, hi * 2
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if max(smem_bytes(mid, 1)) <= MAX_SMEM else (lo, mid)
    return lo


# csrc/recurrence_cluster.cuh: the cluster block's threads, the ring's
# shallowest and deepest, the card's SMs, the run length of a lane's sum,
# the cluster sizes and batch rows the plan tries, and the accumulators a
# lane holds
CLUSTER_THREADS, MIN_DEPTH, MAX_DEPTH, SMS, CHUNK = 256, 3, 8, 132, 32
CLUSTER_SIZES, CLUSTER_ROWS, MAX_ACC = (1, 2, 4, 8, 16), (1, 2, 4, 8, 16), 16
PLAN_FIELDS = ("C", "R", "RT", "KP", "S", "staged", "depth", "bytes")


def _round4(x):
    return (x + 3) & ~3


def _pow2_floor(x):
    p = 1
    while p * 2 <= x:
        p *= 2
    return p


def _weights(g, v, phase1):
    """The weights a unit takes at one reduction index in each phase: a
    phase's product sums over the other phase's V values a unit."""
    if phase1 is None:
        return (g * v,)
    g1, v1 = phase1
    return g * v1, g1 * v


def _slice_floats(hdim, ws, wbytes):
    """recurrence_cluster.cuh ``slice_floats``: H rows of ``ws`` weights of
    ``wbytes`` bytes, in floats, in whole 16-byte granules."""
    return -(-hdim * ws * wbytes // 16) * 4


def cluster_smem_floats(g, e, n_loc, hdim, rows, c, staged, depth, v=1,
                        phase1=None, wbytes=4):
    """recurrence_cluster.cuh ``smem_floats``: the states (one phase: two
    buffers), the ``n_loc`` local values a unit, the weight slices (of
    ``wbytes``-byte elements) when staged and ``depth`` ring stages, in
    floats."""
    s = -(-hdim // c)
    v1 = v if phase1 is None else phase1[1]
    return (_round4(v * hdim * rows) + _round4(v1 * hdim * rows)
            + _round4(n_loc * rows * s)
            + (sum(_slice_floats(hdim, s * n + 4, wbytes)
                   for n in _weights(g, v, phase1)) if staged else 0)
            + depth * _round4(e * rows * s))


def cluster_plan_at(g, e, n_loc, hdim, rows, c, v=1, phase1=None, wbytes=4):
    """recurrence_cluster.cuh ``plan_at``: the plan of (C, R) as a dict of
    PLAN_FIELDS, C = 0 when it does not fit; the weight slices staged in
    shared memory when they fit beside the shallowest ring."""
    s = -(-hdim // c)
    rt = min(rows, MAX_ACC // max(_weights(g, v, phase1)))
    p = dict(C=0, R=rows, RT=rt, KP=1, S=s, staged=0, depth=0, bytes=0)
    cap = MAX_SMEM // 4
    if c > hdim:
        return p
    stage = _round4(e * rows * s)
    fixed = cluster_smem_floats(g, e, n_loc, hdim, rows, c, True, 0, v,
                                phase1, wbytes)
    p["staged"] = int(fixed + MIN_DEPTH * stage <= cap)
    if not p["staged"]:
        fixed = cluster_smem_floats(g, e, n_loc, hdim, rows, c, False, 0, v,
                                    phase1, wbytes)
    if fixed + MIN_DEPTH * stage > cap:
        return p
    p["depth"] = min((cap - fixed) // stage, MAX_DEPTH)
    p["bytes"] = 4 * (fixed + p["depth"] * stage)
    items = s * (rows // p["RT"])
    p["KP"] = _pow2_floor(max(1, min(CLUSTER_THREADS // items, 32, hdim)))
    p["C"] = c
    return p


def fill_rows(nd, b, c):
    """recurrence_cluster.cuh ``fill_rows``: the fewest batch rows a
    cluster whose D x ceil(B / R) clusters of C blocks fit the SMs side by
    side (16 when none do)."""
    return next((r for r in CLUSTER_ROWS if nd * -(-b // r) * c <= SMS),
                CLUSTER_ROWS[-1])


def cluster_plan(g, e, n_loc, nd, b, hdim, v=1, phase1=None, wbytes=4):
    """recurrence_cluster.cuh ``make_plan``: the smallest cluster whose
    blocks hold their weight slice in shared memory, with the rows that
    fill the SMs; else 16 blocks reading their slices through L2 with as
    many of those rows as fit; C = 0 when nothing fits.  A function of
    the shape alone."""
    for c in CLUSTER_SIZES:
        p = cluster_plan_at(g, e, n_loc, hdim, fill_rows(nd, b, c), c, v,
                            phase1, wbytes)
        if p["C"] and p["staged"]:
            return p
    rows = fill_rows(nd, b, 16)
    while rows >= 1:
        p = cluster_plan_at(g, e, n_loc, hdim, rows, 16, v, phase1, wbytes)
        if p["C"]:
            return p
        rows //= 2
    return dict.fromkeys(PLAN_FIELDS, 0)


def kernel_plan(entry, *args):
    """The plan a kernel library's ``bigdl_*_plan(*args, out)`` entry
    computes, as a dict of PLAN_FIELDS."""
    out = (ctypes.c_int * len(PLAN_FIELDS))()
    entry(*args, out)
    return dict(zip(PLAN_FIELDS, out))


def dwh_slices(t, b, k, j, nd):
    """(S, rows a slice) of a weight gradient's split over the time*batch
    axis, for a (K, J) gradient of ``nd`` directions: enough 64x64 output
    tiles to give two waves of blocks on 132 SMs, slices a multiple of 16
    rows; a function of the shape alone, so the sum's order is too."""
    rows = t * b
    if rows == 0 or nd * k * j == 0:
        return 1, 16
    tiles = nd * -(-k // 64) * -(-j // 64)
    s = max(1, min(-(-264 // tiles), -(-rows // 64)))
    per = -(-rows // s)
    per = -(-per // 16) * 16
    return -(-rows // per), per


_TYPED: dict = {}


def load(name, setup):
    """The kernel library ``name``, its entry points typed by
    ``setup(lib)`` once."""
    lib = _TYPED.get(name)
    if lib is None:
        lib = _build.load(name)
        setup(lib)
        lib.bigdl_cuda_error_string.argtypes = [I]
        lib.bigdl_cuda_error_string.restype = ctypes.c_char_p
        _TYPED[name] = lib
    return lib


def check(kernel, v, name, device, shape, dtype=torch.float32):
    if v.device != device:
        raise ValueError(f"{kernel}: {name} on {v.device}, expected {device}")
    if v.dtype != dtype:
        raise TypeError(f"{kernel}: {name} must be {dtype}, got {v.dtype}")
    if tuple(v.shape) != tuple(shape) or not v.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be a contiguous "
                         f"{tuple(shape)} tensor, got {tuple(v.shape)}")


def check_states(kernel, device, shape, **states):
    """Each initial state given (h0=..., c0=...; None for zeros) as a
    contiguous f32 ``shape`` tensor on ``device``."""
    for name, v in states.items():
        if v is not None:
            check(kernel, v, name, device, shape)


def ptr(v):
    """The device pointer of ``v``, or None (a null pointer) for None."""
    return None if v is None else v.data_ptr()


def check_hidden(kernel, hdim, limit, smem_bytes):
    """Refuses an H past the kernel's limit, by name, before a launch."""
    if hdim > limit:
        raise NotImplementedError(
            f"{kernel}: H={hdim} needs {max(smem_bytes(hdim, 1))} bytes of "
            f"shared memory a block even at one batch row, more than the "
            f"card's {MAX_SMEM}; the kernels run H <= {limit}")


def check_device(kernel, t):
    if t.device.type != "cuda":
        raise ValueError(f"{kernel}: no kernel for device {t.device}")


def raise_on(lib, err, kernel, which, hdim):
    if err != 0:
        msg = lib.bigdl_cuda_error_string(err).decode()
        raise RuntimeError(f"{kernel} {which} kernel launch failed at "
                           f"H={hdim}: {msg}")


def product(h, wht):
    """h . wht as the kernels take it: against a bf16 wht, h rounded to
    bf16 and the (exact) products summed in f32."""
    if wht.dtype == torch.bfloat16:
        return torch.matmul(h.to(wht.dtype).float(), wht.float())
    return torch.matmul(h, wht)


def shift_prev(xs, x0=None):
    """xs[t] -> xs[t-1] along time, ``x0`` (zeros when None) at t = 0."""
    first = torch.zeros_like(xs[:1]) if x0 is None else x0[None]
    return torch.cat([first, xs[:-1]])
