#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``bigdl_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py            # the smoke, about two minutes
    python3 chip_smoke.py --profile  # plus torch.profiler breakdowns

Phases, each failing with a non-zero exit:

1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions, and the build of every CUDA kernel from
   ``bigdl_tpu_torch/csrc`` (one nvcc per source, all at once);
2. every kernel against its plain PyTorch version on the card, with
   times (CUDA events, L2 flushed before each launch): paged attention
   at the decode step's full-width shape and at ragged page layouts;
   the max pool's forward, argmax and backward on tied inputs at nine
   geometries (LeNet's two pools and Inception-v1's first among them)
   and on inputs with NaNs at three; fused SGD on six hyper sets, timed
   at LeNet's and at the serving model's parameter counts;
3. serving: a full-width ``TransformerLM`` (vocab 4000, d_model 1024,
   4 heads, 6 layers, hidden 4096, random weights from seed 0) serves 16
   requests through ``ContinuousDecoder``; the kernels' launch counts
   show the path went through them, and every generated token is held
   against the plain full-sequence forward by teacher forcing; then
   ``lm_decode`` extends the longest seed on the same weights and is held
   against the decoder's row for it;
4. training: ``LeNet5`` (seed 0) trains two epochs of synthetic MNIST
   through ``Optimizer(...).optimize()`` with its default ``SGD``,
   validating Top1 every epoch; the launch counts show every step went
   through the SGD kernel and every pool through the pool kernels, and
   the same run on the CPU (plain versions) from the same parameters and
   batch order gives the same losses and final parameters;
5. one JSON line of kernels, then the card line, then the result line.

Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

RTOL, ATOL = 1e-4, 1e-5          # fp32, summation order differs
HBM_BYTES_PER_S = 3.35e12         # H100 SXM data sheet
FP32_FLOPS = 67e12                # H100 SXM data sheet, non-tensor fp32
VOCAB, D_MODEL, HEADS, LAYERS, HIDDEN = 4000, 1024, 4, 6, 4096
SLOTS, N_POS, PAGE = 8, 1024, 16
N_REQ, N_WORDS = 16, 128
# training slice: examples/train_lenet.py on synthetic MNIST
N_TRAIN, N_VAL, BATCH, EPOCHS, LR, MOMENTUM = 2048, 512, 128, 2, 0.05, 0.9
LOSS_RTOL, PARAM_ATOL = 1e-3, 1e-4   # card vs CPU: cuDNN conv sums differ
POOL_TOL = dict(rtol=1e-5, atol=1e-5)   # backward: summation order
SGD_TOL = dict(rtol=1e-5, atol=1e-6)    # fused multiply-adds
# (shape, window, strides, pads): tests/test_pallas_ops.py:159-172, then
# LeNet's two pools at batch 128, then Inception-v1's first pool
# (models/inception.py:36, 3x3 s2 ceil) at batch 32
POOL_CASES = [
    ((2, 5, 13, 17), (3, 3), (2, 2), ((1, 1), (1, 1))),
    ((2, 3, 10, 12), (3, 3), (1, 1), ((1, 1), (1, 1))),
    ((1, 4, 9, 11), (2, 2), (2, 2), ((0, 1), (1, 0))),
    ((1, 2, 12, 8), (5, 3), (3, 2), ((2, 2), (1, 1))),
    ((37, 1, 13, 7), (3, 3), (2, 2), ((1, 1), (1, 1))),
    ((1, 100, 8, 8), (3, 3), (1, 1), ((0, 0), (0, 0))),
    ((BATCH, 6, 24, 24), (2, 2), (2, 2), ((0, 0), (0, 0))),
    ((BATCH, 12, 8, 8), (2, 2), (2, 2), ((0, 0), (0, 0))),
    ((32, 64, 112, 112), (3, 3), (2, 2), ((0, 1), (0, 1))),
]
NAN_POOL_CASES = (0, 2, 6)   # padded, asymmetric pads, LeNet's first pool
# tests/test_pallas_ops.py:37-44
SGD_HYPERS = [
    {"lr": 0.1}, {"lr": 0.1, "dampening": 0.9},
    {"lr": 0.1, "momentum": 0.9},
    {"lr": 0.1, "momentum": 0.9, "dampening": 0.9},
    {"lr": 0.1, "momentum": 0.9, "nesterov": True},
    {"lr": 0.1, "momentum": 0.9, "weight_decay": 1e-3},
]


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(torch, fn, flush, reps=25, warm=3):
    """Median device time of ``fn`` over ``reps`` launches, L2 flushed
    before each (the decode step finds its K/V pages cold: six layers of
    pools and 335 MB of weights pass through L2 between two reads)."""
    times = []
    for r in range(warm + reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        if r >= warm:
            times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_queued_ms(torch, fn, reps=20):
    """Mean time of ``reps`` calls queued back to back between two
    events: the host runs ahead of the card, so where the device work of
    a call outlasts the wrapper's host work, this is the device's time.
    No L2 flush: use it at shapes far above the 50 MB L2."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def paged_case(torch, g, bsz, S, H, hd, ps, P, n_pages, pos, shared=False):
    dev = "cuda"
    q = torch.randn(bsz, S, H, hd, generator=g, device=dev)
    kpool = torch.randn(n_pages, ps, H, hd, generator=g, device=dev)
    vpool = torch.randn(n_pages, ps, H, hd, generator=g, device=dev)
    perm = torch.randperm(n_pages, generator=g, device=dev)
    ptab = perm[:bsz * P].reshape(bsz, P).to(torch.int32)
    if shared:
        ptab[:, 0] = perm[0]          # prefix-style shared head page
    pos = torch.as_tensor(pos, dtype=torch.int32, device=dev)
    return q, kpool, vpool, ptab, pos


def window_pos(bsz, S, n_view):
    """Consecutive S-query windows, row 0 at the minimal position (its
    tail pages fully masked), the last row at the last view position."""
    last = np.linspace(S - 1, n_view - 1, bsz).round().astype(np.int64)
    return last[:, None] - (S - 1) + np.arange(S)[None, :]


def check_paged(torch, ops, args):
    """Kernel against the plain version on the same inputs; live rows
    only (a row with pos < 0 is discarded by every caller)."""
    out = ops.paged_attention(*args)
    ref = ops.paged_attention_reference(*args)
    torch.cuda.synchronize()
    live = args[4] >= 0
    torch.testing.assert_close(out[live], ref[live], rtol=RTOL, atol=ATOL)
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("paged_attention: non-finite output")
    return float((out[live] - ref[live]).abs().max())


def paged_bound(args):
    """Least time for this call's work: each live K/V page read once, q,
    pos, ptab read and out written once, over the memory rate; its
    QK and PV flops over the fp32 rate.  Pages past a row's last query
    position are not needed and not counted."""
    q, kpool, _, ptab, pos = args
    bsz, S, H, hd = q.shape
    ps, P = kpool.shape[1], ptab.shape[1]
    last = pos.max(dim=1).values.cpu().numpy()
    pages = np.where(last < 0, 0, np.minimum(P, last // ps + 1))
    live_keys = pos.clamp(min=-1).cpu().numpy() + 1          # (B, S)
    kv = 2 * int(pages.sum()) * ps * H * hd * 4
    io = 2 * q.numel() * 4 + pos.numel() * 4 + ptab.numel() * 4
    flops = 4 * hd * H * int(live_keys.sum())
    t_bytes = (kv + io) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), kv + io


def phase_kernels(torch, ops):
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(0)
    # full-width decode step: B=8, S=1, H=4, hd=256, ps=16, P=64 pages of
    # a 512-page pool; row 0 never admitted (pos -1), the rest spread
    # over 0..1023
    spread = [[-1]] + [[int(p)] for p in np.linspace(0, N_POS - 1, 7)]
    full = paged_case(torch, g, SLOTS, 1, HEADS, D_MODEL // HEADS, PAGE,
                      N_POS // PAGE, 512, spread)
    errs = [check_paged(torch, ops, full)]
    for S, hd in ((1, 8), (3, 8), (3, 6)):
        # ragged: ps=4, P=3 (the page layout of the n_pos=9 fixtures), a shared head page,
        # fully masked tail pages on row 0; hd=6 takes the scalar path
        args = paged_case(torch, g, 3, S, 2, hd, 4, 3, 10,
                          window_pos(3, S, 12), shared=True)
        errs.append(check_paged(torch, ops, args))
    for ps, P in ((32, 4), (64, 2)):
        # wide pages at hd=256: the ring drops to 3 and to 1 stage
        args = paged_case(torch, g, 3, 1, 2, 256, ps, P, 3 * P + 1,
                          window_pos(3, 1, ps * P))
        errs.append(check_paged(torch, ops, args))

    flush = torch.empty(64 * 2**20, device="cuda")   # 256 MB > 50 MB L2
    q, kpool, vpool, ptab, pos = full
    bsz, S, H, hd = q.shape
    n_view = ptab.shape[1] * PAGE
    kview = kpool[ptab.long()].reshape(bsz, n_view, H, hd).transpose(1, 2)
    vview = vpool[ptab.long()].reshape(bsz, n_view, H, hd).transpose(1, 2)
    kview, vview = kview.contiguous(), vview.contiguous()
    mask = (torch.arange(n_view, device="cuda")[None, None, None, :]
            <= pos[:, None, :, None])
    qh = q.transpose(1, 2).contiguous()
    times = {
        "ms": time_ms(torch, lambda: ops.paged_attention(*full), flush),
        "plain_ms": time_ms(
            torch, lambda: ops.paged_attention_reference(*full), flush),
        "library_ms": time_ms(
            torch, lambda: F.scaled_dot_product_attention(
                qh, kview, vview, attn_mask=mask), flush),
    }
    bound, bound_by, nbytes = paged_bound(full)
    # every position live: the worst case a full reservation reaches
    all_live = (q, kpool, vpool, ptab,
                torch.full_like(pos, N_POS - 1))
    errs.append(check_paged(torch, ops, all_live))
    live_ms = time_ms(torch, lambda: ops.paged_attention(*all_live), flush)
    live_bound, _, live_bytes = paged_bound(all_live)
    print(f"paged_attention full-width (B=8 S=1 H=4 hd=256 ps=16 P=64, "
          f"pos spread, row 0 masked): kernel_ms={times['ms']:.5f} "
          f"plain_ms={times['plain_ms']:.5f} "
          f"library_ms={times['library_ms']:.5f} bound_ms={bound:.5f} "
          f"({nbytes} bytes) max_abs_err={max(errs):.3e}")
    print(f"paged_attention all positions live (pos=1023): "
          f"kernel_ms={live_ms:.5f} bound_ms={live_bound:.5f} "
          f"({live_bytes} bytes)")
    return {"name": "paged_attention", "route": "cuda",
            "source": "bigdl_tpu_torch/csrc/paged_attention.cu",
            "replaces": "bigdl_tpu/ops/pallas_kernels.py:1299",
            "max_abs_err": max(errs), "bound_ms": bound,
            "bound_by": bound_by, "ok": True, **times,
            # its pages fit in L2, so queued calls would read them warm;
            # its ms, L2 flushed, is already the device's time
            "queued_ms": None}


def check_pool(torch, ops, g, shape, win, st, pads, nan=False):
    """Forward, argmax, the primal variant, the backward wrapper and the
    autograd path against the plain versions on tied inputs (with
    ``nan``, a seventh of them NaN: the first-tap rule); returns
    (forward error, backward error)."""
    x = torch.randn(shape, generator=g, device="cuda").mul_(2).round_().div_(2)
    if nan:
        x[torch.rand(shape, generator=g, device="cuda") < 1 / 7] = float("nan")
    y, arg = ops.maxpool2d_forward(x, win, st, pads)
    y_only = ops.maxpool2d_forward(x, win, st, pads, with_argmax=False)
    y_ref, arg_ref = ops.maxpool2d_forward_reference(x, win, st, pads)
    gy = torch.randn(y.shape, generator=g, device="cuda")
    dx = ops.maxpool2d_backward(arg, gy, win, st, pads, shape)
    dx_ref = ops.maxpool2d_backward_reference(arg_ref, gy, win, st, pads,
                                              shape)
    xg = x.clone().requires_grad_()
    ops.maxpool2d(xg, win, st, pads).backward(gy)
    torch.cuda.synchronize()
    exact = dict(rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(y, y_ref, **exact)
    torch.testing.assert_close(y_only, y, **exact)
    if not torch.equal(arg, arg_ref):
        raise AssertionError(f"maxpool2d argmax differs at {shape}")
    if nan and not bool(y.isnan().any()):
        raise AssertionError(f"maxpool2d: no NaN output at {shape}")
    torch.testing.assert_close(dx, dx_ref, **POOL_TOL)
    torch.testing.assert_close(xg.grad, dx_ref, **POOL_TOL)
    return (float((y - y_ref).nan_to_num(nan=0.0).abs().max()),
            float((dx - dx_ref).abs().max()))


def pool_times(torch, ops, flush, g, shape, win, st, pads):
    """Kernel, plain and library (``F.max_pool2d`` with indices and its
    backward) times of the forward with argmax and of the backward, and
    their byte bounds: x read and y, argmax written; g, argmax read and
    dx written."""
    import torch.nn.functional as F

    x = torch.randn(shape, generator=g, device="cuda")
    y, arg = ops.maxpool2d_forward(x, win, st, pads)
    gy = torch.randn(y.shape, generator=g, device="cuda")
    (plh, phh), (plw, phw) = pads
    # the library's padding is symmetric: the high pad becomes ceil mode
    ceil = (phh, phw) != (plh, plw)
    lib = dict(kernel_size=win, stride=st, padding=(plh, plw),
               ceil_mode=ceil)
    y_lib, idx = F.max_pool2d(x, return_indices=True, **lib)
    if not torch.equal(y_lib, y):
        raise AssertionError("F.max_pool2d is not the same pool")
    fwd = {
        "ms": time_ms(torch, lambda: ops.maxpool2d_forward(
            x, win, st, pads), flush),
        "plain_ms": time_ms(torch, lambda: ops.maxpool2d_forward_reference(
            x, win, st, pads), flush),
        "library_ms": time_ms(torch, lambda: F.max_pool2d(
            x, return_indices=True, **lib), flush),
    }
    bwd = {
        "ms": time_ms(torch, lambda: ops.maxpool2d_backward(
            arg, gy, win, st, pads, shape), flush),
        "plain_ms": time_ms(torch, lambda: ops.maxpool2d_backward_reference(
            arg, gy, win, st, pads, shape), flush),
        "library_ms": time_ms(
            torch, lambda: torch.ops.aten.max_pool2d_with_indices_backward(
                gy, x, win, st, (plh, plw), (1, 1), ceil, idx), flush),
    }
    fwd["queued_ms"] = time_queued_ms(torch, lambda: ops.maxpool2d_forward(
        x, win, st, pads))
    bwd["queued_ms"] = time_queued_ms(torch, lambda: ops.maxpool2d_backward(
        arg, gy, win, st, pads, shape))
    nbytes = 4 * (x.numel() + 2 * y.numel())
    for row in (fwd, bwd):
        row["bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
        row["bound_by"] = "bytes"
        row["bytes"] = nbytes
    return fwd, bwd


def sgd_leaves(torch, g, shapes):
    return [[torch.randn(s, generator=g, device="cuda") for s in shapes]
            for _ in range(3)]


def check_sgd(torch, ops, g):
    """Three steps of the kernel and of the plain version on every hyper
    set, over leaves that no chunk or vector width divides, the gradients
    moved to new memory before the last step (the cached leaf table must
    give way to a new one); then a step with the finite flag False
    changes nothing."""
    shapes = [(130, 7), (7,), (4097,), (100,), (3, 5, 5), (10001,)]
    err = 0.0
    for h in SGD_HYPERS:
        p, gr, v = sgd_leaves(torch, g, shapes)
        p2, v2 = [t.clone() for t in p], [t.clone() for t in v]
        kw = dict(momentum=h.get("momentum", 0.0),
                  weight_decay=h.get("weight_decay", 0.0),
                  dampening=h.get("dampening", 0.0),
                  nesterov=h.get("nesterov", False))
        for step in range(3):
            if step == 2:
                gr = [t.clone() for t in gr]
            ops.fused_sgd(p, gr, v, h["lr"], **kw)
            ops.fused_sgd_reference(p2, gr, v2, h["lr"], **kw)
        torch.cuda.synchronize()
        for a, b in zip(p + v, p2 + v2):
            torch.testing.assert_close(a, b, **SGD_TOL)
            err = max(err, float((a - b).abs().max()))
        kept = [t.clone() for t in p + v]
        ops.fused_sgd(p, gr, v, h["lr"], finite=torch.zeros(
            (), dtype=torch.bool, device="cuda"), **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(p + v, kept)):
            raise AssertionError("fused_sgd wrote on a non-finite step")
    return err


def sgd_times(torch, ops, flush, g, shapes):
    """Kernel, plain and library (``torch.optim.SGD(fused=True).step()``,
    timing only: its first step's dampening differs) times of one step
    of the training slice's hypers over leaves of ``shapes``, and the
    byte bound: p, g, v read and p, v written, 20 bytes a parameter."""
    p, gr, v = sgd_leaves(torch, g, shapes)
    ok = torch.ones((), dtype=torch.bool, device="cuda")
    kw = dict(momentum=MOMENTUM, dampening=MOMENTUM)
    lib_params = [t.clone().requires_grad_() for t in p]
    for t, d in zip(lib_params, gr):
        t.grad = d
    lib = torch.optim.SGD(lib_params, lr=LR, fused=True, **kw)
    lib.step()   # allocates its momentum buffers
    n = sum(t.numel() for t in p)
    row = {
        "ms": time_ms(torch, lambda: ops.fused_sgd(
            p, gr, v, LR, finite=ok, **kw), flush),
        "plain_ms": time_ms(torch, lambda: ops.fused_sgd_reference(
            p, gr, v, LR, finite=ok, **kw), flush),
        "library_ms": time_ms(torch, lib.step, flush),
        "bound_ms": 20 * n / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "params": n,
        "queued_ms": time_queued_ms(torch, lambda: ops.fused_sgd(
            p, gr, v, LR, finite=ok, **kw)),
    }
    return row


def phase_train_kernels(torch, ops):
    """The training slice's kernels against their plain versions, with
    times at LeNet's shapes and at one larger shape a model of the repo
    has: Inception-v1's first pool, the serving model's parameters."""
    from bigdl_tpu_torch.models.lenet import LeNet5
    from bigdl_tpu_torch.models.transformer import TransformerLM

    g = torch.Generator(device="cuda").manual_seed(1)
    errs = [check_pool(torch, ops, g, *case) for case in POOL_CASES]
    errs += [check_pool(torch, ops, g, *POOL_CASES[k], nan=True)
             for k in NAN_POOL_CASES]
    sgd_err = check_sgd(torch, ops, g)
    flush = torch.empty(64 * 2**20, device="cuda")   # 256 MB > 50 MB L2
    for case in POOL_CASES[-3:]:
        fwd, bwd = pool_times(torch, ops, flush, g, *case)
        for name, row in (("forward", fwd), ("backward", bwd)):
            print(f"maxpool2d_{name} {case[0]} {case[1][0]}x{case[1][1]} "
                  f"s{case[2][0]} pads {case[3]}: kernel_ms={row['ms']:.5f} "
                  f"plain_ms={row['plain_ms']:.5f} "
                  f"library_ms={row['library_ms']:.5f} "
                  f"bound_ms={row['bound_ms']:.5f} ({row['bytes']} bytes) "
                  f"queued_ms={row['queued_ms']:.5f}")
    lenet = [tuple(p.shape) for p in LeNet5(device="cuda").parameters()]
    serving = [tuple(p.shape) for p in TransformerLM(
        VOCAB, D_MODEL, HEADS, LAYERS, HIDDEN, dropout=0.0,
        device="meta").parameters()]
    for shapes in (lenet, serving):
        sgd = sgd_times(torch, ops, flush, g, shapes)
        print(f"fused_sgd {sgd['params']} params in {len(shapes)} leaves: "
              f"kernel_ms={sgd['ms']:.5f} plain_ms={sgd['plain_ms']:.5f} "
              f"library_ms={sgd['library_ms']:.5f} "
              f"bound_ms={sgd['bound_ms']:.5f} ({20 * sgd['params']} bytes) "
              f"queued_ms={sgd['queued_ms']:.5f}")
    fwd_err = max(e[0] for e in errs)
    bwd_err = max(e[1] for e in errs)
    print(f"maxpool2d: {len(POOL_CASES)} geometries with ties and "
          f"{len(NAN_POOL_CASES)} with NaNs, forward and argmax equal, "
          f"backward max_abs_err={bwd_err:.3e}; fused_sgd: "
          f"{len(SGD_HYPERS)} hyper sets x 3 steps, max_abs_err="
          f"{sgd_err:.3e}, a non-finite step writes nothing")
    common = {"route": "cuda", "ok": True}
    pool_src = {"source": "bigdl_tpu_torch/csrc/maxpool2d.cu"}
    return [
        {"name": "fused_sgd", "source": "bigdl_tpu_torch/csrc/fused_sgd.cu",
         "replaces": "bigdl_tpu/ops/pallas_kernels.py:59",
         "max_abs_err": sgd_err, **common, **sgd},
        {"name": "maxpool2d_forward", **pool_src,
         "replaces": "bigdl_tpu/ops/pallas_kernels.py:1162",
         "max_abs_err": fwd_err, **common, **fwd},
        {"name": "maxpool2d_backward", **pool_src,
         "replaces": "bigdl_tpu/ops/pallas_kernels.py:1202",
         "max_abs_err": bwd_err, **common, **bwd},
    ]


def lenet_run(torch, device, init_tree, end_trigger, validate=True):
    """``examples/train_lenet.py`` on synthetic MNIST, from ``init_tree``:
    an optimizer ready to run."""
    from bigdl_tpu_torch.dataset import (DataSet, ImgNormalizer, ImgToBatch,
                                         mnist)
    from bigdl_tpu_torch.models.lenet import LeNet5
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import Optimizer, Top1Accuracy, every_epoch
    from bigdl_tpu_torch.utils.table import T

    norm = ImgNormalizer(mnist.TRAIN_MEAN, mnist.TRAIN_STD)
    train = DataSet.array(mnist.synthetic(N_TRAIN)) >> norm >> ImgToBatch(
        BATCH)
    model = LeNet5(10, device=device).load_params(init_tree)
    # the optimizer's own default method, SGD
    opt = Optimizer(model, train, ClassNLLCriterion(),
                    state=T(learningRate=LR, momentum=MOMENTUM),
                    end_trigger=end_trigger, device=device)
    if validate:
        val = (DataSet.array(mnist.synthetic(N_VAL, seed=1)) >> norm
               >> ImgToBatch(BATCH))
        opt.set_validation(every_epoch(), val, [Top1Accuracy()])
    return opt


def phase_train(torch, ops, profile: bool):
    from bigdl_tpu_torch.models.lenet import LeNet5
    from bigdl_tpu_torch.nn.module import export_params
    from bigdl_tpu_torch.optim import max_epoch, max_iteration
    from bigdl_tpu_torch.utils.random import generator

    init = export_params(LeNet5(10, device="cuda", generator=generator(0)))
    # warm-up: cuDNN's algorithm choice, allocator, kernel library loads
    lenet_run(torch, "cuda", init, max_iteration(3)).optimize()
    opt = lenet_run(torch, "cuda", init, max_epoch(EPOCHS))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    opt.optimize()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    steps = int(opt.state["neval"]) - 1
    val_batches = len(opt.validation_log) * -(-N_VAL // BATCH)
    want = {"fused_sgd": steps, "maxpool2d_backward": 2 * steps,
            "maxpool2d_forward": 2 * steps + 2 * val_batches}
    if steps != EPOCHS * N_TRAIN // BATCH or any(
            counts[k] != n for k, n in want.items()):
        raise AssertionError(f"training launches {counts} after {steps} "
                             f"steps and {val_batches} validation batches, "
                             f"expected {want}")
    losses = [l for _, l in opt.loss_log]
    if len(losses) != steps or not np.isfinite(losses).all():
        raise AssertionError(f"training losses: {losses}")
    val_s = opt.metrics.get("validate")[0]
    step_ms = (wall - val_s) / steps * 1e3
    top1 = " ".join(f"epoch {e - 1}: {v['Top1Accuracy']:.4f}"
                    for _, e, v in opt.validation_log[1:])
    print(f"train: LeNet5 {sum(p.numel() for p in opt.model.parameters())} "
          f"params, {steps} steps of {BATCH} over {EPOCHS} epochs, "
          f"{len(opt.validation_log)} validations of {val_batches // len(opt.validation_log)} "
          f"batches; wall {wall:.4f} s, {steps * BATCH / wall:.1f} images/s "
          f"(validation included), {step_ms:.4f} ms/step (validation "
          f"{val_s:.4f} s excluded), {opt.host_syncs} host syncs of the "
          f"loop + {val_batches} validation reads, max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} B; launches {counts}; "
          f"losses {losses[0]:.6f} -> {losses[-1]:.6f}; Top1 {top1}")

    # the same run on the CPU: plain versions, same params and batches
    cpu = lenet_run(torch, "cpu", init, max_epoch(EPOCHS))
    cpu.optimize()
    want_l = np.asarray([l for _, l in cpu.loss_log])
    got_l = np.asarray(losses)
    rel = float(np.max(np.abs(got_l - want_l) / np.abs(want_l)))
    p_err = max(float((a.detach().cpu() - b.detach()).abs().max())
                for a, b in zip(opt.model.parameters(),
                                cpu.model.parameters()))
    print(f"train vs CPU: {len(want_l)} flushed losses, largest relative "
          f"difference {rel:.3e} (limit {LOSS_RTOL}); final params, largest "
          f"absolute difference {p_err:.3e} (limit {PARAM_ATOL}); Top1 "
          f"card {[v for _, _, v in opt.validation_log]} CPU "
          f"{[v for _, _, v in cpu.validation_log]}")
    if len(want_l) != len(got_l) or rel > LOSS_RTOL or p_err > PARAM_ATOL:
        raise AssertionError("the card's training left the CPU's")
    if profile:
        busy_ms = profile_train(torch, init)
        print(f"profile: device idle share of the unprofiled train step "
              f"{1 - busy_ms / step_ms:.4f} ({busy_ms:.4f} of "
              f"{step_ms:.4f} ms/step busy)")
    return counts


def profile_train(torch, init):
    """Device time by kernel over a window of train steps (no
    validation), after two warm steps."""
    from torch.profiler import ProfilerActivity, profile

    from bigdl_tpu_torch.optim import max_iteration

    n = 16
    opt = lenet_run(torch, "cuda", init, max_iteration(2), validate=False)
    opt.optimize()
    opt.set_end_when(max_iteration(2 + n))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        opt.optimize()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda e: -e.device_time_total)
    busy = sum(e.device_time_total for e in rows) / 1e3   # ms
    print(f"profile: {n} train steps, wall under the profiler "
          f"{wall * 1e3:.3f} ms ({wall / n * 1e3:.4f} ms/step), device busy "
          f"{busy:.3f} ms ({busy / n:.4f} ms/step, "
          f"{sum(e.count for e in rows) / n:.1f} device ops/step)")
    for e in rows[:12]:
        print(f"profile:   {e.device_time_total / n:9.2f} us/step "
              f"{e.count / n:5.1f}/step  {e.key[:80]}")
    return busy / n


def forced_gaps(torch, model, row, n_seed):
    """Teacher forcing: for each generated token of ``row``, how far its
    log-prob under the plain full-sequence forward sits below that
    position's maximum."""
    import torch.nn.functional as F

    with torch.no_grad():
        ids = torch.tensor([row], device="cuda")
        lp = model(F.one_hot(ids, VOCAB).float())[0]
    if not bool(torch.isfinite(lp).all()):
        raise AssertionError("non-finite log-probs")
    j = torch.arange(n_seed - 1, len(row) - 1, device="cuda")
    return lp[j].max(dim=-1).values - lp[j, ids[0, j + 1]]


def check_lm_decode(torch, ops, model, seed, want):
    """The offline entry point at full width: ``lm_decode`` of one seed
    launches the kernel once per layer and position, and its row equals
    the decoder's.  Two fp32 runs at different batch widths may part at a
    near-tie; there both tokens must sit within 1e-3 of the position's
    maximum, and the rows are compared no further."""
    from bigdl_tpu_torch.models.transformer import lm_decode

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    got = lm_decode(model, seed, N_WORDS, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()["paged_attention"]
    n_pos = len(seed) + N_WORDS - 1
    if launches != LAYERS * n_pos:
        raise AssertionError(f"lm_decode launched paged_attention "
                             f"{launches} times, expected {LAYERS} x "
                             f"{n_pos} positions")
    if len(got) != len(want) or got[:len(seed)] != seed:
        raise AssertionError("lm_decode returned a row of the wrong shape")
    same = next((k for k in range(len(seed), len(got))
                 if got[k] != want[k]), len(got))
    if same < len(got):
        gaps = forced_gaps(torch, model, want[:same] + [got[same]],
                           len(seed))
        if float(gaps.max()) > 1e-3:
            raise AssertionError(
                f"lm_decode parts from the decoder at position {same} on "
                f"a token {float(gaps[-1]):.3e} below the maximum")
    print(f"lm_decode: seed {len(seed)} tokens + {N_WORDS} words "
          f"({-(-n_pos // PAGE)} pages of {PAGE}), {launches} kernel "
          f"launches, {same - len(seed)} of {N_WORDS} tokens equal to the "
          f"decoder's row{'' if same == len(got) else ' (then a near-tie)'}"
          f", wall {wall:.4f} s")


def phase_slice(torch, ops, profile: bool):
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.serve.decode import (ContinuousDecoder,
                                              continuous_decode)
    from bigdl_tpu_torch.utils.random import generator

    t0 = time.perf_counter()
    model = TransformerLM(VOCAB, D_MODEL, HEADS, LAYERS, HIDDEN,
                          dropout=0.0, device="cuda",
                          generator=generator(0)).evaluate()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {n_params} parameters on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    # warm-up: cuBLAS handles, allocator, kernel library load
    continuous_decode(model, [[1, 2, 3]], 4, max_slots=SLOTS, n_pos=N_POS,
                      device="cuda")

    rs = np.random.RandomState(0)
    seeds = [rs.randint(0, VOCAB, size=int(rs.randint(16, 257))).tolist()
             for _ in range(N_REQ)]
    dec = ContinuousDecoder(model, max_slots=SLOTS, n_pos=N_POS,
                            page_size=PAGE, device="cuda")
    futs = [dec.submit(s, N_WORDS) for s in seeds]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    dec.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    rows = [f.result() for f in futs]
    if counts["paged_attention"] != LAYERS * dec.steps:
        raise AssertionError(f"paged_attention launched "
                             f"{counts['paged_attention']} times, expected "
                             f"{LAYERS} x {dec.steps} steps")
    st = dec.stats()
    print(f"decode: {N_REQ} requests, seeds {min(map(len, seeds))}.."
          f"{max(map(len, seeds))} tokens, n_words={N_WORDS}, "
          f"{st['steps']} steps, {st['host_syncs']} host syncs, "
          f"admitted {st['admitted']}, live_hwm {st['live_hwm']}, "
          f"wall {wall:.4f} s, {N_REQ * N_WORDS / wall:.1f} generated "
          f"tokens/s, {wall / st['steps'] * 1e3:.4f} ms/step, "
          f"max_memory_allocated {torch.cuda.max_memory_allocated()} B, "
          f"paged_attention launches {counts['paged_attention']}")
    if st["pool"]["in_use"] != 0:
        raise AssertionError(f"pages leaked: {st['pool']}")

    # teacher forcing: each generated token's log-prob under the plain
    # full-sequence forward is within 1e-3 of that position's maximum
    worst = 0.0
    for seed, row in zip(seeds, rows):
        if len(row) != len(seed) + N_WORDS or row[:len(seed)] != seed:
            raise AssertionError("returned row has the wrong shape")
        worst = max(worst, float(forced_gaps(torch, model, row,
                                             len(seed)).max()))
    if worst > 1e-3:
        raise AssertionError(f"teacher forcing: a generated token sits "
                             f"{worst:.3e} below the position's maximum")
    print(f"teacher forcing: {N_REQ * N_WORDS} tokens checked, largest "
          f"gap to the position's max log-prob {worst:.3e} (limit 1e-3)")
    longest = max(range(N_REQ), key=lambda k: len(seeds[k]))
    check_lm_decode(torch, ops, model, seeds[longest], rows[longest])

    if profile:
        busy_ms = profile_decode(torch, model, seeds)
        step_ms = wall / st["steps"] * 1e3
        print(f"profile: device idle share of the unprofiled step "
              f"{1 - busy_ms / step_ms:.4f} ({busy_ms:.4f} of "
              f"{step_ms:.4f} ms/step busy)")
    return counts


def profile_decode(torch, model, seeds):
    """Device time by kernel over a steady window of the same traffic."""
    from torch.profiler import ProfilerActivity, profile

    from bigdl_tpu_torch.serve.decode import ContinuousDecoder

    dec = ContinuousDecoder(model, max_slots=SLOTS, n_pos=N_POS,
                            page_size=PAGE, device="cuda")
    for s in seeds[:SLOTS]:
        dec.submit(s, N_WORDS)
    dec.step_boundary()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(4):
            dec.step_boundary()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side rows only (kernels, memcpy, memset): each runs once
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda e: -e.device_time_total)
    busy = sum(e.device_time_total for e in rows) / 1e3   # ms
    steps = 4 * dec.sync_interval
    print(f"profile: {steps} steps, wall under the profiler "
          f"{wall * 1e3:.3f} ms ({wall / steps * 1e3:.4f} ms/step), device "
          f"busy {busy:.3f} ms ({busy / steps:.4f} ms/step, "
          f"{sum(e.count for e in rows) / steps:.1f} device ops/step)")
    for e in rows[:10]:
        print(f"profile:   {e.device_time_total / steps:9.2f} us/step "
              f"{e.count / steps:5.1f}/step  {e.key[:80]}")
    dec.run()
    return busy / steps


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.utils.device import pin_fp32

    pin_fp32(torch.device("cuda"))
    smi = smi_line()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    built = _build.build()
    print(f"kernel build: {len(built)} built in "
          f"{time.perf_counter() - t0:.2f} s (wall, parallel)")
    for name, info in built.items():
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  {name}: {line.strip()}")

    kernel_rows = [phase_kernels(torch, ops)] + phase_train_kernels(torch,
                                                                    ops)
    # each path's counts are read right after it ran, from zero
    counts = phase_slice(torch, ops, "--profile" in argv)
    counts_train = phase_train(torch, ops, "--profile" in argv)
    for row in kernel_rows:
        row["launches"] = (counts if row["name"] == "paged_attention"
                           else counts_train)[row["name"]]
    # queued_ms: calls queued back to back, the device's time where it
    # outlasts the wrapper's host work (no L2 flush)
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "queued_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "ok")
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in kernel_rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
