#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``bigdl_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py            # the smoke, about a minute
    python3 chip_smoke.py --profile  # plus a torch.profiler breakdown

Phases, each failing with a non-zero exit:

1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions, and the build of every CUDA kernel from
   ``bigdl_tpu_torch/csrc`` (one nvcc per source, all at once);
2. every kernel against its plain PyTorch version on the card, at the
   decode step's full-width shape and at ragged page layouts, with times
   (CUDA events, L2 flushed before each launch);
3. the slice: a full-width ``TransformerLM`` (vocab 4000, d_model 1024,
   4 heads, 6 layers, hidden 4096, random weights from seed 0) serves 16
   requests through ``ContinuousDecoder``; the kernels' launch counts
   show the path went through them, and every generated token is held
   against the plain full-sequence forward by teacher forcing; then
   ``lm_decode`` extends the longest seed on the same weights and is held
   against the decoder's row for it;
4. one JSON line of kernels, then the card line, then the result line.

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
            "bound_by": bound_by, "ok": True, **times}


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

    kernel_rows = [phase_kernels(torch, ops)]
    counts = phase_slice(torch, ops, "--profile" in argv)
    for row in kernel_rows:
        row["launches"] = counts[row["name"]]
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "ok")
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in kernel_rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
