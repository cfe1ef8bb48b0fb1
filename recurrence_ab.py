"""A/B of the port's recurrence and paged-attention kernels between two
trees, on one card.

    python3 recurrence_ab.py [--recurrence] PARENT_TREE CHANGE_TREE

Each tree is a checkout of the repository (unpack the other one with
``git archive`` into a directory that ``.gitignore`` lists).  The trees
run in turns, parent, change, change, parent, each turn a fresh process
that imports that tree's ``bigdl_tpu_torch`` and builds its kernels.  A
turn times every recurrence wrapper (``bilstm_*``, ``rnn_*``, ``gru_*``,
``lstm_scan``) at (T, D, B, H) = (500, 2, 128, 128), ``bilstm_forward``
and ``bilstm_backward`` also at D = 1, ``gru_forward`` and
``gru_backward`` also at D = 1, ``lstm_scan`` at (T, B, H) = (500, 128,
128), ``rnn_forward`` / ``rnn_backward`` at SimpleRNN's (4, 1, 4, 40) and
(8, 1, 4, 40), ``maxpool2d_backward`` at (32, 64, 112, 112) and at
Inception-v1's four 3x3 s2 pools at batch 128, ``maxpool2d_s1_forward``
and ``maxpool2d_s1_backward`` at Inception-v1's six stride-1 pool inputs
(3x3 p1, batch 128), and ``paged_attention``
over fp32 and int8
pools at the decode step's full width (B 8, S 1, H 4, hd 256, ps 16, P
64, positions spread to 1023, row 0 dead), at serving's own context
(positions up to 383) and in an S = 4 window: CUDA events, L2 flushed
before each call, median of 25.  Then it serves ``chip_smoke.py``'s 16
requests on its full-width ``TransformerLM`` (seed 0) through
``ContinuousDecoder`` with fp32 and with int8 KV pages: wall ms a step,
and under the profiler (four step boundaries) device ms a step and the
attention kernels' device us a step; and it serves eight long requests
(860-874-token seeds, 128 words) with each pool, the attention's device
us a step profiled in seven windows of 32 steps whose rows reach 8, 16,
..., 56 pages (the pages L2-warm, as the loop leaves them): the tree's
plan, and, where the tree splits the walk, one walk a row and the split
rule at every table width.  It lists the four longest kernels of three
bilstm forward and backward calls and of three gru forward and backward
calls under the profiler.  The bilstm, rnn, gru, ``lstm_scan`` and
attention outputs of fixed inputs are kept (``.recurrence_ab/`` in the
working directory), each wrapper called with its defaults (from zero
state, under tanh), with the gru's distance from a float64 plain run,
and the pool backward's dx at each timed shape, and the stride-1 pool's
y and dx at each of its shapes, are digested (sha256); their largest
differences between the trees are printed, and whether each tree's bits
repeat across its two turns.  ``--recurrence`` runs the recurrence
wrappers alone (no pool, attention or serving).  Prints the card's name
and power limit first; exits 1 if a turn fails, a tree's outputs do not
repeat, or an rnn, bilstm, gru or ``lstm_scan`` output or a pool digest
differs from the parent's in a bit.
"""
from __future__ import annotations

import hashlib
import json
import os
import statistics
import subprocess
import sys

FULL = (500, 2, 128, 128)
BIT_CASES = [FULL, (13, 2, 37, 100), (3, 2, 9, 558)]
SIMPLE = [(4, 1, 4, 40), (8, 1, 4, 40)]   # SimpleRNN's chunk and sequence
KEEP = ".recurrence_ab"
# the gru's outputs, in the order of the wrappers'
GRU_OUTS = ("hs", "dzrz", "dzn", "rh", "dwrz", "dwh")
# the pool backward: chip_smoke.py's row shape (a 3x3 s2 pool at batch 32)
# and Inception-v1's four 3x3 s2 ceil pools at batch 128
POOLS = [(32, 64, 112, 112), (128, 64, 112, 112), (128, 192, 56, 56),
         (128, 480, 28, 28), (128, 832, 14, 14)]
# the stride-1 pool: Inception-v1's six distinct 3x3 p1 pool inputs at
# batch 128 (3a, 3b, 4a, 4b-4d, 4e, 5a-5b)
S1_POOLS = [(128, 192, 28, 28), (128, 256, 28, 28), (128, 480, 14, 14),
            (128, 512, 14, 14), (128, 528, 14, 14), (128, 832, 7, 7)]
S1_GEOM = ((3, 3), ((1, 1), (1, 1)))
# the first steps of the long-context windows: their rows reach 8, 16, ...,
# 56 pages
LONG_WINDOWS = (96, 224, 352, 480, 608, 736, 864)
# attention: (B, S) positions of the decode step's full width, serving's
# own context (seeds of 16-256 tokens, 128 generated) and an S = 4 window
PAGED = {"full": [[-1]] + [[int(round(1023 * i / 6))] for i in range(7)],
         "serving": [[int(round(15 + (383 - 15) * i / 7))] for i in range(8)],
         "window": [[int(round(3 + 1020 * i / 7)) - 3 + k for k in range(4)]
                    for i in range(8)]}


def _digest(v):
    return hashlib.sha256(v.cpu().numpy().tobytes()).hexdigest()


def _ms(torch, fn, flush, reps=25, warm=3):
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


def paged_inputs(torch, g, quantize_rows, name):
    """Fixed attention inputs at PAGED[name]: the fp32 call's arguments
    and the int8 call's (the pools written by ``quantize_rows``); 64-page
    tables, serving's as wide as its longest request (24 pages)."""
    pos = torch.tensor(PAGED[name], dtype=torch.int32, device="cuda")
    bsz, S = pos.shape
    P = 24 if name == "serving" else 64
    q = torch.randn(bsz, S, 4, 256, generator=g, device="cuda")
    kp = torch.randn(512, 16, 4, 256, generator=g, device="cuda")
    vp = torch.randn(512, 16, 4, 256, generator=g, device="cuda")
    perm = torch.randperm(512, generator=g, device="cuda")
    ptab = perm[:bsz * P].reshape(bsz, P).to(torch.int32)
    (k8, ks), (v8, vs) = quantize_rows(kp), quantize_rows(vp)
    return (q, kp, vp, ptab, pos), (q, k8, v8, ptab, pos, ks, vs)


def _model():
    """chip_smoke.py's full-width TransformerLM (seed 0)."""
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.utils.random import generator

    return TransformerLM(4000, 1024, 4, 6, 4096, dropout=0.0, device="cuda",
                         generator=generator(0)).evaluate()


def _attention_us_step(torch, prof, steps):
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    return rows, sum(e.device_time_total for e in rows
                     if "paged_attention" in e.key
                     or "merge_kernel" in e.key) / steps


def long_context(torch, model, kv_quant, split_from=None):
    """The decode loop's attention us a step at long contexts, L2 warm as
    the loop leaves it: eight requests of 860-874-token seeds and 128
    generated words on ``model`` with ``kv_quant`` pools, profiled over
    the four step boundaries of each LONG_WINDOWS window, keyed by the
    pages its rows reach.  ``split_from`` (a tree that splits the walk)
    sets the table width from which the walk is split for this run only:
    past every table, one walk a row; 1, the split rule at every width."""
    import importlib

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from bigdl_tpu_torch.serve.decode import ContinuousDecoder

    pa = importlib.import_module("bigdl_tpu_torch.ops.paged_attention")
    default = getattr(pa, "SPLIT_FROM_PAGES", None)
    if split_from is not None:
        pa.SPLIT_FROM_PAGES = split_from
    rs = np.random.RandomState(1)
    out = {}
    try:
        dec = ContinuousDecoder(model, max_slots=8, n_pos=1024, page_size=16,
                                kv_quant=kv_quant, device="cuda")
        for i in range(8):
            dec.submit(rs.randint(0, 4000, size=860 + 2 * i).tolist(), 128)
        for start in LONG_WINDOWS:
            while dec.steps < start:
                dec.step_boundary()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(4):
                    dec.step_boundary()
                torch.cuda.synchronize()
            steps = 4 * dec.sync_interval
            pages = (start + steps) // 16
            out[f"{pages}p"] = _attention_us_step(torch, prof, steps)[1]
        dec.run()
    finally:
        if split_from is not None:
            pa.SPLIT_FROM_PAGES = default
    return out


def serving(torch, model, kv_quant):
    """chip_smoke.py's serving traffic on ``model``: {wall ms a step,
    device ms a step, attention us a step} with ``kv_quant`` pools."""
    import time

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from bigdl_tpu_torch.serve.decode import ContinuousDecoder

    rs = np.random.RandomState(0)
    seeds = [rs.randint(0, 4000, size=int(rs.randint(16, 257))).tolist()
             for _ in range(16)]
    out = {}
    for run in ("warm", "timed"):
        dec = ContinuousDecoder(model, max_slots=8, n_pos=1024, page_size=16,
                                kv_quant=kv_quant, device="cuda")
        for seed in seeds:
            dec.submit(seed, 128)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dec.run()
        torch.cuda.synchronize()
        out["wall_ms_step"] = (time.perf_counter() - t0) / dec.steps * 1e3
    dec = ContinuousDecoder(model, max_slots=8, n_pos=1024, page_size=16,
                            kv_quant=kv_quant, device="cuda")
    for seed in seeds[:8]:
        dec.submit(seed, 128)
    dec.step_boundary()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            dec.step_boundary()
        torch.cuda.synchronize()
    steps = 4 * dec.sync_interval
    rows, out["attention_us_step"] = _attention_us_step(torch, prof, steps)
    out["device_ms_step"] = sum(e.device_time_total for e in rows) / steps / 1e3
    dec.run()
    return out


def turn(tree, keep, recurrence_only=False):
    """One tree's times, top kernels and gru distances, as a dict; its
    bilstm, rnn, gru, lstm_scan and attention outputs saved to ``keep``
    (with ``recurrence_only``, the recurrence wrappers alone)."""
    sys.path.insert(0, tree)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.quant.kv import quantize_rows
    from bigdl_tpu_torch.utils.device import pin_fp32

    pin_fp32(torch.device("cuda"))
    g = torch.Generator(device="cuda").manual_seed(4)
    r = lambda *s: torch.randn(*s, generator=g, device="cuda")
    u = lambda h, *s: (torch.rand(*s, generator=g, device="cuda") * 2
                       - 1) / h ** 0.5
    kept = {}
    for t, nd, b, h in BIT_CASES:
        zx, wht, go = r(t, nd, b, 4 * h), u(h, nd, h, 4 * h), r(t, nd, b, h)
        hs, cs = ops.bilstm_forward(zx, wht)
        dzx = ops.bilstm_backward(zx, wht, hs, cs, go)
        for label, v in (("hs", hs), ("cs", cs), ("dzx", dzx),
                         ("dwh", ops.bilstm_dwh(hs, dzx)),
                         ("primal", ops.bilstm_forward(zx, wht,
                                                       with_c=False))):
            kept[f"bilstm {label} {(t, nd, b, h)}"] = v.cpu()
    gru_vs_64 = {}
    for t, nd, b, h in BIT_CASES:
        zrz, zn = r(t, nd, b, 2 * h), r(t, nd, b, h)
        wrz, wh, go = u(h, nd, h, 2 * h), u(h, nd, h, h), r(t, nd, b, h)
        hg = ops.gru_forward(zrz, zn, wrz, wh)
        dzrz, dzn, rh = ops.gru_backward(zrz, zn, wrz, wh, hg, go)
        x64 = [v.double() for v in (zrz, zn, wrz, wh)]
        h64 = ops.gru_forward_reference(*x64)
        b64 = ops.gru_backward_reference(*x64, h64, go.double())
        outs = (hg, dzrz, dzn, rh, *ops.gru_dwh(hg, rh, dzrz, dzn))
        refs = (h64, *b64, *ops.gru_dwh_reference(h64, b64[2], *b64[:2]))
        for label, v, ref in zip(GRU_OUTS, outs, refs):
            kept[f"gru {label} {(t, nd, b, h)}"] = v.cpu()
            gru_vs_64[f"gru {label} {(t, nd, b, h)}"] = float(
                (v.double() - ref).abs().max())
    pool_digests, pool_calls = {}, {}
    for shape in [] if recurrence_only else POOLS:
        x = r(*shape).mul_(2).round_().div_(2)   # ties
        geom = ((3, 3), (2, 2), ((0, 1), (0, 1)))
        _, arg = ops.maxpool2d_forward(x, *geom)
        gy = r(*arg.shape)
        call = (lambda arg=arg, gy=gy, geom=geom, shape=shape:
                ops.maxpool2d_backward(arg, gy, *geom, shape))
        pool_digests[f"maxpool2d_backward dx {shape}"] = _digest(call())
        pool_calls[f"maxpool2d_backward {shape}"] = call
    for shape in [] if recurrence_only else S1_POOLS:
        x = r(*shape).mul_(2).round_().div_(2)   # ties
        y = ops.maxpool2d_s1_forward(x, *S1_GEOM)
        gy = r(*y.shape)
        pool_digests[f"maxpool2d_s1 y {shape}"] = _digest(y)
        pool_digests[f"maxpool2d_s1 dx {shape}"] = _digest(
            ops.maxpool2d_s1_backward(x, gy, *S1_GEOM))
        pool_calls[f"maxpool2d_s1_forward {shape}"] = (
            lambda x=x: ops.maxpool2d_s1_forward(x, *S1_GEOM))
        pool_calls[f"maxpool2d_s1_backward {shape}"] = (
            lambda x=x, gy=gy: ops.maxpool2d_s1_backward(x, gy, *S1_GEOM))
    for t, nd, b, h in [FULL] + SIMPLE:
        zr, wr, go = r(t, nd, b, h), u(h, nd, h, h), r(t, nd, b, h)
        hr = ops.rnn_forward(zr, wr)
        kept[f"rnn_forward {(t, nd, b, h)}"] = hr.cpu()
        dr = ops.rnn_backward(wr, hr, go)
        kept[f"rnn_backward {(t, nd, b, h)}"] = dr.cpu()
        kept[f"rnn_dwh {(t, nd, b, h)}"] = ops.rnn_dwh(hr, dr).cpu()
    scan_args = (r(500, 128, 512), u(128, 128, 512),
                 r(128, 128).tanh(), r(128, 128))
    kept["lstm_scan (500, 128, 128)"] = ops.lstm_scan(*scan_args).cpu()
    paged = {} if recurrence_only else {
        name: paged_inputs(torch, g, quantize_rows, name) for name in PAGED}
    for name, (fp, i8) in paged.items():
        kept[f"paged_attention {name}"] = ops.paged_attention(*fp).cpu()
        kept[f"paged_attention_int8 {name}"] = (
            ops.paged_attention_int8(*i8).cpu())
    torch.save(kept, keep)
    flush = torch.empty(64 * 2 ** 20, device="cuda")
    t, nd, b, h = FULL
    zx, wht, go = r(t, nd, b, 4 * h), u(h, nd, h, 4 * h), r(t, nd, b, h)
    hs, cs = ops.bilstm_forward(zx, wht)
    dzx = ops.bilstm_backward(zx, wht, hs, cs, go)
    calls = {"bilstm_forward": lambda: ops.bilstm_forward(zx, wht),
             "bilstm_backward": lambda: ops.bilstm_backward(zx, wht, hs, cs,
                                                            go),
             "bilstm_dwh": lambda: ops.bilstm_dwh(hs, dzx)}
    z1, w1, g1 = zx[:, :1].contiguous(), wht[:1].contiguous(), go[:, :1]
    g1 = g1.contiguous()
    h1, c1 = ops.bilstm_forward(z1, w1)
    calls |= {"bilstm_forward D=1": lambda: ops.bilstm_forward(z1, w1),
              "bilstm_backward D=1": lambda: ops.bilstm_backward(
                  z1, w1, h1, c1, g1)}
    for name, (fp, i8) in paged.items():
        calls |= {f"paged_attention {name}": (
                      lambda fp=fp: ops.paged_attention(*fp)),
                  f"paged_attention_int8 {name}": (
                      lambda i8=i8: ops.paged_attention_int8(*i8))}
    zr, wr = r(t, nd, b, h), u(h, nd, h, h)
    hr = ops.rnn_forward(zr, wr)
    dr = ops.rnn_backward(wr, hr, go)
    zrz, zn = r(t, nd, b, 2 * h), r(t, nd, b, h)
    wrz, wh = u(h, nd, h, 2 * h), u(h, nd, h, h)
    hg = ops.gru_forward(zrz, zn, wrz, wh)
    dzrz, dzn, rh = ops.gru_backward(zrz, zn, wrz, wh, hg, go)
    zg1, ng1, wg1 = zrz[:, :1].contiguous(), zn[:, :1].contiguous(), \
        wrz[:1].contiguous()
    wh1 = wh[:1].contiguous()
    hg1 = ops.gru_forward(zg1, ng1, wg1, wh1)
    calls |= {"rnn_forward": lambda: ops.rnn_forward(zr, wr),
              "rnn_backward": lambda: ops.rnn_backward(wr, hr, go),
              "rnn_dwh": lambda: ops.rnn_dwh(hr, dr),
              "gru_forward": lambda: ops.gru_forward(zrz, zn, wrz, wh),
              "gru_backward": lambda: ops.gru_backward(zrz, zn, wrz, wh,
                                                       hg, go),
              "gru_dwh": lambda: ops.gru_dwh(hg, rh, dzrz, dzn),
              "gru_forward D=1": lambda: ops.gru_forward(zg1, ng1, wg1, wh1),
              "gru_backward D=1": lambda: ops.gru_backward(
                  zg1, ng1, wg1, wh1, hg1, g1),
              "lstm_scan": lambda: ops.lstm_scan(*scan_args), **pool_calls}
    for case in SIMPLE:
        zs, ws, gs = r(*case), u(case[3], 1, case[3], case[3]), r(*case)
        hsm = ops.rnn_forward(zs, ws)
        calls |= {f"rnn_forward {case}": (
                      lambda zs=zs, ws=ws: ops.rnn_forward(zs, ws)),
                  f"rnn_backward {case}": (
                      lambda ws=ws, hsm=hsm, gs=gs: ops.rnn_backward(
                          ws, hsm, gs))}
    times = {name: _ms(torch, fn, flush) for name, fn in calls.items()}
    torch.cuda.synchronize()
    top = []
    for label in ("bilstm", "gru"):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                calls[f"{label}_forward"]()
                calls[f"{label}_backward"]()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        top += [(e.key[:80], e.device_time_total / 3) for e in sorted(
            events, key=lambda e: -e.device_time_total)[:4]]
    import importlib

    pa = importlib.import_module("bigdl_tpu_torch.ops.paged_attention")
    # a tree that splits the walk also runs the long contexts with one
    # walk a row and with the split rule at every width
    modes = {"plan": None}
    if hasattr(pa, "SPLIT_FROM_PAGES"):
        modes |= {"one-walk": 10 ** 9, "split-all": 1}
    model = None if recurrence_only else _model()
    for kv_quant in () if recurrence_only else ("off", "int8"):
        for k, v in serving(torch, model, kv_quant).items():
            times[f"serving {kv_quant} {k}"] = v
        for mode, split_from in modes.items():
            for k, v in long_context(torch, model, kv_quant,
                                     split_from).items():
                times[f"long {kv_quant} {mode} attention_us_step {k}"] = v
    return {"ms": times, "top_us_per_call": top,
            "pool_digests": pool_digests, "gru_vs_float64": gru_vs_64}


def main(argv) -> int:
    if len(argv) == 4 and argv[0] == "--turn":
        print(json.dumps(turn(argv[1], argv[2], argv[3] == "recurrence")))
        return 0
    only = "--recurrence" in argv
    argv = [a for a in argv if a != "--recurrence"]
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip())
    trees = {"parent": argv[0], "change": argv[1]}
    runs = []
    os.makedirs(KEEP, exist_ok=True)
    keep = [os.path.join(KEEP, f"turn{i}.pt") for i in range(4)]
    for i, tag in enumerate(("parent", "change", "change", "parent")):
        out = subprocess.run([sys.executable, __file__, "--turn", trees[tag],
                              keep[i], "recurrence" if only else "all"],
                             capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            print(f"{tag} ({trees[tag]}) failed:\n{out.stderr}",
                  file=sys.stderr)
            return 1
        res = json.loads(out.stdout.strip().splitlines()[-1])
        runs.append((tag, res))
        print(tag, " ".join(f"{k} {v:.5f}" for k, v in res["ms"].items()))
        for key, us in res["top_us_per_call"]:
            print(f"{tag}   {us:10.1f} us/call {key}")
    digests = [res["pool_digests"] for _, res in runs]
    pool_equal = all(d == digests[0] for d in digests)
    for key in digests[0]:
        print(f"{key} equal to the parent's first turn: " + " ".join(
            f"{tag} {d[key] == digests[0][key]}"
            for (tag, _), d in zip(runs[1:], digests[1:])))
    for name in runs[0][1]["ms"]:
        if name.startswith("maxpool2d_s1_"):
            par = [res["ms"][name] for tag, res in runs if tag == "parent"]
            chg = [res["ms"][name] for tag, res in runs if tag == "change"]
            print(f"{name}: change faster than both parent turns in both "
                  f"of its turns {max(chg) < min(par)}")
    import torch

    parent, change = torch.load(keep[0]), torch.load(keep[1])
    again, parent2 = torch.load(keep[2]), torch.load(keep[3])
    worst, repeat = {}, True
    for name in parent:
        diff = float((change[name] - parent[name]).abs().max())
        same = (torch.equal(change[name], again[name])
                and torch.equal(parent[name], parent2[name]))
        repeat &= same
        kind = name.split()[0]
        worst[kind] = max(worst.get(kind, 0.0), diff)
        line = (f"{name}: change vs parent max |diff| {diff:.3e}; each "
                f"tree's bits repeat {same}")
        if kind == "gru":
            line += (f"; from float64 change "
                     f"{runs[1][1]['gru_vs_float64'][name]:.3e} parent "
                     f"{runs[0][1]['gru_vs_float64'][name]:.3e}")
        print(line)
    bits_equal = all(worst[k] == 0.0 for k in worst
                     if k.startswith(("rnn", "bilstm", "gru", "lstm_scan")))
    for name in runs[0][1]["ms"]:
        par = [res["ms"][name] for tag, res in runs if tag == "parent"]
        chg = [res["ms"][name] for tag, res in runs if tag == "change"]
        spread = max(max(par) - min(par), max(chg) - min(chg))
        print(f"{name}: parent {min(par):.5f}-{max(par):.5f} change "
              f"{min(chg):.5f}-{max(chg):.5f} ms; change - parent "
              f"{statistics.mean(chg) - statistics.mean(par):+.5f} against "
              f"a turn-to-turn spread of {spread:.5f}")
    print(json.dumps({"recurrence_bits_equal": bits_equal,
                      "pool_bits_equal": pool_equal,
                      "max_diff_from_parent": worst,
                      "bits_repeat": repeat}))
    return 0 if bits_equal and pool_equal and repeat else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
