"""A/B of the port's recurrence kernels between two trees, on one card.

    python3 recurrence_ab.py PARENT_TREE CHANGE_TREE

Each tree is a checkout of the repository (unpack the other one with
``git archive`` into a directory that ``.gitignore`` lists).  The trees
run in turns, parent, change, change, parent, each turn a fresh process
that imports that tree's ``bigdl_tpu_torch`` and builds its kernels.  A
turn times every recurrence wrapper the tree has (``bilstm_*``, and
``rnn_*``, ``gru_*`` and ``lstm_scan`` where present) at (T, D, B, H) =
(500, 2, 128, 128), ``lstm_scan`` at (T, B, H) = (500, 128, 128) and
``rnn_forward`` / ``rnn_backward`` at SimpleRNN's (4, 1, 4, 40) and (8,
1, 4, 40): CUDA events, L2 flushed before each call, median of 25.  It
lists the four longest kernels of three bilstm forward and backward
calls under the profiler, and digests (sha256) the four bilstm outputs
and the gru outputs of fixed inputs at three shapes, so the trees are
compared bit for bit.  The rnn and ``lstm_scan`` outputs of fixed inputs
are kept (``.recurrence_ab/`` in the working directory) and their largest
differences between the trees printed.  Prints the card's name and power
limit first; exits 1 if a turn fails or the bilstm or gru outputs of the
two trees differ.
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


def turn(tree, keep):
    """One tree's times, top kernels and bilstm and gru digests, as a
    dict; its rnn and lstm_scan outputs saved to ``keep``."""
    sys.path.insert(0, tree)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.utils.device import pin_fp32

    pin_fp32(torch.device("cuda"))
    g = torch.Generator(device="cuda").manual_seed(4)
    r = lambda *s: torch.randn(*s, generator=g, device="cuda")
    u = lambda h, *s: (torch.rand(*s, generator=g, device="cuda") * 2
                       - 1) / h ** 0.5
    digests = {}
    for t, nd, b, h in BIT_CASES:
        zx, wht, go = r(t, nd, b, 4 * h), u(h, nd, h, 4 * h), r(t, nd, b, h)
        hs, cs = ops.bilstm_forward(zx, wht)
        dzx = ops.bilstm_backward(zx, wht, hs, cs, go)
        digests[str((t, nd, b, h))] = [
            _digest(v) for v in (hs, cs, dzx, ops.bilstm_dwh(hs, dzx))]
    gru_digests = {}
    for t, nd, b, h in BIT_CASES:
        zrz, zn = r(t, nd, b, 2 * h), r(t, nd, b, h)
        wrz, wh, go = u(h, nd, h, 2 * h), u(h, nd, h, h), r(t, nd, b, h)
        hg = ops.gru_forward(zrz, zn, wrz, wh)
        dzrz, dzn, rh = ops.gru_backward(zrz, zn, wrz, wh, hg, go)
        gru_digests[str((t, nd, b, h))] = [
            _digest(v) for v in (hg, dzrz, dzn, rh,
                                 *ops.gru_dwh(hg, rh, dzrz, dzn))]
    kept = {}
    for t, nd, b, h in [FULL] + SIMPLE:
        zr, wr, go = r(t, nd, b, h), u(h, nd, h, h), r(t, nd, b, h)
        hr = ops.rnn_forward(zr, wr)
        kept[f"rnn_forward {(t, nd, b, h)}"] = hr.cpu()
        kept[f"rnn_backward {(t, nd, b, h)}"] = ops.rnn_backward(
            wr, hr, go).cpu()
    scan_args = (r(500, 128, 512), u(128, 128, 512),
                 r(128, 128).tanh(), r(128, 128))
    kept["lstm_scan (500, 128, 128)"] = ops.lstm_scan(*scan_args).cpu()
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
    zr, wr = r(t, nd, b, h), u(h, nd, h, h)
    hr = ops.rnn_forward(zr, wr)
    dr = ops.rnn_backward(wr, hr, go)
    zrz, zn = r(t, nd, b, 2 * h), r(t, nd, b, h)
    wrz, wh = u(h, nd, h, 2 * h), u(h, nd, h, h)
    hg = ops.gru_forward(zrz, zn, wrz, wh)
    dzrz, dzn, rh = ops.gru_backward(zrz, zn, wrz, wh, hg, go)
    calls |= {"rnn_forward": lambda: ops.rnn_forward(zr, wr),
              "rnn_backward": lambda: ops.rnn_backward(wr, hr, go),
              "rnn_dwh": lambda: ops.rnn_dwh(hr, dr),
              "gru_forward": lambda: ops.gru_forward(zrz, zn, wrz, wh),
              "gru_backward": lambda: ops.gru_backward(zrz, zn, wrz, wh,
                                                       hg, go),
              "gru_dwh": lambda: ops.gru_dwh(hg, rh, dzrz, dzn),
              "lstm_scan": lambda: ops.lstm_scan(*scan_args)}
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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            calls["bilstm_forward"]()
            calls["bilstm_backward"]()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    top = [(e.key[:80], e.device_time_total / 3)
           for e in sorted(events, key=lambda e: -e.device_time_total)[:4]]
    return {"ms": times, "top_us_per_call": top, "digests": digests,
            "gru_digests": gru_digests}


def main(argv) -> int:
    if len(argv) == 3 and argv[0] == "--turn":
        print(json.dumps(turn(argv[1], argv[2])))
        return 0
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
                              keep[i]],
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
    equal = {}
    for label, key in (("bilstm", "digests"), ("gru", "gru_digests")):
        first = runs[0][1][key]
        equal[label] = all(res[key] == first for _, res in runs)
        for case in first:
            print(f"{label} bits {case}: " + " ".join(
                f"{tag} {[a == b for a, b in zip(res[key][case], first[case])]}"
                for tag, res in runs[1:]))
    import torch

    parent, change = torch.load(keep[0]), torch.load(keep[1])
    again = torch.load(keep[2])
    for name in parent:
        print(f"{name}: change vs parent max |diff| "
              f"{float((change[name] - parent[name]).abs().max()):.3e}; "
              f"change bits repeat {torch.equal(change[name], again[name])}")
    print(json.dumps({"bilstm_bits_equal": equal["bilstm"],
                      "gru_bits_equal": equal["gru"]}))
    return 0 if all(equal.values()) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
