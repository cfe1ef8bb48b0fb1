"""A/B of the port's recurrence kernels between two trees, on one card.

    python3 recurrence_ab.py PARENT_TREE CHANGE_TREE

Each tree is a checkout of the repository (unpack the other one with
``git archive`` into a directory that ``.gitignore`` lists).  The trees
run in turns, parent, change, change, parent, each turn a fresh process
that imports that tree's ``bigdl_tpu_torch`` and builds its kernels.  A
turn times every recurrence wrapper the tree has (``bilstm_*``, and
``rnn_*`` and ``gru_*`` where present) at (T, D, B, H) = (500, 2, 128,
128): CUDA events, L2 flushed before each call, median of 25.  It lists
the four longest kernels of three bilstm forward and backward calls under
the profiler, and digests (sha256) the four bilstm outputs of fixed
inputs at three shapes, so the trees are compared bit for bit.  Prints
the card's name and power limit first; exits 1 if a turn fails or the
bilstm outputs of the two trees differ.
"""
from __future__ import annotations

import hashlib
import json
import statistics
import subprocess
import sys

FULL = (500, 2, 128, 128)
BIT_CASES = [FULL, (13, 2, 37, 100), (3, 2, 9, 558)]


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


def turn(tree):
    """One tree's times, top kernels and bilstm digests, as a dict."""
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
            hashlib.sha256(v.cpu().numpy().tobytes()).hexdigest()
            for v in (hs, cs, dzx, ops.bilstm_dwh(hs, dzx))]
    flush = torch.empty(64 * 2 ** 20, device="cuda")
    t, nd, b, h = FULL
    zx, wht, go = r(t, nd, b, 4 * h), u(h, nd, h, 4 * h), r(t, nd, b, h)
    hs, cs = ops.bilstm_forward(zx, wht)
    dzx = ops.bilstm_backward(zx, wht, hs, cs, go)
    calls = {"bilstm_forward": lambda: ops.bilstm_forward(zx, wht),
             "bilstm_backward": lambda: ops.bilstm_backward(zx, wht, hs, cs,
                                                            go),
             "bilstm_dwh": lambda: ops.bilstm_dwh(hs, dzx)}
    if hasattr(ops, "rnn_forward"):
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
                  "gru_dwh": lambda: ops.gru_dwh(hg, rh, dzrz, dzn)}
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
    return {"ms": times, "top_us_per_call": top, "digests": digests}


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--turn":
        print(json.dumps(turn(argv[1])))
        return 0
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip())
    trees = {"parent": argv[0], "change": argv[1]}
    runs = []
    for tag in ("parent", "change", "change", "parent"):
        out = subprocess.run([sys.executable, __file__, "--turn", trees[tag]],
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
    first = runs[0][1]["digests"]
    same = all(res["digests"] == first for _, res in runs)
    for case in first:
        print(f"bilstm bits {case}: " + " ".join(
            f"{tag} {[a == b for a, b in zip(res['digests'][case], first[case])]}"
            for tag, res in runs[1:]))
    print(json.dumps({"bilstm_bits_equal": same}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
