"""Every cluster plan of the rnn, LSTM and GRU kernels, timed, on one card.

    python3 recurrence_plans.py

For each shape the kernels run on a main path -- ``rnn_forward`` and
``rnn_backward`` at (T, D, B, H) = (500, 2, 128, 128), (500, 1, 128, 128)
and SimpleRNN's (4, 1, 4, 40), ``bilstm_forward`` (with the c stack) and
``bilstm_backward`` at (500, 2, 128, 128) and (500, 1, 128, 128) (the
forward at D = 1 is also ``lstm_scan``'s kernel and plan at (T, B, H) =
(500, 128, 128)), ``gru_forward`` and ``gru_backward`` at (500, 2, 128,
128) and (500, 1, 128, 128) -- it launches the kernel at every (C, R) of
``csrc/recurrence_cluster.cuh``'s choices that fits (the C entries take
an explicit plan; the wrappers pass none and get the plan of the shape),
holds each output to the plain version (rtol 1e-5 / atol 1e-6 forward,
1e-4 / 1e-5 backward; the GRU's, where the 500-step chain leaves that,
within twice the plain fp32 version's own distance from a float64 run),
and times it: CUDA events, L2 flushed before each call, median of 10.
The GRU backward's time includes its gates pre-pass.  Prints the card's
name and power limit, then a line a shape with the plans fastest first,
the one the plan rule picks marked ``*``, then one JSON line of every
time.  Exits 1 if a plan's
output leaves the tolerance.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys

RNN_SHAPES = [(500, 2, 128, 128), (500, 1, 128, 128), (4, 1, 4, 40)]
LSTM_SHAPES = [(500, 2, 128, 128), (500, 1, 128, 128)]
GRU_SHAPES = LSTM_SHAPES


def _ms(torch, fn, flush, reps=10, warm=2):
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


def main() -> int:
    import torch

    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.ops import _recurrence as rec
    from bigdl_tpu_torch.ops import bilstm, gru, rnn
    from bigdl_tpu_torch.ops._activation import TANH
    from bigdl_tpu_torch.utils.device import pin_fp32

    if not torch.cuda.is_available():
        print("recurrence_plans: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip())
    pin_fp32(torch.device("cuda"))
    g = torch.Generator(device="cuda").manual_seed(11)
    r = lambda *s: torch.randn(*s, generator=g, device="cuda")
    u = lambda h, *s: (torch.rand(*s, generator=g, device="cuda") * 2
                       - 1) / h ** 0.5
    flush = torch.empty(64 * 2 ** 20, device="cuda")
    dev = _build.device_stream(torch.device("cuda"))
    rnn_lib = rec.load("rnn", rnn._setup)
    lstm_lib = rec.load("bilstm", bilstm._setup)
    gru_lib = rec.load("gru", gru._setup)
    fwd = dict(rtol=1e-5, atol=1e-6)
    bwd = dict(rtol=1e-4, atol=1e-5)

    def rnn_case(t, nd, b, h, backward):
        """(name, chosen plan, launch(C, R), output, plain output, tol)."""
        zx, wht, gout = r(t, nd, b, h), u(h, nd, h, h), r(t, nd, b, h)
        hs = ops.rnn_forward_reference(zx, wht)
        out = torch.empty_like(hs)
        if backward:
            want = ops.rnn_backward_reference(wht, hs, gout)
            launch = lambda c, rows: rnn_lib.bigdl_rnn_bwd_f32(
                None, wht.data_ptr(), hs.data_ptr(), None, gout.data_ptr(),
                out.data_ptr(), t, nd, b, h, c, rows, *TANH.entry_args,
                *dev)
        else:
            want = hs
            launch = lambda c, rows: rnn_lib.bigdl_rnn_fwd_f32(
                zx.data_ptr(), wht.data_ptr(), None, out.data_ptr(), t, nd,
                b, h, c, rows, *TANH.entry_args, *dev)
        name = f"rnn_{'backward' if backward else 'forward'} {(t, nd, b, h)}"
        return (name, rnn.plan(nd, b, h, backward), launch, out, want,
                bwd if backward else fwd)

    def lstm_case(t, nd, b, h, backward):
        """The bilstm forward (with the c stack) or backward at (C, R);
        the backward's call includes its gates pre-pass."""
        zx, wht, gout = r(t, nd, b, 4 * h), u(h, nd, h, 4 * h), r(t, nd, b, h)
        hs, cs = ops.bilstm_forward_reference(zx, wht)
        if backward:
            out = torch.empty_like(zx)
            want = ops.bilstm_backward_reference(zx, wht, hs, cs, gout)
            launch = lambda c, rows: lstm_lib.bigdl_lstm_bwd_f32(
                zx.data_ptr(), wht.data_ptr(), hs.data_ptr(), cs.data_ptr(),
                None, None, gout.data_ptr(), out.data_ptr(), t, nd, b, h, c,
                rows, *dev)
        else:
            out, c_out = torch.empty_like(hs), torch.empty_like(cs)
            want = hs
            launch = lambda c, rows: lstm_lib.bigdl_lstm_fwd_f32(
                zx.data_ptr(), wht.data_ptr(), None, None, out.data_ptr(),
                c_out.data_ptr(), t, nd, b, h, c, rows, *dev)
        name = (f"bilstm_{'backward' if backward else 'forward'} "
                f"{(t, nd, b, h)}")
        return (name, bilstm.plan(nd, b, h, backward), launch, out, want,
                bwd if backward else fwd)

    def gru_case(t, nd, b, h, backward):
        """The gru forward or backward (its three outputs, the plain
        versions' in fp32 and float64 beside them) at (C, R)."""
        zrz, zn, gout = r(t, nd, b, 2 * h), r(t, nd, b, h), r(t, nd, b, h)
        wrz, wh = u(h, nd, h, 2 * h), u(h, nd, h, h)
        x64 = [v.double() for v in (zrz, zn, wrz, wh)]
        hs = ops.gru_forward_reference(zrz, zn, wrz, wh)
        if backward:
            outs = [torch.empty_like(zrz), torch.empty_like(zn),
                    torch.empty_like(zn)]
            want = ops.gru_backward_reference(zrz, zn, wrz, wh, hs, gout)
            want64 = ops.gru_backward_reference(*x64, hs.double(),
                                                gout.double())
            launch = lambda c, rows: gru_lib.bigdl_gru_bwd_f32(
                *(v.data_ptr() for v in (zrz, zn, wrz, wh, hs)), None,
                *(v.data_ptr() for v in (gout, *outs)), t, nd, b, h, c,
                rows, *dev)
        else:
            outs = [torch.empty_like(hs)]
            want, want64 = [hs], [ops.gru_forward_reference(*x64)]
            launch = lambda c, rows: gru_lib.bigdl_gru_fwd_f32(
                zrz.data_ptr(), zn.data_ptr(), wrz.data_ptr(), wh.data_ptr(),
                None, outs[0].data_ptr(), t, nd, b, h, c, rows, *dev)
        name = f"gru_{'backward' if backward else 'forward'} {(t, nd, b, h)}"
        return (name, gru.plan(nd, b, h, backward), launch, outs,
                list(zip(want, want64)), bwd if backward else fwd)

    cases = [rnn_case(*shape, backward) for shape in RNN_SHAPES
             for backward in (False, True)] + [
        lstm_case(*shape, backward) for shape in LSTM_SHAPES
        for backward in (False, True)] + [
        gru_case(*shape, backward) for shape in GRU_SHAPES
        for backward in (False, True)]
    report, ok = {}, True
    for name, chosen, launch, out, want, tol in cases:
        times = []
        for c in rec.CLUSTER_SIZES:
            for rows in rec.CLUSTER_ROWS:
                if launch(c, rows) != 0:   # (C, R) does not fit
                    continue
                torch.cuda.synchronize()
                for got, w in (zip(out, want) if isinstance(out, list)
                               else [(out, (want, None))]):
                    w32, w64 = w
                    if torch.allclose(got, w32, **tol) or (
                            w64 is not None and float(
                                (got - w64).abs().max()) <= 2 * float(
                                (w32 - w64).abs().max())):
                        continue
                    ok = False
                    print(f"{name} C={c} R={rows}: "
                          f"{float((got - w32).abs().max()):.3e} from the "
                          f"plain version")
                times.append((_ms(torch, lambda: launch(c, rows), flush),
                              f"C{c}R{rows}"))
        times.sort()
        pick = f"C{chosen['C']}R{chosen['R']}"
        print(f"{name}: " + " ".join(
            f"{key}{'*' if key == pick else ''}={ms:.5f}"
            for ms, key in times))
        report[name] = {key: ms for ms, key in times}
    print(json.dumps({"plans_ms": report, "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
