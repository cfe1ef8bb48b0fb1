"""Where the stride-1 pool's time goes, on one card.

    python3 pool_s1_split.py
    python3 pool_s1_split.py --stages

Builds three forms of ``bigdl_tpu_torch/csrc/maxpool2d_s1.cu`` with nvcc
(into ``bigdl_tpu_torch/build/``): the kernels as they are; their copies
alone (the window, tap and gather compute skipped at run time: the bulk
copies in and the stores out of whatever the buffers hold); their compute
alone (no copy in, no wait and no store: the compute runs on whatever
shared memory holds).  The cuts are guards on lines of the source, and
the script fails if a line it guards is gone.  Times each pass of each
form at Inception-v1's six stride-1 pool inputs (batch 128, 3x3 p1)
beside a PyTorch copy (forward: x read, y written) and add (backward: x
and g read, dx written) moving the same bytes, and the byte bound at
3.35 TB/s: CUDA events, L2 flushed, median of 25.  Prints the card's
name and power limit first and one JSON line of the times last.

``--stages`` builds the kernels as they are with 2, 3, 4 and 6 stages in
the ring (``kStages``; each library plans with its own) and times both
forms, f32 and bf16, of each pass at the same six inputs, with
Inception-v1's step sums (its nine pools: one launch a shape, three at
4b-4d, two at 5a-5b) beside the byte bounds at 4 and 2 bytes an element.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

SHAPES = [(128, 192, 28, 28), (128, 256, 28, 28), (128, 480, 14, 14),
          (128, 512, 14, 14), (128, 528, 14, 14), (128, 832, 7, 7)]
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
# launches an Inception-v1 step (batch 128) takes at each shape
STEP_LAUNCHES = (1, 1, 1, 3, 1, 2)
SKIP = "if (g.plh < 0) "    # pads are never negative: a run-time skip
STAGES_LINE = "constexpr int kStages = 3;"
STAGE_COUNTS = (2, 3, 4, 6)
COMPUTE = ["    for_tasks(tasks, G.np, g.OW, G.r0, G.r1,",
           "    for_tasks(outs, G.np, g.OW, G.gr0, G.gr1,",
           "    for_tasks(ins, G.np, g.W, G.r0, G.r1,"]
COPIES = ["    mbar_wait(&full[s], (k / kStages) & 1);",
          "    store_run(ydst, ys, G.np * yplane);",
          "    store_run(dxdst, dxbuf, G.np * dplane);",
          "  mbar_expect(bar, cover_bytes(xs, nx)",
          "  stage_run(xb, xs, nx, bar);",
          "  if (bwd) stage_run(gb, gs, ng, bar);"]


def guarded(src, lines):
    for line in lines:
        if line not in src:
            raise SystemExit(f"pool_s1_split: the source has no {line!r}")
        indent = len(line) - len(line.lstrip())
        src = src.replace(line, line[:indent] + SKIP + line[indent:])
    return src


def build(name, src):
    from bigdl_tpu_torch.ops import _build

    out_dir = _build.build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, so = out_dir / f"split_{name}.cu", out_dir / f"libsplit_{name}.so"
    cu.write_text(src)
    return subprocess.Popen([_build.nvcc(), *_build.NVCC_FLAGS, "-o",
                             str(so), str(cu)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), so


def load(so):
    lib = ctypes.CDLL(str(so))
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    geom = [ll, *[i] * 9, vp]
    for form in ("f32", "bf16"):
        getattr(lib, f"bigdl_maxpool2d_s1_fwd_{form}").argtypes = [
            vp, vp, *geom]
        getattr(lib, f"bigdl_maxpool2d_s1_bwd_{form}").argtypes = [
            vp, vp, vp, *geom]
    return lib


def built(forms):
    """{name: loaded library} of the sources ``forms``, built in
    parallel; None (the compiler's output printed) where one fails."""
    procs = {name: build(name, s) for name, s in forms.items()}
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"{name}: nvcc exited {proc.returncode}\n{log}",
                  file=sys.stderr)
            return None
        libs[name] = load(so)
    return libs


def stages(torch, src) -> int:
    """Both forms of each pass at each ring depth in STAGE_COUNTS."""
    if STAGES_LINE not in src:
        raise SystemExit(f"pool_s1_split: the source has no {STAGES_LINE!r}")
    libs = built({f"stages{k}": src.replace(
        STAGES_LINE, f"constexpr int kStages = {k};") for k in STAGE_COUNTS})
    if libs is None:
        return 1
    flush = torch.empty(64 * 2 ** 20, device="cuda")   # 256 MB > 50 MB L2
    stream = torch.cuda.current_stream().cuda_stream
    rows, step = {}, {}
    for shape, n_step in zip(SHAPES, STEP_LAUNCHES):
        n, c, h, w = shape
        args = (n * c, h, w, h, w, 3, 3, 1, 1, 0, stream)
        for form, dtype, eb in (("f32", torch.float32, 4),
                                ("bf16", torch.bfloat16, 2)):
            x = torch.randn(shape, device="cuda").to(dtype)
            gy = torch.randn(shape, device="cuda").to(dtype)
            out = torch.empty_like(x)
            fwd = {"bound": 2 * eb * x.numel() / HBM_BYTES_PER_S * 1e3}
            bwd = {"bound": 3 * eb * x.numel() / HBM_BYTES_PER_S * 1e3}
            for name, lib in libs.items():
                f = getattr(lib, f"bigdl_maxpool2d_s1_fwd_{form}")
                b = getattr(lib, f"bigdl_maxpool2d_s1_bwd_{form}")
                fwd[name] = time_ms(torch, lambda: f(
                    x.data_ptr(), out.data_ptr(), *args), flush)
                bwd[name] = time_ms(torch, lambda: b(
                    x.data_ptr(), gy.data_ptr(), out.data_ptr(), *args), flush)
            torch.cuda.synchronize()
            for pass_, row in (("forward", fwd), ("backward", bwd)):
                rows[f"{pass_} {form} {shape}"] = row
                print(f"{pass_} {form} {shape}: " + " ".join(
                    f"{k}={v:.5f}" for k, v in row.items()))
                acc = step.setdefault(f"{pass_} {form}", {})
                for k, v in row.items():
                    acc[k] = acc.get(k, 0.0) + n_step * v
    for key, row in step.items():
        print(f"Inception-v1's step, {key}: " + " ".join(
            f"{k}={v:.5f}" for k, v in row.items()))
    print(json.dumps({"shapes": rows, "inception_step": step}))
    return 0


def time_ms(torch, fn, flush, reps=25, warm=3):
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

    if not torch.cuda.is_available():
        print("pool_s1_split: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip())
    src = (Path(__file__).resolve().parent / "bigdl_tpu_torch" / "csrc"
           / "maxpool2d_s1.cu").read_text()
    if "--stages" in sys.argv[1:]:
        return stages(torch, src)
    libs = built({"kernel": src, "copies_only": guarded(src, COMPUTE),
                  "compute_only": guarded(src, COPIES)})
    if libs is None:
        return 1
    flush = torch.empty(64 * 2 ** 20, device="cuda")   # 256 MB > 50 MB L2
    stream = torch.cuda.current_stream().cuda_stream
    rows = {}
    for shape in SHAPES:
        n, c, h, w = shape
        x = torch.randn(shape, device="cuda")
        gy = torch.randn(shape, device="cuda")
        out = torch.empty_like(x)
        args = (n * c, h, w, h, w, 3, 3, 1, 1, 0, stream)
        fwd = {"same_bytes": time_ms(torch, lambda: out.copy_(x), flush),
               "bound": 8 * x.numel() / HBM_BYTES_PER_S * 1e3}
        bwd = {"same_bytes": time_ms(
                   torch, lambda: torch.add(x, gy, out=out), flush),
               "bound": 12 * x.numel() / HBM_BYTES_PER_S * 1e3}
        for name, lib in libs.items():
            fwd[name] = time_ms(torch, lambda: lib.bigdl_maxpool2d_s1_fwd_f32(
                x.data_ptr(), out.data_ptr(), *args), flush)
            bwd[name] = time_ms(torch, lambda: lib.bigdl_maxpool2d_s1_bwd_f32(
                x.data_ptr(), gy.data_ptr(), out.data_ptr(), *args), flush)
        torch.cuda.synchronize()
        rows[str(shape)] = {"forward": fwd, "backward": bwd}
        for pass_, row in (("forward", fwd), ("backward", bwd)):
            print(f"{pass_} {shape}: " + " ".join(
                f"{k}={v:.5f}" for k, v in row.items()))
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
