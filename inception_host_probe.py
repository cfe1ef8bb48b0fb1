#!/usr/bin/env python3
"""Inception-v1's step on the card with the prefetch on and off, under
four host configurations, each in its own process: as is; with one
OpenMP thread (``OMP_NUM_THREADS=1``); with OpenMP's spin-wait off
(``GOMP_SPINCOUNT=0``); and with glibc's mmap threshold raised past a
batch (``MALLOC_MMAP_THRESHOLD_``), so that batch buffers are not mapped
and faulted anew.  Each process runs examples/train_inception.py's
synthetic step at batch 128 (chip_smoke.py's ``inception_run``), 6
steps after 2, prefetch on, off, on, off, and prints one ``RESULT``
line: for each setting, (ms a step, dispatch ms a step) of each turn.
Run from the repository root on a machine with the card:

    python3 inception_host_probe.py

``python3 inception_host_probe.py ops`` times the host ops instead: each
op's µs an image through the C loop and through its numpy version
(``native=False``), on a 28x28 digit and on a 224x224x3 image (the
median of five rounds), then LeNet-5's step (examples/train_lenet.py,
batch 128, chip_smoke.py's ``lenet_run``) with its chain on each, numpy,
C, numpy, C, 32 steps after 8; one ``RESULT`` line.
"""
import json
import os
import subprocess
import sys
import time

CONFIGS = (("base", {}), ("omp1", {"OMP_NUM_THREADS": "1"}),
           ("nospin", {"GOMP_SPINCOUNT": "0"}),
           ("nommap", {"MALLOC_MMAP_THRESHOLD_": "1073741824",
                       "MALLOC_TRIM_THRESHOLD_": "1073741824",
                       "MALLOC_TOP_PAD_": "536870912"}))


def child():
    import torch

    import chip_smoke as smoke
    from bigdl_tpu_torch.models.inception import Inception_v1
    from bigdl_tpu_torch.nn.module import export_params
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.optim import max_iteration
    from bigdl_tpu_torch.utils.device import pin_fp32
    from bigdl_tpu_torch.utils.random import RNG, generator

    pin_fp32(torch.device("cuda"))
    _build.build(["maxpool2d", "maxpool2d_s1", "lrn", "fused_sgd"])
    init = export_params(Inception_v1(1000, device="cpu",
                                      generator=generator(0)))
    images = smoke.inception_images(512, 256, 0)
    out = {}
    for on in (True, False, True, False):
        os.environ["BIGDL_PREFETCH"] = "1" if on else "0"
        RNG.set_seed(0)
        opt = smoke.inception_run(torch, "cuda", init, images, 128,
                                  max_iteration(2))
        opt.optimize()
        opt.set_end_when(max_iteration(8))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.optimize()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / 6 * 1e3
        dispatch_s, _ = opt.metrics.get("train time")
        out.setdefault(str(on), []).append(
            (round(step_ms, 2), round(dispatch_s / 8 * 1e3, 2)))
    print("RESULT", os.environ.get("PROBE"), json.dumps(out), flush=True)


def _per_image_us(fn, reps):
    rounds = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        rounds.append((time.perf_counter() - t0) / reps * 1e6)
    return round(sorted(rounds)[2], 3)


def ops_probe():
    import functools

    import numpy as np
    import torch

    import chip_smoke as smoke
    from bigdl_tpu_torch import native
    from bigdl_tpu_torch.models.lenet import LeNet5
    from bigdl_tpu_torch.nn.module import export_params
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.optim import max_iteration
    from bigdl_tpu_torch.utils.device import pin_fp32
    from bigdl_tpu_torch.utils.random import generator

    out = {}
    rng = np.random.RandomState(0)
    for label, shape, reps in (("28x28", (28, 28), 4000),
                               ("224x224x3", (224, 224, 3), 100)):
        img = rng.uniform(0, 255, shape).astype(np.float32)
        c = 1 if img.ndim == 2 else 3
        mean = np.full(c, 33.3, np.float32) if c > 1 else 33.3
        std = np.full(c, 78.6, np.float32) if c > 1 else 78.6
        h, w = shape[:2]
        calls = {
            "normalize": lambda nat: native.normalize(img, mean, std,
                                                      native=nat),
            "crop": lambda nat: native.crop(img, 1, 1, h - 2, w - 2,
                                            native=nat),
            "hflip": lambda nat: native.hflip(img, native=nat),
            "hwc_to_chw": lambda nat: native.hwc_to_chw(img, native=nat)}
        out[label] = {name: {"c": _per_image_us(lambda: f(True), reps),
                             "numpy": _per_image_us(lambda: f(False), reps)}
                      for name, f in calls.items()}
    pin_fp32(torch.device("cuda"))
    _build.build(["maxpool2d", "fused_sgd"])
    init = export_params(LeNet5(10, device="cpu", generator=generator(0)))
    plain = {name: functools.partial(getattr(native, name), native=False)
             for name in ("normalize", "hwc_to_chw")}
    c_ops = {name: getattr(native, name) for name in plain}
    for path in ("numpy", "c", "numpy", "c"):
        for name, fn in (plain if path == "numpy" else c_ops).items():
            setattr(native, name, fn)
        opt = smoke.lenet_run(torch, "cuda", init, max_iteration(8),
                              validate=False)
        opt.optimize()
        opt.set_end_when(max_iteration(40))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.optimize()
        torch.cuda.synchronize()
        out.setdefault(f"lenet_ms_{path}", []).append(
            round((time.perf_counter() - t0) / 32 * 1e3, 4))
    for name, fn in c_ops.items():
        setattr(native, name, fn)
    print("RESULT ops", json.dumps(out), flush=True)


def main():
    for name, env in CONFIGS:
        proc = subprocess.run(
            [sys.executable, __file__, "child"],
            env=dict(os.environ, PROBE=name, **env), capture_output=True,
            text=True)
        lines = [l for l in proc.stdout.splitlines()
                 if l.startswith("RESULT")]
        print(lines[0] if lines else proc.stderr[-2000:], flush=True)
        if not lines:
            return 1
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if sys.argv[1:] == ["child"]:
        child()
    elif sys.argv[1:] == ["ops"]:
        ops_probe()
    else:
        sys.exit(main())
