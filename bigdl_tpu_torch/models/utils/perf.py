"""Synthetic-data throughput harnesses (counterpart of
bigdl_tpu/models/utils/perf.py) — the LocalOptimizerPerf /
DistriOptimizerPerf CLIs (ref models/utils/DistriOptimizerPerf.scala:41-138,
LocalOptimizerPerf.scala).

Usage:
  python -m bigdl_tpu_torch.models.utils.perf --model inception_v1 -b 128 -i 20
  python -m bigdl_tpu_torch.models.utils.perf --model vgg16 -b 64 --distributed

Flags mirror the reference's scopt options: --batchSize/-b, --iteration/-i,
--model/-m (alexnet | alexnetowt | googlenet_v1 | inception_v1 |
googlenet_v2 | inception_v2 | vgg16 | vgg19 | lenet5), --dataType
(float | bf16: the dtype policy ``tensor.FP32`` or ``tensor.BF16_COMPUTE``),
--device (``cuda`` unless asked for ``cpu``).

A step is the training loop's: the forward, the criterion, the backward
and one ``fused_sgd`` update (lr 0.01, momentum 0.9), on a batch that
lives on the device, drawn once from ``RandomState(0)``.  With
``--distributed`` each rank takes its share of the batch and the
gradients are averaged over the world (``torch.distributed``, the group
``Engine.ensure_group`` forms).  ``--iterationsPerDispatch n`` steps over
n distinct batches back to back between two host reads of the loss (the
JAX harness scans them in one dispatch).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

MODELS = {}


def _register():
    from bigdl_tpu_torch.models.alexnet import AlexNet, AlexNet_OWT
    from bigdl_tpu_torch.models.inception import Inception_v1, Inception_v2
    from bigdl_tpu_torch.models.lenet import LeNet5
    from bigdl_tpu_torch.models.vgg import Vgg_16, Vgg_19
    MODELS.update({
        "alexnet": (lambda d: AlexNet(1000, device=d), (3, 227, 227), 1000),
        "alexnetowt": (lambda d: AlexNet_OWT(1000, device=d), (3, 224, 224),
                       1000),
        "googlenet_v1": (lambda d: Inception_v1(1000, device=d),
                         (3, 224, 224), 1000),
        "inception_v1": (lambda d: Inception_v1(1000, device=d),
                         (3, 224, 224), 1000),
        "googlenet_v2": (lambda d: Inception_v2(1000, device=d),
                         (3, 224, 224), 1000),
        "inception_v2": (lambda d: Inception_v2(1000, device=d),
                         (3, 224, 224), 1000),
        "vgg16": (lambda d: Vgg_16(1000, device=d), (3, 224, 224), 1000),
        "vgg19": (lambda d: Vgg_19(1000, device=d), (3, 224, 224), 1000),
        "lenet5": (lambda d: LeNet5(10, device=d), (1, 28, 28), 10),
    })


def _sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_perf(model_name: str, batch_size: int, iterations: int,
             warmup: int = 3, distributed: bool = False,
             data_type: str = "bf16", iters_per_dispatch: int = 1,
             device: str = "cuda") -> dict:
    """Train ``model_name`` on synthetic data: the first step (kernel
    builds, cuDNN's choices) timed alone as ``compile_time_s``, ``warmup
    - 1`` more untimed, then ``iterations`` dispatches timed.  The JAX
    harness's dict."""
    import torch
    import torch.distributed as dist

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch import tensor as bt
    from bigdl_tpu_torch.dataset.dataset import get_batch_size
    from bigdl_tpu_torch.optim.optim_method import SGD
    from bigdl_tpu_torch.utils.engine import Engine
    from bigdl_tpu_torch.utils.random import RNG

    _register()
    RNG.set_seed(1)
    bt.set_policy(bt.BF16_COMPUTE if data_type == "bf16" else bt.FP32)
    build, shape, n_classes = MODELS[model_name]
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(1)
        model = build(device)
    model.train()
    criterion = nn.ClassNLLCriterion()
    method = SGD()
    params = list(model.parameters())
    opt_state = method.init_state(params)
    hyper = {"lr": 0.01, "momentum": 0.9, "dampening": 0.0,
             "weight_decay": 0.0, "nesterov": False}
    world, rank = 1, 0
    if distributed:
        group = Engine.ensure_group(device)
        world, rank = dist.get_world_size(group), dist.get_rank(group)
    local = get_batch_size(batch_size, world)
    n_disp = max(1, int(iters_per_dispatch))
    rs = np.random.RandomState(0)
    xs = rs.randn(n_disp, batch_size, *shape).astype(np.float32)
    ys = rs.randint(1, n_classes + 1, (n_disp, batch_size))
    rows = slice(rank * local, (rank + 1) * local)
    xs = torch.from_numpy(xs[:, rows].copy()).to(device)
    ys = torch.from_numpy(ys[:, rows].astype(np.float32)).to(device)

    def step(x, y):
        for p in params:
            p.grad = None
        loss = criterion(model(x), y)
        loss.backward()
        loss = loss.detach()
        grads = [p.grad for p in params]
        if world > 1:
            for t in grads + [loss]:
                dist.all_reduce(t)
                t.div_(world)
        method.update(grads, opt_state, params, hyper)
        return loss

    def dispatch():
        loss = None
        for i in range(n_disp):
            loss = step(xs[i], ys[i])
        return loss

    compile_t0 = time.perf_counter()
    float(dispatch())
    compile_time = time.perf_counter() - compile_t0
    for _ in range(warmup - 1):
        dispatch()
    _sync(torch, device)
    t0 = time.perf_counter()
    for _ in range(iterations):
        loss = dispatch()
    last_loss = float(loss)   # syncs the step chain
    dt = (time.perf_counter() - t0) / (iterations * n_disp)
    bt.set_policy(bt.FP32)
    return {
        "model": model_name,
        "batch_size": batch_size,
        "iters_per_dispatch": n_disp,
        "distributed": distributed,
        "devices": world,
        "step_time_ms": round(dt * 1e3, 3),
        "throughput_records_per_sec": round(batch_size / dt, 2),
        "compile_time_s": round(compile_time, 2),
        "loss": last_loss,
    }


def main(argv=None, force_distributed=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", "-m", default="inception_v1")
    p.add_argument("--batchSize", "-b", type=int, default=128)
    p.add_argument("--iteration", "-i", type=int, default=10)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--dataType", choices=["float", "bf16"], default="bf16")
    p.add_argument("--iterationsPerDispatch", type=int, default=1,
                   help="n steps over n distinct batches a host read")
    p.add_argument("--distributed", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if force_distributed is not None and args.distributed != force_distributed:
        p.error("--distributed conflicts with this entry point; use "
                "`python -m bigdl_tpu_torch.models.utils.perf --distributed` "
                "instead")
    distributed = (force_distributed if force_distributed is not None
                   else args.distributed)
    result = run_perf(args.model, args.batchSize, args.iteration,
                      args.warmup, distributed, args.dataType,
                      iters_per_dispatch=args.iterationsPerDispatch,
                      device=args.device)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
