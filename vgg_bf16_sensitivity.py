"""How far VGG-16 (CIFAR-10) under BF16_COMPUTE moves with the last bit
of an f32 sum, by batch size, on the CPU.

Two runs of the port's ``VggForCifar10`` under ``BF16_COMPUTE``, dropout
off, from the same parameters, except that the second run's every weight
is moved by one f32 ulp (a random sign each).  The second run replays the
first one's routing (``chip_smoke.Routes``: ReLU masks and pool argmaxes),
as ``chip_smoke.py``'s check against the CPU does.  What the two part by
(the first batch's whole-model gradient, ||a - b|| / ||b||, and the
parameters after two SGD steps at lr 0.01, the largest |a - b|) is what a
card whose f32 sums differ from the CPU's in their last bits parts by
when it is right.  An FP32 run under the same routing is printed beside
it: what a run that ignored the policy would part by.

    python3 vgg_bf16_sensitivity.py 8 16 32 64

The batch is chip_smoke.py's ``bench_batch``: N(0, 1) images, seed 1.
"""
from __future__ import annotations

import sys

import torch

import chip_smoke as cs
from bigdl_tpu_torch import tensor as bt
from bigdl_tpu_torch.models.vgg import VggForCifar10
from bigdl_tpu_torch.nn import ClassNLLCriterion
from bigdl_tpu_torch.utils.random import generator

STEPS, LR = 2, 0.01


def run(batch, pol, nudge, routes):
    """(gradient leaves, flat parameters after STEPS steps, routing choices
    that differed from the replayed record) of one run."""
    bt.set_policy(pol)
    try:
        model = cs.set_dropout(VggForCifar10(10, device="cpu",
                                             generator=generator(1)), 0.0)
        model.train()
        if nudge:
            g = torch.Generator().manual_seed(nudge)
            with torch.no_grad():
                for p in model.parameters():
                    sign = torch.randint(0, 2, p.shape, generator=g) * 2 - 1
                    p.mul_(1 + sign * 2.0 ** -23)
        x = torch.from_numpy(batch.data)
        y = torch.from_numpy(batch.labels)
        with cs.Routes(torch, model, replay=routes.get("probe")) as seen:
            loss = ClassNLLCriterion()(model(x), y)
        routes.setdefault("probe", seen)
        loss.backward()
        grads = [p.grad.detach().double().clone()
                 for p in model.parameters()]
        with cs.Routes(torch, model, replay=routes.get("steps")) as steps:
            for _ in range(STEPS):
                model.zero_grad(set_to_none=True)
                ClassNLLCriterion()(model(x), y).backward()
                with torch.no_grad():
                    for p in model.parameters():
                        p -= LR * p.grad
        routes.setdefault("steps", steps)
        flat = torch.cat([p.detach().flatten() for p in model.parameters()])
        return grads, flat, seen.differ
    finally:
        bt.set_policy(bt.FP32)


def main(batches):
    for b in batches:
        batch = cs.bench_batch((b, 3, 32, 32), 10, 1)
        routes = {}
        g0, p0, _ = run(batch, bt.BF16_COMPUTE, 0, routes)
        line = [f"batch {b}:"]
        for nudge in (5, 6):
            g1, p1, flips = run(batch, bt.BF16_COMPUTE, nudge, routes)
            line.append(f"nudged (seed {nudge}) gradient "
                        f"{cs.model_rel(g1, g0):.3e} params "
                        f"{float((p1 - p0).abs().max()):.3e} ({flips} "
                        f"routing choices replayed against its own);")
        g2, p2, _ = run(batch, bt.FP32, 0, routes)
        line.append(f"FP32 gradient {cs.model_rel(g2, g0):.3e} params "
                    f"{float((p2 - p0).abs().max()):.3e}")
        print(" ".join(line), flush=True)


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [8, 64])
