"""Rank functions for the port's observability tests (spawned by
``parallel.launch``; this module imports the port alone, as the ranks
must)."""
import os

import numpy as np
import torch.distributed as dist

from bigdl_tpu_torch.nn.module import load_jax_params
from bigdl_tpu_torch.obs import events
from bigdl_tpu_torch.optim import DistriOptimizer, max_iteration
from bigdl_tpu_torch.utils.table import T
from tests.helpers import torch_distri_workers as W


def taps_case(spec: dict, run_dir: str) -> dict:
    """Train as ``spec`` says (``W.run``'s keys: model, init, xs, ys,
    batch, seed, state, iters, kw) with the taps read every step and the
    events of this rank under ``run_dir``; the taps of each step, the
    losses and this rank's event file."""
    events.configure(run_dir)
    try:
        model = load_jax_params(W.build(spec["model"]), spec["init"])
        opt = DistriOptimizer(model, W.dataset(spec), W.criterion(spec),
                              device="cpu", **spec.get("kw", {}))
        opt.set_state(T(**spec["state"]))
        opt.set_end_when(max_iteration(spec["iters"]))
        opt.set_taps(True, 1)
        if spec.get("abort_after"):
            opt.set_nonfinite_policy(spec["abort_after"])
        poison = spec.get("poison", {}).get(dist.get_rank())
        if poison is not None:
            step = opt._train_step

            def poisoned(params, opt_state, x, y, hyper, taps=None):
                if int(opt.state["neval"]) == poison:
                    x = x.clone().fill_(float("nan"))
                return step(params, opt_state, x, y, hyper, taps=taps)
            opt._train_step = poisoned
        error = None
        try:
            opt.optimize()
        except Exception as e:   # the abort: its type and the bundle
            error = type(e).__name__
        return {"taps": [(s, v) for s, v in opt._taps_monitor.history],
                "per_host": opt.spans.per_host_report(),
                "loss": [l for _, l in opt.loss_log],
                "error": error,
                "path": events.get().path,
                "bundles": sorted(d for d in os.listdir(run_dir)
                                  if d.startswith("crash-")),
                "rank": dist.get_rank(),
                "params": [np.asarray(p.detach()) for p in
                           model.parameters()]}
    finally:
        events.reset()


def taps_cases(specs: list, run_dirs: list) -> list:
    """Several :func:`taps_case` runs in one process group."""
    out = []
    for spec, run_dir in zip(specs, run_dirs):
        out.append(taps_case(spec, run_dir))
        dist.barrier()
    return out
