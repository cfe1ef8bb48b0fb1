"""Optimizer factory (counterpart of bigdl_tpu/optim/optimizer.py; ref
optim/Optimizer.scala:30,151-186).  The port has local datasets only, so
every dataset gets a ``LocalOptimizer``; the distributed optimizer and
the checkpoint helpers come with later slices."""
from __future__ import annotations

from bigdl_tpu_torch.optim.local_optimizer import LocalOptimizer


def Optimizer(model, dataset, criterion, *, optim_method=None, state=None,
              end_trigger=None, device="cuda"):
    """(ref Optimizer.apply :151-186) — a ``LocalOptimizer`` on
    ``device`` (the card unless the caller asks for the CPU), with the
    optional method, state Table and end trigger already set."""
    opt = LocalOptimizer(model, dataset, criterion, device=device)
    if optim_method is not None:
        opt.set_optim_method(optim_method)
    if state is not None:
        opt.set_state(state)
    if end_trigger is not None:
        opt.set_end_when(end_trigger)
    return opt
