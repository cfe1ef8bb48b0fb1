"""Triggers — predicates over the optimizer's state Table (counterpart of
bigdl_tpu/optim/trigger.py; ref optim/Trigger.scala:22-71)."""
from __future__ import annotations

from bigdl_tpu_torch.utils.table import Table


class Trigger:
    def __init__(self, fn, name="trigger"):
        self._fn = fn
        self._name = name

    def __call__(self, state: Table) -> bool:
        return bool(self._fn(state))

    def __repr__(self):
        return f"Trigger({self._name})"


def every_epoch():
    """Fires when a new epoch begins (ref Trigger.everyEpoch)."""
    holder = {"last": -1}

    def fn(state):
        e = state.get("epoch", 1)
        if e != holder["last"]:
            holder["last"] = e
            return True
        return False

    return Trigger(fn, "everyEpoch")


def several_iteration(interval: int):
    """Fires every ``interval`` iterations (ref Trigger.severalIteration)."""
    return Trigger(lambda s: s.get("neval", 0) % interval == 0
                   and s.get("neval", 0) > 0,
                   f"severalIteration({interval})")


def max_epoch(n: int):
    """End condition: epoch > n (ref Trigger.maxEpoch)."""
    return Trigger(lambda s: s.get("epoch", 1) > n, f"maxEpoch({n})")


def max_iteration(n: int):
    """End condition: neval > n (ref Trigger.maxIteration)."""
    return Trigger(lambda s: s.get("neval", 0) > n, f"maxIteration({n})")


def min_loss(loss: float):
    return Trigger(lambda s: s.get("loss", float("inf")) < loss,
                   f"minLoss({loss})")


def and_trigger(*triggers):
    return Trigger(lambda s: all(t(s) for t in triggers), "and")


def or_trigger(*triggers):
    return Trigger(lambda s: any(t(s) for t in triggers), "or")


# the reference's Python API names
MaxEpoch = max_epoch
MaxIteration = max_iteration
EveryEpoch = every_epoch
SeveralIteration = several_iteration
