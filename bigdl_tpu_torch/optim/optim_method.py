"""OptimMethod and SGD with its learning-rate schedules (counterpart of
bigdl_tpu/optim/optim_method.py; ref optim/OptimMethod.scala:98,
SGD.scala:26, schedules SGD.scala:128-210).

``init_state(params)`` and ``update(grads, opt_state, params, hyper)``
work over the model's parameter list.  Where the JAX functions return new
pytrees, ``update`` here writes the new values into ``params`` and the
velocity in place (no model-sized copy) and returns them; ``finite`` (a
bool tensor on the card, or None) makes a step with non-finite gradients
leave both as they were, without a host sync.  Config and state live in
``Table``s under the reference's keys.  ``Adagrad`` and the functional
``optimize(feval, x)`` interface come later.
"""
from __future__ import annotations

import torch

from bigdl_tpu_torch.ops import fused_sgd
from bigdl_tpu_torch.utils.table import Table


class OptimMethod:
    def init_state(self, params):
        return {}

    def update(self, grads, opt_state, params, hyper, finite=None):
        """One step in place; returns ``(params, opt_state)``.  ``hyper``
        holds lr, weight_decay, momentum, dampening, nesterov."""
        raise NotImplementedError


class SGD(OptimMethod):
    """SGD with weight decay, momentum, dampening and nesterov, plus the
    LR schedules (ref SGD.scala:26).

    Every update is one pass over every parameter through
    ``ops.fused_sgd``: the hand-written CUDA kernel on the card, one launch
    a step, and its plain version on the CPU.  ``fused`` is accepted for
    the JAX package's signature only; both settings compute the same math
    there, and here they take the same path."""

    def __init__(self, fused: bool = True):
        del fused

    def init_state(self, params):
        return {"velocity": [torch.zeros_like(p) for p in params]}

    def update(self, grads, opt_state, params, hyper, finite=None):
        lr = hyper.get("lr", 1e-3)
        wd = hyper.get("weight_decay", 0.0)
        mom = hyper.get("momentum", 0.0)
        damp = hyper.get("dampening", 0.0)
        nesterov = hyper.get("nesterov", False)
        if hyper.get("lr_scales") is not None:
            raise NotImplementedError(
                "SGD: per-parameter learning rates (state 'learningRates') "
                "are not ported yet")
        fused_sgd(params, grads, opt_state["velocity"], lr, momentum=mom,
                  weight_decay=wd, dampening=damp, nesterov=nesterov,
                  finite=finite)
        return params, opt_state


# ---------------------------------------------------------------------------
# learning-rate schedules (ref SGD.scala:128-210); each writes the
# negative current rate into the config, a Torch habit
# ---------------------------------------------------------------------------

class LearningRateSchedule:
    def update_hyper_parameter(self, config: Table, state: Table):
        raise NotImplementedError

    def scale_at(self, step: int, config: Table) -> float:
        """Multiplicative factor of the base lr at ``step``."""
        raise NotImplementedError


class Default(LearningRateSchedule):
    """lr / (1 + evalCounter * learningRateDecay) (ref SGD.scala Default)."""

    def update_hyper_parameter(self, config: Table, state: Table):
        lr = config.get("learningRate", 1e-3)
        lrd = config.get("learningRateDecay", 0.0)
        n = state.get("evalCounter", 0)
        config["currentLearningRate"] = -lr / (1 + n * lrd)

    def scale_at(self, step, config):
        return 1.0 / (1.0 + step * config.get("learningRateDecay", 0.0))


class Step(LearningRateSchedule):
    """lr * gamma^(floor(evalCounter / stepSize)) (ref SGD.Step)."""

    def __init__(self, step_size: int, gamma: float):
        self.step_size = step_size
        self.gamma = gamma

    def update_hyper_parameter(self, config: Table, state: Table):
        lr = config.get("learningRate", 1e-3)
        n = state.get("evalCounter", 0)
        config["currentLearningRate"] = \
            -lr * self.gamma ** (n // self.step_size)

    def scale_at(self, step, config):
        return self.gamma ** (step // self.step_size)


class Poly(LearningRateSchedule):
    """lr * (1 - iter/maxIter)^power (ref SGD.Poly)."""

    def __init__(self, power: float, max_iteration: int):
        self.power = power
        self.max_iteration = max_iteration

    def update_hyper_parameter(self, config: Table, state: Table):
        lr = config.get("learningRate", 1e-3)
        n = state.get("evalCounter", 0)
        if n > self.max_iteration:
            config["currentLearningRate"] = 0.0
        else:
            config["currentLearningRate"] = \
                -lr * (1 - n / self.max_iteration) ** self.power

    def scale_at(self, step, config):
        frac = min(max(1.0 - step / self.max_iteration, 0.0), 1.0)
        return frac ** self.power


class EpochDecay(LearningRateSchedule):
    """lr * 0.1^decayFn(epoch) (ref SGD.EpochDecay)."""

    def __init__(self, decay_fn):
        self.decay_fn = decay_fn

    def update_hyper_parameter(self, config: Table, state: Table):
        lr = config.get("learningRate", 1e-3)
        config["currentLearningRate"] = \
            -lr * 0.1 ** self.decay_fn(state.get("epoch", 1))


class EpochStep(LearningRateSchedule):
    """lr * gamma^floor((epoch-1)/stepSize) (ref SGD.EpochStep)."""

    def __init__(self, step_size: int, gamma: float):
        self.step_size = step_size
        self.gamma = gamma

    def update_hyper_parameter(self, config: Table, state: Table):
        lr = config.get("learningRate", 1e-3)
        epoch = state.get("epoch", 1)
        config["currentLearningRate"] = \
            -lr * self.gamma ** ((epoch - 1) // self.step_size)


class EpochSchedule(LearningRateSchedule):
    """Explicit per-epoch-range rates (ref SGD.EpochSchedule / Regime)."""

    class Regime:
        def __init__(self, start_epoch, end_epoch, config: Table):
            self.start_epoch = start_epoch
            self.end_epoch = end_epoch
            self.config = config

    def __init__(self, regimes):
        self.regimes = regimes

    def update_hyper_parameter(self, config: Table, state: Table):
        epoch = state.get("epoch", 1)
        for r in self.regimes:
            if r.start_epoch <= epoch <= r.end_epoch:
                config.update(r.config)
        config["currentLearningRate"] = -config.get("learningRate", 1e-3)
