"""OptimMethod, SGD and Adagrad with the learning-rate schedules
(counterpart of bigdl_tpu/optim/optim_method.py; ref
optim/OptimMethod.scala:98, SGD.scala:26, Adagrad.scala:26, schedules
SGD.scala:128-210).

Two faces, as in the JAX package:

- ``optimize(feval, x, config, state)``, the reference's functional
  interface: ``x`` is what ``feval`` takes (a tensor, a list of tensors or
  a nested dict of them, the JAX tree layout), ``feval(x)`` returns
  ``(loss, grads)`` of the same layout, and the call returns ``(new x,
  [loss])``; config and state are ``Table``s under the reference's keys
  (``learningRate``, ``weightDecay``, ``momentum``, ``dampening``,
  ``nesterov``, ``learningRateDecay``, ``learningRates``, ``evalCounter``,
  ``dfdx``, ``paramVariance``, ``currentLearningRate``);
- ``init_state(params)`` and ``update(grads, opt_state, params, hyper)``
  over the model's parameter list, what the optimizers run.  Where the
  JAX functions return new pytrees, ``update`` here writes the new
  values into ``params`` and the optimizer's state in place (no
  model-sized copy) and returns them; ``finite`` (a bool tensor on the
  leaves' device, or None) makes a step with non-finite gradients leave
  all of them as they were, without a host sync; ``taps`` (4 float64 on
  the leaves' device, or None) gains the step's tap sums
  (``obs/taps.py``): SGD's kernel adds them as it updates, another
  method through :meth:`OptimMethod._tap`, a plain pass over a pre-step
  copy of the parameters kept only while taps are on.
"""
from __future__ import annotations

import torch

from bigdl_tpu_torch.ops import fused_sgd
from bigdl_tpu_torch.utils.table import T, Table


def tree_map(fn, *trees):
    """``fn`` over the leaves of tensors, lists / tuples or dicts of them
    (the layouts ``optimize``'s ``x`` takes), the structure kept; a dict's
    keys in sorted order, as a JAX tree orders them."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees))
                for k in sorted(first)}
    if isinstance(first, (list, tuple)):
        return type(first)(tree_map(fn, *z) for z in zip(*trees))
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The leaves of a tree of :func:`tree_map`'s layouts, in the JAX
    order (``jax.tree_util.tree_leaves``)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


class OptimMethod:
    def optimize(self, feval, x, config: Table = None, state: Table = None):
        """One step of the reference's functional interface: ``(new x,
        [losses])``."""
        raise NotImplementedError

    def clear_history(self, state: Table):
        raise NotImplementedError

    def get_hyper_parameter(self, config: Table) -> str:
        return ""

    def update_hyper_parameter(self, config: Table, state: Table):
        pass

    def init_state(self, params):
        return {}

    def update(self, grads, opt_state, params, hyper, finite=None,
               taps=None):
        """One step in place; returns ``(params, opt_state)``.  ``hyper``
        holds lr, weight_decay, momentum, dampening, nesterov, lr_decay
        and lr_scales; ``taps`` gains the step's tap sums."""
        raise NotImplementedError

    def _pre_step(self, params, taps):
        """The parameters' pre-step copy for :meth:`_tap` (None while
        taps are off), in buffers kept across steps for one set of
        parameter addresses."""
        if taps is None:
            return None
        key = tuple((p.data_ptr(), p.numel()) for p in params)
        kept = getattr(self, "_kept_params", None)
        if kept is None or kept[0] != key:
            kept = self._kept_params = (key, [torch.empty_like(p)
                                              for p in params])
        with torch.no_grad():
            torch._foreach_copy_(kept[1], params)
        return kept[1]

    @staticmethod
    def _tap(grads, before, params, taps):
        """Add the step's tap sums (``obs.taps.sums``) into ``taps``."""
        if taps is not None:
            from bigdl_tpu_torch.obs.taps import sums
            sums(grads, before, params, out=taps)


class SGD(OptimMethod):
    """SGD with weight decay, momentum, dampening and nesterov, plus the
    LR schedules (ref SGD.scala:26).

    Every ``update`` is one pass over every parameter through
    ``ops.fused_sgd``: the hand-written CUDA kernel on the card, one launch
    a step, and its plain version on the CPU; per-parameter learning rates
    (``hyper['lr_scales']``, one tensor a leaf) take the kernel's scaled
    form.  ``fused`` is accepted for the JAX package's signature only;
    both settings compute the same math there, and here they take the
    same path."""

    def __init__(self, fused: bool = True):
        del fused

    def optimize(self, feval, x, config: Table = None, state: Table = None):
        """The reference's SGD step over ``x`` (bigdl_tpu/optim/
        optim_method.py:67-102): the schedule writes the negative
        ``currentLearningRate``; ``dfdx`` keeps the momentum buffer and
        ``evalCounter`` counts the calls."""
        config = config if config is not None else T()
        state = state if state is not None else config
        schedule = config.get("learningRateSchedule", Default())
        schedule.update_hyper_parameter(config, state)
        clr = -config.get("currentLearningRate",
                          -config.get("learningRate", 1e-3))
        wd = config.get("weightDecay", 0.0)
        mom = config.get("momentum", 0.0)
        damp = config.get("dampening", mom)  # Torch: dampening = momentum
        nesterov = config.get("nesterov", False)
        lrs = config.get("learningRates", None)

        loss, dfdx = feval(x)
        with torch.no_grad():
            if wd != 0:
                dfdx = tree_map(lambda g, p: g + wd * p, dfdx, x)
            if mom != 0:
                if "dfdx" not in state:
                    state["dfdx"] = tree_map(torch.clone, dfdx)
                else:
                    state["dfdx"] = tree_map(
                        lambda v, g: mom * v + (1 - damp) * g,
                        state["dfdx"], dfdx)
                if nesterov:
                    dfdx = tree_map(lambda g, v: g + mom * v, dfdx,
                                    state["dfdx"])
                else:
                    dfdx = state["dfdx"]
            if lrs is not None:
                x = tree_map(lambda p, g, s: p - clr * s * g, x, dfdx,
                             tree_map(torch.as_tensor, lrs))
            else:
                x = tree_map(lambda p, g: p - clr * g, x, dfdx)
        state["evalCounter"] = state.get("evalCounter", 0) + 1
        return x, [loss]

    def clear_history(self, state: Table):
        if "dfdx" in state:
            del state["dfdx"]
        return state

    def get_hyper_parameter(self, config: Table) -> str:
        lr = -config.get("currentLearningRate",
                         -config.get("learningRate", 1e-3))
        return f"Current learning rate is {lr}. "

    def update_hyper_parameter(self, config: Table, state: Table):
        schedule = config.get("learningRateSchedule", Default())
        schedule.update_hyper_parameter(config, state)

    def init_state(self, params):
        return {"velocity": [torch.zeros_like(p) for p in params]}

    def update(self, grads, opt_state, params, hyper, finite=None,
               taps=None):
        lr = hyper.get("lr", 1e-3)
        wd = hyper.get("weight_decay", 0.0)
        mom = hyper.get("momentum", 0.0)
        damp = hyper.get("dampening", 0.0)
        nesterov = hyper.get("nesterov", False)
        fused_sgd(params, grads, opt_state["velocity"], lr, momentum=mom,
                  weight_decay=wd, dampening=damp, nesterov=nesterov,
                  finite=finite, scales=hyper.get("lr_scales"), taps=taps)
        return params, opt_state


class Adagrad(OptimMethod):
    """Adagrad (ref Adagrad.scala:26): the squared gradients summed into
    ``variance``, the step ``lr / (1 + step * lr_decay) * g / (sqrt(v) +
    1e-10)``.

    ``init_state`` keeps the step counter as a 0-d int32 tensor on the
    leaves' device (the JAX ``{"variance": ..., "step": int32}``), and
    ``update`` computes the rate from it on the device and moves it
    there: a CUDA graph's replays see the counter move, and nothing is
    read back to the host.  The update is plain PyTorch, as the JAX one is
    a ``jnp`` tree map (no kernel)."""

    def optimize(self, feval, x, config: Table = None, state: Table = None):
        """The reference's Adagrad step over ``x`` (bigdl_tpu/optim/
        optim_method.py:153-172): ``paramVariance`` and ``evalCounter``
        in ``state``."""
        config = config if config is not None else T()
        state = state if state is not None else config
        lr = config.get("learningRate", 1e-3)
        lrd = config.get("learningRateDecay", 0.0)
        wd = config.get("weightDecay", 0.0)

        loss, dfdx = feval(x)
        with torch.no_grad():
            if wd != 0:
                dfdx = tree_map(lambda g, p: g + wd * p, dfdx, x)
            n_eval = state.get("evalCounter", 0)
            clr = lr / (1 + n_eval * lrd)
            if "paramVariance" not in state:
                state["paramVariance"] = tree_map(torch.zeros_like, dfdx)
            state["paramVariance"] = tree_map(lambda v, g: v + g * g,
                                              state["paramVariance"], dfdx)
            x = tree_map(lambda p, g, v: p - clr * g / (v.sqrt() + 1e-10),
                         x, dfdx, state["paramVariance"])
        state["evalCounter"] = n_eval + 1
        return x, [loss]

    def clear_history(self, state: Table):
        if "paramVariance" in state:
            del state["paramVariance"]
        return state

    def init_state(self, params):
        return {"variance": [torch.zeros_like(p) for p in params],
                "step": torch.zeros((), dtype=torch.int32,
                                    device=params[0].device)}

    def update(self, grads, opt_state, params, hyper, finite=None,
               taps=None):
        """bigdl_tpu/optim/optim_method.py:178-189 in place: ``lr`` a
        float or a 0-d float32 tensor on the device (a captured graph's),
        the rate ``lr / (1 + step * lr_decay)`` a device scalar."""
        before, raw = self._pre_step(params, taps), grads
        lr = hyper.get("lr", 1e-3)
        lrd = hyper.get("lr_decay", 0.0)
        wd = hyper.get("weight_decay", 0.0)
        step, variance = opt_state["step"], opt_state["variance"]
        with torch.no_grad():
            if wd != 0.0:
                grads = torch._foreach_add(grads, params, alpha=wd)
            denom = step.float() * lrd + 1
            clr = (lr if isinstance(lr, torch.Tensor) else
                   torch.full_like(denom, lr)) / denom
            var = torch._foreach_add(variance, torch._foreach_mul(grads,
                                                                  grads))
            std = torch._foreach_sqrt(var)
            torch._foreach_add_(std, 1e-10)
            delta = torch._foreach_mul(grads, clr)
            torch._foreach_div_(delta, std)
            new = torch._foreach_sub(params, delta)
            if finite is None:
                torch._foreach_copy_(params, new)
                torch._foreach_copy_(variance, var)
                step.add_(1)
            else:
                for dst, src in zip(params + variance, new + var):
                    dst.copy_(torch.where(finite, src, dst))
                step.add_(finite.to(step.dtype))
        self._tap(raw, before, params, taps)
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
