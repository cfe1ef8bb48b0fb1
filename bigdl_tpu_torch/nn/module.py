"""Module base classes (counterpart of bigdl_tpu/nn/module.py).

Every layer is a ``torch.nn.Module``.  On top of PyTorch's own machinery
the port keeps the JAX package's nested parameter view,
``{'~': own params, '<i>': child tree, ...}`` (bigdl_tpu/nn/module.py
``Module.params``), so one pytree moves between the two packages
(:func:`load_jax_params` / :func:`export_params`, for every model), the
same view of the running state (``Module.state``: the buffers, such as
batch normalisation's running statistics; :func:`load_jax_state` /
:func:`export_state`), and the Torch-style API of the JAX ``Module``
(bigdl_tpu/nn/module.py:229-382; ref AbstractModule.scala:41):
``update_output``, ``backward``, ``update_grad_input``,
``acc_grad_parameters``, ``grads`` / ``load_grads`` /
``zero_grad_parameters``, ``get_parameters``, ``n_parameters``,
``evaluate`` / ``is_training``, ``clear_state``, ``clone_module``,
``reset``, ``reset_times`` / ``get_times``, ``save`` and ``predict``.
Containers name their children ``'0'``, ``'1'``, ... exactly as the JAX
containers do.

Two names stay PyTorch's, where the JAX ``Module`` has its own:
``parameters()`` is torch's iterator of parameters (the JAX one returns
``(weights, grads)``: here ``get_parameters()`` gives them flat, and
``grads()`` the gradient tree), and ``training`` is torch's flag (the
JAX ``training()`` is a method: here ``train()``, or ``is_training()``
to read it).  The port's optimizers iterate ``parameters()`` and its
layers read the flag.
"""
from __future__ import annotations

import contextlib
import copy
import time

import numpy as np
import torch

from bigdl_tpu_torch.tensor import default_dtype

#: attributes the Torch-style API keeps on a module that neither a
#: module file nor a copy carries
_TRANSIENT = ("output", "grad_input", "_replay")


class Module(torch.nn.Module):
    """Base for every layer of the port.

    ``forward_time`` is the host time of the module's calls, summed (a
    ``perf_counter`` pair around each, no sync and no hook); a child's
    calls inside its parent's count in both.  ``backward_time`` is that of
    the Torch-style ``backward``."""

    forward_time = 0.0
    backward_time = 0.0
    output = None
    grad_input = None

    def __call__(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = torch.nn.Module.__call__(self, *args, **kwargs)
        d = self.__dict__
        d["forward_time"] = d.get("forward_time", 0.0) + \
            (time.perf_counter() - t0)
        return out

    def __getstate__(self):
        state = super().__getstate__()
        return {k: v for k, v in state.items() if k not in _TRANSIENT}

    def _add_param(self, name: str, value: torch.Tensor, device=None):
        """A parameter in ``tensor.default_dtype()`` (f32 unless set
        otherwise), as the JAX ``Module._add_param`` registers it."""
        self.register_parameter(name, torch.nn.Parameter(
            value.to(device=device, dtype=default_dtype())))

    def _add_buffer(self, name: str, value: torch.Tensor, device=None):
        """Running state under the JAX name (``running_mean``,
        ``running_var``): in ``state()``, in checkpoints, moved with the
        module, and never rebound (``load_state`` copies into it)."""
        self.register_buffer(name, value.to(device))

    def params(self) -> dict:
        """Nested view ``{'~': {name: tensor}, '<child>': {...}}``."""
        tree = {"~": {k: p.detach() for k, p in self._parameters.items()}}
        for name, m in self._modules.items():
            tree[name] = m.params()
        return tree

    def load_params(self, tree: dict) -> "Module":
        """Copy a nested tree (tensors or numpy arrays) into this module's
        parameters in place, on their current device.  Every parameter
        must be present with its exact shape."""
        own = tree.get("~", {})
        with torch.no_grad():
            for k, p in self._parameters.items():
                if k not in own:
                    raise KeyError(f"{type(self).__name__}: no value for "
                                   f"parameter {k!r}")
                v = own[k]
                # numpy leaves (often read-only views) are copied first
                v = (v if isinstance(v, torch.Tensor)
                     else torch.from_numpy(np.array(v)))
                if tuple(v.shape) != tuple(p.shape):
                    raise ValueError(
                        f"{type(self).__name__}.{k}: shape "
                        f"{tuple(v.shape)} != {tuple(p.shape)}")
                p.copy_(v)
        for name, m in self._modules.items():
            if name not in tree:
                raise KeyError(f"no subtree for child {name!r} of "
                               f"{type(self).__name__}")
            m.load_params(tree[name])
        return self

    def state(self) -> dict:
        """Nested view of the buffers, ``{'~': {name: tensor}, '<child>':
        {...}}``: the JAX ``Module.state`` layout, every module present."""
        tree = {"~": {k: b.detach() for k, b in self._buffers.items()
                      if b is not None}}
        for name, m in self._modules.items():
            tree[name] = m.state()
        return tree

    def load_state(self, tree: dict) -> "Module":
        """Copy a nested state tree (tensors or numpy arrays) into this
        module's buffers in place (``copy_``: a captured CUDA graph keeps
        reading the same storage).  Every buffer must be present with its
        exact shape; a module without buffers needs no entry."""
        own = tree.get("~", {})
        with torch.no_grad():
            for k, b in self._buffers.items():
                if b is None:
                    continue
                if k not in own:
                    raise KeyError(f"{type(self).__name__}: no value for "
                                   f"buffer {k!r}")
                v = own[k]
                v = (v if isinstance(v, torch.Tensor)
                     else torch.from_numpy(np.array(v)))
                if tuple(v.shape) != tuple(b.shape):
                    raise ValueError(
                        f"{type(self).__name__}.{k}: shape "
                        f"{tuple(v.shape)} != {tuple(b.shape)}")
                b.copy_(v)
        for name, m in self._modules.items():
            sub = tree.get(name)
            if sub is None:
                if any(b is not None for b in m.buffers()):
                    raise KeyError(f"no state subtree for child {name!r} "
                                   f"of {type(self).__name__}")
                continue
            m.load_state(sub)
        return self

    def copy_status(self, src: "Module") -> "Module":
        """Copy the running state (BN statistics) of ``src``, a module of
        the same structure (ref AbstractModule.copyStatus)."""
        return self.load_state(src.state())

    def set_name(self, name: str) -> "Module":
        self.name = name
        return self

    def evaluate(self) -> "Module":
        """Inference mode (ref AbstractModule.evaluate): dropout off."""
        self.eval()
        return self

    def is_training(self) -> bool:
        return self.training

    # -- the Torch-style gradient methods (ref AbstractModule.scala:145-170)
    def update_output(self, x):
        """The forward of the Torch-style API: the output, kept in
        ``output``.  The dropout stream's position is kept too, so that a
        later ``backward`` on the same input replays this call's masks."""
        self._replay = _stream_state(x)
        self.output = self(x)
        return self.output

    @contextlib.contextmanager
    def _replayed(self, x):
        """(output, input leaves that take a gradient, rebuild): the
        forward run again under autograd from ``x`` (detached) with the
        last ``update_output``'s dropout masks; on leaving, the running
        statistics are as they were before it (the JAX ``backward`` runs
        ``apply`` again and drops the state it returns)."""
        leaves, rebuild = _input_leaves(x)
        inputs = [t.detach().requires_grad_(t.is_floating_point())
                  for t in leaves]
        kept = [b.clone() for b in self.buffers()]
        rewind = getattr(self, "_replay", None)
        now = None
        if rewind is not None:
            now = _stream_state(x)
            _set_stream(x, rewind)
        try:
            with torch.enable_grad():
                y = self(rebuild(inputs))
        finally:
            if now is not None:
                _set_stream(x, now)
        try:
            yield y, inputs, rebuild
        finally:
            with torch.no_grad():
                for b, k in zip(self.buffers(), kept):
                    b.copy_(k)

    def backward(self, x, grad_output):
        """The input's gradient (``grad_input``), and each parameter's
        gradient added into its ``.grad`` (= update_grad_input +
        acc_grad_parameters, as in the reference)."""
        t0 = time.perf_counter()
        with self._replayed(x) as (y, inputs, rebuild):
            _autograd_backward(y, grad_output)
        self.grad_input = rebuild([t.grad for t in inputs])
        self.backward_time += time.perf_counter() - t0
        return self.grad_input

    def update_grad_input(self, x, grad_output):
        """The input's gradient only: no parameter's ``.grad`` moves."""
        with self._replayed(x) as (y, inputs, rebuild):
            wanted = [t for t in inputs if t.requires_grad]
            outs, gys = _output_pairs(y, grad_output)
            grads = iter(torch.autograd.grad(outs, wanted, gys,
                                             allow_unused=True))
        self.grad_input = rebuild([next(grads) if t.requires_grad else None
                                   for t in inputs])
        return self.grad_input

    def acc_grad_parameters(self, x, grad_output):
        """Each parameter's gradient added into its ``.grad``."""
        params = [p for p in self.parameters() if p.requires_grad]
        with self._replayed(x) as (y, _, _):
            outs, gys = _output_pairs(y, grad_output)
            grads = torch.autograd.grad(outs, params, gys,
                                        allow_unused=True)
        with torch.no_grad():
            for p, g in zip(params, grads):
                if g is None:
                    continue
                if p.grad is None:
                    p.grad = g.detach().clone()
                else:
                    p.grad.add_(g)

    def grads(self) -> dict:
        """The gradients in the ``params()`` layout (zeros where a
        parameter has none yet)."""
        tree = {"~": {k: (p.grad.detach() if p.grad is not None
                          else torch.zeros_like(p.detach()))
                      for k, p in self._parameters.items()}}
        for name, m in self._modules.items():
            tree[name] = m.grads()
        return tree

    def load_grads(self, tree: dict) -> "Module":
        """Copy a gradient tree into each parameter's ``.grad``."""
        own = tree.get("~", {})
        with torch.no_grad():
            for k, p in self._parameters.items():
                if k not in own:
                    continue
                v = own[k]
                v = (v if isinstance(v, torch.Tensor)
                     else torch.from_numpy(np.array(v)))
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                p.grad.copy_(v)
        for name, m in self._modules.items():
            if name in tree:
                m.load_grads(tree[name])
        return self

    def zero_grad_parameters(self) -> "Module":
        """Every parameter's gradient to zero, in place where it has one
        (a flat buffer's views or a leaf table keep their addresses)."""
        with torch.no_grad():
            for p in self.parameters():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                else:
                    p.grad.zero_()
        return self

    # -- parameter views (ref AbstractModule.scala:217-228) ---------------
    def get_parameters(self):
        """Flat (weights, gradients) snapshots over every parameter in the
        depth-first ``{'~': own}`` order (the JAX ``get_parameters``: not
        live views)."""
        ps = list(self.parameters())
        if not ps:
            return torch.zeros(0), torch.zeros(0)
        return (torch.cat([p.detach().reshape(-1) for p in ps]),
                torch.cat([(p.grad if p.grad is not None
                            else torch.zeros_like(p)).detach().reshape(-1)
                           for p in ps]))

    def n_parameters(self) -> int:
        return sum(p.numel() for p in self.parameters())

    # -- lifecycle (ref AbstractModule.scala:248-306) ---------------------
    def clear_state(self) -> "Module":
        """Drop the kept ``output`` and ``grad_input`` here and below."""
        for m in self.modules():
            for k in _TRANSIENT:
                m.__dict__.pop(k, None)
        return self

    def clone_module(self) -> "Module":
        """A deep copy: parameters, buffers and gradients of its own."""
        return copy.deepcopy(self)

    def reset(self, generator=None) -> "Module":
        """Draw every parameter again, as the constructor draws it (from
        ``generator``, else PyTorch's default generator), in place: shapes,
        devices and addresses stay.  A layer with running statistics
        restarts them.  The draws are not the JAX package's (another
        generator)."""
        for m in self.modules():
            draw = getattr(m, "_draw", None)
            if draw is not None:
                with torch.no_grad():
                    for k, v in draw(generator).items():
                        p = m._parameters.get(k)
                        if p is not None:
                            p.copy_(v)
            restart = getattr(m, "_reset_state", None)
            if restart is not None:
                restart()
        return self

    def reset_times(self) -> None:
        for m in self.modules():
            m.__dict__["forward_time"] = 0.0
            m.__dict__["backward_time"] = 0.0

    def get_times(self) -> list:
        """``[(module, forward_s, backward_s)]`` over this module and
        every one below it (ref Container.getTimes)."""
        return [(m, m.forward_time, m.backward_time)
                for m in self.modules() if isinstance(m, Module)]

    def save(self, path, overwrite: bool = True) -> "Module":
        """The module file (ref AbstractModule.save): architecture,
        weights and running state, readable by the JAX ``File``."""
        from bigdl_tpu_torch.utils import file as File

        File.save_module(self, path, overwrite=overwrite)
        return self

    def predict(self, x):
        """The output in evaluation mode, without gradients; the mode is
        put back after."""
        was = self.training
        self.eval()
        try:
            with torch.no_grad():
                return self(x)
        finally:
            self.train(was)


class TensorModule(Module):
    """Marker base for modules mapping Tensor -> Tensor."""


class Container(Module):
    """Base for modules holding submodules, named '0', '1', ..."""

    def __init__(self, *modules: Module):
        super().__init__()
        for m in modules:
            self.add(m)

    def add(self, module: Module) -> "Container":
        self.add_module(str(len(self._modules)), module)
        return self

    def get(self, index: int) -> Module:
        """1-based indexing, like Torch ``container:get(i)``."""
        return list(self._modules.values())[index - 1]


def _input_leaves(x):
    """(the tensors of an input: a tensor, or a Table / list / tuple of
    them, and the function that builds the same kind of input from a
    list of tensors)."""
    from bigdl_tpu_torch.utils.table import Table

    if isinstance(x, torch.Tensor):
        return [x], lambda ts: ts[0]
    if isinstance(x, Table):
        return list(x), lambda ts: Table(*ts)
    if isinstance(x, (list, tuple)):
        return list(x), type(x)
    raise TypeError(f"a module input is a tensor or a Table of tensors, "
                    f"got {type(x).__name__}")


def _output_pairs(y, gy):
    """(outputs, their gradients) as matching lists."""
    ys, _ = _input_leaves(y)
    gys, _ = _input_leaves(gy)
    return ys, gys


def _autograd_backward(y, gy):
    ys, gys = _output_pairs(y, gy)
    torch.autograd.backward(ys, gys)


def _stream_device(x):
    leaves, _ = _input_leaves(x)
    return leaves[0].device


def _stream_state(x):
    from bigdl_tpu_torch.utils.random import RNG

    return RNG.generator(_stream_device(x)).get_state()


def _set_stream(x, state):
    from bigdl_tpu_torch.utils.random import RNG

    RNG.generator(_stream_device(x)).set_state(state)


def device_constant(owner, key: str, value: torch.Tensor, device):
    """``value``, a constant made on the CPU (a mask, a filter, a lookup
    table that is no parameter and no state), on ``device``: copied there
    once and kept on ``owner``, so a step (or a captured CUDA graph) reads
    it without a host-to-device copy."""
    cache = owner.__dict__.setdefault("_device_constants", {})
    dev = torch.device(device)
    t = cache.get((key, dev))
    if t is None:
        t = cache[(key, dev)] = value.to(dev)
    return t


def load_jax_params(model: Module, tree: dict) -> Module:
    """Fill a port model from the JAX model's ``params()`` pytree (numpy
    leaves, same ``{'~', '<i>'}`` paths) in place."""
    return model.load_params(tree)


def export_params(model: Module) -> dict:
    """The inverse of :func:`load_jax_params`: the nested tree with numpy
    leaves, as the JAX package's ``load_params`` takes it."""
    return _numpy_tree(model.params())


def _numpy_tree(tree: dict) -> dict:
    return {k: ({n: v.cpu().numpy().copy() for n, v in sub.items()}
                if k == "~" else _numpy_tree(sub)) for k, sub in tree.items()}


def load_jax_state(model: Module, tree: dict) -> Module:
    """Fill a port model's buffers from the JAX model's ``state()`` pytree
    in place."""
    return model.load_state(tree)


def export_state(model: Module) -> dict:
    """The inverse of :func:`load_jax_state`: the nested state tree with
    numpy leaves, as the JAX package's ``load_state`` takes it."""
    return _numpy_tree(model.state())


def param_paths(model: Module) -> list:
    """The path of every parameter in the nested tree, ``(child, ...,
    '~', name)``, in ``model.parameters()`` order."""
    def walk(mod, prefix):
        out = [prefix + ("~", k) for k in mod._parameters]
        for name, m in mod._modules.items():
            out += walk(m, prefix + (name,))
        return out
    return walk(model, ())


def tree_of(model: Module, leaves) -> dict:
    """``leaves`` (one per parameter, in ``model.parameters()`` order) in
    the nested tree layout of :func:`export_params`, every module's
    subtree present: how a per-parameter optimizer state (the momentum
    velocity) is stored as the JAX package keeps it, a pytree shaped like
    the params."""
    it = iter(leaves)

    def walk(mod):
        tree = {"~": {k: next(it) for k in mod._parameters}}
        for name, m in mod._modules.items():
            tree[name] = walk(m)
        return tree

    try:
        tree = walk(model)
    except StopIteration:
        raise ValueError("fewer leaves than parameters") from None
    if next(it, None) is not None:
        raise ValueError("more leaves than parameters")
    return tree


def leaves_of(model: Module, tree: dict) -> list:
    """The inverse of :func:`tree_of`: the tree's leaves in
    ``model.parameters()`` order; every parameter's path must be there."""
    out = []
    for path in param_paths(model):
        node = tree
        for key in path:
            if key not in node:
                raise KeyError(f"no leaf at {'/'.join(path)}")
            node = node[key]
        out.append(node)
    return out
