"""Module base classes (counterpart of bigdl_tpu/nn/module.py).

Every layer is a ``torch.nn.Module``.  On top of PyTorch's own machinery
the port keeps the JAX package's nested parameter view,
``{'~': own params, '<i>': child tree, ...}`` (bigdl_tpu/nn/module.py
``Module.params``), so one pytree moves between the two packages
(:func:`load_jax_params` / :func:`export_params`, for every model), the
same view of the running state (``Module.state``: the buffers, such as
batch normalisation's running statistics; :func:`load_jax_state` /
:func:`export_state`), and the Torch-style ``evaluate()`` mode switch.
Containers name their children ``'0'``, ``'1'``, ... exactly as the JAX
containers do.
"""
from __future__ import annotations

import numpy as np
import torch

from bigdl_tpu_torch.tensor import default_dtype


class Module(torch.nn.Module):
    """Base for every layer of the port."""

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
