"""Module base classes (counterpart of bigdl_tpu/nn/module.py).

Every layer is a ``torch.nn.Module``.  On top of PyTorch's own machinery
the port keeps the JAX package's nested parameter view,
``{'~': own params, '<i>': child tree, ...}`` (bigdl_tpu/nn/module.py
``Module.params``), so one pytree moves between the two packages
(:func:`load_jax_params` / :func:`export_params`, for every model), and the
Torch-style ``evaluate()`` mode switch.  Containers name their children
``'0'``, ``'1'``, ... exactly as the JAX containers do.
"""
from __future__ import annotations

import numpy as np
import torch


class Module(torch.nn.Module):
    """Base for every layer of the port."""

    def _add_param(self, name: str, value: torch.Tensor, device=None):
        self.register_parameter(
            name, torch.nn.Parameter(value.to(device)))

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


def load_jax_params(model: Module, tree: dict) -> Module:
    """Fill a port model from the JAX model's ``params()`` pytree (numpy
    leaves, same ``{'~', '<i>'}`` paths) in place."""
    return model.load_params(tree)


def export_params(model: Module) -> dict:
    """The inverse of :func:`load_jax_params`: the nested tree with numpy
    leaves, as the JAX package's ``load_params`` takes it."""
    def to_np(tree):
        return {k: ({n: v.cpu().numpy().copy() for n, v in sub.items()}
                    if k == "~" else to_np(sub)) for k, sub in tree.items()}
    return to_np(model.params())
