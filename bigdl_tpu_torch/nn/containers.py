"""Containers of the slice (counterpart of bigdl_tpu/nn/containers.py).

A Table of branch outputs is a plain Python list here: the slice's
containers need nothing more.
"""
from __future__ import annotations

import torch

from bigdl_tpu_torch.nn.module import Container


class Sequential(Container):
    """Chain modules serially."""

    def forward(self, x):
        for m in self._modules.values():
            x = m(x)
        return x


class ConcatTable(Container):
    """Apply every branch to the same input; a list of the results."""

    def forward(self, x):
        return [m(x) for m in self._modules.values()]


class Concat(Container):
    """Apply every branch to the same input and concatenate the outputs
    along ``dimension`` (1-based, ref Concat.scala).  The JAX module's
    merged execution of the branches' leading 1x1 convolutions
    (``_apply_merged``) is the same math over the same parameters and is
    not ported: each branch runs on its own."""

    def __init__(self, dimension: int, *modules):
        super().__init__(*modules)
        self.dimension = dimension

    def forward(self, x):
        return torch.cat([m(x) for m in self._modules.values()],
                         dim=self.dimension - 1)
