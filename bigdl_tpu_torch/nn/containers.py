"""Containers of the slice (counterpart of bigdl_tpu/nn/containers.py).

A Table of branch outputs is a plain Python list here: the slice's
containers need nothing more.
"""
from __future__ import annotations

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
