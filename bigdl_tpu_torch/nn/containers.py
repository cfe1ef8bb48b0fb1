"""Containers (counterpart of bigdl_tpu/nn/containers.py): Sequential,
Concat, ConcatTable, ParallelTable, MapTable and Bottle.

A Table of branch outputs is a ``utils.table.Table``, 1-based as in the
JAX package: ``ConcatTable(a, b)(x)[1]`` is branch ``a``'s output.  An
input Table may also be given as a list (its first element is element
1).
"""
from __future__ import annotations

import torch

from bigdl_tpu_torch.nn.module import Container, Module
from bigdl_tpu_torch.utils.table import Table, as_table


class Sequential(Container):
    """Chain modules serially."""

    def forward(self, x):
        for m in self._modules.values():
            x = m(x)
        return x


class ConcatTable(Container):
    """Apply every branch to the same input; the Table of the results,
    branch i's at key i (ref ConcatTable.scala)."""

    def forward(self, x):
        return Table(*[m(x) for m in self._modules.values()])


class ParallelTable(Container):
    """The i-th branch applied to the i-th element of the input Table;
    the Table of the results (ref ParallelTable.scala)."""

    def forward(self, x):
        x = as_table(x)
        return Table(*[m(x[i + 1])
                       for i, m in enumerate(self._modules.values())])


class MapTable(Container):
    """Its one child, ``'0'``, applied to every element of the input
    Table (ref MapTable.scala): the elements share the child's
    parameters, as the reference's clones share storage, so the parameter
    tree has that one child."""

    def __init__(self, module: Module = None):
        super().__init__()
        if module is not None:
            self.add(module)

    def forward(self, x):
        x = as_table(x)
        m = self._modules["0"]
        return Table(*[m(x[i + 1]) for i in range(x.length())])


class Bottle(Container):
    """Apply an ``n_input_dim``-D module to higher-D input (ref
    Bottle.scala): the leading dims fold into one, the module runs, and
    they unfold again in front of its output's trailing dims."""

    def __init__(self, module: Module, n_input_dim: int = 2,
                 n_output_dim: int = None):
        super().__init__(module)
        self.n_input_dim = n_input_dim
        self.n_output_dim = (n_output_dim if n_output_dim is not None
                             else n_input_dim)

    def forward(self, x):
        cut = x.dim() - self.n_input_dim + 1
        lead, rest = tuple(x.shape[:cut]), tuple(x.shape[cut:])
        y = self._modules["0"](x.reshape((-1,) + rest))
        return y.reshape(lead + tuple(y.shape[1:]))


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
