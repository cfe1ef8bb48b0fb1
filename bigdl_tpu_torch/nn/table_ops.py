"""Table ops (counterpart of bigdl_tpu/nn/table_ops.py): CAddTable,
CSubTable, CMulTable, CDivTable, CMaxTable, CMinTable, JoinTable,
SelectTable, NarrowTable, FlattenTable, MixtureTable, DotProduct,
PairwiseDistance, CosineDistance and CriterionTable.

Every op indexes its input Table from 1, as the JAX ops do (a list
counts as the Table of its elements); an op that makes a Table makes a
``utils.table.Table``.
"""
from __future__ import annotations

import functools

import torch

from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.ops._activation import _abs
from bigdl_tpu_torch.utils.table import Table, as_table


class CAddTable(Module):
    """Element-wise sum of the Table's tensors; ``inplace`` is accepted for
    the reference's signature and computes the same."""

    def __init__(self, inplace: bool = False):
        super().__init__()
        self.inplace = inplace

    def forward(self, xs):
        return functools.reduce(torch.add, as_table(xs))


class CSubTable(Module):
    """x[1] - x[2]."""

    def forward(self, x):
        x = as_table(x)
        return x[1] - x[2]


class CMulTable(Module):
    """Element-wise product of the Table's tensors."""

    def forward(self, x):
        return functools.reduce(torch.mul, as_table(x))


class CDivTable(Module):
    """x[1] / x[2]."""

    def forward(self, x):
        x = as_table(x)
        return x[1] / x[2]


class CMaxTable(Module):
    """Element-wise maximum of the Table's tensors (a tie's gradient split
    in halves, as ``jnp.maximum``'s)."""

    def forward(self, x):
        return functools.reduce(torch.maximum, as_table(x))


class CMinTable(Module):
    """Element-wise minimum of the Table's tensors."""

    def forward(self, x):
        return functools.reduce(torch.minimum, as_table(x))


class JoinTable(Module):
    """Concatenate the Table's tensors along 1-based ``dimension``, one
    further for input of more than ``n_input_dims`` dims (a batch; ref
    JoinTable.scala)."""

    def __init__(self, dimension: int, n_input_dims: int = -1):
        super().__init__()
        self.dimension = dimension
        self.n_input_dims = n_input_dims

    def forward(self, x):
        elems = list(as_table(x))
        dim = self.dimension - 1
        if self.n_input_dims > 0 and elems[0].dim() > self.n_input_dims:
            dim += 1
        return torch.cat(elems, dim=dim)


class SelectTable(Module):
    """Element ``index`` of the Table; a negative index counts from the
    end (ref SelectTable.scala)."""

    def __init__(self, index: int):
        super().__init__()
        self.index = index

    def forward(self, x):
        x = as_table(x)
        idx = self.index if self.index > 0 else x.length() + self.index + 1
        return x[idx]


class NarrowTable(Module):
    """The Table of ``length`` elements from ``offset``; a negative length
    counts from the end (ref NarrowTable.scala)."""

    def __init__(self, offset: int, length: int = 1):
        super().__init__()
        self.offset = offset
        self.length = length

    def forward(self, x):
        x = as_table(x)
        n = self.length
        if n < 0:
            n = x.length() - self.offset + 2 + n
        return Table(*[x[self.offset + i] for i in range(n)])


class FlattenTable(Module):
    """Nested Tables flattened into one Table, depth first (ref
    FlattenTable.scala)."""

    def forward(self, x):
        out = Table()

        def rec(t):
            for v in t:
                if isinstance(v, (Table, list, tuple)):
                    rec(as_table(v))
                else:
                    out.insert(v)

        rec(as_table(x))
        return out


class MixtureTable(Module):
    """Blend of experts by gates: Table(gates (N, E), experts), the experts
    a Table of E tensors (N, ...) or one tensor (N, E, ...) (ref
    MixtureTable.scala)."""

    def __init__(self, dim: int = None):
        super().__init__()
        self.dim = dim

    def forward(self, x):
        x = as_table(x)
        gates, experts = x[1], x[2]
        if isinstance(experts, (Table, list, tuple)):
            experts = torch.stack(list(as_table(experts)), dim=1)
        g = gates.reshape(tuple(gates.shape)
                          + (1,) * (experts.dim() - gates.dim()))
        return (experts * g).sum(1)


class DotProduct(Module):
    """Row-wise dot product of Table(a, b) (ref DotProduct.scala)."""

    def forward(self, x):
        x = as_table(x)
        a, b = x[1], x[2]
        if a.dim() == 1:
            return torch.dot(a, b)
        return (a * b).sum(-1)


class PairwiseDistance(Module):
    """Row-wise Lp distance of Table(a, b) (ref PairwiseDistance.scala)."""

    def __init__(self, norm: int = 2):
        super().__init__()
        self.norm = norm

    def forward(self, x):
        x = as_table(x)
        a, b = x[1], x[2]
        dim = -1 if a.dim() > 1 else 0
        return (_abs(a - b) ** self.norm).sum(dim) ** (1.0 / self.norm)


class CosineDistance(Module):
    """Row-wise cosine similarity of Table(a, b), the norms' product
    floored at 1e-12 (ref CosineDistance.scala)."""

    def forward(self, x):
        x = as_table(x)
        a, b = x[1], x[2]
        dim = -1 if a.dim() > 1 else 0
        den = (torch.linalg.vector_norm(a, dim=dim)
               * torch.linalg.vector_norm(b, dim=dim))
        return (a * b).sum(dim) / torch.clamp_min(den, 1e-12)


class CriterionTable(Module):
    """A criterion as a module over Table(input, target) (ref
    CriterionTable.scala)."""

    def __init__(self, criterion):
        super().__init__()
        self.criterion = criterion

    def forward(self, x):
        x = as_table(x)
        return self.criterion.apply_loss(x[1], x[2])
