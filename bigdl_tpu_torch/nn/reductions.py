"""Reductions and indexing (counterpart of bigdl_tpu/nn/reductions.py):
Mean, Sum, Max, Min, Index, Select, Narrow and MaskedSelect.
Dimensions and indices are 1-based, as in the reference."""
from __future__ import annotations

import torch

from bigdl_tpu_torch.nn.module import Module, TensorModule
from bigdl_tpu_torch.parallel.collectives import psum
from bigdl_tpu_torch.utils.table import as_table


class Mean(TensorModule):
    """Mean over 1-based ``dimension``; ``n_input_dims`` shifts it by one
    for batched input (more dims than that); ``squeeze`` drops the reduced
    dim.

    Under ``DistriOptimizer(sequence_parallel=True)`` the optimizer sets
    ``seq_axis``: a mean over the time dimension (dim 1 of a batch, which
    each rank holds a block of) is then the sum of the blocks over the
    axis (``psum``: every rank's copy feeds its loss, so the backward
    sums too) over the global length."""

    def __init__(self, dimension: int = 1, n_input_dims: int = -1,
                 squeeze: bool = True):
        super().__init__()
        self.dimension = dimension
        self.n_input_dims = n_input_dims
        self.squeeze = squeeze
        self.seq_axis = None
        #: set when the last forward reduced the time dimension over the
        #: axis (the loss after it is the same on every rank of the axis)
        self.reduced_time = False

    def _axis(self, x: torch.Tensor) -> int:
        d = self.dimension - 1
        if self.n_input_dims > 0 and x.dim() > self.n_input_dims:
            d += 1
        return d

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        axis, ring = self._axis(x), self.seq_axis
        if ring is None or ring.size == 1 or axis != 1:
            return x.mean(dim=axis, keepdim=not self.squeeze)
        self.reduced_time = True
        total = psum(x.sum(dim=1, keepdim=not self.squeeze), ring)
        return total / (x.shape[1] * ring.size)


class Sum(TensorModule):
    """Sum over 1-based ``dimension`` (shifted as ``Mean``'s), divided by
    that dim's size with ``size_average`` (ref Sum.scala)."""

    def __init__(self, dimension: int = 1, n_input_dims: int = -1,
                 size_average: bool = False, squeeze: bool = True):
        super().__init__()
        self.dimension = dimension
        self.n_input_dims = n_input_dims
        self.size_average = size_average
        self.squeeze = squeeze

    def forward(self, x):
        d = self.dimension - 1
        if self.n_input_dims > 0 and x.dim() > self.n_input_dims:
            d += 1
        y = x.sum(dim=d, keepdim=not self.squeeze)
        return y / x.shape[d] if self.size_average else y


class Max(TensorModule):
    """The maximum over 1-based ``dim`` (ref Max.scala).  ``amax``: the
    gradient of a tie is split evenly among the tied entries, as JAX
    splits it (``x.max(dim)`` would give it all to one)."""

    def __init__(self, dim: int = 1, num_input_dims: int = None):
        super().__init__()
        self.dim = dim

    def forward(self, x):
        return torch.amax(x, dim=self.dim - 1)


class Min(TensorModule):
    """The minimum over 1-based ``dim``, a tie's gradient split as
    ``Max``'s (ref Min.scala)."""

    def __init__(self, dim: int = 1, num_input_dims: int = None):
        super().__init__()
        self.dim = dim

    def forward(self, x):
        return torch.amin(x, dim=self.dim - 1)


class Index(Module):
    """Table(src, 1-based indices): ``src`` indexed along 1-based
    ``dimension``, the indices' shape in that dim's place (ref
    Index.scala)."""

    def __init__(self, dimension: int = 1):
        super().__init__()
        self.dimension = dimension

    def forward(self, x):
        x = as_table(x)
        src = x[1]
        idx = torch.as_tensor(x[2], device=src.device).long() - 1
        d = self.dimension - 1
        y = src.index_select(d, idx.reshape(-1))
        return y.reshape(tuple(src.shape[:d]) + tuple(idx.shape)
                         + tuple(src.shape[d + 1:]))


class Select(TensorModule):
    """The slice at 1-based ``index`` of 1-based ``dimension``, the dim
    dropped; a negative index counts from the end (ref Select.scala)."""

    def __init__(self, dimension: int, index: int):
        super().__init__()
        self.dimension = dimension
        self.index = index

    def forward(self, x):
        d = self.dimension - 1
        idx = self.index if self.index > 0 else x.shape[d] + self.index + 1
        return x.select(d, idx - 1)


class Narrow(TensorModule):
    """``length`` entries of 1-based ``dimension`` from 1-based ``offset``;
    a negative length counts from the end (ref Narrow.scala).  The slice
    is the JAX module's, Python slice rules included."""

    def __init__(self, dimension: int, offset: int, length: int = 1):
        super().__init__()
        self.dimension = dimension
        self.offset = offset
        self.length = length

    def forward(self, x):
        d = self.dimension - 1
        n = self.length
        if n < 0:
            n = x.shape[d] - self.offset + 2 + n
        start = self.offset - 1
        sl = [slice(None)] * x.dim()
        sl[d] = slice(start, start + n)
        return x[tuple(sl)]


class MaskedSelect(Module):
    """Table(src, mask): the 1-D tensor of the entries of ``src`` where
    the mask is non-zero, in order (ref MaskedSelect.scala).  Its length
    depends on the data, so on the card it waits for the mask.

    The JAX module computes this in numpy, outside the trace, so no
    gradient flows through it there; here the backward scatters the
    output's gradient into zeros at the selected entries (the
    reference's), a documented difference."""

    def forward(self, x):
        x = as_table(x)
        src = x[1]
        mask = torch.as_tensor(x[2], device=src.device)
        return src[mask != 0]
