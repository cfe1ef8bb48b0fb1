"""Shape ops (counterpart of bigdl_tpu/nn/shape_ops.py): Reshape,
InferReshape, View, Transpose, Replicate, Squeeze, Unsqueeze, Padding,
SpatialZeroPadding, Contiguous, Copy, Identity and Echo.  Dimensions
are 1-based, as in the reference."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.module import Module, TensorModule


class Identity(Module):
    def forward(self, x):
        return x


class Reshape(TensorModule):
    """(ref Reshape.scala) — reshapes the non-batch dims; ``batch_mode``
    forces treating dim 0 as the batch (None: decide as the reference
    does)."""

    def __init__(self, size, batch_mode: bool = None):
        super().__init__()
        self.size = tuple(int(s) for s in size)
        self.batch_mode = batch_mode

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n_el = math.prod(self.size)
        batched = self.batch_mode
        if batched is None:
            # batched when the per-sample elements match; a singleton
            # leading dim with more input dims than target dims counts as
            # a batch of one (shape_ops.py:30-35)
            batched = (x.numel() == x.shape[0] * n_el and
                       (x.numel() != n_el or
                        (x.shape[0] == 1 and x.dim() > len(self.size))))
        if batched:
            return x.reshape((x.shape[0],) + self.size)
        return x.reshape(self.size)

    def extra_repr(self) -> str:
        return "x".join(map(str, self.size))


class View(TensorModule):
    """(ref View.scala) — reshape keeping the element count.  With
    ``num_input_dims`` set, an input of more dims than that is a batch
    over dim 0; otherwise the JAX module's rule: the whole input is one
    view unless its leading dim is a batch (``shape_ops.py:81-85``)."""

    def __init__(self, *sizes):
        super().__init__()
        if len(sizes) == 1 and isinstance(sizes[0], (tuple, list)):
            sizes = tuple(sizes[0])
        self.sizes = tuple(int(s) for s in sizes)
        self.num_input_dims = 0

    def set_num_input_dims(self, n: int) -> "View":
        self.num_input_dims = n
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.num_input_dims:
            batched = x.dim() > self.num_input_dims
        else:
            batched = not (x.numel() == math.prod(self.sizes) and not (
                x.shape[0] == 1 and x.dim() > len(self.sizes)))
        if batched:
            return x.reshape((x.shape[0],) + self.sizes)
        return x.reshape(self.sizes)

    def extra_repr(self) -> str:
        return "x".join(map(str, self.sizes))


class InferReshape(TensorModule):
    """Reshape to ``size``, where -1 is inferred and 0 copies the input's
    dim there; ``batch_mode`` keeps dim 0 in front (ref
    InferReshape.scala)."""

    def __init__(self, size, batch_mode: bool = False):
        super().__init__()
        self.size = tuple(int(s) for s in size)
        self.batch_mode = batch_mode

    def forward(self, x):
        base = 1 if self.batch_mode else 0
        out = [x.shape[0]] if self.batch_mode else []
        out += [x.shape[base + i] if s == 0 else s
                for i, s in enumerate(self.size)]
        return x.reshape(out)


class Transpose(TensorModule):
    """Swap each listed pair of 1-based dims, in order (ref
    Transpose.scala)."""

    def __init__(self, permutations):
        super().__init__()
        self.permutations = [(int(a), int(b)) for a, b in permutations]

    def forward(self, x):
        for a, b in self.permutations:
            x = x.transpose(a - 1, b - 1)
        return x


class Replicate(TensorModule):
    """A new dim of ``n_features`` copies at 1-based ``dim`` (ref
    Replicate.scala); ``n_dim`` is accepted for the reference's signature,
    and as in the JAX module changes nothing."""

    def __init__(self, n_features: int, dim: int = 1, n_dim: int = math.inf):
        super().__init__()
        self.n_features = n_features
        self.dim = dim

    def forward(self, x):
        y = x.unsqueeze(self.dim - 1)
        reps = [1] * y.dim()
        reps[self.dim - 1] = self.n_features
        return y.repeat(reps)


class Squeeze(TensorModule):
    """Drop 1-based ``dim`` if its size is 1, or every size-1 dim (ref
    Squeeze.scala)."""

    def __init__(self, dim: int = None, num_input_dims: int = None):
        super().__init__()
        self.dim = dim

    def forward(self, x):
        if self.dim is None:
            return x.squeeze()
        return x.squeeze(self.dim - 1) if x.shape[self.dim - 1] == 1 else x


class Unsqueeze(TensorModule):
    """A size-1 dim inserted at 1-based ``pos`` (ref Unsqueeze.scala)."""

    def __init__(self, pos: int, num_input_dims: int = None):
        super().__init__()
        self.pos = pos

    def forward(self, x):
        return x.unsqueeze(self.pos - 1)


class Padding(TensorModule):
    """``pad`` entries of ``value`` along 1-based ``dim`` (one further for
    input of more than ``n_input_dim`` dims), after the data, or before it
    for a negative ``pad`` (ref Padding.scala).  ``n_index`` is kept, and
    as in the JAX module does not move the padding."""

    def __init__(self, dim: int, pad: int, n_input_dim: int,
                 value: float = 0.0, n_index: int = 1):
        super().__init__()
        self.dim = dim
        self.pad = pad
        self.n_input_dim = n_input_dim
        self.value = value
        self.n_index = n_index

    def forward(self, x):
        dim = self.dim - 1
        if x.dim() > self.n_input_dim:
            dim += 1
        widths = [0] * (2 * (x.dim() - dim))
        widths[-2:] = (-self.pad, 0) if self.pad < 0 else (0, self.pad)
        return F.pad(x, widths, value=self.value)


class SpatialZeroPadding(TensorModule):
    """Zero padding of the H and W dims of (N, C, H, W) or (C, H, W); a
    negative pad crops (ref SpatialZeroPadding.scala)."""

    def __init__(self, pad_left: int, pad_right: int = None,
                 pad_top: int = None, pad_bottom: int = None):
        super().__init__()
        self.pl = pad_left
        self.pr = pad_left if pad_right is None else pad_right
        self.pt = pad_left if pad_top is None else pad_top
        self.pb = pad_left if pad_bottom is None else pad_bottom

    def forward(self, x):
        return F.pad(x, (self.pl, self.pr, self.pt, self.pb))


class Contiguous(TensorModule):
    """The input in a compact layout (ref Contiguous.scala)."""

    def forward(self, x):
        return x.contiguous()


class Copy(TensorModule):
    """A copy of the input (ref Copy.scala)."""

    def forward(self, x):
        return x.clone()


class Echo(TensorModule):
    """Prints the module's name and the input's shape, and passes it on
    (ref Echo.scala)."""

    def forward(self, x):
        print(f"{getattr(self, 'name', None) or type(self).__name__}: "
              f"shape {tuple(x.shape)}")
        return x
