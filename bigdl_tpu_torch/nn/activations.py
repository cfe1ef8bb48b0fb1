"""Activation layers, the whole inventory of the reference (counterpart of
bigdl_tpu/nn/activations.py): ReLU, ReLU6, PReLU, RReLU, LeakyReLU, ELU,
Tanh, TanhShrink, Sigmoid, LogSigmoid, LogSoftMax, SoftMax, SoftMin,
SoftPlus, SoftShrink, SoftSign, HardTanh, HardShrink, Threshold, Clamp,
Abs, Sqrt, Square, Power, Exp, Log, GradientReversal.

Each takes the JAX class's name and constructor arguments and computes
its expression.  The element-wise ones (every class but the three
row-wise soft-maxes, PReLU, RReLU and GradientReversal) describe
themselves with ``act()`` as the ``ops.Act`` the RNN kernel applies, and
their forward is ``ops._activation.apply`` of it, written so that
autograd gives the JAX derivative at the kinks (a clip's bound 1/2, abs
at 0 and LeakyReLU's identity at x >= 0).  In-place flags (``ip``,
``inplace``) are taken for the reference's signature and ignored, as in
the JAX package.
"""
from __future__ import annotations

import torch

from bigdl_tpu_torch.nn.module import TensorModule
from bigdl_tpu_torch.ops import _activation
from bigdl_tpu_torch.ops._activation import Act
from bigdl_tpu_torch.utils.random import RNG


class _Elementwise(TensorModule):
    """An activation of the RNN kernel's inventory: ``kind`` and the
    parameters ``_params()`` give its ``Act``."""

    kind = ""

    def _params(self) -> tuple:
        return ()

    def act(self) -> Act:
        return Act(self.kind, *(float(p) for p in self._params()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _activation.apply(self.act(), x)


class ReLU(_Elementwise):
    """max(x, 0), derivative 0 at 0."""

    kind = "relu"

    def __init__(self, ip: bool = False):
        super().__init__()
        self.inplace = ip


class ReLU6(_Elementwise):
    """clip(x, 0, 6)."""

    kind = "relu6"

    def __init__(self, inplace: bool = False):
        super().__init__()
        self.inplace = inplace


class Tanh(_Elementwise):
    kind = "tanh"


class TanhShrink(_Elementwise):
    """x - tanh(x)."""

    kind = "tanhshrink"


class Sigmoid(_Elementwise):
    kind = "sigmoid"


class LogSigmoid(_Elementwise):
    """-softplus(-x)."""

    kind = "logsigmoid"


class SoftPlus(_Elementwise):
    """softplus(beta x) / beta, with no linear tail."""

    kind = "softplus"

    def __init__(self, beta: float = 1.0):
        super().__init__()
        self.beta = beta

    def _params(self):
        return (self.beta,)


class SoftSign(_Elementwise):
    """x / (1 + |x|)."""

    kind = "softsign"


class SoftShrink(_Elementwise):
    """x - lam above lam, x + lam below -lam, 0 between."""

    kind = "softshrink"

    def __init__(self, lam: float = 0.5):
        super().__init__()
        self.lam = lam

    def _params(self):
        return (self.lam,)


class HardShrink(_Elementwise):
    """x where |x| > lam, else 0."""

    kind = "hardshrink"

    def __init__(self, lam: float = 0.5):
        super().__init__()
        self.lam = lam

    def _params(self):
        return (self.lam,)


class HardTanh(_Elementwise):
    """clip(x, min_value, max_value)."""

    kind = "hardtanh"

    def __init__(self, min_value: float = -1.0, max_value: float = 1.0,
                 inplace: bool = False):
        super().__init__()
        assert max_value > min_value
        self.min_value = min_value
        self.max_value = max_value

    def _params(self):
        return (self.min_value, self.max_value)


class Clamp(HardTanh):
    """(ref Clamp.scala) HardTanh with int bounds."""

    def __init__(self, min_value: int, max_value: int):
        super().__init__(float(min_value), float(max_value))


class Threshold(_Elementwise):
    """x if x > th else v (ref Threshold.scala)."""

    kind = "threshold"

    def __init__(self, th: float = 1e-6, v: float = 0.0, ip: bool = False):
        super().__init__()
        self.threshold = th
        self.value = v

    def _params(self):
        return (self.threshold, self.value)


class LeakyReLU(_Elementwise):
    """x where x >= 0, else negval x."""

    kind = "leakyrelu"

    def __init__(self, negval: float = 0.01, inplace: bool = False):
        super().__init__()
        self.negval = negval

    def _params(self):
        return (self.negval,)


class ELU(_Elementwise):
    """x where x > 0, else alpha (exp(x) - 1)."""

    kind = "elu"

    def __init__(self, alpha: float = 1.0, inplace: bool = False):
        super().__init__()
        self.alpha = alpha

    def _params(self):
        return (self.alpha,)


class Abs(_Elementwise):
    kind = "abs"


class Sqrt(_Elementwise):
    kind = "sqrt"


class Square(_Elementwise):
    kind = "square"


class Power(_Elementwise):
    """(shift + scale * x) ** power (ref Power.scala)."""

    kind = "power"

    def __init__(self, power: float, scale: float = 1.0, shift: float = 0.0):
        super().__init__()
        self.power = power
        self.scale = scale
        self.shift = shift

    def _params(self):
        return (self.power, self.scale, self.shift)


class Exp(_Elementwise):
    kind = "exp"


class Log(_Elementwise):
    kind = "log"


class LogSoftMax(TensorModule):
    """Over the last dim, always in fp32 (log-probabilities need the
    fp32 mantissa)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.float()
        return torch.log_softmax(x, dim=-1)


class SoftMax(TensorModule):
    """Over the last dim."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.softmax(x, dim=-1)


class SoftMin(TensorModule):
    """softmax(-x) over the last dim."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.softmax(-x, dim=-1)


class PReLU(TensorModule):
    """Learnable leaky slope ``weight`` (ref PReLU.scala), 0.25 at the
    start: one shared slope for ``n_output_plane`` 0, else one a channel
    (dim 1, or dim 0 of a 1D input)."""

    def __init__(self, n_output_plane: int = 0, device=None):
        super().__init__()
        self.n_output_plane = n_output_plane
        self._add_param("weight", torch.full((max(1, n_output_plane),),
                                             0.25), device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        if self.n_output_plane > 0:
            shape = [1] * x.dim()
            shape[1 if x.dim() >= 2 else 0] = self.n_output_plane
            w = w.reshape(shape)
        return torch.where(x >= 0, x, x * w)


class RReLU(TensorModule):
    """Randomized leaky ReLU (ref RReLU.scala): in training each negative
    input's slope is drawn from U(lower, upper) on the package stream
    (``utils.random.RNG`` on the input's device), in evaluation it is the
    mean slope.  The draws are not the JAX package's (the generators
    differ), as with ``Dropout``."""

    def __init__(self, lower: float = 1.0 / 8, upper: float = 1.0 / 3,
                 inplace: bool = False):
        super().__init__()
        self.lower = lower
        self.upper = upper

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            a = torch.empty_like(x).uniform_(
                self.lower, self.upper, generator=RNG.generator(x.device))
        else:
            a = (self.lower + self.upper) / 2.0
        return torch.where(x >= 0, x, x * a)


class _Reverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lam):
        ctx.lam = lam
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return -ctx.lam * g, None


class GradientReversal(TensorModule):
    """Identity forward, -lambda * grad backward (ref
    GradientReversal.scala)."""

    def __init__(self, lam: float = 1.0):
        super().__init__()
        self.lam = lam

    def set_lambda(self, lam) -> "GradientReversal":
        self.lam = lam
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _Reverse.apply(x, self.lam)
