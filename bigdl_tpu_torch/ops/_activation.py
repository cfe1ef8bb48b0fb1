"""The element-wise activations the RNN kernel applies (``csrc/rnn.cu``
``act_fwd`` / ``act_grad``) as a descriptor, and their plain versions.

An :class:`Act` is a kind and up to three float parameters: LeakyReLU's
negval, ELU's alpha, SoftPlus's beta, HardTanh's (and Clamp's) bounds,
Threshold's th and v, the shrinks' lambda, Power's power, scale and
shift.  ``KINDS`` lists the kinds in the order of the kernel's codes.

:func:`apply` is the JAX package's expression of each
(bigdl_tpu/nn/activations.py), written so that PyTorch's autograd gives
the JAX derivative at the kinks: ``jnp.clip`` is a maximum then a minimum,
whose derivative at a bound is 1/2 (``torch.maximum`` / ``torch.minimum``
split a tie as JAX's do, ``torch.clamp`` does not); ``jnp.abs`` has
derivative 1 at 0 (``torch.abs`` 0); ``LeakyReLU`` takes the identity at
x >= 0.  :func:`derivative` is the same derivative in closed form, from
the pre-activation (``tanh`` from its output, as the kernel takes it).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

KINDS = ("tanh", "relu", "relu6", "tanhshrink", "sigmoid", "logsigmoid",
         "softplus", "softsign", "softshrink", "hardshrink", "hardtanh",
         "threshold", "leakyrelu", "elu", "abs", "sqrt", "square", "power",
         "exp", "log")


class Act(NamedTuple):
    kind: str = "tanh"
    a: float = 0.0
    b: float = 0.0
    c: float = 0.0

    @property
    def entry_args(self) -> tuple:
        """(code, a, b, c): the kind's code in csrc/rnn.cu and the
        parameters, as the kernel entries take them."""
        return (KINDS.index(self.kind), self.a, self.b, self.c)

    @property
    def from_h(self) -> bool:
        """The backward's derivative is read from the output h (tanh: 1 -
        h^2), not from a recomputed pre-activation."""
        return self.kind == "tanh"


TANH = Act()


def _abs(x):
    return torch.where(x >= 0, x, -x)


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def apply(act: Act, x: torch.Tensor) -> torch.Tensor:
    """The activation ``act`` of ``x``, differentiable as the JAX one."""
    k, a, b, c = act
    if k == "tanh":
        return torch.tanh(x)
    if k == "relu":
        return torch.relu(x)
    if k == "relu6":
        return _clip(x, 0.0, 6.0)
    if k == "tanhshrink":
        return x - torch.tanh(x)
    if k == "sigmoid":
        return torch.sigmoid(x)
    if k == "logsigmoid":
        return -torch.logaddexp(-x, torch.zeros_like(x))
    if k == "softplus":
        return torch.logaddexp(a * x, torch.zeros_like(x)) / a
    if k == "softsign":
        return x / (1.0 + _abs(x))
    if k == "softshrink":
        return torch.where(x > a, x - a,
                           torch.where(x < -a, x + a, torch.zeros_like(x)))
    if k == "hardshrink":
        return torch.where(_abs(x) > a, x, torch.zeros_like(x))
    if k == "hardtanh":
        return _clip(x, a, b)
    if k == "threshold":
        return torch.where(x > a, x, torch.full_like(x, b))
    if k == "leakyrelu":
        return torch.where(x >= 0, x, x * a)
    if k == "elu":
        return torch.where(x > 0, x, a * (torch.exp(x) - 1.0))
    if k == "abs":
        return _abs(x)
    if k == "sqrt":
        return torch.sqrt(x)
    if k == "square":
        return x * x
    if k == "power":
        return torch.pow(c + b * x, a)
    if k == "exp":
        return torch.exp(x)
    if k == "log":
        return torch.log(x)
    raise ValueError(f"unknown activation kind {k!r}")


def derivative(act: Act, pre: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """d act / d pre at the pre-activation ``pre`` (output ``h``): the JAX
    derivative, kinks included."""
    k, a, b, c = act
    if k == "tanh":
        return 1.0 - h * h
    one, zero = torch.ones_like(pre), torch.zeros_like(pre)
    if k == "relu":
        return torch.where(pre > 0, one, zero)
    if k in ("relu6", "hardtanh"):
        lo, hi = (0.0, 6.0) if k == "relu6" else (a, b)
        inside = torch.where((pre > lo) & (pre < hi), one, zero)
        return torch.where((pre == lo) | (pre == hi), 0.5 * one, inside)
    if k == "tanhshrink":
        t = torch.tanh(pre)
        return t * t
    if k == "sigmoid":
        s = torch.sigmoid(pre)
        return s * (1.0 - s)
    if k == "logsigmoid":
        return torch.sigmoid(-pre)
    if k == "softplus":
        return torch.sigmoid(a * pre)
    if k == "softsign":
        d = 1.0 + pre.abs()
        return 1.0 / (d * d)
    if k == "softshrink":
        return torch.where((pre > a) | (pre < -a), one, zero)
    if k == "hardshrink":
        return torch.where(pre.abs() > a, one, zero)
    if k == "threshold":
        return torch.where(pre > a, one, zero)
    if k == "leakyrelu":
        return torch.where(pre >= 0, one, torch.full_like(pre, a))
    if k == "elu":
        return torch.where(pre > 0, one, a * torch.exp(pre))
    if k == "abs":
        return torch.where(pre >= 0, one, -one)
    if k == "sqrt":
        return 0.5 / torch.sqrt(pre)
    if k == "square":
        return 2.0 * pre
    if k == "power":
        if a == 0:
            return zero
        return b * a * torch.pow(c + b * pre, a - 1.0)
    if k == "exp":
        return torch.exp(pre)
    if k == "log":
        return 1.0 / pre
    raise ValueError(f"unknown activation kind {k!r}")
