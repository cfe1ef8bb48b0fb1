"""The dtype policy and the Torch-shape helpers (counterpart of
bigdl_tpu/tensor/__init__.py).

``default_dtype()`` is the dtype a layer registers its parameters in
(float32 unless ``set_default_dtype`` says otherwise).  A
``DTypePolicy`` names three dtypes: the parameters' (``param_dtype``),
the one matrix products, convolutions and the bandwidth-bound chains
(pools, normalisation applies, the LRN) take their operands in
(``compute_dtype``), and the one their results come back in
(``output_dtype``).  ``FP32`` is the default; ``BF16_COMPUTE`` feeds the
products bf16 operands and returns f32; ``BF16_ACT`` keeps their results
in bf16 too.  Parameters, gradients, the optimizer's state, batch
statistics and the loss stay f32 under every policy.

As in the JAX package the policy is process state, read by the layers
at call time: ``set_policy(BF16_COMPUTE)`` before a forward changes what
that forward computes.  Under ``FP32`` no layer casts anything, so a
float64 model on the CPU stays float64.
"""
from __future__ import annotations

import torch

_DEFAULT_DTYPE = torch.float32


def default_dtype() -> torch.dtype:
    return _DEFAULT_DTYPE


def set_default_dtype(dtype: torch.dtype) -> torch.dtype:
    global _DEFAULT_DTYPE
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise TypeError(f"set_default_dtype: a floating torch.dtype, got "
                        f"{dtype!r}")
    _DEFAULT_DTYPE = dtype
    return _DEFAULT_DTYPE


class DTypePolicy:
    """Mixed precision: parameters in ``param_dtype``, the operands of
    products and convolutions in ``compute_dtype`` (bf16 runs the tensor
    cores at full rate; they accumulate in f32), their results in
    ``output_dtype``."""

    def __init__(self, param_dtype=torch.float32, compute_dtype=torch.float32,
                 output_dtype=torch.float32):
        self.param_dtype = param_dtype
        self.compute_dtype = compute_dtype
        self.output_dtype = output_dtype

    @property
    def reduced(self) -> bool:
        """Whether products take operands or give results below f32: the
        layers cast only then (under FP32 every path is as it was)."""
        return (self.compute_dtype != torch.float32
                or self.output_dtype != torch.float32)

    def key(self) -> tuple:
        """The three dtypes: what a captured program is a function of."""
        return (self.param_dtype, self.compute_dtype, self.output_dtype)

    def cast_compute(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.compute_dtype)

    def cast_output(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.output_dtype)

    def __eq__(self, other) -> bool:
        return isinstance(other, DTypePolicy) and self.key() == other.key()

    def __hash__(self) -> int:
        return hash(self.key())

    def __repr__(self) -> str:
        return (f"DTypePolicy(param={self.param_dtype}, compute="
                f"{self.compute_dtype}, output={self.output_dtype})")


FP32 = DTypePolicy()
BF16_COMPUTE = DTypePolicy(compute_dtype=torch.bfloat16)
# the products' results stay bf16 too, so the activations downstream of
# them (pool windows, ReLU, BN apply, concatenations) move half the bytes;
# parameters, gradients, BN statistics and the loss stay f32
BF16_ACT = DTypePolicy(compute_dtype=torch.bfloat16,
                       output_dtype=torch.bfloat16)

_POLICY = FP32


def policy() -> DTypePolicy:
    return _POLICY


def set_policy(p: DTypePolicy) -> DTypePolicy:
    global _POLICY
    if not isinstance(p, DTypePolicy):
        raise TypeError(f"set_policy: a DTypePolicy, got {p!r}")
    _POLICY = p
    return p


def narrow(x: torch.Tensor, dim: int, index: int, size: int) -> torch.Tensor:
    """``size`` elements along the 1-based ``dim`` from the 1-based
    ``index`` (ref Tensor.scala ``narrow``)."""
    return x.narrow(dim - 1, index - 1, size)


def select(x: torch.Tensor, dim: int, index: int) -> torch.Tensor:
    """The 1-based ``index`` of the 1-based ``dim``, the dim dropped (ref
    Tensor.scala ``select``)."""
    return x.select(dim - 1, index - 1)


__all__ = ["BF16_ACT", "BF16_COMPUTE", "DTypePolicy", "FP32",
           "default_dtype", "narrow", "policy", "select",
           "set_default_dtype", "set_policy"]
