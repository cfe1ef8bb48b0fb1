"""Linear-algebra layers (counterpart of bigdl_tpu/nn/linear.py):
Linear, Bilinear, CMul, CAdd, Mul, Add, MulConstant, AddConstant, MM,
MV, Cosine, Euclidean and LookupTable.

The parameterised layers draw their initial values on the CPU from
``generator`` (``nn.init``) and keep them on ``device``, which the
layers new to the port resolve as the models do (``"cuda"`` unless the
caller asks for the CPU; no card is an error).  Parameters carry the
JAX names, so ``load_jax_params`` fills any of them.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn import init as init_
from bigdl_tpu_torch.nn.module import Module, TensorModule
from bigdl_tpu_torch.parallel import collectives as coll
from bigdl_tpu_torch.tensor import policy
from bigdl_tpu_torch.utils.device import resolve_device
from bigdl_tpu_torch.utils.table import as_table


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The one matrix-product chokepoint (bigdl_tpu/nn/linear.py ``_dot``):
    under a reduced dtype policy both operands in its compute dtype (the
    product accumulates in f32) and the result in its output dtype; under
    FP32 the plain product."""
    p = policy()
    if not p.reduced:
        return torch.matmul(a, b)
    return torch.matmul(p.cast_compute(a), p.cast_compute(b)).to(
        p.output_dtype)


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor = None) -> torch.Tensor:
    """x W^T + b through ``_dot``'s casts, the bias added to the result in
    the output dtype (an f32 bias promotes a bf16 result to f32, as in
    the JAX package)."""
    p = policy()
    if not p.reduced:
        return F.linear(x, weight, bias)
    y = F.linear(p.cast_compute(x), p.cast_compute(weight)).to(
        p.output_dtype)
    return y if bias is None else y + bias


class Linear(TensorModule):
    """y = x W^T + b with ``weight`` (out, in), ``bias`` (out,).
    ``with_bias=False`` leaves the bias out; ``init_method`` Default draws
    both U(-1/sqrt(in), 1/sqrt(in)), Xavier draws the weight with fan-in
    ``in`` and fan-out ``out`` and zeroes the bias (bigdl_tpu/nn/linear.py
    ``Linear.reset``).

    Under tensor parallelism ``model_axis`` (the mesh's ``model`` Axis,
    set by the ``DistriOptimizer`` for the run) says that this rank holds
    its rows of the weight: the layer computes its columns of the output
    and gathers them (column-parallel), the bias added after the gather
    and the input's gradient summed over the axis."""

    def __init__(self, input_size: int, output_size: int,
                 with_bias: bool = True, init_method: str = init_.Default,
                 device=None, generator=None):
        super().__init__()
        self.input_size = input_size
        self.output_size = output_size
        self.with_bias = with_bias
        self.init_method = init_method
        draws = self._draw(generator)
        self._add_param("weight", draws["weight"], device)
        if with_bias:
            self._add_param("bias", draws["bias"], device)
        else:
            self.bias = None
        self.model_axis = None

    def _draw(self, generator=None) -> dict:
        """The initial values (``Module.reset`` draws them again)."""
        shape = (self.output_size, self.input_size)
        if self.init_method == init_.Xavier:
            return {"weight": init_.xavier(shape, self.input_size,
                                           self.output_size, generator),
                    "bias": torch.zeros(self.output_size)}
        w = init_.default_linear(shape, self.input_size, generator)
        return {"weight": w,
                "bias": init_.default_linear((self.output_size,),
                                             self.input_size, generator)}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        axis = self.model_axis
        if axis is None or axis.size == 1:
            return linear(x, self.weight, self.bias)
        y = coll.gather_dim(linear(coll.sum_grad(x, axis), self.weight),
                            axis, -1)
        return y if self.bias is None else y + self.bias

    def extra_repr(self) -> str:
        return f"{self.input_size} -> {self.output_size}"


class Bilinear(TensorModule):
    """y_k = x1^T W_k x2 + b_k over Table(x1 (n, i1), x2 (n, i2)), with
    ``weight`` (out, i1, i2) and ``bias`` (out,), both drawn U(-1/sqrt(i1),
    1/sqrt(i1)) (ref Bilinear.scala)."""

    def __init__(self, input_size1: int, input_size2: int, output_size: int,
                 bias_res: bool = True, device="cuda", generator=None):
        super().__init__()
        dev = resolve_device(device)
        self.input_size1 = input_size1
        self.input_size2 = input_size2
        self.output_size = output_size
        self.bias_res = bias_res
        draws = self._draw(generator)
        self._add_param("weight", draws["weight"], dev)
        if bias_res:
            self._add_param("bias", draws["bias"], dev)

    def _draw(self, generator=None) -> dict:
        stdv = 1.0 / math.sqrt(self.input_size1)
        out = {"weight": init_.uniform(
            (self.output_size, self.input_size1, self.input_size2), -stdv,
            stdv, generator)}
        if self.bias_res:
            out["bias"] = init_.uniform((self.output_size,), -stdv, stdv,
                                        generator)
        return out

    def forward(self, x):
        x = as_table(x)
        y = torch.einsum("ni,oij,nj->no", x[1], self.weight, x[2])
        return y + self.bias if self.bias_res else y


class CMul(TensorModule):
    """A learnt scale of shape ``size``, broadcast over the input (ref
    CMul.scala); drawn U(-1/sqrt(n), 1/sqrt(n)), n its element count."""

    def __init__(self, size, device="cuda", generator=None):
        super().__init__()
        self.size = tuple(size)
        self._add_param("weight", self._draw(generator)["weight"],
                        resolve_device(device))

    def _draw(self, generator=None) -> dict:
        stdv = 1.0 / math.sqrt(math.prod(self.size))
        return {"weight": init_.uniform(self.size, -stdv, stdv, generator)}

    def forward(self, x):
        return x * self.weight


class CAdd(TensorModule):
    """A learnt bias of shape ``size``, broadcast over the input (ref
    CAdd.scala)."""

    def __init__(self, size, device="cuda", generator=None):
        super().__init__()
        self.size = tuple(size)
        self._add_param("bias", self._draw(generator)["bias"],
                        resolve_device(device))

    def _draw(self, generator=None) -> dict:
        stdv = 1.0 / math.sqrt(math.prod(self.size))
        return {"bias": init_.uniform(self.size, -stdv, stdv, generator)}

    def forward(self, x):
        return x + self.bias


class Mul(TensorModule):
    """One learnt scalar gain, ``weight`` (1,) drawn U(-1, 1) (ref
    Mul.scala)."""

    def __init__(self, device="cuda", generator=None):
        super().__init__()
        self._add_param("weight", self._draw(generator)["weight"],
                        resolve_device(device))

    def _draw(self, generator=None) -> dict:
        return {"weight": init_.uniform((1,), -1.0, 1.0, generator)}

    def forward(self, x):
        return x * self.weight[0]


class Add(TensorModule):
    """A learnt bias of ``input_size`` (one shared value with ``scalar``)
    (ref Add.scala)."""

    def __init__(self, input_size: int, scalar: bool = False, device="cuda",
                 generator=None):
        super().__init__()
        self.input_size = 1 if scalar else input_size
        self.scalar = scalar
        self._add_param("bias", self._draw(generator)["bias"],
                        resolve_device(device))

    def _draw(self, generator=None) -> dict:
        stdv = 1.0 / math.sqrt(self.input_size)
        return {"bias": init_.uniform((self.input_size,), -stdv, stdv,
                                      generator)}

    def forward(self, x):
        return x + (self.bias[0] if self.scalar else self.bias)


class MulConstant(TensorModule):
    """x * scalar (ref MulConstant.scala); ``inplace`` computes the
    same."""

    def __init__(self, scalar: float, inplace: bool = False):
        super().__init__()
        self.scalar = scalar

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scalar

    def extra_repr(self) -> str:
        return f"{self.scalar}"


class AddConstant(TensorModule):
    """x + constant (ref AddConstant.scala); ``inplace`` computes the
    same."""

    def __init__(self, constant_scalar: float, inplace: bool = False):
        super().__init__()
        self.constant_scalar = constant_scalar

    def forward(self, x):
        return x + self.constant_scalar


class MM(Module):
    """Matrix product of Table(a, b), batched over leading dims, either
    operand transposed first (ref MM.scala)."""

    def __init__(self, trans_a: bool = False, trans_b: bool = False):
        super().__init__()
        self.trans_a = trans_a
        self.trans_b = trans_b

    def forward(self, x):
        x = as_table(x)
        a, b = x[1], x[2]
        if self.trans_a:
            a = a.transpose(-1, -2)
        if self.trans_b:
            b = b.transpose(-1, -2)
        return _dot(a, b)


class MV(Module):
    """Matrix-vector product of Table(mat, vec), batched (ref MV.scala)."""

    def __init__(self, trans: bool = False):
        super().__init__()
        self.trans = trans

    def forward(self, x):
        x = as_table(x)
        m = x[1].transpose(-1, -2) if self.trans else x[1]
        return torch.einsum("...ij,...j->...i", m, x[2])


class Cosine(TensorModule):
    """Cosine similarity to each of ``output_size`` learnt prototypes,
    ``weight`` (out, in); each norm has 1e-12 added (ref Cosine.scala)."""

    def __init__(self, input_size: int, output_size: int, device="cuda",
                 generator=None):
        super().__init__()
        self.input_size = input_size
        self.output_size = output_size
        self._add_param("weight", self._draw(generator)["weight"],
                        resolve_device(device))

    def _draw(self, generator=None) -> dict:
        stdv = 1.0 / math.sqrt(self.input_size)
        return {"weight": init_.uniform(
            (self.output_size, self.input_size), -stdv, stdv, generator)}

    def forward(self, x):
        w = self.weight
        xn = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)
        wn = w / (torch.linalg.vector_norm(w, dim=-1, keepdim=True) + 1e-12)
        return _dot(xn, wn.T)


class Euclidean(TensorModule):
    """Euclidean distance to each learnt prototype, ``weight`` (in, out)
    (ref Euclidean.scala); ``fast_backward`` is accepted for the
    reference's signature (autograd computes the backward)."""

    def __init__(self, input_size: int, output_size: int,
                 fast_backward: bool = True, device="cuda", generator=None):
        super().__init__()
        self.input_size = input_size
        self.output_size = output_size
        self._add_param("weight", self._draw(generator)["weight"],
                        resolve_device(device))

    def _draw(self, generator=None) -> dict:
        stdv = 1.0 / math.sqrt(self.input_size)
        return {"weight": init_.uniform(
            (self.input_size, self.output_size), -stdv, stdv, generator)}

    def forward(self, x):
        diff = x[..., :, None] - self.weight
        return torch.linalg.vector_norm(diff, dim=-2)


class LookupTable(TensorModule):
    """Embedding lookup of 1-based indices, ``weight`` (n_index, n_output)
    drawn N(0, 1) (ref LookupTable.scala:273).

    With ``max_norm`` every forward rescales the whole table by min(1,
    max_norm / (||row||_p + 1e-7)) before the lookup, differentiably, as
    the JAX module does; Torch renormalises the looked-up rows in place
    instead (a documented difference of the JAX package, kept).
    ``padding_value`` and ``should_scale_grad_by_freq`` are accepted for
    the reference's signature and, as in the JAX module, change
    nothing."""

    def __init__(self, n_index: int, n_output: int, padding_value: float = 0,
                 max_norm: float = None, norm_type: float = 2.0,
                 should_scale_grad_by_freq: bool = False, device="cuda",
                 generator=None):
        super().__init__()
        self.n_index = n_index
        self.n_output = n_output
        self.padding_value = padding_value
        self.max_norm = max_norm
        self.norm_type = norm_type
        self._add_param("weight", self._draw(generator)["weight"],
                        resolve_device(device))

    def _draw(self, generator=None) -> dict:
        return {"weight": init_.normal((self.n_index, self.n_output), 0.0,
                                       1.0, generator)}

    def forward(self, x):
        w = self.weight
        if self.max_norm is not None:
            norms = torch.linalg.vector_norm(w, ord=self.norm_type, dim=1,
                                             keepdim=True)
            w = w * torch.clamp_max(self.max_norm / (norms + 1e-7), 1.0)
        idx = torch.as_tensor(x, device=w.device).long() - 1
        return w[idx]

    def extra_repr(self) -> str:
        return f"{self.n_index} -> {self.n_output}"
