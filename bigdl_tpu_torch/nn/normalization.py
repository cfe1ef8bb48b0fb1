"""Normalisation layers (counterpart of bigdl_tpu/nn/normalization.py):
``BatchNormalization``, ``SpatialBatchNormalization``, ``LayerNorm``,
the cross-channel LRN ``SpatialCrossMapLRN``, and the local
normalisations ``SpatialSubtractiveNormalization``,
``SpatialDivisiveNormalization`` and ``SpatialContrastiveNormalization``."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn import init as init_
from bigdl_tpu_torch.nn.module import TensorModule, device_constant
from bigdl_tpu_torch.ops import lrn_channel
from bigdl_tpu_torch.parallel.collectives import (all_gather, all_reduce,
                                                  axis_size)
from bigdl_tpu_torch.tensor import policy


def _apply_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype a normalisation's apply runs in: the policy's compute
    dtype for an f32 input under a reduced policy, else the input's own
    (bigdl_tpu/nn/normalization.py ``_apply_in_compute_dtype``)."""
    p = policy()
    if p.compute_dtype != torch.float32 and x.dtype == torch.float32:
        return p.compute_dtype
    return x.dtype


def _scaled(x, scale, shift):
    """x * scale + shift in the apply dtype (``scale`` and ``shift`` f32,
    broadcast), the result in x's dtype: the JAX apply chain."""
    dt = _apply_dtype(x)
    return (x.to(dt) * scale.to(dt) + shift.to(dt)).to(x.dtype)


class BatchNormalization(TensorModule):
    """Batch norm over (N, D) input, or over dim 1 of (N, D, ...) (ref
    BatchNormalization.scala:31; bigdl_tpu/nn/normalization.py:40-99).

    Arguments follow the reference: ``(n_output, eps, momentum,
    affine)``.  Training normalises by the batch statistics (the biased
    variance) and moves the running ones by ``(1 - m) * running + m *
    stat``, the variance unbiased by ``n / max(n - 1, 1)``; ``evaluate()``
    normalises by the running statistics.  One sample without its batch
    dim (``n_dim - 1`` dims) is a batch of one.  The weight is drawn U(0,
    1) from ``generator``, the bias is zero.

    The JAX package computes this in plain XLA (no Pallas kernel), and
    so does the port: ``F.batch_norm``, whose update of ``running_mean``
    and ``running_var`` is written in place into the registered buffers
    (a captured CUDA graph replays it).  ``F.batch_norm`` refuses one
    value a channel in training; there the JAX arithmetic runs as plain
    operations (variance 0, the unbiasing divisor 1).

    In a data-parallel run whose step takes the statistics of the global
    batch (the ``DistriOptimizer``'s plain path, as the JAX step under
    ``jit`` takes them), ``process_group`` is the group of the ranks
    that share the batch: training then normalises by the global batch's
    statistics (:class:`_SyncBatchNorm`); it is None otherwise, and never
    pickled.

    Under a reduced dtype policy (a bf16 compute dtype) the module runs
    the JAX arithmetic by hand: the batch statistics and the running
    averages in f32 from the input as it came (an f32 input's statistics
    are those of FP32, never of its bf16 rounding, which cuDNN's bf16
    ``F.batch_norm`` would take them from), then ``x * scale + shift`` in
    the compute dtype, cast back to the input's dtype; the synchronised
    form too (its backward, by hand, in f32)."""

    n_dim = 2

    def __init__(self, n_output: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True, device=None,
                 generator=None):
        super().__init__()
        self.n_output = n_output
        self.eps = eps
        self.momentum = momentum
        self.affine = affine
        if affine:
            for k, v in self._draw(generator).items():
                self._add_param(k, v, device)
        else:
            self.weight = self.bias = None
        self._add_buffer("running_mean", torch.zeros(n_output), device)
        self._add_buffer("running_var", torch.ones(n_output), device)
        self.process_group = None

    def _draw(self, generator=None) -> dict:
        """The initial values (``Module.reset`` draws them again)."""
        if not self.affine:
            return {}
        return {"weight": init_.uniform((self.n_output,), 0.0, 1.0,
                                        generator),
                "bias": torch.zeros(self.n_output)}

    def _reset_state(self):
        """The running statistics back to their start (``reset``)."""
        with torch.no_grad():
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def __getstate__(self):
        state = super().__getstate__()
        state["process_group"] = None
        return state

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        unbatched = x.dim() == self.n_dim - 1
        if unbatched:
            x = x[None]
        if self.training and self.process_group is not None:
            y = _SyncBatchNorm.apply(x, self.weight, self.bias,
                                     self.running_mean, self.running_var,
                                     self.eps, self.momentum,
                                     self.process_group)
        elif (self.training and x.numel() == self.n_output
              or policy().compute_dtype != torch.float32):
            y = self._by_hand(x)
        else:
            y = F.batch_norm(x, self.running_mean, self.running_var,
                             self.weight, self.bias, self.training,
                             self.momentum, self.eps)
        return y[0] if unbatched else y

    def _by_hand(self, x):
        """The JAX module's arithmetic as plain operations: the batch's
        mean and biased variance in f32 (one value a channel: the value
        and 0) moving the running ones, the variance unbiased by n /
        max(n - 1, 1), or the running statistics in evaluation; then the
        apply in ``_apply_dtype``."""
        if self.training:
            x32 = x.float() if x.dtype != torch.float32 else x
            axes = _stat_axes(x)
            mean = x32.mean(axes)
            var = x32.var(axes, unbiased=False)
            n = x.numel() / self.n_output
            m = self.momentum
            with torch.no_grad():
                self.running_mean.mul_(1 - m).add_(m * mean)
                self.running_var.mul_(1 - m).add_(
                    m * var * (n / max(n - 1, 1.0)))
        else:
            mean, var = self.running_mean, self.running_var
        scale = torch.rsqrt(var + self.eps)
        shift = -mean * scale
        if self.affine:
            scale = scale * self.weight
            shift = shift * self.weight + self.bias
        shape = [1] * x.dim()
        shape[1] = self.n_output
        return _scaled(x, scale.reshape(shape), shift.reshape(shape))

    def extra_repr(self) -> str:
        return f"{self.n_output}, eps={self.eps}, momentum={self.momentum}"


def _stat_axes(x):
    return [0] + list(range(2, x.dim()))


def _per_channel(v, x):
    return v.reshape([1, -1] + [1] * (x.dim() - 2))


class _SyncBatchNorm(torch.autograd.Function):
    """Batch normalisation over the global batch of a process group, with
    the JAX module's arithmetic (bigdl_tpu/nn/normalization.py:77-97).

    Forward: each rank's count, per-channel mean and sum of squared
    deviations cross in one all-gather (float64) and merge exactly (Chan
    et al.'s pairwise update); the biased variance normalises,
    ``y = x·scale + shift``, and the running variance moves by the
    variance unbiased with the global count.  Backward: the per-channel
    sums of dy and dy·x̂ cross in one all-reduce; dx takes the global
    sums, dγ and dβ stay this rank's (the data-parallel all-reduce of the
    gradients sums them)."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, eps,
                momentum, group):
        axes = _stat_axes(x)
        c = x.shape[1]
        n_r = x.numel() // c
        m_r = x.mean(axes)
        d = x - _per_channel(m_r, x)
        local = torch.cat([x.new_tensor([float(n_r)]), m_r,
                           (d * d).sum(axes)]).double()
        g = all_gather(local, group).view(axis_size(group), 2 * c + 1)
        counts, means, m2s = g[:, :1], g[:, 1:1 + c], g[:, 1 + c:]
        n = counts.sum()
        mean64 = (counts * means).sum(0) / n
        var64 = (m2s.sum(0) + (counts * (means - mean64) ** 2).sum(0)) / n
        mean, var = mean64.float(), var64.float()
        n = float(n)
        with torch.no_grad():
            unbiased = var * (n / max(n - 1.0, 1.0))
            running_mean.mul_(1 - momentum).add_(momentum * mean)
            running_var.mul_(1 - momentum).add_(momentum * unbiased)
        inv = torch.rsqrt(var + eps)
        scale, shift = inv, -mean * inv
        if weight is not None:
            scale = scale * weight
            shift = shift * weight + bias
        ctx.save_for_backward(x, mean, inv, weight)
        ctx.n, ctx.group = n, group
        return _scaled(x, _per_channel(scale, x), _per_channel(shift, x))

    @staticmethod
    def backward(ctx, dy):
        x, mean, inv, weight = ctx.saved_tensors
        axes = _stat_axes(x)
        xhat = (x - _per_channel(mean, x)) * _per_channel(inv, x)
        sdy = dy.sum(axes)
        sdyx = (dy * xhat).sum(axes)
        both = all_reduce(torch.cat([sdy, sdyx]), ctx.group)
        g_sdy, g_sdyx = both.split(x.shape[1])
        k = inv if weight is None else inv * weight
        dx = _per_channel(k, x) * (dy - _per_channel(g_sdy / ctx.n, x)
                                   - xhat * _per_channel(g_sdyx / ctx.n, x))
        if weight is None:
            return dx, None, None, None, None, None, None, None
        return dx, sdyx, sdy, None, None, None, None, None


class SpatialBatchNormalization(BatchNormalization):
    """Batch norm over (N, C, H, W), or one (C, H, W) sample (ref
    SpatialBatchNormalization.scala)."""

    n_dim = 4


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """(x - mean) * rsqrt(var + eps) * weight + bias over the last dim,
    with the population variance — the decode step's formula
    (bigdl_tpu/models/transformer.py ``_lm_forward_window``)."""
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * weight + bias


class LayerNorm(TensorModule):
    """Layer normalisation over the trailing feature dim, stats in fp32;
    ``affine=False`` has no parameters and gives the plain (x - mean) *
    rsqrt(var + eps)."""

    def __init__(self, d_model: int, eps: float = 1e-5, affine: bool = True,
                 device=None):
        super().__init__()
        self.d_model = d_model
        self.eps = eps
        self.affine = affine
        for k, v in self._draw().items():
            self._add_param(k, v, device)

    def _draw(self, generator=None) -> dict:
        """The initial values (``Module.reset`` sets them again)."""
        if not self.affine:
            return {}
        return {"weight": torch.ones(self.d_model),
                "bias": torch.zeros(self.d_model)}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if policy().compute_dtype != torch.float32:
            # the JAX arithmetic: f32 statistics, the scale and shift
            # applied in the compute dtype
            x32 = x.float()
            mean = x32.mean(dim=-1, keepdim=True)
            scale = torch.rsqrt(x32.var(dim=-1, unbiased=False,
                                        keepdim=True) + self.eps)
            shift = -mean * scale
            if self.affine:
                scale = scale * self.weight
                shift = shift * self.weight + self.bias
            return _scaled(x, scale, shift)
        w, b = (self.weight, self.bias) if self.affine else (1.0, 0.0)
        return layer_norm(x.float(), w, b, self.eps).to(x.dtype)


class SpatialCrossMapLRN(TensorModule):
    """Local response normalisation across channels (ref
    SpatialCrossMapLRN.scala:221):
    y = x / (k + alpha/size * sum_{window} x^2) ** beta, the window of
    ``size`` channels padded ((size-1)//2, size-1-lo).  Every NCHW input
    (or one CHW sample) goes through ``ops.lrn_channel``: the hand-written
    kernel pair on the card, the plain version on the CPU.  Under a
    reduced dtype policy an f32 input runs in the compute dtype (the
    kernels' bf16 forms) and comes back f32, as the JAX module's chain
    does; its route flags are not ported."""

    def __init__(self, size: int = 5, alpha: float = 1.0, beta: float = 0.75,
                 k: float = 1.0):
        super().__init__()
        self.size = size
        self.alpha = alpha
        self.beta = beta
        self.k = k

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        was3d = x.dim() == 3
        dt = _apply_dtype(x)
        y = lrn_channel((x[None] if was3d else x).to(dt).contiguous(),
                        self.size, self.alpha, self.beta, self.k).to(x.dtype)
        return y[0] if was3d else y

    def extra_repr(self) -> str:
        return f"{self.size}, {self.alpha}, {self.beta}, {self.k}"


def _gaussian_kernel(kernel_size: int) -> np.ndarray:
    """A normalised 2-D gaussian of sigma 0.25 * size, like Torch's
    ``image.gaussian`` (the JAX package's ``_gaussian_kernel``)."""
    sigma = 0.25 * kernel_size
    xs = np.arange(kernel_size, dtype=np.float64)
    c = (kernel_size - 1) / 2.0
    g = np.exp(-((xs - c) ** 2) / (2 * sigma ** 2))
    k2 = np.outer(g, g)
    return (k2 / k2.sum()).astype(np.float32)


class SpatialSubtractiveNormalization(TensorModule):
    """Subtract a kernel-weighted local mean (ref
    SpatialSubtractiveNormalization.scala): the kernel (a 9x9 gaussian by
    default; a 1-D kernel is its outer product) is normalised to sum 1
    over the ``n_input_plane`` planes; the mean is the zero-padded
    correlation of the input with it across all channels, one map shared
    by them, divided by the ``coef`` map, the same correlation of ones
    (the kernel's mass inside the image at each pixel)."""

    def __init__(self, n_input_plane: int = 1, kernel=None):
        super().__init__()
        self.n_input_plane = n_input_plane
        kernel = _gaussian_kernel(9) if kernel is None else np.asarray(
            kernel, np.float32)
        if kernel.ndim == 1:
            kernel = np.outer(kernel, kernel)
        self.kernel = torch.from_numpy(
            (kernel / (kernel.sum() * n_input_plane)).astype(np.float32))
        self.kh, self.kw = self.kernel.shape

    def _conv_sum(self, x):
        """(N, 1, H, W): the normalised kernel correlated with every
        channel of the zero-padded input, summed over the channels."""
        k = device_constant(self, "kernel", self.kernel, x.device)
        ph, pw = (self.kh - 1) // 2, (self.kw - 1) // 2
        x = F.pad(x, (pw, self.kw - 1 - pw, ph, self.kh - 1 - ph))
        return F.conv2d(x, k.expand(1, x.shape[1], self.kh, self.kw))

    def _coef(self, x):
        return self._conv_sum(torch.ones((1,) + tuple(x.shape[1:]),
                                         dtype=x.dtype, device=x.device))

    def _subtract(self, x):
        return x - self._conv_sum(x) / self._coef(x)

    def forward(self, x):
        was3d = x.dim() == 3
        y = self._subtract(x[None] if was3d else x)
        return y[0] if was3d else y


class SpatialDivisiveNormalization(SpatialSubtractiveNormalization):
    """Divide by the local standard deviation (ref
    SpatialDivisiveNormalization.scala:114-136): sqrt of the kernel's
    correlation with x^2, divided by ``coef`` after the sqrt, and where
    that is not above ``threshold`` replaced by ``thresval``."""

    def __init__(self, n_input_plane: int = 1, kernel=None,
                 threshold: float = 1e-4, thresval: float = 1e-4):
        super().__init__(n_input_plane, kernel)
        self.threshold = threshold
        self.thresval = thresval

    def _divide(self, x):
        s = self._conv_sum(x * x)
        local_std = torch.sqrt(torch.maximum(s, torch.zeros_like(s)))
        adjusted = local_std / self._coef(x)
        return x / torch.where(adjusted > self.threshold, adjusted,
                               self.thresval)

    def forward(self, x):
        was3d = x.dim() == 3
        y = self._divide(x[None] if was3d else x)
        return y[0] if was3d else y


class SpatialContrastiveNormalization(SpatialDivisiveNormalization):
    """Subtractive, then divisive normalisation with the same kernel (ref
    SpatialContrastiveNormalization.scala)."""

    def forward(self, x):
        was3d = x.dim() == 3
        y = self._divide(self._subtract(x[None] if was3d else x))
        return y[0] if was3d else y
