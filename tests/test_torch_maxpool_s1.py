"""The port's stride-1 max pool (bigdl_tpu_torch/ops/maxpool_s1.py, and
``nn.SpatialMaxPooling`` at stride 1) against the JAX package: the plain
versions against the stride-1 Pallas ``maxpool2d`` in interpret mode on
tests/test_pallas_ops.py's three geometries, with inputs quantized to
halves so that ties occur (the forward exact, the gradient rtol/atol
1e-5, the JAX test's own); the module against the JAX module under
``_PALLAS_POOL = "interpret"``, Inception's 3x3/s1/p1 ceil pool.

The NaN rule is the port's any-stride pool's (a NaN counts only at a
window's first tap), not the JAX stride-1 kernel's, which spreads a NaN
from any tap: the last test pins that documented difference.

On the CPU the wrappers take their plain versions; the CUDA kernels are
held against those on the card by ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.nn import pooling as jax_pooling
from bigdl_tpu.nn.module import Context
from bigdl_tpu.ops.pallas_kernels import maxpool2d as jax_maxpool2d
from bigdl_tpu_torch import nn, ops
from bigdl_tpu_torch.nn import pooling

TOL = dict(rtol=1e-5, atol=1e-5)
CASES = [   # tests/test_pallas_ops.py TestPallasMaxPool
    ((2, 4, 14, 14), (3, 3), ((1, 1), (1, 1))),
    ((1, 2, 8, 8), (3, 3), ((1, 1), (1, 1))),
    ((2, 3, 10, 12), (2, 2), ((0, 1), (1, 0))),
]


def _quantized(rs, shape):
    return (np.round(rs.randn(*shape) * 2) / 2).astype(np.float32)


@pytest.mark.parametrize("shape,win,pads", CASES)
def test_plain_versions_match_the_pallas_kernel(shape, win, pads):
    rs = np.random.RandomState(0)
    x = _quantized(rs, shape)
    y_jax = jax_maxpool2d(jnp.asarray(x), win, (1, 1), pads, True)
    g = rs.randn(*y_jax.shape).astype(np.float32)
    d_jax = jax.grad(lambda v: (jax_maxpool2d(v, win, (1, 1), pads, True)
                                * g).sum())(jnp.asarray(x))

    xt = torch.from_numpy(x).requires_grad_()
    y = ops.maxpool2d_s1(xt, win, pads)
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(y_jax))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(d_jax), **TOL)
    y2 = ops.maxpool2d_s1_forward(torch.from_numpy(x), win, pads)
    dx = ops.maxpool2d_s1_backward(torch.from_numpy(x), torch.from_numpy(g),
                                   win, pads)
    np.testing.assert_array_equal(y2.numpy(), np.asarray(y_jax))
    np.testing.assert_allclose(dx.numpy(), np.asarray(d_jax), **TOL)


@pytest.mark.parametrize("shape", [(2, 6, 7, 7), (1, 3, 14, 10),
                                   (4, 5, 5)])
def test_module_routes_stride_one_pools_and_matches_jax(monkeypatch, shape):
    """``SpatialMaxPooling(3, 3, 1, 1, 1, 1).ceil()`` (every inception
    module's pool branch) goes through ``maxpool2d_s1``, never the
    argmax pool, and equals the JAX module forward and backward; one CHW
    sample is a batch of one."""
    monkeypatch.setattr(jax_pooling, "_PALLAS_POOL", "interpret")
    calls = []

    def s1(*a):
        calls.append("s1")
        return ops.maxpool2d_s1(*a)

    def strided(*a):
        calls.append("strided")
        return ops.maxpool2d(*a)

    monkeypatch.setattr(pooling, "maxpool2d_s1", s1)
    monkeypatch.setattr(pooling, "maxpool2d", strided)
    rs = np.random.RandomState(2)
    x = _quantized(rs, shape)
    jm = jnn.SpatialMaxPooling(3, 3, 1, 1, 1, 1).ceil()
    y_jax = jm.forward(jnp.asarray(x))
    g = rs.randn(*y_jax.shape).astype(np.float32)
    ctx = Context(training=True)
    d_jax = jax.grad(lambda v: (jm.apply(jm.params(), v, jm.state(),
                                         ctx)[0] * g).sum())(jnp.asarray(x))

    xt = torch.from_numpy(x).requires_grad_()
    y = nn.SpatialMaxPooling(3, 3, 1, 1, 1, 1).ceil()(xt)
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(y_jax))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(d_jax), **TOL)
    nn.SpatialMaxPooling(3, 3, 2, 2).ceil()(torch.from_numpy(x))
    assert calls == ["s1", "strided"]


@pytest.mark.parametrize("shape,win,pads", CASES)
def test_nan_rule_is_the_any_stride_pools(shape, win, pads):
    """With NaNs, the stride-1 pool gives the any-stride pool's output and
    gradient at stride 1, so a module's answer does not depend on its
    stride; the JAX stride-1 kernel instead spreads every NaN it meets."""
    rs = np.random.RandomState(7)
    x = _quantized(rs, shape)
    x[rs.rand(*shape) < 0.15] = np.nan
    xt = torch.from_numpy(x)
    y = ops.maxpool2d_s1_forward(xt, win, pads)
    y_any = ops.maxpool2d_forward(xt, win, (1, 1), pads, with_argmax=False)
    torch.testing.assert_close(y, y_any, rtol=0, atol=0, equal_nan=True)
    g = torch.from_numpy(rs.randn(*y.shape).astype(np.float32))
    a, b = xt.clone().requires_grad_(), xt.clone().requires_grad_()
    (ops.maxpool2d_s1(a, win, pads) * g).sum().backward()
    (ops.maxpool2d(b, win, (1, 1), pads) * g).sum().backward()
    torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=0)
    y_jax = np.asarray(jax_maxpool2d(jnp.asarray(x), win, (1, 1), pads, True))
    assert np.isnan(y_jax).sum() > np.isnan(y.numpy()).sum()


def test_cpu_path_counts_no_launch():
    ops.reset_launch_counts()
    x = torch.randn(2, 3, 6, 6, requires_grad=True)
    ops.maxpool2d_s1(x, (3, 3), ((1, 1), (1, 1))).sum().backward()
    counts = ops.launch_counts()
    assert counts["maxpool2d_s1_forward"] == 0
    assert counts["maxpool2d_s1_backward"] == 0
    assert ops.maxpool2d_s1_forward in ops.KERNELS
    assert ops.maxpool2d_s1_backward in ops.KERNELS
