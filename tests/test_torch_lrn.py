"""The port's cross-channel LRN (bigdl_tpu_torch/ops/lrn.py and
``nn.SpatialCrossMapLRN``) against the JAX package: the plain versions
against ``lrn_channel`` in interpret mode on tests/test_pallas_ops.py's
four LRN cases (an even size, whose adjoint window is the mirror of the
forward's, and a ragged H*W), and the module against the JAX module on
both of its routes, the Pallas kernel (interpreted on the CPU) and the
default analytic VJP.  Tolerances are the JAX test's own: forward rtol
1e-5 / atol 1e-6, gradient rtol 1e-4 / atol 1e-5 (the window sums and
the pow run in other orders).

On the CPU the wrappers take their plain versions; the CUDA kernels are
held against those on the card by ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.nn import normalization as jax_norm
from bigdl_tpu.nn.module import Context
from bigdl_tpu.ops.pallas_kernels import (_lrn_call, _lrn_fwd_res_kernel,
                                          lrn_channel)
from bigdl_tpu_torch import nn, ops

FWD = dict(rtol=1e-5, atol=1e-6)
BWD = dict(rtol=1e-4, atol=1e-5)
CASES = [   # tests/test_pallas_ops.py TestPallasLRN
    ((2, 8, 16, 8), (5, 1.0, 0.75, 1.0)),
    ((2, 6, 16, 16), (3, 2e-4, 0.9, 2.0)),
    ((2, 8, 7, 9), (5, 1.0, 0.75, 1.0)),      # ragged H*W
    ((2, 8, 16, 8), (4, 1.0, 0.75, 1.0)),     # even size
]
INCEPTION = ((2, 64, 7, 7), (5, 1e-4, 0.75, 1.0))   # models/inception.py:37


def _inputs(shape, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(*shape).astype(np.float32),
            rs.randn(*shape).astype(np.float32))


@pytest.mark.parametrize("shape,hyper", CASES)
def test_plain_versions_match_the_pallas_kernel(shape, hyper):
    """y and the residual z of the forward, the backward wrapper from z
    and the autograd path, against the JAX kernel trio interpreted."""
    x, g = _inputs(shape)
    y_jax, z_jax = _lrn_call(_lrn_fwd_res_kernel, (jnp.asarray(x),),
                             [jnp.float32, jnp.float32], *hyper,
                             interpret=True)
    d_jax = jax.grad(lambda v: (lrn_channel(v, *hyper, True) * g).sum())(
        jnp.asarray(x))

    y, z = ops.lrn_forward(torch.from_numpy(x), *hyper)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_jax), **FWD)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_jax), **FWD)
    primal = ops.lrn_forward(torch.from_numpy(x), *hyper, with_z=False)
    assert torch.equal(primal, y)
    dx = ops.lrn_backward(torch.from_numpy(x), z, torch.from_numpy(g),
                          *hyper)
    np.testing.assert_allclose(dx.numpy(), np.asarray(d_jax), **BWD)
    xt = torch.from_numpy(x).requires_grad_()
    (ops.lrn_channel(xt, *hyper) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(d_jax), **BWD)


def test_even_size_window_is_the_jax_one_not_torchs():
    """At size 4 the window is channels c-1..c+2; PyTorch's own
    ``local_response_norm`` takes c-2..c+1, a different function."""
    x, _ = _inputs((1, 6, 2, 2), seed=3)
    xt = torch.from_numpy(x)
    lo, hi = 1, 2
    want = np.stack([(x[:, max(c - lo, 0):c + hi + 1] ** 2).sum(1)
                     for c in range(6)], 1)
    _, z = ops.lrn_forward(xt, 4, 1.0, 0.75, 1.0)
    np.testing.assert_allclose(z.numpy(), 1.0 + want / 4, **FWD)
    lib = torch.nn.functional.local_response_norm(xt, 4, 1.0, 0.75, 1.0)
    assert not torch.allclose(lib, ops.lrn_forward(xt, 4, 1.0, 0.75, 1.0,
                                                   with_z=False))


@pytest.mark.parametrize("pallas", [True, False], ids=["pallas", "analytic"])
@pytest.mark.parametrize("shape,hyper", [CASES[0], CASES[3], INCEPTION])
def test_module_matches_jax_module(monkeypatch, pallas, shape, hyper):
    monkeypatch.setattr(jax_norm.SpatialCrossMapLRN, "_PALLAS", pallas)
    x, g = _inputs(shape, seed=1)
    jm = jnn.SpatialCrossMapLRN(*hyper)
    ctx = Context(training=True)
    y_jax = jm.forward(jnp.asarray(x))
    d_jax = jax.grad(lambda v: (jm.apply(jm.params(), v, jm.state(),
                                         ctx)[0] * g).sum())(jnp.asarray(x))

    pm = nn.SpatialCrossMapLRN(*hyper)
    xt = torch.from_numpy(x).requires_grad_()
    y = pm(xt)
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_jax), **FWD)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(d_jax), **BWD)
    # one CHW sample is a batch of one
    with torch.no_grad():
        one = pm(torch.from_numpy(x[0]))
    np.testing.assert_allclose(one.numpy(), np.asarray(y_jax)[0], **FWD)


def test_cpu_path_counts_no_launch():
    x, g = _inputs(CASES[0][0])
    ops.reset_launch_counts()
    xt = torch.from_numpy(x).requires_grad_()
    (nn.SpatialCrossMapLRN()(xt) * torch.from_numpy(g)).sum().backward()
    with torch.no_grad():
        nn.SpatialCrossMapLRN()(torch.from_numpy(x))
    counts = ops.launch_counts()
    assert counts["lrn_forward"] == counts["lrn_backward"] == 0
    assert ops.lrn_forward in ops.KERNELS and ops.lrn_backward in ops.KERNELS


@pytest.mark.parametrize("bad", [0, 2.5])
def test_size_must_be_a_positive_int(bad):
    with pytest.raises(ValueError, match="positive int"):
        ops.lrn_forward(torch.zeros(1, 2, 2, 2), bad, 1.0, 0.75, 1.0)
