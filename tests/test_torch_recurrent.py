"""The port's recurrence modules (bigdl_tpu_torch/nn/recurrent.py) and
``Mean`` against the JAX package: ``Recurrent(LSTMCell)`` forward and
reverse, ``BiRecurrent`` on its fused two-direction path (concat and add)
and on its two-child path, outputs, input gradients and every parameter
gradient, with the weights carried across by ``load_jax_params``.  The
JAX modules run on both of their routes: the Pallas kernel pair through
the interpreter (``_PALLAS_BILSTM = "interpret"``) and ``lax.scan``
(False).  Tolerances are the JAX tests' own: forward rtol 1e-5 / atol
1e-6, gradients rtol 1e-4 / atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.nn import recurrent as jax_recurrent
from bigdl_tpu.nn.module import Context
from bigdl_tpu.utils.random import set_seed
from bigdl_tpu_torch import nn, ops
from bigdl_tpu_torch.nn.module import export_params, load_jax_params

FWD = dict(rtol=1e-5, atol=1e-6)
BWD = dict(rtol=1e-4, atol=1e-5)
ROUTES = pytest.mark.parametrize("route", ["interpret", False],
                                 ids=["pallas", "scan"])


def _tree(m):
    return jax.tree_util.tree_map(np.asarray, m.params())


def _grads(module):
    tree = {"~": {k: p.grad for k, p in module._parameters.items()}}
    for name, m in module._modules.items():
        tree[name] = _grads(m)
    return tree


def _assert_trees_close(got, want, **tol):
    g, w = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w) > 0
    for a, b in zip(g, w):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


def _compare(jm, pm, shape, seed):
    """Output, input gradient and parameter gradients of the port module
    ``pm`` against the JAX module ``jm`` under ``(y * g).sum()``."""
    rs = np.random.RandomState(seed)
    x = rs.randn(*shape).astype(np.float32)
    ctx = Context(training=False, key=jax.random.PRNGKey(0))
    y_j = np.asarray(jm.apply(jm.params(), jnp.asarray(x), jm.state(),
                              ctx)[0])
    g = rs.randn(*y_j.shape).astype(np.float32)
    dp_j, dx_j = jax.grad(lambda p, v: (jm.apply(p, v, jm.state(), ctx)[0]
                                        * g).sum(), argnums=(0, 1))(
        jm.params(), jnp.asarray(x))
    load_jax_params(pm, _tree(jm))
    xt = torch.from_numpy(x).requires_grad_()
    y = pm(xt)
    (y * torch.from_numpy(g)).sum().backward()
    assert tuple(y.shape) == y_j.shape
    np.testing.assert_allclose(y.detach().numpy(), y_j, **FWD)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j), **BWD)
    _assert_trees_close(_grads(pm), dp_j, **BWD)
    with torch.no_grad():
        np.testing.assert_allclose(pm(torch.from_numpy(x)).numpy(), y_j,
                                   **FWD)


@ROUTES
@pytest.mark.parametrize("reverse", [False, True])
def test_recurrent_lstm_matches_jax(monkeypatch, route, reverse):
    """tests/test_recurrent.py:211's shapes: the kernel's D = 1 case."""
    monkeypatch.setattr(jax_recurrent, "_PALLAS_BILSTM", route)
    set_seed(7)
    jm = jnn.Recurrent(reverse=reverse).add(jnn.LSTMCell(6, 5))
    pm = nn.Recurrent(reverse=reverse).add(nn.LSTMCell(6, 5, device="cpu"))
    _compare(jm, pm, (4, 9, 6), seed=3)


@ROUTES
@pytest.mark.parametrize("merge", ["concat", "add"])
def test_birecurrent_fused_matches_jax(monkeypatch, route, merge):
    """Both directions in one D = 2 call against the JAX fused path."""
    monkeypatch.setattr(jax_recurrent, "_PALLAS_BILSTM", route)
    set_seed(5)
    jm = jnn.BiRecurrent(jnn.LSTMCell(6, 5), jnn.LSTMCell(6, 5), merge=merge)
    pm = nn.BiRecurrent(nn.LSTMCell(6, 5), nn.LSTMCell(6, 5), merge=merge)
    assert pm._fused_lstm_eligible() and jm._fused_lstm_eligible()
    _compare(jm, pm, (3, 7, 6), seed=1)


@pytest.mark.parametrize("make,bptt", [
    (lambda N: (N.LSTMCell(6, 5), N.LSTMCell(6, 4)), 0),   # unequal cells
    (lambda N: (N.LSTMCell(6, 5), N.LSTMCell(6, 5)), 7),   # bptt >= T
])
def test_birecurrent_two_children_match_jax(monkeypatch, make, bptt):
    """Cells that cannot share one call run as two D = 1 calls, as the
    JAX module runs two scans."""
    monkeypatch.setattr(jax_recurrent, "_PALLAS_BILSTM", "interpret")
    set_seed(6)
    jm = jnn.BiRecurrent(*make(jnn), bptt_truncate=bptt)
    pm = nn.BiRecurrent(*make(nn), bptt_truncate=bptt)
    assert not pm._fused_lstm_eligible()
    assert not jm._fused_lstm_eligible()
    _compare(jm, pm, (3, 7, 6), seed=2)


def test_fused_path_is_one_kernel_call_of_two_directions(monkeypatch):
    """The fused BiRecurrent hands the recurrence (T, 2, N, 4H) and
    (2, H, 4H); a Recurrent (T, 1, N, 4H) and (1, H, 4H)."""
    from bigdl_tpu_torch.nn import recurrent
    shapes = []

    def spy(zx, wht):
        shapes.append((tuple(zx.shape), tuple(wht.shape)))
        return ops.bilstm_recurrence(zx, wht)

    monkeypatch.setattr(recurrent, "bilstm_recurrence", spy)
    x = torch.randn(3, 7, 6)
    nn.BiRecurrent(nn.LSTMCell(6, 5), nn.LSTMCell(6, 5))(x)
    nn.Recurrent(reverse=True).add(nn.LSTMCell(6, 4))(x)
    assert shapes == [((7, 2, 3, 20), (2, 5, 20)), ((7, 1, 3, 16), (1, 4, 16))]


def test_param_tree_carries_across():
    set_seed(8)
    jm = jnn.BiRecurrent(jnn.LSTMCell(6, 5), jnn.LSTMCell(6, 5))
    pm = load_jax_params(nn.BiRecurrent(nn.LSTMCell(6, 5),
                                        nn.LSTMCell(6, 5)), _tree(jm))
    got = jax.tree_util.tree_leaves_with_path(export_params(pm))
    want = jax.tree_util.tree_leaves_with_path(_tree(jm))
    assert [(k, v.shape) for k, v in got] == [(k, v.shape) for k, v in want]
    _assert_trees_close(export_params(pm), jm.params(), rtol=0, atol=0)


def test_lstm_cell_init():
    """U(-1/sqrt(H), 1/sqrt(H)) for w (4H, D+H) and bias (4H), as the JAX
    cell draws them; the same generator seed gives the same weights."""
    from bigdl_tpu_torch.utils.random import generator
    cell = nn.LSTMCell(200, 128, generator=generator(0))
    bound = 1 / np.sqrt(128)
    for p, shape in ((cell.w, (512, 328)), (cell.bias, (512,))):
        assert tuple(p.shape) == shape
        assert bound * 0.99 < float(p.detach().abs().max()) <= bound
    set_seed(9)
    jc = jnn.LSTMCell(200, 128)
    for k, v in _tree(jc)["~"].items():
        assert v.shape == tuple(getattr(cell, k).shape)
        assert bound * 0.99 < np.abs(v).max() <= bound
    again = nn.LSTMCell(200, 128, generator=generator(0))
    assert torch.equal(again.w, cell.w) and torch.equal(again.bias, cell.bias)


@pytest.mark.parametrize("args,shape", [
    ((1, 2), (3, 7, 4)), ((1, 2), (7, 4)), ((2,), (3, 7, 4)),
    ((1, -1, False), (3, 7, 4)), ((3, 2), (2, 3, 5, 4)),
])
def test_mean_matches_jax(args, shape):
    x = np.random.RandomState(5).randn(*shape).astype(np.float32)
    want = np.asarray(jnn.Mean(*args).forward(jnp.asarray(x)))
    got = nn.Mean(*args)(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **FWD)


@pytest.mark.parametrize("build,match", [
    (lambda: nn.RnnCell(6, 5), "rnn_recurrence"),
    (lambda: nn.GRUCell(6, 5), "gru_recurrence"),
    (lambda: nn.Recurrent(bptt_truncate=2).add(nn.LSTMCell(6, 5))(
        torch.zeros(3, 7, 6)), "truncated BPTT"),
    (lambda: nn.Recurrent().add(type("MyCell", (nn.LSTMCell,), {})(6, 5))(
        torch.zeros(3, 7, 6)), "only LSTMCell"),
])
def test_what_is_not_ported_raises(build, match):
    with pytest.raises(NotImplementedError, match=match):
        build()
