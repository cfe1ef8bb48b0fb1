"""The port's ``nn.MoE`` and ``parallel/moe.py`` against the JAX package
(tests/test_moe_layer.py:32-93): top-1 gating and the capacity's drops
against the JAX ``top1_gating``, the module's forward and every
gradient against ``jax.grad`` on the same parameters, and
``moe_apply`` / ``moe_apply_sharded_tokens`` at 2 gloo ranks against
the JAX functions and the JAX module's gradients."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.nn.module import Context
from bigdl_tpu.parallel import moe as jmoe
from bigdl_tpu.parallel.mesh import make_mesh as jax_make_mesh
from bigdl_tpu.utils.random import set_seed
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.nn.module import load_jax_params
from bigdl_tpu_torch.parallel import moe as pmoe
from bigdl_tpu_torch.parallel.launch import launch
from tests.helpers import torch_distri_workers as W
from tests.helpers.torch_parity import keep_torch_rng  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-5)     # tests/test_moe_layer.py:49-50


def _ctx():
    return Context(training=True, key=jax.random.PRNGKey(0))


def _pair(d, h, e, cf, seed):
    set_seed(seed)
    jm = jnn.MoE(d, h, e, capacity_factor=cf)
    pm = nn.MoE(d, h, e, capacity_factor=cf, device="cpu")
    load_jax_params(pm, jax.tree_util.tree_map(np.asarray, jm.params()))
    return jm, pm


@pytest.mark.parametrize("t,e,cap", [(10, 4, 3), (12, 4, 1), (9, 3, 9),
                                     (16, 8, 2)])
def test_top1_gating_matches_jax(t, e, cap):
    """The dense (dispatch, combine) pair from the index form, against
    JAX's at a capacity that drops tokens and one that does not."""
    logits = np.random.RandomState(t + e).randn(t, e).astype(np.float32)
    jd, jc = jmoe.top1_gating(jnp.asarray(logits), e, cap)
    pd, pc = pmoe.top1_gating(torch.from_numpy(logits), e, cap)
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), **TOL)


def test_expert_capacity_is_the_jax_formula():
    for args in [(10, 4, 1.25), (8192, 8, 1.25), (5, 8, 0.1), (7, 3, 2.0)]:
        assert pmoe.expert_capacity(*args) == jmoe.expert_capacity(*args)


def test_moe_routing_matches_manual():
    """test_moe_routing_matches_manual: every kept token is its argmax
    expert's FFN times the gate."""
    jm, pm = _pair(6, 8, 4, 4.0, 2)
    x = np.random.RandomState(0).randn(10, 6).astype(np.float32)
    y = pm(torch.from_numpy(x)).detach().numpy()
    p = {k: v.detach().numpy() for k, v in pm.named_parameters()}
    logits = x @ p["router"]
    gates = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    for t in range(10):
        e = gates[t].argmax()
        h = np.maximum(x[t] @ p["w1"][e] + p["b1"][e], 0)
        want = (h @ p["w2"][e] + p["b2"][e]) * gates[t, e]
        np.testing.assert_allclose(y[t], want, **TOL)


def test_moe_capacity_drops_overflow():
    """test_moe_capacity_drops_overflow: capacity 1 an expert, 10 tokens
    over 4 experts: at least 6 rows exactly zero, the same rows as
    JAX's."""
    jm, pm = _pair(6, 8, 4, 0.4, 2)
    x = np.random.RandomState(0).randn(10, 6).astype(np.float32)
    y = pm(torch.from_numpy(x)).detach().numpy()
    yj = np.asarray(jm._forward(jm.params()["~"], jnp.asarray(x), {},
                                _ctx())[0])
    zero = np.where(np.abs(y).sum(-1) == 0)[0]
    assert len(zero) >= 10 - 4
    np.testing.assert_array_equal(zero,
                                  np.where(np.abs(yj).sum(-1) == 0)[0])
    assert int(pm.dropped) == len(zero) and pm.tokens == 10


@pytest.mark.parametrize("shape,cf", [((12, 6), 1.25), ((3, 5, 6), 1.0),
                                      ((2, 8, 6), 0.5)])
def test_moe_forward_and_gradients_match_jax(shape, cf):
    """Forward, dx and every parameter's gradient (router, w1, b1, w2, b2)
    against jax.grad, with and without drops, on 2-D and 3-D input."""
    jm, pm = _pair(6, 8, 4, cf, 3)
    rs = np.random.RandomState(1)
    x = rs.randn(*shape).astype(np.float32)
    g = rs.randn(*shape).astype(np.float32)

    def loss(p, xx):
        return (jm.apply(p, xx, jm.state(), _ctx())[0] * g).sum()

    yj = jm.apply(jm.params(), jnp.asarray(x), jm.state(), _ctx())[0]
    gp, gx = jax.grad(loss, argnums=(0, 1))(jm.params(), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y = pm(xt)
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **TOL)
    for k in ("router", "w1", "b1", "w2", "b2"):
        got = getattr(pm, k).grad.numpy()
        np.testing.assert_allclose(got, np.asarray(gp["~"][k]), **TOL,
                                   err_msg=k)
        assert np.abs(got).max() > 0, k


def test_moe_is_exported_with_the_jax_parameter_layout():
    m = nn.MoE(12, 24, 4, device="cpu")
    assert [(k, tuple(p.shape)) for k, p in m.named_parameters()] == [
        ("router", (12, 4)), ("w1", (4, 12, 24)), ("b1", (4, 24)),
        ("w2", (4, 24, 12)), ("b2", (4, 12))]
    assert "MoE" in nn.__all__


# -- over a process group --------------------------------------------------

def _moe_params(seed, d=6, h=8, e=4):
    set_seed(seed)
    jm = jnn.MoE(d, h, e, capacity_factor=1.0)
    return jm, jax.tree_util.tree_map(np.asarray, jm.params())["~"]


@pytest.fixture(scope="module")
def moe_runs():
    jm, params = _moe_params(4)
    rs = np.random.RandomState(2)
    x = rs.randn(16, 6).astype(np.float32)
    g = rs.randn(16, 6).astype(np.float32)
    _, params2 = _moe_params(5, e=2)
    return (jm, params, x, g,
            launch(W.moe_apply_case, 2, "gloo", args=(params, x, g, False)),
            launch(W.moe_apply_case, 2, "gloo", args=(params, x, g, True)),
            (params2, launch(W.moe_apply_case, 2, "gloo",
                             args=(params2, x, g, True))))


def _jax_sharded(params, x):
    """JAX's moe_apply_sharded_tokens on a {"data": 2, "expert": 2} mesh
    of x's two halves, each half's output (the function routes each data
    slice alone)."""
    mesh = jax_make_mesh({"data": 2, "expert": 2}, jax.devices()[:4])
    p = {k: jnp.asarray(v) for k, v in params.items()}
    return np.asarray(jmoe.moe_apply_sharded_tokens(
        p["router"], p["w1"], p["b1"], p["w2"], p["b2"], jnp.asarray(x),
        mesh, capacity_factor=1.0))


def test_moe_apply_matches_jax(moe_runs):
    """moe_apply at 2 ranks: the output against the JAX moe_apply on an
    expert axis of 2 and against the JAX module; each rank's expert
    rows, the router's and the tokens' gradients against jax.grad of the
    module (the true function's)."""
    jm, params, x, g, ranks, _, _ = moe_runs
    mesh = jax_make_mesh({"expert": 2}, jax.devices()[:2])
    p = {k: jnp.asarray(v) for k, v in params.items()}
    yj = np.asarray(jmoe.moe_apply(p["router"], p["w1"], p["b1"], p["w2"],
                                   p["b2"], jnp.asarray(x), mesh,
                                   capacity_factor=1.0))

    def loss(pp, xx):
        return (jm.apply(pp, xx, jm.state(), _ctx())[0] * g).sum()

    gp, gx = jax.grad(loss, argnums=(0, 1))(jm.params(), jnp.asarray(x))
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out["y"], yj, **TOL)
        np.testing.assert_allclose(out["dx"], np.asarray(gx), **TOL)
        np.testing.assert_allclose(out["router"],
                                   np.asarray(gp["~"]["router"]), **TOL)
        for k in ("w1", "b1", "w2", "b2"):
            np.testing.assert_allclose(
                out[k], np.asarray(gp["~"][k])[2 * r:2 * r + 2], **TOL,
                err_msg=k)


def test_moe_apply_sharded_tokens_matches_jax(moe_runs):
    """moe_apply_sharded_tokens at 2 ranks, each its own 8 tokens, one
    expert a rank: the output against the JAX function (which routes
    each data slice alone)."""
    x = moe_runs[2]
    params, ranks = moe_runs[6]
    yj = _jax_sharded(params, x)
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out["y"], yj[8 * r:8 * r + 8], **TOL)


def test_moe_apply_sharded_tokens_is_the_module_on_each_rank(moe_runs):
    """Two experts a rank: each rank's output is the JAX module's on its
    own tokens (capacity from its 8), and the gradients are jax.grad of
    the module run on each half, summed: each rank's expert rows take
    both ranks' tokens through the two all-to-alls, its router gradient
    its own tokens'.  (The JAX function contracts a rank's experts
    together, ``"scd,edh->sch"``, and agrees with the module at one
    expert a rank only: ROADMAP.md, documented differences.)"""
    jm, params, x, g, _, ranks, _ = moe_runs
    halves = [slice(0, 8), slice(8, 16)]

    def loss(pp, xx, gg):
        return (jm.apply(pp, xx, jm.state(), _ctx())[0] * gg).sum()

    grads = [jax.grad(loss, argnums=(0, 1))(jm.params(), jnp.asarray(x[h]),
                                            g[h]) for h in halves]
    total = jax.tree_util.tree_map(lambda a, b: np.asarray(a) + b,
                                   grads[0][0], grads[1][0])
    router = 0
    for r, out in enumerate(ranks):
        want = jm.apply(jm.params(), jnp.asarray(x[halves[r]]), jm.state(),
                        _ctx())[0]
        np.testing.assert_allclose(out["y"], np.asarray(want), **TOL)
        np.testing.assert_allclose(out["dx"], np.asarray(grads[r][1]),
                                   **TOL)
        router = router + out["router"]
        for k in ("w1", "b1", "w2", "b2"):
            np.testing.assert_allclose(
                out[k], np.asarray(total["~"][k])[2 * r:2 * r + 2], **TOL,
                err_msg=k)
    np.testing.assert_allclose(router, np.asarray(total["~"]["router"]),
                               **TOL)
