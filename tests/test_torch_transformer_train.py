"""The attention family's training on the port against the JAX package:
``TransformerClassifier`` (with and without MoE blocks, causal and not)
and ``TransformerLM`` forward and every parameter's gradient against
``jax.grad``, ``MultiHeadSelfAttention``'s, and six-step
``LocalOptimizer`` trajectories, losses and parameters, against the
JAX ``LocalOptimizer`` (tests/test_transformer.py:63-82, :147's
tolerance).  Weights cross from the JAX model; the epoch order comes
from the dataset's stream at one seed on both sides; dropout 0."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.dataset import Sample as JSample
from bigdl_tpu.dataset import SampleToBatch as JSampleToBatch
from bigdl_tpu.models.transformer import TransformerClassifier as JTC
from bigdl_tpu.models.transformer import TransformerLM as JLM
from bigdl_tpu.nn.module import Context
from bigdl_tpu.optim import LocalOptimizer as JLocalOptimizer
from bigdl_tpu.optim import max_iteration as jmax_iteration
from bigdl_tpu.utils.random import set_seed
from bigdl_tpu.utils.table import T as JT
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToBatch
from bigdl_tpu_torch.models.transformer import (TransformerClassifier,
                                                TransformerLM)
from bigdl_tpu_torch.nn.module import export_params, load_jax_params
from bigdl_tpu_torch.optim import LocalOptimizer, max_iteration
from bigdl_tpu_torch.utils.table import T
from tests.helpers.torch_parity import keep_torch_rng  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-5)   # tests/test_transformer.py:82, :147
TRAIN = Context(training=True, key=jax.random.PRNGKey(0))

CLASSIFIERS = {
    "plain": dict(class_num=4, d_model=16, n_heads=2, n_layers=2,
                  hidden=32),
    "causal": dict(class_num=4, d_model=16, n_heads=2, n_layers=1,
                   hidden=32, causal=True),
    "moe": dict(class_num=4, d_model=16, n_heads=2, n_layers=1, hidden=32,
                moe_experts=4),
}
LM = dict(vocab_size=8, d_model=16, n_heads=2, n_layers=2, hidden=32)


def _pair(kind, arch, seed=3):
    set_seed(seed)
    if kind == "lm":
        jm = JLM(dropout=0.0, **arch)
        pm = TransformerLM(dropout=0.0, device="cpu", **arch)
    else:
        jm = JTC(dropout=0.0, **arch)
        pm = TransformerClassifier(dropout=0.0, device="cpu", **arch)
    load_jax_params(pm, jax.tree_util.tree_map(np.asarray, jm.params()))
    return jm, pm


def _leaves_with_paths(tree, prefix=()):
    for k, sub in tree.items():
        if k == "~":
            for n, v in sub.items():
                yield prefix + (n,), v
        else:
            yield from _leaves_with_paths(sub, prefix + (k,))


def _grads_match(jm, pm, x, g, loss_of=None):
    """Forward and every parameter's gradient of sum(y * g), or of
    ``loss_of(y)`` given in both frameworks."""
    def f(p):
        y = jm.apply(p, jnp.asarray(x), jm.state(), TRAIN)[0]
        return (y * g).sum()

    yj = jm.apply(jm.params(), jnp.asarray(x), jm.state(), TRAIN)[0]
    gj = jax.tree_util.tree_map(np.asarray, jax.grad(f)(jm.params()))
    y = pm(torch.from_numpy(x))
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(yj), **TOL)
    got = {path: p.grad.numpy() for path, p in zip(
        (p for p, _ in _leaves_with_paths(pm.params())), pm.parameters())}
    n = 0
    for path, want in _leaves_with_paths(gj):
        np.testing.assert_allclose(got[path], want, **TOL,
                                   err_msg="/".join(path))
        n += 1
    assert n == len(got) and n > 0


@pytest.mark.parametrize("kind", sorted(CLASSIFIERS))
def test_classifier_forward_and_every_gradient_match_jax(kind):
    jm, pm = _pair("classifier", CLASSIFIERS[kind])
    rs = np.random.RandomState(0)
    x = rs.randn(3, 8, 16).astype(np.float32)
    g = rs.randn(3, 4).astype(np.float32)
    _grads_match(jm, pm, x, g)


def test_lm_forward_and_every_gradient_match_jax():
    jm, pm = _pair("lm", LM)
    rs = np.random.RandomState(1)
    x = np.eye(8, dtype=np.float32)[rs.randint(0, 8, (3, 8))]
    g = rs.randn(3, 8, 8).astype(np.float32)
    _grads_match(jm, pm, x, g)


@pytest.mark.parametrize("causal", [False, True])
def test_attention_layer_gradients_match_jax(causal):
    """MultiHeadSelfAttention: the input's and each of the eight
    parameters' gradients against jax.grad."""
    set_seed(4)
    jm = jnn.MultiHeadSelfAttention(16, 4, causal=causal)
    pm = nn.MultiHeadSelfAttention(16, 4, causal=causal, device="cpu")
    load_jax_params(pm, jax.tree_util.tree_map(np.asarray, jm.params()))
    rs = np.random.RandomState(2)
    x = rs.randn(2, 8, 16).astype(np.float32)
    g = rs.randn(2, 8, 16).astype(np.float32)

    def f(p, xx):
        return (jm.apply(p, xx, jm.state(), TRAIN)[0] * g).sum()

    gp, gx = jax.grad(f, argnums=(0, 1))(jm.params(), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    (pm(xt) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **TOL)
    for k in ("wq", "wk", "wv", "wo", "bq", "bk", "bv", "bo"):
        np.testing.assert_allclose(getattr(pm, k).grad.numpy(),
                                   np.asarray(gp["~"][k]), **TOL, err_msg=k)


# -- six-step trajectories ------------------------------------------------

def _classifier_records():
    """tests/test_transformer.py:_ds: 32 (8, 16) records, 4 classes."""
    rs = np.random.RandomState(0)
    return [(rs.randn(8, 16).astype(np.float32),
             np.asarray([float(i % 4 + 1)], np.float32)) for i in range(32)]


def _lm_records():
    """test_transformer_lm_sequence_parallel_matches_local's: one-hot
    (8, 8) inputs and a class a step."""
    rs = np.random.RandomState(0)
    return [(np.eye(8, dtype=np.float32)[rs.randint(0, 8, 8)],
             (rs.randint(0, 8, 8) + 1.0)) for _ in range(32)]


def _trajectories(kind, arch, records, crit, lr, iters=6):
    jm, pm = _pair(kind, arch)
    jds = JDataSet.array([JSample(x, y) for x, y in records]) \
        >> JSampleToBatch(16)
    jopt = JLocalOptimizer(jm, jds, crit(jnn))
    jopt.set_state(JT(learningRate=lr))
    jopt.set_end_when(jmax_iteration(iters))
    set_seed(5)   # the epoch order: the JAX shuffle draws from here
    jopt.optimize()
    ds = DataSet.array([Sample(x, y) for x, y in records], seed=5) \
        >> SampleToBatch(16)
    opt = LocalOptimizer(pm, ds, crit(nn), device="cpu")
    opt.set_state(T(learningRate=lr))
    opt.set_end_when(max_iteration(iters))
    opt.optimize()
    assert len(opt.loss_log) == iters
    np.testing.assert_allclose(opt.loss_log[-1][1],
                               float(jopt.state["loss"]), **TOL)
    want = dict(_leaves_with_paths(
        jax.tree_util.tree_map(np.asarray, jm.params())))
    for path, got in _leaves_with_paths(export_params(pm)):
        np.testing.assert_allclose(got, want[path], **TOL,
                                   err_msg="/".join(path))
    return [l for _, l in opt.loss_log]


@pytest.mark.parametrize("kind", ["plain", "moe"])
def test_classifier_trajectory_matches_jax(kind):
    """test_transformer_trains_and_sp_matches_local's local run: six
    steps at lr 0.1, losses and every parameter."""
    losses = _trajectories("classifier", CLASSIFIERS[kind],
                           _classifier_records(),
                           lambda m: m.ClassNLLCriterion(), 0.1)
    assert np.isfinite(losses).all()


def test_lm_trajectory_matches_jax():
    """The LM with TimeDistributedCriterion(ClassNLLCriterion,
    size_average=True), six steps at lr 0.1."""
    losses = _trajectories(
        "lm", dict(LM, n_layers=1), _lm_records(),
        lambda m: m.TimeDistributedCriterion(m.ClassNLLCriterion(),
                                             size_average=True), 0.1)
    assert losses[-1] < losses[0]


def test_classifier_head_and_flags():
    """The head is LayerNorm, Mean over time, Linear, LogSoftMax; causal
    reaches every attention layer; MoE blocks replace the FFN."""
    m = TransformerClassifier(4, d_model=16, n_heads=2, n_layers=2,
                              hidden=32, causal=True, moe_experts=4,
                              device="cpu")
    mods = list(m.children())
    assert [type(x).__name__ for x in mods[-4:]] == [
        "LayerNorm", "Mean", "Linear", "LogSoftMax"]
    attn = [x for x in m.modules()
            if isinstance(x, nn.MultiHeadSelfAttention)]
    assert len(attn) == 2 and all(a.causal for a in attn)
    assert sum(isinstance(x, nn.MoE) for x in m.modules()) == 2
    y = m(torch.randn(2, 8, 16))
    assert y.shape == (2, 4) and torch.isfinite(y).all()
