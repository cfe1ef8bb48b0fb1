"""The port's text-classifier slice against the JAX package: the
``TextClassifierBiLSTM`` parameter tree at BASELINE config 4's widths,
its log-probs and every parameter gradient at a small size (the JAX
recurrence on its Pallas route, interpreted, and on ``lax.scan``),
``TextClassifierConv`` (the JAX pools on their Mosaic route, interpreted:
its first-max tie rule is the port's), a 4-step ``LocalOptimizer`` run on
examples/text_classifier.py's synthetic corpus from the same parameters
and batch order, and the ``news20`` readers on a tiny corpus and GloVe
file written for the test.

Weights cross from the JAX models through ``nn.module.load_jax_params``.
Tolerances are the JAX tests' own: forward rtol 1e-5 / atol 1e-6 on the
recurrence, rtol 1e-4 / atol 1e-5 on gradients and on whole models.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.dataset import DataSet as JaxDataSet
from bigdl_tpu.dataset import Sample as JaxSample
from bigdl_tpu.dataset import news20 as jax_news20
from bigdl_tpu.dataset.transformer import SampleToBatch as JaxSampleToBatch
from bigdl_tpu.models import textclassifier as jax_tc
from bigdl_tpu.nn import pooling as jax_pooling
from bigdl_tpu.nn import recurrent as jax_recurrent
from bigdl_tpu.nn.module import Context
from bigdl_tpu.optim import LocalOptimizer as JaxLocalOptimizer
from bigdl_tpu.optim import Top1Accuracy as JaxTop1
from bigdl_tpu.optim import max_iteration as jax_max_iteration
from bigdl_tpu.optim import validate as jax_validate
from bigdl_tpu.utils.random import set_seed
from bigdl_tpu.utils.table import T as JaxT
from bigdl_tpu_torch import nn, ops
from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToBatch, news20
from bigdl_tpu_torch.models import textclassifier
from bigdl_tpu_torch.nn.module import export_params, load_jax_params
from bigdl_tpu_torch.optim import (LocalOptimizer, Top1Accuracy,
                                   max_iteration, validate)
from bigdl_tpu_torch.utils.random import generator
from bigdl_tpu_torch.utils.table import T

TOL = dict(rtol=1e-4, atol=1e-5)


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


def _loss_and_grads(jm, pm, x, y):
    """Log-probs, NLL loss and parameter gradients of both models on one
    batch; the port model's come back as (out, loss) with .grad set."""
    crit = jnn.ClassNLLCriterion()
    ctx = Context(training=True)

    def loss_fn(p):
        out, _ = jm.apply(p, jnp.asarray(x), jm.state(), ctx)
        return crit.apply_loss(out, jnp.asarray(y)), out

    (loss_j, out_j), grads_j = jax.value_and_grad(loss_fn, has_aux=True)(
        jm.params())
    out = pm(torch.from_numpy(x))
    loss = nn.ClassNLLCriterion()(out, torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), **TOL)
    _assert_trees_close(_grads(pm), grads_j, **TOL)
    return np.asarray(out_j)


def test_bilstm_param_tree_carries_across():
    """BASELINE config 4: 364,616 parameters, the JAX tree's paths and
    shapes; the JAX tree goes in and comes out unchanged."""
    set_seed(1)
    jm = jax_tc.TextClassifierBiLSTM(20, 200, 128)
    port = textclassifier.TextClassifierBiLSTM(20, 200, 128, device="cpu",
                                               generator=generator(0))
    want = _tree(jm)
    got = jax.tree_util.tree_leaves_with_path(export_params(port))
    assert [(k, v.shape) for k, v in got] == [
        (k, v.shape) for k, v in jax.tree_util.tree_leaves_with_path(want)]
    assert sum(p.numel() for p in port.parameters()) == 364616
    load_jax_params(port, want)
    _assert_trees_close(export_params(port), want, rtol=0, atol=0)


@pytest.mark.parametrize("route", ["interpret", False],
                         ids=["pallas", "scan"])
def test_bilstm_log_probs_and_grads_match_jax(monkeypatch, route):
    """E 6, H 5, T 7, 4 classes, a batch of 3."""
    monkeypatch.setattr(jax_recurrent, "_PALLAS_BILSTM", route)
    set_seed(2)
    jm = jax_tc.TextClassifierBiLSTM(4, 6, 5)
    pm = load_jax_params(textclassifier.TextClassifierBiLSTM(
        4, 6, 5, device="cpu"), _tree(jm))
    rs = np.random.RandomState(3)
    x = rs.randn(3, 7, 6).astype(np.float32)
    y = (rs.randint(0, 4, 3) + 1).astype(np.float32)
    out_j = _loss_and_grads(jm, pm, x, y)
    pm.evaluate()
    with torch.no_grad():   # validation's form: the primal recurrence
        np.testing.assert_allclose(pm(torch.from_numpy(x)).numpy(), out_j,
                                   **TOL)


def test_conv_log_probs_and_grads_match_jax(monkeypatch):
    """The shortest sequence the three stages take (149), embed 8, 4
    classes, a batch of 2."""
    monkeypatch.setattr(jax_pooling, "_PALLAS_POOL", "interpret")
    set_seed(4)
    jm = jax_tc.TextClassifierConv(4, 149, 8)
    pm = load_jax_params(textclassifier.TextClassifierConv(
        4, 149, 8, device="cpu"), _tree(jm))
    assert sum(p.numel() for p in pm.parameters()) == sum(
        np.asarray(v).size for v in jax.tree_util.tree_leaves(jm.params()))
    rs = np.random.RandomState(5)
    x = rs.randn(2, 149, 8).astype(np.float32)
    y = np.asarray([2.0, 4.0], np.float32)
    _loss_and_grads(jm, pm, x, y)
    with pytest.raises(ValueError, match="too short"):
        textclassifier.TextClassifierConv(4, 148, 8, device="cpu")


def _corpus(n, seq, embed, classes):
    """examples/text_classifier.py:56-64's synthetic documents."""
    rng = np.random.RandomState(0)
    means = rng.randn(classes, embed)
    docs = []
    for i in range(n):
        c = i % classes
        docs.append(((rng.randn(seq, embed) * 0.5 + means[c]).astype(
            np.float32), np.asarray([c + 1.0])))
    return docs


def test_local_optimizer_trajectory_matches_jax():
    """Four iterations over one shuffled epoch of 32 documents (T 7, E 6)
    in batches of 8 with the example's state (lr 0.01, momentum 0.9) and
    the tail batch dropped: the final parameters, ``state['loss']`` and
    ``neval`` equal the JAX run's; then Top1 on the 8 held-out documents
    is the same count."""
    set_seed(6)
    jm = jax_tc.TextClassifierBiLSTM(4, 6, 5)
    pm = load_jax_params(textclassifier.TextClassifierBiLSTM(
        4, 6, 5, device="cpu"), _tree(jm))
    docs = _corpus(40, 7, 6, 4)
    train, held_out = docs[:32], docs[32:]
    state = dict(learningRate=0.01, momentum=0.9)

    jds = (JaxDataSet.array([JaxSample(f, l) for f, l in train])
           >> JaxSampleToBatch(8, drop_last=True))
    jopt = JaxLocalOptimizer(jm, jds, jnn.ClassNLLCriterion())
    jopt.set_state(JaxT(**state)).set_end_when(jax_max_iteration(4))
    set_seed(7)   # the epoch order: the JAX shuffle draws from this stream
    jopt.optimize()

    pds = (DataSet.array([Sample(f, l) for f, l in train], seed=7)
           >> SampleToBatch(8, drop_last=True))
    popt = LocalOptimizer(pm, pds, nn.ClassNLLCriterion(), device="cpu")
    popt.set_state(T(**state)).set_end_when(max_iteration(4))
    popt.optimize()

    assert popt.state["neval"] == jopt.state["neval"] == 5
    assert popt.state["epoch"] == jopt.state["epoch"] == 2
    np.testing.assert_allclose(popt.state["loss"], jopt.state["loss"], **TOL)
    _assert_trees_close(export_params(pm), jm.params(), **TOL)

    (_, want), = jax_validate(
        jm, jm.params(), jm.state(),
        JaxDataSet.array([JaxSample(f, l) for f, l in held_out])
        >> JaxSampleToBatch(8), [JaxTop1()])
    (_, got), = validate(
        pm, DataSet.array([Sample(f, l) for f, l in held_out])
        >> SampleToBatch(8), [Top1Accuracy()], "cpu")
    assert (got.correct, got.count) == (want.correct, want.count)


def test_cpu_training_counts_no_launch():
    ops.reset_launch_counts()
    docs = _corpus(16, 7, 6, 4)
    ds = (DataSet.array([Sample(f, l) for f, l in docs])
          >> SampleToBatch(8, drop_last=True))
    opt = LocalOptimizer(textclassifier.TextClassifierBiLSTM(
        4, 6, 5, device="cpu", generator=generator(1)), ds,
        nn.ClassNLLCriterion(), device="cpu")
    opt.set_state(T(learningRate=0.01, momentum=0.9))
    opt.set_end_when(max_iteration(2)).optimize()
    assert set(ops.launch_counts().values()) == {0}
    assert opt.state["neval"] == 3 and np.isfinite(opt.state["loss"])


@pytest.mark.parametrize("build", [
    lambda: textclassifier.TextClassifierBiLSTM(20, 200, 128),
    lambda: textclassifier.TextClassifierConv(20, 200, 50),
])
def test_entry_points_default_to_the_card(build):
    """Without a card the model factories raise unless asked for the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build()


def _write_corpus(root):
    """Two groups of two posts and a GloVe file of 4-d vectors, with a
    glove.6B/ folder beside the groups (not a class)."""
    posts = {"comp.graphics": ["Rendering a Mesh, 3 times!",
                               "caf\xe9 shaders\nand MESH"],
             "alt.atheism": ["the mesh is not a god", ""]}
    news = root / "20_newsgroups"
    for group, texts in posts.items():
        (news / group).mkdir(parents=True)
        for k, text in enumerate(texts):
            (news / group / str(1000 + k)).write_bytes(text.encode("latin-1"))
    (news / "glove.6B").mkdir()
    glove = root / "glove.6B"
    glove.mkdir()
    rs = np.random.RandomState(8)
    words = ["mesh", "the", "a", "rendering", "shaders", "god", "and"]
    (glove / "glove.6B.4d.txt").write_text("".join(
        w + " " + " ".join(f"{v:.5f}" for v in rs.randn(4)) + "\n"
        for w in words), encoding="utf-8")


@pytest.mark.parametrize("seq_len", [3, 9])
def test_news20_matches_jax(tmp_path, seq_len):
    """Texts and 1-based labels in sorted group order, the word vectors,
    the tokens and the padded (or cut) embedded Samples equal the JAX
    readers'."""
    _write_corpus(tmp_path)
    texts = news20.get_news20(str(tmp_path))
    assert texts == jax_news20.get_news20(str(tmp_path))
    assert [lbl for _, lbl in texts] == [1.0, 1.0, 2.0, 2.0]
    w2v = news20.get_glove_w2v(str(tmp_path), dim=4)
    want = jax_news20.get_glove_w2v(str(tmp_path), dim=4)
    assert sorted(w2v) == sorted(want)
    for w in want:
        np.testing.assert_array_equal(w2v[w], want[w])
    for text, _ in texts:
        assert news20.tokenize(text) == jax_news20.tokenize(text)
    got = news20.embed_samples(texts, w2v, seq_len, 4)
    ref = jax_news20.embed_samples(texts, want, seq_len, 4)
    assert len(got) == len(ref) == 4
    for a, b in zip(got, ref):
        assert a.feature.dtype == np.float32 and a.label.dtype == np.float32
        np.testing.assert_array_equal(a.feature, np.asarray(b.feature))
        np.testing.assert_array_equal(a.label, np.asarray(b.label))


def test_news20_reads_local_copies_only(tmp_path):
    for fn in (news20.get_news20, jax_news20.get_news20):
        with pytest.raises(FileNotFoundError, match="class folders"):
            fn(str(tmp_path))
    for fn in (news20.get_glove_w2v, jax_news20.get_glove_w2v):
        with pytest.raises(FileNotFoundError, match="glove.6B.50d.txt"):
            fn(str(tmp_path), dim=50)
    (tmp_path / "alt.atheism").mkdir()
    with pytest.raises(FileNotFoundError, match="no documents"):
        news20.get_news20(str(tmp_path))
