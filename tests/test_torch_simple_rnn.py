"""The port's SimpleRNN slice against the JAX package: the model's
parameter tree, ``TimeDistributedCriterion`` (loss and input gradient,
per-step and shared targets), 4 ``LocalOptimizer`` steps of
examples/train_rnn.py over its built-in corpus at bptt 4 (chunked kernel
calls against the JAX chunked scan) and at bptt 0 (one call against the
JAX scan and its Pallas kernel, interpreted) from the same parameters and
batch order, and ``generate`` giving the same words from the same
``RandomState``.  Weights cross through ``nn.module.load_jax_params``.
Tolerances: the criterion rtol 1e-5 / atol 1e-6 forward and 1e-4 / 1e-5
on gradients (the JAX tests'); trajectories rtol 1e-4 / atol 1e-5."""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.dataset import DataSet as JaxDataSet
from bigdl_tpu.dataset import text as jtext
from bigdl_tpu.dataset.transformer import SampleToBatch as JaxSampleToBatch
from bigdl_tpu.models import rnn as jax_rnn
from bigdl_tpu.nn import recurrent as jax_recurrent
from bigdl_tpu.optim import LocalOptimizer as JaxLocalOptimizer
from bigdl_tpu.optim import max_iteration as jax_max_iteration
from bigdl_tpu.utils.random import set_seed
from bigdl_tpu.utils.table import T as JaxT
from bigdl_tpu_torch import nn, ops
from bigdl_tpu_torch.dataset import DataSet, SampleToBatch, text
from bigdl_tpu_torch.models import rnn, textclassifier
from bigdl_tpu_torch.nn.module import export_params, load_jax_params
from bigdl_tpu_torch.optim import LocalOptimizer, max_iteration
from bigdl_tpu_torch.utils.random import generator
from bigdl_tpu_torch.utils.table import T

ROOT = Path(__file__).resolve().parent.parent
FWD = dict(rtol=1e-5, atol=1e-6)
BWD = dict(rtol=1e-4, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-5)


def _tree(m):
    return jax.tree_util.tree_map(np.asarray, m.params())


def _assert_trees_close(got, want, **tol):
    g, w = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w) > 0
    for a, b in zip(g, w):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


def _corpus():
    """examples/train_rnn.py's built-in corpus, tokenized, and its
    dictionary at the example's vocabSize."""
    spec = importlib.util.spec_from_file_location(
        "train_rnn", ROOT / "examples" / "train_rnn.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    toks = list(text.WordTokenizer()(iter(
        mod.FALLBACK_CORPUS.strip().split("\n"))))
    return toks, text.Dictionary(toks, 4000), jtext.Dictionary(toks, 4000)


def test_param_tree_carries_across():
    """The JAX SimpleRNN's paths and shapes at examples/train_rnn.py's
    widths (4,001 words in and out, hidden 40); the JAX tree goes in and
    comes out unchanged."""
    set_seed(1)
    jm = jax_rnn.SimpleRNN(4001, 40, 4001)
    pm = rnn.SimpleRNN(4001, 40, 4001, device="cpu", generator=generator(0))
    want = _tree(jm)
    got = jax.tree_util.tree_leaves_with_path(export_params(pm))
    assert [(k, v.shape) for k, v in got] == [
        (k, v.shape) for k, v in jax.tree_util.tree_leaves_with_path(want)]
    assert sum(p.numel() for p in pm.parameters()) == 325761
    load_jax_params(pm, want)
    _assert_trees_close(export_params(pm), want, rtol=0, atol=0)


def test_bilstm_classifier_alias():
    a = rnn.BiLSTMClassifier(6, 5, 4, device="cpu", generator=generator(2))
    b = textclassifier.TextClassifierBiLSTM(4, 6, 5, device="cpu",
                                            generator=generator(2))
    _assert_trees_close(export_params(a), export_params(b), rtol=0, atol=0)


@pytest.mark.parametrize("size_average", [False, True])
@pytest.mark.parametrize("per_step", [True, False])
def test_time_distributed_criterion_matches_jax(size_average, per_step):
    """ClassNLL at every step of (N, T, C) log-probs, against per-step
    targets (N, T) or one target (N,) for every step: the loss and the
    input gradient."""
    rs = np.random.RandomState(3)
    logp = np.log(rs.dirichlet(np.ones(7), size=(4, 5))).astype(np.float32)
    target = (rs.randint(0, 7, (4, 5) if per_step else (4,)) + 1).astype(
        np.float32)
    jc = jnn.TimeDistributedCriterion(jnn.ClassNLLCriterion(), size_average)
    want, dwant = jax.value_and_grad(jc.apply_loss)(jnp.asarray(logp),
                                                    jnp.asarray(target))
    pc = nn.TimeDistributedCriterion(nn.ClassNLLCriterion(), size_average)
    x = torch.from_numpy(logp)
    got = pc(x, torch.from_numpy(target))
    np.testing.assert_allclose(float(got), float(want), **FWD)
    np.testing.assert_allclose(pc.backward(x, torch.from_numpy(target))
                               .numpy(), np.asarray(dwant), **BWD)


def _trajectories(bptt, seed):
    """4 steps of examples/train_rnn.py's loop (batch 4, seqLength 8, lr
    0.1) at hidden 8 in both packages from the same parameters; the epoch
    order from ``seed``."""
    toks, d, jd = _corpus()
    vocab = d.vocab_size() + 1
    set_seed(seed + 1)
    jm = jax_rnn.SimpleRNN(vocab, 8, vocab, bptt_truncate=bptt)
    pm = load_jax_params(rnn.SimpleRNN(vocab, 8, vocab, bptt_truncate=bptt,
                                       device="cpu"), _tree(jm))
    jds = (JaxDataSet.array(toks) >> jtext.SentenceToLabeledSentence(jd)
           >> jtext.LabeledSentenceToSample(n_input_dims=vocab,
                                            fixed_length=8)
           >> JaxSampleToBatch(4))
    jopt = JaxLocalOptimizer(jm, jds, jnn.TimeDistributedCriterion(
        jnn.ClassNLLCriterion(), size_average=True))
    jopt.set_state(JaxT(learningRate=0.1)).set_end_when(jax_max_iteration(4))
    jopt.set_iterations_per_dispatch(1)
    set_seed(seed)
    jopt.optimize()
    pds = (DataSet.array(toks, seed=seed) >> text.SentenceToLabeledSentence(d)
           >> text.LabeledSentenceToSample(n_input_dims=vocab,
                                           fixed_length=8)
           >> SampleToBatch(4))
    popt = LocalOptimizer(pm, pds, nn.TimeDistributedCriterion(
        nn.ClassNLLCriterion(), size_average=True), device="cpu")
    popt.set_state(T(learningRate=0.1)).set_end_when(max_iteration(4))
    popt.set_iterations_per_dispatch(1).optimize()
    return jm, jopt, pm, popt, d, jd


@pytest.mark.parametrize("bptt,route", [(4, True), (0, False),
                                        (0, "interpret")],
                         ids=["bptt4-scan", "bptt0-scan", "bptt0-pallas"])
def test_training_trajectory_matches_jax(monkeypatch, bptt, route):
    """Four iterations over the built-in corpus (8 sentences, so two
    epochs): ``neval``, ``epoch``, ``state['loss']`` and the final
    parameters equal the JAX run's.  At bptt 4 every step runs two
    chunks against the JAX chunked scan."""
    monkeypatch.setattr(jax_recurrent, "_PALLAS_BILSTM", route)
    jm, jopt, pm, popt, _, _ = _trajectories(bptt, seed=5)
    assert popt.state["neval"] == jopt.state["neval"] == 5
    assert popt.state["epoch"] == jopt.state["epoch"] == 3
    np.testing.assert_allclose(popt.state["loss"], jopt.state["loss"], **TOL)
    _assert_trees_close(export_params(pm), jm.params(), **TOL)


def test_generate_matches_jax():
    """From the trained parameters, 12 words sampled after the first
    sentence from the same RandomState, at temperature 1 and with a
    temperature and top-k: the same ids."""
    jm, _, pm, _, d, jd = _trajectories(4, seed=7)
    toks, _, _ = _corpus()
    seed = [d.index(w) for w in toks[0]]
    assert seed == [jd.index(w) for w in toks[0]]
    for kw in ({}, dict(temperature=0.7, top_k=5)):
        got = rnn.generate(pm, d, seed, 12, np.random.RandomState(11), **kw)
        want = jax_rnn.generate(jm, jd, seed, 12, np.random.RandomState(11),
                                **kw)
        assert got == want and len(got) == len(seed) + 12
    assert pm.training   # generate leaves the mode as it found it


def test_adjust_logprobs_matches_jax():
    logp = np.log(np.random.RandomState(2).dirichlet(np.ones(9)))
    for t, k in ((1.0, 0), (0.5, 0), (1.0, 3), (2.0, 4)):
        np.testing.assert_allclose(rnn.adjust_logprobs(logp, t, k),
                                   jax_rnn.adjust_logprobs(logp, t, k),
                                   rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="temperature must be > 0"):
        rnn.adjust_logprobs(logp, 0.0)


def test_cpu_training_counts_no_launch():
    toks, d, _ = _corpus()
    vocab = d.vocab_size() + 1
    ops.reset_launch_counts()
    ds = (DataSet.array(toks) >> text.SentenceToLabeledSentence(d)
          >> text.LabeledSentenceToSample(n_input_dims=vocab, fixed_length=8)
          >> SampleToBatch(4))
    opt = LocalOptimizer(rnn.SimpleRNN(vocab, 8, vocab, device="cpu",
                                       generator=generator(1)), ds,
                         nn.TimeDistributedCriterion(nn.ClassNLLCriterion(),
                                                     size_average=True),
                         device="cpu")
    opt.set_state(T(learningRate=0.1)).set_end_when(max_iteration(2))
    opt.optimize()
    rnn.generate(opt.model, d, [0, 1], 2, np.random.RandomState(0))
    assert set(ops.launch_counts().values()) == {0}
    assert opt.state["neval"] == 3 and np.isfinite(opt.state["loss"])


def test_entry_point_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rnn.SimpleRNN()
