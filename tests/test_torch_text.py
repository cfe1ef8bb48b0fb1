"""The port's text pipeline (bigdl_tpu_torch/dataset/text.py) against the
JAX package's: the dictionary (most frequent words, the OOV bucket, the
reverse lookup), the tokenizer, the language-model pairs and the padded
one-hot or index Samples, then whole batches of examples/train_rnn.py's
pipeline over its built-in corpus, equal bit for bit in the same epoch
order."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

from bigdl_tpu.dataset import DataSet as JaxDataSet
from bigdl_tpu.dataset import text as jtext
from bigdl_tpu.dataset.transformer import SampleToBatch as JaxSampleToBatch
from bigdl_tpu.utils.random import set_seed
from bigdl_tpu_torch.dataset import DataSet, LabeledSentence, SampleToBatch
from bigdl_tpu_torch.dataset import text

ROOT = Path(__file__).resolve().parent.parent
LINES = ["The cat sat.", "", "the dog's bone, the cat!", "a", "Dog  sat on"
         " the MAT", "cat cat cat dog"]


def _example():
    spec = importlib.util.spec_from_file_location(
        "train_rnn", ROOT / "examples" / "train_rnn.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_tokenizer_matches_jax():
    got = list(text.WordTokenizer()(iter(LINES)))
    assert got == list(jtext.WordTokenizer()(iter(LINES)))
    assert got[1] == ["the", "dog's", "bone", "the", "cat"]


@pytest.mark.parametrize("vocab_size", [None, 3, 100])
def test_dictionary_matches_jax(vocab_size):
    toks = list(text.WordTokenizer()(iter(LINES)))
    got, want = (text.Dictionary(toks, vocab_size),
                 jtext.Dictionary(toks, vocab_size))
    assert got.index2word == want.index2word
    assert got.vocab_size() == want.vocab_size()
    for w in ("the", "cat", "zebra", "a"):
        assert got.index(w) == want.index(w)
    for i in (-1, 0, 2, got.vocab_size(), 99):
        assert got.word(i) == want.word(i)
    assert got.index("zebra") == got.vocab_size()   # the OOV bucket


@pytest.mark.parametrize("n_input_dims,fixed_length", [
    (8, None), (8, 3), (8, 6), (None, None), (None, 4)])
def test_samples_match_jax(n_input_dims, fixed_length):
    """Language-model pairs shifted by one word (one-word sentences
    dropped), then one-hot or index features and 1-based labels, padded
    or cut to ``fixed_length``."""
    toks = list(text.WordTokenizer()(iter(LINES)))
    d = text.Dictionary(toks, vocab_size=6)
    got = list(text.LabeledSentenceToSample(n_input_dims, fixed_length)(
        text.SentenceToLabeledSentence(d)(iter(toks))))
    want = list(jtext.LabeledSentenceToSample(n_input_dims, fixed_length)(
        jtext.SentenceToLabeledSentence(jtext.Dictionary(toks, 6))(
            iter(toks))))
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert a.feature.dtype == np.float32 and a.label.dtype == np.float32
        np.testing.assert_array_equal(a.feature, np.asarray(b.feature))
        np.testing.assert_array_equal(a.label, np.asarray(b.label))


def test_labeled_sentence():
    s = LabeledSentence([3, 1, 4], [1, 4, 1, 5])
    assert (s.data_length(), s.label_length()) == (3, 4)
    assert s.data.dtype == np.asarray([1]).dtype


def test_train_rnn_batches_match_jax():
    """examples/train_rnn.py's pipeline over its built-in corpus (vocab
    4000 with the OOV bucket, seqLength 8, batch 4): two epochs of
    batches, shuffled from seed 3, equal the JAX pipeline's bit for
    bit."""
    lines = _example().FALLBACK_CORPUS.strip().split("\n")
    toks = list(text.WordTokenizer()(iter(lines)))
    d = text.Dictionary(toks, vocab_size=4000)
    vocab = d.vocab_size() + 1
    port = (DataSet.array(toks, seed=3)
            >> text.SentenceToLabeledSentence(d)
            >> text.LabeledSentenceToSample(n_input_dims=vocab,
                                            fixed_length=8)
            >> SampleToBatch(4))
    jd = jtext.Dictionary(toks, vocab_size=4000)
    jax_ds = (JaxDataSet.array(toks)
              >> jtext.SentenceToLabeledSentence(jd)
              >> jtext.LabeledSentenceToSample(n_input_dims=vocab,
                                               fixed_length=8)
              >> JaxSampleToBatch(4))
    set_seed(3)
    jit, pit = jax_ds.data(train=True), port.data(train=True)
    for epoch in range(2):
        for _ in range(port.size() // 4):
            a, b = next(pit), next(jit)
            assert a.data.shape == (4, 8, vocab)
            np.testing.assert_array_equal(a.data, np.asarray(b.data))
            np.testing.assert_array_equal(a.labels, np.asarray(b.labels))
        port.shuffle()
        jax_ds.shuffle()
        jit, pit = jax_ds.data(train=True), port.data(train=True)
