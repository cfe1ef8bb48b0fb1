"""Text pipeline (counterpart of bigdl_tpu/dataset/text.py; ref
dataset/text/: LabeledSentence types, LabeledSentenceToSample.scala:43;
models/rnn/Utils.scala Dictionary :144, WordTokenizer :207).

Host-side numpy: a vocabulary of the most frequent words with an
out-of-vocabulary bucket, a lower-case word tokenizer, language-model
pairs shifted by one word, and Samples of one-hot or index features with
1-based padded labels.
"""
from __future__ import annotations

import re
from collections import Counter

import numpy as np

from bigdl_tpu_torch.dataset.sample import LabeledSentence, Sample
from bigdl_tpu_torch.dataset.transformer import Transformer


class Dictionary:
    """Vocabulary built from tokenized sentences (ref rnn/Utils.Dictionary
    :144): the ``vocab_size`` most frequent words (ties in first-seen
    order), the rest mapped to an out-of-vocabulary bucket."""

    def __init__(self, sentences=None, vocab_size: int = None):
        self.word2index = {}
        self.index2word = []
        if sentences is not None:
            counts = Counter(w for s in sentences for w in s)
            for w, _ in counts.most_common(vocab_size):
                self.add_word(w)

    def add_word(self, word):
        if word not in self.word2index:
            self.word2index[word] = len(self.index2word)
            self.index2word.append(word)
        return self.word2index[word]

    def vocab_size(self):
        return len(self.index2word)

    def index(self, word):
        """0-based index; unknown words map to vocab_size (OOV bucket)."""
        return self.word2index.get(word, len(self.index2word))

    def word(self, index):
        """Reverse lookup (ref Dictionary.getWord): the OOV bucket and
        out-of-range indices render as ``<unk>``."""
        if 0 <= int(index) < len(self.index2word):
            return self.index2word[int(index)]
        return "<unk>"


class WordTokenizer(Transformer):
    """Lower-case word tokenizer (ref rnn/Utils.WordTokenizer :207); empty
    lines give no sentence."""

    def __call__(self, iterator):
        for line in iterator:
            tokens = re.findall(r"[\w']+", line.lower())
            if tokens:
                yield tokens


class SentenceToLabeledSentence(Transformer):
    """Language-model pairs: data = w_0..w_{n-2}, label = w_1..w_{n-1}
    (the reference rnn Train pipeline's shift-by-one); sentences of one
    word give none."""

    def __init__(self, dictionary: Dictionary):
        self.dictionary = dictionary

    def __call__(self, iterator):
        for tokens in iterator:
            ids = np.asarray([self.dictionary.index(w) for w in tokens],
                             np.int64)
            if len(ids) < 2:
                continue
            yield LabeledSentence(ids[:-1], ids[1:])


class LabeledSentenceToSample(Transformer):
    """LabeledSentence -> Sample (ref text/LabeledSentenceToSample.scala
    :43): one-hot features (length, ``n_input_dims``) when the vocabulary
    size is given (SimpleRNN's input), else the ids as floats padded with
    ``pad_value``; labels are 1-based classes, padded with
    ``label_pad_class`` (a padded position still needs a valid class)."""

    def __init__(self, n_input_dims: int = None, fixed_length: int = None,
                 pad_value: int = 0, label_pad_class: int = 1):
        self.n_input_dims = n_input_dims
        self.fixed_length = fixed_length
        self.pad_value = pad_value
        self.label_pad_class = label_pad_class

    def __call__(self, iterator):
        for s in iterator:
            length = (self.fixed_length if self.fixed_length is not None
                      else s.data_length())
            data_ids = s.data[:length]
            label_ids = s.label[:length]
            if self.n_input_dims is not None:
                feat = np.zeros((length, self.n_input_dims), np.float32)
                feat[np.arange(len(data_ids)), data_ids] = 1.0
            else:
                feat = np.full((length,), self.pad_value, np.float32)
                feat[:len(data_ids)] = data_ids
            label = np.full((length,), self.label_pad_class, np.float32)
            label[:len(label_ids)] = label_ids + 1
            yield Sample(feat, label)
