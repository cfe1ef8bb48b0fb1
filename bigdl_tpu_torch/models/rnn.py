"""SimpleRNN language model and its word sampler (counterpart of
bigdl_tpu/models/rnn.py; ref models/rnn/SimpleRNN.scala:23-38 and
rnn/Test.scala), plus the ``BiLSTMClassifier`` alias.

``SimpleRNN`` is ``Recurrent(RnnCell + Tanh)`` over one-hot words, then a
per-step ``Linear`` and ``LogSoftMax``; its recurrence runs the
``rnn_recurrence`` kernels, in chunks of ``bptt_truncate`` steps while
training.  It keeps the JAX model's layers one for one, so
``nn.module.load_jax_params`` takes the JAX model's ``params()`` tree.
Weights are drawn on the CPU from ``generator`` and placed on ``device``:
the card unless the caller asks for the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

import bigdl_tpu_torch.nn as nn
from bigdl_tpu_torch.models.textclassifier import TextClassifierBiLSTM
from bigdl_tpu_torch.utils.device import resolve_device


def SimpleRNN(input_size: int = 4000, hidden_size: int = 40,
              output_size: int = 4000, bptt_truncate: int = 4,
              device="cuda", generator=None):
    """(ref SimpleRNN.scala:23-38) (N, T, vocab) one-hot input ->
    Recurrent(RnnCell + Tanh) -> per-step Linear -> LogSoftMax."""
    kw = dict(device=resolve_device(device), generator=generator)
    return nn.Sequential(
        nn.Recurrent(bptt_truncate).add(
            nn.RnnCell(input_size, hidden_size, nn.Tanh(), **kw)),
        nn.TimeDistributed(nn.Sequential(
            nn.Linear(hidden_size, output_size, **kw),
            nn.LogSoftMax())),
    )


def adjust_logprobs(logp, temperature: float = 1.0, top_k: int = 0):
    """Renormalized log-probs (float64) after temperature scaling and
    top-k truncation; both default to the reference's raw distribution."""
    logp = np.asarray(logp, np.float64)
    if temperature != 1.0:
        if temperature <= 0:
            raise ValueError("temperature must be > 0 (use a small value "
                             "like 1e-3 to approach greedy)")
        logp = logp / temperature
    if top_k and top_k < logp.size:
        kth = np.partition(logp, -top_k)[-top_k]
        logp = np.where(logp >= kth, logp, -np.inf)
    logp = logp - logp.max()
    return logp - np.log(np.exp(logp).sum())


def generate(model, dictionary, seed_ids, n_words, rng,
             temperature: float = 1.0, top_k: int = 0):
    """Word-by-word sampling, the reference's rnn/Test.scala loop
    (:58-90): forward the sentence, inverse-CDF-sample the next word from
    the last step's distribution, append, repeat.

    ``seed_ids`` are 0-based word ids; returns the extended list.  Each
    word is a fresh forward of the whole sentence without gradients, on
    the model's device; the draw is on the host from ``rng``, an explicit
    ``numpy.random.RandomState``, with the JAX package's index
    ``(cumsum < draw).sum()`` clamped to the last class of nonzero
    probability (rounding can leave the cumsum a hair under 1)."""
    vocab = dictionary.vocab_size() + 1   # + OOV bucket
    ids = [int(i) for i in seed_ids]
    device = next(model.parameters()).device
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            for _ in range(int(n_words)):
                x = np.zeros((1, len(ids), vocab), np.float32)
                x[0, np.arange(len(ids)), ids] = 1.0
                out = model(torch.from_numpy(x).to(device))
                logp = adjust_logprobs(out[0, -1].cpu().numpy(),
                                       temperature, top_k)
                probs = np.exp(logp)
                probs /= probs.sum()
                idx = int((np.cumsum(probs) < rng.uniform()).sum())
                ids.append(min(idx, int(np.flatnonzero(probs)[-1])))
    finally:
        model.train(was_training)
    return ids


def BiLSTMClassifier(input_size: int, hidden_size: int, class_num: int,
                     device="cuda", generator=None):
    """The Bi-LSTM text classifier under its first name: canonical builder
    ``models.textclassifier.TextClassifierBiLSTM``."""
    return TextClassifierBiLSTM(class_num, input_size, hidden_size,
                                device=device, generator=generator)
