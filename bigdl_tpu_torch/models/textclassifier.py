"""Text classifiers over word embeddings (counterpart of
bigdl_tpu/models/textclassifier.py).

- ``TextClassifierConv``: the reference's temporal conv net
  (example/textclassification/TextClassifier.scala:119-140): three
  conv5-relu-maxpool stages as SpatialConvolution over the
  (1, seq, embed) plane, then a linear head.  Its pools run the strided
  ``maxpool2d`` kernels.
- ``TextClassifierBiLSTM``: a bidirectional LSTM (``BiRecurrent`` of two
  ``LSTMCell``s, both directions in one call of the ``bilstm_recurrence``
  kernels) with mean-over-time pooling and a linear head: 364,616
  parameters at (20, 200, 128).

Both take pre-embedded input (batch, seq_len, embed_dim), as
``dataset.news20.embed_samples`` makes it, and keep the JAX model's
layers one for one, so ``nn.module.load_jax_params`` takes the JAX
model's ``params()`` tree.  Weights are drawn on the CPU from
``generator`` and placed on ``device``: the card unless the caller asks
for the CPU.
"""
from __future__ import annotations

import bigdl_tpu_torch.nn as nn
from bigdl_tpu_torch.utils.device import resolve_device


def TextClassifierConv(class_num: int, seq_len: int = 200,
                       embed_dim: int = 50, device="cuda", generator=None):
    """(ref TextClassifier.buildModel :119-140).  The last pool consumes
    whatever extent remains (the reference hardcodes 35 for its 1000-token
    sequences), so any seq_len that survives the first two stages
    (>= 149) works."""
    h1 = seq_len - 4          # conv kh=5
    h2 = (h1 - 5) // 5 + 1    # pool 5/5
    h3 = h2 - 4               # conv kh=5
    h4 = (h3 - 5) // 5 + 1    # pool 5/5
    h5 = h4 - 4               # conv kh=5
    if h5 < 1:
        raise ValueError(f"seqLength {seq_len} too short for 3 conv stages")
    kw = dict(device=resolve_device(device), generator=generator)
    return nn.Sequential(
        nn.Reshape([1, seq_len, embed_dim]),
        nn.SpatialConvolution(1, 128, embed_dim, 5, **kw),  # kw=embed, kh=5
        nn.ReLU(),
        nn.SpatialMaxPooling(1, 5, 1, 5),
        nn.SpatialConvolution(128, 128, 1, 5, **kw),
        nn.ReLU(),
        nn.SpatialMaxPooling(1, 5, 1, 5),
        nn.SpatialConvolution(128, 128, 1, 5, **kw),
        nn.ReLU(),
        nn.SpatialMaxPooling(1, h5, 1, h5),                 # ref: 35 @ 1000
        nn.Reshape([128]),
        nn.Linear(128, 100, **kw),
        nn.ReLU(),
        nn.Linear(100, class_num, **kw),
        nn.LogSoftMax(),
    )


def TextClassifierBiLSTM(class_num: int, embed_dim: int = 50,
                         hidden_size: int = 128, device="cuda",
                         generator=None):
    """(B, T, E) -> BiRecurrent(LSTM fwd, LSTM bwd) -> (B, T, 2H) -> mean
    over time -> Linear(2H, 100) -> ReLU -> Linear -> LogSoftMax; any
    sequence length."""
    kw = dict(device=resolve_device(device), generator=generator)
    return nn.Sequential(
        nn.BiRecurrent(nn.LSTMCell(embed_dim, hidden_size, **kw),
                       nn.LSTMCell(embed_dim, hidden_size, **kw)),
        nn.Mean(1, n_input_dims=2),   # time: dim 1 of an unbatched (T, 2H)
        nn.Linear(2 * hidden_size, 100, **kw),
        nn.ReLU(),
        nn.Linear(100, class_num, **kw),
        nn.LogSoftMax(),
    )
