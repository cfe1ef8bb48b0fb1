#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``bigdl_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py            # the smoke, a few minutes
    python3 chip_smoke.py --profile  # plus torch.profiler breakdowns
    python3 chip_smoke.py --kernels  # phases 1-2 alone, no result line
    python3 chip_smoke.py --harness  # fused_sgd's checks and phase 10
                                     # alone, no result line
    python3 chip_smoke.py --harness-api  # fused_sgd's checks (its scaled
                                         # form) and phase 10b alone,
                                         # no result line
    python3 chip_smoke.py --bn       # the pool, LRN and SGD checks and
                                     # phases 11-14 alone, no result line
    python3 chip_smoke.py --inventory  # fused_sgd's checks and phase 15
                                       # alone, no result line
    python3 chip_smoke.py --distri   # fused_sgd's checks and phase 16
                                     # alone, no result line
    python3 chip_smoke.py --serve    # the attention kernels (the verify
                                     # window among them) and phase 3
                                     # alone, no result line
    python3 chip_smoke.py --serve-cards  # the serving path and phase 3's
                                         # four-card decoder alone
    python3 chip_smoke.py --attention  # the attention and SGD kernels'
                                       # checks and phase 17 alone, no
                                       # result line
    python3 chip_smoke.py --parallel   # the SGD, pool and LRN checks
                                       # and phases 18-19, no result line
    python3 chip_smoke.py --parallel-cards  # phase 19 alone (four cards)
    python3 chip_smoke.py --parallel-vs-cpu  # VGG's pipeline against the
                                             # CPU at microbatches of 2
                                             # and 4, a reading
    python3 chip_smoke.py --bf16     # the bf16 forms' checks and phase 20
                                     # alone, no result line
    python3 chip_smoke.py --obs      # phase 21 alone, no result line
    python3 chip_smoke.py --imagenet # the SGD and pool checks and phase
                                     # 12b alone, no result line

Each option runs part of one phase table (``ONLY``); every phase runs
even where one before it failed, and a failed phase makes the exit
non-zero with no result line.  The run with no arguments takes each
reading's repeats about once (``READ``: the plain versions' and library
calls' times, profiled windows, timed dispatches; no check or gate
reads them), and runs phase 3 right after the attention kernels, while
the recurrences' libraries still compile.  Phases:

1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions, and the build of every CUDA kernel from
   ``bigdl_tpu_torch/csrc`` (one nvcc per source, all at once);
2. every kernel against its plain PyTorch version on the card, with
   times (CUDA events, L2 flushed before each launch): paged attention
   at the decode step's full-width shape and at ragged page layouts;
   the max pool's forward, argmax and backward on tied inputs at nine
   geometries (LeNet's two pools and Inception-v1's first among them)
   and at Inception-v1's four 3x3 s2 pools at batch 128, and on inputs
   with NaNs at three, timed at each of Inception's pools of either pool
   kernel (the step's sums beside the rows); fused SGD on six hyper
   sets, timed at LeNet's and at the serving model's parameter counts,
   and its scaled form (per-parameter rates) on the same sets at odd
   leaves and Inception-v1's layout (all-ones rates the unscaled bits),
   timed beside it; and its taps form (the four sums of
   ``obs/taps.py`` as it updates) on the same sets, unscaled and scaled,
   at odd leaves and the serving model's layout: p' and v' the bits of
   the form without taps, the sums within 1e-5 of the plain version's,
   a non-finite step's NaN and inf counted and nothing written; timed
   beside the form without taps in turns;
   the LRN
   (forward with and without z, backward) at six shapes, Inception-v1's
   two among them; the stride-1 pool on tied inputs at ten geometries
   (Inception-v1's among them) and with NaNs at three; the int8 variant
   of paged attention at the decode step's full width, an S = 4 window
   and small pages taking each of its copy paths, with the two-call
   reference (dequantize, then SDPA) beside it; both pools' split walks
   at the plan's split count and at 1, 3 and 64 splits (empty splits and
   a row with pos < 0 among them) against the plain split-and-merge
   version, and timed at serving's own context; ``lstm_scan`` from
   non-zero states at (T 500, B 128, H 128), a ragged shape, shapes whose
   cluster plans take 1, 2, 4, 8 and 16 blocks, and its largest H, beside
   cuDNN's no-grad ``nn.LSTM`` layer, and from zero state the same bits
   as ``bilstm_forward`` at D = 1;
3. serving: a full-width ``TransformerLM`` (vocab 4000, d_model 1024,
   4 heads, 6 layers, hidden 4096, random weights from seed 0) serves 16
   requests through ``ContinuousDecoder``; the kernels' launch counts
   show the path went through them, and every generated token is held
   against the plain full-sequence forward by teacher forcing; then
   ``lm_decode`` extends the longest seed on the same weights and is held
   against the decoder's row for it; then the same requests with
   ``kv_quant="int8"``: every attention launch is the int8 kernel's,
   every token is held by teacher forcing against the plain int8 window
   forward, and the pools' bytes and the share of tokens equal to the
   fp32 stream are printed; then serving's request features on the same
   model, each path read from zeroed launch counts: (a, with phase 2)
   both page walks on the speculative verify window (S = 5 at the 64-page
   tables, a head page every row shares) against their plain versions,
   timed beside SDPA (or dequantize + SDPA) and the bound; (b) two waves
   of 16 requests sharing a 256-token system prompt through the prefix
   cache, the second all hits in fewer steps, every token teacher-forced;
   (c) speculative decode (k = 4 drafts from 3 blocks), fp32 and int8,
   ``paged_attention`` launched steps x (4 x 3 + 6) times, beside the
   plain greedy decoder; (d) a mixed batch of greedy, sampled
   (temperature 0.8, top-k 50, top-p 0.9) and stop-sequence requests: the
   greedy rows equal a greedy-only run's, a sampled request replays in
   another slot, a stop request ends just past its match; 20,000 draws
   of ``sample_tokens`` from one filtered row against its probabilities
   (chi-squared); (e) the 16 requests streamed, the chunks equal to the
   rows, time to first token and inter-token latency printed beside the
   card's name and power limit; (f) sampled ``lm_decode`` twice under one
   key, ``lm_beam_search(beam_size=1)`` equal to greedy ``lm_decode``;
   (g) tensor parallelism: ``ContinuousDecoder(mesh=hybrid_mesh(1, 2))``
   as two gloo ranks on the one card, each the model's shard (two of
   the four heads, half of each FFN) and its own pools of two heads,
   serving the four shortest requests greedy with fp32 pools and with
   int8 pools and speculative decode (k = 2): every rank's rows
   identical, each rank's launches the path's and no other kernel,
   every token teacher-forced against the whole model, each rank's
   pools half the whole's bytes; (h) the same over four NCCL cards
   where the machine has them (a line says why not otherwise), ms a
   step beside one card's and the NCCL kernels' share; with phase 2,
   both page walks at a rank's heads (H = 2 and 1, serving's context)
   against their plain versions;
4. training: ``LeNet5`` (seed 0) trains two epochs of synthetic MNIST
   through ``Optimizer(...).optimize()`` with its default ``SGD``,
   validating Top1 every epoch; the launch counts show every step went
   through the SGD kernel and every pool through the pool kernels, and
   the same run on the CPU (plain versions) from the same parameters and
   batch order gives the same losses and final parameters;
5. Inception-v1 (examples/train_inception.py --synthetic: 6,998,552
   parameters, batch 128 of random 224 crops and flips of 512 synthetic
   256x256 images, SGD with weight decay, momentum 0.9, dampening 0 and
   Poly(0.5)) trains 20 steps through ``Optimizer(...).optimize()`` and
   validates Top1/Top5 once; the launch counts show every LRN, pool and
   update went through its kernel, and three steps at batch 16, dropout
   off, equal the same steps on the CPU;
6. the Bi-LSTM text classifier (examples/text_classifier.py --model
   lstm at BASELINE config 4: 364,616 parameters, embed 200, hidden 128,
   batch 128 of 500-token synthetic documents, lr 0.01, momentum 0.9)
   trains two epochs (16 steps, Top1 every epoch); the launch counts show
   every recurrence went through the ``bilstm`` kernels, forward,
   backward and weight gradient, and three steps at batch 16 equal the
   same steps on the CPU.  Its kernels are checked before the paths,
   with phase 2: at the JAX tests' shapes, a ragged H, H = 558, 600 and
   1,200, T = 1, the full width, shapes whose cluster plans take 4, 8 and
   16 blocks and the largest H, each case's cluster plans printed,
   against the plain versions (or, where the 500-step chain leaves the
   tolerance, against twice the plain version's own error from float64),
   with the weight gradient timed beside one ``torch.einsum`` and the
   whole layer beside cuDNN's ``torch.nn.LSTM``; one H past the limit is
   refused before a launch; then the classifier with one LSTM direction
   (183,368 parameters) trains one epoch through the ``bilstm`` kernels
   at D = 1 and validates through ``lstm_scan``, and three steps at
   batch 16 equal the CPU's;
7. SimpleRNN (examples/train_rnn.py's defaults: 4,001 words in and out,
   hidden 40, batch 4, seqLength 8, bptt 4, lr 0.1, 1,024 synthetic
   sentences) trains two epochs, every step two chunks of the ``rnn``
   kernels; then 8 steps at bptt 8 (one call a step); then ``generate``
   samples 20 words, each a forward through the kernel, equal to the
   CPU's from the same parameters and ``RandomState``; three steps equal
   the CPU's.  The ``rnn`` and ``gru`` kernels are checked with phase 2
   as the ``bilstm`` ones are, h0, each kernel's largest H and shapes
   whose cluster plans take 1, 2, 4, 8 and 16 blocks included,
   cuDNN's ``nn.RNN`` timed beside the port's layer and ``nn.GRU`` as a
   same-size reference (another function);
8. the Bi-LSTM classifier's composition with GRU cells trains one epoch
   at full width through the ``gru`` kernels (both directions in one
   call); three steps at batch 16 equal the CPU's;
9. the rest of the recurrence: its kernels are checked with phase 2 --
   the LSTM's forward, backward and weight gradient from a given h0, c0
   and the GRU's three from h0, at the truncated classifiers' chunk
   (35, 1, 128, 128), their ragged last chunk, both directions at an odd
   batch and SimpleRNN's chunk, and the rnn's three under each of the
   twenty element-wise kinds at (500, 1, 128, 128) and SimpleRNN's (4, 1,
   4, 40), step by step against the plain activation and derivative,
   each timed beside from zeros and tanh; then (a) the LSTM classifier
   truncated every 35 steps (the unroll of Zaremba et al. 2014; 15
   chunks over T 500, the last ragged) trains 8 steps, exactly 15 of
   each ``bilstm`` kernel a step, validating through ``lstm_scan``; (b)
   the GRU classifier truncated likewise, 30 of each ``gru`` kernel a
   step (two directions apart); (c) SimpleRNN's composition with
   Sigmoid and with ReLU cells at examples/train_rnn.py's defaults, two
   epochs, the ``rnn`` kernels on every chunk; each held to three steps
   on the CPU and beside the untruncated run's ms a step and tokens/s,
   the step route never taken; (d) an RnnCell under SoftMax and an
   LSTMCell subclass take the step route with no recurrence launch;
10. the training harness's host side: LeNet-5 and SimpleRNN (the
    examples' full width) take 8 steps a dispatch as one CUDA graph,
    held to the eager 8-step loop on the card (bits under the
    deterministic algorithms, else rtol 1e-5 / atol 1e-6) and to the CPU,
    the wrappers counting the capture's launches and the profiler the
    kernels each run's replays ran (by name: every step through its
    kernels), ms a step, device ms a step and idle share beside one step
    a dispatch; a
    classifier with dropout in the graph ends with its mask generator
    where the eager loop's ends, and its Top1 rises on a learnable
    synthetic set; Inception-v1 and the Bi-LSTM at full width take the
    same steps with the background prefetch on and off, bit-equal
    losses, the host share, ms a step and idle share of each, then
    Inception-v1 with the prefetch on at 8 steps a dispatch as one CUDA
    graph (the replays' kernels counted by the profiler); LeNet-5 with
    momentum on distinct digits, cropped and flipped at random, resumes on
    the card from a checkpoint past corrupt snapshots and ends where the
    uninterrupted run does, and without the random payload does not, the
    checkpoint's wall cost printed;
10b. the rest of the harness's API (``harness_api``): Inception-v1
    fine-tuned at full width through ``Optimizer(...).optimize()`` with
    ``learningRates`` 0 on every leaf but the classifier's (one
    ``fused_sgd_scaled`` launch a step, the frozen leaves bit-equal, two
    steps at batch 16 against the CPU); the Bi-LSTM classifier with
    ``Adagrad`` at BASELINE config 4, 8 steps at 4 a dispatch eager and
    as one CUDA graph (equal; the step counter on the card), three
    steps at batch 16 against the CPU (the parameters as a whole);
    LeNet-5's full-batch ``LBFGS().optimize(feval, x)`` over 1,024
    synthetic images (the loss falls; the first losses the CPU's); the
    ``Validator`` (Top1, Top5, Loss) over Inception-v1 against the CPU,
    ``predict`` against the eval forward and ``backward`` against
    autograd; the serving step with each module's ``forward_time`` on
    and off, in turns;
11. VGG on CIFAR-10 (``VggForCifar10``: 14,991,946 parameters, 9,472
    running-statistic values; examples/train_vgg.py on its synthetic
    data, batch 128, lr 0.01, momentum 0.9, weight decay 5e-4) trains 20
    steps through ``Optimizer(...).optimize()`` and validates Top1 once;
    every step's and validation batch's five pools go through the
    ``maxpool2d`` kernels and every update through ``fused_sgd``; two
    steps at batch 16, dropout off, equal the CPU's, losses, parameters
    and running statistics, the CPU's steps taking the card's ReLU and
    pool choices and the first batch's gradients held against float64
    runs that take each fp32 run's own (``Routes``);
12. ResNet-50 (25,557,032 parameters, 53 BN layers;
    examples/train_resnet50_imagenet.py --synthetic: batch 256 of 512
    224x224 images, nesterov SGD, EpochStep(30, 0.1)) trains 10 steps,
    the stem pool through ``maxpool2d`` and the update through
    ``fused_sgd``; two steps at batch 8 and lr 0.01 equal the CPU's, held
    as VGG's are (the gradient probe's zeroed BN weights drawn U(0, 1));
    the buffer snapshot's time a step;
12b. ImageNet-style input (config 5; ``--imagenet`` runs it alone with
    the SGD and pool checks): 768 smooth seeded PNGs of 224-320 px a side
    in 16 class folders, written by this script's own PNG writer (zlib
    and struct, the rows under the five filter types in turn: it needs
    no Pillow), packed into 4 shards by
    ``imagenet_tools.generate``; ResNet-50 trains one epoch (3 steps of
    256) through ``Optimizer(...)`` over ``ShardFolder(distributed=True)``
    and examples/train_resnet50_imagenet.py's chain (the port's PNG
    decode, resize to 256, random crop, flip, colour jitter, lighting,
    normalisation): the ``DistriOptimizer`` at a world of one,
    ``fused_sgd`` and the stem pool's ``maxpool2d`` once a step, two
    steps at batch 8 equal the CPU's; then a ``.caffemodel`` of a seeded
    Inception-v1's named layers (this script's protobuf writer) loads
    into a card model by ``CaffeLoader.load`` (every copied blob bit for
    bit), examples/model_validator.py's chain validates it over 128 of
    the PNGs (Top1, Top5; the LRN and both pools' launches counted), its
    logits equal the CPU's on 8, and ``TorchFile`` round-trips it bit
    for bit; then 256 of the images go through a SequenceFile
    (``BGRImgToLocalSeqFile``, ``DataSet.seq_file_folder``,
    ``SeqBytesToBGRImg``) bit for bit, and ``MTLabeledImgToBatch`` reads
    them at 1 and 8 threads (the same batches; images a second);
13. the harness with module state: ``ResNetCifar(20)`` (batch 128,
    examples/train_resnet.py's SGD) at 8 steps a dispatch as one CUDA
    graph bit-equal to the eager loop in parameters, velocities and
    running statistics, the replays' kernels counted by the profiler;
    a snapshot mid-run resumes on the card and ends where the
    uninterrupted run does, bit for bit;
14. the model zoo: one training forward and backward at full width of
    ``Inception_v2`` (batch 8), ``Vgg_16`` (4), ``AlexNet`` (8) and
    ``Autoencoder`` (32) against the CPU, and again with cuDNN off, the
    pools and LRNs through their kernels; with phases 2 and 3, the
    kernels at every pool and LRN geometry the BN paths meet (VGG's five
    2x2 s2 pools at batch 128, ResNet-50's 3x3 s2 p1 stem pool at 256,
    the zoo's) and ``fused_sgd`` over VGG's and ResNet-50's layouts,
    held to their plain versions and timed beside ``F.max_pool2d``;
15. the inventory: (a) examples/train_autoencoder.py at its width
    (``Autoencoder(32)``, ``MSECriterion``, records that
    ``FuncTransformer`` makes of 2,048 synthetic digits, batch 150, lr
    0.01, momentum 0.9) trains two epochs through ``LocalOptimizer``,
    one ``fused_sgd`` launch a step and the loss over the training set
    falling, then a warm epoch timed and profiled (ms a step, idle
    share); three steps equal the CPU's; 8 steps a dispatch as one CUDA
    graph equal the eager loop and the CPU (``dispatch_runs``, the
    replays' kernels counted by the profiler); (b) one forward and
    backward of every class this slice adds (containers, criteria,
    linear-algebra layers, table, shape and reduction ops, L1Penalty,
    the convolution family with DCGAN's, a DeepLab-v2 ASPP branch's and
    a connection table's shapes, the local normalisations, RoiPooling at
    Fast R-CNN's VGG-16 conv5_3) against the same module on the CPU,
    each class's largest error and the card's peak memory on a line,
    and NMS over 6,000 proposals; none launches a kernel of the port;
16. the data-parallel slice: Inception-v1 as examples/train_inception.py
    --synthetic builds it, ``Optimizer(...)`` on its sharded dataset
    giving a ``DistriOptimizer`` over ``torch.cuda.device_count()`` NCCL
    ranks (one a card: in this process with one card, spawned ranks with
    more), 20 steps each plain, ``zero1`` and bf16 at batch 128 a rank,
    every step through the pool, LRN and SGD kernels; with one card,
    plain and ``zero1`` equal LocalOptimizer bit for bit (deterministic
    algorithms, dropout 0), bf16's reduced gradient is LocalOptimizer's
    rounded to bf16 bit for bit and three steps stay within 2e-2 /
    2e-3 of it; with more cards, the plain run's three steps equal
    LocalOptimizer's on the same global batches; ms a step beside
    LocalOptimizer's, the NCCL kernels' device time a step, the idle
    share and the peak memory of each mode; then LeNet-5 as
    examples/train_lenet.py --distributed, two epochs, equal to the
    LocalOptimizer run;
17. the attention family's training: the ring attention's per-hop step
    in one process over 4 blocks of (16, 512, 4, 256), causal and not,
    against full attention and autograd; the flagship classifier
    (examples/train_transformer.py at bench.py's width:
    ``TransformerClassifier(20, 1024, 4 heads, 6 layers, hidden 4096)``,
    75,599,892 parameters, batch 16 x T 512 of synthetic embedded
    documents, SGD lr 0.01, Top1 every epoch) 20 steps through
    ``Optimizer(...).optimize()``, every update through ``fused_sgd``,
    its ms a step, tokens/s, device time and idle share, peak memory and
    bound printed; the MoE classifier (8 experts, 428,185,620
    parameters) 6 steps, its dropped share printed; the LM at the serving
    width (batch 16 x T 128 on the built-in corpus) 8 steps through
    ``LocalOptimizer``, then ``lm_decode`` from its weights through
    ``paged_attention``; each path held to the CPU at depth 1; the
    sequence- and expert-parallel ``DistriOptimizer`` at a world of one
    bit-equal to LocalOptimizer; with four cards, both across them
    against LocalOptimizer (``--attention-cards`` runs that alone);
18. tensor and pipeline parallelism on one card, a world of one: VGG on
    CIFAR-10 at full width (vgg_run's data and SGD, batch 128 as 8
    microbatches of 16) through ``DistriOptimizer(pipeline_stages=1)``
    under 1F1B and GPipe, 20 steps each (``fused_sgd`` 20,
    ``maxpool2d_forward`` = ``maxpool2d_backward`` = 800), ms a step,
    images/s, device busy, idle share and peak memory; three steps of
    each, and of GPipe under gradient checkpointing (twice the
    forward's launches), held to the serial program (the stage run
    microbatch by microbatch on the card, backpropagated in the
    schedule's order) with one validation; three steps at batch 16 as 4
    microbatches held to the CPU; the flagship classifier through
    ``tensor_parallel=True`` on ``{"data": 1, "model": 1}`` at depth 2
    bit-equal to LocalOptimizer;
19. with four cards (``--parallel-cards``): VGG in four stages under
    1F1B and GPipe and at ``{"data": 2, "pipe": 2}``, each held to the
    serial program on this card; __graft_entry__.py's deterministic MLP,
    hybrid dp x pp equal to plain DP; the classifier at ``{"data": 2,
    "model": 2}`` with and without ``zero1`` and as plain DP at
    ``{"data": 4}``, each held to LocalOptimizer on this card; ms a step
    beside one card's, the schedule's bubble (idle ticks over ticks),
    each rank's peak memory, the NCCL kernels' device time by name and
    the leaves that ran gathered; with fewer cards a line says so;
20. the dtype policy (``--bf16`` runs it alone, with its kernel phase):
    the bf16 forms of the any-stride pool (LeNet-5's, VGG's, Inception's
    and ResNet-50's s2 pools), the stride-1 pool and LRN (Inception's)
    and the LSTM recurrence (the Bi-LSTM's width, zx bf16 and f32, and
    ``lstm_scan``) against their plain versions, timed beside their
    bounds and the library's bf16 calls (cuDNN's bf16 ``nn.LSTM`` as the
    layer's yardstick); then bench.py's six configurations at full width
    and batch under FP32 and BF16_COMPUTE, bench.py's steps a dispatch
    through the CUDA-graph route: ms a step, records a second, device
    busy, idle share and peak memory each way, the bf16 forms' launches,
    the first loss against FP32's and a small-batch run against the CPU
    under the same policy; and ``Recurrent(LSTMCell)`` under it through
    the bf16-weight forms and ``lstm_scan``'s;
21. the observability plane (``--obs`` runs it alone): LeNet-5 through
    ``Optimizer`` with events to a directory, a ``TrainSummary`` and the
    taps read every 2 steps, and with obs off, in turns (the losses bit
    for bit, every event valid, ``fused_sgd_taps`` once a step, the same
    device-to-host syncs under ``torch.cuda.set_sync_debug_mode`` on and
    off, ``train_mfu`` in (0, 1]), a profiled run whose trace holds the
    phase spans as ``record_function`` ranges, then the serving model's
    16 requests with every request traced and every other streamed, and
    with obs off (the hops, one TTFT a streamed request and one ITL a
    later token, the flight recorder's rows the served ones,
    ``decode_model_flops_util`` in (0, 1], the same rows); ms a step of
    both paths on and off;
22. one JSON line of kernels, then the card line, then the result line.

Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import shutil
import statistics
import struct
import subprocess
import sys
import time
import types
import zlib

import numpy as np

RTOL, ATOL = 1e-4, 1e-5          # fp32, summation order differs
HBM_BYTES_PER_S = 3.35e12         # H100 SXM data sheet
FP32_FLOPS = 67e12                # H100 SXM data sheet, non-tensor fp32
VOCAB, D_MODEL, HEADS, LAYERS, HIDDEN = 4000, 1024, 4, 6, 4096
SLOTS, N_POS, PAGE = 8, 1024, 16
N_REQ, N_WORDS = 16, 128
# serving's request features: a SYSTEM-token shared prompt (16 pages),
# speculative decode at SPEC_K drafts from DRAFT_LAYERS of the 6 blocks,
# the sampled requests' filters, CHI_DRAWS draws for the sampler's check
SYSTEM, SPEC_K, DRAFT_LAYERS, CHI_DRAWS = 256, 4, 3, 20000
SAMPLED = {"temperature": 0.8, "top_k": 50, "top_p": 0.9}
# training slice: examples/train_lenet.py on synthetic MNIST
N_TRAIN, N_VAL, BATCH, EPOCHS, LR, MOMENTUM = 2048, 512, 128, 2, 0.05, 0.9
LOSS_RTOL, PARAM_ATOL = 1e-3, 1e-4   # card vs CPU: cuDNN conv sums differ
POOL_TOL = dict(rtol=1e-5, atol=1e-5)   # backward: summation order
SGD_TOL = dict(rtol=1e-5, atol=1e-6)    # fused multiply-adds
# (shape, window, strides, pads): tests/test_pallas_ops.py:159-172, then
# LeNet's two pools at batch 128, then Inception-v1's first pool
# (models/inception.py:36, 3x3 s2 ceil) at batch 32
POOL_CASES = [
    ((2, 5, 13, 17), (3, 3), (2, 2), ((1, 1), (1, 1))),
    ((2, 3, 10, 12), (3, 3), (1, 1), ((1, 1), (1, 1))),
    ((1, 4, 9, 11), (2, 2), (2, 2), ((0, 1), (1, 0))),
    ((1, 2, 12, 8), (5, 3), (3, 2), ((2, 2), (1, 1))),
    ((37, 1, 13, 7), (3, 3), (2, 2), ((1, 1), (1, 1))),
    ((1, 100, 8, 8), (3, 3), (1, 1), ((0, 0), (0, 0))),
    ((BATCH, 6, 24, 24), (2, 2), (2, 2), ((0, 0), (0, 0))),
    ((BATCH, 12, 8, 8), (2, 2), (2, 2), ((0, 0), (0, 0))),
    ((32, 64, 112, 112), (3, 3), (2, 2), ((0, 1), (0, 1))),
]
NAN_POOL_CASES = (0, 2, 6)   # padded, asymmetric pads, LeNet's first pool
# Inception-v1's four 3x3 s2 ceil pools at batch 128 (models/inception.py:
# 56, 63, 66, 72), one launch each way a step
INCEPTION_POOLS = [((128, 64, 112, 112), (3, 3), (2, 2), ((0, 1), (0, 1))),
                   ((128, 192, 56, 56), (3, 3), (2, 2), ((0, 1), (0, 1))),
                   ((128, 480, 28, 28), (3, 3), (2, 2), ((0, 1), (0, 1))),
                   ((128, 832, 14, 14), (3, 3), (2, 2), ((0, 1), (0, 1)))]
# VGG on CIFAR-10's five 2x2 s2 ceil pools at batch 128 (models/vgg.py:
# 22, 25, 29, 33, 37) and ResNet-50's 3x3 s2 p1 stem pool at batch 256
# (models/resnet.py:114), one launch each way a step
VGG_POOLS = [((128, c, hw, hw), (2, 2), (2, 2), ((0, 0), (0, 0)))
             for c, hw in ((64, 32), (128, 16), (256, 8), (512, 4),
                           (512, 2))]
RESNET50_POOL = ((256, 64, 112, 112), (3, 3), (2, 2), ((1, 0), (1, 0)))
# model_zoo's s2 pools at its batches: Inception_v2's four 3x3 s2 ceil
# (models/inception.py:139, 142 and 3c's and 4e's branch pools) at batch
# 8, Vgg_16's five 2x2 s2 at batch 4, AlexNet's three 3x3 s2 at batch 8
ZOO_POOLS = ([((8, c, hw, hw), (3, 3), (2, 2), ((0, 1), (0, 1)))
              for c, hw in ((64, 112), (192, 56), (320, 28), (576, 14))]
             + [((4, c, hw, hw), (2, 2), (2, 2), ((0, 0), (0, 0)))
                for c, hw in ((64, 224), (128, 112), (256, 56), (512, 28),
                              (512, 14))]
             + [((8, c, hw, hw), (3, 3), (2, 2), ((0, 0), (0, 0)))
                for c, hw in ((96, 55), (256, 27), (256, 13))])
BN_POOLS = VGG_POOLS + [RESNET50_POOL] + ZOO_POOLS
# VGG in pipeline stages: the batch of 128 as PMICRO microbatches of 16,
# each through the five pools (PIPE_POOLS, timed), and each replica's 8
# rows of a microbatch on {"data": 2, "pipe": 2} (PIPE_DP_POOLS)
PMICRO = 8
PIPE_POOLS, PIPE_DP_POOLS = ([((128 // PMICRO // d, c, hw, hw), w, st, pads)
                              for (_, c, hw, _), w, st, pads in VGG_POOLS]
                             for d in (1, 2))
# Inception-v1 training slice: examples/train_inception.py --synthetic
IBATCH, ICLASSES, IMAGES, ISIZE, ICROP = 128, 1000, 4 * 128, 256, 224
ILR, IWD, ISTEPS, IVAL = 0.0898, 1e-4, 20, 256
ICHECK_BATCH, ICHECK_STEPS = 16, 3
# Inception card vs CPU.  conv1's weight gradient sums 16 x 112 x 112
# products of pixels of +-128 that mostly cancel: each fp32 run lands
# ~2e-3 of the leaf's scale from the float64 value (the card 2.53e-3,
# the CPU 2.17e-3 in the run that set these), so the card is held to
# twice the CPU's own fp32 error against float64 (``held_vs_cpu``), not
# to the CPU; three steps at lr 0.0898 carry that into conv1's weights
# (4.6e-4 apart).
IPARAM_ATOL = 1e-3
IPARAMS = 6998552
LRN = (5, 1e-4, 0.75, 1.0)            # models/inception.py:37,42
LRN_FWD_TOL = dict(rtol=1e-5, atol=1e-6)   # tests/test_pallas_ops.py:148
LRN_BWD_TOL = dict(rtol=1e-4, atol=1e-5)   # tests/test_pallas_ops.py:155
# (shape, (size, alpha, beta, k)): tests/test_pallas_ops.py:116-121 (an
# even size, ragged H*W), then Inception-v1's two LRNs at batch 128, then
# AlexNet's two (models/alexnet.py:21, 26: the same hyper-parameters) at
# model_zoo's batch 8
INCEPTION_LRNS = [((IBATCH, 64, 56, 56), LRN), ((IBATCH, 192, 56, 56), LRN)]
ALEXNET_LRNS = [((8, 96, 55, 55), LRN), ((8, 256, 27, 27), LRN)]
LRN_CASES = [
    ((2, 8, 16, 8), (5, 1.0, 0.75, 1.0)),
    ((2, 6, 16, 16), (3, 2e-4, 0.9, 2.0)),
    ((2, 8, 7, 9), (5, 1.0, 0.75, 1.0)),
    ((2, 8, 16, 8), (4, 1.0, 0.75, 1.0)),
] + INCEPTION_LRNS + ALEXNET_LRNS
# (shape, window, pads), stride 1: tests/test_pallas_ops.py:80-84, then
# Inception-v1's 3a, 3b, 4a and 5a pools at batch 128, a plane cut into
# row bands, a window whose backward bands need more than two blocks an SM
# of shared memory, and a window no band holds (the unstaged kernels);
# then 7x7 planes whose groups of 73 start off 16-byte boundaries (NC 150:
# two misaligned starts, a tail group of 4), a plane too large for a block
# (360 KB) cut into 8-row bands with W not a multiple of 4, and a 5x5
# window with pads 2 on 14x14 planes (the runtime-window kernels); then
# Inception_v2's 5b pool (models/inception.py:120, 3x3 s1 p1 ceil) at
# model_zoo's batch 8
INCEPTION_V2_S1 = ((8, 1024, 7, 7), (3, 3), ((1, 1), (1, 1)))
S1_CASES = [
    ((2, 4, 14, 14), (3, 3), ((1, 1), (1, 1))),
    ((1, 2, 8, 8), (3, 3), ((1, 1), (1, 1))),
    ((2, 3, 10, 12), (2, 2), ((0, 1), (1, 0))),
    ((IBATCH, 192, 28, 28), (3, 3), ((1, 1), (1, 1))),
    ((IBATCH, 256, 28, 28), (3, 3), ((1, 1), (1, 1))),
    ((IBATCH, 480, 14, 14), (3, 3), ((1, 1), (1, 1))),
    ((IBATCH, 832, 7, 7), (3, 3), ((1, 1), (1, 1))),
    ((2, 3, 112, 112), (3, 3), ((1, 1), (1, 1))),
    ((1, 2, 100, 100), (40, 40), ((0, 0), (0, 0))),
    ((1, 1, 243, 243), (242, 242), ((0, 0), (0, 0))),
    ((3, 50, 7, 7), (3, 3), ((1, 1), (1, 1))),
    ((1, 2, 301, 299), (3, 3), ((1, 1), (1, 1))),
    ((4, 37, 14, 14), (5, 5), ((2, 2), (2, 2))),
    INCEPTION_V2_S1,
]
NAN_S1_CASES = (0, 2, 7, 10)
# Inception-v1's nine stride-1 pools at batch 128, by input: 3a, 3b, 4a,
# 4b-4d (three), 4e, 5a-5b (two), one launch each way a step
INCEPTION_S1_POOLS = [((IBATCH, c, hw, hw), (3, 3), ((1, 1), (1, 1)), n)
                      for c, hw, n in ((192, 28, 1), (256, 28, 1),
                                       (480, 14, 1), (512, 14, 3),
                                       (528, 14, 1), (832, 7, 2))]
# Bi-LSTM text classifier: examples/text_classifier.py --model lstm at
# BASELINE config 4 (bench.py:317-323): 20 classes, embed 200, hidden 128,
# batch 128, T 500; 1,280 synthetic documents (80/20 split: 8 steps and 2
# validation batches an epoch), 2 epochs, lr 0.01, momentum 0.9
TCLASSES, TEMBED, THIDDEN, TSEQ, TBATCH = 20, 200, 128, 500, 128
TDOCS, TEPOCHS, TLR, TPARAMS = 1280, 2, 0.01, 364616
TCHECK_BATCH, TCHECK_STEPS = 16, 3
GPARAMS = 280392   # the classifier's composition with GRU cells
LPARAMS = 183368   # ... and with one LSTM direction
BILSTM_FWD_TOL = dict(rtol=1e-5, atol=1e-6)   # tests/test_recurrent.py:189
BILSTM_BWD_TOL = dict(rtol=1e-4, atol=1e-5)   # tests/test_recurrent.py:193
# where the 500-step chain or the 64,000-term weight-gradient sum leaves
# those tolerances, the card is held to twice the plain fp32 version's own
# error against a float64 plain run on the same inputs
BILSTM_VS_64 = 2.0
# (T, D, B, H): tests/test_recurrent.py:129,211 and
# tests/test_pallas_ops.py:240, a ragged H, the largest H of the former
# 8-row blocks (558), then H = 600 and 1,200 (wht through L2 in 16-block
# clusters), T = 1, the classifier's full width in both directions and in
# one, an odd batch at H that the plans' clusters of 4, 8 and 16 blocks
# split raggedly (the forward's weight in shared memory, the backward's
# at 16 through L2), then the largest H (ops.bilstm.MAX_HIDDEN, filled in
# at run time)
BILSTM_CASES = [(7, 2, 3, 5), (9, 1, 4, 5), (13, 2, 37, 4),
                (13, 2, 37, 100), (3, 2, 9, 558), (3, 2, 9, 600),
                (3, 2, 9, 1200), (1, 2, 3, 5), (1, 2, 128, 128),
                (TSEQ, 2, TBATCH, THIDDEN), (TSEQ, 1, TBATCH, THIDDEN),
                (7, 2, 37, 203), (7, 2, 37, 250), (7, 2, 37, 330),
                (2, 1, 3, None)]
# SimpleRNN training slice: examples/train_rnn.py's defaults (vocabSize
# 4000, so 4,001 inputs and outputs with the OOV bucket; hiddenSize 40,
# batchSize 4, seqLength 8, bptt 4, learningRate 0.1), 2 of its 5 epochs
RVOCAB, RHIDDEN, RBATCH, RSEQ, RBPTT, RLR, REPOCHS = 4000, 40, 4, 8, 4, 0.1, 2
RSENTENCES, RCHECK_STEPS, RWORDS = 1024, 3, 20
# (T, D, B, H, h0 given): tests/test_pallas_ops.py:283, tests/
# test_recurrent.py's Recurrent(RnnCell(6, 5)) over (4, 9, 6), a ragged H
# from h0, T = 1, SimpleRNN's chunk and whole sequence, the largest H
# (ops.rnn.MAX_HIDDEN, filled in at run time), then (500, D, 128, 128);
# then both directions from h0 at an odd batch and an H that the plan's
# clusters of 2, 4, 8 and 16 blocks split raggedly (the weight slice in
# shared memory), and at H = 1,001 (16 blocks, through L2)
RNN_CASES = [(9, 2, 3, 6, False), (9, 2, 3, 6, True), (9, 1, 4, 5, False),
             (13, 2, 37, 100, True), (1, 2, 3, 5, True),
             (RBPTT, 1, RBATCH, RHIDDEN, True),
             (RSEQ, 1, RBATCH, RHIDDEN, False), (2, 1, 3, None, True),
             (TSEQ, 2, TBATCH, THIDDEN, False),
             (TSEQ, 1, TBATCH, THIDDEN, False),
             (7, 2, 37, 301, True), (7, 2, 37, 331, True),
             (7, 2, 37, 471, True), (7, 2, 37, 669, True),
             (5, 2, 37, 1001, True)]
# (T, B, H): the classifier's validation width, a ragged shape, an odd
# batch at an H that the plan's clusters of 2, 4, 8 and 16 blocks split
# raggedly, H = 1,001 (16 blocks, wht through L2), the largest H
# (ops.lstm_scan.MAX_HIDDEN, filled in at run time)
SCAN_CASES = [(TSEQ, TBATCH, THIDDEN), (13, 37, 100), (7, 37, 151),
              (7, 37, 203), (7, 37, 301), (7, 37, 403), (5, 37, 1001),
              (3, 9, None)]
# the cluster sizes csrc/recurrence_cluster.cuh's plan picks from; the
# rnn and lstm_scan cases run every one, and both weight placements
CLUSTER_SIZES = (1, 2, 4, 8, 16)
# (T, D, B, H): tests/test_pallas_ops.py:260, tests/test_recurrent.py's
# GRUCell(6, 5) over (4, 9, 6), a ragged H, T = 1, the largest H
# (ops.gru.MAX_HIDDEN, filled in at run time), then the classifier's
# width with GRU cells in both directions and in one; then an odd batch
# at H that the plans' clusters of 2, 4, 8 and 16 blocks split raggedly
# (the forward's weights in shared memory at 16, the backward's through
# L2), and H = 700 (16 blocks, both through L2)
GRU_CASES = [(13, 1, 5, 100), (9, 1, 4, 5), (7, 2, 37, 33), (1, 2, 3, 5),
             (2, 1, 3, None), (TSEQ, 2, TBATCH, THIDDEN),
             (TSEQ, 1, TBATCH, THIDDEN), (7, 2, 37, 150), (7, 2, 37, 200),
             (7, 2, 37, 301), (7, 2, 37, 400), (5, 2, 37, 700)]
# truncated BPTT: the 35-step unroll of Zaremba et al., "Recurrent Neural
# Network Regularization" (2014) on PTB; T 500 = 14 x 35 + 10, so the
# classifiers' last chunk is ragged
TBPTT, TTRUNC_STEPS = 35, 8
# (T, D, B, H) of the kernels from a carried state: the classifiers' chunk
# and their last, ragged one, both directions at an odd batch and ragged
# H, and SimpleRNN's chunk
STATE_CASES = [(TBPTT, 1, TBATCH, THIDDEN), (TSEQ % TBPTT, 1, TBATCH, THIDDEN),
               (7, 2, 37, 100), (RBPTT, 1, RBATCH, RHIDDEN)]
# every element-wise kind the rnn kernels apply, with parameters
ACT_CASES = [("tanh",), ("relu",), ("relu6",), ("tanhshrink",),
             ("sigmoid",), ("logsigmoid",), ("softplus", 2.0), ("softsign",),
             ("softshrink", 0.5), ("hardshrink", 0.5),
             ("hardtanh", -0.5, 0.5), ("threshold", 0.1, -0.2),
             ("leakyrelu", 0.01), ("elu", 1.0), ("abs",), ("sqrt",),
             ("square",), ("power", 2.0, 0.5, 0.1), ("exp",), ("log",)]
ACT_SHAPES = [(TSEQ, 1, TBATCH, THIDDEN), (RBPTT, 1, RBATCH, RHIDDEN)]
# one query a row at positions spread over serving's context: seeds of
# 16-256 tokens and 128 generated, in the widest table ContinuousDecoder
# passes that traffic, the pages its longest request reaches (24)
SERVE_POS = [[int(p)] for p in np.linspace(15, 256 + N_WORDS - 1, SLOTS)]
SERVE_PAGES = -(-(256 + N_WORDS) // PAGE)
# serving's tensor parallelism: the model axis as two gloo ranks on the
# one card (TP_ONE_CARD) and as four NCCL ranks across four cards
# (TP_CARDS), each rank's heads (the kernel rows' H), the requests of the
# serving phase each serves (its TP_REQ shortest: the longest seed's
# prefill sets a wave's steps) and the drafts of its speculative run (the
# serving features' DRAFT_LAYERS blocks; each draft costs DRAFT_LAYERS
# forwards of all-reduces through the host on the one card)
TP_ONE_CARD, TP_CARDS, TP_REQ, TP_SPEC_K = 2, 4, SLOTS // 2, 2
TP_HEADS = (HEADS // TP_ONE_CARD, HEADS // TP_CARDS)
# tests/test_pallas_ops.py:37-44
# the harness (n steps a dispatch, the prefetch, checkpoints): LeNet-5 and
# SimpleRNN take HSTEPS steps at HDISPATCH a dispatch after HDISPATCH
# warm-up steps; the learnable set (tests/test_training.py's, widened)
# trains HLEARN_EPOCHS epochs; Inception-v1 and the Bi-LSTM (HDOCS
# documents: 4 steps an epoch) take HPREFETCH_STEPS steps with the
# prefetch on and off; LeNet-5 takes a snapshot every HCKPT_EVERY of
# HCKPT_STEPS steps
HDISPATCH, HSTEPS = 8, 64
HFEATURES, HCLASSES, HLEARN, HLEARN_EPOCHS = 32, 10, 4096, 4
HPREFETCH_STEPS, HDOCS = 6, 4 * TBATCH
HCKPT_STEPS, HCKPT_EVERY = 12, 4
# VGG on CIFAR-10: examples/train_vgg.py on its synthetic data (2,048
# training and 512 validation images), batch 128, lr 0.01, momentum 0.9,
# weight decay 5e-4; VSTEPS steps and one validation
VTRAIN, VVAL, VBATCH, VLR, VWD, VSTEPS = 2048, 512, 128, 0.01, 5e-4, 20
VPARAMS, VSTATE = 14991946, 9472
# the card against the CPU: VCHECK_STEPS steps at batch VCHECK_BATCH, dropout
# 0 (at three steps a rounding's perturbation of the init ends 2.1e-4
# from the CPU's params on the CPU, past PARAM_ATOL)
VCHECK_BATCH, VCHECK_STEPS = 16, 2
# ResNet-50: examples/train_resnet50_imagenet.py --synthetic (2 x 256
# images of 224x224, batch 256, lr 0.1, weight decay 1e-4, momentum 0.9,
# dampening 0, nesterov, EpochStep(30, 0.1)); R50_STEPS steps
R50_BATCH, R50_IMAGES, R50_LR, R50_WD, R50_STEPS = 256, 512, 0.1, 1e-4, 10
R50_PARAMS = 25557032
# the card against the CPU: R50_CHECK_STEPS steps at batch R50_CHECK_BATCH
# and lr R50_CHECK_LR (at lr 0.1 a rounding's perturbation of the init
# ends 3.0e-3 from the CPU's params after three steps, past IPARAM_ATOL)
R50_CHECK_BATCH, R50_CHECK_STEPS, R50_CHECK_LR = 8, 2, 0.01
# config 5's input path: IN_IMAGES PNGs of IN_CLASSES classes, IN_SIDES
# px a side, in IN_SHARDS shards (ResNet-50 trains one epoch of them at
# R50_BATCH); the validator's IN_VAL of them in batches of IN_VAL_BATCH,
# its logits against the CPU's on IN_VAL_CPU; IN_SEQ of them through a
# SequenceFile, read IN_SEQ_BATCH at a time
IN_IMAGES, IN_CLASSES, IN_SIDES, IN_SHARDS = 768, 16, (224, 320), 4
IN_VAL, IN_VAL_BATCH, IN_VAL_CPU, IN_SEQ, IN_SEQ_BATCH = 128, 32, 8, 256, 32
IN_MEAN, IN_STD = (123.0, 117.0, 104.0), (58.4, 57.1, 57.4)
# the harness with module state: ResNetCifar(20), examples/train_resnet.py
# (batch 128; 512 synthetic images, 4 steps an epoch)
BN_DEPTH, BN_BATCH, BN_PARAMS = 20, 128, 269722
# the inventory: examples/train_autoencoder.py at its width (mnist
# .synthetic(2048), batch 150, learningRate 0.01, momentum 0.9), two
# epochs (the example's ten cut to two); three steps against the CPU
AE_IMAGES, AE_BATCH, AE_CLASSES, AE_EPOCHS = 2048, 150, 32, 2
AE_LR, AE_MOMENTUM, AE_CHECK_STEPS = 0.01, 0.9, 3
# each class this slice adds, card against CPU: where no sum's order
# differs (element-wise, gathers, copies, maxima), else RTOL / ATOL
EXACT_TOL = dict(rtol=1e-6, atol=1e-6)
SUM_TOL = dict(rtol=RTOL, atol=ATOL)
# the inventory's widths: the table, shape and reduction ops at (INV_B,
# INV_T, INV_D), the criteria at batch INV_B over INV_CLASSES classes
INV_B, INV_T, INV_D, INV_CLASSES = 128, 500, 256, 1000
# a gradient leaf this far below the model's largest float64 gradient
# entry is zero (a bias that batch normalisation cancels)
NULL_GRAD = 1e-9
# the running statistics, card against CPU: each buffer within this of
# its largest entry
STATE_RTOL = 1e-3
# batch normalisation's kernels as the profiler names them (cuDNN's
# bn_fw_* / bn_bw_*, ATen's batch_norm_*)
BN_KERNEL_PARTS = ("batch_norm", "bn_fw", "bn_bw")
# the graph against the eager loop on the card where bits do not hold
GRAPH_TOL = dict(rtol=1e-5, atol=1e-6)
# the device kernel each wrapper of the harness's graph paths launches
# once a call, as the profiler names it: each form a set of parts its
# (demangled or mangled) symbol holds
KERNEL_SYMBOLS = {
    "fused_sgd": [("fused_sgd_kernel",)],
    "maxpool2d_forward": [("maxpool2d_fwd_kernel",)],
    "maxpool2d_backward": [("maxpool2d_bwd_kernel",)],
    "maxpool2d_s1_forward": [("s1_fwd_staged",), ("s1_fwd_direct",)],
    "maxpool2d_s1_backward": [("s1_bwd_staged",), ("s1_bwd_direct",)],
    "lrn_forward": [("lrn_fwd_kernel",)],
    "lrn_backward": [("lrn_bwd_kernel",)],
    "rnn_forward": [("cluster_recurrence", "RnnFwd")],
    "rnn_backward": [("cluster_recurrence", "RnnBwd")],
    # the weight gradient's sliced products (then their sum, uncounted)
    "rnn_dwh": [("dwh_kernel",)],
}
SGD_HYPERS = [
    {"lr": 0.1}, {"lr": 0.1, "dampening": 0.9},
    {"lr": 0.1, "momentum": 0.9},
    {"lr": 0.1, "momentum": 0.9, "dampening": 0.9},
    {"lr": 0.1, "momentum": 0.9, "nesterov": True},
    {"lr": 0.1, "momentum": 0.9, "weight_decay": 1e-3},
]


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def ptxas_lines(log):
    """One line per kernel of ``nvcc -Xptxas -v`` output: its (mangled)
    name, then its registers and its stack and spills."""
    out, name, spill = [], "?", ""
    for line in log.splitlines():
        if "Function properties for" in line:
            name = line.split("Function properties for", 1)[1].strip()
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
    return out


def cluster_plan_line(label, lib, cell, plan, kernel_plan, nd, b):
    """A case's cluster plan (the Python mirror, held equal to the plan
    the library computes) with ptxas's registers and spills for the
    instantiation it launches; returns the plan's (C, staged)."""
    from bigdl_tpu_torch.ops import _build

    if plan != kernel_plan:
        raise AssertionError(f"{label}: the plan mirror {plan} differs from "
                             f"the kernel's {kernel_plan}")
    log = _build.target(lib).with_suffix(".log").read_text()
    inst = f"{len(cell)}{cell}ELi{plan['RT']}ELb{plan['staged']}E"
    regs = [line.split(": ", 1)[1] for line in ptxas_lines(log)
            if "cluster_recurrence" in line and inst in line]
    grid = nd * -(-b // plan["R"]) * plan["C"]
    print(f"{label}: C={plan['C']} R={plan['R']} RT={plan['RT']} "
          f"KP={plan['KP']} grid={grid} ({grid // plan['C']} clusters) "
          f"depth={plan['depth']} weight "
          f"{'in shared memory' if plan['staged'] else 'through L2'} "
          f"smem={plan['bytes']} B; {cell}<{plan['RT']}, "
          f"{bool(plan['staged'])}>: {'; '.join(regs) or 'no ptxas line'}")
    return plan["C"], plan["staged"]


def covered(label, plans):
    """Raises unless the (C, staged) pairs ``plans`` ran every cluster
    size and both weight placements (shared memory, through L2)."""
    sizes, staged = {c for c, _ in plans}, {w for _, w in plans}
    if sizes != set(CLUSTER_SIZES) or staged != {0, 1}:
        raise AssertionError(f"{label}: the cases ran cluster sizes "
                             f"{sorted(sizes)} and placements "
                             f"{sorted(staged)}, not all of "
                             f"{CLUSTER_SIZES} and (0, 1)")


def time_ms(torch, fn, flush, reps=25, warm=3):
    """Median device time of ``fn`` over ``reps`` launches, L2 flushed
    before each (the decode step finds its K/V pages cold: six layers of
    pools and 335 MB of weights pass through L2 between two reads)."""
    times = []
    for r in range(warm + reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        if r >= warm:
            times.append(start.elapsed_time(end))
    return statistics.median(times)


# the repeats of readings no gate reads: the plain versions' and the
# library calls' times (and a whole layer's, a same-bytes copy's), the
# bf16 configurations' timed and traced dispatches, the pipeline's
# steady-state pairs and profiled steps, the profiled steps after a
# harness run's held ones, a training path's profiled window.
# The option runs PERF.md's tables are read from keep these counts; the
# run with no arguments, whose limit is 1200 s, takes each about once
# (``short_readings``)
READ = {"yard_reps": 25, "yard_warm": 3, "dispatches": 3, "pairs": 3,
        "profiled": None, "pipe_profiled": None, "train_profiled": None}


def short_readings():
    READ.update(yard_reps=3, yard_warm=1, dispatches=1, pairs=1,
                profiled=HDISPATCH, pipe_profiled=2, train_profiled=1)


def yard_ms(torch, fn, flush, reps=25):
    """``time_ms`` of a yardstick (a plain version, a library call, a
    whole layer, a copy of the same bytes): ``reps`` repeats or READ's,
    the fewer."""
    return time_ms(torch, fn, flush, reps=min(reps, READ["yard_reps"]),
                   warm=READ["yard_warm"])


def time_queued_ms(torch, fn, reps=20):
    """Mean time of ``reps`` calls queued back to back between two
    events: the host runs ahead of the card, so where the device work of
    a call outlasts the wrapper's host work, this is the device's time.
    No L2 flush: use it at shapes far above the 50 MB L2."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def byte_bound(nbytes, ops):
    """The least time for ``nbytes`` moved and ``ops`` fp32 operations:
    the larger of the two over the card's rates, and which one it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bytes": nbytes,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def timed(torch, flush, kernel, plain, library):
    """A kernel row's times: the wrapper, its plain version and the
    library call, each L2-flushed, and the wrapper queued."""
    return {"ms": time_ms(torch, kernel, flush),
            "plain_ms": yard_ms(torch, plain, flush),
            "library_ms": yard_ms(torch, library, flush),
            "queued_ms": time_queued_ms(torch, kernel)}


def paged_case(torch, g, bsz, S, H, hd, ps, P, n_pages, pos, shared=False):
    dev = "cuda"
    q = torch.randn(bsz, S, H, hd, generator=g, device=dev)
    kpool = torch.randn(n_pages, ps, H, hd, generator=g, device=dev)
    vpool = torch.randn(n_pages, ps, H, hd, generator=g, device=dev)
    perm = torch.randperm(n_pages, generator=g, device=dev)
    ptab = perm[:bsz * P].reshape(bsz, P).to(torch.int32)
    if shared:
        ptab[:, 0] = perm[0]          # prefix-style shared head page
    pos = torch.as_tensor(pos, dtype=torch.int32, device=dev)
    return q, kpool, vpool, ptab, pos


def window_pos(bsz, S, n_view):
    """Consecutive S-query windows, row 0 at the minimal position (its
    tail pages fully masked), the last row at the last view position."""
    last = np.linspace(S - 1, n_view - 1, bsz).round().astype(np.int64)
    return last[:, None] - (S - 1) + np.arange(S)[None, :]


def check_paged(torch, ops, args):
    """Kernel against the plain version on the same inputs; live rows
    only (a row with pos < 0 is discarded by every caller)."""
    out = ops.paged_attention(*args)
    ref = ops.paged_attention_reference(*args)
    torch.cuda.synchronize()
    live = args[4] >= 0
    torch.testing.assert_close(out[live], ref[live], rtol=RTOL, atol=ATOL)
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("paged_attention: non-finite output")
    return float((out[live] - ref[live]).abs().max())


def check_splits(torch, ops, args, counts):
    """The kernel (fp32 or, with scales, int8 pools) cut into each split
    count of ``counts`` (None: the plan's) against the plain split-and-
    merge version at that count and the gathered-view plain version on
    live rows; a row with pos < 0 comes out 0, and the bits repeat from
    one call to the next.  Returns {count: max_abs_err} and the (row,
    split) blocks of the plan's count that found no live page."""
    import importlib

    pa = importlib.import_module("bigdl_tpu_torch.ops.paged_attention")
    int8 = len(args) == 7
    plain = (ops.paged_attention_int8_reference if int8
             else ops.paged_attention_reference)
    q, kpool, _, ptab, pos = args[:5]
    bsz, _, H, _ = q.shape
    ps, P = kpool.shape[1], ptab.shape[1]
    plan = pa.split_count(bsz, H, P)
    if plan != pa._lib().bigdl_paged_attention_splits(bsz, H, P):
        raise AssertionError(f"split plan mirror {plan} differs from the "
                             f"kernel's at (B, H, P) = {(bsz, H, P)}")
    live = pos >= 0
    ref = plain(*args)
    errs = {}
    for n in counts:
        out = pa._launch(*args, splits=n)
        again = pa._launch(*args, splits=n)
        split = pa.paged_attention_split_reference(*args[:5], n, *args[5:])
        torch.cuda.synchronize()
        torch.testing.assert_close(out[live], ref[live], rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(out, split, rtol=RTOL, atol=ATOL)
        if not torch.equal(out, again) or bool(out[~live].any()):
            raise AssertionError(f"paged split {n}: bits differ between "
                                 f"calls, or a dead row is not 0")
        errs[n or plan] = float((out[live] - ref[live]).abs().max())
    per = -(-P // plan)
    pages = (pos.max(dim=1).values.clamp(min=-1) // ps + 1).tolist()
    empty = sum(k * per >= n_live for n_live in pages for k in range(plan))
    return errs, plan, empty


def sdpa_view(torch, args):
    """The yardstick's inputs: q and each row's gathered K and V views as
    (B, H, S or keys, hd), and the mask of keys past pos."""
    q, kpool, vpool, ptab, pos = args
    bsz, _, H, hd = q.shape
    n_view = ptab.shape[1] * kpool.shape[1]
    idx = ptab.long()
    kview = kpool[idx].reshape(bsz, n_view, H, hd).transpose(1, 2)
    vview = vpool[idx].reshape(bsz, n_view, H, hd).transpose(1, 2)
    mask = (torch.arange(n_view, device="cuda")[None, None, None, :]
            <= pos[:, None, :, None])
    return (q.transpose(1, 2).contiguous(), kview.contiguous(),
            vview.contiguous(), mask)


def unique_key_rows(ptab, pos, ps):
    """K/V rows a call must read at least once: each physical page's rows up
    to the last one any batch row's queries reach (none for a row whose
    positions are all < 0; a head page the rows share counts once)."""
    reach = {}
    pt = ptab.cpu().numpy()
    last = pos.max(dim=1).values.cpu().numpy()
    for b in range(pt.shape[0]):
        n = min(int(last[b]) + 1, pt.shape[1] * ps)
        for j in range(-(-n // ps) if n > 0 else 0):
            reach[pt[b, j]] = max(reach.get(pt[b, j], 0), min(ps, n - j * ps))
    return sum(reach.values())


def paged_bound(args):
    """Least time for this call's work: each live K/V row read once, q,
    pos, ptab read and out written once, over the memory rate; its
    QK and PV flops over the fp32 rate.  Rows past a row's last query
    position are not needed and not counted."""
    q, kpool, _, ptab, pos = args
    bsz, S, H, hd = q.shape
    live_keys = pos.clamp(min=-1).cpu().numpy() + 1          # (B, S)
    kv = 2 * unique_key_rows(ptab, pos, kpool.shape[1]) * H * hd * 4
    io = 2 * q.numel() * 4 + pos.numel() * 4 + ptab.numel() * 4
    flops = 4 * hd * H * int(live_keys.sum())
    t_bytes = (kv + io) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), kv + io


def local_head_rows(torch, ops, flush, int8):
    """The page walk at a tensor-parallel rank's heads (TP_HEADS: the
    serving model's H / tp), at serving's context (B 8, hd 256, the
    24-page table), fp32 or int8 pools: against its plain version and the
    plain split-and-merge version at the plan's split count and at one,
    timed beside the plain version, the library's yardstick (SDPA over
    the gathered view; int8: dequantize it first) and the bound.  Its own
    generator: the phase's other inputs stay as they were.  Returns
    {H: row}."""
    import torch.nn.functional as F

    from bigdl_tpu_torch.quant.kv import dequantize_view

    g = torch.Generator(device="cuda").manual_seed(21)
    hd = D_MODEL // HEADS
    out = {}
    for H in TP_HEADS:
        if int8:
            args = paged_int8_case(torch, g, SLOTS, 1, H, hd, PAGE,
                                   SERVE_PAGES, 512, SERVE_POS)
            err = check_paged_int8(torch, ops, args)
            kernel, plain = (ops.paged_attention_int8,
                             ops.paged_attention_int8_reference)
            q, k, v, ptab, pos, ks, vs = args
            n_view = ptab.shape[1] * PAGE
            mask = (torch.arange(n_view, device="cuda")[None, None, None, :]
                    <= pos[:, None, :, None])

            def library():
                kv = [dequantize_view(p[ptab.long()], sc[ptab.long()])
                      .reshape(SLOTS, n_view, H, hd).transpose(1, 2)
                      for p, sc in ((k, ks), (v, vs))]
                return F.scaled_dot_product_attention(
                    q.transpose(1, 2), *kv, attn_mask=mask)
            bound = paged_int8_bound(args)
        else:
            args = paged_case(torch, g, SLOTS, 1, H, hd, PAGE, SERVE_PAGES,
                              512, SERVE_POS)
            err = check_paged(torch, ops, args)
            kernel, plain = (ops.paged_attention,
                             ops.paged_attention_reference)
            view = sdpa_view(torch, args)

            def library():
                return F.scaled_dot_product_attention(*view[:3],
                                                      attn_mask=view[3])
            b, by, nbytes = paged_bound(args)
            bound = {"bound_ms": b, "bound_by": by, "bytes": nbytes}
        split_errs, plan, _ = check_splits(torch, ops, args, (None, 1))
        row = {"splits": plan, "max_abs_err": max(err, *split_errs.values()),
               "ms": time_ms(torch, lambda: kernel(*args), flush),
               "plain_ms": yard_ms(torch, lambda: plain(*args), flush),
               ("dequant_sdpa_ms" if int8 else "library_ms"):
                   yard_ms(torch, library, flush), **bound}
        out[H] = row
        print(f"paged_attention{'_int8' if int8 else ''} at a rank's heads "
              f"(B={SLOTS} S=1 H={H} hd={hd} ps={PAGE} P={SERVE_PAGES}, "
              f"serving's context, {plan} splits): kernel_ms={row['ms']:.5f}"
              f" plain_ms={row['plain_ms']:.5f} "
              f"{'dequant_sdpa_ms' if int8 else 'library_ms'}="
              f"{row.get('dequant_sdpa_ms', row.get('library_ms')):.5f} "
              f"bound_ms={row['bound_ms']:.5f} ({row['bound_by']}, "
              f"{row['bytes']} bytes) max_abs_err={row['max_abs_err']:.3e}")
    return out


def phase_kernels(torch, ops):
    import importlib

    import torch.nn.functional as F

    split_count = importlib.import_module(
        "bigdl_tpu_torch.ops.paged_attention").split_count

    g = torch.Generator(device="cuda").manual_seed(0)
    # full-width decode step: B=8, S=1, H=4, hd=256, ps=16, P=64 pages of
    # a 512-page pool; row 0 never admitted (pos -1), the rest spread
    # over 0..1023
    spread = [[-1]] + [[int(p)] for p in np.linspace(0, N_POS - 1, 7)]
    full = paged_case(torch, g, SLOTS, 1, HEADS, D_MODEL // HEADS, PAGE,
                      N_POS // PAGE, 512, spread)
    errs = [check_paged(torch, ops, full)]
    for S, hd in ((1, 8), (3, 8), (3, 6)):
        # ragged: ps=4, P=3 (the page layout of the n_pos=9 fixtures), a shared head page,
        # fully masked tail pages on row 0; hd=6 takes the scalar path
        args = paged_case(torch, g, 3, S, 2, hd, 4, 3, 10,
                          window_pos(3, S, 12), shared=True)
        errs.append(check_paged(torch, ops, args))
    for ps, P in ((32, 4), (64, 2)):
        # wide pages at hd=256: the ring drops to 3 and to 1 stage
        args = paged_case(torch, g, 3, 1, 2, 256, ps, P, 3 * P + 1,
                          window_pos(3, 1, ps * P))
        errs.append(check_paged(torch, ops, args))

    # the split walk at the plan's count (row 0 dead, the short rows'
    # later splits empty), at one split, at three and at one page a split
    split_errs, plan, empty = check_splits(torch, ops, full,
                                           (None, 1, 3, N_POS // PAGE))
    if not empty:
        raise AssertionError("paged splits: no split without a live page")
    errs += list(split_errs.values())
    print(f"paged_attention splits (plan {plan}, {empty} (row, split) "
          f"blocks with no live page, row 0 pos < 0): " + "; ".join(
              f"{n} max_abs_err={e:.3e}" for n, e in split_errs.items()))

    flush = torch.empty(64 * 2**20, device="cuda")   # 256 MB > 50 MB L2
    q, kpool, vpool, ptab, pos = full
    view = sdpa_view(torch, full)
    times = {
        "ms": time_ms(torch, lambda: ops.paged_attention(*full), flush),
        "plain_ms": yard_ms(
            torch, lambda: ops.paged_attention_reference(*full), flush),
        "library_ms": yard_ms(torch, lambda: F.scaled_dot_product_attention(
            *view[:3], attn_mask=view[3]), flush),
    }
    bound, bound_by, nbytes = paged_bound(full)
    # every position live: the worst case a full reservation reaches
    all_live = (q, kpool, vpool, ptab,
                torch.full_like(pos, N_POS - 1))
    errs.append(check_paged(torch, ops, all_live))
    live_ms = time_ms(torch, lambda: ops.paged_attention(*all_live), flush)
    live_bound, _, live_bytes = paged_bound(all_live)
    # serving's own context: seeds of 16-256 tokens and 128 generated, so
    # positions up to 383 (at most 24 live pages of the 64)
    serve = paged_case(torch, g, SLOTS, 1, HEADS, D_MODEL // HEADS, PAGE,
                       SERVE_PAGES, 512, SERVE_POS)
    errs.append(check_paged(torch, ops, serve))
    sview = sdpa_view(torch, serve)
    serving = {
        "serving_ms": time_ms(torch, lambda: ops.paged_attention(*serve),
                              flush),
        "serving_plain_ms": time_ms(
            torch, lambda: ops.paged_attention_reference(*serve), flush),
        "serving_library_ms": time_ms(torch, lambda: (
            F.scaled_dot_product_attention(*sview[:3], attn_mask=sview[3])),
            flush),
        "serving_bound_ms": paged_bound(serve)[0]}
    print(f"paged_attention full-width (B=8 S=1 H=4 hd=256 ps=16 P=64, "
          f"pos spread, row 0 masked, {plan} splits): kernel_ms="
          f"{times['ms']:.5f} plain_ms={times['plain_ms']:.5f} "
          f"library_ms={times['library_ms']:.5f} bound_ms={bound:.5f} "
          f"({nbytes} bytes) max_abs_err={max(errs):.3e}")
    print(f"paged_attention all positions live (pos=1023): "
          f"kernel_ms={live_ms:.5f} bound_ms={live_bound:.5f} "
          f"({live_bytes} bytes)")
    print(f"paged_attention serving context (pos "
          f"{SERVE_POS[0][0]}..{SERVE_POS[-1][0]}, P={SERVE_PAGES}, "
          f"{split_count(SLOTS, HEADS, SERVE_PAGES)} splits): kernel_ms="
          f"{serving['serving_ms']:.5f} plain_ms="
          f"{serving['serving_plain_ms']:.5f} library_ms="
          f"{serving['serving_library_ms']:.5f} bound_ms="
          f"{serving['serving_bound_ms']:.5f}")
    local = local_head_rows(torch, ops, flush, int8=False)
    errs += [r["max_abs_err"] for r in local.values()]
    return {"name": "paged_attention", "route": "cuda",
            "source": "bigdl_tpu_torch/csrc/paged_attention.cu",
            "replaces": "bigdl_tpu/ops/pallas_kernels.py:1299",
            "local_heads": local,
            "max_abs_err": max(errs), "bound_ms": bound,
            "bound_by": bound_by, "ok": True, "splits": plan, **times,
            **serving,
            # its pages fit in L2, so queued calls would read them warm;
            # its ms, L2 flushed, is already the device's time
            "queued_ms": None}


def check_pool(torch, ops, g, shape, win, st, pads, nan=False):
    """Forward, argmax, the primal variant, the backward wrapper and the
    autograd path against the plain versions on tied inputs (with
    ``nan``, a seventh of them NaN: the first-tap rule); returns
    (forward error, backward error)."""
    x = torch.randn(shape, generator=g, device="cuda").mul_(2).round_().div_(2)
    if nan:
        x[torch.rand(shape, generator=g, device="cuda") < 1 / 7] = float("nan")
    y, arg = ops.maxpool2d_forward(x, win, st, pads)
    y_only = ops.maxpool2d_forward(x, win, st, pads, with_argmax=False)
    y_ref, arg_ref = ops.maxpool2d_forward_reference(x, win, st, pads)
    gy = torch.randn(y.shape, generator=g, device="cuda")
    dx = ops.maxpool2d_backward(arg, gy, win, st, pads, shape)
    dx_ref = ops.maxpool2d_backward_reference(arg_ref, gy, win, st, pads,
                                              shape)
    xg = x.clone().requires_grad_()
    ops.maxpool2d(xg, win, st, pads).backward(gy)
    torch.cuda.synchronize()
    exact = dict(rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(y, y_ref, **exact)
    torch.testing.assert_close(y_only, y, **exact)
    if not torch.equal(arg, arg_ref):
        raise AssertionError(f"maxpool2d argmax differs at {shape}")
    if nan and not bool(y.isnan().any()):
        raise AssertionError(f"maxpool2d: no NaN output at {shape}")
    torch.testing.assert_close(dx, dx_ref, **POOL_TOL)
    torch.testing.assert_close(xg.grad, dx_ref, **POOL_TOL)
    return (float((y - y_ref).nan_to_num(nan=0.0).abs().max()),
            float((dx - dx_ref).abs().max()))


def print_pool_row(label, case, row):
    shape, win, st = case[:3]
    print(f"{label} {shape} {win[0]}x{win[1]} s{st[0] if st else 1} pads "
          f"{case[-1]}: kernel_ms={row['ms']:.5f} "
          f"queued_ms={row['queued_ms']:.5f} plain_ms={row['plain_ms']:.5f} "
          f"library_ms={row['library_ms']:.5f} "
          f"bound_ms={row['bound_ms']:.5f} ({row['bound_by']}, "
          f"{row['bytes']} bytes)")


def step_sum(sums, name, row, n, model="inception"):
    """Adds ``n`` launches of ``row`` to a pass's step totals of ``model``
    (Inception's unless named): kernel, bound and library ms and launches
    a step."""
    out = sums.setdefault(name, {})
    for key in ("ms", "bound_ms", "library_ms"):
        out[f"{model}_{key}"] = out.get(f"{model}_{key}", 0.0) + n * row[key]
    out[f"{model}_launches_step"] = out.get(f"{model}_launches_step", 0) + n


def pool_times(torch, ops, flush, g, shape, win, st, pads):
    """Kernel, plain and library (``F.max_pool2d`` with indices and its
    backward) times of the forward with argmax and of the backward, and
    their byte bounds: x read and y, argmax written; g, argmax read and
    dx written."""
    import torch.nn.functional as F

    x = torch.randn(shape, generator=g, device="cuda")
    y, arg = ops.maxpool2d_forward(x, win, st, pads)
    gy = torch.randn(y.shape, generator=g, device="cuda")
    (plh, phh), (plw, phw) = pads
    # the library's padding is symmetric: a high pad past the low one
    # becomes ceil mode
    ceil = phh > plh or phw > plw
    lib = dict(kernel_size=win, stride=st, padding=(plh, plw),
               ceil_mode=ceil)
    y_lib, idx = F.max_pool2d(x, return_indices=True, **lib)
    if not torch.equal(y_lib, y):
        raise AssertionError("F.max_pool2d is not the same pool")
    fwd = timed(torch, flush,
                lambda: ops.maxpool2d_forward(x, win, st, pads),
                lambda: ops.maxpool2d_forward_reference(x, win, st, pads),
                lambda: F.max_pool2d(x, return_indices=True, **lib))
    bwd = timed(
        torch, flush,
        lambda: ops.maxpool2d_backward(arg, gy, win, st, pads, shape),
        lambda: ops.maxpool2d_backward_reference(arg, gy, win, st, pads,
                                                 shape),
        lambda: torch.ops.aten.max_pool2d_with_indices_backward(
            gy, x, win, st, (plh, plw), (1, 1), ceil, idx))
    for row in (fwd, bwd):
        row.update(byte_bound(4 * (x.numel() + 2 * y.numel()), 0))
    return fwd, bwd


def check_lrn(torch, ops, g, shape, hyper):
    """Forward (y, z and the primal y), the backward wrapper and the
    autograd path against the plain versions; returns (forward error,
    backward error)."""
    x = torch.randn(shape, generator=g, device="cuda")
    gy = torch.randn(shape, generator=g, device="cuda")
    y, z = ops.lrn_forward(x, *hyper)
    y_only = ops.lrn_forward(x, *hyper, with_z=False)
    y_ref, z_ref = ops.lrn_forward_reference(x, *hyper)
    dx = ops.lrn_backward(x, z, gy, *hyper)
    dx_ref = ops.lrn_backward_reference(x, z_ref, gy, *hyper)
    xg = x.clone().requires_grad_()
    ops.lrn_channel(xg, *hyper).backward(gy)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, y_ref, **LRN_FWD_TOL)
    torch.testing.assert_close(z, z_ref, **LRN_FWD_TOL)
    torch.testing.assert_close(y_only, y, rtol=0, atol=0)
    torch.testing.assert_close(dx, dx_ref, **LRN_BWD_TOL)
    torch.testing.assert_close(xg.grad, dx_ref, **LRN_BWD_TOL)
    return (max(float((y - y_ref).abs().max()),
                float((z - z_ref).abs().max())),
            float((dx - dx_ref).abs().max()))


def lrn_times(torch, ops, flush, g, shape, hyper):
    """Forward (with z, as training runs it) and backward rows.  Library:
    ``F.local_response_norm`` and its autograd backward (the same
    function at size 5, whose window is symmetric).  Bound: x read, y and
    z written (backward: x, z, g read, dx written); operations counted
    per element (window squares and adds, scale, two square roots, the
    cube, a quotient; backward: u, g/z^b, the adjoint adds, the update)."""
    import torch.nn.functional as F

    size, alpha, beta, k = hyper
    x = torch.randn(shape, generator=g, device="cuda")
    gy = torch.randn(shape, generator=g, device="cuda")
    y, z = ops.lrn_forward(x, *hyper)
    xl = x.clone().requires_grad_()
    yl = F.local_response_norm(xl, size, alpha, beta, k)
    torch.testing.assert_close(yl, y, rtol=1e-4, atol=1e-5)
    n = x.numel()
    fwd = timed(torch, flush, lambda: ops.lrn_forward(x, *hyper),
                lambda: ops.lrn_forward_reference(x, *hyper),
                lambda: F.local_response_norm(x, size, alpha, beta, k))
    fwd.update(byte_bound(12 * n, (2 * size + 6) * n))
    bwd = timed(torch, flush, lambda: ops.lrn_backward(x, z, gy, *hyper),
                lambda: ops.lrn_backward_reference(x, z, gy, *hyper),
                lambda: torch.autograd.grad(yl, xl, gy, retain_graph=True))
    bwd.update(byte_bound(16 * n, (size + 11) * n))
    return fwd, bwd


def check_pool_s1(torch, ops, g, shape, win, pads, nan=False):
    """Forward and backward (wrapper and autograd) against the plain
    versions on tied inputs (with ``nan``, a seventh of them NaN); the
    forward also equals the any-stride kernel's at stride 1.  Returns
    (forward error, backward error)."""
    x = torch.randn(shape, generator=g, device="cuda").mul_(2).round_().div_(2)
    if nan:
        x[torch.rand(shape, generator=g, device="cuda") < 1 / 7] = float("nan")
    y = ops.maxpool2d_s1_forward(x, win, pads)
    y_ref = ops.maxpool2d_s1_forward_reference(x, win, pads)
    y_any = ops.maxpool2d_forward(x, win, (1, 1), pads, with_argmax=False)
    gy = torch.randn(y.shape, generator=g, device="cuda")
    dx = ops.maxpool2d_s1_backward(x, gy, win, pads)
    dx_ref = ops.maxpool2d_s1_backward_reference(x, gy, win, pads)
    xg = x.clone().requires_grad_()
    ops.maxpool2d_s1(xg, win, pads).backward(gy)
    torch.cuda.synchronize()
    exact = dict(rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(y, y_ref, **exact)
    torch.testing.assert_close(y_any, y, **exact)
    if nan and not bool(y.isnan().any()):
        raise AssertionError(f"maxpool2d_s1: no NaN output at {shape}")
    torch.testing.assert_close(dx, dx_ref, **POOL_TOL)
    torch.testing.assert_close(xg.grad, dx_ref, **POOL_TOL)
    return (float((y - y_ref).nan_to_num(nan=0.0).abs().max()),
            float((dx - dx_ref).abs().max()))


def pool_s1_plan_line(ops, shape, win, pads, dtype=None):
    """The plan each pass takes at ``shape`` (``ops.maxpool_s1.plan``) for
    ``dtype`` (f32 where None), held equal to the one the built library
    computes; one line."""
    import torch

    dtype = dtype or torch.float32
    plans = []
    for bwd in (False, True):
        want = ops.maxpool_s1.plan(shape, win, pads, bwd, dtype)
        got = ops.maxpool_s1.kernel_plan(shape, win, pads, bwd, dtype)
        if want != got:
            raise AssertionError(f"maxpool2d_s1 plan at {shape} {win} "
                                 f"{pads} bwd={bwd} {dtype}: the library's "
                                 f"{got}, the mirror's {want}")
        if want["path"] == "planes":
            how = f"planes, {want['planes']} a group"
        elif want["path"] == "bands":
            how = f"bands of {want['rows']} rows"
        else:
            how = "direct (unstaged)"
        if want["path"] != "direct":
            how += (f" ({want['threads']} threads, {want['groups']} groups, "
                    f"{want['stages']} stages, {want['smem_bytes']} B)")
        plans.append(how)
    form = " bf16" if dtype == torch.bfloat16 else ""
    return (f"maxpool2d_s1{form} plan {shape} {win[0]}x{win[1]} pads "
            f"{pads}: forward {plans[0]}; backward {plans[1]}")


def pool_s1_times(torch, ops, flush, g, shape, win, pads):
    """Forward and backward rows.  Library: ``F.max_pool2d`` with indices
    and ``aten.max_pool2d_with_indices_backward`` (symmetric pads).
    Bound: x read, y written (backward: x and g read, dx written); the
    window's compares (backward: again, plus a compare and add a tap)."""
    import torch.nn.functional as F

    (plh, _), (plw, _) = pads
    x = torch.randn(shape, generator=g, device="cuda")
    y = ops.maxpool2d_s1_forward(x, win, pads)
    gy = torch.randn(y.shape, generator=g, device="cuda")
    lib = dict(kernel_size=win, stride=1, padding=(plh, plw))
    y_lib, idx = F.max_pool2d(x, return_indices=True, **lib)
    if not torch.equal(y_lib, y):
        raise AssertionError("F.max_pool2d is not the same pool")
    taps = win[0] * win[1]
    fwd = timed(torch, flush, lambda: ops.maxpool2d_s1_forward(x, win, pads),
                lambda: ops.maxpool2d_s1_forward_reference(x, win, pads),
                lambda: F.max_pool2d(x, return_indices=True, **lib))
    fwd.update(byte_bound(4 * (x.numel() + y.numel()), taps * y.numel()))
    bwd = timed(
        torch, flush, lambda: ops.maxpool2d_s1_backward(x, gy, win, pads),
        lambda: ops.maxpool2d_s1_backward_reference(x, gy, win, pads),
        lambda: torch.ops.aten.max_pool2d_with_indices_backward(
            gy, x, win, (1, 1), (plh, plw), (1, 1), False, idx))
    bwd.update(byte_bound(4 * (2 * x.numel() + y.numel()),
                          taps * (y.numel() + 2 * x.numel())))
    if y.shape == x.shape:
        # what the card reaches for the same bytes: a copy (x read, y
        # written) and an add (x and g read, dx written)
        out = torch.empty_like(x)
        fwd["same_bytes_ms"] = yard_ms(torch, lambda: out.copy_(x), flush)
        bwd["same_bytes_ms"] = yard_ms(
            torch, lambda: torch.add(x, gy, out=out), flush)
    return fwd, bwd


def phase_conv_kernels(torch, ops):
    """The Inception slice's new kernels against their plain versions,
    with times at Inception-v1's shapes at batch 128: both LRNs, the 3a
    and 3b pools (3b's input is the largest a stride-1 pool takes); and
    at model_zoo's: AlexNet's two LRNs, Inception_v2's 5b pool."""
    g = torch.Generator(device="cuda").manual_seed(2)
    lrn_errs = [check_lrn(torch, ops, g, *case) for case in LRN_CASES]
    s1_errs = []
    for case in S1_CASES:
        s1_errs.append(check_pool_s1(torch, ops, g, *case))
        print(pool_s1_plan_line(ops, *case))
    s1_errs += [check_pool_s1(torch, ops, g, *S1_CASES[k], nan=True)
                for k in NAN_S1_CASES]
    flush = torch.empty(64 * 2**20, device="cuda")   # 256 MB > 50 MB L2
    rows = {}
    for case in ALEXNET_LRNS + INCEPTION_LRNS:
        fwd, bwd = lrn_times(torch, ops, flush, g, *case)
        for name, row in (("forward", fwd), ("backward", bwd)):
            print(f"lrn_{name} {case[0]} {case[1:]}: "
                  f"kernel_ms={row['ms']:.5f} "
                  f"queued_ms={row['queued_ms']:.5f} "
                  f"plain_ms={row['plain_ms']:.5f} "
                  f"library_ms={row['library_ms']:.5f} "
                  f"bound_ms={row['bound_ms']:.5f} ({row['bound_by']}, "
                  f"{row['bytes']} bytes)")
            rows[f"lrn_{name}"] = row   # the last: Inception-v1's 2nd
    # the stride-1 rows at 3b's input, the largest; beside them the step's
    # nine pools (and, at each shape, a copy or add of the same bytes)
    inception = {}
    for *case, n in INCEPTION_S1_POOLS:
        for name, row in zip(("forward", "backward"),
                             pool_s1_times(torch, ops, flush, g, *case)):
            print_pool_row(f"maxpool2d_s1_{name}", (case[0], case[1], None,
                                                   case[2]), row)
            print(f"  the same bytes through "
                  f"{'a copy' if name == 'forward' else 'an add'}: "
                  f"{row['same_bytes_ms']:.5f} ms")
            step_sum(inception, name, row, n)
            if case[0] == S1_CASES[4][0]:
                rows[f"maxpool2d_s1_{name}"] = row
    v2_rows = pool_s1_times(torch, ops, flush, g, *INCEPTION_V2_S1)
    for name, row in zip(("forward", "backward"), v2_rows):
        print_pool_row(f"maxpool2d_s1_{name}", (INCEPTION_V2_S1[0],
                                               INCEPTION_V2_S1[1], None,
                                               INCEPTION_V2_S1[2]), row)
    for name in ("forward", "backward"):
        rows[f"maxpool2d_s1_{name}"].update(inception[name])
    print(f"lrn: {len(LRN_CASES)} cases, forward max_abs_err="
          f"{max(e[0] for e in lrn_errs):.3e} (rtol/atol "
          f"{LRN_FWD_TOL['rtol']}/{LRN_FWD_TOL['atol']}), backward "
          f"max_abs_err={max(e[1] for e in lrn_errs):.3e} (rtol/atol "
          f"{LRN_BWD_TOL['rtol']}/{LRN_BWD_TOL['atol']}); maxpool2d_s1: "
          f"{len(S1_CASES)} geometries with ties and {len(NAN_S1_CASES)} "
          f"with NaNs, forward equal to the plain version and to the "
          f"any-stride kernel, backward max_abs_err="
          f"{max(e[1] for e in s1_errs):.3e}")
    src = "bigdl_tpu_torch/csrc/"
    at = "bigdl_tpu/ops/pallas_kernels.py:"
    errs = {"lrn_forward": max(e[0] for e in lrn_errs),
            "lrn_backward": max(e[1] for e in lrn_errs),
            "maxpool2d_s1_forward": max(e[0] for e in s1_errs),
            "maxpool2d_s1_backward": max(e[1] for e in s1_errs)}
    where = {"lrn_forward": ("lrn.cu", 384), "lrn_backward": ("lrn.cu", 395),
             "maxpool2d_s1_forward": ("maxpool2d_s1.cu", 197),
             "maxpool2d_s1_backward": ("maxpool2d_s1.cu", 214)}
    return [{"name": name, "route": "cuda", "ok": True,
             "source": src + where[name][0],
             "replaces": at + str(where[name][1]),
             "max_abs_err": errs[name], **rows[name]} for name in where]


def bilstm_inputs(torch, g, t, nd, b, h):
    """zx and the cotangent of hs from N(0, 1), wht from the LSTMCell
    init's U(-1/sqrt(H), 1/sqrt(H))."""
    zx = torch.randn(t, nd, b, 4 * h, generator=g, device="cuda")
    wht = (torch.rand(nd, h, 4 * h, generator=g, device="cuda") * 2
           - 1) / h ** 0.5
    gout = torch.randn(t, nd, b, h, generator=g, device="cuda")
    return zx, wht, gout


def held(torch, name, got, plain, want64, tol):
    """``got`` against the plain fp32 version within ``tol``, or failing
    that within BILSTM_VS_64 times the plain version's own error against
    a float64 run on the same inputs; raises otherwise."""
    err = float((got - plain).abs().max())
    e_card = float((got.double() - want64).abs().max())
    e_plain = float((plain.double() - want64).abs().max())
    if torch.allclose(got, plain, **tol):
        rule = "tol"
    elif e_card <= BILSTM_VS_64 * e_plain:
        rule = "float64"
    else:
        raise AssertionError(
            f"{name}: {err:.3e} from the plain version; against float64 "
            f"the card {e_card:.3e}, the plain version {e_plain:.3e}")
    return {"err": err, "rule": rule, "card_vs_64": e_card,
            "plain_vs_64": e_plain}


def check_bilstm(torch, ops, g, case):
    """Both forwards, the backward and the weight gradient against the
    plain versions on the same inputs (float64 rule where the tolerances
    are not met), and the autograd path equal to the wrappers bit for
    bit (the kernels are deterministic)."""
    zx, wht, gout = bilstm_inputs(torch, g, *case)
    hs, cs = ops.bilstm_forward(zx, wht)
    h_only = ops.bilstm_forward(zx, wht, with_c=False)
    dzx = ops.bilstm_backward(zx, wht, hs, cs, gout)
    dwh = ops.bilstm_dwh(hs, dzx)
    zg, wg = zx.clone().requires_grad_(), wht.clone().requires_grad_()
    ops.bilstm_recurrence(zg, wg).backward(gout)
    torch.cuda.synchronize()
    if not (torch.equal(h_only, hs) and torch.equal(zg.grad, dzx)
            and torch.equal(wg.grad, dwh)):
        raise AssertionError(f"bilstm {case}: the primal forward or the "
                             f"autograd path differs from the wrappers")
    hs_p, cs_p = ops.bilstm_forward_reference(zx, wht)
    dzx_p = ops.bilstm_backward_reference(zx, wht, hs, cs, gout)
    dwh_p = ops.bilstm_dwh_reference(hs, dzx)
    z64, w64, h64, c64 = zx.double(), wht.double(), hs.double(), cs.double()
    hs_64, cs_64 = ops.bilstm_forward_reference(z64, w64)
    dzx_64 = ops.bilstm_backward_reference(z64, w64, h64, c64, gout.double())
    dwh_64 = ops.bilstm_dwh_reference(h64, dzx.double())
    name = f"bilstm {case}"
    return {"h": held(torch, name + " h", hs, hs_p, hs_64, BILSTM_FWD_TOL),
            "c": held(torch, name + " c", cs, cs_p, cs_64, BILSTM_FWD_TOL),
            "dzx": held(torch, name + " dzx", dzx, dzx_p, dzx_64,
                        BILSTM_BWD_TOL),
            "dwh": held(torch, name + " dwh", dwh, dwh_p, dwh_64,
                        BILSTM_BWD_TOL)}


def bilstm_times(torch, ops, flush, g, case):
    """Forward (with the c stack, as training runs it), backward and
    weight-gradient rows at ``case``.  Bounds: forward zx, wht read, hs,
    cs written, the recurrent product's multiply-adds; backward zx, wht,
    hs, cs, gout read, dzx written, the gates' product recomputed and
    dz . wht^T; weight gradient hs, dzx read, dwht written, one product.
    The gate arithmetic (a few dozen operations per hidden unit) is left
    out of the operation counts."""
    zx, wht, gout = bilstm_inputs(torch, g, *case)
    hs, cs = ops.bilstm_forward(zx, wht)
    dzx = ops.bilstm_backward(zx, wht, hs, cs, gout)
    n_h, n_w = hs.numel(), wht.numel()
    flops = 2 * n_h * 4 * case[3]
    rows = recurrence_times(torch, flush, {
        "forward": (lambda: ops.bilstm_forward(zx, wht),
                    lambda: ops.bilstm_forward_reference(zx, wht),
                    4 * (4 * n_h + n_w + 2 * n_h), flops),
        "backward": (lambda: ops.bilstm_backward(zx, wht, hs, cs, gout),
                     lambda: ops.bilstm_backward_reference(zx, wht, hs, cs,
                                                           gout),
                     4 * (8 * n_h + n_w + 3 * n_h), 2 * flops),
        "dwh": (lambda: ops.bilstm_dwh(hs, dzx),
                lambda: ops.bilstm_dwh_reference(hs, dzx),
                4 * (5 * n_h + n_w), flops)})
    rows["forward"]["primal_ms"] = time_ms(
        torch, lambda: ops.bilstm_forward(zx, wht, with_c=False), flush)
    einsum_yardstick(torch, flush, rows["dwh"], hs, dzx,
                     lambda: ops.bilstm_dwh(hs, dzx))
    return rows


def lstm_library_times(torch, flush, g):
    """The yardstick the port never calls: ``torch.nn.LSTM`` (cuDNN),
    bidirectional, at the classifier's full width, with the weights of
    the port's ``BiRecurrent`` (w_ih = w[:, :E], w_hh = w[:, E:], b_ih =
    bias, b_hh = 0): the same layer, projection included."""
    from bigdl_tpu_torch.nn import BiRecurrent, LSTMCell
    from bigdl_tpu_torch.utils.random import generator

    gen = generator(3)
    port = BiRecurrent(*[LSTMCell(TEMBED, THIDDEN, device="cuda",
                                  generator=gen) for _ in range(2)])
    lib = torch.nn.LSTM(TEMBED, THIDDEN, batch_first=True,
                        bidirectional=True).cuda()
    with torch.no_grad():
        for sfx, rec in (("", port.get(1)), ("_reverse", port.get(2))):
            w = rec.cell.w
            getattr(lib, "weight_ih_l0" + sfx).copy_(w[:, :TEMBED])
            getattr(lib, "weight_hh_l0" + sfx).copy_(w[:, TEMBED:])
            getattr(lib, "bias_ih_l0" + sfx).copy_(rec.cell.bias)
            getattr(lib, "bias_hh_l0" + sfx).zero_()
    return layer_times(torch, flush, g, port, lib, 2 * THIDDEN, "nn.LSTM")


def phase_bilstm_kernels(torch, ops):
    """The recurrence kernels against their plain versions at the JAX
    tests' shapes, a ragged H, T = 1, the classifier's full width and the
    largest H, each case's forward and backward cluster plans printed and
    every cluster size run, with times at the full width of both
    directions and the cuDNN yardstick."""
    from bigdl_tpu_torch.ops import bilstm

    g = torch.Generator(device="cuda").manual_seed(4)
    cases = [c if c[3] is not None else c[:3] + (bilstm.MAX_HIDDEN,)
             for c in BILSTM_CASES]
    errs = {case: check_bilstm(torch, ops, g, case) for case in cases}
    print_errs("bilstm", errs)
    covered("bilstm", {cluster_plan_line(
        f"bilstm {(t, nd, b, h)} {cell}", "bilstm", cell,
        bilstm.plan(nd, b, h, bwd), bilstm.kernel_plan(nd, b, h, bwd), nd, b)
        for t, nd, b, h in cases
        for cell, bwd in (("LstmFwd", False), ("LstmBwd", True))})
    flush = torch.empty(64 * 2**20, device="cuda")   # 256 MB > 50 MB L2
    full = (TSEQ, 2, TBATCH, THIDDEN)
    rows = bilstm_times(torch, ops, flush, g, full)
    # the largest H the clusters hold is checked above; one more is
    # refused before a launch, by name
    h = bilstm.MAX_HIDDEN + 1
    refused(torch, f"bilstm H={h}", lambda: ops.bilstm_forward(
        torch.zeros(2, 1, 3, 4 * h, device="cuda"),
        torch.zeros(1, h, 4 * h, device="cuda")))
    # no PyTorch call runs the recurrence from a hoisted projection, so
    # the forward and backward rows have no library_ms; cuDNN's layer
    # (projection included) stands beside the port's whole layer instead
    lib = lstm_library_times(torch, flush, g)
    for name in ("fwd", "bwd"):
        row = rows["forward" if name == "fwd" else "backward"]
        row["layer_library_ms"] = lib[f"library_{name}_ms"]
        row["layer_port_ms"] = lib[f"port_{name}_ms"]
    print_rows("bilstm", full, rows)
    print(f"bilstm layer (128, 500, 200) -> (128, 500, 256): port "
          f"BiRecurrent forward {lib['port_fwd_ms']:.5f} ms, backward "
          f"{lib['port_bwd_ms']:.5f} ms; torch.nn.LSTM (cuDNN) forward "
          f"{lib['library_fwd_ms']:.5f} ms, backward "
          f"{lib['library_bwd_ms']:.5f} ms; outputs "
          f"{lib['same_layer_diff']:.3e} apart")
    quantity = {"forward": ("h", "c"), "backward": ("dzx",), "dwh": ("dwh",)}
    at = "bigdl_tpu/ops/pallas_kernels.py:"
    replaces = {"forward": 606, "backward": 631, "dwh": 631}
    return [{"name": f"bilstm_{name}", "route": "cuda", "ok": True,
             "source": "bigdl_tpu_torch/csrc/bilstm.cu",
             "replaces": at + str(replaces[name]),
             "max_abs_err": max(r[q]["err"] for r in errs.values()
                                for q in quantity[name]),
             **rows[name]} for name in rows]


def refused(torch, name, call):
    """``call()`` must raise NotImplementedError before any launch."""
    try:
        call()
    except NotImplementedError as e:
        print(f"{name}: refused ({e})")
    else:
        raise AssertionError(f"{name}: launched past the limit")


def rnn_inputs(torch, g, t, nd, b, h, with_h0):
    """zx, the cotangent and h0 from N(0, 1) (h0 through tanh), wht from
    the RnnCell init's U(-1/sqrt(H), 1/sqrt(H))."""
    zx = torch.randn(t, nd, b, h, generator=g, device="cuda")
    wht = (torch.rand(nd, h, h, generator=g, device="cuda") * 2 - 1) / h ** .5
    gout = torch.randn(t, nd, b, h, generator=g, device="cuda")
    h0 = (torch.randn(nd, b, h, generator=g, device="cuda").tanh()
          if with_h0 else None)
    return zx, wht, gout, h0


def check_rnn(torch, ops, g, case):
    """The forward, backward and weight gradient against the plain
    versions (float64 rule where the tolerances are not met), the
    autograd path equal to the wrappers bit for bit."""
    zx, wht, gout, h0 = rnn_inputs(torch, g, *case)
    hs = ops.rnn_forward(zx, wht, h0)
    dzx = ops.rnn_backward(wht, hs, gout)
    dwh = ops.rnn_dwh(hs, dzx, h0)
    zg, wg = zx.clone().requires_grad_(), wht.clone().requires_grad_()
    y = ops.rnn_recurrence(zg, wg, h0)
    y.backward(gout)
    torch.cuda.synchronize()
    if not (torch.equal(y, hs) and torch.equal(zg.grad, dzx)
            and torch.equal(wg.grad, dwh)):
        raise AssertionError(f"rnn {case}: the autograd path differs from "
                             f"the wrappers")
    d64 = lambda v: None if v is None else v.double()
    z64, w64, h64, g64 = zx.double(), wht.double(), hs.double(), gout.double()
    name = f"rnn {case}"
    return {"h": held(torch, name + " h", hs,
                      ops.rnn_forward_reference(zx, wht, h0),
                      ops.rnn_forward_reference(z64, w64, d64(h0)),
                      BILSTM_FWD_TOL),
            "dzx": held(torch, name + " dzx", dzx,
                        ops.rnn_backward_reference(wht, hs, gout),
                        ops.rnn_backward_reference(w64, h64, g64),
                        BILSTM_BWD_TOL),
            "dwh": held(torch, name + " dwh", dwh,
                        ops.rnn_dwh_reference(hs, dzx, h0),
                        ops.rnn_dwh_reference(h64, dzx.double(), d64(h0)),
                        BILSTM_BWD_TOL)}


def gru_inputs(torch, g, t, nd, b, h):
    """zrz, zn and the cotangent from N(0, 1), wrz and wh from the
    GRUCell init's U(-1/sqrt(H), 1/sqrt(H))."""
    u = lambda *shape: (torch.rand(*shape, generator=g, device="cuda") * 2
                        - 1) / h ** .5
    zrz = torch.randn(t, nd, b, 2 * h, generator=g, device="cuda")
    zn = torch.randn(t, nd, b, h, generator=g, device="cuda")
    gout = torch.randn(t, nd, b, h, generator=g, device="cuda")
    return zrz, zn, u(nd, h, 2 * h), u(nd, h, h), gout


def check_gru(torch, ops, g, case):
    """As ``check_rnn`` for the GRU: hs, dzrz, dzn, the r o hprev stack
    and both weight gradients."""
    zrz, zn, wrz, wh, gout = gru_inputs(torch, g, *case)
    hs = ops.gru_forward(zrz, zn, wrz, wh)
    dzrz, dzn, rh = ops.gru_backward(zrz, zn, wrz, wh, hs, gout)
    dwrz, dwh = ops.gru_dwh(hs, rh, dzrz, dzn)
    args = [v.clone().requires_grad_() for v in (zrz, zn, wrz, wh)]
    y = ops.gru_recurrence(*args)
    y.backward(gout)
    torch.cuda.synchronize()
    if not (torch.equal(y, hs) and all(
            torch.equal(a.grad, b) for a, b in zip(args, (dzrz, dzn, dwrz,
                                                        dwh)))):
        raise AssertionError(f"gru {case}: the autograd path differs from "
                             f"the wrappers")
    x64 = [v.double() for v in (zrz, zn, wrz, wh)]
    bwd_p = ops.gru_backward_reference(zrz, zn, wrz, wh, hs, gout)
    bwd_64 = ops.gru_backward_reference(*x64, hs.double(), gout.double())
    dw_p = ops.gru_dwh_reference(hs, rh, dzrz, dzn)
    dw_64 = ops.gru_dwh_reference(hs.double(), rh.double(), dzrz.double(),
                                  dzn.double())
    name = f"gru {case}"
    out = {"h": held(torch, name + " h", hs,
                     ops.gru_forward_reference(zrz, zn, wrz, wh),
                     ops.gru_forward_reference(*x64), BILSTM_FWD_TOL)}
    for q, got, p, w, tol in (("dzrz", dzrz, bwd_p[0], bwd_64[0],
                               BILSTM_BWD_TOL),
                              ("dzn", dzn, bwd_p[1], bwd_64[1],
                               BILSTM_BWD_TOL),
                              ("rh", rh, bwd_p[2], bwd_64[2],
                               BILSTM_FWD_TOL),
                              ("dwrz", dwrz, dw_p[0], dw_64[0],
                               BILSTM_BWD_TOL),
                              ("dwh", dwh, dw_p[1], dw_64[1],
                               BILSTM_BWD_TOL)):
        out[q] = held(torch, f"{name} {q}", got, p, w, tol)
    return out


def recurrence_times(torch, flush, rows_of):
    """``rows_of``: {row name: (kernel, plain, bytes, operations)}; each
    row's kernel, queued and plain times and its bound (library_ms null:
    filled in by the caller where a PyTorch call computes the same
    function)."""
    return {name: {"ms": time_ms(torch, kernel, flush),
                   "plain_ms": yard_ms(torch, plain, flush, reps=5),
                   "queued_ms": time_queued_ms(torch, kernel),
                   "library_ms": None, **byte_bound(nbytes, n_ops)}
            for name, (kernel, plain, nbytes, n_ops) in rows_of.items()}


def einsum_yardstick(torch, flush, row, hs, dzx, kernel):
    """The weight gradient's library_ms: one einsum of the h stack read at
    t - 1 and dzx (the t = 0 term is zero), timed beside ``kernel()``;
    the yardstick only, the port never calls it."""
    library = lambda: torch.einsum("tdbk,tdbj->dkj", hs[:-1], dzx[1:])
    row["library_ms"] = yard_ms(torch, library, flush)
    row["library_diff"] = float((library() - kernel()).abs().max())


def rnn_times(torch, ops, flush, g, case):
    """Forward, backward and weight-gradient rows at ``case``.  Bounds:
    forward zx, wht read, hs written, the recurrent product's
    multiply-adds; backward wht, hs, gout read, dzx written, dz . wht^T;
    weight gradient hs, dzx read, dwht written, one product (tanh and
    the element-wise terms left out of the operation counts)."""
    zx, wht, gout, _ = rnn_inputs(torch, g, *case, False)
    hs = ops.rnn_forward(zx, wht)
    dzx = ops.rnn_backward(wht, hs, gout)
    n_h, n_w = hs.numel(), wht.numel()
    flops = 2 * n_h * case[3]
    rows = recurrence_times(torch, flush, {
        "forward": (lambda: ops.rnn_forward(zx, wht),
                    lambda: ops.rnn_forward_reference(zx, wht),
                    4 * (2 * n_h + n_w), flops),
        "backward": (lambda: ops.rnn_backward(wht, hs, gout),
                     lambda: ops.rnn_backward_reference(wht, hs, gout),
                     4 * (3 * n_h + n_w), flops),
        "dwh": (lambda: ops.rnn_dwh(hs, dzx),
                lambda: ops.rnn_dwh_reference(hs, dzx),
                4 * (2 * n_h + n_w), flops)})
    einsum_yardstick(torch, flush, rows["dwh"], hs, dzx,
                     lambda: ops.rnn_dwh(hs, dzx))
    return rows


def gru_times(torch, ops, flush, g, case):
    """As ``rnn_times`` for the GRU.  Bounds: forward zrz, zn, wrz, wh
    read, hs written, the two recurrent products (3H columns); backward
    zrz, zn, wrz, wh, hs, gout read, dzrz, dzn, rh written, the gates'
    products recomputed (3H) and dn . wh^T, dzrz . wrz^T (3H); weight
    gradients hs, rh, dzrz, dzn read, dwrz, dwh written, two products
    (3H)."""
    zrz, zn, wrz, wh, gout = gru_inputs(torch, g, *case)
    hs = ops.gru_forward(zrz, zn, wrz, wh)
    dzrz, dzn, rh = ops.gru_backward(zrz, zn, wrz, wh, hs, gout)
    n_h, n_w = hs.numel(), wrz.numel() + wh.numel()
    flops = 2 * n_h * 3 * case[3]
    rows = recurrence_times(torch, flush, {
        "forward": (lambda: ops.gru_forward(zrz, zn, wrz, wh),
                    lambda: ops.gru_forward_reference(zrz, zn, wrz, wh),
                    4 * (4 * n_h + n_w), flops),
        "backward": (lambda: ops.gru_backward(zrz, zn, wrz, wh, hs, gout),
                     lambda: ops.gru_backward_reference(zrz, zn, wrz, wh,
                                                        hs, gout),
                     4 * (9 * n_h + n_w), 2 * flops),
        "dwh": (lambda: ops.gru_dwh(hs, rh, dzrz, dzn),
                lambda: ops.gru_dwh_reference(hs, rh, dzrz, dzn),
                4 * (5 * n_h + n_w), flops)})
    # no one PyTorch call computes both weight gradients; two einsums do
    # (beside the row, not its library_ms)
    rows["dwh"]["two_einsum_ms"] = yard_ms(torch, lambda: (
        torch.einsum("tdbk,tdbj->dkj", hs[:-1], dzrz[1:]),
        torch.einsum("tdbk,tdbj->dkj", rh, dzn)), flush)
    return rows


def rnn_library_times(torch, flush, g):
    """The yardstick the port never calls: cuDNN's ``torch.nn.RNN``
    (tanh), one direction, at the classifier's width (batch 128, T 500,
    200 -> 128), with the weights of the port's ``Recurrent(RnnCell)``:
    the same layer, projection included, forward with autograd on and
    backward to the input and every weight."""
    from bigdl_tpu_torch.nn import Recurrent, RnnCell
    from bigdl_tpu_torch.utils.random import generator

    port = Recurrent().add(RnnCell(TEMBED, THIDDEN, device="cuda",
                                   generator=generator(5)))
    lib = torch.nn.RNN(TEMBED, THIDDEN, nonlinearity="tanh",
                       batch_first=True).cuda()
    with torch.no_grad():
        cell = port.cell
        for mine, theirs in ((cell.i2h, "weight_ih_l0"),
                             (cell.h2h, "weight_hh_l0"),
                             (cell.bias_i, "bias_ih_l0"),
                             (cell.bias_h, "bias_hh_l0")):
            getattr(lib, theirs).copy_(mine)
    return layer_times(torch, flush, g, port, lib, THIDDEN, "nn.RNN")


def gru_library_times(torch, flush, g):
    """A same-size reference, not the same function: cuDNN's
    ``torch.nn.GRU``, bidirectional, at the classifier's width, beside
    the port's ``BiRecurrent(GRUCell, GRUCell)``.  cuDNN's GRU applies r
    after the recurrent product (n = tanh(W x + r o (U h + b))); the
    port's, as the JAX package's, before it (n = tanh(W x + U (r o h))),
    so their outputs differ and no PyTorch call is the port's function."""
    from bigdl_tpu_torch.nn import BiRecurrent, GRUCell
    from bigdl_tpu_torch.utils.random import generator

    gen = generator(6)
    port = BiRecurrent(*[GRUCell(TEMBED, THIDDEN, device="cuda",
                                 generator=gen) for _ in range(2)])
    lib = torch.nn.GRU(TEMBED, THIDDEN, batch_first=True,
                       bidirectional=True).cuda()
    return layer_times(torch, flush, g, port, lib, 2 * THIDDEN, None)


def layer_times(torch, flush, g, port, lib, width, same):
    """Forward (autograd on) and backward times of the port's layer and
    of cuDNN's over one (128, 500, 200) batch; with ``same`` the two must
    give the same output (within 1e-3)."""
    x = torch.randn(TBATCH, TSEQ, TEMBED, generator=g, device="cuda")
    gy = torch.randn(TBATCH, TSEQ, width, generator=g, device="cuda")
    xl, xp = x.clone().requires_grad_(), x.clone().requires_grad_()
    yl, yp = lib(xl)[0], port(xp)
    out = {}
    if same is not None:
        out["same_layer_diff"] = float((yl - yp).detach().abs().max())
        if out["same_layer_diff"] > 1e-3:
            raise AssertionError(f"{same} is not the same layer: "
                                 f"{out['same_layer_diff']:.3e}")
    return out | {
        "library_fwd_ms": yard_ms(torch, lambda: lib(x), flush),
        "port_fwd_ms": yard_ms(torch, lambda: port(x), flush),
        "library_bwd_ms": yard_ms(torch, lambda: torch.autograd.grad(
            yl, [xl, *lib.parameters()], gy, retain_graph=True), flush),
        "port_bwd_ms": yard_ms(torch, lambda: torch.autograd.grad(
            yp, [xp, *port.parameters()], gy, retain_graph=True), flush)}


def print_errs(label, errs):
    for case, res in errs.items():
        print(f"{label} {case}: " + "; ".join(
            f"{q} max_abs_err={r['err']:.3e} ({r['rule']}; vs float64 card "
            f"{r['card_vs_64']:.3e} plain {r['plain_vs_64']:.3e})"
            for q, r in res.items()))


def print_rows(label, case, rows):
    for name, row in rows.items():
        extra = "".join(
            f" {k}={row[k]:.5f}" for k in ("primal_ms", "two_einsum_ms",
                                           "bilstm_forward_ms",
                                           "layer_library_ms",
                                           "layer_port_ms",
                                           "same_size_library_ms")
            if k in row)
        print(f"{label}_{name} {case}: kernel_ms={row['ms']:.5f} "
              f"({row['ms'] / case[0] * 1e3:.3f} us/step) queued_ms="
              f"{row['queued_ms']:.5f} plain_ms={row['plain_ms']:.5f} "
              f"bound_ms={row['bound_ms']:.5f} ({row['bound_by']}, "
              f"{row['bytes']} bytes)" + extra
              + (f" library_ms={row['library_ms']:.5f} (einsum, "
                 f"{row['library_diff']:.3e} from the kernel)"
                 if row["library_ms"] is not None else ""))


def phase_rnn_gru_kernels(torch, ops):
    """The RNN and GRU kernels against their plain versions at the JAX
    tests' shapes, a ragged H, T = 1, h0 (RNN), the largest H each takes
    and the full widths, each case's cluster plans printed and every
    cluster size run, with times at (500, 2, 128, 128) beside the
    bilstm rows and at SimpleRNN's chunk, cuDNN's nn.RNN beside the port's
    layer and nn.GRU as a same-size reference; one H past each limit is
    refused."""
    from bigdl_tpu_torch.ops import gru, rnn

    g = torch.Generator(device="cuda").manual_seed(7)
    rnn_cases = [c if c[3] is not None else c[:3] + (rnn.MAX_HIDDEN, c[4])
                 for c in RNN_CASES]
    gru_cases = [c if c[3] is not None else c[:3] + (gru.MAX_HIDDEN,)
                 for c in GRU_CASES]
    rnn_errs = {c: check_rnn(torch, ops, g, c) for c in rnn_cases}
    gru_errs = {c: check_gru(torch, ops, g, c) for c in gru_cases}
    print_errs("rnn", rnn_errs)
    plans = {cluster_plan_line(f"rnn {(t, nd, b, h)} {cell}", "rnn", cell,
                               rnn.plan(nd, b, h, bwd),
                               rnn.kernel_plan(nd, b, h, bwd), nd, b)
             for t, nd, b, h, _ in rnn_cases
             for cell, bwd in (("RnnFwd", False), ("RnnBwd", True))}
    covered("rnn", plans)
    print_errs("gru", gru_errs)
    plans = {cluster_plan_line(f"gru {(t, nd, b, h)} {cell}", "gru", cell,
                               gru.plan(nd, b, h, bwd),
                               gru.kernel_plan(nd, b, h, bwd), nd, b)
             for t, nd, b, h in gru_cases
             for cell, bwd in (("GruFwd", False), ("GruBwd", True))}
    covered("gru", plans)
    for name, limit, call in (
            ("rnn", rnn.MAX_HIDDEN, lambda h: ops.rnn_forward(
                torch.zeros(2, 1, 3, h, device="cuda"),
                torch.zeros(1, h, h, device="cuda"))),
            ("gru", gru.MAX_HIDDEN, lambda h: ops.gru_forward(
                torch.zeros(2, 1, 3, 2 * h, device="cuda"),
                torch.zeros(2, 1, 3, h, device="cuda"),
                torch.zeros(1, h, 2 * h, device="cuda"),
                torch.zeros(1, h, h, device="cuda")))):
        refused(torch, f"{name} H={limit + 1}", lambda: call(limit + 1))
    flush = torch.empty(64 * 2**20, device="cuda")   # 256 MB > 50 MB L2
    full = (TSEQ, 2, TBATCH, THIDDEN)
    rows = {"rnn": rnn_times(torch, ops, flush, g, full),
            "gru": gru_times(torch, ops, flush, g, full)}
    # SimpleRNN's own shapes: a 4-step chunk of 4 rows at H 40
    small = (RBPTT, 1, RBATCH, RHIDDEN)
    simple = rnn_times(torch, ops, flush, g, small)
    # cuDNN's nn.RNN is the same layer; nn.GRU only a same-size reference
    for label, lib, key in (
            ("rnn", rnn_library_times(torch, flush, g), "layer_library_ms"),
            ("gru", gru_library_times(torch, flush, g),
             "same_size_library_ms")):
        for name, short in (("forward", "fwd"), ("backward", "bwd")):
            rows[label][name][key] = lib[f"library_{short}_ms"]
            rows[label][name]["layer_port_ms"] = lib[f"port_{short}_ms"]
        if "same_layer_diff" in lib:
            print(f"{label} layer: cuDNN and the port "
                  f"{lib['same_layer_diff']:.3e} apart")
    for label in ("rnn", "gru"):
        print_rows(label, full, rows[label])
    print_rows("rnn", small, simple)
    for name in ("forward", "backward"):
        rows["rnn"][name]["simplernn_ms"] = simple[name]["ms"]
        rows["rnn"][name]["simplernn_bound_ms"] = simple[name]["bound_ms"]
    src = "bigdl_tpu_torch/csrc/"
    at = "bigdl_tpu/ops/pallas_kernels.py:"
    quantity = {"rnn": {"forward": ("h",), "backward": ("dzx",),
                        "dwh": ("dwh",)},
                "gru": {"forward": ("h",), "backward": ("dzrz", "dzn", "rh"),
                        "dwh": ("dwrz", "dwh")}}
    replaces = {"rnn": {"forward": 948, "backward": 969, "dwh": 969},
                "gru": {"forward": 792, "backward": 818, "dwh": 818}}
    errs = {"rnn": rnn_errs, "gru": gru_errs}
    return [{"name": f"{label}_{name}", "route": "cuda", "ok": True,
             "source": f"{src}{label}.cu",
             "replaces": at + str(replaces[label][name]),
             "max_abs_err": max(r[q]["err"] for r in errs[label].values()
                                for q in quantity[label][name]),
             **rows[label][name]}
            for label in ("rnn", "gru") for name in rows[label]]


def state_inputs(torch, g, case):
    """h0 through tanh and c0 from N(0, 1), (D, B, H)."""
    t, nd, b, h = case
    return (torch.randn(nd, b, h, generator=g, device="cuda").tanh(),
            torch.randn(nd, b, h, generator=g, device="cuda"))


def check_bilstm_state(torch, ops, g, case):
    """The LSTM from a given h0, c0: forward (h, c), backward and weight
    gradient against the plain versions, and the truncated chunk's
    autograd path (its last c too) equal to the wrappers bit for bit."""
    zx, wht, gout = bilstm_inputs(torch, g, *case)
    h0, c0 = state_inputs(torch, g, case)
    hs, cs = ops.bilstm_forward(zx, wht, h0=h0, c0=c0)
    dzx = ops.bilstm_backward(zx, wht, hs, cs, gout, h0, c0)
    dwh = ops.bilstm_dwh(hs, dzx, h0)
    zg, wg = zx.clone().requires_grad_(), wht.clone().requires_grad_()
    y, last_c = ops.bilstm_recurrence(zg, wg, h0, c0, with_last_c=True)
    y.backward(gout)
    torch.cuda.synchronize()
    if not (torch.equal(y, hs) and torch.equal(last_c, cs[-1])
            and torch.equal(zg.grad, dzx) and torch.equal(wg.grad, dwh)):
        raise AssertionError(f"bilstm from h0, c0 {case}: the autograd path "
                             f"differs from the wrappers")
    x64 = [v.double() for v in (zx, wht, hs, cs, gout, h0, c0)]
    z64, w64, h64, c64, g64, s64, t64 = x64
    hs_64, cs_64 = ops.bilstm_forward_reference(z64, w64, h0=s64, c0=t64)
    hs_p, cs_p = ops.bilstm_forward_reference(zx, wht, h0=h0, c0=c0)
    name = f"bilstm from h0, c0 {case}"
    return {"h": held(torch, name + " h", hs, hs_p, hs_64, BILSTM_FWD_TOL),
            "c": held(torch, name + " c", cs, cs_p, cs_64, BILSTM_FWD_TOL),
            "dzx": held(torch, name + " dzx", dzx,
                        ops.bilstm_backward_reference(zx, wht, hs, cs, gout,
                                                      h0, c0),
                        ops.bilstm_backward_reference(z64, w64, h64, c64,
                                                      g64, s64, t64),
                        BILSTM_BWD_TOL),
            "dwh": held(torch, name + " dwh", dwh,
                        ops.bilstm_dwh_reference(hs, dzx, h0),
                        ops.bilstm_dwh_reference(h64, dzx.double(), s64),
                        BILSTM_BWD_TOL)}


def check_gru_state(torch, ops, g, case):
    """The GRU from a given h0: forward, backward (dzrz, dzn, rh) and both
    weight gradients against the plain versions, the autograd path equal
    to the wrappers bit for bit."""
    zrz, zn, wrz, wh, gout = gru_inputs(torch, g, *case)
    h0 = state_inputs(torch, g, case)[0]
    hs = ops.gru_forward(zrz, zn, wrz, wh, h0)
    dzrz, dzn, rh = ops.gru_backward(zrz, zn, wrz, wh, hs, gout, h0)
    dwrz, dwh = ops.gru_dwh(hs, rh, dzrz, dzn, h0)
    args = [v.clone().requires_grad_() for v in (zrz, zn, wrz, wh)]
    y = ops.gru_recurrence(*args, h0)
    y.backward(gout)
    torch.cuda.synchronize()
    if not (torch.equal(y, hs) and all(
            torch.equal(a.grad, b) for a, b in zip(args, (dzrz, dzn, dwrz,
                                                        dwh)))):
        raise AssertionError(f"gru from h0 {case}: the autograd path "
                             f"differs from the wrappers")
    x64 = [v.double() for v in (zrz, zn, wrz, wh)]
    h064 = h0.double()
    bwd_p = ops.gru_backward_reference(zrz, zn, wrz, wh, hs, gout, h0)
    bwd_64 = ops.gru_backward_reference(*x64, hs.double(), gout.double(),
                                        h064)
    dw_p = ops.gru_dwh_reference(hs, rh, dzrz, dzn, h0)
    dw_64 = ops.gru_dwh_reference(hs.double(), rh.double(), dzrz.double(),
                                  dzn.double(), h064)
    name = f"gru from h0 {case}"
    out = {"h": held(torch, name + " h", hs,
                     ops.gru_forward_reference(zrz, zn, wrz, wh, h0),
                     ops.gru_forward_reference(*x64, h064), BILSTM_FWD_TOL)}
    for q, got, p, w, tol in (("dzrz", dzrz, bwd_p[0], bwd_64[0],
                               BILSTM_BWD_TOL),
                              ("dzn", dzn, bwd_p[1], bwd_64[1],
                               BILSTM_BWD_TOL),
                              ("rh", rh, bwd_p[2], bwd_64[2],
                               BILSTM_FWD_TOL),
                              ("dwrz", dwrz, dw_p[0], dw_64[0],
                               BILSTM_BWD_TOL),
                              ("dwh", dwh, dw_p[1], dw_64[1],
                               BILSTM_BWD_TOL)):
        out[q] = held(torch, f"{name} {q}", got, p, w, tol)
    return out


def act_inputs(torch, g, case, act):
    """rnn_inputs from h0 for activation ``act``: zx moved into the domain
    of sqrt and log (|zx| + 3, h0 |h0| + 1, wht quartered: every
    pre-activation stays above 1), zx halved and wht quartered for the
    kinds that grow (square, exp, power), so that 500 steps stay
    finite."""
    zx, wht, gout, h0 = rnn_inputs(torch, g, *case, True)
    if act.kind in ("sqrt", "log"):
        zx, h0, wht = zx.abs() + 3.0, h0.abs() + 1.0, wht * 0.25
    elif act.kind in ("square", "exp", "power"):
        zx, wht = zx * 0.5, wht * 0.25
    return zx, wht, gout, h0


# the points where an activation's value or derivative jumps, by kind
# (parameters a, b as in ops.Act)
ACT_KINKS = {"relu": lambda a, b: (0.0,), "relu6": lambda a, b: (0.0, 6.0),
             "softshrink": lambda a, b: (-a, a),
             "hardshrink": lambda a, b: (-a, a),
             "hardtanh": lambda a, b: (a, b), "threshold": lambda a, b: (a,),
             "leakyrelu": lambda a, b: (0.0,), "elu": lambda a, b: (0.0,),
             "abs": lambda a, b: (0.0,)}


def forced_steps(torch, act, zx, wht, h0, hs, gout, dzx):
    """The plain step of every t from the card's own previous state, in
    the dtype of the inputs: (pre, act(pre), (gout_t + dz_{t+1} .
    wht^T) act'(pre)), pre = zx_t + h_{t-1} . wht."""
    from bigdl_tpu_torch.ops import _activation
    from bigdl_tpu_torch.ops._recurrence import shift_prev

    pre = zx + torch.matmul(shift_prev(hs, h0), wht)
    dh = torch.matmul(torch.cat([dzx[1:], torch.zeros_like(pre[:1])]),
                      wht.transpose(1, 2))
    return (pre, _activation.apply(act, pre),
            (gout + dh) * _activation.derivative(act, pre, hs))


def teacher_forced(torch, act, zx, wht, h0, hs, gout, dzx):
    """Each step of the card's forward and backward from the card's own
    previous state against the plain step (``forced_steps``, the plain
    activation and derivative of ``ops._activation``): within the
    tolerance of the fp32 plain step, or no further from the float64
    step than BILSTM_VS_64 times the fp32 plain step.  Over 500 steps the
    free-running fp32 chains of the card and of the plain version part
    where a pre-activation falls within rounding of a jump of act or act'
    (HardShrink's and Threshold's values, a clip's or abs's derivative)
    and stay apart; held step by step they cannot.  Elements whose
    float64 pre is within 1e-4 of such a point are left out:
    {quantity: (max |card - plain|, held, card vs float64, plain vs
    float64, elements left out)}."""
    args = (zx, wht, h0, hs, gout, dzx)
    pre, h32, dz32 = forced_steps(torch, act, *args)
    pre64, h64, dz64 = forced_steps(torch, act, *(v.double() for v in args))
    keep = torch.ones_like(pre64, dtype=torch.bool)
    for k in ACT_KINKS.get(act.kind, lambda a, b: ())(act.a, act.b):
        keep &= (pre64 - k).abs() > 1e-4
    out = {}
    for q, got, p32, p64, tol in (("h", hs, h32, h64, BILSTM_FWD_TOL),
                                  ("dzx", dzx, dz32, dz64, BILSTM_BWD_TOL)):
        got, p32, p64 = got[keep], p32[keep], p64[keep]
        e_card = float((got.double() - p64).abs().max())
        e_plain = float((p32.double() - p64).abs().max())
        ok = (bool(torch.allclose(got, p32, **tol))
              or e_card <= BILSTM_VS_64 * e_plain)
        out[q] = (float((got - p32).abs().max()), ok, e_card, e_plain,
                  int((~keep).sum()))
    return out


def check_rnn_act(torch, ops, g, case, act):
    """The rnn kernels under ``act`` from h0: forward and backward (from
    the pre-activations, recomputed, except tanh's) step by step against
    the plain activation and derivative (``teacher_forced``), the weight
    gradient against its plain version on the card's h and dz, the
    autograd path equal to the wrappers bit for bit."""
    zx, wht, gout, h0 = act_inputs(torch, g, case, act)
    hs = ops.rnn_forward(zx, wht, h0, act)
    dzx = ops.rnn_backward(wht, hs, gout, act, zx, h0)
    dwh = ops.rnn_dwh(hs, dzx, h0)
    zg, wg = zx.clone().requires_grad_(), wht.clone().requires_grad_()
    y = ops.rnn_recurrence(zg, wg, h0, act)
    y.backward(gout)
    torch.cuda.synchronize()
    if not (torch.equal(y, hs) and torch.equal(zg.grad, dzx)
            and torch.equal(wg.grad, dwh)):
        raise AssertionError(f"rnn {act.kind} {case}: the autograd path "
                             f"differs from the wrappers")
    if not bool(torch.isfinite(hs).all() & torch.isfinite(dzx).all()):
        raise AssertionError(f"rnn {act.kind} {case}: not finite on these "
                             f"inputs")
    name = f"rnn {act.kind} {case}"
    out = {}
    for q, (err, ok, e_card, e_plain, left) in teacher_forced(
            torch, act, zx, wht, h0, hs, gout, dzx).items():
        if not ok:
            raise AssertionError(
                f"{name} {q}: {err:.3e} from the plain step; against "
                f"float64 the card {e_card:.3e}, the plain step "
                f"{e_plain:.3e} ({left} elements at a jump left out)")
        out[q] = {"err": err, "rule": f"step by step, {left} at a jump "
                  f"left out", "card_vs_64": e_card, "plain_vs_64": e_plain}
    out["dwh"] = held(torch, name + " dwh", dwh,
                      ops.rnn_dwh_reference(hs, dzx, h0),
                      ops.rnn_dwh_reference(hs.double(), dzx.double(),
                                            h0.double()), BILSTM_BWD_TOL)
    return out


def state_times(torch, ops, flush, g, case):
    """The LSTM and GRU wrappers at ``case`` from zeros and from a given
    state: {row name: (from-zeros ms, from-state ms)}."""
    zx, wht, gout = bilstm_inputs(torch, g, *case)
    h0, c0 = state_inputs(torch, g, case)
    hs, cs = ops.bilstm_forward(zx, wht)
    hs1, cs1 = ops.bilstm_forward(zx, wht, h0=h0, c0=c0)
    dzx = ops.bilstm_backward(zx, wht, hs, cs, gout)
    dzx1 = ops.bilstm_backward(zx, wht, hs1, cs1, gout, h0, c0)
    zrz, zn, wrz, wh, go = gru_inputs(torch, g, *case)
    hg = ops.gru_forward(zrz, zn, wrz, wh)
    hg1 = ops.gru_forward(zrz, zn, wrz, wh, h0)
    bg = ops.gru_backward(zrz, zn, wrz, wh, hg, go)
    bg1 = ops.gru_backward(zrz, zn, wrz, wh, hg1, go, h0)
    pairs = {
        "bilstm_forward": (lambda: ops.bilstm_forward(zx, wht),
                           lambda: ops.bilstm_forward(zx, wht, h0=h0, c0=c0)),
        "bilstm_backward": (
            lambda: ops.bilstm_backward(zx, wht, hs, cs, gout),
            lambda: ops.bilstm_backward(zx, wht, hs1, cs1, gout, h0, c0)),
        "bilstm_dwh": (lambda: ops.bilstm_dwh(hs, dzx),
                       lambda: ops.bilstm_dwh(hs1, dzx1, h0)),
        "gru_forward": (lambda: ops.gru_forward(zrz, zn, wrz, wh),
                        lambda: ops.gru_forward(zrz, zn, wrz, wh, h0)),
        "gru_backward": (
            lambda: ops.gru_backward(zrz, zn, wrz, wh, hg, go),
            lambda: ops.gru_backward(zrz, zn, wrz, wh, hg1, go, h0)),
        "gru_dwh": (lambda: ops.gru_dwh(hg, bg[2], *bg[:2]),
                    lambda: ops.gru_dwh(hg1, bg1[2], *bg1[:2], h0))}
    return {name: (time_ms(torch, zero, flush), time_ms(torch, state, flush))
            for name, (zero, state) in pairs.items()}


def act_times(torch, ops, flush, g, case):
    """rnn_forward and rnn_backward under every kind at ``case`` from
    zeros: {kind: (forward ms, backward ms)}."""
    from bigdl_tpu_torch.ops import Act

    out = {}
    for spec in ACT_CASES:
        act = Act(*spec)
        zx, wht, gout, _ = act_inputs(torch, g, case, act)
        hs = ops.rnn_forward(zx, wht, None, act)
        out[act.kind] = (
            time_ms(torch, lambda: ops.rnn_forward(zx, wht, None, act),
                    flush),
            time_ms(torch, lambda: ops.rnn_backward(wht, hs, gout, act, zx),
                    flush))
    return out


def phase_state_kernels(torch, ops, rows):
    """The recurrence kernels from a carried state and under every
    activation: the LSTM's backward and weight gradient from h0, c0 (its
    forward too) and the GRU's three from h0 at STATE_CASES, the rnn's
    three under each of the twenty kinds at ACT_SHAPES, each against its
    plain version; times from a state beside from zeros at the
    classifiers' chunk, and each kind's beside tanh's at (500, 1, 128,
    128).  Adds them to the kernel ``rows`` (their max_abs_err the larger
    of the two checks')."""
    from bigdl_tpu_torch.ops import Act

    g = torch.Generator(device="cuda").manual_seed(11)
    lstm = {c: check_bilstm_state(torch, ops, g, c) for c in STATE_CASES}
    gru = {c: check_gru_state(torch, ops, g, c) for c in STATE_CASES}
    acts = {(spec[0],) + c: check_rnn_act(torch, ops, g, c, Act(*spec))
            for c in ACT_SHAPES for spec in ACT_CASES}
    print_errs("bilstm from h0, c0", lstm)
    print_errs("gru from h0", gru)
    print_errs("rnn act", acts)
    flush = torch.empty(64 * 2**20, device="cuda")   # 256 MB > 50 MB L2
    chunk = STATE_CASES[0]
    st = state_times(torch, ops, flush, g, chunk)
    for name, (zero, state) in st.items():
        print(f"{name} {chunk}: from zeros {zero:.5f} ms, from h0"
              f"{', c0' if name.startswith('bilstm') else ''} {state:.5f} ms")
    at = act_times(torch, ops, flush, g, ACT_SHAPES[0])
    for kind, (fwd, bwd) in at.items():
        print(f"rnn {kind} {ACT_SHAPES[0]}: forward {fwd:.5f} ms "
              f"(tanh {at['tanh'][0]:.5f}), backward {bwd:.5f} ms (tanh "
              f"{at['tanh'][1]:.5f})")
    quantity = {"bilstm_forward": (lstm, ("h", "c")),
                "bilstm_backward": (lstm, ("dzx",)),
                "bilstm_dwh": (lstm, ("dwh",)),
                "gru_forward": (gru, ("h",)),
                "gru_backward": (gru, ("dzrz", "dzn", "rh")),
                "gru_dwh": (gru, ("dwrz", "dwh")),
                "rnn_forward": (acts, ("h",)), "rnn_backward": (acts, ("dzx",)),
                "rnn_dwh": (acts, ("dwh",))}
    for row in rows:
        if row["name"] not in quantity:
            continue
        errs, qs = quantity[row["name"]]
        row["max_abs_err"] = max([row["max_abs_err"]] + [
            r[q]["err"] for r in errs.values() for q in qs])
        if row["name"] in st:
            row["chunk_ms"], row["chunk_state_ms"] = st[row["name"]]
        if row["name"] in ("rnn_forward", "rnn_backward"):
            i = 0 if row["name"] == "rnn_forward" else 1
            row["act_ms"] = {k: v[i] for k, v in at.items()}


def paged_int8_case(torch, g, bsz, S, H, hd, ps, P, n_pages, pos,
                    shared=False):
    """``paged_case``'s inputs with the pools written as the decoder
    writes them: ``quant.kv.quantize_rows`` of the N(0, 1) fp32 rows."""
    from bigdl_tpu_torch.quant.kv import quantize_rows

    q, kf, vf, ptab, pos = paged_case(torch, g, bsz, S, H, hd, ps, P,
                                      n_pages, pos, shared)
    (k, ks), (v, vs) = quantize_rows(kf), quantize_rows(vf)
    return q, k, v, ptab, pos, ks, vs


def check_paged_int8(torch, ops, args):
    """The int8 kernel against its plain version on the same inputs, live
    rows only; ``paged_attention`` hands int8 pools to the same kernel."""
    out = ops.paged_attention_int8(*args)
    ref = ops.paged_attention_int8_reference(*args)
    again = ops.paged_attention(*args)
    torch.cuda.synchronize()
    live = args[4] >= 0
    torch.testing.assert_close(out[live], ref[live], rtol=RTOL, atol=ATOL)
    if not (bool(torch.isfinite(out).all()) and torch.equal(out, again)):
        raise AssertionError("paged_attention_int8: non-finite output, or "
                             "paged_attention did not give its bits")
    return float((out[live] - ref[live]).abs().max())


def paged_int8_bound(args):
    """``paged_bound`` for int8 pools: each live int8 K and V row and its
    f32 scale read once, q, pos, ptab read and out written once; the QK
    and PV flops."""
    q, kpool, _, ptab, pos, _, _ = args
    _, _, H, hd = q.shape
    kv = 2 * unique_key_rows(ptab, pos, kpool.shape[1]) * H * (hd + 4)
    io = 2 * q.numel() * 4 + pos.numel() * 4 + ptab.numel() * 4
    flops = 4 * hd * H * int((pos.clamp(min=-1) + 1).sum())
    return byte_bound(kv + io, flops)


def phase_int8_attention_kernels(torch, ops):
    """The int8 page walk against its plain version: the decode step's
    full-width shape, an S = 4 window at the same width, small pages at
    hd 16, 8 and 6 (the 16-byte, 4-byte and plain-load copies, a shared
    head page, fully masked tail pages) and wide pages at hd 256; times at
    the full width beside the plain version and the two-call reference
    (dequantize the gathered view, then SDPA).  No one PyTorch call
    computes attention over int8 pages: its library_ms is null."""
    import torch.nn.functional as F

    from bigdl_tpu_torch.quant.kv import dequantize_view

    g = torch.Generator(device="cuda").manual_seed(8)
    hd = D_MODEL // HEADS
    spread = [[-1]] + [[int(p)] for p in np.linspace(0, N_POS - 1, 7)]
    full = paged_int8_case(torch, g, SLOTS, 1, HEADS, hd, PAGE,
                           N_POS // PAGE, 512, spread)
    window = paged_int8_case(torch, g, SLOTS, 4, HEADS, hd, PAGE,
                             N_POS // PAGE, 512, window_pos(SLOTS, 4, N_POS))
    errs = {"full": check_paged_int8(torch, ops, full),
            "window S=4": check_paged_int8(torch, ops, window)}
    for S, d in ((1, 16), (3, 8), (3, 6)):
        args = paged_int8_case(torch, g, 3, S, 2, d, 4, 3, 10,
                               window_pos(3, S, 12), shared=True)
        errs[f"S={S} hd={d} ps=4"] = check_paged_int8(torch, ops, args)
    for ps, P in ((32, 4), (64, 2)):
        args = paged_int8_case(torch, g, 3, 1, 2, hd, ps, P, 3 * P + 1,
                               window_pos(3, 1, ps * P))
        errs[f"hd={hd} ps={ps}"] = check_paged_int8(torch, ops, args)
    # the split walk at the plan's count, at one split, at three and at
    # one page a split, on the full-width case (row 0 dead, the short rows'
    # later splits empty) and the S = 4 window
    splits = {}
    for label, args in (("full", full), ("window S=4", window)):
        split_errs, plan, empty = check_splits(torch, ops, args,
                                               (None, 1, 3, N_POS // PAGE))
        splits[label] = (plan, empty)
        errs |= {f"{label} splits={n}": e for n, e in split_errs.items()}
    if not splits["full"][1]:
        raise AssertionError("int8 splits: no split without a live page")

    flush = torch.empty(64 * 2**20, device="cuda")   # 256 MB > 50 MB L2
    q, k, v, ptab, pos, ks, vs = full
    bsz, S, H, _ = q.shape
    n_view = ptab.shape[1] * PAGE
    idx = ptab.long()
    mask = (torch.arange(n_view, device="cuda")[None, None, None, :]
            <= pos[:, None, :, None])
    qh = q.transpose(1, 2)

    def dequant_sdpa():
        kview = dequantize_view(k[idx], ks[idx]).reshape(bsz, n_view, H, hd)
        vview = dequantize_view(v[idx], vs[idx]).reshape(bsz, n_view, H, hd)
        return F.scaled_dot_product_attention(
            qh, kview.transpose(1, 2), vview.transpose(1, 2), attn_mask=mask)

    live = pos >= 0
    ref_diff = float((dequant_sdpa().transpose(1, 2)[live]
                      - ops.paged_attention_int8(*full)[live]).abs().max())
    row = {"ms": time_ms(torch, lambda: ops.paged_attention_int8(*full),
                         flush),
           "plain_ms": yard_ms(torch, lambda: (
               ops.paged_attention_int8_reference(*full)), flush),
           "queued_ms": time_queued_ms(
               torch, lambda: ops.paged_attention_int8(*full)),
           "library_ms": None,
           "dequant_sdpa_ms": yard_ms(torch, dequant_sdpa, flush),
           **paged_int8_bound(full)}
    window_ms = time_ms(torch, lambda: ops.paged_attention_int8(*window),
                        flush)
    window_bound = paged_int8_bound(window)
    all_live = full[:4] + (torch.full_like(pos, N_POS - 1),) + full[5:]
    errs["all live"] = check_paged_int8(torch, ops, all_live)
    live_ms = time_ms(torch, lambda: ops.paged_attention_int8(*all_live),
                      flush)
    live_bound = paged_int8_bound(all_live)
    serve = paged_int8_case(torch, g, SLOTS, 1, HEADS, hd, PAGE,
                            SERVE_PAGES, 512, SERVE_POS)
    errs["serving context"] = check_paged_int8(torch, ops, serve)
    row |= {"splits": splits["full"][0],
            "serving_ms": time_ms(
                torch, lambda: ops.paged_attention_int8(*serve), flush),
            "serving_plain_ms": time_ms(torch, lambda: (
                ops.paged_attention_int8_reference(*serve)), flush),
            "serving_bound_ms": paged_int8_bound(serve)["bound_ms"]}
    print("paged_attention_int8: " + "; ".join(
        f"{k_} max_abs_err={e:.3e}" for k_, e in errs.items()))
    print("paged_attention_int8 splits: " + "; ".join(
        f"{k_} plan {n}, {e} (row, split) blocks with no live page"
        for k_, (n, e) in splits.items()))
    print(f"paged_attention_int8 full-width (B=8 S=1 H=4 hd=256 ps=16 P=64, "
          f"pos spread, row 0 masked): kernel_ms={row['ms']:.5f} queued_ms="
          f"{row['queued_ms']:.5f} (pages warm in L2) plain_ms="
          f"{row['plain_ms']:.5f} dequant_sdpa_ms={row['dequant_sdpa_ms']:.5f}"
          f" ({ref_diff:.3e} from the kernel) bound_ms={row['bound_ms']:.5f} "
          f"({row['bound_by']}, {row['bytes']} bytes)")
    print(f"paged_attention_int8 S=4 window at the same width: kernel_ms="
          f"{window_ms:.5f} bound_ms={window_bound['bound_ms']:.5f} "
          f"({window_bound['bytes']} bytes)")
    print(f"paged_attention_int8 all positions live (pos=1023): kernel_ms="
          f"{live_ms:.5f} bound_ms={live_bound['bound_ms']:.5f} "
          f"({live_bound['bytes']} bytes)")
    print(f"paged_attention_int8 serving context (pos "
          f"{SERVE_POS[0][0]}..{SERVE_POS[-1][0]}): kernel_ms="
          f"{row['serving_ms']:.5f} plain_ms={row['serving_plain_ms']:.5f} "
          f"bound_ms={row['serving_bound_ms']:.5f}")
    local = local_head_rows(torch, ops, flush, int8=True)
    errs |= {f"H={h}": r["max_abs_err"] for h, r in local.items()}
    return {"name": "paged_attention_int8", "route": "cuda",
            "source": "bigdl_tpu_torch/csrc/paged_attention.cu",
            "replaces": "bigdl_tpu/ops/pallas_kernels.py:1299",
            "local_heads": local,
            "max_abs_err": max(errs.values()), "ok": True, **row}


def lstm_scan_inputs(torch, g, t, b, h):
    """zx N(0, 1), wht from the LSTMCell init's U(-1/sqrt(H), 1/sqrt(H)),
    h0 in (-1, 1), c0 N(0, 1)."""
    zx = torch.randn(t, b, 4 * h, generator=g, device="cuda")
    wht = (torch.rand(h, 4 * h, generator=g, device="cuda") * 2 - 1) / h ** .5
    h0 = torch.randn(b, h, generator=g, device="cuda").tanh()
    c0 = torch.randn(b, h, generator=g, device="cuda")
    return zx, wht, h0, c0


def lstm_scan_layer_times(torch, flush, g):
    """The yardstick the port never calls: cuDNN's ``torch.nn.LSTM``, one
    direction, at the classifier's width (batch 128, T 500, 200 -> 128),
    no gradient, with the weights of the port's ``Recurrent(LSTMCell)``,
    whose no-grad forward is the projection and ``lstm_scan``."""
    from bigdl_tpu_torch.nn import LSTMCell, Recurrent
    from bigdl_tpu_torch.utils.random import generator

    port = Recurrent().add(LSTMCell(TEMBED, THIDDEN, device="cuda",
                                    generator=generator(8)))
    lib = torch.nn.LSTM(TEMBED, THIDDEN, batch_first=True).cuda()
    x = torch.randn(TBATCH, TSEQ, TEMBED, generator=g, device="cuda")
    with torch.no_grad():
        w = port.cell.w
        lib.weight_ih_l0.copy_(w[:, :TEMBED])
        lib.weight_hh_l0.copy_(w[:, TEMBED:])
        lib.bias_ih_l0.copy_(port.cell.bias)
        lib.bias_hh_l0.zero_()
        diff = float((lib(x)[0] - port(x)).abs().max())
        if diff > 1e-3:
            raise AssertionError(f"nn.LSTM is not the same layer: {diff:.3e}")
        return {"same_layer_diff": diff,
                "layer_library_ms": yard_ms(torch, lambda: lib(x), flush),
                "layer_port_ms": yard_ms(torch, lambda: port(x), flush)}


def phase_lstm_scan_kernels(torch, ops):
    """``lstm_scan`` against its plain version from non-zero h0 and c0 at
    SCAN_CASES (float64 rule where a long sum needs it), each case's
    cluster plan printed and every cluster size run; from zero state the
    same bits as ``bilstm_forward`` at D = 1, with and without the c stack
    (one kernel); H past the limit refused; times at the full width beside
    ``bilstm_forward``'s primal forward at D = 1 on the same inputs (from
    zero state) and cuDNN's no-grad layer beside the port's."""
    import importlib

    scan = importlib.import_module("bigdl_tpu_torch.ops.lstm_scan")
    g = torch.Generator(device="cuda").manual_seed(9)
    errs = {}
    for case in [c if c[2] is not None else c[:2] + (scan.MAX_HIDDEN,)
                 for c in SCAN_CASES]:
        args = lstm_scan_inputs(torch, g, *case)
        hs = ops.lstm_scan(*args)
        torch.cuda.synchronize()
        errs[case] = {"h": held(
            torch, f"lstm_scan {case} h", hs, scan.lstm_scan_reference(*args),
            scan.lstm_scan_reference(*(a.double() for a in args)),
            BILSTM_FWD_TOL)}
        del args, hs
    print_errs("lstm_scan", errs)
    covered("lstm_scan", {cluster_plan_line(
        f"lstm_scan {case}", "bilstm", "LstmFwd", scan.plan(*case[1:]),
        scan.kernel_plan(*case[1:]), 1, case[1]) for case in errs})
    for case in list(errs)[:-1]:
        zx, wht, h0, _ = lstm_scan_inputs(torch, g, *case)
        zero = torch.zeros_like(h0)
        got = ops.lstm_scan(zx, wht, zero, zero)
        hs, _ = ops.bilstm_forward(zx[:, None], wht[None])
        h_only = ops.bilstm_forward(zx[:, None], wht[None], with_c=False)
        torch.cuda.synchronize()
        if not (torch.equal(got, hs[:, 0]) and torch.equal(got, h_only[:, 0])):
            raise AssertionError(f"lstm_scan {case} from zero state is not "
                                 f"bilstm_forward's bits at D = 1")
    print(f"lstm_scan from zero state: bilstm_forward's bits at D = 1, both "
          f"modes, at {len(errs) - 1} shapes")
    h = scan.MAX_HIDDEN + 1
    refused(torch, f"lstm_scan H={h}", lambda: ops.lstm_scan(
        torch.zeros(2, 3, 4 * h, device="cuda"),
        torch.zeros(h, 4 * h, device="cuda"),
        torch.zeros(3, h, device="cuda"), torch.zeros(3, h, device="cuda")))
    flush = torch.empty(64 * 2**20, device="cuda")   # 256 MB > 50 MB L2
    full = (TSEQ, TBATCH, THIDDEN)
    zx, wht, h0, c0 = lstm_scan_inputs(torch, g, *full)
    n_h = TSEQ * TBATCH * THIDDEN
    row = recurrence_times(torch, flush, {"lstm_scan": (
        lambda: ops.lstm_scan(zx, wht, h0, c0),
        lambda: scan.lstm_scan_reference(zx, wht, h0, c0),
        4 * (zx.numel() + wht.numel() + 2 * h0.numel() + n_h),
        2 * n_h * 4 * THIDDEN)})["lstm_scan"]
    row["bilstm_forward_ms"] = time_ms(torch, lambda: ops.bilstm_forward(
        zx[:, None], wht[None], with_c=False), flush)
    row |= lstm_scan_layer_times(torch, flush, g)
    print_rows("lstm", (TSEQ, 1, TBATCH, THIDDEN), {"scan": row})
    print(f"lstm_scan layer (128, 500, 200) -> (128, 500, 128), no "
          f"gradient: port Recurrent {row['layer_port_ms']:.5f} ms, "
          f"torch.nn.LSTM (cuDNN) {row['layer_library_ms']:.5f} ms, outputs "
          f"{row['same_layer_diff']:.3e} apart")
    return {"name": "lstm_scan", "route": "cuda",
            "source": "bigdl_tpu_torch/csrc/bilstm.cu",
            "replaces": "bigdl_tpu/ops/pallas_kernels.py:117",
            "max_abs_err": max(r["h"]["err"] for r in errs.values()),
            "ok": True, **row}


def sgd_leaves(torch, g, shapes):
    return [[torch.randn(s, generator=g, device="cuda") for s in shapes]
            for _ in range(3)]


def check_sgd(torch, ops, g, shapes=None):
    """Three steps of the kernel and of the plain version on every hyper
    set, over leaves that no chunk or vector width divides (or over leaves
    of ``shapes``: a model's layout), the gradients
    moved to new memory before the last step (the cached leaf table must
    give way to a new one); then a step with the finite flag False
    changes nothing.  The device-lr form (lr read from a one-float
    tensor, as a captured graph launches it) runs beside the host-lr form
    on copies of the same leaves and must give the same bits."""
    shapes = shapes or [(130, 7), (7,), (4097,), (100,), (3, 5, 5),
                        (10001,)]
    err = 0.0
    for h in SGD_HYPERS:
        p, gr, v = sgd_leaves(torch, g, shapes)
        p2, v2 = [t.clone() for t in p], [t.clone() for t in v]
        p3, v3 = [t.clone() for t in p], [t.clone() for t in v]
        lr_dev = torch.tensor(h["lr"], dtype=torch.float32, device="cuda")
        kw = dict(momentum=h.get("momentum", 0.0),
                  weight_decay=h.get("weight_decay", 0.0),
                  dampening=h.get("dampening", 0.0),
                  nesterov=h.get("nesterov", False))
        for step in range(3):
            if step == 2:
                gr = [t.clone() for t in gr]
            ops.fused_sgd(p, gr, v, h["lr"], **kw)
            ops.fused_sgd_reference(p2, gr, v2, h["lr"], **kw)
            ops.fused_sgd(p3, gr, v3, lr_dev, **kw)
        torch.cuda.synchronize()
        for a, b, c in zip(p + v, p2 + v2, p3 + v3):
            torch.testing.assert_close(a, b, **SGD_TOL)
            torch.testing.assert_close(c, b, **SGD_TOL)
            err = max(err, float((a - b).abs().max()),
                      float((c - b).abs().max()))
            if not torch.equal(a, c):
                raise AssertionError("fused_sgd: the device-lr form's bits "
                                     "differ from the host-lr form's")
        kept = [t.clone() for t in p + v]
        ops.fused_sgd(p, gr, v, h["lr"], finite=torch.zeros(
            (), dtype=torch.bool, device="cuda"), **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(p + v, kept)):
            raise AssertionError("fused_sgd wrote on a non-finite step")
    return err


def check_sgd_scaled(torch, ops, g, shapes=None):
    """The kernel's scaled form (per-parameter learning rates) on every
    hyper set: three steps against the plain version at rates 0, 0.5
    and 2 drawn per element (the first leaf's rate one broadcast value),
    the rates moved to new memory before the last step (the cached leaf
    table must give way); an element at rate 0 keeps its bits; at
    all-ones rates its bits are the unscaled form's; a step with the
    finite flag False writes nothing."""
    shapes = shapes or [(130, 7), (7,), (4097,), (100,), (3, 5, 5),
                        (10001,)]
    rates = torch.tensor([0.0, 0.5, 2.0], device="cuda")
    err = 0.0
    for h in SGD_HYPERS:
        kw = dict(momentum=h.get("momentum", 0.0),
                  weight_decay=h.get("weight_decay", 0.0),
                  dampening=h.get("dampening", 0.0),
                  nesterov=h.get("nesterov", False))
        p, gr, v = sgd_leaves(torch, g, shapes)
        p0 = [t.clone() for t in p]
        p2, v2 = [t.clone() for t in p], [t.clone() for t in v]
        sc = [rates[torch.randint(0, 3, s, generator=g, device="cuda")]
              for s in shapes]
        sc[0] = torch.full((1,) * len(shapes[0]), 0.5, device="cuda")
        for step in range(3):
            if step == 2:
                sc = [t.clone() for t in sc]
            ops.fused_sgd(p, gr, v, h["lr"], scales=sc, **kw)
            ops.fused_sgd_reference(p2, gr, v2, h["lr"], scales=sc, **kw)
        torch.cuda.synchronize()
        for a, b in zip(p + v, p2 + v2):
            torch.testing.assert_close(a, b, **SGD_TOL)
            err = max(err, float((a - b).abs().max()))
        for a, a0, s in zip(p[1:], p0[1:], sc[1:]):
            if not torch.equal(a[s == 0], a0[s == 0]):
                raise AssertionError("fused_sgd scaled: a rate-0 element "
                                     "moved")
        q, u = [t.clone() for t in p0], [t.clone() for t in v2]
        q1, u1 = [t.clone() for t in p0], [t.clone() for t in v2]
        ones = [torch.ones(s, device="cuda") for s in shapes]
        for _ in range(3):
            ops.fused_sgd(q, gr, u, h["lr"], scales=ones, **kw)
            ops.fused_sgd(q1, gr, u1, h["lr"], **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(q + u, q1 + u1)):
            raise AssertionError("fused_sgd: the scaled form at all-ones "
                                 "rates differs from the unscaled form's "
                                 "bits")
        kept = [t.clone() for t in p + v]
        ops.fused_sgd(p, gr, v, h["lr"], scales=sc, finite=torch.zeros(
            (), dtype=torch.bool, device="cuda"), **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(p + v, kept)):
            raise AssertionError("fused_sgd scaled wrote on a non-finite "
                                 "step")
    return err


TAPS_RTOL = 1e-5   # the taps form's sums against the plain version's


def check_sgd_taps(torch, ops, g, shapes=None, hypers=SGD_HYPERS):
    """The kernel's taps form (``obs/taps.py``'s sums: g^2, p^2,
    (p' - p)^2, non-finite g) on each hyper set, unscaled and scaled
    (rates U(0, 2)): three steps beside the form without taps on copies
    of the same leaves, p' and v' bit-equal to it, each step's four sums
    within TAPS_RTOL of the plain version's (``fused_sgd_reference(...,
    taps=)``) on the same leaves; then a step with NaN and inf in the
    gradients and the finite flag False: nothing written, the non-finite
    count the plain version's, (p' - p)^2 zero.  Returns the largest
    relative error of a sum."""
    shapes = shapes or [(130, 7), (7,), (4097,), (100,), (3, 5, 5),
                        (10001,)]
    worst = 0.0
    off = torch.zeros((), dtype=torch.bool, device="cuda")
    for h in hypers:
        kw = dict(momentum=h.get("momentum", 0.0),
                  weight_decay=h.get("weight_decay", 0.0),
                  dampening=h.get("dampening", 0.0),
                  nesterov=h.get("nesterov", False))
        for scaled in (False, True):
            p, gr, v = sgd_leaves(torch, g, shapes)
            sc = ([torch.rand(s, generator=g, device="cuda") * 2
                   for s in shapes] if scaled else None)
            q, u = [t.clone() for t in p], [t.clone() for t in v]
            for _ in range(3):
                before = [t.clone() for t in p]
                vb = [t.clone() for t in v]
                got = torch.zeros(4, dtype=torch.float64, device="cuda")
                want = torch.zeros(4, dtype=torch.float64, device="cuda")
                ops.fused_sgd(p, gr, v, h["lr"], scales=sc, taps=got, **kw)
                ops.fused_sgd(q, gr, u, h["lr"], scales=sc, **kw)
                ops.fused_sgd_reference(before, gr, vb, h["lr"], scales=sc,
                                        taps=want, **kw)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(p + v, q + u)):
                    raise AssertionError(
                        f"fused_sgd taps: p', v' differ from the form "
                        f"without taps ({h}, scaled={scaled})")
                rel = ((got - want).abs() / want.abs().clamp_min(1e-30))
                worst = max(worst, float(rel[:3].max()))
                if float(rel[:3].max()) > TAPS_RTOL or got[3] != want[3]:
                    raise AssertionError(
                        f"fused_sgd taps: sums {got.tolist()} against the "
                        f"plain version's {want.tolist()} ({h}, "
                        f"scaled={scaled})")
            bad = [t.clone() for t in gr]
            bad[0].view(-1)[0] = float("nan")
            bad[-1].view(-1)[-1] = float("inf")
            kept = [t.clone() for t in p + v]
            got = torch.zeros(4, dtype=torch.float64, device="cuda")
            want = torch.zeros(4, dtype=torch.float64, device="cuda")
            ops.fused_sgd(p, bad, v, h["lr"], scales=sc, finite=off,
                          taps=got, **kw)
            ops.fused_sgd_reference([t.clone() for t in p], bad,
                                    [t.clone() for t in v], h["lr"],
                                    scales=sc, finite=off, taps=want, **kw)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(p + v, kept)):
                raise AssertionError("fused_sgd taps wrote on a non-finite "
                                     "step")
            if got[3] != want[3] or got[3] != 2 or got[2] != 0:
                raise AssertionError(f"fused_sgd taps on a non-finite step: "
                                     f"{got.tolist()}, plain "
                                     f"{want.tolist()}")
    return worst


def sgd_times(torch, ops, flush, g, shapes):
    """Kernel, plain and library (``torch.optim.SGD(fused=True).step()``,
    timing only: its first step's dampening differs) times of one step
    of the training slice's hypers over leaves of ``shapes``, and the
    byte bound: p, g, v read and p, v written, 20 bytes a parameter; then
    the scaled form's kernel and plain times (rates U(0, 2)) and its
    bound, 24 bytes a parameter (the rate read too)."""
    p, gr, v = sgd_leaves(torch, g, shapes)
    ok = torch.ones((), dtype=torch.bool, device="cuda")
    kw = dict(momentum=MOMENTUM, dampening=MOMENTUM)
    lib_params = [t.clone().requires_grad_() for t in p]
    for t, d in zip(lib_params, gr):
        t.grad = d
    lib = torch.optim.SGD(lib_params, lr=LR, fused=True, **kw)
    lib.step()   # allocates its momentum buffers
    row = timed(torch, flush,
                lambda: ops.fused_sgd(p, gr, v, LR, finite=ok, **kw),
                lambda: ops.fused_sgd_reference(p, gr, v, LR, finite=ok,
                                                **kw),
                lib.step)
    lr_dev = torch.tensor(LR, dtype=torch.float32, device="cuda")
    row["device_lr_ms"] = time_ms(torch, lambda: ops.fused_sgd(
        p, gr, v, lr_dev, finite=ok, **kw), flush)
    row["params"] = sum(t.numel() for t in p)
    row.update(byte_bound(20 * row["params"], 0))
    sc = [torch.rand(s, generator=g, device="cuda") * 2 for s in shapes]
    row["scaled_ms"] = time_ms(torch, lambda: ops.fused_sgd(
        p, gr, v, LR, finite=ok, scales=sc, **kw), flush)
    row["scaled_queued_ms"] = time_queued_ms(torch, lambda: ops.fused_sgd(
        p, gr, v, LR, finite=ok, scales=sc, **kw))
    row["scaled_plain_ms"] = yard_ms(torch, lambda: ops.fused_sgd_reference(
        p, gr, v, LR, finite=ok, scales=sc, **kw), flush)
    row["scaled_bound_ms"] = byte_bound(24 * row["params"], 0)["bound_ms"]
    # the taps form: the same 20 bytes a parameter read and written (the
    # sums' 32 bytes of atomics a block aside); its plain version the
    # unfused update and the four sums leaf by leaf
    buf = torch.zeros(4, dtype=torch.float64, device="cuda")
    row["taps_ms"] = time_ms(torch, lambda: ops.fused_sgd(
        p, gr, v, LR, finite=ok, taps=buf, **kw), flush)
    row["taps_queued_ms"] = time_queued_ms(torch, lambda: ops.fused_sgd(
        p, gr, v, LR, finite=ok, taps=buf, **kw))
    row["taps_plain_ms"] = yard_ms(torch, lambda: ops.fused_sgd_reference(
        p, gr, v, LR, finite=ok, taps=buf, **kw), flush)
    row["taps_bound_ms"] = row["bound_ms"]
    # in turns with the form without taps, L2 flushed: their ratio
    pair = [time_ms(torch, lambda: ops.fused_sgd(
        p, gr, v, LR, finite=ok, taps=t, **kw), flush, reps=10)
        for t in (None, buf, buf, None)]
    row["taps_ratio"] = (pair[1] + pair[2]) / (pair[0] + pair[3])
    return row


def phase_train_kernels(torch, ops):
    """The training slice's kernels against their plain versions, with
    times at LeNet's shapes and at larger shapes models of the repo have:
    Inception-v1's first pool at batch 32 (the rows' shape) and its four
    3x3 s2 pools at batch 128, the BN paths' pools (VGG's, ResNet-50's,
    model_zoo's), the serving model's parameters; ``fused_sgd`` also over
    VGG's and ResNet-50's layouts."""
    from bigdl_tpu_torch.models.inception import Inception_v1
    from bigdl_tpu_torch.models.lenet import LeNet5
    from bigdl_tpu_torch.models.resnet import ResNet
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.models.vgg import VggForCifar10

    g = torch.Generator(device="cuda").manual_seed(1)
    errs = [check_pool(torch, ops, g, *case)
            for case in POOL_CASES + INCEPTION_POOLS + BN_POOLS
            + PIPE_POOLS + PIPE_DP_POOLS]
    errs += [check_pool(torch, ops, g, *POOL_CASES[k], nan=True)
             for k in NAN_POOL_CASES]
    # the BN paths' layouts: VGG's 58 leaves, ResNet-50's 161
    vgg = [tuple(p.shape) for p in VggForCifar10(10, device="meta")
           .parameters()]
    r50 = [tuple(p.shape) for p in ResNet(50, ICLASSES, device="meta")
           .parameters()]
    sgd_err = max(check_sgd(torch, ops, g, shapes)
                  for shapes in (None, vgg, r50))
    # the scaled form at the kernel phase's leaves and at Inception-v1's
    # layout (the fine-tune's, harness_api)
    inception = [tuple(p.shape) for p in Inception_v1(
        ICLASSES, device="meta").parameters()]
    scaled_err = max(check_sgd_scaled(torch, ops, g, shapes)
                     for shapes in (None, inception))
    sgd_err = max(sgd_err, scaled_err)
    # the taps form at the odd leaves on every hyper set, and at serving's
    # layout on the training slice's two (momentum, and nesterov with
    # weight decay)
    serving = [tuple(p.shape) for p in TransformerLM(
        VOCAB, D_MODEL, HEADS, LAYERS, HIDDEN, dropout=0.0,
        device="meta").parameters()]
    taps_rel = max(check_sgd_taps(torch, ops, g),
                   check_sgd_taps(torch, ops, g, serving,
                                  [SGD_HYPERS[3], SGD_HYPERS[5]]))
    flush = torch.empty(64 * 2**20, device="cuda")   # 256 MB > 50 MB L2
    sums = {}
    for case in POOL_CASES[-3:] + INCEPTION_POOLS + BN_POOLS + PIPE_POOLS:
        rows = pool_times(torch, ops, flush, g, *case)
        for name, row in zip(("forward", "backward"), rows):
            print_pool_row(f"maxpool2d_{name}", case, row)
            if case in INCEPTION_POOLS:
                step_sum(sums, name, row, 1)
            if case in VGG_POOLS:
                step_sum(sums, name, row, 1, "vgg")
            if case == RESNET50_POOL:
                step_sum(sums, name, row, 1, "resnet50")
            if case in PIPE_POOLS:
                step_sum(sums, name, row, PMICRO, "vgg_pipe")
        if case == POOL_CASES[-1]:
            fwd, bwd = rows   # the rows' shape
    lenet = [tuple(p.shape) for p in LeNet5(device="cuda").parameters()]
    for shapes in (lenet, vgg, r50, serving):   # the row: serving's
        sgd = sgd_times(torch, ops, flush, g, shapes)
        print(f"fused_sgd {sgd['params']} params in {len(shapes)} leaves: "
              f"kernel_ms={sgd['ms']:.5f} device_lr_ms="
              f"{sgd['device_lr_ms']:.5f} plain_ms={sgd['plain_ms']:.5f} "
              f"library_ms={sgd['library_ms']:.5f} "
              f"bound_ms={sgd['bound_ms']:.5f} ({20 * sgd['params']} bytes) "
              f"queued_ms={sgd['queued_ms']:.5f}; scaled form: "
              f"kernel_ms={sgd['scaled_ms']:.5f} queued_ms="
              f"{sgd['scaled_queued_ms']:.5f} plain_ms="
              f"{sgd['scaled_plain_ms']:.5f} bound_ms="
              f"{sgd['scaled_bound_ms']:.5f} ({24 * sgd['params']} bytes); "
              f"taps form: kernel_ms={sgd['taps_ms']:.5f} queued_ms="
              f"{sgd['taps_queued_ms']:.5f} plain_ms="
              f"{sgd['taps_plain_ms']:.5f} bound_ms="
              f"{sgd['taps_bound_ms']:.5f}, {sgd['taps_ratio']:.4f}x the "
              f"form without taps (turns off, on, on, off)")
    for name, row in (("forward", fwd), ("backward", bwd)):
        row.update(sums[name])
    fwd_err = max(e[0] for e in errs)
    bwd_err = max(e[1] for e in errs)
    n_tied = (len(POOL_CASES) + len(INCEPTION_POOLS) + len(BN_POOLS)
              + len(PIPE_POOLS) + len(PIPE_DP_POOLS))
    print(f"maxpool2d: {n_tied} geometries with ties and "
          f"{len(NAN_POOL_CASES)} with NaNs, forward and argmax equal, "
          f"backward max_abs_err={bwd_err:.3e}; fused_sgd: "
          f"{len(SGD_HYPERS)} hyper sets x 3 steps over 6 odd leaves, "
          f"VGG's {len(vgg)} and ResNet-50's {len(r50)}, the scaled form "
          f"over the 6 leaves and Inception-v1's {len(inception)}, "
          f"max_abs_err={sgd_err:.3e} (scaled {scaled_err:.3e}), the "
          f"device-lr form bit-equal to the host-lr form, the scaled form "
          f"at all-ones rates bit-equal to the unscaled form, a rate-0 "
          f"element unmoved, a non-finite step writes nothing; the taps "
          f"form on the 6 hyper sets unscaled and scaled at the 6 leaves "
          f"and on 2 at serving's {len(serving)} leaves: p', v' bit-equal "
          f"to the form without taps, the sums within "
          f"{taps_rel:.3e} relative of the plain version's (limit "
          f"{TAPS_RTOL}), a non-finite step writes nothing and counts its "
          f"NaN and inf")
    common = {"route": "cuda", "ok": True}
    pool_src = {"source": "bigdl_tpu_torch/csrc/maxpool2d.cu"}
    return [
        {"name": "fused_sgd", "source": "bigdl_tpu_torch/csrc/fused_sgd.cu",
         "replaces": "bigdl_tpu/ops/pallas_kernels.py:59",
         "max_abs_err": sgd_err, "taps_max_rel_err": taps_rel, **common,
         **sgd},
        {"name": "maxpool2d_forward", **pool_src,
         "replaces": "bigdl_tpu/ops/pallas_kernels.py:1162",
         "max_abs_err": fwd_err, **common, **fwd},
        {"name": "maxpool2d_backward", **pool_src,
         "replaces": "bigdl_tpu/ops/pallas_kernels.py:1202",
         "max_abs_err": bwd_err, **common, **bwd},
    ]


def lenet_run(torch, device, init_tree, end_trigger, validate=True,
              distributed=False):
    """``examples/train_lenet.py`` on synthetic MNIST, from ``init_tree``:
    an optimizer ready to run (``--distributed``: the training set
    sharded over the ranks, a ``DistriOptimizer``)."""
    from bigdl_tpu_torch.dataset import (DataSet, ImgNormalizer, ImgToBatch,
                                         mnist)
    from bigdl_tpu_torch.models.lenet import LeNet5
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import Optimizer, Top1Accuracy, every_epoch
    from bigdl_tpu_torch.utils.table import T

    norm = ImgNormalizer(mnist.TRAIN_MEAN, mnist.TRAIN_STD)
    train = DataSet.array(mnist.synthetic(N_TRAIN),
                          distributed=distributed) >> norm >> ImgToBatch(
        BATCH)
    model = LeNet5(10, device=device).load_params(init_tree)
    # the optimizer's own default method, SGD
    opt = Optimizer(model, train, ClassNLLCriterion(),
                    state=T(learningRate=LR, momentum=MOMENTUM),
                    end_trigger=end_trigger, device=device)
    if validate:
        val = (DataSet.array(mnist.synthetic(N_VAL, seed=1)) >> norm
               >> ImgToBatch(BATCH))
        opt.set_validation(every_epoch(), val, [Top1Accuracy()])
    return opt


def phase_train(torch, ops, profile: bool):
    from bigdl_tpu_torch.models.lenet import LeNet5
    from bigdl_tpu_torch.nn.module import export_params
    from bigdl_tpu_torch.optim import max_epoch, max_iteration
    from bigdl_tpu_torch.utils.random import generator

    init = export_params(LeNet5(10, device="cuda", generator=generator(0)))
    # warm-up: cuDNN's algorithm choice, allocator, kernel library loads
    lenet_run(torch, "cuda", init, max_iteration(3)).optimize()
    opt = lenet_run(torch, "cuda", init, max_epoch(EPOCHS))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    opt.optimize()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    steps = int(opt.state["neval"]) - 1
    val_batches = len(opt.validation_log) * -(-N_VAL // BATCH)
    want = {"fused_sgd": steps, "maxpool2d_backward": 2 * steps,
            "maxpool2d_forward": 2 * steps + 2 * val_batches}
    if steps != EPOCHS * N_TRAIN // BATCH or any(
            counts[k] != n for k, n in want.items()):
        raise AssertionError(f"training launches {counts} after {steps} "
                             f"steps and {val_batches} validation batches, "
                             f"expected {want}")
    losses = [l for _, l in opt.loss_log]
    if len(losses) != steps or not np.isfinite(losses).all():
        raise AssertionError(f"training losses: {losses}")
    val_s = opt.metrics.get("validate")[0]
    step_ms = (wall - val_s) / steps * 1e3
    top1 = " ".join(f"epoch {e - 1}: {v['Top1Accuracy']:.4f}"
                    for _, e, v in opt.validation_log[1:])
    print(f"train: LeNet5 {sum(p.numel() for p in opt.model.parameters())} "
          f"params, {steps} steps of {BATCH} over {EPOCHS} epochs, "
          f"{len(opt.validation_log)} validations of {val_batches // len(opt.validation_log)} "
          f"batches; wall {wall:.4f} s, {steps * BATCH / wall:.1f} images/s "
          f"(validation included), {step_ms:.4f} ms/step (validation "
          f"{val_s:.4f} s excluded), {opt.host_syncs} host syncs of the "
          f"loop + {val_batches} validation reads, max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} B; launches {counts}; "
          f"losses {losses[0]:.6f} -> {losses[-1]:.6f}; Top1 {top1}")

    # the same run on the CPU: plain versions, same params and batches
    cpu = lenet_run(torch, "cpu", init, max_epoch(EPOCHS))
    cpu.optimize()
    print(f"train vs CPU: Top1 card {[v for _, _, v in opt.validation_log]} "
          f"CPU {[v for _, _, v in cpu.validation_log]}")
    held_to_cpu_run(torch, "train", opt, cpu)
    if profile:
        busy_ms = profile_train(torch, lambda end: lenet_run(
            torch, "cuda", init, end, validate=False), 16)
        print(f"profile: device idle share of the unprofiled train step "
              f"{1 - busy_ms / step_ms:.4f} ({busy_ms:.4f} of "
              f"{step_ms:.4f} ms/step busy)")
    return counts


def profile_train(torch, make_opt, n):
    """Device time by kernel over a window of ``n`` train steps
    (READ["train_profiled"] where it is set; no validation) of the
    optimizer ``make_opt(end_trigger)`` builds, after two warm steps."""
    from torch.profiler import ProfilerActivity, profile

    from bigdl_tpu_torch.optim import max_iteration

    n = READ["train_profiled"] or n
    opt = make_opt(max_iteration(2))
    opt.optimize()
    opt.set_end_when(max_iteration(2 + n))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        opt.optimize()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda e: -e.device_time_total)
    busy = sum(e.device_time_total for e in rows) / 1e3   # ms
    print(f"profile: {n} train steps, wall under the profiler "
          f"{wall * 1e3:.3f} ms ({wall / n * 1e3:.4f} ms/step), device busy "
          f"{busy:.3f} ms ({busy / n:.4f} ms/step, "
          f"{sum(e.count for e in rows) / n:.1f} device ops/step)")
    # the twelve largest, then the port's own kernels among the rest
    # (each csrc/ kernel lives in an anonymous namespace)
    own = [e for e in rows[12:] if "(anonymous namespace)::" in e.key]
    for e in rows[:12] + own:
        print(f"profile:   {e.device_time_total / n:9.2f} us/step "
              f"{e.count / n:5.1f}/step  {e.key[:80]}")
    bn = [e for e in rows if is_bn_kernel(e.key)]
    if bn:
        bn_ms = sum(e.device_time_total for e in bn) / 1e3
        print(f"profile: batch-norm kernels {bn_ms / n:.4f} ms/step, "
              f"{sum(e.count for e in bn) / n:.1f} launches/step, "
              f"{bn_ms / busy:.4f} of device time; by name "
              + ", ".join(f"{e.key[:60]} {e.device_time_total / n:.2f} "
                          f"us/step" for e in bn[:6]))
    return busy / n


def is_bn_kernel(name):
    """Whether the profiler's kernel ``name`` is one of batch
    normalisation's (cuDNN's ``bn_fw_*`` / ``bn_bw_*`` or ATen's
    ``batch_norm_*``)."""
    low = name.lower()
    return any(part in low for part in BN_KERNEL_PARTS)


def inception_images(n, size, seed):
    """examples/train_inception.py:55-58 (``--synthetic``): ``n`` RGB
    images of ``size`` x ``size``, uniform [0, 255), labels 1..1000."""
    from bigdl_tpu_torch.dataset import LabeledImage

    rng = np.random.RandomState(seed)
    return [LabeledImage(rng.uniform(0, 255, (size, size, 3)),
                         rng.randint(1, ICLASSES + 1)) for _ in range(n)]


def inception_run(torch, device, init_tree, images, batch, end_trigger,
                  val_images=None, dropout=None, distributed=False,
                  **distri):
    """examples/train_inception.py:59-82 from ``init_tree``: random
    224 crops, flips and the mean subtraction over ``images``, the SGD
    state with Poly(0.5, ISTEPS); validation (Top1, Top5) after ISTEPS
    iterations when ``val_images`` are given.  An optimizer ready to
    run: with ``distributed``, the example's own ``DataSet.array(data,
    distributed=True)``, so a ``DistriOptimizer`` (``distri``: its
    arguments)."""
    from bigdl_tpu_torch.dataset import (DataSet, HFlip, ImgNormalizer,
                                         ImgRdmCropper, ImgToBatch)
    from bigdl_tpu_torch.models.inception import Inception_v1
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import (Optimizer, Poly, Top1Accuracy,
                                       Top5Accuracy, several_iteration)
    from bigdl_tpu_torch.utils.table import T

    norm = ImgNormalizer((123.0, 117.0, 104.0), (1.0, 1.0, 1.0))
    train = (DataSet.array(images, distributed=distributed)
             >> ImgRdmCropper(ICROP, ICROP) >> HFlip() >> norm
             >> ImgToBatch(batch))
    model = Inception_v1(ICLASSES, device=device).load_params(init_tree)
    if dropout is not None:
        set_dropout(model, dropout)
    opt = Optimizer(model, train, ClassNLLCriterion(), state=T(
        learningRate=ILR, weightDecay=IWD, momentum=0.9, dampening=0.0,
        learningRateSchedule=Poly(0.5, ISTEPS)), end_trigger=end_trigger,
        device=device, **distri)
    if val_images is not None:
        val = DataSet.array(val_images) >> norm >> ImgToBatch(batch)
        opt.set_validation(several_iteration(ISTEPS), val,
                           [Top1Accuracy(), Top5Accuracy()])
    return opt


def phase_inception(torch, ops, profile: bool):
    """Inception-v1 trains at full width on the card through
    ``Optimizer(...).optimize()``; the launch counts show every LRN,
    pool and update went through its kernel; the same few steps on the
    CPU at batch 16 give the same losses and parameters."""
    from bigdl_tpu_torch.models.inception import Inception_v1
    from bigdl_tpu_torch.nn.module import export_params
    from bigdl_tpu_torch.optim import max_iteration
    from bigdl_tpu_torch.utils.random import RNG, generator

    init = export_params(Inception_v1(ICLASSES, device="cpu",
                                      generator=generator(0)))
    n_params = sum(v.size for v in _leaves(init))
    if n_params != IPARAMS:
        raise AssertionError(f"Inception-v1 has {n_params} parameters, "
                             f"expected {IPARAMS}")
    t0 = time.perf_counter()
    images = inception_images(IMAGES, ISIZE, 0)
    val_images = inception_images(IVAL, ICROP, 1)
    make_s = time.perf_counter() - t0
    RNG.set_seed(0)   # the dropout masks
    # warm-up: cuDNN's algorithm choice, allocator, kernel library loads
    inception_run(torch, "cuda", init, images, IBATCH,
                  max_iteration(2)).optimize()
    opt = inception_run(torch, "cuda", init, images, IBATCH,
                        max_iteration(ISTEPS), val_images)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    opt.optimize()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    steps = int(opt.state["neval"]) - 1
    val_batches = len(opt.validation_log) * -(-IVAL // IBATCH)
    want = {**untapped(counts), "fused_sgd": steps,
            "lrn_forward": 2 * steps + 2 * val_batches,
            "lrn_backward": 2 * steps,
            "maxpool2d_s1_forward": 9 * steps + 9 * val_batches,
            "maxpool2d_s1_backward": 9 * steps,
            "maxpool2d_forward": 4 * steps + 4 * val_batches,
            "maxpool2d_backward": 4 * steps}
    if steps != ISTEPS or val_batches != 2 or counts != want:
        raise AssertionError(f"Inception launches {counts} after {steps} "
                             f"steps and {val_batches} validation batches, "
                             f"expected {want}")
    losses = [l for _, l in opt.loss_log]
    if len(losses) != steps or not np.isfinite(losses).all():
        raise AssertionError(f"Inception losses: {losses}")
    val_s = opt.metrics.get("validate")[0]
    step_ms = (wall - val_s) / steps * 1e3
    fetch_s, fetches = opt.metrics.get("data fetch time")
    dispatch_s, _ = opt.metrics.get("train time")
    (_, _, val), = opt.validation_log
    print(f"inception: Inception-v1 {n_params} params, {steps} steps of "
          f"{IBATCH} at {ICROP}x{ICROP} over {IMAGES} synthetic "
          f"{ISIZE}x{ISIZE} images (made in {make_s:.2f} s), 1 validation "
          f"of {val_batches} batches; wall {wall:.4f} s, {step_ms:.4f} "
          f"ms/step and {steps * IBATCH / (wall - val_s):.1f} images/s "
          f"(validation {val_s:.4f} s excluded); host: dataset iterator "
          f"and H2D copy {fetch_s / fetches * 1e3:.4f} ms/batch "
          f"({fetch_s / (wall - val_s):.4f} of the loop), dispatch "
          f"{dispatch_s / steps * 1e3:.4f} ms/step; "
          f"max_memory_allocated {torch.cuda.max_memory_allocated()} B; "
          f"launches {counts}; losses {losses[0]:.6f} -> {losses[-1]:.6f}; "
          f"Top1 {val['Top1Accuracy']:.4f} Top5 {val['Top5Accuracy']:.4f}")

    check = inception_images(ICHECK_BATCH * ICHECK_STEPS, ISIZE, 2)
    diff = card_vs_cpu(torch, init, lambda device: inception_run(
        torch, device, init, check, ICHECK_BATCH,
        max_iteration(ICHECK_STEPS), dropout=0.0))
    print_vs_cpu("inception", ICHECK_BATCH, diff, IPARAM_ATOL)
    if profile:
        busy_ms = profile_train(torch, lambda end: inception_run(
            torch, "cuda", init, images, IBATCH, end), 5)
        print(f"profile: device idle share of the unprofiled Inception "
              f"train step {1 - busy_ms / step_ms:.4f} ({busy_ms:.4f} of "
              f"{step_ms:.4f} ms/step busy)")
    held_vs_cpu("Inception", diff, IPARAM_ATOL)
    return counts


def text_docs(n, seed=0):
    """examples/text_classifier.py:56-64, its synthetic corpus: class
    means from N(0, 1) in embedding space, each document TSEQ embeddings
    of N(0, 0.25) about its class's mean, label c + 1."""
    from bigdl_tpu_torch.dataset import Sample

    rng = np.random.RandomState(seed)
    means = rng.randn(TCLASSES, TEMBED)
    docs = []
    for i in range(n):
        c = i % TCLASSES
        doc = (rng.randn(TSEQ, TEMBED) * 0.5 + means[c]).astype(np.float32)
        docs.append(Sample(doc, np.asarray([c + 1.0])))
    return docs


def bilstm_run(torch, device, init_tree, docs, batch, end_trigger,
               val_docs=None, build=None):
    """examples/text_classifier.py:66-82 with ``--model lstm`` from
    ``init_tree``: batches of ``batch`` (the tail dropped),
    ``ClassNLLCriterion``, SGD at lr 0.01 and momentum 0.9, Top1 every
    epoch when ``val_docs`` are given.  ``build(device)`` makes the model
    (default ``TextClassifierBiLSTM``).  An optimizer ready to run."""
    from bigdl_tpu_torch.dataset import DataSet, SampleToBatch
    from bigdl_tpu_torch.models.textclassifier import TextClassifierBiLSTM
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import Optimizer, Top1Accuracy, every_epoch
    from bigdl_tpu_torch.utils.table import T

    if build is None:
        build = lambda dev: TextClassifierBiLSTM(TCLASSES, TEMBED, THIDDEN,
                                                 device=dev)
    train = DataSet.array(docs) >> SampleToBatch(batch, drop_last=True)
    model = build(device).load_params(init_tree)
    opt = Optimizer(model, train, ClassNLLCriterion(),
                    state=T(learningRate=TLR, momentum=0.9),
                    end_trigger=end_trigger, device=device)
    if val_docs is not None:
        val = DataSet.array(val_docs) >> SampleToBatch(batch, drop_last=True)
        opt.set_validation(every_epoch(), val, [Top1Accuracy()])
    return opt


def phase_bilstm(torch, ops, profile: bool):
    """The Bi-LSTM text classifier trains at full width on the card
    through ``Optimizer(...).optimize()``; the launch counts show every
    recurrence and update went through its kernel; three steps at batch
    16 equal the same steps on the CPU."""
    from bigdl_tpu_torch.models.textclassifier import TextClassifierBiLSTM
    from bigdl_tpu_torch.nn.module import export_params
    from bigdl_tpu_torch.optim import max_epoch, max_iteration
    from bigdl_tpu_torch.utils.random import generator

    init = export_params(TextClassifierBiLSTM(
        TCLASSES, TEMBED, THIDDEN, device="cpu", generator=generator(0)))
    n_params = sum(v.size for v in _leaves(init))
    if n_params != TPARAMS:
        raise AssertionError(f"TextClassifierBiLSTM has {n_params} "
                             f"parameters, expected {TPARAMS}")
    t0 = time.perf_counter()
    docs = text_docs(TDOCS)
    make_s = time.perf_counter() - t0
    split = int(len(docs) * 0.8)
    train, val = docs[:split], docs[split:]
    # warm-up: cuBLAS handles, allocator, kernel library loads
    bilstm_run(torch, "cuda", init, train, TBATCH, max_iteration(2)).optimize()
    opt = bilstm_run(torch, "cuda", init, train, TBATCH, max_epoch(TEPOCHS),
                     val)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    opt.optimize()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    steps = int(opt.state["neval"]) - 1
    val_batches = len(opt.validation_log) * (len(val) // TBATCH)
    want = {**untapped(counts), "fused_sgd": steps,
            "bilstm_forward": steps + val_batches,
            "bilstm_backward": steps, "bilstm_dwh": steps}
    if steps != TEPOCHS * (split // TBATCH) or counts != want:
        raise AssertionError(f"Bi-LSTM launches {counts} after {steps} "
                             f"steps and {val_batches} validation batches, "
                             f"expected {want}")
    losses = [l for _, l in opt.loss_log]
    if len(losses) != steps or not np.isfinite(losses).all():
        raise AssertionError(f"Bi-LSTM losses: {losses}")
    val_s = opt.metrics.get("validate")[0]
    loop_s = wall - val_s
    fetch_s, fetches = opt.metrics.get("data fetch time")
    dispatch_s, _ = opt.metrics.get("train time")
    top1 = " ".join(f"{v['Top1Accuracy']:.4f}" for _, _, v in
                    opt.validation_log)
    step_ms = loop_s / steps * 1e3
    print(f"bilstm: TextClassifierBiLSTM {n_params} params, {steps} steps "
          f"of {TBATCH} x {TSEQ} x {TEMBED} over {split} synthetic "
          f"documents (made in {make_s:.2f} s), {len(opt.validation_log)} "
          f"validations of {len(val) // TBATCH} batches; wall {wall:.4f} s, "
          f"{step_ms:.4f} ms/step and {steps * TBATCH * TSEQ / loop_s:.1f} "
          f"tokens/s (validation {val_s:.4f} s excluded); host: dataset "
          f"iterator and H2D copy {fetch_s / fetches * 1e3:.4f} ms/batch "
          f"({fetch_s / loop_s:.4f} of the loop), dispatch "
          f"{dispatch_s / steps * 1e3:.4f} ms/step; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} B; launches {counts}; "
          f"losses {' '.join(f'{l:.6f}' for l in losses)}; Top1 {top1}")

    check = train[:TCHECK_BATCH * TCHECK_STEPS]
    diff = card_vs_cpu(torch, init, lambda device: bilstm_run(
        torch, device, init, check, TCHECK_BATCH,
        max_iteration(TCHECK_STEPS)))
    print_vs_cpu("bilstm", TCHECK_BATCH, diff, PARAM_ATOL)
    if profile:
        busy_ms = profile_train(torch, lambda end: bilstm_run(
            torch, "cuda", init, train, TBATCH, end), 5)
        print(f"profile: device idle share of the unprofiled Bi-LSTM train "
              f"step {1 - busy_ms / step_ms:.4f} ({busy_ms:.4f} of "
              f"{step_ms:.4f} ms/step busy)")
    held_vs_cpu("Bi-LSTM", diff)
    return counts


def rnn_corpus(n, seed=0):
    """``n`` synthetic lines for examples/train_rnn.py: 6 to 14 words
    each, drawn uniformly from 6,000 made-up words, so that more than
    RVOCAB distinct words occur and the dictionary is full width."""
    rng = np.random.RandomState(seed)
    return [" ".join(f"w{k}" for k in rng.randint(0, 6000,
                                                  rng.randint(6, 15)))
            for _ in range(n)]


def rnn_data(lines):
    """examples/train_rnn.py:70-80: the tokens, the dictionary and the
    vocabulary (with the OOV bucket)."""
    from bigdl_tpu_torch.dataset.text import Dictionary, WordTokenizer

    tokens = list(WordTokenizer()(iter(lines)))
    dictionary = Dictionary(tokens, vocab_size=RVOCAB)
    return tokens, dictionary, dictionary.vocab_size() + 1


def rnn_run(torch, device, init_tree, tokens, dictionary, end_trigger,
            bptt=RBPTT, build=None):
    """examples/train_rnn.py:76-89 from ``init_tree``: one-hot words of
    ``seqLength`` 8 in batches of 4, ``SimpleRNN`` with ``bptt`` (or
    ``build(vocab, device)``),
    ``TimeDistributedCriterion(ClassNLLCriterion(), size_average=True)``,
    SGD at lr 0.1, one iteration a dispatch, through ``Optimizer(...)``
    (a ``LocalOptimizer`` for this dataset).  An optimizer ready to
    run."""
    from bigdl_tpu_torch.dataset import DataSet, SampleToBatch
    from bigdl_tpu_torch.dataset.text import (LabeledSentenceToSample,
                                              SentenceToLabeledSentence)
    from bigdl_tpu_torch.models.rnn import SimpleRNN
    from bigdl_tpu_torch.nn import (ClassNLLCriterion,
                                    TimeDistributedCriterion)
    from bigdl_tpu_torch.optim import Optimizer
    from bigdl_tpu_torch.utils.table import T

    vocab = dictionary.vocab_size() + 1
    ds = (DataSet.array(tokens)
          >> SentenceToLabeledSentence(dictionary)
          >> LabeledSentenceToSample(n_input_dims=vocab, fixed_length=RSEQ)
          >> SampleToBatch(RBATCH))
    model = (SimpleRNN(vocab, RHIDDEN, vocab, bptt_truncate=bptt,
                       device=device) if build is None
             else build(vocab, device)).load_params(init_tree)
    opt = Optimizer(model, ds, TimeDistributedCriterion(
        ClassNLLCriterion(), size_average=True), device=device)
    opt.set_state(T(learningRate=RLR)).set_end_when(end_trigger)
    return opt.set_iterations_per_dispatch(1)


def run_path(torch, ops, fn):
    """``fn()`` with every launch count set to 0 just before it; (its
    result, the counts read just after, wall seconds)."""
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, ops.launch_counts(), time.perf_counter() - t0


def phase_simple_rnn(torch, ops, profile: bool):
    """examples/train_rnn.py's defaults at full width on the card: 2
    epochs at bptt 4 (two kernel calls a step), a short run at bptt 8 (the
    whole sequence in one call), then 20 generated words; the launch
    counts of each, three steps against the CPU and the generated words
    against the CPU's from the same parameters and draws."""
    from bigdl_tpu_torch.models.rnn import SimpleRNN, generate
    from bigdl_tpu_torch.nn.module import export_params
    from bigdl_tpu_torch.optim import max_epoch, max_iteration
    from bigdl_tpu_torch.utils.random import generator

    t0 = time.perf_counter()
    tokens, dictionary, vocab = rnn_data(rnn_corpus(RSENTENCES))
    make_s = time.perf_counter() - t0
    if vocab != RVOCAB + 1:
        raise AssertionError(f"the dictionary holds {vocab - 1} words, not "
                             f"{RVOCAB}")
    init = export_params(SimpleRNN(vocab, RHIDDEN, vocab, RBPTT, device="cpu",
                                   generator=generator(0)))
    n_params = sum(v.size for v in _leaves(init))
    # warm-up: cuBLAS handles, allocator, kernel library loads
    rnn_run(torch, "cuda", init, tokens, dictionary, max_iteration(2)).optimize()
    opt = rnn_run(torch, "cuda", init, tokens, dictionary, max_epoch(REPOCHS))
    torch.cuda.reset_peak_memory_stats()
    _, counts, wall = run_path(torch, ops, opt.optimize)
    steps = int(opt.state["neval"]) - 1
    batches = -(-len(tokens) // RBATCH)
    want = {**untapped(counts), "fused_sgd": steps,
            "rnn_forward": 2 * steps, "rnn_backward": 2 * steps,
            "rnn_dwh": 2 * steps}
    if steps != REPOCHS * batches or counts != want:
        raise AssertionError(f"SimpleRNN launches {counts} after {steps} "
                             f"steps, expected {want}")
    losses = [l for _, l in opt.loss_log]
    if len(losses) != steps or not np.isfinite(losses).all():
        raise AssertionError(f"SimpleRNN losses: {losses}")
    fetch_s, fetches = opt.metrics.get("data fetch time")
    dispatch_s, _ = opt.metrics.get("train time")
    step_ms = wall / steps * 1e3
    first = np.mean(losses[:batches])
    last = np.mean(losses[-batches:])
    print(f"simple_rnn: SimpleRNN {n_params} params ({vocab} words in and "
          f"out, hidden {RHIDDEN}), {steps} steps of {RBATCH} x {RSEQ} at "
          f"bptt {RBPTT} over {len(tokens)} synthetic sentences (made in "
          f"{make_s:.2f} s), {REPOCHS} epochs; wall {wall:.4f} s, "
          f"{step_ms:.4f} ms/step, {steps * RBATCH * RSEQ / wall:.1f} "
          f"words/s; host: dataset iterator and H2D copy "
          f"{fetch_s / fetches * 1e3:.4f} ms/batch ({fetch_s / wall:.4f} of "
          f"the loop), dispatch {dispatch_s / steps * 1e3:.4f} ms/step; "
          f"max_memory_allocated {torch.cuda.max_memory_allocated()} B; "
          f"launches {counts}; mean loss epoch 1 {first:.6f}, epoch "
          f"{REPOCHS} {last:.6f}")
    if not last < first:
        raise AssertionError("SimpleRNN: the loss did not fall")

    # the whole sequence in one kernel call
    opt8 = rnn_run(torch, "cuda", init, tokens, dictionary, max_iteration(8),
                   bptt=RSEQ)
    _, counts8, wall8 = run_path(torch, ops, opt8.optimize)
    want8 = {**untapped(counts8), "fused_sgd": 8, "rnn_forward": 8,
             "rnn_backward": 8, "rnn_dwh": 8}
    if counts8 != want8:
        raise AssertionError(f"SimpleRNN at bptt {RSEQ}: launches {counts8}, "
                             f"expected {want8}")
    print(f"simple_rnn bptt {RSEQ}: 8 steps, {wall8 / 8 * 1e3:.4f} ms/step, "
          f"launches {counts8}")

    # generation from the first sentence, on the card and on the CPU
    seed = [dictionary.index(w) for w in tokens[0]]
    trained = export_params(opt.model)
    ids, counts_g, wall_g = run_path(torch, ops, lambda: generate(
        opt.model, dictionary, seed, RWORDS, np.random.RandomState(0)))
    cpu_model = SimpleRNN(vocab, RHIDDEN, vocab, RBPTT, device="cpu")
    cpu_ids = generate(cpu_model.load_params(trained), dictionary, seed,
                       RWORDS, np.random.RandomState(0))
    want_g = {**untapped(counts_g), "rnn_forward": RWORDS}
    if counts_g != want_g or len(ids) != len(seed) + RWORDS:
        raise AssertionError(f"generate: launches {counts_g}, expected "
                             f"{want_g}, {len(ids)} ids")
    if ids != cpu_ids:
        raise AssertionError(f"generate: the card's words {ids[len(seed):]} "
                             f"are not the CPU's {cpu_ids[len(seed):]}")
    print(f"generate: seed of {len(seed)} words + {RWORDS} sampled, "
          f"{wall_g / RWORDS * 1e3:.4f} ms/word, equal to the CPU's; "
          f"launches {counts_g}; "
          f"{' '.join(dictionary.word(i) for i in ids[len(seed):])}")

    diff = card_vs_cpu(torch, init, lambda device: rnn_run(
        torch, device, init, tokens, dictionary,
        max_iteration(RCHECK_STEPS)))
    print_vs_cpu("simple_rnn", RBATCH, diff, PARAM_ATOL)
    if profile:
        busy_ms = profile_train(torch, lambda end: rnn_run(
            torch, "cuda", init, tokens, dictionary, end), 32)
        print(f"profile: device idle share of the unprofiled SimpleRNN "
              f"train step {1 - busy_ms / step_ms:.4f} ({busy_ms:.4f} of "
              f"{step_ms:.4f} ms/step busy)")
    held_vs_cpu("SimpleRNN", diff)
    return {"simple_rnn": counts, f"simple_rnn_bptt{RSEQ}": counts8,
            "generate": counts_g}


def gru_classifier(device, generator=None, bptt=0):
    """The Bi-LSTM classifier's composition with GRU cells, from the
    package's public modules: 280,392 parameters at (20, 200, 128), the
    recurrence truncated every ``bptt`` steps (0: not)."""
    from bigdl_tpu_torch import nn

    kw = dict(device=device, generator=generator)
    return nn.Sequential(
        nn.BiRecurrent(nn.GRUCell(TEMBED, THIDDEN, **kw),
                       nn.GRUCell(TEMBED, THIDDEN, **kw),
                       bptt_truncate=bptt),
        nn.Mean(1, n_input_dims=2),
        nn.Linear(2 * THIDDEN, 100, **kw), nn.ReLU(),
        nn.Linear(100, TCLASSES, **kw), nn.LogSoftMax())


def phase_gru(torch, ops, profile: bool):
    """The GRU classifier trains one epoch of the Bi-LSTM phase's
    documents at full width (Top1 every epoch); the launch counts show
    both directions of every recurrence went through one call of each
    ``gru`` kernel; three steps at batch 16 equal the CPU's."""
    from bigdl_tpu_torch.nn.module import export_params
    from bigdl_tpu_torch.optim import max_epoch, max_iteration
    from bigdl_tpu_torch.utils.random import generator

    init = export_params(gru_classifier("cpu", generator(0)))
    n_params = sum(v.size for v in _leaves(init))
    if n_params != GPARAMS:
        raise AssertionError(f"the GRU classifier has {n_params} "
                             f"parameters, expected {GPARAMS}")
    docs = text_docs(TDOCS)
    split = int(len(docs) * 0.8)
    train, val = docs[:split], docs[split:]
    run = lambda device, docs_, batch, end, val_=None: bilstm_run(
        torch, device, init, docs_, batch, end, val_, build=gru_classifier)
    run("cuda", train, TBATCH, max_iteration(2)).optimize()   # warm-up
    opt = run("cuda", train, TBATCH, max_epoch(1), val)
    torch.cuda.reset_peak_memory_stats()
    _, counts, wall = run_path(torch, ops, opt.optimize)
    steps = int(opt.state["neval"]) - 1
    val_batches = len(opt.validation_log) * (len(val) // TBATCH)
    want = {**untapped(counts), "fused_sgd": steps,
            "gru_forward": steps + val_batches, "gru_backward": steps,
            "gru_dwh": steps}
    if steps != split // TBATCH or counts != want:
        raise AssertionError(f"GRU launches {counts} after {steps} steps and "
                             f"{val_batches} validation batches, expected "
                             f"{want}")
    losses = [l for _, l in opt.loss_log]
    if len(losses) != steps or not np.isfinite(losses).all():
        raise AssertionError(f"GRU losses: {losses}")
    val_s = opt.metrics.get("validate")[0]
    loop_s = wall - val_s
    fetch_s, fetches = opt.metrics.get("data fetch time")
    step_ms = loop_s / steps * 1e3
    print(f"gru: GRU classifier {n_params} params, {steps} steps of "
          f"{TBATCH} x {TSEQ} x {TEMBED}, {len(opt.validation_log)} "
          f"validations of {len(val) // TBATCH} batches; wall {wall:.4f} s, "
          f"{step_ms:.4f} ms/step and {steps * TBATCH * TSEQ / loop_s:.1f} "
          f"tokens/s (validation {val_s:.4f} s excluded); host: dataset "
          f"iterator and H2D copy {fetch_s / fetches * 1e3:.4f} ms/batch "
          f"({fetch_s / loop_s:.4f} of the loop); max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} B; launches {counts}; "
          f"losses {' '.join(f'{l:.6f}' for l in losses)}; Top1 "
          f"{' '.join(f'{v["Top1Accuracy"]:.4f}' for _, _, v in opt.validation_log)}")
    diff = card_vs_cpu(torch, init, lambda device: run(
        device, train[:TCHECK_BATCH * TCHECK_STEPS], TCHECK_BATCH,
        max_iteration(TCHECK_STEPS)))
    print_vs_cpu("gru", TCHECK_BATCH, diff, PARAM_ATOL)
    if profile:
        busy_ms = profile_train(torch, lambda end: run(
            "cuda", train, TBATCH, end), 5)
        print(f"profile: device idle share of the unprofiled GRU train "
              f"step {1 - busy_ms / step_ms:.4f} ({busy_ms:.4f} of "
              f"{step_ms:.4f} ms/step busy)")
    held_vs_cpu("GRU", diff)
    return counts, {"step_ms": step_ms,
                    "tokens_s": steps * TBATCH * TSEQ / loop_s}


def lstm_classifier(device, generator=None, bptt=0):
    """The Bi-LSTM classifier's composition with one direction, from the
    package's public modules: 183,368 parameters at (20, 200, 128), the
    recurrence truncated every ``bptt`` steps (0: not)."""
    from bigdl_tpu_torch import nn

    kw = dict(device=device, generator=generator)
    return nn.Sequential(
        nn.Recurrent(bptt).add(nn.LSTMCell(TEMBED, THIDDEN, **kw)),
        nn.Mean(1, n_input_dims=2),
        nn.Linear(THIDDEN, 100, **kw), nn.ReLU(),
        nn.Linear(100, TCLASSES, **kw), nn.LogSoftMax())


def phase_lstm(torch, ops, profile: bool):
    """The single-direction LSTM classifier trains one epoch of the
    Bi-LSTM phase's documents at full width (the ``bilstm`` kernels at
    D = 1 and ``fused_sgd``) and validates Top1 through ``lstm_scan``, the
    no-grad route; the launch counts show each; three steps at batch 16
    equal the CPU's."""
    from bigdl_tpu_torch.nn.module import export_params
    from bigdl_tpu_torch.optim import max_epoch, max_iteration
    from bigdl_tpu_torch.utils.random import generator

    init = export_params(lstm_classifier("cpu", generator(0)))
    n_params = sum(v.size for v in _leaves(init))
    if n_params != LPARAMS:
        raise AssertionError(f"the LSTM classifier has {n_params} "
                             f"parameters, expected {LPARAMS}")
    docs = text_docs(TDOCS)
    split = int(len(docs) * 0.8)
    train, val = docs[:split], docs[split:]
    run = lambda device, docs_, batch, end, val_=None: bilstm_run(
        torch, device, init, docs_, batch, end, val_, build=lstm_classifier)
    run("cuda", train, TBATCH, max_iteration(2), val).optimize()  # warm-up
    opt = run("cuda", train, TBATCH, max_epoch(1), val)
    torch.cuda.reset_peak_memory_stats()
    _, counts, wall = run_path(torch, ops, opt.optimize)
    steps = int(opt.state["neval"]) - 1
    val_batches = len(opt.validation_log) * (len(val) // TBATCH)
    want = {**untapped(counts), "fused_sgd": steps,
            "bilstm_forward": steps, "bilstm_backward": steps,
            "bilstm_dwh": steps, "lstm_scan": val_batches}
    if steps != split // TBATCH or val_batches == 0 or counts != want:
        raise AssertionError(f"LSTM launches {counts} after {steps} steps "
                             f"and {val_batches} validation batches, "
                             f"expected {want}")
    losses = [l for _, l in opt.loss_log]
    if len(losses) != steps or not np.isfinite(losses).all():
        raise AssertionError(f"LSTM losses: {losses}")
    val_s = opt.metrics.get("validate")[0]
    loop_s = wall - val_s
    step_ms = loop_s / steps * 1e3
    print(f"lstm: LSTM classifier {n_params} params, {steps} steps of "
          f"{TBATCH} x {TSEQ} x {TEMBED}, {len(opt.validation_log)} "
          f"validations of {len(val) // TBATCH} batches through lstm_scan "
          f"({val_s / val_batches * 1e3:.4f} ms per validation batch); wall "
          f"{wall:.4f} s, {step_ms:.4f} ms/step and "
          f"{steps * TBATCH * TSEQ / loop_s:.1f} tokens/s (validation "
          f"excluded); max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} B; launches {counts}; losses "
          f"{' '.join(f'{l:.6f}' for l in losses)}; Top1 "
          f"{' '.join(f'{v["Top1Accuracy"]:.4f}' for _, _, v in opt.validation_log)}")
    diff = card_vs_cpu(torch, init, lambda device: run(
        device, train[:TCHECK_BATCH * TCHECK_STEPS], TCHECK_BATCH,
        max_iteration(TCHECK_STEPS)))
    print_vs_cpu("lstm", TCHECK_BATCH, diff, PARAM_ATOL)
    if profile:
        busy_ms = profile_train(torch, lambda end: run(
            "cuda", train, TBATCH, end), 5)
        print(f"profile: device idle share of the unprofiled LSTM train "
              f"step {1 - busy_ms / step_ms:.4f} ({busy_ms:.4f} of "
              f"{step_ms:.4f} ms/step busy)")
    held_vs_cpu("LSTM", diff)
    return counts, {"step_ms": step_ms,
                    "tokens_s": steps * TBATCH * TSEQ / loop_s}


def truncated_classifier(torch, ops, profile, label, build, per_step,
                         untruncated):
    """``build(device, generator, bptt)`` at TBPTT trains TTRUNC_STEPS
    steps of the Bi-LSTM phase's documents at full width and validates
    Top1 once: the launch counts a step must be ``per_step`` (each
    chunk one D = 1 call of each kernel) and fused_sgd one, the step
    route never taken; ms a step and tokens/s beside the untruncated
    run's ``untruncated`` figures; three steps at batch 16 against the
    CPU.  The launch counts."""
    from bigdl_tpu_torch.nn import recurrent
    from bigdl_tpu_torch.nn.module import export_params
    from bigdl_tpu_torch.optim import max_iteration
    from bigdl_tpu_torch.utils.random import generator

    make = lambda dev: build(dev, None, TBPTT)
    init = export_params(build("cpu", generator(0), TBPTT))
    docs = text_docs(TDOCS)
    split = int(len(docs) * 0.8)
    train, val = docs[:split], docs[split:]
    run = lambda device, docs_, batch, end, val_=None: bilstm_run(
        torch, device, init, docs_, batch, end, val_, build=make)
    run("cuda", train, TBATCH, max_iteration(2)).optimize()   # warm-up
    opt = run("cuda", train, TBATCH, max_iteration(TTRUNC_STEPS), val)
    routes = recurrent.step_route_calls
    _, counts, wall = run_path(torch, ops, opt.optimize)
    steps = int(opt.state["neval"]) - 1
    val_batches = len(opt.validation_log) * (len(val) // TBATCH)
    chunks = -(-TSEQ // TBPTT)
    want = {**untapped(counts), "fused_sgd": steps,
            **{k: v * steps for k, v in per_step(chunks).items()}}
    val_counts = per_step(0, val_batches)
    for k, v in val_counts.items():
        want[k] = want.get(k, 0) + v
    if (steps != TTRUNC_STEPS or val_batches == 0 or counts != want
            or recurrent.step_route_calls != routes):
        raise AssertionError(f"truncated {label}: launches {counts} after "
                             f"{steps} steps and {val_batches} validation "
                             f"batches, expected {want}; step route "
                             f"{recurrent.step_route_calls - routes}")
    losses = [l for _, l in opt.loss_log]
    if len(losses) != steps or not np.isfinite(losses).all():
        raise AssertionError(f"truncated {label} losses: {losses}")
    val_s = opt.metrics.get("validate")[0]
    loop_s = wall - val_s
    step_ms = loop_s / steps * 1e3
    tokens = steps * TBATCH * TSEQ / loop_s
    print(f"truncated {label}: bptt {TBPTT} over T {TSEQ} ({chunks} chunks, "
          f"the last of {TSEQ - (chunks - 1) * TBPTT} steps), {steps} steps "
          f"of {TBATCH} x {TSEQ} x {TEMBED}, {val_batches} validation "
          f"batches; {step_ms:.4f} ms/step and {tokens:.1f} tokens/s "
          f"(untruncated, same call: {untruncated['step_ms']:.4f} ms/step, "
          f"{untruncated['tokens_s']:.1f} tokens/s); launches {counts} "
          f"({', '.join(f'{k} {v}' for k, v in per_step(chunks).items())} "
          f"a step); step route 0; losses "
          f"{' '.join(f'{l:.6f}' for l in losses)}")
    diff = card_vs_cpu(torch, init, lambda device: run(
        device, train[:TCHECK_BATCH * TCHECK_STEPS], TCHECK_BATCH,
        max_iteration(TCHECK_STEPS)))
    print_vs_cpu(f"truncated {label}", TCHECK_BATCH, diff, PARAM_ATOL)
    if profile:
        busy_ms = profile_train(torch, lambda end: run(
            "cuda", train, TBATCH, end), 5)
        print(f"profile: device idle share of the unprofiled truncated "
              f"{label} train step {1 - busy_ms / step_ms:.4f} "
              f"({busy_ms:.4f} of {step_ms:.4f} ms/step busy)")
    held_vs_cpu(f"truncated {label}", diff)
    return counts


def simple_rnn_composition(activation):
    """SimpleRNN's layers from the public modules, its RnnCell under
    ``activation`` (a class of nn): ``build(vocab, device, generator)``,
    SimpleRNN's parameter tree."""
    from bigdl_tpu_torch import nn

    return lambda vocab, device, generator=None: nn.Sequential(
        nn.Recurrent(RBPTT).add(nn.RnnCell(vocab, RHIDDEN, activation(),
                                           device=device,
                                           generator=generator)),
        nn.TimeDistributed(nn.Sequential(
            nn.Linear(RHIDDEN, vocab, device=device, generator=generator),
            nn.LogSoftMax())))


def phase_truncation(torch, ops, profile, figures):
    """The rest of the recurrence at full width: (a) the LSTM classifier
    and (b) the GRU classifier truncated every TBPTT steps (15 chunks a
    sequence, each one kernel call of each kernel a direction), (c)
    SimpleRNN's composition with Sigmoid and with ReLU cells for the
    SimpleRNN phase's steps (rnn_* on every chunk), each held to the
    CPU; (d) an RnnCell under SoftMax and an LSTMCell subclass, a short
    forward and backward through the step route with no recurrence
    launch.  ``figures``: the untruncated classifiers' {label: ms a step,
    tokens/s} from this call.  The launch counts of each path."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.nn import recurrent
    from bigdl_tpu_torch.nn.module import export_params
    from bigdl_tpu_torch.optim import max_epoch, max_iteration
    from bigdl_tpu_torch.utils.random import generator

    out = {"lstm_bptt": truncated_classifier(
        torch, ops, profile, "LSTM", lstm_classifier,
        lambda n, val=0: {"bilstm_forward": n, "bilstm_backward": n,
                          "bilstm_dwh": n, "lstm_scan": val},
        figures["lstm"])}
    out["gru_bptt"] = truncated_classifier(
        torch, ops, profile, "GRU", gru_classifier,
        lambda n, val=0: {"gru_forward": 2 * n + 2 * val,
                          "gru_backward": 2 * n, "gru_dwh": 2 * n},
        figures["gru"])

    tokens, dictionary, vocab = rnn_data(rnn_corpus(RSENTENCES))
    batches = -(-len(tokens) // RBATCH)
    for act in (nn.Sigmoid, nn.ReLU):
        build = simple_rnn_composition(act)
        init = export_params(build(vocab, "cpu", generator(0)))
        make = lambda device, end: rnn_run(torch, device, init, tokens,
                                           dictionary, end, build=build)
        make("cuda", max_iteration(2)).optimize()   # warm-up
        opt = make("cuda", max_epoch(REPOCHS))
        routes = recurrent.step_route_calls
        _, counts, wall = run_path(torch, ops, opt.optimize)
        steps = int(opt.state["neval"]) - 1
        want = {**untapped(counts), "fused_sgd": steps,
                "rnn_forward": 2 * steps, "rnn_backward": 2 * steps,
                "rnn_dwh": 2 * steps}
        if (steps != REPOCHS * batches or counts != want
                or recurrent.step_route_calls != routes):
            raise AssertionError(f"SimpleRNN {act.__name__}: launches "
                                 f"{counts} after {steps} steps, expected "
                                 f"{want}")
        losses = [l for _, l in opt.loss_log]
        if not np.isfinite(losses).all():
            raise AssertionError(f"SimpleRNN {act.__name__} losses")
        print(f"simple_rnn {act.__name__}: {steps} steps of {RBATCH} x "
              f"{RSEQ} at bptt {RBPTT}, {wall / steps * 1e3:.4f} ms/step, "
              f"{steps * RBATCH * RSEQ / wall:.1f} words/s; launches "
              f"{counts} (2 chunks a step); step route 0; mean loss epoch 1 "
              f"{np.mean(losses[:batches]):.6f}, epoch {REPOCHS} "
              f"{np.mean(losses[-batches:]):.6f}")
        diff = card_vs_cpu(torch, init, lambda device: make(
            device, max_iteration(RCHECK_STEPS)))
        print_vs_cpu(f"simple_rnn {act.__name__}", RBATCH, diff, PARAM_ATOL)
        held_vs_cpu(f"SimpleRNN {act.__name__}", diff)
        out[f"simple_rnn_{act.__name__.lower()}"] = counts

    # (d) what no kernel runs: a row-wise activation, a cell subclass
    x = torch.randn(3, 7, 6, device="cuda", requires_grad=True)
    for label, cell in (
            ("RnnCell(6, 5, SoftMax())", nn.RnnCell(6, 5, nn.SoftMax(),
                                                    device="cuda")),
            ("LSTMCell subclass", type("Sub", (nn.LSTMCell,), {})(
                6, 5, device="cuda"))):
        routes = recurrent.step_route_calls
        _, counts, _ = run_path(torch, ops, lambda: nn.Recurrent(3).add(
            cell)(x).sum().backward())
        taken = recurrent.step_route_calls - routes
        if taken <= 0 or any(counts.values()):
            raise AssertionError(f"{label}: step route {taken}, launches "
                                 f"{counts}")
        print(f"step route: Recurrent(3).add({label}) forward and backward, "
              f"step_route_calls +{taken}, no kernel launch")
    return out


def held_vs_cpu(label, diff, param_limit=PARAM_ATOL, scope="leaf"):
    """Every path's card-vs-CPU gate over ``card_vs_cpu``'s differences:
    the first batch's loss (and its outputs, where given) and the steps'
    losses within LOSS_RTOL (RTOL) of the CPU's; the gradients within the
    backward tolerance of the CPU's or of float64, or no further from
    float64 than BILSTM_VS_64 times the CPU's own fp32 run, each leaf over
    its largest entry (``scope`` "leaf") or over the whole model
    ("model", ``norm_rel``); the final parameters within
    ``param_limit``; each running statistic within STATE_RTOL of its
    buffer's largest entry."""
    failed = vs_cpu_failures(diff, param_limit, scope)
    if failed:
        raise AssertionError(f"the card's {label} training left the CPU's: "
                             f"{', '.join(failed)}")


def vs_cpu_failures(diff, param_limit=PARAM_ATOL, scope="leaf"):
    """The parts of ``held_vs_cpu``'s gate that ``diff`` fails."""
    if scope == "leaf":
        vs_cpu, vs_64, cpu_64 = (diff["grad_rel"], diff["card_vs_64"],
                                 diff["cpu_vs_64_max"])
    else:
        vs_cpu, vs_64, cpu_64 = (diff["grad_norm_rel"], diff["card_norm_64"],
                                 diff["cpu_norm_64"])
    rtol = BILSTM_BWD_TOL["rtol"]
    grads_ok = vs_cpu <= rtol or vs_64 <= max(rtol, BILSTM_VS_64 * cpu_64)
    card, cpu = diff["loss"]
    return [part for part, bad in (
        ("first loss", abs(card - cpu) > LOSS_RTOL * abs(cpu)),
        ("gradients", not grads_ok),
        ("outputs", diff.get("out_rel", 0.0) > RTOL),
        ("losses", diff["loss_rel"] > LOSS_RTOL),
        ("params", diff["param_abs"] > param_limit),
        ("running statistics", diff["state_rel"] > STATE_RTOL)) if bad]


def print_vs_cpu(label, batch, diff, param_limit):
    print(f"{label} vs CPU, first batch of {batch}: loss card "
          f"{diff['loss'][0]:.8f} CPU {diff['loss'][1]:.8f}; gradients, "
          f"largest |card - CPU| / max|CPU| of a leaf {diff['grad_rel']:.3e} "
          f"({diff['grad_leaf']}); against float64 on the CPU, the card's "
          f"largest {diff['card_vs_64']:.3e} ({diff['leaf_64']}, where the "
          f"CPU's fp32 is {diff['cpu_vs_64']:.3e}; the CPU's largest "
          f"{diff['cpu_vs_64_max']:.3e}); {len(diff['losses'][0])} optimizer "
          f"steps: losses card {diff['losses'][0]} CPU {diff['losses'][1]}, "
          f"largest relative difference {diff['loss_rel']:.3e} (limit "
          f"{LOSS_RTOL}); final params, largest absolute difference "
          f"{diff['param_abs']:.3e} ({diff['param_leaf']}, whose largest "
          f"update is {diff['param_step']:.3e}; limit {param_limit}); "
          + (f"running statistics ({diff['n_state']} values), largest "
             f"|card - CPU| / max|CPU| of a buffer {diff['state_rel']:.3e} "
             f"({diff['state_leaf']}; limit {STATE_RTOL}); "
             if diff["n_state"] else "")
          + f"the whole gradient: card - CPU {diff['grad_norm_rel']:.3e}, "
          + "from float64"
          + (" (each under its own routing)" if "flips" in diff else "")
          + f" card {diff['card_norm_64']:.3e} CPU "
          f"{diff['cpu_norm_64']:.3e}; "
          + (f"float64 without the fp32 runs' routing: card "
             f"{diff['card_norm_64_free']:.3e} CPU "
             f"{diff['cpu_norm_64_free']:.3e} ({diff['flips']}); the "
             f"CPU's steps took the card's routing ({diff['steps_differ'][0]} "
             f"of its own {diff['steps_differ'][1]} choices differed); "
             if "flips" in diff else "")
          + (f"{diff['n_null']} gradient leaves zero in float64 (biases "
             f"under BN) taken over the largest gradient entry; "
             if diff["n_null"] else "")
          + f"CPU {diff['cpu_s']:.2f} s")


def leaf_rel(a, b, scale=None):
    """The largest |a - b| of a leaf over b's largest entry (or over
    ``scale``)."""
    return float((a.double() - b).abs().max()
                 / (b.abs().max().clamp_min(1e-30) if scale is None
                    else scale))


def norm_rel(card, cpu, card_64, cpu_64):
    """Whole-model relative errors of gradient lists, ||a - b|| / ||b||
    over every leaf at once: the card against the CPU, and each against
    its float64 reference.  Under batch normalisation many leaves are
    sums that mostly cancel (a BN bias), and a leaf's error over its own
    largest entry then measures the cancellation, not the arithmetic."""
    return {"grad_norm_rel": model_rel(card, cpu),
            "card_norm_64": model_rel(card, card_64),
            "cpu_norm_64": model_rel(cpu, cpu_64)}


def model_rel(a, b):
    """||a - b|| / ||b|| over every leaf of two tensor lists at once."""
    num = sum(float((u.double() - v.double()).pow(2).sum())
              for u, v in zip(a, b))
    den = sum(float(v.double().pow(2).sum()) for v in b)
    return (num / max(den, 1e-300)) ** 0.5


def null_scales(grads_64):
    """For each float64 gradient leaf, None, or the model's largest
    gradient entry where the leaf is zero in float64 (a bias under batch
    normalisation, which the batch mean cancels): such a leaf holds only
    rounding noise, so its errors are taken over that scale."""
    gmax = max(float(g.abs().max()) for g in grads_64)
    return [gmax if float(g.abs().max()) <= NULL_GRAD * gmax else None
            for g in grads_64]


class Routes:
    """Forward hooks on a model's ReLUs, max pools and MoE layers, and on
    its LRNs for their geometry.  Recording (``replay`` None), each call
    leaves, in call order, its routing: a ReLU's mask x > 0, a max pool's
    first-max input index for every output (the plain version's rule,
    which the kernels keep), an MoE's expert and kept flag a token and
    its experts' ReLU masks; and
    each pool's and LRN's geometry (``pools``, ``s1``, ``lrn``), alone
    with ``geometry_only``.  Replaying another record on
    a float64 copy of the model (or on the CPU's fp32 run), each ReLU
    gives its input times the recorded mask and each max pool its input
    gathered at the recorded indices: the gradient then flows where the
    recording run's did, and the two differ by their arithmetic alone,
    not by which of two values a rounding apart won; ``differ`` counts
    the replayed choices the run would have made otherwise, of
    ``choices``."""

    def __init__(self, torch, model, replay=None, geometry_only=False):
        from bigdl_tpu_torch import ops
        from bigdl_tpu_torch.nn import (MoE, ReLU, SpatialCrossMapLRN,
                                        SpatialMaxPooling)

        self.torch, self.ops, self.geometry_only = torch, ops, geometry_only
        self.route, self.pools, self.s1, self.lrn = [], set(), set(), set()
        self.replay = None if replay is None else iter(replay.route)
        self.differ = self.choices = 0
        hook = {ReLU: self._relu, SpatialMaxPooling: self._pool,
                SpatialCrossMapLRN: self._lrn, MoE: self._moe}
        self.handles = [m.register_forward_hook(hook[type(m)])
                        for m in model.modules() if type(m) in hook]

    def __enter__(self):
        return self

    def __exit__(self, kind, *_):
        for h in self.handles:
            h.remove()
        if (kind is None and self.replay is not None
                and next(self.replay, None) is not None):
            raise AssertionError("the replay routed fewer calls than its "
                                 "record")

    def _relu(self, m, args, out):
        x = args[0]
        if self.replay is not None:
            mask = next(self.replay).to(x.device)
            self._count(x > 0, mask)
            return x * mask.to(x.dtype)
        if not self.geometry_only:
            self.route.append((x > 0).cpu())
        return None

    def _count(self, own, replayed):
        self.differ += int((own != replayed).sum())
        self.choices += replayed.numel()

    def _pool(self, m, args, out):
        from bigdl_tpu_torch.nn.pooling import _pads
        from bigdl_tpu_torch.tensor import policy

        torch = self.torch
        x = args[0] if args[0].dim() == 4 else args[0][None]
        win, st = (m.kh, m.kw), (m.dh, m.dw)
        pads = _pads(m, x.shape[2:])
        # the module pools an f32 input in a reduced policy's compute
        # dtype: its first max is that of the rounded input
        dt = policy().compute_dtype
        cast = x.dtype == torch.float32 and dt != torch.float32
        xc = x.to(dt) if cast else x
        if self.replay is not None:
            idx = next(self.replay).to(x.device)
            self._count(self._first_max(xc, win, st, pads), idx)
            y = xc.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)
            y = y.to(x.dtype) if cast else y
            return y if args[0].dim() == 4 else y[0]
        if st == (1, 1):
            self.s1.add((tuple(x.shape), win, pads))
        else:
            self.pools.add((tuple(x.shape), win, st, pads))
        if not self.geometry_only:
            self.route.append(self._first_max(xc, win, st, pads).cpu())
        return None

    def _first_max(self, x, win, st, pads):
        """Each output's first-max input index into an (H * W) plane."""
        torch = self.torch
        with torch.no_grad():
            _, arg = self.ops.maxpool2d_forward_reference(x, win, st, pads)
            arg = arg.long()
            oh, ow = arg.shape[2:]
            rows = (torch.arange(oh, device=x.device)[:, None] * st[0]
                    - pads[0][0] + arg // win[1])
            cols = (torch.arange(ow, device=x.device) * st[1] - pads[1][0]
                    + arg % win[1])
            return rows * x.shape[3] + cols

    def _moe(self, m, args, out):
        """An MoE's routing: each token's expert and whether it was kept,
        then each expert's ReLU mask over its places.  Replayed, the
        layer's output is recomputed with the recorded routing and masks
        (the gates, places and products in this run's arithmetic)."""
        import torch.nn.functional as F

        from bigdl_tpu_torch.parallel import moe as pmoe

        torch = self.torch
        x = args[0]
        xt = x.reshape(-1, x.shape[-1])
        cap = pmoe.expert_capacity(xt.shape[0], m.n_experts,
                                   m.capacity_factor)
        with torch.no_grad():
            own = pmoe.top1_route(xt @ m.router, m.n_experts, cap)
            xe, _ = pmoe.dispatch(xt, own, m.n_experts, cap)
            own_mask = torch.bmm(xe, m.w1) + m.b1[:, None] > 0
        choice = torch.stack([own.expert, own.keep.long()])
        if self.replay is None:
            if not self.geometry_only:
                self.route += [choice.cpu(), own_mask.cpu()]
            return None
        rec, mask = (next(self.replay).to(x.device),
                     next(self.replay).to(x.device))
        self._count(choice, rec)
        expert, keep = rec[0], rec[1].bool()
        gates = torch.softmax(xt @ m.router, dim=-1)
        onehot = F.one_hot(expert, m.n_experts)
        local = (onehot.cumsum(0) * onehot).sum(1) - 1
        route = pmoe.Route(expert, local, local, keep,
                           gates.gather(1, expert[:, None])[:, 0])
        xe, flat = pmoe.dispatch(xt, route, m.n_experts, cap)
        pre = torch.bmm(xe, m.w1) + m.b1[:, None]
        self._count(pre > 0, mask)
        ye = torch.bmm(pre * mask.to(pre.dtype), m.w2) + m.b2[:, None]
        return pmoe.combine(ye, flat, route).reshape(x.shape)

    def _lrn(self, m, args, out):
        x = args[0] if args[0].dim() == 4 else args[0][None]
        self.lrn.add((tuple(x.shape), (m.size, m.alpha, m.beta, m.k)))
        return None

    def flips(self, other):
        """How many ReLU masks and pool indices differ from ``other``'s."""
        n = sum(int((a != b).sum()) for a, b in zip(self.route, other.route))
        return (f"{n} of {sum(a.numel() for a in self.route)} routing "
                f"choices differ from the CPU's")

    def route_equal(self, other):
        return len(self.route) == len(other.route) and all(
            self.torch.equal(a, b) for a, b in zip(self.route, other.route))


def held_standalone(label, seen):
    """Every pool and LRN geometry that ``seen`` (a recording ``Routes``)
    met is one the kernel phases hold against the plain version."""
    missing = ((seen.pools - {tuple(c) for c in POOL_CASES + INCEPTION_POOLS
                              + BN_POOLS + PIPE_POOLS
                              + PIPE_DP_POOLS})
               | (seen.s1 - {tuple(c) for c in S1_CASES})
               | (seen.lrn - {tuple(c) for c in LRN_CASES}))
    if missing:
        raise AssertionError(f"{label}: kernel geometries no standalone "
                             f"check holds: {sorted(missing)}")


def card_vs_cpu(torch, init, make_run, make_probe=None, routed=False):
    """The card against the CPU (plain versions) from the same parameters
    ``init`` on the same batches: the first batch's loss (under the run's
    criterion) and gradients, then the optimizer's steps' losses, final
    parameters and running statistics.
    ``make_run(device)`` builds the optimizer of a few steps on
    ``device`` (dropout off, since the two draw different masks).
    ``make_probe(device)``, when given, builds the run whose first batch
    the gradients are taken on (and in float64), apart from the run that
    takes the steps.  Each fp32 run's gradients are held against float64
    on the CPU.  With ``routed`` (``Routes``), each against a float64
    run that takes that fp32 run's own routing, the free float64 run's
    distances kept beside them (``*_free``); and the CPU's steps take
    the card's steps' routing, so that the two trajectories part by
    their arithmetic, not by a near-tie that one rounding flips
    (``steps_differ``: the CPU's own choices that differed)."""
    from bigdl_tpu_torch.nn.module import export_state
    from bigdl_tpu_torch.optim.local_optimizer import to_device

    names = [".".join(k) for k in _paths(init)]
    make_probe = make_probe or make_run
    out, routes = {}, {}
    for device in ("cuda", "cpu"):
        probe = make_probe(device)
        batch = next(probe.dataset.data(train=True))
        dev = torch.device(device)
        probe.model.train()
        # the probe's forward moves the running statistics: put them back
        state0 = export_state(probe.model)
        with (Routes(torch, probe.model) if routed
              else contextlib.nullcontext()) as routes[device]:
            loss = probe.criterion(probe.model(to_device(batch.data, dev)),
                                   to_device(batch.labels, dev))
        loss.backward()
        grads = [p.grad.detach().cpu() for p in probe.model.parameters()]
        probe.model.zero_grad(set_to_none=True)
        probe.model.load_state(state0)
        run = probe if make_probe is make_run else make_run(device)
        t1 = time.perf_counter()
        with (Routes(torch, run.model, replay=routes.get("steps"))
              if routed else contextlib.nullcontext()) as steps:
            run.optimize()
        routes.setdefault("steps", steps)
        out[device] = (float(loss.detach()), grads, run,
                       time.perf_counter() - t1)
    (loss_g, grad_g, card, _), (loss_c, grad_c, cpu, cpu_s) = (
        out["cuda"], out["cpu"])

    def grads_64(route=None):
        """The same first batch on the CPU in float64, routed as
        ``route`` was when given."""
        ref = make_probe("cpu")
        batch = next(ref.dataset.data(train=True))
        ref.model.double().train()
        with (Routes(torch, ref.model, replay=route) if route
              else contextlib.nullcontext()):
            loss = ref.criterion(
                ref.model(torch.from_numpy(batch.data).double()),
                torch.from_numpy(batch.labels))
        loss.backward()
        return [p.grad for p in ref.model.parameters()]

    grad_64 = grads_64()
    card_64, cpu_64 = ((grads_64(routes["cuda"]), grads_64(routes["cpu"]))
                       if routed else (grad_64, grad_64))
    # each leaf over its largest entry (a leaf zero in float64 over the
    # model's largest gradient entry)
    rel = leaf_rel
    scale = null_scales(grad_64)
    g_rel = [rel(a, b.double(), s)
             for a, b, s in zip(grad_g, grad_c, scale)]
    norm = norm_rel(grad_g, grad_c, card_64, cpu_64)
    if routed:
        norm |= {"card_norm_64_free": model_rel(grad_g, grad_64),
                 "cpu_norm_64_free": model_rel(grad_c, grad_64),
                 "flips": routes["cuda"].flips(routes["cpu"]),
                 "steps_differ": (steps.differ, steps.choices)}
    e_card = [rel(a, b, s) for a, b, s in zip(grad_g, card_64, scale)]
    e_cpu = [rel(a, b, s) for a, b, s in zip(grad_c, cpu_64, scale)]
    init_leaves = [torch.from_numpy(v) for v in _leaves(init)]
    p_abs, p_step = [], []
    gap2 = moved2 = 0.0
    for a, b, p0 in zip(card.model.parameters(), cpu.model.parameters(),
                        init_leaves):
        d = a.detach().cpu().double() - b.detach().double()
        p_abs.append(float(d.abs().max()))
        p_step.append(float((b.detach() - p0).abs().max()))
        gap2 += float(d.pow(2).sum())
        moved2 += float((b.detach().double() - p0.double()).pow(2).sum())
    got_l = np.asarray([l for _, l in card.loss_log])
    want_l = np.asarray([l for _, l in cpu.loss_log])
    gi, pi = int(np.argmax(g_rel)), int(np.argmax(p_abs))
    ei = int(np.argmax(e_card))
    # the running statistics, each buffer over its largest entry
    s_names = [n for n, _ in cpu.model.named_buffers()]
    s_rel = [rel(a.detach().cpu(), b.double())
             for a, b in zip(card.model.buffers(), cpu.model.buffers())]
    si = int(np.argmax(s_rel)) if s_rel else None
    return {"loss": (float(loss_g), float(loss_c)),
            "state_rel": s_rel[si] if s_rel else 0.0,
            "state_leaf": s_names[si] if s_rel else None,
            "n_state": sum(b.numel() for b in cpu.model.buffers()),
            "n_null": sum(s is not None for s in scale),
            "grad_rel": g_rel[gi], "grad_leaf": names[gi],
            "card_vs_64": e_card[ei], "cpu_vs_64": e_cpu[ei],
            "leaf_64": names[ei], "cpu_vs_64_max": max(e_cpu),
            "losses": (got_l.tolist(), want_l.tolist()),
            "loss_rel": float(np.max(np.abs(got_l - want_l)
                                     / np.abs(want_l))),
            "param_abs": p_abs[pi], "param_leaf": names[pi],
            "param_step": p_step[pi],
            "update_rel": (gap2 / max(moved2, 1e-300)) ** 0.5,
            "cpu_s": cpu_s, **norm}


def _leaves(tree):
    """The leaves of a parameter tree, in ``model.parameters()`` order."""
    for k, sub in tree.items():
        yield from (sub.values() if k == "~" else _leaves(sub))


def _paths(tree, prefix=()):
    for k, sub in tree.items():
        if k == "~":
            yield from (prefix + (n,) for n in sub)
        else:
            yield from _paths(sub, prefix + (k,))


def forced_gaps(torch, model, row, n_seed):
    """Teacher forcing: for each generated token of ``row``, how far its
    log-prob under the plain full-sequence forward sits below that
    position's maximum."""
    import torch.nn.functional as F

    with torch.no_grad():
        ids = torch.tensor([row], device="cuda")
        lp = model(F.one_hot(ids, VOCAB).float())[0]
    if not bool(torch.isfinite(lp).all()):
        raise AssertionError("non-finite log-probs")
    j = torch.arange(n_seed - 1, len(row) - 1, device="cuda")
    return lp[j].max(dim=-1).values - lp[j, ids[0, j + 1]]


def check_lm_decode(torch, ops, model, seed, want):
    """The offline entry point at full width: ``lm_decode`` of one seed
    launches the kernel once per layer and position, and its row equals
    the decoder's.  Two fp32 runs at different batch widths may part at a
    near-tie; there both tokens must sit within 1e-3 of the position's
    maximum, and the rows are compared no further."""
    from bigdl_tpu_torch.models.transformer import lm_decode

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    got = lm_decode(model, seed, N_WORDS, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()["paged_attention"]
    n_pos = len(seed) + N_WORDS - 1
    if launches != LAYERS * n_pos:
        raise AssertionError(f"lm_decode launched paged_attention "
                             f"{launches} times, expected {LAYERS} x "
                             f"{n_pos} positions")
    if len(got) != len(want) or got[:len(seed)] != seed:
        raise AssertionError("lm_decode returned a row of the wrong shape")
    same = next((k for k in range(len(seed), len(got))
                 if got[k] != want[k]), len(got))
    if same < len(got):
        gaps = forced_gaps(torch, model, want[:same] + [got[same]],
                           len(seed))
        if float(gaps.max()) > 1e-3:
            raise AssertionError(
                f"lm_decode parts from the decoder at position {same} on "
                f"a token {float(gaps[-1]):.3e} below the maximum")
    print(f"lm_decode: seed {len(seed)} tokens + {N_WORDS} words "
          f"({-(-n_pos // PAGE)} pages of {PAGE}), {launches} kernel "
          f"launches, {same - len(seed)} of {N_WORDS} tokens equal to the "
          f"decoder's row{'' if same == len(got) else ' (then a near-tie)'}"
          f", wall {wall:.4f} s")


def phase_slice(torch, ops, profile: bool):
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.serve.decode import (ContinuousDecoder,
                                              continuous_decode)
    from bigdl_tpu_torch.utils.random import generator

    t0 = time.perf_counter()
    model = TransformerLM(VOCAB, D_MODEL, HEADS, LAYERS, HIDDEN,
                          dropout=0.0, device="cuda",
                          generator=generator(0)).evaluate()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {n_params} parameters on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    # warm-up: cuBLAS handles, allocator, kernel library load
    continuous_decode(model, [[1, 2, 3]], 4, max_slots=SLOTS, n_pos=N_POS,
                      device="cuda")

    rs = np.random.RandomState(0)
    seeds = [rs.randint(0, VOCAB, size=int(rs.randint(16, 257))).tolist()
             for _ in range(N_REQ)]
    dec = ContinuousDecoder(model, max_slots=SLOTS, n_pos=N_POS,
                            page_size=PAGE, device="cuda")
    futs = [dec.submit(s, N_WORDS) for s in seeds]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    dec.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    rows = [f.result() for f in futs]
    if counts != {**untapped(counts),
                  "paged_attention": LAYERS * dec.steps}:
        raise AssertionError(f"serving launches {counts}, expected "
                             f"paged_attention {LAYERS} x {dec.steps} steps "
                             f"and no other kernel")
    st = dec.stats()
    print(f"decode: {N_REQ} requests, seeds {min(map(len, seeds))}.."
          f"{max(map(len, seeds))} tokens, n_words={N_WORDS}, "
          f"{st['steps']} steps, {st['host_syncs']} host syncs, "
          f"admitted {st['admitted']}, live_hwm {st['live_hwm']}, "
          f"wall {wall:.4f} s, {N_REQ * N_WORDS / wall:.1f} generated "
          f"tokens/s, {wall / st['steps'] * 1e3:.4f} ms/step, "
          f"max_memory_allocated {torch.cuda.max_memory_allocated()} B, "
          f"paged_attention launches {counts['paged_attention']}")
    if st["pool"]["in_use"] != st["prefix"]["entries"]:
        raise AssertionError(f"pages leaked past the prefix cache: {st}")

    # teacher forcing: each generated token's log-prob under the plain
    # full-sequence forward is within 1e-3 of that position's maximum
    worst = 0.0
    for seed, row in zip(seeds, rows):
        if len(row) != len(seed) + N_WORDS or row[:len(seed)] != seed:
            raise AssertionError("returned row has the wrong shape")
        worst = max(worst, float(forced_gaps(torch, model, row,
                                             len(seed)).max()))
    if worst > 1e-3:
        raise AssertionError(f"teacher forcing: a generated token sits "
                             f"{worst:.3e} below the position's maximum")
    print(f"teacher forcing: {N_REQ * N_WORDS} tokens checked, largest "
          f"gap to the position's max log-prob {worst:.3e} (limit 1e-3)")
    longest = max(range(N_REQ), key=lambda k: len(seeds[k]))
    check_lm_decode(torch, ops, model, seeds[longest], rows[longest])

    if profile:
        busy_ms = profile_decode(torch, model, seeds)
        step_ms = wall / st["steps"] * 1e3
        print(f"profile: device idle share of the unprofiled step "
              f"{1 - busy_ms / step_ms:.4f} ({busy_ms:.4f} of "
              f"{step_ms:.4f} ms/step busy)")
    return counts, model, seeds, rows


@contextlib.contextmanager
def plain_int8_attention(tt, ops):
    """The window forward's attention as the int8 kernel's plain version
    (the dequantized gathered view), for teacher forcing on the card."""
    tt.paged_attention = ops.paged_attention_int8_reference
    try:
        yield
    finally:
        tt.paged_attention = ops.paged_attention


def int8_forced_gaps(torch, ops, handles, row, n_seed):
    """Teacher forcing under the plain int8 window forward, the function
    the int8 kernel computes: the row's positions in one window over int8
    pools, their attention the plain version; for each generated token,
    how far its log-prob sits below its position's maximum."""
    from bigdl_tpu_torch.models import transformer as tt

    n = len(row) - 1
    P = -(-n // PAGE)
    caches = tt.new_pools(handles, P, PAGE, "cuda", kv_quant="int8")
    pages = (torch.arange(P, dtype=torch.int32, device="cuda")[None], PAGE)
    ids = torch.tensor([row], device="cuda")
    with torch.no_grad(), plain_int8_attention(tt, ops):
        lp, _ = tt._lm_forward_window(
            ids[:, :-1], torch.arange(n, device="cuda")[None], caches,
            handles, handles.mods[1].table(P * PAGE).to("cuda"), pages)
    if not bool(torch.isfinite(lp).all()):
        raise AssertionError("non-finite log-probs")
    j = torch.arange(n_seed - 1, n, device="cuda")
    return lp[0, j].max(dim=-1).values - lp[0, j, ids[0, j + 1]]


def phase_serving_int8(torch, ops, model, seeds, fp_rows, profile: bool):
    """The serving phase again with ``kv_quant="int8"``: the same model
    and 16 requests through int8 KV pools; every attention launch is the
    int8 kernel's, every token is held by teacher forcing against the
    plain int8 window forward, and the share of tokens equal to the fp32
    stream is printed beside the drift budget (a reading: the weights are
    random)."""
    from bigdl_tpu_torch.models.transformer import _lm_handles
    from bigdl_tpu_torch.quant import KV_TOKEN_DRIFT_BUDGET
    from bigdl_tpu_torch.quant import kv as kvq
    from bigdl_tpu_torch.serve.decode import (ContinuousDecoder,
                                              continuous_decode)

    continuous_decode(model, [[1, 2, 3]], 4, max_slots=SLOTS, n_pos=N_POS,
                      kv_quant="int8", device="cuda")    # warm-up
    dec = ContinuousDecoder(model, max_slots=SLOTS, n_pos=N_POS,
                            page_size=PAGE, kv_quant="int8", device="cuda")
    futs = [dec.submit(s, N_WORDS) for s in seeds]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _, counts, wall = run_path(torch, ops, dec.run)
    rows = [f.result() for f in futs]
    st = dec.stats()
    if counts != {**untapped(counts),
                  "paged_attention_int8": LAYERS * dec.steps}:
        raise AssertionError(f"int8 serving launches {counts}, expected "
                             f"paged_attention_int8 {LAYERS} x {dec.steps} "
                             f"steps and no other kernel")
    if (st["pool"]["in_use"] != st["prefix"]["entries"]
            or st["kv_quant"] != "int8"):
        raise AssertionError(f"int8 serving: {st}")
    tokens = (st["pool"]["pages"] + 1) * PAGE     # the scratch page too
    pool_int8 = sum(c.numel() * c.element_size() for c in dec._caches)
    pool_fp32 = tokens * kvq.bytes_per_token(LAYERS, HEADS, D_MODEL // HEADS)
    if pool_int8 != tokens * st["kv_bytes_per_token"]:
        raise AssertionError(f"int8 pools hold {pool_int8} bytes, not "
                             f"{tokens} x {st['kv_bytes_per_token']}")
    print(f"decode int8 KV: {N_REQ} requests, {st['steps']} steps, "
          f"{st['host_syncs']} host syncs, wall {wall:.4f} s, "
          f"{N_REQ * N_WORDS / wall:.1f} generated tokens/s, "
          f"{wall / st['steps'] * 1e3:.4f} ms/step, pools {pool_int8} B "
          f"against fp32's {pool_fp32} B ({pool_fp32 / pool_int8:.3f}x), "
          f"kv_bytes_per_token {st['kv_bytes_per_token']}, "
          f"max_memory_allocated {torch.cuda.max_memory_allocated()} B, "
          f"paged_attention_int8 launches {counts['paged_attention_int8']}")

    handles = _lm_handles(model)
    worst, same, total = 0.0, 0, 0
    for seed, row, fp in zip(seeds, rows, fp_rows):
        if len(row) != len(seed) + N_WORDS or row[:len(seed)] != seed:
            raise AssertionError("returned row has the wrong shape")
        worst = max(worst, float(int8_forced_gaps(torch, ops, handles, row,
                                                  len(seed)).max()))
        same += sum(a == b for a, b in zip(row[len(seed):], fp[len(seed):]))
        total += N_WORDS
    if worst > 1e-3:
        raise AssertionError(f"int8 teacher forcing: a generated token sits "
                             f"{worst:.3e} below the position's maximum")
    print(f"int8 teacher forcing: {total} tokens checked against the plain "
          f"int8 window forward, largest gap to the position's max log-prob "
          f"{worst:.3e} (limit 1e-3); tokens equal to the fp32 stream "
          f"{same / total:.4f} (a reading: drift {1 - same / total:.4f} "
          f"beside KV_TOKEN_DRIFT_BUDGET {KV_TOKEN_DRIFT_BUDGET})")
    if profile:
        busy_ms = profile_decode(torch, model, seeds, kv_quant="int8")
        step_ms = wall / st["steps"] * 1e3
        print(f"profile: device idle share of the unprofiled int8 step "
              f"{1 - busy_ms / step_ms:.4f} ({busy_ms:.4f} of "
              f"{step_ms:.4f} ms/step busy)")
    return counts


def profile_decode(torch, model, seeds, kv_quant="off"):
    """Device time by kernel over a steady window of the same traffic."""
    from torch.profiler import ProfilerActivity, profile

    from bigdl_tpu_torch.serve.decode import ContinuousDecoder

    dec = ContinuousDecoder(model, max_slots=SLOTS, n_pos=N_POS,
                            page_size=PAGE, kv_quant=kv_quant,
                            device="cuda")
    for s in seeds[:SLOTS]:
        dec.submit(s, N_WORDS)
    dec.step_boundary()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(4):
            dec.step_boundary()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side rows only (kernels, memcpy, memset): each runs once
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda e: -e.device_time_total)
    busy = sum(e.device_time_total for e in rows) / 1e3   # ms
    steps = 4 * dec.sync_interval
    print(f"profile: {steps} steps, wall under the profiler "
          f"{wall * 1e3:.3f} ms ({wall / steps * 1e3:.4f} ms/step), device "
          f"busy {busy:.3f} ms ({busy / steps:.4f} ms/step, "
          f"{sum(e.count for e in rows) / steps:.1f} device ops/step)")
    for e in rows[:10]:
        print(f"profile:   {e.device_time_total / steps:9.2f} us/step "
              f"{e.count / steps:5.1f}/step  {e.key[:80]}")
    dec.run()
    return busy / steps


# ---------------------------------------------------------------------------
# serving's request features: the verify window at S = k+1, the prefix
# cache, speculative decode, sampled / stop-sequence requests, streaming,
# sampled lm_decode and beam search
# ---------------------------------------------------------------------------

def phase_verify_kernels(torch, ops, rows):
    """Both page walks on the speculative verify window: S = SPEC_K + 1
    queries a row at the decode width's 64-page tables, every row's head
    page the same physical page (a prefix hit's shared page), each window
    at its row's own positions (row 0's in its first page).  Each against
    its plain version and split at the plan's count, 1, 3 and 64 against
    the split-and-merge version; timed beside the plain version, SDPA over
    the gathered view (fp32) or dequantize + SDPA (int8) and the bound.
    Adds the figures to the two attention rows."""
    import torch.nn.functional as F

    from bigdl_tpu_torch.quant.kv import dequantize_view

    g = torch.Generator(device="cuda").manual_seed(16)
    hd, S = D_MODEL // HEADS, SPEC_K + 1
    pos = window_pos(SLOTS, S, N_POS)
    fp = paged_case(torch, g, SLOTS, S, HEADS, hd, PAGE, N_POS // PAGE, 512,
                    pos, shared=True)
    q8 = paged_int8_case(torch, g, SLOTS, S, HEADS, hd, PAGE,
                         N_POS // PAGE, 512, pos, shared=True)
    errs = {"fp32": check_paged(torch, ops, fp),
            "int8": check_paged_int8(torch, ops, q8)}
    for label, args in (("fp32", fp), ("int8", q8)):
        split_errs, plan, _ = check_splits(torch, ops, args,
                                           (None, 1, 3, N_POS // PAGE))
        errs |= {f"{label} splits={n}": e for n, e in split_errs.items()}
    flush = torch.empty(64 * 2**20, device="cuda")   # 256 MB > 50 MB L2
    view = sdpa_view(torch, fp)
    q, k, v, ptab, p, ks, vs = q8
    n_view, idx = ptab.shape[1] * PAGE, ptab.long()

    def dequant_sdpa():
        kv = [dequantize_view(t[idx], s[idx]).reshape(SLOTS, n_view, HEADS,
                                                      hd).transpose(1, 2)
              for t, s in ((k, ks), (v, vs))]
        return F.scaled_dot_product_attention(q.transpose(1, 2), *kv,
                                              attn_mask=view[3])

    fig = {
        "paged_attention": {
            "verify_ms": time_ms(torch, lambda: ops.paged_attention(*fp),
                                 flush),
            "verify_plain_ms": time_ms(
                torch, lambda: ops.paged_attention_reference(*fp), flush),
            "verify_library_ms": time_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    *view[:3], attn_mask=view[3]), flush),
            "verify_bound_ms": paged_bound(fp)[0]},
        "paged_attention_int8": {
            "verify_ms": time_ms(
                torch, lambda: ops.paged_attention_int8(*q8), flush),
            "verify_plain_ms": time_ms(
                torch, lambda: ops.paged_attention_int8_reference(*q8),
                flush),
            "verify_dequant_sdpa_ms": time_ms(torch, dequant_sdpa, flush),
            "verify_bound_ms": paged_int8_bound(q8)["bound_ms"]}}
    print(f"verify window (B={SLOTS} S={S} H={HEADS} hd={hd} ps={PAGE} "
          f"P={N_POS // PAGE}, shared head page, plan {plan} splits): " +
          "; ".join(f"{n} max_abs_err={e:.3e}" for n, e in errs.items()))
    nbytes = {"paged_attention": paged_bound(fp)[2],
              "paged_attention_int8": paged_int8_bound(q8)["bytes"]}
    for name, f in fig.items():
        print(f"{name} verify window: " + " ".join(
            f"{key[len('verify_'):]}={val:.5f}" for key, val in f.items())
            + f" ({nbytes[name]} bytes)")
    for row in rows:
        if row["name"] in fig:
            row |= fig[row["name"]]
            label = "fp32" if row["name"] == "paged_attention" else "int8"
            row["max_abs_err"] = max([row["max_abs_err"]] + [
                e for n, e in errs.items() if n.startswith(label)])


def chi2_limit(df):
    """The 0.999 quantile of chi-squared(df), Wilson-Hilferty."""
    return df * (1 - 2 / (9 * df) + 3.0902 * np.sqrt(2 / (9 * df))) ** 3


def serve_run(torch, ops, dec, reqs):
    """Submit ``reqs`` ((seed, sampling) pairs, N_WORDS each) and run the
    decoder from zeroed launch counts; (rows, counts, wall s, futures)."""
    futs = [dec.submit(s, N_WORDS, sampling=sp) for s, sp in reqs]
    _, counts, wall = run_path(torch, ops, dec.run)
    return [f.result(timeout=300) for f in futs], counts, wall, futs


def only_kernel(counts, name, n, label):
    if counts != {**untapped(counts), name: n}:
        raise AssertionError(f"{label} launches {counts}, expected {name} "
                             f"{n} and no other kernel")


def forced_worst(torch, ops, model, rows, seeds, int8=False):
    """The largest teacher-forcing gap over ``rows`` (their generated
    tokens only), under the plain fp32 or int8 forward."""
    from bigdl_tpu_torch.models.transformer import _lm_handles

    handles = _lm_handles(model) if int8 else None
    worst = 0.0
    for seed, row in zip(seeds, rows):
        if row[:len(seed)] != seed or len(row) <= len(seed):
            raise AssertionError("returned row has the wrong shape")
        gaps = (int8_forced_gaps(torch, ops, handles, row, len(seed)) if int8
                else forced_gaps(torch, model, row, len(seed)))
        worst = max(worst, float(gaps.max()))
    if worst > 1e-3:
        raise AssertionError(f"teacher forcing: a generated token sits "
                             f"{worst:.3e} below the position's maximum")
    return worst


def first_run(row, n_seed, start, n):
    """Generated tokens ``start .. start + n - 1`` of ``row`` as a stop
    sequence, and the row's length cut just past its first occurrence in
    the generated part (a stop sequence matches output only)."""
    gen = row[n_seed:]
    stop = gen[start:start + n]
    return stop, n_seed + next(j + n for j in range(len(gen) - n + 1)
                               if gen[j:j + n] == stop)


def serve_prefix(torch, ops, model, counts):
    """(b) two waves of N_REQ requests sharing a SYSTEM-token prompt, each
    with its own 16-64-token tail; the second hits the cache."""
    from bigdl_tpu_torch.serve import ContinuousDecoder

    rs = np.random.RandomState(16)
    system = rs.randint(0, VOCAB, size=SYSTEM).tolist()
    seeds = [system + rs.randint(0, VOCAB, size=int(rs.randint(16, 65)))
             .tolist() for _ in range(N_REQ)]
    dec = ContinuousDecoder(model, max_slots=SLOTS, n_pos=N_POS,
                            page_size=PAGE, prefix_cache=True, device="cuda")
    waves = []
    for w in (1, 2):
        steps0, pre0 = dec.steps, dec.stats()["prefix"]
        rows, c, wall, _ = serve_run(torch, ops, dec,
                                     [(s, None) for s in seeds])
        steps = dec.steps - steps0
        pre = dec.stats()["prefix"]
        only_kernel(c, "paged_attention", LAYERS * steps, f"prefix wave {w}")
        counts[f"serve_prefix_wave{w}"] = c
        worst = forced_worst(torch, ops, model, rows, seeds)
        hits = pre["hits"] - pre0["hits"]
        reused = pre["pages_reused"] - pre0["pages_reused"]
        waves.append((rows, steps))
        print(f"prefix wave {w}: {N_REQ} requests, {SYSTEM}-token system "
              f"prompt + 16..64-token tails, n_words={N_WORDS}: {steps} "
              f"steps, {hits} hits, {reused} pages reused, wall "
              f"{wall:.4f} s, {N_REQ * N_WORDS / wall:.1f} generated "
              f"tokens/s, {wall / steps * 1e3:.4f} ms/step, teacher "
              f"forcing largest gap {worst:.3e} (limit 1e-3)")
        if w == 2 and not (hits == N_REQ and steps < waves[0][1]):
            raise AssertionError(f"prefix wave 2: {hits} hits and {steps} "
                                 f"steps against wave 1's {waves[0][1]}")
    same = sum(a == b for a, b in zip(*(r for r, _ in waves)))
    st = dec.stats()
    if st["pool"]["in_use"] != st["prefix"]["entries"]:
        raise AssertionError(f"prefix: pages held past the cache: {st}")
    dec.close()
    print(f"prefix: {same} of {N_REQ} hit rows equal their cold rows "
          f"exactly; cache {st['prefix']}")


def serve_spec(torch, ops, model, seeds, counts):
    """(c) speculative decode, fp32 and int8 pools, beside the plain
    greedy decoder on the same seeds."""
    from bigdl_tpu_torch.serve import ContinuousDecoder

    kw = dict(max_slots=SLOTS, n_pos=N_POS, page_size=PAGE,
              prefix_cache=False, device="cuda")
    base = ContinuousDecoder(model, **kw)
    greedy, c, wall, _ = serve_run(torch, ops, base,
                                   [(s, None) for s in seeds])
    only_kernel(c, "paged_attention", LAYERS * base.steps, "greedy")
    counts["serve_greedy"] = c
    print(f"spec baseline, plain greedy: {base.steps} steps, wall "
          f"{wall:.4f} s, {N_REQ * N_WORDS / wall:.1f} generated tokens/s, "
          f"{wall / base.steps * 1e3:.4f} ms/step")
    for kv in ("off", "int8"):
        dec = ContinuousDecoder(model, spec_k=SPEC_K,
                                draft_layers=DRAFT_LAYERS, kv_quant=kv, **kw)
        rows, c, w, _ = serve_run(torch, ops, dec, [(s, None) for s in seeds])
        name = "paged_attention" + ("_int8" if kv == "int8" else "")
        only_kernel(c, name, dec.steps * (SPEC_K * DRAFT_LAYERS + LAYERS),
                    f"spec {kv}")
        counts["serve_spec" + ("_int8" if kv == "int8" else "")] = c
        worst = forced_worst(torch, ops, model, rows, seeds, kv == "int8")
        st = dec.stats()
        same = sum(a == b for a, b in zip(rows, greedy))
        print(f"spec k={SPEC_K} draft_layers={DRAFT_LAYERS} kv {kv}: "
              f"{dec.steps} steps ({base.steps} greedy), {st['host_syncs']}"
              f" host syncs, wall {w:.4f} s, {N_REQ * N_WORDS / w:.1f} "
              f"generated tokens/s ({N_REQ * N_WORDS / wall:.1f} greedy), "
              f"{w / dec.steps * 1e3:.4f} ms/step ({wall / base.steps * 1e3:.4f}"
              f" greedy), acceptance histogram {st['accept_hist']} over "
              f"{st['spec_windows']} decode windows (mean "
              f"{st['accept_mean']:.4f}), {name} launches {c[name]} = "
              f"{dec.steps} x ({SPEC_K} x {DRAFT_LAYERS} + {LAYERS}), "
              f"teacher forcing largest gap {worst:.3e} (limit 1e-3), "
              f"{same} of {N_REQ} rows equal to greedy's")


def serve_mixed(torch, ops, model, seeds, counts):
    """(d) greedy, sampled and stop-sequence requests in one batch: the
    greedy rows are the greedy-only run's, a sampled request replays in
    another slot beside other companions, a stop request ends just past
    its match; then 20,000 draws of ``sample_tokens`` from one filtered
    row against its probabilities."""
    import torch.nn.functional as F

    from bigdl_tpu_torch.serve import ContinuousDecoder
    from bigdl_tpu_torch.serve import sampling as smp

    kw = dict(max_slots=SLOTS, n_pos=N_POS, page_size=PAGE,
              prefix_cache=False, device="cuda")
    # the longest seed is a greedy row, so the table width a cycle passes
    # (the longest live reach) is the same in every run below
    order = sorted(range(N_REQ), key=lambda i: -len(seeds[i]))[:SLOTS]
    greedy_ix, sampled_ix, stop_ix = order[:3], order[3:6], order[6:8]
    sp = [dict(SAMPLED, seed=100 + i) for i in range(3)]
    plain = ContinuousDecoder(model, **kw)
    ref, _, _, _ = serve_run(torch, ops, plain,
                             [(seeds[i], None) for i in order])
    stops = [first_run(ref[6 + j], len(seeds[i]), 20 + 5 * j, 3)
             for j, i in enumerate(stop_ix)]
    reqs = ([(seeds[i], None) for i in greedy_ix]
            + [(seeds[i], p) for i, p in zip(sampled_ix, sp)]
            + [(seeds[i], {"stop": [st]})
               for i, (st, _) in zip(stop_ix, stops)])
    dec = ContinuousDecoder(model, **kw)
    rows, c, wall, _ = serve_run(torch, ops, dec, reqs)
    only_kernel(c, "paged_attention", LAYERS * dec.steps, "mixed")
    counts["serve_mixed"] = c
    if rows[:3] != ref[:3]:
        raise AssertionError("mixed batch: a greedy row differs from the "
                             "greedy-only run's")
    for k, (i, (st, end)) in enumerate(zip(stop_ix, stops)):
        if rows[6 + k] != ref[6 + k][:end]:
            raise AssertionError(f"stop request {k} did not end just past "
                                 f"its match at {end}")
    st = dec.stats()
    if st["stop_retired"] != 2 or st["sampled"] != 3:
        raise AssertionError(f"mixed batch stats {st}")
    # the first sampled request again, in slot 2, beside other companions
    # (the longest greedy request kept, so the same table widths)
    again = ContinuousDecoder(model, **kw)
    alone, _, _, _ = serve_run(torch, ops, again, [
        (seeds[greedy_ix[0]], None), (seeds[stop_ix[0]], None),
        (seeds[sampled_ix[0]], sp[0])])
    if alone[2] != rows[3]:
        raise AssertionError("a sampled request drew another row in "
                             "another slot beside other companions")
    worst = forced_worst(torch, ops, model, rows[:3], [r[0] for r in reqs])
    print(f"mixed batch: 3 greedy, 3 sampled {SAMPLED}, 2 stop requests, "
          f"{dec.steps} steps, wall {wall:.4f} s: greedy rows equal the "
          f"greedy-only run's, the sampled row replays in slot 2, stop rows "
          f"end at {[e - len(seeds[i]) for i, (_, e) in zip(stop_ix, stops)]}"
          f" generated tokens (steps saved {st['steps_saved']}), greedy "
          f"teacher forcing {worst:.3e}")
    # the sampler alone: one filtered row of the model's log-probs
    with torch.no_grad():
        ids = torch.tensor([seeds[0]], device="cuda")
        lp = model(F.one_hot(ids, VOCAB).float())[0, -1]
    filt = (SAMPLED["temperature"], SAMPLED["top_k"], SAMPLED["top_p"])
    rows_lp = lp.expand(2000, VOCAB)
    # the probabilities of the filter as the sampler computes it (the
    # same shape: the top-p prefix sum rounds as in the draws)
    probs = torch.softmax(smp.filter_logits(rows_lp, *filt)[0],
                          dim=-1).double()
    drawn = torch.zeros(VOCAB, dtype=torch.int64, device="cuda")
    base = smp.key_data(31, "cuda")
    for lo in range(0, CHI_DRAWS, 2000):
        keys = smp.fold_in_rows(base.expand(2000, 2),
                                torch.arange(lo, lo + 2000, device="cuda"))
        drawn += torch.bincount(smp.sample_tokens(rows_lp, keys, *filt),
                                minlength=VOCAB)
    counts_np, p = drawn.cpu().numpy(), probs.cpu().numpy()
    if counts_np[p == 0].sum():
        raise AssertionError("sample_tokens drew a filtered-out token")
    big = p > 0.001
    exp = CHI_DRAWS * np.append(p[big], p[~big].sum())
    obs = np.append(counts_np[big], counts_np[~big].sum())
    keep = exp > 0
    stat = float(((obs[keep] - exp[keep]) ** 2 / exp[keep]).sum())
    limit = chi2_limit(int(big.sum()))
    if stat > limit:
        raise AssertionError(f"sample_tokens chi2 {stat:.2f} > {limit:.2f}")
    print(f"sample_tokens: {CHI_DRAWS} draws of one filtered row ({filt}, "
          f"{int((p > 0).sum())} tokens kept, {int(big.sum())} with p > "
          f"0.001): chi2 {stat:.2f} (0.999 quantile {limit:.2f})")


def serve_stream(torch, ops, model, seeds, fp_rows, counts, smi):
    """(e) the 16-request wave streamed: the chunks equal each row's tail;
    time to first token and inter-token latency as the client's callbacks
    see them."""
    from bigdl_tpu_torch.serve import ContinuousDecoder

    dec = ContinuousDecoder(model, max_slots=SLOTS, n_pos=N_POS,
                            page_size=PAGE, device="cuda")
    seen = [[] for _ in seeds]
    futs = []
    for i, s in enumerate(seeds):
        f = dec.submit(s, N_WORDS)
        f.on_tokens(lambda toks, i=i: seen[i].append(
            (time.perf_counter(), list(toks))))
        futs.append(f)
    _, c, wall = run_path(torch, ops, dec.run)
    rows = [f.result(timeout=300) for f in futs]
    only_kernel(c, "paged_attention", LAYERS * dec.steps, "streaming")
    counts["serve_stream"] = c
    ttft, itl = [], []
    for f, chunks, s, row in zip(futs, seen, seeds, rows):
        if [t for _, ch in chunks for t in ch] != row[len(s):]:
            raise AssertionError("streamed chunks differ from the row")
        ttft.append(chunks[0][0] - f.t_create)
        for (t0, _), (t1, ch) in zip(chunks, chunks[1:]):
            itl += [(t1 - t0) / len(ch)] * len(ch)
    same = sum(a == b for a, b in zip(rows, fp_rows))
    st = dec.stats()
    dec.close()
    print(f"{smi} streaming: {N_REQ} requests, {st['stream']['boundaries']}"
          f" boundaries, {st['host_syncs']} host syncs, wall {wall:.4f} s; "
          f"time to first token p50 {np.percentile(ttft, 50) * 1e3:.4f} ms "
          f"p99 {np.percentile(ttft, 99) * 1e3:.4f} ms; inter-token latency "
          f"p50 {np.percentile(itl, 50) * 1e3:.4f} ms p99 "
          f"{np.percentile(itl, 99) * 1e3:.4f} ms; chunks equal every row's "
          f"tail; {same} of {N_REQ} rows equal the unstreamed run's")


def serve_offline(torch, ops, model, seeds, counts):
    """(f) sampled ``lm_decode`` twice under one key, and
    ``lm_beam_search(beam_size=1)`` against greedy ``lm_decode``."""
    from bigdl_tpu_torch.models.transformer import lm_beam_search, lm_decode

    seed, n = seeds[0][:64], 32
    kw = dict(greedy=False, key=7, temperature=SAMPLED["temperature"],
              top_k=SAMPLED["top_k"], top_p=SAMPLED["top_p"], device="cuda")
    (a, b), c, wall = run_path(torch, ops, lambda: (
        lm_decode(model, seed, n, **kw), lm_decode(model, seed, n, **kw)))
    only_kernel(c, "paged_attention", 2 * LAYERS * (len(seed) + n - 1),
                "sampled lm_decode")
    counts["lm_decode_sampled"] = c
    if a != b or len(a) != len(seed) + n:
        raise AssertionError("sampled lm_decode is not deterministic under "
                             "one key")
    (beam, greedy), c, _ = run_path(torch, ops, lambda: (
        lm_beam_search(model, seed, n, beam_size=1, device="cuda"),
        lm_decode(model, seed, n, device="cuda")))
    only_kernel(c, "paged_attention", 2 * LAYERS * (len(seed) + n - 1),
                "beam search")
    counts["beam_search"] = c
    if beam != greedy:
        raise AssertionError("lm_beam_search(beam_size=1) differs from "
                             "greedy lm_decode")
    rows, scores = lm_beam_search(model, seed, n, beam_size=4,
                                  return_all=True, device="cuda")
    if scores != sorted(scores, reverse=True) or len(set(map(tuple, rows))) \
            != 4:
        raise AssertionError("beam search rows not distinct or unsorted")
    print(f"lm_decode sampled (key 7, {n} words after {len(seed)}): the same "
          f"row twice, {wall:.4f} s for both; lm_beam_search beam 1 equals "
          f"greedy lm_decode; beam 4 scores {[round(s, 4) for s in scores]}")


def phase_serve_features(torch, ops, model, seeds, fp_rows):
    """Serving's request features at full width on the card, each path
    read from zeroed launch counts: (b) the prefix cache, (c) speculative
    decode (fp32 and int8), (d) a mixed batch and the sampler, (e)
    streaming, (f) sampled ``lm_decode`` and beam search."""
    counts = {}
    smi = smi_line()
    serve_prefix(torch, ops, model, counts)
    serve_spec(torch, ops, model, seeds, counts)
    serve_mixed(torch, ops, model, seeds, counts)
    serve_stream(torch, ops, model, seeds, fp_rows, counts, smi)
    serve_offline(torch, ops, model, seeds, counts)
    return counts


# ---------------------------------------------------------------------------
# serving's tensor parallelism: ContinuousDecoder(mesh=) with each rank's
# heads, its own pools and two all-reduces a block
# ---------------------------------------------------------------------------

#: the tensor-parallel runs: (kv_quant, spec_k); the fp32 pools greedy,
#: the int8 pools with speculative decode, both with the prefix cache
TP_JOBS = (("off", 0), ("int8", TP_SPEC_K))


def serve_tp_child(backend, seeds, jobs, profile_nccl):
    """One rank of the tensor-parallel serving runs: the serving model
    from seed 0 built on the CPU, its shard moved to this rank's card by
    ``ContinuousDecoder(mesh=hybrid_mesh(1, world))``, the model axis
    over ``backend``'s group (gloo ranks share the one card).  Each job
    of ``jobs`` serves ``seeds`` after a warm-up, from zeroed launch
    counts and a count of the step's all-reduces; with ``profile_nccl``
    the greedy job is served again under the profiler, for the NCCL
    kernels' device time.  Returns each job's rows, launch counts,
    all-reduces, wall, stats and pools."""
    import torch
    import torch.distributed as dist

    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.models import transformer as tt
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.parallel.mesh import hybrid_mesh
    from bigdl_tpu_torch.serve import ContinuousDecoder, continuous_decode
    from bigdl_tpu_torch.utils.device import pin_fp32
    from bigdl_tpu_torch.utils.random import generator

    pin_fp32(torch.device("cuda"))
    model = TransformerLM(VOCAB, D_MODEL, HEADS, LAYERS, HIDDEN,
                          dropout=0.0, device="cpu",
                          generator=generator(0)).evaluate()
    mesh = hybrid_mesh(1, dist.get_world_size(),
                       "cpu" if backend == "gloo" else "cuda")
    reduces, all_reduce = [0], tt.all_reduce

    def counted(*args, **kwargs):
        reduces[0] += 1
        return all_reduce(*args, **kwargs)

    tt.all_reduce = counted
    out = []
    for kv, spec in jobs:
        kw = dict(max_slots=SLOTS, n_pos=N_POS, page_size=PAGE,
                  kv_quant=kv, spec_k=spec, draft_layers=DRAFT_LAYERS,
                  prefix_cache=True, device="cuda", mesh=mesh)
        continuous_decode(model, [[1, 2, 3]], 4, **kw)     # warm-up
        dec = ContinuousDecoder(model, **kw)
        futs = [dec.submit(s, N_WORDS) for s in seeds]
        dist.barrier()
        reduces[0] = 0
        _, counts, wall = run_path(torch, ops, dec.run)
        res = {"rows": [f.result(timeout=60) for f in futs],
               "counts": counts, "reduces": reduces[0], "wall": wall,
               "stats": dec.stats(),
               "index": mesh.axis("model").index,
               "pools": [tuple(c.shape) for c in dec._caches],
               "pool_bytes": sum(c.numel() * c.element_size()
                                 for c in dec._caches)}
        dec.close()
        if profile_nccl and spec == 0:
            res["nccl"] = nccl_serve_window(torch, model, seeds, kw)
        out.append(res)
        dist.barrier()
    return out


def nccl_serve_window(torch, model, seeds, kw):
    """The greedy job again under the profiler: (the NCCL kernels' device
    ms, the whole run's wall ms, steps)."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from bigdl_tpu_torch.serve import ContinuousDecoder

    dec = ContinuousDecoder(model, **kw)
    for s in seeds:
        dec.submit(s, N_WORDS)
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        dec.run()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    nccl = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == cuda and "nccl" in e.name().lower())
    steps = dec.steps
    dec.close()
    return nccl / 1e6, wall, steps


def held_tp_runs(torch, ops, model, seeds, ranks, label):
    """The rank results of ``serve_tp_child``, job by job: every rank's
    rows identical; each rank's launches exactly its path's (the greedy
    job ``paged_attention`` LAYERS a step, the speculative int8 job
    ``paged_attention_int8`` k x DRAFT_LAYERS + LAYERS a window) and
    no other kernel, and two all-reduces a block of each forward; every
    generated token within 1e-3 of its position's maximum under the
    whole model on this card (the plain int8 window forward for int8
    pools); each rank's pools its own H/tp heads, the whole pool's bytes
    over tp.  Returns {path: counts} and each job's
    (rows, ms a step, steps)."""
    mp = len(ranks)
    by_path, jobs = {}, []
    for j, (kv, spec) in enumerate(TP_JOBS):
        runs = [r[j] for r in ranks]
        rows = runs[0]["rows"]
        if any(r["rows"] != rows for r in runs):
            raise AssertionError(f"{label} {kv}: the ranks' rows differ")
        path = f"{label}" + ("_int8" if kv == "int8" else "")
        for r in runs:
            st = r["stats"]
            if spec:
                want = ("paged_attention_int8",
                        st["steps"] * (spec * DRAFT_LAYERS + LAYERS))
            else:
                want = ("paged_attention", st["steps"] * LAYERS)
            only_kernel(r["counts"], *want, f"{path} rank {r['index']}")
            if r["reduces"] != 2 * want[1]:
                raise AssertionError(f"{path} rank {r['index']}: "
                                     f"{r['reduces']} all-reduces, not two "
                                     f"a block of {want[1]}")
            by_path[f"{path}_r{r['index']}"] = r["counts"]
            tokens = (st["pool"]["pages"] + 1) * PAGE
            whole = tokens * st["kv_bytes_per_token"]
            if (st["tp"] != mp or r["pool_bytes"] * mp != whole
                    or any(s[3] != HEADS // mp for s in r["pools"])):
                raise AssertionError(
                    f"{path} rank {r['index']}: tp {st['tp']}, pools "
                    f"{r['pools']} of {r['pool_bytes']} B, the whole pool "
                    f"{whole} B")
        worst = forced_worst(torch, ops, model, rows, seeds, kv == "int8")
        st = runs[0]["stats"]
        step_ms = max(r["wall"] for r in runs) / st["steps"] * 1e3
        print(f"{label} {kv}{f' spec k={spec}' if spec else ''} at mp "
              f"{mp}: {len(seeds)} requests, {st['steps']} steps, "
              f"{st['host_syncs']} host syncs, {st['tp_checks']} digest "
              f"checks, {step_ms:.4f} ms/step (the slowest rank's wall), "
              f"every rank's rows identical, teacher forcing largest gap "
              f"{worst:.3e} (limit 1e-3); launches a rank "
              f"{ops_nonzero(runs[0]['counts'])}, all-reduces "
              f"{runs[0]['reduces']}; pools a rank "
              f"{runs[0]['pool_bytes']} B {runs[0]['pools'][0]} "
              f"(the whole pool {runs[0]['pool_bytes'] * mp} B)")
        jobs.append((rows, step_ms, st["steps"]))
    return by_path, jobs


def same_share(rows, want, seeds):
    """The share of generated tokens of ``rows`` equal to ``want``'s."""
    same = total = 0
    for row, w, s in zip(rows, want, seeds):
        same += sum(a == b for a, b in zip(row[len(s):], w[len(s):]))
        total += len(row) - len(s)
    return same / total


def tp_requests(seeds, fp_rows):
    """The serving phase's TP_REQ shortest requests, in its order, and
    their one-card rows."""
    keep = sorted(sorted(range(len(seeds)), key=lambda i: len(seeds[i]))
                  [:TP_REQ])
    return [seeds[i] for i in keep], [fp_rows[i] for i in keep]


def phase_serve_tp(torch, ops, model, seeds, fp_rows):
    """Serving's tensor parallelism on the one card: the model axis of
    ``hybrid_mesh(1, TP_ONE_CARD)`` as gloo ranks (gloo's all-reduce takes
    CUDA tensors, through the host; NCCL takes no two ranks on one card),
    each rank the serving model's shard on the card, TP_JOBS over the
    serving phase's TP_REQ shortest requests; held by ``held_tp_runs``.  The
    step time is a reading of this layout, not a tensor-parallel speed.
    Returns the paths' launch counts."""
    from bigdl_tpu_torch.parallel.launch import launch

    seeds, fp_rows = tp_requests(seeds, fp_rows)
    ranks = launch(serve_tp_child, TP_ONE_CARD, "gloo",
                   args=("gloo", seeds, TP_JOBS, False))
    by_path, jobs = held_tp_runs(torch, ops, model, seeds, ranks, "serve_tp")
    smi = smi_line()
    print(f"serve_tp: fp32 rows' tokens equal to the one-card serving "
          f"phase's {same_share(jobs[0][0], fp_rows, seeds):.4f}, the int8 "
          f"speculative rows' {same_share(jobs[1][0], fp_rows, seeds):.4f} "
          f"(a reading); {jobs[0][1]:.4f} / {jobs[1][1]:.4f} ms/step with "
          f"{TP_ONE_CARD} gloo ranks on one card [{smi}]")
    return by_path


def phase_serve_cards(torch, ops, model, seeds, fp_rows):
    """Serving's tensor parallelism across TP_CARDS cards, one NCCL rank a
    card, where the machine has them: TP_JOBS over the TP_REQ shortest
    requests held by ``held_tp_runs``; ms a step beside the one-card
    decoder's on the same requests and the NCCL kernels' share of a
    profiled greedy run's wall."""
    from bigdl_tpu_torch.parallel.launch import launch
    from bigdl_tpu_torch.serve import ContinuousDecoder

    smi = smi_line()
    if torch.cuda.device_count() < TP_CARDS:
        print(f"serve cards: {torch.cuda.device_count()} card(s): the "
              f"{TP_CARDS}-card tensor-parallel decoder needs {TP_CARDS}; "
              f"[{smi}]")
        return {}
    seeds, fp_rows = tp_requests(seeds, fp_rows)
    ranks = launch(serve_tp_child, TP_CARDS, "nccl",
                   args=("nccl", seeds, TP_JOBS, True))
    by_path, jobs = held_tp_runs(torch, ops, model, seeds, ranks,
                                 "serve_cards")
    one = []
    for kv, spec in TP_JOBS:
        dec = ContinuousDecoder(model, max_slots=SLOTS, n_pos=N_POS,
                                page_size=PAGE, kv_quant=kv, spec_k=spec,
                                draft_layers=DRAFT_LAYERS, device="cuda")
        futs = [dec.submit(s, N_WORDS) for s in seeds]
        _, _, wall = run_path(torch, ops, dec.run)
        one.append((wall / dec.steps * 1e3,
                    [f.result(timeout=60) for f in futs]))
        dec.close()
    nccl_ms, wall_ms, steps = ranks[0][0]["nccl"]
    print(f"serve_cards: ms/step {jobs[0][1]:.4f} (fp32) and "
          f"{jobs[1][1]:.4f} (int8 spec) on {TP_CARDS} cards against one "
          f"card's {one[0][0]:.4f} and {one[1][0]:.4f}; rows' tokens equal "
          f"to one card's {same_share(jobs[0][0], one[0][1], seeds):.4f} / "
          f"{same_share(jobs[1][0], one[1][1], seeds):.4f}; the NCCL "
          f"kernels {nccl_ms / steps:.4f} device ms a step of a profiled "
          f"greedy run's {wall_ms / steps:.4f} ms/step (share "
          f"{nccl_ms / wall_ms:.4f}, rank 0) [{smi}]")
    return by_path


# ---------------------------------------------------------------------------
# the training harness's host side: n steps a dispatch as one CUDA graph,
# the background prefetch, checkpoints that resume the same trajectory
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def prefetch_set(on: bool):
    """``BIGDL_PREFETCH`` on or off for the runs inside."""
    import os

    old = os.environ.get("BIGDL_PREFETCH")
    os.environ["BIGDL_PREFETCH"] = "1" if on else "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["BIGDL_PREFETCH"]
        else:
            os.environ["BIGDL_PREFETCH"] = old


@contextlib.contextmanager
def deterministic(torch):
    """``torch.use_deterministic_algorithms`` for the runs inside (cuDNN's
    deterministic algorithms), so two runs of one trajectory can be held
    bit for bit."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def _params(torch, model):
    return torch.cat([p.detach().float().cpu().reshape(-1)
                      for p in model.parameters()])


def held_same(torch, label, a, b, tol):
    """Two runs of one trajectory on the card: bits where they agree,
    else within ``tol`` (losses rtol, params atol); the rule held."""
    la = np.asarray([l for _, l in a.loss_log])
    lb = np.asarray([l for _, l in b.loss_log])
    pa, pb = _params(torch, a.model), _params(torch, b.model)
    if len(la) != len(lb) or len(la) == 0:
        raise AssertionError(f"{label}: {len(la)} and {len(lb)} losses")
    if np.array_equal(la, lb) and torch.equal(pa, pb):
        return "bits"
    rel = float(np.max(np.abs(la - lb) / np.abs(lb)))
    p_abs = float((pa - pb).abs().max())
    print(f"{label}: losses {rel:.3e} relative apart, params {p_abs:.3e}")
    if rel > tol["rtol"] or p_abs > tol["atol"]:
        raise AssertionError(f"{label}: the two runs part beyond {tol}")
    return f"within rtol {tol['rtol']} / atol {tol['atol']}"


def held_to_cpu_run(torch, label, card, cpu):
    """A card run against the same run on the CPU: losses within
    LOSS_RTOL, final params within PARAM_ATOL."""
    got = np.asarray([l for _, l in card.loss_log])
    want = np.asarray([l for _, l in cpu.loss_log])
    rel = float(np.max(np.abs(got - want) / np.abs(want)))
    p_abs = float((_params(torch, card.model) - _params(torch, cpu.model))
                  .abs().max())
    print(f"{label} vs CPU: {len(got)} losses, largest relative difference "
          f"{rel:.3e} (limit {LOSS_RTOL}); params {p_abs:.3e} (limit "
          f"{PARAM_ATOL})")
    if len(got) != len(want) or rel > LOSS_RTOL or p_abs > PARAM_ATOL:
        raise AssertionError(f"{label}: the card's run left the CPU's")


def dispatch_runs(torch, ops, label, make, steps, per_step):
    """``make(device, n, graph)`` builds an optimizer; each of: one step a
    dispatch with the prefetch off and on, n = HDISPATCH as an eager
    loop, n = HDISPATCH as one CUDA graph (on the card), and n =
    HDISPATCH on the CPU, takes HDISPATCH
    warm-up steps, then ``steps`` more in a second ``optimize()`` (each
    call starts from zero velocity), timed, its launches counted by the
    wrappers: ``per_step`` a step in the eager runs, and in the graph run
    ``per_step`` for each of the HDISPATCH steps its one capture
    recorded.  The graph run is held to the eager loop (bits where the
    deterministic algorithms give them, else GRAPH_TOL) and to the CPU.
    Then each card run takes ``steps`` more steps (READ["profiled"] where
    it is set) under the profiler: its device ms a step, and its kernels
    as the card ran them, counted by name (``per_step`` a step in every
    run, the graph's replays included).  Returns the graph run's wrapper
    counts, the kernels its profiled replays ran."""
    from bigdl_tpu_torch.optim import max_iteration

    runs = {}
    with deterministic(torch):
        for name, device, n, graph, fetch in (
                ("n=1 prefetch off", "cuda", 1, True, False),
                ("n=1", "cuda", 1, True, True),
                (f"n={HDISPATCH} eager", "cuda", HDISPATCH, False, True),
                (f"n={HDISPATCH} graph", "cuda", HDISPATCH, True, True),
                (f"n={HDISPATCH} cpu", "cpu", HDISPATCH, False, True)):
            with prefetch_set(fetch):
                opt = make(device, n, graph)
                opt.set_end_when(max_iteration(HDISPATCH)).optimize()
                opt.set_end_when(max_iteration(HDISPATCH + steps))
                if device == "cuda":
                    _, counts, wall = run_path(torch, ops, opt.optimize)
                else:
                    t0 = time.perf_counter()
                    opt.optimize()
                    counts, wall = {}, time.perf_counter() - t0
            runs[name] = (opt, counts, wall, fetch)
    graph, counts, _, _ = runs[f"n={HDISPATCH} graph"]
    replays = steps // HDISPATCH
    for name, (opt, c, _, _) in runs.items():
        if name.endswith("cpu"):
            continue
        per_run = HDISPATCH if opt is graph else steps
        want = {**untapped(c),
                **{k: v * per_run for k, v in per_step.items()}}
        if c != want:
            raise AssertionError(f"{label} {name}: the wrappers counted "
                                 f"{c}, expected {want}")
    if graph.replays != replays or graph.captures != 1:
        raise AssertionError(f"{label} graph: {graph.captures} captures, "
                             f"{graph.replays} replays (expected 1, "
                             f"{replays})")
    rule = held_same(torch, f"{label} graph vs eager",
                     runs[f"n={HDISPATCH} eager"][0], graph, GRAPH_TOL)
    held_same(torch, f"{label} prefetch on vs off", runs["n=1"][0],
              runs["n=1 prefetch off"][0], GRAPH_TOL)
    held_to_cpu_run(torch, f"{label} graph", graph,
                    runs[f"n={HDISPATCH} cpu"][0])
    ran = {}
    profiled = READ["profiled"] or steps
    want_ran = {k: v * profiled for k, v in per_step.items()}
    for name, (opt, c, wall, fetch) in runs.items():
        if name.endswith("cpu"):
            continue
        step_ms = wall / steps * 1e3
        with prefetch_set(fetch):
            busy, ran[name] = profiled_run(torch, opt, profiled)
        print(f"{label} {name}: {step_ms:.4f} ms/step, device "
              f"{busy:.4f} ms/step busy, idle share "
              f"{1 - busy / step_ms:.4f}; launches counted by the "
              f"wrappers {ops_nonzero(c)}; kernels the card ran under the "
              f"profiler, {profiled} steps {ran[name]}")
        if ran[name] != want_ran:
            raise AssertionError(f"{label} {name}: the card ran "
                                 f"{ran[name]} of the port's kernels in "
                                 f"{profiled} steps, expected {want_ran}")
    losses = [l for _, l in graph.loss_log]
    print(f"{label}: n={HDISPATCH} steps a dispatch as one CUDA graph, "
          f"{replays} replays of one capture; the wrappers counted the "
          f"capture's launches ({per_step} a step x {HDISPATCH} steps), the "
          f"profiler counted the replays' kernels ({per_step} a step x "
          f"{profiled} steps); held to the eager n={HDISPATCH} loop by "
          f"{rule}; "
          f"losses {losses[0]:.6f} -> {losses[-1]:.6f}")
    return counts, ran[f"n={HDISPATCH} graph"]


def ops_nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def untapped(counts):
    """Every count of ``counts`` at 0 but ``fused_sgd_taps``, kept: the
    gate a path's launches are held to.  The taps form's launches count
    in ``fused_sgd`` (or ``fused_sgd_scaled``) as every SGD launch does,
    and apart in ``fused_sgd_taps`` where the run had its taps on (the
    default; off under tensor and expert parallelism): the ``obs`` phase
    gates that count, the kernels line sums it by path."""
    return {**dict.fromkeys(counts, 0),
            **{k: v for k, v in counts.items() if k == "fused_sgd_taps"}}


def kernel_of(name):
    """The wrapper whose kernel the profiler's kernel ``name`` is (its
    demangled or mangled symbol), or None."""
    for wrapper, forms in KERNEL_SYMBOLS.items():
        if any(all(part in name for part in form) for form in forms):
            return wrapper
    return None


def profiled_run(torch, opt, steps):
    """``steps`` more steps of ``opt`` under torch.profiler: (device busy
    ms a step: kernels, copies and sets, graph replays' kernels included;
    {wrapper: runs of its kernel}, the kernels the card ran, counted by
    name)."""
    from torch.profiler import ProfilerActivity, profile

    from bigdl_tpu_torch.optim import max_iteration

    opt.set_end_when(max_iteration(int(opt.state["neval"]) - 1 + steps))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        # one throwaway kernel, run to its end, before the counted steps:
        # a window's first kernel record went missing once as the
        # profiler started (SimpleRNN's first rnn_forward, 15 of 16)
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        opt.optimize()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    ran = {}
    for e in rows:
        wrapper = kernel_of(e.key)
        if wrapper is not None:
            ran[wrapper] = ran.get(wrapper, 0) + e.count
    return sum(e.device_time_total for e in rows) / 1e3 / steps, ran


def prefetch_graph_run(torch, ops, label, make, per_step):
    """The prefetch on, HDISPATCH steps a dispatch as one CUDA graph:
    the loop's own dispatch leaves the host, so the producer's batches
    overlap the replays.  A warm-up chunk, then two dispatches timed and
    counted (the wrappers count ``per_step`` a step of the one capture),
    then two more (READ["profiled"] steps where it is set) under the
    profiler, which counts the kernels the replays ran (``per_step`` a
    step).  Returns the wrapper counts and the profiler's."""
    from bigdl_tpu_torch.optim import max_iteration
    from bigdl_tpu_torch.utils.random import RNG

    steps = 2 * HDISPATCH
    with prefetch_set(True), deterministic(torch):
        RNG.set_seed(0)
        opt = make(max_iteration(HDISPATCH))
        opt.set_iterations_per_dispatch(HDISPATCH).optimize()
        opt.set_end_when(max_iteration(HDISPATCH + steps))
        fetch0, _ = opt.metrics.get("data fetch time")
        _, counts, wall = run_path(torch, ops, opt.optimize)
        fetch_s = opt.metrics.get("data fetch time")[0] - fetch0
        profiled = READ["profiled"] or steps
        busy, ran = profiled_run(torch, opt, profiled)
    want = {**untapped(counts),
            **{k: v * HDISPATCH for k, v in per_step.items()}}
    want_ran = {k: v * profiled for k, v in per_step.items()}
    losses = [l for _, l in opt.loss_log]
    if counts != want or ran != want_ran or opt.replays < 2 \
            or not np.isfinite(losses).all():
        raise AssertionError(f"harness {label} graph: the wrappers counted "
                             f"{counts}, expected {want}; the card ran "
                             f"{ran}, expected {want_ran}; {opt.replays} "
                             f"replays; losses {losses}")
    step_ms = wall / steps * 1e3
    print(f"harness {label} prefetch on, {HDISPATCH} a dispatch as one CUDA "
          f"graph: {steps} steps, {step_ms:.4f} ms/step, host (the loop's "
          f"wait) {fetch_s / wall:.4f} of the loop, device {busy:.4f} "
          f"ms/step busy, idle share {1 - busy / step_ms:.4f}; the wrappers "
          f"counted the capture's launches {ops_nonzero(counts)}, the "
          f"profiler the replays' kernels in {profiled} steps {ran}; losses "
          f"{' '.join(f'{l:.6f}' for l in losses[-steps:])}")
    return counts, ran


def graph_or_eager(opt, n, graph):
    """``opt`` at n steps a dispatch: one CUDA graph on the card, or with
    ``graph`` False the eager loop (the reference the graph is held to)."""
    opt.set_iterations_per_dispatch(n)._cuda_graph = graph
    return opt


def classification_set(n, seed):
    """tests/test_training.py's linearly separable classes, widened: 32
    features, 10 classes, labels 1..10."""
    from bigdl_tpu_torch.dataset import Sample

    rng = np.random.RandomState(seed)
    w = np.random.RandomState(99).randn(HFEATURES, HCLASSES) * 2
    xs = rng.randn(n, HFEATURES).astype(np.float32)
    ys = (xs @ w).argmax(1) + 1.0
    return [Sample(x, np.asarray([y])) for x, y in zip(xs, ys)]


def learnable_run(device, n, graph, val=True):
    """A Linear-Tanh-Dropout-Linear classifier of the learnable set,
    batch 128, lr 0.5, momentum 0.9, Top1 every epoch."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet, SampleToBatch
    from bigdl_tpu_torch.optim import (LocalOptimizer, Top1Accuracy,
                                       every_epoch)
    from bigdl_tpu_torch.utils.random import generator
    from bigdl_tpu_torch.utils.table import T

    g = generator(0)
    model = nn.Sequential(nn.Linear(HFEATURES, 64, generator=g), nn.Tanh(),
                          nn.Dropout(0.3), nn.Linear(64, HCLASSES,
                                                     generator=g),
                          nn.LogSoftMax()).to(device)
    train = DataSet.array(classification_set(HLEARN, 0)) >> SampleToBatch(
        128)
    opt = LocalOptimizer(model, train, nn.ClassNLLCriterion(), device=device)
    opt.set_state(T(learningRate=0.5, momentum=0.9))
    graph_or_eager(opt, n, graph)
    if val:
        held = DataSet.array(classification_set(1024, 1)) >> SampleToBatch(
            128)
        opt.set_validation(every_epoch(), held, [Top1Accuracy()])
    return opt


def phase_harness(torch, ops):
    """The harness's host side on the card: LeNet-5 and SimpleRNN at n =
    8 a dispatch through one CUDA graph (held to the eager loop and to the
    CPU, beside one step a dispatch), a classifier with dropout in the
    graph (masks advanced at each replay, as the eager loop draws them)
    whose Top1 rises; Inception-v1 and the Bi-LSTM with the prefetch on
    and off (equal losses, host share, ms a step and idle share), and
    Inception-v1 with the prefetch feeding an 8-step graph; a checkpoint
    resumed on the card past corrupt snapshots, which without its random
    payload leaves the run.  Returns the wrappers' launch counts of each
    path, and the kernels the graph paths' replays ran under the
    profiler."""
    import tempfile

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import (DataSet, HFlip, ImgNormalizer,
                                         ImgRdmCropper, ImgToBatch,
                                         LabeledImage, mnist)
    from bigdl_tpu_torch.models.inception import Inception_v1
    from bigdl_tpu_torch.models.lenet import LeNet5
    from bigdl_tpu_torch.models.rnn import SimpleRNN
    from bigdl_tpu_torch.models.textclassifier import TextClassifierBiLSTM
    from bigdl_tpu_torch.nn.module import export_params
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.optim import (Optimizer, load_latest_checkpoint,
                                       max_epoch, max_iteration,
                                       several_iteration, validate)
    from bigdl_tpu_torch.utils.random import RNG, generator
    from bigdl_tpu_torch.utils.table import T

    by_path, ran = {}, {}
    # (1) n steps a dispatch as one CUDA graph
    init = export_params(LeNet5(10, device="cpu", generator=generator(0)))
    by_path["harness_lenet"], ran["harness_lenet"] = dispatch_runs(
        torch, ops, "harness LeNet5",
        lambda dev, n, graph: graph_or_eager(lenet_run(
            torch, dev, init, None, validate=False), n, graph),
        HSTEPS, {"fused_sgd": 1, "maxpool2d_forward": 2,
                 "maxpool2d_backward": 2})
    tokens, dictionary, vocab = rnn_data(rnn_corpus(RSENTENCES))
    rinit = export_params(SimpleRNN(vocab, RHIDDEN, vocab, RBPTT,
                                    device="cpu", generator=generator(0)))
    by_path["harness_simple_rnn"], ran["harness_simple_rnn"] = \
        dispatch_runs(
            torch, ops, "harness SimpleRNN",
            lambda dev, n, graph: graph_or_eager(rnn_run(
                torch, dev, rinit, tokens, dictionary, None), n, graph),
            HSTEPS, {"fused_sgd": 1, "rnn_forward": 2, "rnn_backward": 2,
                     "rnn_dwh": 2})
    # dropout inside the graph, and a Top1 that rises
    runs = {}
    with deterministic(torch):
        for graph in (False, True):
            RNG.set_seed(3)
            opt = learnable_run("cuda", HDISPATCH, graph)
            (_, before), = validate(opt.model, opt.validation_dataset,
                                    opt.validation_methods, "cuda")
            opt.set_end_when(max_epoch(HLEARN_EPOCHS)).optimize()
            runs[graph] = (opt, RNG.generator("cuda").get_state())
    (eager, g_eager), (graph, g_graph) = runs[False], runs[True]
    rule = held_same(torch, "harness dropout graph vs eager", eager, graph,
                     GRAPH_TOL)
    top1 = [before.result()[0]] + [v["Top1Accuracy"]
                                   for _, _, v in graph.validation_log]
    if not torch.equal(g_eager, g_graph) or graph.replays < 2:
        raise AssertionError("harness dropout: the graph's replays did not "
                             "advance the mask generator as the eager loop")
    if not top1[-1] > top1[0] + 0.3:
        raise AssertionError(f"harness learnable set: Top1 {top1} did not "
                             f"rise")
    print(f"harness dropout + learnable set: {HLEARN} examples of "
          f"{HFEATURES} features in {HCLASSES} classes, Dropout(0.3), "
          f"n={HDISPATCH} a dispatch, {graph.replays} replays: the masks "
          f"advance at each replay (the generator ends where the eager "
          f"loop's does, the losses held by {rule}); Top1 untrained, then "
          f"at each epoch's first dispatch "
          f"{' '.join(f'{v:.4f}' for v in top1)}")

    # (2) the prefetch on and off at full width
    iinit = export_params(Inception_v1(ICLASSES, device="cpu",
                                       generator=generator(0)))
    images = inception_images(IMAGES, ISIZE, 0)
    docs = text_docs(HDOCS)
    binit = export_params(TextClassifierBiLSTM(
        TCLASSES, TEMBED, THIDDEN, device="cpu", generator=generator(0)))
    for label, make in (
            ("Inception-v1", lambda end: inception_run(
                torch, "cuda", iinit, images, IBATCH, end)),
            ("Bi-LSTM", lambda end: bilstm_run(
                torch, "cuda", binit, docs, TBATCH, end))):
        out = {}
        for on in (True, False):
            with prefetch_set(on), deterministic(torch):
                RNG.set_seed(0)
                opt = make(max_iteration(HPREFETCH_STEPS))
                _, counts, wall = run_path(torch, ops, opt.optimize)
                fetch_s, _ = opt.metrics.get("data fetch time")
                RNG.set_seed(0)
                busy = profile_train(torch, make, 4)
            step_ms = wall / HPREFETCH_STEPS * 1e3
            out[on] = ([l for _, l in opt.loss_log], counts)
            print(f"harness {label} prefetch {'on' if on else 'off'}: "
                  f"{HPREFETCH_STEPS} steps, {step_ms:.4f} ms/step, host "
                  f"(the loop's wait for its batch and the copy) "
                  f"{fetch_s / wall:.4f} of the loop, device "
                  f"{busy:.4f} ms/step busy, idle share "
                  f"{1 - busy / step_ms:.4f}; launches {counts}")
        if len(out[True][0]) != HPREFETCH_STEPS or not np.array_equal(
                out[True][0], out[False][0], equal_nan=True):
            raise AssertionError(f"harness {label}: the losses with the "
                                 f"prefetch on {out[True][0]} are not those "
                                 f"with it off {out[False][0]}")
        print(f"harness {label}: the {HPREFETCH_STEPS} losses with the "
              f"prefetch on equal those with it off, bit for bit: "
              f"{' '.join(f'{l:.6f}' for l in out[True][0])}")
        by_path[f"harness_{label}_prefetch"] = out[True][1]
    by_path["harness_Inception-v1_graph"], \
        ran["harness_Inception-v1_graph"] = prefetch_graph_run(
        torch, ops, "Inception-v1", lambda end: inception_run(
            torch, "cuda", iinit, images, IBATCH, end),
        {"fused_sgd": 1, "lrn_forward": 2, "lrn_backward": 2,
         "maxpool2d_s1_forward": 9, "maxpool2d_s1_backward": 9,
         "maxpool2d_forward": 4, "maxpool2d_backward": 4})

    # (3) a checkpoint resumed on the card: LeNet-5 with momentum on
    # distinct digits, cropped and flipped at random and reordered every
    # epoch, one batch an epoch (so the snapshots land on epoch
    # boundaries: a resume inside an epoch restarts the pass over the
    # records); the uninterrupted run with the prefetch on, its producer
    # drawn ahead of each snapshot, the resumes serial
    digits = [LabeledImage(np.pad(d.data, 2), d.label)
              for d in mnist.synthetic(BATCH, 5)]
    norm = ImgNormalizer(mnist.TRAIN_MEAN, mnist.TRAIN_STD)

    def ckpt_set():
        return (DataSet.array(digits) >> norm >> ImgRdmCropper(28, 28)
                >> HFlip() >> ImgToBatch(BATCH))

    def ckpt_run(model, ds):
        return Optimizer(model, ds, nn.ClassNLLCriterion(),
                         state=T(learningRate=LR, momentum=MOMENTUM),
                         end_trigger=max_iteration(HCKPT_STEPS),
                         device="cuda")

    def resume(tmp, restore_rng):
        ds = ckpt_set()
        module, blob, neval = load_latest_checkpoint(
            tmp, restore_rng=restore_rng, device="cuda", dataset=ds)
        opt = ckpt_run(module, ds)
        opt.set_state(blob["state"]).set_optim_state(blob["opt_state"])
        opt.optimize()
        return _params(torch, opt.model), neval

    with tempfile.TemporaryDirectory(dir=_build.build_dir()) as tmp, \
            deterministic(torch):
        with prefetch_set(True):
            opt_a = ckpt_run(LeNet5(10, device="cuda").load_params(init),
                             ckpt_set())
            opt_a.set_checkpoint(tmp, several_iteration(HCKPT_EVERY))
            _, counts, _ = run_path(torch, ops, opt_a.optimize)
        ck_s, ck_n = opt_a.metrics.get("checkpoint")
        final = _params(torch, opt_a.model)
        for k in range(2 * HCKPT_EVERY, HCKPT_STEPS + 1, HCKPT_EVERY):
            with open(f"{tmp}/model.{k}", "wb") as f:
                f.write(b"rot")
        resumed, neval = resume(tmp, restore_rng=True)
        forked, _ = resume(tmp, restore_rng=False)
    rule = ("bits" if torch.equal(final, resumed) else
            f"atol {GRAPH_TOL['atol']}")
    err = float((final - resumed).abs().max())
    fork = float((final - forked).abs().max())
    if neval != HCKPT_EVERY or err > GRAPH_TOL["atol"]:
        raise AssertionError(f"harness checkpoint: resumed from {neval}, "
                             f"final params {err:.3e} from the "
                             f"uninterrupted run's")
    if fork <= GRAPH_TOL["atol"]:
        raise AssertionError(f"harness checkpoint: the resume without the "
                             f"random payload ends {fork:.3e} from the "
                             f"uninterrupted run: the payload is not what "
                             f"the check holds")
    print(f"harness checkpoint: LeNet5 with momentum {MOMENTUM}, "
          f"{len(digits)} distinct digits cropped and flipped at random, "
          f"{HCKPT_STEPS} steps with the prefetch on, a snapshot every "
          f"{HCKPT_EVERY} ({ck_n} written, {ck_s / ck_n * 1e3:.3f} ms each "
          f"of wall, model + state + sidecars); the snapshots after "
          f"{HCKPT_EVERY} corrupted, load_latest_checkpoint(restore_rng="
          f"True) resumed from {neval}: the final params equal the "
          f"uninterrupted run's by {rule} (largest difference {err:.3e}); "
          f"restore_rng=False ends {fork:.3e} from them")
    by_path["harness_checkpoint"] = counts
    return by_path, ran


# -- harness_api: the rest of the training harness's API ----------------

# the fine-tune (learningRates 0 but on the classifier), FT_STEPS steps of
# IBATCH over FT_STEPS x IBATCH images, FT_CHECK_STEPS at inception's
# check batch (its images: the same first batch) against the CPU; the
# Bi-LSTM with Adagrad at BASELINE config 4, AG_DISPATCH steps a dispatch
# over AG_DOCS documents, AG_STEPS steps; LeNet-5's full-batch L-BFGS over
# LB_IMAGES images, LB_ITERS iterations, its first LB_HELD losses held to
# the CPU's; the Validator over VAL_IMAGES images in batches of VAL_BATCH
FT_STEPS, FT_CHECK_STEPS = 3, 2
AG_LR, AG_LRD, AG_DOCS, AG_DISPATCH, AG_STEPS = 0.01, 0.01, 512, 4, 8
# the Adagrad run against the CPU, parameters as a whole (see
# harness_adagrad): a few sign flips of an lr-sized step among 364,616
# parameters move the ratio by ~1e-3; a wrong rate or decay by ~1e-1
AG_UPDATE_RTOL = 1e-2
LB_IMAGES, LB_ITERS, LB_HELD = 1024, 6, 3
VAL_IMAGES, VAL_BATCH = 16, 8
# the serving step with the modules' forward_time on and off: FT_REQ
# requests of FT_WORDS words each way, in turns (on, off, off, on)
FT_REQ, FT_WORDS = 16, 32


def finetune_scales(init):
    """``state['learningRates']`` of the fine-tune: 0 for every leaf but
    the final classifier's (Inception-v1's child '24'), 1 there; each a
    0-d array, broadcast over its leaf."""
    def rates(tree, r):
        return {k: ({n: np.float32(r) for n in sub} if k == "~"
                    else rates(sub, r)) for k, sub in tree.items()}
    return {k: rates({k: sub}, float(k == "24"))[k]
            for k, sub in init.items()}


def finetune_run(torch, device, init, images, batch, end_trigger):
    """examples/train_inception.py's run (``inception_run``) with the
    classifier alone learning: ``learningRates`` in the state, dropout
    off."""
    from bigdl_tpu_torch.utils.table import T

    opt = inception_run(torch, device, init, images, batch, end_trigger,
                        dropout=0.0)
    opt.set_state(T(learningRates=finetune_scales(init)))
    return opt


def harness_finetune(torch, ops):
    from bigdl_tpu_torch.models.inception import Inception_v1
    from bigdl_tpu_torch.nn.module import export_params
    from bigdl_tpu_torch.optim import max_iteration
    from bigdl_tpu_torch.utils.random import generator

    init = export_params(Inception_v1(ICLASSES, device="cpu",
                                      generator=generator(0)))
    images = inception_images(FT_STEPS * IBATCH, ISIZE, 3)
    opt = finetune_run(torch, "cuda", init, images, IBATCH,
                       max_iteration(FT_STEPS))
    _, counts, wall = run_path(torch, ops, opt.optimize)
    after = export_params(opt.model)
    moved = [k for k in after if k not in ("~", "24")
             and any(not np.array_equal(a, b) for a, b in
                     zip(_leaves(after[k]), _leaves(init[k])))]
    grew = any(not np.array_equal(a, b) for a, b in
               zip(_leaves(after["24"]), _leaves(init["24"])))
    steps = int(opt.state["neval"]) - 1
    want = {**untapped(counts), "fused_sgd_scaled": steps,
            "lrn_forward": 2 * steps, "lrn_backward": 2 * steps,
            "maxpool2d_s1_forward": 9 * steps,
            "maxpool2d_s1_backward": 9 * steps,
            "maxpool2d_forward": 4 * steps, "maxpool2d_backward": 4 * steps}
    losses = [l for _, l in opt.loss_log]
    print(f"harness_api finetune: Inception-v1 {steps} steps of {IBATCH} "
          f"through Optimizer(...).optimize(), learningRates 0 on 114 "
          f"leaves and 1 on the classifier's 2; {wall / steps * 1e3:.4f} "
          f"ms/step; frozen leaves bit-equal: {not moved}, the classifier "
          f"moved: {grew}; launches {ops_nonzero(counts)}; losses "
          f"{' '.join(f'{l:.6f}' for l in losses)}")
    if moved or not grew or counts != want or steps != FT_STEPS \
            or not np.isfinite(losses).all():
        raise AssertionError(f"finetune: moved {moved}, classifier moved "
                             f"{grew}, launches {counts} (expected {want})")
    check = inception_images(ICHECK_BATCH * FT_CHECK_STEPS, ISIZE, 2)
    diff = card_vs_cpu(torch, init, lambda device: finetune_run(
        torch, device, init, check, ICHECK_BATCH,
        max_iteration(FT_CHECK_STEPS)))
    print_vs_cpu("harness_api finetune", ICHECK_BATCH, diff, IPARAM_ATOL)
    held_vs_cpu("the fine-tune", diff, IPARAM_ATOL)
    return counts, wall / steps * 1e3


def adagrad_bilstm_run(torch, device, init, docs, batch, end_trigger):
    """``bilstm_run``'s Bi-LSTM classifier with ``Adagrad`` (lr AG_LR,
    learningRateDecay AG_LRD) in place of SGD."""
    from bigdl_tpu_torch.optim import Adagrad
    from bigdl_tpu_torch.utils.table import T

    opt = bilstm_run(torch, device, init, docs, batch, end_trigger)
    opt.set_optim_method(Adagrad())
    opt.set_state(T(learningRate=AG_LR, learningRateDecay=AG_LRD))
    return opt


def harness_adagrad(torch, ops):
    """The Bi-LSTM with Adagrad: AG_STEPS steps at AG_DISPATCH a dispatch
    as the eager loop and as one CUDA graph (a warm-up chunk, then one
    capture replayed), equal to each other; three steps at batch 16
    against the CPU."""
    from bigdl_tpu_torch.models.textclassifier import TextClassifierBiLSTM
    from bigdl_tpu_torch.nn.module import export_params
    from bigdl_tpu_torch.optim import max_iteration
    from bigdl_tpu_torch.utils.random import generator

    init = export_params(TextClassifierBiLSTM(
        TCLASSES, TEMBED, THIDDEN, device="cpu", generator=generator(0)))
    docs = text_docs(AG_DOCS, seed=5)
    runs = {}
    with deterministic(torch):
        for graph in (False, True):
            opt = graph_or_eager(adagrad_bilstm_run(
                torch, "cuda", init, docs, TBATCH, max_iteration(AG_STEPS)),
                AG_DISPATCH, graph)
            _, counts, wall = run_path(torch, ops, opt.optimize)
            runs[graph] = (opt, counts, wall)
    (eager, ec, ew), (graph, gc, gw) = runs[False], runs[True]
    want = {**untapped(ec), "bilstm_forward": AG_STEPS,
            "bilstm_backward": AG_STEPS, "bilstm_dwh": AG_STEPS}
    rule = held_same(torch, "harness_api adagrad graph vs eager", eager,
                     graph, GRAPH_TOL)
    step = int(graph.opt_state["step"])
    print(f"harness_api adagrad: TextClassifierBiLSTM at {TBATCH} x {TSEQ} "
          f"x {TEMBED}, Adagrad lr {AG_LR} decay {AG_LRD}, {AG_STEPS} "
          f"steps at {AG_DISPATCH} a dispatch: eager {ew / AG_STEPS * 1e3:.4f}"
          f" ms/step, graph {gw / AG_STEPS * 1e3:.4f} ms/step ({graph.captures}"
          f" capture, {graph.replays} replay), held by {rule}; the step "
          f"counter {step} on the card; launches eager {ops_nonzero(ec)} "
          f"graph {ops_nonzero(gc)} (the wrappers count the warm-up chunk "
          f"and the capture)")
    if ec != want or gc != want or graph.captures != 1 \
            or graph.replays != 1 or step != AG_STEPS:
        raise AssertionError(f"adagrad: launches {ec} / {gc}, expected "
                             f"{want}; {graph.captures} captures, "
                             f"{graph.replays} replays, step {step}")
    check = docs[:TCHECK_BATCH * TCHECK_STEPS]
    diff = card_vs_cpu(torch, init, lambda device: adagrad_bilstm_run(
        torch, device, init, check, TCHECK_BATCH,
        max_iteration(TCHECK_STEPS)))
    print_vs_cpu("harness_api adagrad", TCHECK_BATCH, diff, PARAM_ATOL)
    # Adagrad's step is lr * g / (|g| + 1e-10) on its first step: an
    # element whose gradient sits within rounding of zero may take
    # +lr on one device and -lr on the other, so the parameters are held
    # as a whole: card - CPU over the CPU's update, both as norms
    print(f"harness_api adagrad vs CPU: parameters ||card - CPU|| / "
          f"||CPU - init|| {diff['update_rel']:.3e} (limit "
          f"{AG_UPDATE_RTOL}), largest element {diff['param_abs']:.3e}")
    failed = vs_cpu_failures(diff, float("inf"))
    if failed or diff["update_rel"] > AG_UPDATE_RTOL:
        raise AssertionError(f"the card's Adagrad Bi-LSTM left the CPU's: "
                             f"{failed}, update {diff['update_rel']:.3e}")
    return gc, gw / AG_STEPS * 1e3


def lbfgs_lenet(torch, device, init, images, labels):
    """Full-batch ``LBFGS().optimize(feval, x)`` over LeNet-5's
    parameters (the JAX tree of tensors on ``device``): each feval loads
    ``x`` into the model and returns the mean NLL over every image and
    its gradient tree.  (f_hist, fevals)."""
    from bigdl_tpu_torch.models.lenet import LeNet5
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.nn.module import tree_of
    from bigdl_tpu_torch.optim import LBFGS
    from bigdl_tpu_torch.utils.table import T

    dev = torch.device(device)
    model = LeNet5(10, device=device).load_params(init)
    crit = ClassNLLCriterion()
    x = torch.from_numpy(images).to(dev)
    y = torch.from_numpy(labels).to(dev)
    calls = [0]

    def feval(params):
        calls[0] += 1
        model.load_params(params)
        model.zero_grad(set_to_none=True)
        loss = crit(model(x), y)
        loss.backward()
        return loss.detach(), tree_of(model, [p.grad for p in
                                              model.parameters()])

    start = tree_of(model, [p.detach().clone() for p in model.parameters()])
    _, hist = LBFGS().optimize(feval, start, T(maxIter=LB_ITERS))
    return hist, calls[0]


def harness_lbfgs(torch, ops):
    from bigdl_tpu_torch.dataset import (DataSet, ImgNormalizer, ImgToBatch,
                                         mnist)
    from bigdl_tpu_torch.models.lenet import LeNet5
    from bigdl_tpu_torch.nn.module import export_params
    from bigdl_tpu_torch.utils.random import generator

    init = export_params(LeNet5(10, device="cpu", generator=generator(0)))
    full = next((DataSet.array(mnist.synthetic(LB_IMAGES, seed=2))
                 >> ImgNormalizer(mnist.TRAIN_MEAN, mnist.TRAIN_STD)
                 >> ImgToBatch(LB_IMAGES)).data(train=False))
    images = np.asarray(full.data, np.float32)
    labels = np.asarray(full.labels, np.float32)
    (hist, fevals), counts, wall = run_path(
        torch, ops, lambda: lbfgs_lenet(torch, "cuda", init, images, labels))
    t0 = time.perf_counter()
    cpu_hist, _ = lbfgs_lenet(torch, "cpu", init, images, labels)
    cpu_s = time.perf_counter() - t0
    n = min(LB_HELD, len(hist), len(cpu_hist))
    rel = float(np.max(np.abs(np.asarray(hist[:n]) - cpu_hist[:n])
                       / np.abs(cpu_hist[:n])))
    want = {**untapped(counts), "maxpool2d_forward": 2 * fevals,
            "maxpool2d_backward": 2 * fevals}
    print(f"harness_api lbfgs: LeNet-5 {sum(v.size for v in _leaves(init))}"
          f" params, full batch of {LB_IMAGES} synthetic MNIST images, "
          f"{len(hist) - 1} iterations, {fevals} fevals in {wall:.4f} s "
          f"({wall / fevals * 1e3:.4f} ms a feval); f_hist card "
          f"{' '.join(f'{f:.6f}' for f in hist)}; CPU "
          f"{' '.join(f'{f:.6f}' for f in cpu_hist)} ({cpu_s:.2f} s); the "
          f"first {n} within {rel:.3e} relative (limit {LOSS_RTOL}); "
          f"launches {ops_nonzero(counts)}")
    if hist[-1] >= hist[0] or rel > LOSS_RTOL or counts != want:
        raise AssertionError(f"lbfgs: f_hist {hist}, CPU {cpu_hist}, "
                             f"launches {counts} (expected {want})")
    return counts, wall / fevals * 1e3


def harness_validator(torch, ops):
    """``Validator(model, val).test`` with Top1, Top5 and Loss over
    Inception-v1 at full width on the card and on the CPU; then
    ``predict`` against the eval forward, and the Torch-style
    ``update_output`` / ``backward`` against autograd on the card."""
    from bigdl_tpu_torch.dataset import DataSet, ImgNormalizer, ImgToBatch
    from bigdl_tpu_torch.models.inception import Inception_v1
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import (Loss, Top1Accuracy, Top5Accuracy,
                                       Validator)
    from bigdl_tpu_torch.utils.random import RNG, generator

    norm = ImgNormalizer((123.0, 117.0, 104.0), (1.0, 1.0, 1.0))
    val = DataSet.array(inception_images(VAL_IMAGES, ICROP, 6)) >> norm \
        >> ImgToBatch(VAL_BATCH)
    methods = [Top1Accuracy(), Top5Accuracy(), Loss(ClassNLLCriterion())]
    res, secs = {}, {}
    for role, device in (("card", "cuda"), ("cpu", "cpu")):
        model = Inception_v1(ICLASSES, device=device, generator=generator(0))
        if role == "card":
            (out, counts, wall) = run_path(
                torch, ops, lambda: Validator(model, val, device).test(
                    methods))
            card_model = model
        else:
            t0 = time.perf_counter()
            out = Validator(model, val, device).test(methods)
            wall = time.perf_counter() - t0
        res[role] = [r.result() for _, r in out]
        secs[role] = wall
    (c1, n1), (c5, n5), (loss, nl) = res["card"]
    (d1, m1), (d5, m5), (cpu_loss, ml) = res["cpu"]
    loss_rel = abs(loss - cpu_loss) / abs(cpu_loss)
    batches = -(-VAL_IMAGES // VAL_BATCH)
    want = {**untapped(counts), "lrn_forward": 2 * batches,
            "maxpool2d_s1_forward": 9 * batches,
            "maxpool2d_forward": 4 * batches}
    print(f"harness_api validator: Inception-v1 over {VAL_IMAGES} images "
          f"in batches of {VAL_BATCH}: card Top1 {c1:.4f} Top5 {c5:.4f} "
          f"Loss {loss:.8f} ({n1} records, {secs['card'] * 1e3:.4f} ms); "
          f"CPU Top1 {d1:.4f} Top5 {d5:.4f} Loss {cpu_loss:.8f} "
          f"({secs['cpu']:.2f} s); loss {loss_rel:.3e} relative apart "
          f"(limit {RTOL}); launches {ops_nonzero(counts)}")
    if (c1, c5, n1, n5, nl) != (d1, d5, m1, m5, ml) or n1 != VAL_IMAGES \
            or loss_rel > RTOL or counts != want:
        raise AssertionError(f"validator: card {res['card']}, CPU "
                             f"{res['cpu']}, launches {counts} (expected "
                             f"{want})")
    # predict and the Torch-style gradient methods on the card
    x = torch.from_numpy(next(val.data(train=False)).data[:8]).cuda()
    with deterministic(torch):
        pred = card_model.predict(x)
        card_model.eval()
        with torch.no_grad():
            ref = card_model(x)
        card_model.train()
        gy = torch.randn(pred.shape, device="cuda",
                         generator=torch.Generator("cuda").manual_seed(0))
        card_model.zero_grad_parameters()
        card_model.update_output(x)
        gx = card_model.backward(x, gy)
        grads = [p.grad.clone() for p in card_model.parameters()]
        card_model.zero_grad_parameters()
        xx = x.clone().requires_grad_(True)
        RNG.generator(x.device).set_state(card_model._replay)
        card_model(xx).backward(gy)
    g_rel = max(leaf_rel(a.cpu(), b.cpu().double())
                for a, b in zip([gx] + grads, [xx.grad] + [
                    p.grad for p in card_model.parameters()]))
    same = torch.equal(pred, ref)
    print(f"harness_api module api: predict bit-equal to the eval "
          f"forward: {same}; backward's gradInput and {len(grads)} "
          f"parameter gradients against autograd, largest |a - b| / "
          f"max|b| {g_rel:.3e} (limit {RTOL}); forward_time "
          f"{card_model.forward_time:.4f} s, backward_time "
          f"{card_model.backward_time:.4f} s")
    if not same or g_rel > RTOL:
        raise AssertionError("the Module API's predict or backward left "
                             "the plain calls'")
    return counts, secs["card"] / batches * 1e3


def forward_time_cost(torch, ops, serving):
    """The serving step with each module's ``forward_time`` kept (the
    port's ``Module.__call__``) and without (torch's own ``__call__``), in
    turns on, off, off, on: ms a step each, and the rows equal."""
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.nn.module import Module
    from bigdl_tpu_torch.serve.decode import ContinuousDecoder
    from bigdl_tpu_torch.utils.random import generator

    if serving is None:
        model = TransformerLM(VOCAB, D_MODEL, HEADS, LAYERS, HIDDEN,
                              dropout=0.0, device="cuda",
                              generator=generator(0)).evaluate()
        rs = np.random.RandomState(0)
        seeds = [rs.randint(0, VOCAB, size=int(rs.randint(16, 257))).tolist()
                 for _ in range(N_REQ)]
    else:
        model, seeds, _ = serving
    timed_call = Module.__call__
    out = {}
    try:
        for turn, on in enumerate((True, False, False, True)):
            Module.__call__ = timed_call if on else torch.nn.Module.__call__
            dec = ContinuousDecoder(model, max_slots=SLOTS, n_pos=N_POS,
                                    page_size=PAGE, device="cuda")
            futs = [dec.submit(s, FT_WORDS) for s in seeds[:FT_REQ]]
            _, _, wall = run_path(torch, ops, dec.run)
            out.setdefault(on, []).append(
                (wall / dec.steps * 1e3, [f.result() for f in futs]))
    finally:
        Module.__call__ = timed_call
    rows = {on: [r for _, r in v] for on, v in out.items()}
    if any(r != rows[True][0] for v in rows.values() for r in v):
        raise AssertionError("forward_time: the served rows differ with "
                             "the timing on and off")
    on = [ms for ms, _ in out[True]]
    off = [ms for ms, _ in out[False]]
    print(f"harness_api forward_time: the serving step ({FT_REQ} requests,"
          f" {FT_WORDS} words) with each module's forward_time kept "
          f"{on[0]:.4f} / {on[1]:.4f} ms, without {off[0]:.4f} / "
          f"{off[1]:.4f} ms (turns on, off, off, on): "
          f"{statistics.mean(on) / statistics.mean(off):.4f}x; the rows "
          f"equal")


def phase_harness_api(torch, ops, serving=None):
    """The rest of the training harness's API on the card at full width,
    each path read from zeroed launch counts: Inception-v1 fine-tuned
    with per-parameter learning rates (``fused_sgd``'s scaled form, one
    launch a step; the frozen leaves bit-equal), the Bi-LSTM classifier
    with ``Adagrad`` eager and as one CUDA graph, LeNet-5's full-batch
    L-BFGS, the ``Validator`` and the Module API over Inception-v1, each
    held against the CPU; and the serving step with the modules'
    ``forward_time`` on and off."""
    out, ms = {}, {}
    t0 = time.perf_counter()
    for name, path in (("finetune", harness_finetune),
                       ("adagrad", harness_adagrad),
                       ("lbfgs", harness_lbfgs),
                       ("validator", harness_validator)):
        out[f"api_{name}"], ms[name] = path(torch, ops)
    forward_time_cost(torch, ops, serving)
    print(f"harness_api: ms a step (finetune, adagrad graph), a feval "
          f"(lbfgs), a batch (validator): "
          f"{ {k: round(v, 4) for k, v in ms.items()} }; "
          f"{time.perf_counter() - t0:.1f} s")
    return out, {}



OBS_STEPS, OBS_CADENCE, OBS_PROFILED, OBS_TIMED = 16, 2, 4, 48
OBS_PHASES = ("data-load", "h2d", "dispatch", "host-wait")


@contextlib.contextmanager
def obs_env(on: bool, run_dir=None):
    """The observability switches of a run: on, events under ``run_dir``
    and every request traced (``BIGDL_OBS_TRACE_SAMPLE=1``); off,
    ``BIGDL_OBS=0`` and no trace.  The process's settings come back
    after."""
    import os

    from bigdl_tpu_torch.obs import events, recorder

    keys = ("BIGDL_OBS", "BIGDL_OBS_TRACE_SAMPLE")
    old = {k: os.environ.get(k) for k in keys}
    os.environ.update(BIGDL_OBS="1" if on else "0",
                      BIGDL_OBS_TRACE_SAMPLE="1" if on else "0")
    events.reset()
    recorder.reset()
    if on and run_dir is not None:
        events.configure(run_dir)
    try:
        yield
    finally:
        events.reset()
        recorder.reset()
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def obs_lenet(torch, ops, init, on, run_dir, steps=OBS_STEPS, debug=True):
    """``steps`` steps of LeNet-5 (batches of BATCH) through
    ``Optimizer``, obs on (events and a ``TrainSummary`` under
    ``run_dir``, taps read every OBS_CADENCE steps) or off (taps off,
    ``BIGDL_OBS=0``), under ``torch.cuda.set_sync_debug_mode`` where
    ``debug``: (the optimizer, its launch counts, wall s, the
    device-to-host syncs the debug mode reported, by file and line)."""
    import warnings

    from bigdl_tpu_torch.obs import summary
    from bigdl_tpu_torch.optim import max_iteration

    with obs_env(on, run_dir):
        opt = lenet_run(torch, "cuda", init, max_iteration(steps),
                        validate=False)
        opt.set_taps(on, OBS_CADENCE)
        if on:
            opt.set_train_summary(summary.TrainSummary(run_dir, "lenet"))

        def run():
            torch.cuda.set_sync_debug_mode("warn" if debug else 0)
            try:
                opt.optimize()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            _, counts, wall = run_path(torch, ops, run)
        if on:
            opt._train_summary.close()
    syncs = [(w.filename.rsplit("/", 1)[-1], w.lineno) for w in seen
             if "synchroniz" in str(w.message)]
    return opt, counts, wall, syncs


def obs_serve(torch, ops, model, seeds, on, run_dir, name):
    """The flagship's requests through ``ContinuousDecoder`` (every
    other one streamed), obs on (every request traced, its chain
    finalized in the flight recorder and emitted) or off: (decoder,
    traces, rows, launch counts, wall s)."""
    from bigdl_tpu_torch.obs import recorder, trace
    from bigdl_tpu_torch.serve.decode import ContinuousDecoder

    with obs_env(on, run_dir):
        sampler = trace.Sampler()
        dec = ContinuousDecoder(model, max_slots=SLOTS, n_pos=N_POS,
                                page_size=PAGE, device="cuda", name=name)
        traces = [sampler.next() for _ in seeds]
        futs = [dec.submit(s, N_WORDS, trace=t)
                for s, t in zip(seeds, traces)]
        for f in futs[::2]:
            f.request_stream()
        _, counts, wall = run_path(torch, ops, dec.run)
        rows = [f.result(timeout=60) for f in futs]
        for t in traces:
            if t is not None and recorder.finalize(
                    t.trace_id, "ok", trace=t, head_sampled=True):
                t.emit("ok")
        records = {t.trace_id: recorder.get().get(t.trace_id)
                   for t in traces if t is not None}
    return dec, traces, rows, counts, wall, records


def phase_obs(torch, ops, serving=None):
    """The observability plane on the main paths (``bigdl_tpu_torch.obs``):
    LeNet-5 trained with events to a directory, a ``TrainSummary`` and
    the taps read at cadence 2, and with obs off, in turns on, off, off,
    on, the same losses bit for bit: every event validates, the taps land
    at the cadence's steps, ``fused_sgd_taps`` launched once a step, the
    debug mode saw the same device-to-host syncs on and off, ``train_mfu``
    in (0, 1]; a profiled run whose trace holds the phase spans as
    ``record_function`` ranges; then the flagship's 16 requests served
    with every request traced and with obs off: the streamed requests'
    ``decode_admit → first_token → retire`` hops, one TTFT a streamed
    request and one ITL a later token, the recorder's rows the served
    ones, ``decode_model_flops_util`` in (0, 1], the rows the same on and
    off.  ms a step of each, on and off."""
    import glob
    import tempfile

    from bigdl_tpu_torch.models.lenet import LeNet5
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.nn.module import export_params
    from bigdl_tpu_torch.obs import events, metrics, summary
    from bigdl_tpu_torch.optim import max_iteration
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.serve.decode import continuous_decode
    from bigdl_tpu_torch.utils.random import generator

    t0 = time.perf_counter()
    smi = smi_line()
    init = export_params(LeNet5(10, device="cuda", generator=generator(0)))
    if serving is None:
        model = TransformerLM(VOCAB, D_MODEL, HEADS, LAYERS, HIDDEN,
                              dropout=0.0, device="cuda",
                              generator=generator(0)).evaluate()
        rs = np.random.RandomState(0)
        seeds = [rs.randint(0, VOCAB, size=int(rs.randint(16, 257)))
                 .tolist() for _ in range(N_REQ)]
    else:
        model, seeds, _ = serving
    print(f"obs: the models ready in {time.perf_counter() - t0:.1f} s")
    out = {}
    with tempfile.TemporaryDirectory(dir=_build.build_dir()) as tmp:
        metrics.reset()
        turns = {}
        with deterministic(torch):   # the turns' losses held bit for bit
            # warm-up: cuDNN's algorithm choice, allocator, the SGD table
            lenet_run(torch, "cuda", init, max_iteration(3),
                      validate=False).optimize()
            for k, on in enumerate((True, False, False, True)):
                turns.setdefault(on, []).append(obs_lenet(
                    torch, ops, init, on, f"{tmp}/lenet{k}"))
        # ms a step, three epochs a turn in three pairs of turns, without
        # the checks' modes
        walls = {True: [], False: []}
        for k, on in enumerate((True, False, False, True, True, False)):
            walls[on].append(obs_lenet(torch, ops, init, on,
                                       f"{tmp}/timed{k}", OBS_TIMED,
                                       debug=False)[2])
        t_lenet = time.perf_counter() - t0
        (opt, counts, wall, syncs), (opt2, _, wall2, syncs2) = turns[True]
        (off, counts_off, wall_off, syncs_off), (_, _, wall_off2, syncs_off2) \
            = turns[False]
        losses = [[l for _, l in o.loss_log]
                  for o in (opt, opt2, off, turns[False][1][0])]
        if any(l != losses[0] for l in losses):
            raise AssertionError("obs: LeNet-5's losses differ with obs on "
                                 "and off")
        steps = OBS_STEPS
        if counts["fused_sgd"] != steps or counts["fused_sgd_taps"] != steps \
                or counts_off["fused_sgd_taps"] != 0 \
                or counts_off["fused_sgd"] != steps:
            raise AssertionError(f"obs: launches on {ops_nonzero(counts)}, "
                                 f"off {ops_nonzero(counts_off)}")
        evs = events.read_events(f"{tmp}/lenet0/events.p0.jsonl")
        for e in evs:
            events.validate_event(e)
        kinds = [e["type"] for e in evs]
        tapped = [e["step"] for e in evs
                  if e["type"] == "step" and "taps" in e]
        if kinds[0] != "run_start" or kinds[-1] != "run_end" or [
                e["step"] for e in evs if e["type"] == "step"] != list(
                    range(1, steps + 1)) or tapped != list(
                        range(OBS_CADENCE, steps + 1, OBS_CADENCE)):
            raise AssertionError(f"obs: LeNet-5's events {kinds}, taps at "
                                 f"{tapped}")
        scalars = summary.read_scalars(glob.glob(
            f"{tmp}/lenet0/lenet/train/events.out.tfevents.*")[0])
        n_loss = sum(t == "Loss" for _, t, _ in scalars)
        n_taps = sum(t == "Taps/grad_norm" for _, t, _ in scalars)
        if (n_loss, n_taps) != (steps, steps // OBS_CADENCE):
            raise AssertionError(f"obs: the TrainSummary holds {n_loss} "
                                 f"losses and {n_taps} grad norms")
        # each turn's syncs by the line that made them (the turns after
        # the first of each kind: a first run's one-time set-up aside)
        print(f"obs lenet: device-to-host syncs by line, turns on, off, "
              f"off, on: {[collections.Counter(x) for x in (syncs, syncs_off, syncs_off2, syncs2)]}")
        # no sync between cadence boundaries: each one is the window's
        # read, once a window, taps on as off
        if len(syncs2) != len(syncs_off2) or opt.host_syncs != \
                off.host_syncs or len(syncs2) != opt2.host_syncs or any(
                    f != "local_optimizer.py" for f, _ in syncs2):
            raise AssertionError(f"obs: device-to-host syncs on "
                                 f"{len(syncs2)} (window reads "
                                 f"{opt.host_syncs}), off {len(syncs_off2)} "
                                 f"({off.host_syncs})")
        snap = metrics.get().snapshot()
        mfu = metrics.family_total(snap, "train_mfu", optimizer="local")
        if not 0 < mfu <= 1:
            raise AssertionError(f"obs: train_mfu {mfu}")
        last = opt._taps_monitor.last()
        on_ms = [w / OBS_TIMED * 1e3 for w in walls[True]]
        off_ms = [w / OBS_TIMED * 1e3 for w in walls[False]]
        chk_ms = [w / steps * 1e3 for w in (wall, wall_off, wall_off2, wall2)]
        print(f"obs lenet: {steps} steps of {BATCH}, taps at cadence "
              f"{OBS_CADENCE} (last {last}), {len(evs)} events valid, "
              f"the TrainSummary {len(scalars)} scalars; fused_sgd_taps "
              f"{counts['fused_sgd_taps']} of fused_sgd "
              f"{counts['fused_sgd']}; device-to-host syncs the debug mode "
              f"saw on {len(syncs)} / {len(syncs2)}, off {len(syncs_off)} / "
              f"{len(syncs_off2)} (window reads "
              f"{opt.host_syncs} / {off.host_syncs}); train_mfu {mfu:.6g}; "
              f"ms a step ({OBS_TIMED} steps a turn, turns on, off, off, "
              f"on, on, off) on {' / '.join(f'{m:.4f}' for m in on_ms)}, "
              f"off {' / '.join(f'{m:.4f}' for m in off_ms)}, medians "
              f"{statistics.median(on_ms):.4f} / "
              f"{statistics.median(off_ms):.4f} (the checked turns, "
              f"cuDNN's deterministic algorithms and the sync debug mode "
              f"on, "
              f"{' / '.join(f'{m:.4f}' for m in chk_ms)}); the losses "
              f"equal; {t_lenet:.1f} s; [{smi}]")
        out["obs_lenet"] = counts

        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            obs_lenet(torch, ops, init, True, f"{tmp}/prof", OBS_PROFILED)
        names = {e.name for e in prof.events()}
        missing = [n for n in OBS_PHASES if n not in names]
        if missing:
            raise AssertionError(f"obs: the profiler's trace lacks the "
                                 f"spans {missing}")
        print(f"obs profiler: the spans {list(OBS_PHASES)} are "
              f"record_function ranges of the trace ({len(names)} names); "
              f"{time.perf_counter() - t0:.1f} s")

        metrics.reset()
        # warm-up: the decode path's first-call costs (allocator, cuBLAS)
        continuous_decode(model, [[1, 2, 3]], 4, max_slots=SLOTS,
                          n_pos=N_POS, device="cuda")
        dec, traces, rows, scounts, swall, records = obs_serve(
            torch, ops, model, seeds, True, f"{tmp}/serve", "obs_on")
        dec_off, traces_off, rows_off, _, swall_off, _ = obs_serve(
            torch, ops, model, seeds, False, f"{tmp}/serve_off", "obs_off")
        only_kernel(scounts, "paged_attention", LAYERS * dec.steps,
                    "obs serving")
        if rows != rows_off or any(t is not None for t in traces_off):
            raise AssertionError("obs: the served rows differ with obs on "
                                 "and off, or obs off traced")
        streamed = traces[::2]
        if any([h[0] for h in t.hops] != ["decode_admit", "first_token",
                                          "retire"] for t in streamed) or \
                any([h[0] for h in t.hops] != ["decode_admit"]
                    for t in traces[1::2]):
            raise AssertionError(f"obs: hops {[t.hops for t in traces]}")
        if any(records[t.trace_id]["tokens"] != r
               for t, r in zip(traces, rows)):
            raise AssertionError("obs: the recorder's rows are not the "
                                 "served ones")
        sevs = events.read_events(f"{tmp}/serve/events.p0.jsonl")
        for e in sevs:
            events.validate_event(e)
        snap = metrics.get().snapshot()
        ttft = metrics.merged_histogram(snap, "decode_ttft_seconds",
                                        decoder="obs_on")
        itl = metrics.merged_histogram(snap, "decode_itl_seconds",
                                       decoder="obs_on")
        firsts = sum(e["timeline"][0][1] for e in sevs
                     if e.get("kind") == "stream")
        tokens = metrics.family_total(snap, "decode_stream_tokens_total",
                                      decoder="obs_on")
        if ttft[3] != len(streamed) or itl[3] != tokens - firsts:
            raise AssertionError(f"obs: TTFT {ttft[3]} of {len(streamed)} "
                                 f"streams, ITL {itl[3]} of "
                                 f"{tokens - firsts} later tokens")
        util = metrics.family_total(snap, "decode_model_flops_util",
                                    decoder="obs_on")
        if not 0 < util <= 1:
            raise AssertionError(f"obs: decode_model_flops_util {util}")
        n_trace = sum(e["type"] == "trace" for e in sevs)
        q = metrics.histogram_quantiles(snap, "decode_ttft_seconds",
                                        decoder="obs_on")
        print(f"obs serving: {len(seeds)} requests x {N_WORDS} words, "
              f"{dec.steps} steps, every request traced ({n_trace} trace "
              f"events, {len(streamed)} streamed with decode_admit -> "
              f"first_token -> retire), {len(sevs)} events valid; TTFT "
              f"{ttft[3]} observations (p50 {q['p50']:.4f} s), ITL {itl[3]} "
              f"= streamed tokens {tokens} - first-boundary {firsts}; "
              f"decode_model_flops_util {util:.6g}, decode_tokens_per_s "
              f"{metrics.family_total(snap, 'decode_tokens_per_s', decoder='obs_on'):.1f}; "
              f"ms a step on {swall / dec.steps * 1e3:.4f}, off "
              f"{swall_off / dec_off.steps * 1e3:.4f}; rows equal; [{smi}]")
        out["obs_serving"] = scounts
        dec.close()
        dec_off.close()
    print(f"obs: {time.perf_counter() - t0:.1f} s")
    return out, {}


def with_init(model, init, dropout=None):
    """``model`` with the parameters and running state of ``init`` (``{
    'params': tree, 'state': tree}``), each ``Dropout``'s p set to
    ``dropout`` when given."""
    model.load_params(init["params"]).load_state(init["state"])
    return model if dropout is None else set_dropout(model, dropout)


def set_dropout(model, p):
    from bigdl_tpu_torch.nn import Dropout

    for m in model.modules():
        if isinstance(m, Dropout):
            m.set_p(p)
    return model


def init_of(model):
    from bigdl_tpu_torch.nn.module import export_params, export_state

    return {"params": export_params(model), "state": export_state(model)}


def ungated(init, seed=0):
    """``init`` with every all-zero BN weight drawn U(0, 1): with ResNet's
    zeroed final BN weights the first batch's branch gradients are
    exactly zero, and a gradient check would hold nothing there."""
    rs = np.random.RandomState(seed)

    def fill(tree):
        out = {}
        for k, sub in tree.items():
            if k != "~":
                out[k] = fill(sub)
                continue
            out[k] = {n: (rs.uniform(0, 1, v.shape).astype(np.float32)
                          if n == "weight" and v.ndim == 1 and not v.any()
                          else v) for n, v in sub.items()}
        return out
    return {"params": fill(init["params"]), "state": init["state"]}


def state_moved(torch, model, init):
    """The largest change of a running statistic from ``init``'s."""
    from bigdl_tpu_torch.nn.module import export_state

    return max(float(np.abs(a - b).max()) for a, b in zip(
        _leaves(export_state(model)), _leaves(init["state"])))


def vgg_run(torch, device, init, images, batch, end_trigger,
            val_images=None, dropout=None):
    """examples/train_vgg.py:51-74 from ``init``: the images normalised,
    padded by 4 and cropped back to 32 at random, flipped; SGD with lr
    0.01, momentum 0.9 and weight decay 5e-4; Top1 after VSTEPS
    iterations when ``val_images`` are given.  An optimizer ready to
    run."""
    from bigdl_tpu_torch.dataset import (DataSet, HFlip, ImgNormalizer,
                                         ImgRdmCropper, ImgToBatch, cifar)
    from bigdl_tpu_torch.models.vgg import VggForCifar10
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import (Optimizer, Top1Accuracy,
                                       several_iteration)
    from bigdl_tpu_torch.utils.table import T

    norm = ImgNormalizer(cifar.TRAIN_MEAN, cifar.TRAIN_STD)
    train = (DataSet.array(images) >> norm >> ImgRdmCropper(32, 32, padding=4)
             >> HFlip() >> ImgToBatch(batch))
    model = with_init(VggForCifar10(10, device=device), init, dropout)
    opt = Optimizer(model, train, ClassNLLCriterion(), state=T(
        learningRate=VLR, momentum=0.9, weightDecay=VWD),
        end_trigger=end_trigger, device=device)
    if val_images is not None:
        val = DataSet.array(val_images) >> norm >> ImgToBatch(batch)
        opt.set_validation(several_iteration(VSTEPS), val, [Top1Accuracy()])
    return opt


def train_line(torch, label, opt, wall, batch, n_params, counts):
    """The path's line: ms a step and images/s without validation, the
    host share, memory, launches, losses; returns ms a step."""
    steps = int(opt.state["neval"]) - 1
    val = opt.metrics.get("validate")
    val_s = val[0] if val else 0.0
    step_ms = (wall - val_s) / steps * 1e3
    fetch_s, fetches = opt.metrics.get("data fetch time")
    losses = [l for _, l in opt.loss_log]
    if len(losses) != steps or not np.isfinite(losses).all():
        raise AssertionError(f"{label} losses: {losses}")
    top1 = " ".join(f"Top1 {v['Top1Accuracy']:.4f}"
                    for _, _, v in opt.validation_log)
    print(f"{label}: {n_params} params, {steps} steps of {batch}; wall "
          f"{wall:.4f} s, {step_ms:.4f} ms/step and "
          f"{steps * batch / (wall - val_s):.1f} images/s (validation "
          f"{val_s:.4f} s excluded); host: dataset iterator and H2D copy "
          f"{fetch_s / fetches * 1e3:.4f} ms/batch ({fetch_s / (wall - val_s):.4f} "
          f"of the loop); max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} B; launches "
          f"{ops_nonzero(counts)}; losses {losses[0]:.6f} -> "
          f"{losses[-1]:.6f} {top1}")
    return step_ms


def timed_path(torch, ops, opt):
    """``opt.optimize()`` from zero counts and peak memory: (counts, wall
    seconds)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _, counts, wall = run_path(torch, ops, opt.optimize)
    return counts, wall


def phase_vgg(torch, ops, profile: bool):
    """VGG on CIFAR-10 (``VggForCifar10``, 14,991,946 parameters, 9,472
    running-statistic values) trains VSTEPS steps at full width through
    ``Optimizer(...).optimize()`` as examples/train_vgg.py sets it up and
    validates Top1 once; every step and validation batch takes its five
    pools through ``maxpool2d``, every update ``fused_sgd``; two steps
    at batch 16, dropout off, equal the CPU's, the running statistics
    included."""
    from bigdl_tpu_torch.dataset import cifar
    from bigdl_tpu_torch.models.vgg import VggForCifar10
    from bigdl_tpu_torch.optim import max_iteration
    from bigdl_tpu_torch.utils.random import RNG, generator

    init = init_of(VggForCifar10(10, device="cpu", generator=generator(0)))
    n_params = sum(v.size for v in _leaves(init["params"]))
    n_state = sum(v.size for v in _leaves(init["state"]))
    if (n_params, n_state) != (VPARAMS, VSTATE):
        raise AssertionError(f"VggForCifar10 has {n_params} parameters and "
                             f"{n_state} state values")
    images, val = cifar.synthetic(VTRAIN), cifar.synthetic(VVAL, seed=1)
    RNG.set_seed(0)   # the dropout masks
    # warm-up: cuDNN's algorithm choice, allocator, kernel library loads;
    # its pools' geometries are ones the kernel phase holds
    warm = vgg_run(torch, "cuda", init, images, VBATCH, max_iteration(2))
    with Routes(torch, warm.model, geometry_only=True) as seen:
        warm.optimize()
    held_standalone("vgg", seen)
    opt = vgg_run(torch, "cuda", init, images, VBATCH, max_iteration(VSTEPS),
                  val)
    counts, wall = timed_path(torch, ops, opt)
    steps = int(opt.state["neval"]) - 1
    val_batches = len(opt.validation_log) * -(-VVAL // VBATCH)
    want = {**untapped(counts), "fused_sgd": steps,
            "maxpool2d_forward": 5 * steps + 5 * val_batches,
            "maxpool2d_backward": 5 * steps}
    if steps != VSTEPS or val_batches != 4 or counts != want:
        raise AssertionError(f"VGG launches {counts} after {steps} steps "
                             f"and {val_batches} validation batches, "
                             f"expected {want}")
    moved = state_moved(torch, opt.model, init)
    step_ms = train_line(torch, f"vgg: VggForCifar10, {n_state} running-"
                         f"statistic values (moved up to {moved:.4f}), "
                         f"{val_batches} validation batches", opt, wall,
                         VBATCH, n_params, counts)
    if not moved > 0:
        raise AssertionError("VGG: the running statistics did not move")
    check = cifar.synthetic(VCHECK_BATCH * VCHECK_STEPS, seed=2)
    diff = card_vs_cpu(torch, init["params"], lambda device: vgg_run(
        torch, device, init, check, VCHECK_BATCH,
        max_iteration(VCHECK_STEPS), dropout=0.0), routed=True)
    print_vs_cpu("vgg", VCHECK_BATCH, diff, PARAM_ATOL)
    if profile:
        busy = profile_train(torch, lambda end: vgg_run(
            torch, "cuda", init, images, VBATCH, end), 8)
        print(f"profile: device idle share of the unprofiled VGG train "
              f"step {1 - busy / step_ms:.4f} ({busy:.4f} of {step_ms:.4f} "
              f"ms/step busy)")
    held_vs_cpu("vgg", diff, PARAM_ATOL, scope="model")
    return counts


def snapshot_line(torch, model, step_ms):
    """The time of one step's buffer snapshot (``LocalOptimizer`` saves
    the running statistics before a step and puts them back after a
    non-finite one): a save and a restore, on ``model``'s buffers, one
    at a time and queued back to back (the device's time where it
    outlasts the host's launches)."""
    from bigdl_tpu_torch.optim.local_optimizer import _BufferSnapshot

    kept = _BufferSnapshot(model)
    finite = torch.ones((), dtype=torch.bool, device="cuda")
    flush = torch.empty(64 * 2**20, device="cuda")   # 256 MB > 50 MB L2
    def step():
        kept.save()
        kept.restore_unless(finite)

    ms, queued = time_ms(torch, step, flush), time_queued_ms(torch, step)
    bufs = list(model.buffers())
    print(f"buffer snapshot: {len(bufs)} buffers, "
          f"{sum(b.numel() for b in bufs)} values, save and restore "
          f"{ms:.5f} ms a step, L2 flushed ({ms / step_ms:.5f} of the "
          f"step; the host's launches included), {queued:.5f} ms queued "
          f"back to back")


def resnet50_images(n, seed):
    """examples/train_resnet50_imagenet.py:55-58 (``--synthetic``): ``n``
    RGB images of 224 x 224, uniform [0, 255), labels 1..1000."""
    from bigdl_tpu_torch.dataset import LabeledImage

    rng = np.random.RandomState(seed)
    return [LabeledImage(rng.uniform(0, 255, (224, 224, 3)),
                         rng.randint(1, ICLASSES + 1)) for _ in range(n)]


def resnet50_run(torch, device, init, images, batch, end_trigger,
                 lr=R50_LR):
    """examples/train_resnet50_imagenet.py:57-84 (``--synthetic``) from
    ``init``: flips and the mean/std normalisation over ``images``
    (``DataSet.array`` without ``distributed=``), SGD with lr 0.1, weight
    decay 1e-4, momentum 0.9, dampening 0, nesterov and EpochStep(30,
    0.1) (``lr`` in place of 0.1 when given).  An optimizer ready to
    run."""
    from bigdl_tpu_torch.dataset import (DataSet, HFlip, ImgNormalizer,
                                         ImgToBatch)
    from bigdl_tpu_torch.models.resnet import ResNet
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import EpochStep, Optimizer
    from bigdl_tpu_torch.utils.table import T

    train = (DataSet.array(images) >> HFlip()
             >> ImgNormalizer((123.0, 117.0, 104.0), (58.4, 57.1, 57.4))
             >> ImgToBatch(batch))
    model = with_init(ResNet(50, ICLASSES, device=device), init)
    return Optimizer(model, train, ClassNLLCriterion(), state=T(
        learningRate=lr, weightDecay=R50_WD, momentum=0.9,
        dampening=0.0, nesterov=True,
        learningRateSchedule=EpochStep(30, 0.1)),
        end_trigger=end_trigger, device=device)


def phase_resnet50(torch, ops, profile: bool):
    """ResNet-50 (25,557,032 parameters, 53 BN layers) trains R50_STEPS
    steps at full width, batch 256, through ``Optimizer(...).optimize()``
    as examples/train_resnet50_imagenet.py --synthetic sets it up; every
    step takes its stem pool through ``maxpool2d`` and its update through
    ``fused_sgd``; R50_CHECK_STEPS steps at batch 8 and lr 0.01 equal the
    CPU's, the running statistics included (the first batch's gradients
    from an init that draws the zeroed BN weights U(0, 1)); the buffer
    snapshot's time a step."""
    from bigdl_tpu_torch.models.resnet import ResNet
    from bigdl_tpu_torch.nn import SpatialBatchNormalization
    from bigdl_tpu_torch.optim import max_iteration
    from bigdl_tpu_torch.utils.random import generator

    model = ResNet(50, ICLASSES, device="cpu", generator=generator(0))
    init = init_of(model)
    n_params = sum(v.size for v in _leaves(init["params"]))
    n_bn = sum(isinstance(m, SpatialBatchNormalization)
               for m in model.modules())
    zeroed = sum(1 for m in model.modules()
                 if isinstance(m, SpatialBatchNormalization)
                 and not bool(m.weight.any()))
    if (n_params, n_bn, zeroed) != (R50_PARAMS, 53, 16):
        raise AssertionError(f"ResNet-50: {n_params} parameters, {n_bn} BN "
                             f"layers, {zeroed} zeroed")
    t0 = time.perf_counter()
    images = resnet50_images(R50_IMAGES, 0)
    make_s = time.perf_counter() - t0
    # warm-up: cuDNN's algorithm choice, allocator, kernel library loads;
    # its pools' geometries are ones the kernel phase holds
    warm = resnet50_run(torch, "cuda", init, images, R50_BATCH,
                        max_iteration(2))
    with Routes(torch, warm.model, geometry_only=True) as seen:
        warm.optimize()
    held_standalone("resnet50", seen)
    del warm
    opt = resnet50_run(torch, "cuda", init, images, R50_BATCH,
                       max_iteration(R50_STEPS))
    counts, wall = timed_path(torch, ops, opt)
    steps = int(opt.state["neval"]) - 1
    want = {**untapped(counts), "fused_sgd": steps,
            "maxpool2d_forward": steps, "maxpool2d_backward": steps}
    if steps != R50_STEPS or counts != want:
        raise AssertionError(f"ResNet-50 launches {counts} after {steps} "
                             f"steps, expected {want}")
    moved = state_moved(torch, opt.model, init)
    step_ms = train_line(torch, f"resnet50: ResNet(50), {n_bn} BN layers "
                         f"({zeroed} final weights zeroed; running "
                         f"statistics moved up to {moved:.4f}), "
                         f"{R50_IMAGES} synthetic images made in "
                         f"{make_s:.2f} s", opt, wall, R50_BATCH, n_params,
                         counts)
    snapshot_line(torch, opt.model, step_ms)
    # the steps from the model's own init; the first batch's gradients
    # from it with the zeroed BN weights drawn U(0, 1) (at lr 0.1 and
    # batch 8, steps from that init diverge: a rounding's perturbation
    # of it ends 0.48 apart after two steps on the CPU)
    check_init = ungated(init)
    check = resnet50_images(R50_CHECK_BATCH * R50_CHECK_STEPS, 2)
    diff = card_vs_cpu(
        torch, init["params"], lambda device: resnet50_run(
            torch, device, init, check, R50_CHECK_BATCH,
            max_iteration(R50_CHECK_STEPS), R50_CHECK_LR),
        make_probe=lambda device: resnet50_run(
            torch, device, check_init, check, R50_CHECK_BATCH,
            max_iteration(R50_CHECK_STEPS)), routed=True)
    print_vs_cpu("resnet50", R50_CHECK_BATCH, diff, IPARAM_ATOL)
    if profile:
        busy = profile_train(torch, lambda end: resnet50_run(
            torch, "cuda", init, images, R50_BATCH, end), 4)
        print(f"profile: device idle share of the unprofiled ResNet-50 "
              f"train step {1 - busy / step_ms:.4f} ({busy:.4f} of "
              f"{step_ms:.4f} ms/step busy)")
    held_vs_cpu("resnet50", diff, IPARAM_ATOL, scope="model")
    return counts


def png_encode(px, level=1):
    """PNG bytes of the uint8 RGB image ``px`` (h, w, 3): colour type 2,
    bit depth 8, row y under filter type y % 5 (None, Sub, Up, Average,
    Paeth), zlib at ``level``: the writer of the ``imagenet`` phase's
    folder, which needs no Pillow."""
    h, w, _ = px.shape
    p = px.reshape(h, w * 3).astype(np.int16)
    zero_row, zero_px = np.zeros((1, w * 3), np.int16), np.zeros((h, 3),
                                                                 np.int16)
    up = np.vstack([zero_row, p[:-1]])
    left = np.hstack([zero_px, p[:, :-3]])
    ul = np.hstack([zero_px, up[:, :-3]])
    pa, pb = np.abs(up - ul), np.abs(left - ul)
    pc = np.abs(left + up - 2 * ul)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, ul))
    kind = (np.arange(h) % 5)[:, None]
    pred = np.select([kind == 1, kind == 2, kind == 3, kind == 4],
                     [left, up, (left + up) >> 1, paeth], 0)
    raw = np.hstack([kind.astype(np.uint8),
                     ((p - pred) & 0xFF).astype(np.uint8)]).tobytes()

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, level))
            + chunk(b"IEND", b""))


def imagenet_folder(root, n, classes, seed):
    """``n`` smooth seeded RGB images, ``IN_SIDES`` px a side, in
    ``classes`` class folders under ``root`` as PNGs (threads: zlib lets
    go of the GIL); (the folder, the files in class order, the raw
    pixels of each, seconds)."""
    from concurrent.futures import ThreadPoolExecutor

    rs = np.random.RandomState(seed)
    specs = [(i % classes, rs.randint(IN_SIDES[0], IN_SIDES[1] + 1, 2),
              rs.uniform(0, 1, (4, 3))) for i in range(n)]

    def one(i):
        c, (h, w), r = specs[i]
        y = np.arange(h, dtype=np.float32)[:, None, None] / h
        x = np.arange(w, dtype=np.float32)[None, :, None] / w
        base = 40.0 + 180.0 * c / (classes - 1)
        img = (base + 60.0 * np.sin(6.0 * (r[0] + 1) * x + 9.0 * r[1])
               * np.cos(4.0 * (r[2] + 1) * y + 9.0 * r[3]))
        px = np.clip(img, 0, 255).astype(np.uint8)
        path = os.path.join(root, f"n{c:04d}", f"{i:05d}.png")
        with open(path, "wb") as f:
            f.write(png_encode(px))
        return path, px

    t0 = time.perf_counter()
    for c in range(classes):
        os.makedirs(os.path.join(root, f"n{c:04d}"), exist_ok=True)
    with ThreadPoolExecutor(8) as pool:
        out = list(pool.map(one, range(n)))
    return out, time.perf_counter() - t0


def pb_varint(v) -> bytes:
    """A protobuf varint."""
    out = b""
    while True:
        b, v = v & 0x7F, v >> 7
        if not v:
            return out + bytes([b])
        out += bytes([b | 0x80])


def pb_field(num, payload, wire=2):
    """A protobuf field: its tag, then ``payload`` (length-delimited for
    wire type 2, a varint's bytes for 0)."""
    tag = pb_varint((num << 3) | wire)
    return tag + (pb_varint(len(payload)) + payload if wire == 2
                  else payload)


def caffemodel_bytes(layers):
    """A .caffemodel (NetParameter) of ``layers`` [(name, [blobs])]: each
    a LayerParameter (field 100: name 1, type 2, blobs 7), each blob a
    BlobProto (shape 7 as BlobShape's dims, data 5 packed floats).  This
    script's own writer, which needs no protobuf package."""
    def blob(a):
        dims = b"".join(pb_field(1, pb_varint(d), 0) for d in a.shape)
        return pb_field(7, dims) + pb_field(
            5, np.ascontiguousarray(a, np.float32).tobytes())

    return b"".join(
        pb_field(100, pb_field(1, name.encode()) + pb_field(2, b"Convolution")
                 + b"".join(pb_field(7, blob(b)) for b in blobs))
        for name, blobs in layers)


def imagenet_run(torch, device, init, shards, batch, end_trigger,
                 lr=R50_LR):
    """examples/train_resnet50_imagenet.py:60-84 without ``--synthetic``
    from ``init``: ``ShardFolder(shards, distributed=True) >>
    BytesToImg(256) >> ImgRdmCropper(224, 224) >> HFlip() >>
    ColorJitter(channel_order="rgb") >> Lighting() >> ImgNormalizer >>
    ImgToBatch(batch)`` into ``Optimizer(...)``, which routes it to the
    ``DistriOptimizer`` (a world of one on ``device``'s backend), with
    the example's SGD (``lr`` in place of 0.1 when given).  An optimizer
    ready to run."""
    from bigdl_tpu_torch.dataset import (BytesToImg, ColorJitter, HFlip,
                                         ImgNormalizer, ImgRdmCropper,
                                         ImgToBatch, Lighting)
    from bigdl_tpu_torch.dataset.shardfile import ShardFolder
    from bigdl_tpu_torch.models.resnet import ResNet
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import EpochStep, Optimizer
    from bigdl_tpu_torch.utils.table import T

    world_for(torch, device)
    train = (ShardFolder(shards, distributed=True) >> BytesToImg(ISIZE)
             >> ImgRdmCropper(ICROP, ICROP) >> HFlip()
             >> ColorJitter(channel_order="rgb") >> Lighting()
             >> ImgNormalizer(IN_MEAN, IN_STD) >> ImgToBatch(batch))
    model = with_init(ResNet(50, ICLASSES, device=device), init)
    return Optimizer(model, train, ClassNLLCriterion(), state=T(
        learningRate=lr, weightDecay=R50_WD, momentum=0.9,
        dampening=0.0, nesterov=True,
        learningRateSchedule=EpochStep(30, 0.1)),
        end_trigger=end_trigger, device=device)


def imagenet_train(torch, ops, root, smi):
    """The folder, its shards and ResNet-50's epoch over them; the CPU
    check.  (the path's counts, the files, their pixels)."""
    from bigdl_tpu_torch.dataset import BytesToImg, ByteRecord
    from bigdl_tpu_torch.dataset import imagenet_tools
    from bigdl_tpu_torch.dataset.image import _resize
    from bigdl_tpu_torch.dataset.shardfile import ShardFolder
    from bigdl_tpu_torch.models.resnet import ResNet
    from bigdl_tpu_torch.optim import (DistriOptimizer, max_epoch,
                                       max_iteration)
    from bigdl_tpu_torch.utils.engine import Engine
    from bigdl_tpu_torch.utils.random import generator

    files, write_s = imagenet_folder(os.path.join(root, "train"),
                                     IN_IMAGES, IN_CLASSES, 0)
    nbytes = sum(os.path.getsize(f) for f, _ in files)
    t0 = time.perf_counter()
    shards, n_classes = imagenet_tools.generate(
        os.path.join(root, "train"), os.path.join(root, "shards"),
        IN_SHARDS)
    pack_s = time.perf_counter() - t0
    print(f"imagenet: {IN_IMAGES} PNGs ({nbytes} B, {IN_SIDES[0]}-"
          f"{IN_SIDES[1]} px a side, the five filters by row) written in "
          f"{write_s:.2f} s; {len(shards)} shards of {n_classes} classes "
          f"packed in {pack_s:.2f} s")
    if n_classes != IN_CLASSES or len(shards) != IN_SHARDS:
        raise AssertionError(f"imagenet: {len(shards)} shards, "
                             f"{n_classes} classes")
    # the host's decode alone (the port's PNG decoder), then the resize
    # to 256, over 64 of the records, each scaled to a batch
    recs = [ByteRecord(open(f, "rb").read(), 1.0) for f, _ in files[:64]]
    t0 = time.perf_counter()
    direct = list(BytesToImg()(iter(recs)))
    t1 = time.perf_counter()
    resized = [_resize(d.data, ISIZE, ISIZE) for d in direct]
    t2 = time.perf_counter()
    decode_ms, resize_ms = ((b - a) / len(recs) * R50_BATCH * 1e3
                            for a, b in ((t0, t1), (t1, t2)))
    if not all(np.array_equal(d.data, px) for d, (_, px)
               in zip(direct, files)) or len(resized) != len(recs):
        raise AssertionError("imagenet: the PNG decode left the written "
                             "pixels")

    init = init_of(ResNet(50, ICLASSES, device="cpu",
                          generator=generator(0)))
    folder = os.path.join(root, "shards")
    try:
        opt = imagenet_run(torch, "cuda", init, folder, R50_BATCH,
                           max_epoch(1))
        if not isinstance(opt, DistriOptimizer) or opt.mesh.size != 1:
            raise AssertionError(f"imagenet: Optimizer gave {type(opt)}")
        counts, wall = timed_path(torch, ops, opt)
        steps = int(opt.state["neval"]) - 1
        want = {**untapped(counts), "fused_sgd": steps,
                "maxpool2d_forward": steps, "maxpool2d_backward": steps}
        if steps != IN_IMAGES // R50_BATCH or counts != want:
            raise AssertionError(f"imagenet ResNet-50 launches {counts} "
                                 f"after {steps} steps, expected {want}")
        moved = state_moved(torch, opt.model, init)
        step_ms = train_line(torch, f"imagenet: ResNet(50) through "
                             f"DistriOptimizer (world {opt.mesh.size}) "
                             f"over ShardFolder(distributed=True), one "
                             f"epoch of {IN_IMAGES} PNGs (running "
                             f"statistics moved up to {moved:.4f})", opt,
                             wall, R50_BATCH, R50_PARAMS, counts)
        fetch_s, fetches = opt.metrics.get("data fetch time")
        print(f"imagenet host: the PNG decode {decode_ms:.1f} ms and the "
              f"resize to {ISIZE} {resize_ms:.1f} ms a batch of "
              f"{R50_BATCH} (one thread, from 64 records); the whole chain "
              f"and H2D {fetch_s / fetches * 1e3:.1f} ms a batch; "
              f"{step_ms:.1f} ms a step; [{smi}]")
        del opt
        check_init = ungated(init)
        diff = card_vs_cpu(
            torch, init["params"], lambda device: imagenet_run(
                torch, device, init, folder, R50_CHECK_BATCH,
                max_iteration(R50_CHECK_STEPS), R50_CHECK_LR),
            make_probe=lambda device: imagenet_run(
                torch, device, check_init, folder, R50_CHECK_BATCH,
                max_iteration(R50_CHECK_STEPS)), routed=True)
    finally:
        Engine.reset()
    print_vs_cpu("imagenet", R50_CHECK_BATCH, diff, IPARAM_ATOL)
    held_vs_cpu("imagenet", diff, IPARAM_ATOL, scope="model")
    if ShardFolder(folder).size() != IN_IMAGES:
        raise AssertionError("imagenet: the shards lost records")
    return counts, files


def imagenet_validator(torch, ops, root, files, smi):
    """A .caffemodel of a seeded Inception-v1's named layers into a card
    model; examples/model_validator.py's chain over IN_VAL of the PNGs;
    the logits against the CPU's; the model through a .t7 and back."""
    from bigdl_tpu_torch.dataset import (ByteRecord, BytesToImg, DataSet,
                                         ImgCropper, ImgNormalizer,
                                         ImgToBatch)
    from bigdl_tpu_torch.models.inception import Inception_v1
    from bigdl_tpu_torch.optim import Top1Accuracy, Top5Accuracy, validate
    from bigdl_tpu_torch.utils import CaffeLoader, TorchFile
    from bigdl_tpu_torch.utils.random import generator

    src = Inception_v1(ICLASSES, device="cpu", generator=generator(3))
    named = CaffeLoader._named_param_modules(src)
    layers = [(n, [m.weight.detach().numpy(), m.bias.detach().numpy()])
              for n, m in sorted(named.items())]
    path = os.path.join(root, "inception.caffemodel")
    with open(path, "wb") as f:
        f.write(caffemodel_bytes(layers))
    models = {}
    for device in ("cuda", "cpu"):
        m = Inception_v1(ICLASSES, device=device, generator=generator(0))
        _, copied = CaffeLoader.load(m, path, match_all=False)
        models[device] = m
        if copied != set(named):
            raise AssertionError(f"imagenet caffe: copied {copied}")
    card = models["cuda"]
    got = CaffeLoader._named_param_modules(card)
    same = all(torch.equal(got[n].weight.cpu(), torch.from_numpy(w))
               and torch.equal(got[n].bias.cpu(), torch.from_numpy(b))
               for n, (w, b) in layers)
    if not same:
        raise AssertionError("imagenet caffe: a copied blob differs")
    # examples/model_validator.py:64-68's chain; its ``image_folder``
    # yields (path, label) pairs that BytesToImg cannot read, so the
    # records are the files' bytes
    step = len(files) // IN_VAL
    recs = [ByteRecord(open(f, "rb").read(), float(i % IN_CLASSES + 1))
            for i, (f, _) in enumerate(files) if i % step == 0][:IN_VAL]
    norm = ImgNormalizer((123.0, 117.0, 104.0), (1.0, 1.0, 1.0))
    val = (DataSet.array(recs) >> BytesToImg(ISIZE)
           >> ImgCropper(ICROP, ICROP) >> norm >> ImgToBatch(IN_VAL_BATCH))
    (res, counts, wall) = run_path(torch, ops, lambda: validate(
        card, val, [Top1Accuracy(), Top5Accuracy()], "cuda"))
    batches = IN_VAL // IN_VAL_BATCH
    want = {**untapped(counts), "lrn_forward": 2 * batches,
            "maxpool2d_s1_forward": 9 * batches,
            "maxpool2d_forward": 4 * batches}
    (_, top1), (_, top5) = res
    if counts != want or top1.result()[1] != IN_VAL:
        raise AssertionError(f"imagenet validator: launches {counts} "
                             f"(expected {want}), {top1.result()}")
    x = next(val.data(train=False)).data[:IN_VAL_CPU]
    with torch.no_grad():
        card.eval()
        models["cpu"].eval()
        lc = card(torch.from_numpy(x).cuda()).cpu()
        lp = models["cpu"](torch.from_numpy(x))
    logit_rel = leaf_rel(lc, lp.double())
    t7 = os.path.join(root, "inception.t7")
    TorchFile.save_module(card, t7)
    back = Inception_v1(ICLASSES, device="cuda", generator=generator(1))
    TorchFile.load_module_weights(back, t7)
    t7_same = all(torch.equal(a, b) for a, b in
                  zip(back.parameters(), card.parameters()))
    print(f"imagenet validator: {len(copied)} Caffe layers "
          f"({', '.join(sorted(copied))}) copied bit for bit; "
          f"Inception-v1 over {IN_VAL} PNGs in batches of {IN_VAL_BATCH}: "
          f"Top1 {top1.result()[0]:.4f} Top5 {top5.result()[0]:.4f} in "
          f"{wall * 1e3:.1f} ms; launches {ops_nonzero(counts)}; logits "
          f"of {IN_VAL_CPU} against the CPU {logit_rel:.3e} of the largest "
          f"(limit {RTOL}); .t7 round trip bit for bit: {t7_same} "
          f"({os.path.getsize(t7)} B); [{smi}]")
    if logit_rel > RTOL or not t7_same:
        raise AssertionError("imagenet validator: logits or .t7 round trip")
    return counts


def imagenet_seqfile(torch, root, files, smi):
    """IN_SEQ of the images through a SequenceFile and back, bit for bit;
    ``MTLabeledImgToBatch`` over them at 1 and 8 threads."""
    from bigdl_tpu_torch.dataset import (ByteRecord, BytesToImg, DataSet,
                                         HFlip, ImgNormalizer,
                                         ImgRdmCropper, MTLabeledImgToBatch)
    from bigdl_tpu_torch.dataset.seqfile import (BGRImgToLocalSeqFile,
                                                 SeqBytesToBGRImg)

    step = len(files) // IN_SEQ
    picked = [(f, px) for i, (f, px) in enumerate(files) if i % step == 0]
    recs = [ByteRecord(open(f, "rb").read(), float(i % IN_CLASSES + 1))
            for i, (f, _) in enumerate(picked)]
    seq_dir = os.path.join(root, "seq")
    t0 = time.perf_counter()
    written = list(BGRImgToLocalSeqFile(IN_SEQ // 2, os.path.join(
        seq_dir, "imagenet"), normalize=1.0)(BytesToImg()(iter(recs))))
    write_s = time.perf_counter() - t0
    back = list((DataSet.seq_file_folder(seq_dir)
                 >> SeqBytesToBGRImg(normalize=1.0)).data(train=False))
    exact = len(back) == len(picked) and all(
        np.array_equal(b.data, px[..., ::-1]) and b.order == "bgr"
        for b, (_, px) in zip(back, picked))
    if not exact or len(written) != 2:
        raise AssertionError("imagenet: the SequenceFile round trip "
                             "left the pixels")
    rates, runs = {}, {}
    for threads in (1, 8):
        chain = (SeqBytesToBGRImg(normalize=1.0) >> ImgRdmCropper(ICROP,
                                                                  ICROP)
                 >> HFlip() >> ImgNormalizer((104.0, 117.0, 123.0),
                                             (57.4, 57.1, 58.4)))
        ds = DataSet.seq_file_folder(seq_dir, seed=5) >> \
            MTLabeledImgToBatch(ICROP, ICROP, IN_SEQ_BATCH, chain,
                                num_threads=threads)
        t0 = time.perf_counter()
        runs[threads] = list(ds.data(train=False))
        rates[threads] = IN_SEQ / (time.perf_counter() - t0)
    same = all(np.array_equal(a.data, b.data) and
               np.array_equal(a.labels, b.labels)
               for a, b in zip(runs[1], runs[8]))
    print(f"imagenet seqfile: {IN_SEQ} images to {len(written)} "
          f"SequenceFiles in {write_s:.2f} s and back bit for bit; "
          f"MTLabeledImgToBatch (read, crop, flip, normalise; batches of "
          f"{IN_SEQ_BATCH}) {rates[1]:.1f} images/s at 1 thread, "
          f"{rates[8]:.1f} at 8 (host; the same batches: {same}); [{smi}]")
    if not same or len(runs[1]) != IN_SEQ // IN_SEQ_BATCH:
        raise AssertionError("imagenet: MTLabeledImgToBatch's batches "
                             "depend on its threads")


def phase_imagenet(torch, ops, profile: bool):
    """Config 5's input path at full width (``imagenet_train``), the
    weight import and the validator (``imagenet_validator``), the
    SequenceFile path (``imagenet_seqfile``); the files live in a
    temporary directory, removed after."""
    import tempfile

    del profile
    smi = smi_line()
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="bigdl-imagenet-")
    try:
        train_counts, files = imagenet_train(torch, ops, root, smi)
        val_counts = imagenet_validator(torch, ops, root, files, smi)
        imagenet_seqfile(torch, root, files, smi)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"imagenet: {time.perf_counter() - t0:.1f} s")
    return {"imagenet": train_counts, "imagenet_validate": val_counts}, {}


def bn_set(images, batch):
    """examples/train_resnet.py's chain: normalised, padded by 4 and
    cropped back to 32 at random, flipped, batched."""
    from bigdl_tpu_torch.dataset import (DataSet, HFlip, ImgNormalizer,
                                         ImgRdmCropper, ImgToBatch, cifar)

    return (DataSet.array(images)
            >> ImgNormalizer(cifar.TRAIN_MEAN, cifar.TRAIN_STD)
            >> ImgRdmCropper(32, 32, padding=4) >> HFlip()
            >> ImgToBatch(batch))


def bn_run(torch, device, init, train, n=1, graph=True, end=None,
           model=None):
    """examples/train_resnet.py on the dataset ``train`` from ``init``:
    ``ResNetCifar(20)``, SGD with lr 0.1, momentum 0.9, weight decay 1e-4,
    dampening 0, nesterov and EpochStep(81, 0.1); n steps a dispatch (one
    CUDA graph on the card unless ``graph`` is False); ``model`` (a
    resumed one) instead of a new model from ``init``."""
    from bigdl_tpu_torch.models.resnet import ResNetCifar
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import EpochStep, Optimizer
    from bigdl_tpu_torch.utils.table import T

    if model is None:
        model = with_init(ResNetCifar(BN_DEPTH, 10, device=device), init)
    opt = Optimizer(model, train, ClassNLLCriterion(), state=T(
        learningRate=0.1, momentum=0.9, weightDecay=1e-4, dampening=0.0,
        nesterov=True, learningRateSchedule=EpochStep(81, 0.1)),
        end_trigger=end, device=device)
    return graph_or_eager(opt, n, graph)


def _run_state(torch, opt):
    """Params, velocities and running statistics of a run, flat on the
    host."""
    vel = opt.opt_state["velocity"]
    return [torch.cat([t.detach().float().cpu().reshape(-1) for t in ts])
            for ts in (list(opt.model.parameters()), vel,
                       list(opt.model.buffers()))]


def phase_bn_harness(torch, ops):
    """The harness with module state, ``ResNetCifar(20)`` at full width
    (batch 128, examples/train_resnet.py's SGD): HSTEPS steps at
    HDISPATCH a dispatch as one CUDA graph against the eager loop under
    the deterministic algorithms, parameters, velocities and running
    statistics bit-equal, the replays' kernels counted by the profiler,
    beside one step a dispatch; a snapshot mid-run (every HCKPT_EVERY of
    HCKPT_STEPS steps, one batch an epoch) resumes on the card and ends
    where the uninterrupted run does, running statistics included.
    Returns the wrappers' counts of each path and the kernels the graph's
    replays ran."""
    import tempfile

    from bigdl_tpu_torch.dataset import cifar
    from bigdl_tpu_torch.models.resnet import ResNetCifar
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.optim import (load_latest_checkpoint, max_iteration,
                                       several_iteration)
    from bigdl_tpu_torch.utils.random import generator

    init = init_of(ResNetCifar(BN_DEPTH, 10, device="cpu",
                               generator=generator(0)))
    n_params = sum(v.size for v in _leaves(init["params"]))
    if n_params != BN_PARAMS:
        raise AssertionError(f"ResNetCifar(20) has {n_params} parameters")
    images = cifar.synthetic(4 * BN_BATCH, seed=3)
    runs = {}
    with deterministic(torch):
        for name, n, graph in (("n1", 1, True), ("eager", HDISPATCH, False),
                               ("graph", HDISPATCH, True)):
            opt = bn_run(torch, "cuda", init, bn_set(images, BN_BATCH), n,
                         graph)
            opt.set_end_when(max_iteration(HDISPATCH)).optimize()
            opt.set_end_when(max_iteration(HDISPATCH + HSTEPS))
            _, counts, wall = run_path(torch, ops, opt.optimize)
            runs[name] = (opt, counts, wall)
        eager, _, _ = runs["eager"]
        graph, _, _ = runs["graph"]
        same = [torch.equal(a, b) for a, b in zip(_run_state(torch, eager),
                                                  _run_state(torch, graph))]
        la = [l for _, l in eager.loss_log]
        lb = [l for _, l in graph.loss_log]
        if not all(same) or la != lb:
            raise AssertionError(f"bn_harness: the graph is not bit-equal "
                                 f"to the eager loop (params, velocities, "
                                 f"running statistics: {same}; losses "
                                 f"{la == lb})")
        if (graph.captures, graph.replays) != (1, HSTEPS // HDISPATCH):
            raise AssertionError(f"bn_harness: {graph.captures} captures, "
                                 f"{graph.replays} replays")
        ran = {}
        for name, (opt, counts, wall) in runs.items():
            per_run = HDISPATCH if opt is graph else HSTEPS
            if counts != {**untapped(counts), "fused_sgd": per_run}:
                raise AssertionError(f"bn_harness {name}: the wrappers "
                                     f"counted {counts}")
            profiled = READ["profiled"] or 2 * HDISPATCH
            busy, ran[name] = profiled_run(torch, opt, profiled)
            step_ms = wall / HSTEPS * 1e3
            print(f"bn_harness {name} (n={opt.iters_per_dispatch}): "
                  f"{step_ms:.4f} ms/step, "
                  f"{HSTEPS * BN_BATCH / wall:.1f} images/s, device "
                  f"{busy:.4f} ms/step busy, idle share "
                  f"{1 - busy / step_ms:.4f}; the wrappers counted "
                  f"{ops_nonzero(counts)}; the profiler, "
                  f"{profiled} steps: {ran[name]}")
            if ran[name] != {"fused_sgd": profiled}:
                raise AssertionError(f"bn_harness {name}: the card ran "
                                     f"{ran[name]}")
    moved = state_moved(torch, graph.model, init)
    print(f"bn_harness: ResNetCifar({BN_DEPTH}) {n_params} params, "
          f"{sum(v.size for v in _leaves(init['state']))} running-statistic "
          f"values (moved up to {moved:.4f}); {HSTEPS} steps at "
          f"{HDISPATCH} a dispatch as one CUDA graph ({graph.replays} "
          f"replays of one capture) bit-equal to the eager loop in params, "
          f"velocities, running statistics and losses "
          f"{lb[0]:.6f} -> {lb[-1]:.6f}")

    # a snapshot mid-run: one batch an epoch, so each lands on a boundary
    one = cifar.synthetic(BN_BATCH, seed=5)
    with tempfile.TemporaryDirectory(dir=_build.build_dir()) as tmp, \
            deterministic(torch):
        opt_a = bn_run(torch, "cuda", init, bn_set(one, BN_BATCH),
                       end=max_iteration(HCKPT_STEPS))
        opt_a.set_checkpoint(tmp, several_iteration(HCKPT_EVERY))
        _, ck_counts, _ = run_path(torch, ops, opt_a.optimize)
        want = _run_state(torch, opt_a)
        for k in range(2 * HCKPT_EVERY, HCKPT_STEPS + 1, HCKPT_EVERY):
            with open(f"{tmp}/model.{k}", "wb") as f:
                f.write(b"rot")
        ds = bn_set(one, BN_BATCH)
        module, blob, neval = load_latest_checkpoint(
            tmp, restore_rng=True, device="cuda", dataset=ds)
        resumed_state = state_moved(torch, module, init)
        opt_b = bn_run(torch, "cuda", init, ds,
                       end=max_iteration(HCKPT_STEPS), model=module)
        opt_b.set_state(blob["state"]).set_optim_state(blob["opt_state"])
        opt_b.optimize()
        got = _run_state(torch, opt_b)
    same = [torch.equal(a, b) for a, b in zip(got, want)]
    if neval != HCKPT_EVERY or not all(same):
        raise AssertionError(f"bn_harness checkpoint: resumed from {neval}; "
                             f"params, velocities, running statistics "
                             f"bit-equal to the uninterrupted run's: {same}")
    print(f"bn_harness checkpoint: {HCKPT_STEPS} steps on one batch an "
          f"epoch, a snapshot every {HCKPT_EVERY}, the later ones "
          f"corrupted; resumed from {neval} (its running statistics "
          f"{resumed_state:.4f} from the init's): final params, velocities "
          f"and running statistics bit-equal to the uninterrupted run's")
    by_path = {f"bn_harness_{k}": c for k, (_, c, _) in runs.items()}
    by_path["bn_harness_checkpoint"] = ck_counts
    return by_path, {"bn_harness_graph": ran["graph"]}


def zoo_criterion(torch, out, x, y, mse):
    """NLL of the log-probs, or the reconstruction's mean squared
    error."""
    return (((out - x.reshape(out.shape)) ** 2).mean() if mse
            else torch.nn.functional.nll_loss(out, y))


def zoo_forward_backward(torch, model, x, y, mse, replay=None):
    """One training forward and backward from zero gradients: (log-probs
    or reconstruction, loss, parameter gradients, running statistics), on
    the host in float64, and the forward's ``Routes`` (recorded, or
    ``replay``'s replayed)."""
    model.train()
    model.zero_grad(set_to_none=True)
    with Routes(torch, model, replay=replay) as seen:
        out = model(x)
    loss = zoo_criterion(torch, out, x, y, mse)
    loss.backward()
    return ([out.detach().cpu().double()], float(loss.detach()),
            [p.grad.detach().cpu().double() for p in model.parameters()],
            [b.detach().cpu().double() for b in model.buffers()]), seen


def zoo_ms(torch, model, x, y, mse, reps=5):
    """Median ms of one training forward and backward on the card (CUDA
    events; the gradients accumulate, which costs what zeroing would)."""
    times = []
    for r in range(reps + 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        zoo_criterion(torch, model(x), x, y, mse).backward()
        end.record()
        end.synchronize()
        if r:
            times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_model_zoo(torch, ops):
    """One training forward and backward of each model at full width and
    a small batch (Inception_v2, Vgg_16, AlexNet, Autoencoder), from one
    random init, against the CPU (``held_vs_cpu`` over the whole model):
    log-probs, loss, running statistics, and gradients against float64
    runs that take each fp32 run's routing (``Routes``); the same on the
    card with cuDNN off (PyTorch's own convolutions), which parts the
    port's kernels from cuDNN's algorithms.  Every pool and LRN geometry
    met is one the kernel phases hold, and the launch counts show each
    went through its kernel.  Then the step's time on the card."""
    import copy

    from bigdl_tpu_torch.models import (AlexNet, Autoencoder, Inception_v2,
                                        Vgg_16)
    from bigdl_tpu_torch.utils.random import generator

    by_path = {}
    for name, build, batch, shape, n_params, per_call in (
            ("Inception_v2", Inception_v2, 8, (3, 224, 224), 11204936,
             {"maxpool2d_forward": 4, "maxpool2d_backward": 4,
              "maxpool2d_s1_forward": 1, "maxpool2d_s1_backward": 1}),
            ("Vgg_16", Vgg_16, 4, (3, 224, 224), 138357544,
             {"maxpool2d_forward": 5, "maxpool2d_backward": 5}),
            ("AlexNet", AlexNet, 8, (3, 227, 227), 60965224,
             {"lrn_forward": 2, "lrn_backward": 2, "maxpool2d_forward": 3,
              "maxpool2d_backward": 3}),
            ("Autoencoder", lambda c, **kw: Autoencoder(32, **kw), 32,
             (28, 28), 50992, {})):
        cpu_model = build(1000, device="cpu", generator=generator(0))
        got = sum(p.numel() for p in cpu_model.parameters())
        if got != n_params:
            raise AssertionError(f"{name}: {got} parameters")
        set_dropout(cpu_model, 0.0)
        rs = np.random.RandomState(1)
        mse = name == "Autoencoder"
        x = (rs.uniform(0, 1, (batch,) + shape) if mse
             else rs.randn(batch, *shape)).astype(np.float32)
        y = torch.from_numpy(rs.randint(0, 1000, batch))
        card = copy.deepcopy(cpu_model).cuda()
        xt = torch.from_numpy(x)
        torch.cuda.synchronize()
        (res_g, seen), counts, _ = run_path(
            torch, ops, lambda: zoo_forward_backward(
                torch, card, xt.cuda(), y.cuda(), mse))
        want = {**untapped(counts), **per_call}
        if counts != want:
            raise AssertionError(f"model_zoo {name}: launches {counts}, "
                                 f"expected {want}")
        held_standalone(f"model_zoo {name}", seen)
        with torch.backends.cudnn.flags(
                enabled=False, allow_tf32=False,
                benchmark=torch.backends.cudnn.benchmark,
                deterministic=torch.backends.cudnn.deterministic):
            res_n, seen_n = zoo_forward_backward(torch, card, xt.cuda(),
                                                 y.cuda(), mse)
        res_c, seen_c = zoo_forward_backward(torch, cpu_model, xt, y, mse)

        def grads_64(route=None):
            wide = copy.deepcopy(cpu_model).double()
            return zoo_forward_backward(torch, wide, xt.double(), y, mse,
                                        route)[0][2]

        g64_g, g64_c = grads_64(seen), grads_64(seen_c)
        g64_n = g64_g if seen_n.route_equal(seen) else grads_64(seen_n)
        g64 = grads_64()
        states = list(zip(res_g[3], res_c[3]))
        diff = {"loss": (res_g[1], res_c[1]), "loss_rel": 0.0,
                "param_abs": 0.0,
                "out_rel": leaf_rel(res_g[0][0], res_c[0][0]),
                "state_rel": max([leaf_rel(a, b) for a, b in states],
                                 default=0.0),
                **norm_rel(res_g[2], res_c[2], g64_g, g64_c)}
        plain = {**diff, "loss": (res_n[1], res_c[1]),
                 "out_rel": leaf_rel(res_n[0][0], res_c[0][0]),
                 **norm_rel(res_n[2], res_c[2], g64_n, g64_c)}
        t = zoo_ms(torch, card, xt.cuda(), y.cuda(), mse)
        print(f"model_zoo {name}: {n_params} params, batch {batch} of "
              f"{shape}, one forward and backward {t:.4f} ms; loss card "
              f"{res_g[1]:.8f} CPU {res_c[1]:.8f}; log-probs |card - CPU| "
              f"over max|CPU| {diff['out_rel']:.3e}; running statistics "
              f"{diff['state_rel']:.3e} (largest of a buffer); gradients "
              f"over the whole model: card - CPU "
              f"{diff['grad_norm_rel']:.3e}, from float64 under its own "
              f"routing card {diff['card_norm_64']:.3e} CPU "
              f"{diff['cpu_norm_64']:.3e}, card without cuDNN "
              f"{plain['card_norm_64']:.3e} (- CPU "
              f"{plain['grad_norm_rel']:.3e}); from float64 without the "
              f"routing card {model_rel(res_g[2], g64):.3e} CPU "
              f"{model_rel(res_c[2], g64):.3e} ({seen.flips(seen_c)}); "
              f"launches {ops_nonzero(counts)}")
        held_vs_cpu(f"model_zoo {name}", diff, scope="model")
        held_vs_cpu(f"model_zoo {name} without cuDNN", plain, scope="model")
        by_path[f"model_zoo_{name}"] = counts
        del card
        torch.cuda.empty_cache()
    return by_path


def autoencoder_run(torch, device, init, end_trigger, drop_last=False):
    """examples/train_autoencoder.py from ``init``: ``Autoencoder(32)``
    and ``MSECriterion`` through ``LocalOptimizer`` on records that
    ``FuncTransformer`` makes of mnist.synthetic(2048) (pixels / 255,
    flattened to 784, as the feature and the label); an optimizer ready
    to run.  ``drop_last`` drops each epoch's last partial batch (a
    chunk of n steps a dispatch stacks uniform batches)."""
    from bigdl_tpu_torch.models.autoencoder import Autoencoder
    from bigdl_tpu_torch.nn import MSECriterion
    from bigdl_tpu_torch.optim import LocalOptimizer
    from bigdl_tpu_torch.utils.table import T

    model = Autoencoder(AE_CLASSES, device=device).load_params(init)
    opt = LocalOptimizer(model, autoencoder_set(AE_BATCH, drop_last),
                         MSECriterion(), device=device)
    opt.set_state(T(learningRate=AE_LR, momentum=AE_MOMENTUM))
    if end_trigger is not None:
        opt.set_end_when(end_trigger)
    return opt


def autoencoder_set(batch, drop_last=False):
    from bigdl_tpu_torch.dataset import (DataSet, FuncTransformer, Sample,
                                         SampleToBatch, mnist)

    def to_sample(img):
        flat = (img.data / 255.0).astype(np.float32).reshape(-1)
        return Sample(flat, flat)

    return (DataSet.array(mnist.synthetic(AE_IMAGES))
            >> FuncTransformer(to_sample)
            >> SampleToBatch(batch, drop_last=drop_last))


def set_mse(torch, model):
    """The model's mean squared error over all AE_IMAGES training
    records, in evaluation mode."""
    dev = next(model.parameters()).device
    total, count = 0.0, 0
    with torch.no_grad():
        for b in autoencoder_set(512).data(train=False):
            x = torch.from_numpy(b.data).to(dev)
            total += float(((model(x) - x) ** 2).double().sum())
            count += x.numel()
    return total / count


def phase_autoencoder(torch, ops):
    """(a) of the inventory phase: the example on the card.  Returns the
    launch counts of its paths and the kernels the graph's replays ran."""
    from bigdl_tpu_torch.models.autoencoder import Autoencoder
    from bigdl_tpu_torch.nn.module import export_params
    from bigdl_tpu_torch.optim import max_epoch, max_iteration
    from bigdl_tpu_torch.utils.random import generator

    init = export_params(Autoencoder(AE_CLASSES, device="cpu",
                                     generator=generator(0)))
    by_path = {}
    opt = autoencoder_run(torch, "cuda", init, max_epoch(AE_EPOCHS))
    before = set_mse(torch, opt.model)
    _, counts, wall = run_path(torch, ops, opt.optimize)
    after = set_mse(torch, opt.model)
    per_epoch = -(-AE_IMAGES // AE_BATCH)
    steps = len(opt.loss_log)
    if steps != AE_EPOCHS * per_epoch:
        raise AssertionError(f"inventory Autoencoder: {steps} steps")
    want = {**untapped(counts), "fused_sgd": steps}
    if counts != want:
        raise AssertionError(f"inventory Autoencoder: launches {counts}, "
                             f"expected {want}")
    if not after < before:
        raise AssertionError(f"inventory Autoencoder: the training set's "
                             f"loss went {before} -> {after}")
    by_path["inventory_autoencoder"] = counts
    # one more epoch, warm: ms a step, then the same under the profiler
    opt.set_end_when(max_epoch(AE_EPOCHS + 1))
    _, warm_counts, warm_wall = run_path(torch, ops, opt.optimize)
    warm_ms = warm_wall / per_epoch * 1e3
    busy, ran = profiled_run(torch, opt, per_epoch)
    losses = [l for _, l in opt.loss_log]
    print(f"inventory Autoencoder: {AE_EPOCHS} epochs of {AE_IMAGES} "
          f"records at batch {AE_BATCH} ({steps} steps, "
          f"{sum(p.numel() for p in opt.model.parameters())} params), "
          f"{wall / steps * 1e3:.4f} ms/step cold; one more epoch warm "
          f"{warm_ms:.4f} ms/step, device {busy:.4f} ms/step busy, idle "
          f"share {1 - busy / warm_ms:.4f}; launches {ops_nonzero(counts)} "
          f"(warm epoch {ops_nonzero(warm_counts)}, the profiler's "
          f"kernels {ran}); loss over the training set {before:.8f} -> "
          f"{after:.8f}; step losses {losses[0]:.6f} -> {losses[-1]:.6f}")
    card = autoencoder_run(torch, "cuda", init,
                           max_iteration(AE_CHECK_STEPS))
    card.optimize()
    cpu = autoencoder_run(torch, "cpu", init, max_iteration(AE_CHECK_STEPS))
    cpu.optimize()
    held_to_cpu_run(torch, f"inventory Autoencoder {AE_CHECK_STEPS} steps",
                    card, cpu)
    graph_counts, graph_ran = dispatch_runs(
        torch, ops, "inventory Autoencoder",
        lambda dev, n, graph: graph_or_eager(autoencoder_run(
            torch, dev, init, None, drop_last=True), n, graph),
        HSTEPS, {"fused_sgd": 1})
    by_path["inventory_autoencoder_graph"] = graph_counts
    return by_path, {"inventory_autoencoder_graph": graph_ran}


def _input_leaves(x):
    return [v for e in x for v in _input_leaves(e)] if isinstance(x, list) else [x]


def _input_tables(x, it, table):
    if isinstance(x, list):
        return table(*[_input_tables(e, it, table) for e in x])
    return next(it)


def _output_leaves(y, table):
    return ([v for e in y for v in _output_leaves(e, table)]
            if isinstance(y, table) else [y])


def inventory_run(torch, module, x, device, g_seed=7):
    """One forward and backward of ``module`` on ``x`` (numpy leaves;
    lists are Tables) on ``device``: the outputs, the floating inputs'
    gradients and the parameters' gradients, on the host.  The backward
    takes sum(y * g) over the floating outputs, g seeded."""
    from bigdl_tpu_torch.utils.table import Table

    leaves = [torch.from_numpy(np.array(a)).to(device) for a in _input_leaves(x)]
    diff = [t.requires_grad_() for t in leaves if t.is_floating_point()]
    module.zero_grad(set_to_none=True)
    out = _output_leaves(module(_input_tables(x, iter(leaves), Table)), Table)
    rs = np.random.RandomState(g_seed)
    loss = None
    for o in out:
        if o.is_floating_point() and o.requires_grad:
            g = torch.from_numpy(np.asarray(rs.randn(*o.shape), np.float32))
            term = (o * g.to(device)).sum()
            loss = term if loss is None else loss + term
    if loss is not None:
        loss.backward()
    params = [p for p in module.parameters()]
    return ([o.detach().cpu() for o in out],
            [t.grad.cpu() if t.grad is not None else torch.zeros(t.shape)
             for t in diff],
            [p.grad.cpu() if p.grad is not None else torch.zeros(p.shape)
             for p in params])


def inventory_held(torch, name, card, cpu, tol):
    """Card against CPU, tensor by tensor: within ``tol`` element-wise;
    where a sum's order differs (``tol`` SUM_TOL) a tensor may instead be
    held as held_vs_cpu holds a leaf, its largest difference over its
    largest entry within RTOL.  Returns (largest |card - CPU| of the
    outputs, of the input gradients, of the parameter gradients, the rule
    that held)."""
    errs, rule = [], "element-wise"
    for part, (a_list, b_list) in zip(("out", "dx", "params"),
                                      zip(card, cpu)):
        worst = 0.0
        for a, b in zip(a_list, b_list):
            if a.shape != b.shape or a.dtype != b.dtype:
                raise AssertionError(f"inventory {name} {part}: {a.shape} "
                                     f"{a.dtype} on the card, {b.shape} "
                                     f"{b.dtype} on the CPU")
            if not a.is_floating_point():
                if not torch.equal(a, b):
                    raise AssertionError(f"inventory {name} {part}: the "
                                         f"card's differs")
                continue
            if a.numel() == 0:
                continue
            d = (a.double() - b.double()).abs()
            worst = max(worst, float(d.max()))
            if torch.allclose(a, b, **tol):
                continue
            if tol is SUM_TOL and leaf_rel(a, b.double()) <= RTOL:
                rule = "over the largest entry"
                continue
            raise AssertionError(f"inventory {name} {part}: |card - CPU| "
                                 f"{float(d.max()):.3e} beyond {tol}")
        errs.append(worst)
    return (*errs, rule)


def inventory_cases(torch):
    """(name, module on the CPU, input, tolerance): one forward and
    backward of each class this slice adds, at a width a real network
    uses."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.utils.random import generator

    g = generator(0)
    rs = np.random.RandomState(0)
    B, T_, D, C = INV_B, INV_T, INV_D, INV_CLASSES

    def randn(*shape):
        return rs.randn(*shape).astype(np.float32)

    def probs(*shape):
        return rs.uniform(0.05, 0.95, shape).astype(np.float32)

    def sign(*shape):
        return np.where(rs.rand(*shape) > 0.5, 1.0, -1.0).astype(np.float32)

    def classes(*shape):
        return rs.randint(1, C + 1, shape).astype(np.int64)

    def log_softmax(x):
        return np.asarray(torch.log_softmax(torch.from_numpy(x), -1))

    def crit(c):
        return nn.CriterionTable(c)

    cpu = dict(device="cpu", generator=g)
    x3, y3 = randn(B, T_, D), randn(B, T_, D)
    labels = np.zeros((B, C), np.int64)     # 1 to 5 labels a row
    for r in range(B):
        k = rs.randint(1, 6)
        labels[r, :k] = rs.choice(C, k, replace=False) + 1
    w_c = rs.uniform(0.5, 2.0, C).astype(np.float32)
    rois = np.stack([np.zeros(128), *(
        rs.uniform(0, 800, 128), rs.uniform(0, 600, 128))], 1)
    rois = np.concatenate([rois, rois[:, 1:] + rs.uniform(
        16, 400, (128, 2))], 1).astype(np.float32)
    rois[:, 3:] = np.minimum(rois[:, 3:], [799, 599])
    m = nn
    E, S = EXACT_TOL, SUM_TOL
    cases = [
        # containers
        ("ParallelTable", m.ParallelTable(m.Linear(D, 128, **cpu),
                                          m.Tanh()), [x3, y3],
         S),
        ("MapTable", m.MapTable(m.Linear(D, D, **cpu)),
         [x3, y3], S),
        ("Bottle", m.Bottle(m.Linear(D, 128, **cpu), 2, 2), x3, S),
        ("ConcatTable", m.Sequential(m.ConcatTable(m.Identity(),
                                                   m.Linear(D, D, **cpu)),
                                     m.CAddTable()), x3, S),
        # criteria at batch B over C classes
        ("MSECriterion", crit(m.MSECriterion()), [randn(B, C), randn(B, C)],
         S),
        ("AbsCriterion", crit(m.AbsCriterion()), [randn(B, C), randn(B, C)],
         S),
        ("BCECriterion", crit(m.BCECriterion(w_c)),
         [probs(B, C), (rs.rand(B, C) > 0.5).astype(np.float32)], S),
        ("DistKLDivCriterion", crit(m.DistKLDivCriterion()),
         [log_softmax(randn(B, C)), probs(B, C)], S),
        ("ClassSimplexCriterion", crit(m.ClassSimplexCriterion(C)),
         [randn(B, C), classes(B)], S),
        ("CosineEmbeddingCriterion", crit(m.CosineEmbeddingCriterion(0.0)),
         [[randn(B, C), randn(B, C)], sign(B)], S),
        ("HingeEmbeddingCriterion", crit(m.HingeEmbeddingCriterion(1.0)),
         [randn(B, C), sign(B, C)], S),
        ("L1HingeEmbeddingCriterion",
         crit(m.L1HingeEmbeddingCriterion(1130.0)),
         [[randn(B, C), randn(B, C)], sign(B)], S),
        ("MarginCriterion", crit(m.MarginCriterion()),
         [randn(B, C), sign(B, C)], S),
        ("MarginRankingCriterion", crit(m.MarginRankingCriterion(0.5)),
         [[randn(B), randn(B)], sign(B)], S),
        ("MultiCriterion", crit(m.MultiCriterion().add(
            m.MSECriterion(), 0.3).add(m.SmoothL1Criterion(), 0.7)),
         [randn(B, C), randn(B, C)], S),
        ("ParallelCriterion", crit(m.ParallelCriterion().add(
            m.MSECriterion(), 0.5).add(m.ClassNLLCriterion(), 1.0)),
         [[randn(B, C), log_softmax(randn(B, C))],
          [randn(B, C), classes(B)]], S),
        ("MultiLabelMarginCriterion", crit(m.MultiLabelMarginCriterion()),
         [randn(B, C), labels], S),
        ("MultiLabelSoftMarginCriterion",
         crit(m.MultiLabelSoftMarginCriterion(w_c)),
         [randn(B, C) * 3, (rs.rand(B, C) > 0.5).astype(np.float32)], S),
        ("MultiMarginCriterion", crit(m.MultiMarginCriterion(2, w_c)),
         [randn(B, C), classes(B)], S),
        ("SmoothL1Criterion", crit(m.SmoothL1Criterion()),
         [randn(B, C) * 2, randn(B, C)], S),
        ("SmoothL1CriterionWithWeights",
         crit(m.SmoothL1CriterionWithWeights(3.0)),
         [randn(B, C), [randn(B, C), probs(B, C), probs(B, C)]], S),
        ("SoftMarginCriterion", crit(m.SoftMarginCriterion()),
         [randn(B, C) * 3, sign(B, C)], S),
        ("SoftmaxWithCriterion", crit(m.SoftmaxWithCriterion(C + 255)),
         [randn(B, C), np.where(rs.rand(B) > 0.9, C + 255, classes(B))], S),
        ("L1Cost", crit(m.L1Cost()), [randn(B, C), randn(B, C)], S),
        # linear.py
        ("Bilinear", m.Bilinear(D, D, 128, **cpu), [randn(B, D),
                                                    randn(B, D)], S),
        ("CMul", m.CMul((1, 1, D), **cpu), x3, S),
        ("CAdd", m.CAdd((1, 1, D), **cpu), x3, S),
        ("Mul", m.Mul(**cpu), x3, S),
        ("Add", m.Add(D, **cpu), x3, S),
        ("AddConstant", m.AddConstant(0.5), x3, E),
        ("MM", m.MM(False, True), [x3, y3], S),
        ("MV", m.MV(), [x3, randn(B, D)], S),
        ("Cosine", m.Cosine(D, C, **cpu), randn(B, D), S),
        ("Euclidean", m.Euclidean(D, 100, **cpu), randn(B, D), S),
        ("LookupTable", m.LookupTable(20000, 200, **cpu),
         rs.randint(1, 20001, (B, T_)), S),
        ("LookupTable max_norm", m.LookupTable(20000, 200, max_norm=1.0,
                                               **cpu),
         rs.randint(1, 20001, (B, T_)), S),
        # table_ops.py at (B, T, D)
        ("CSubTable", m.CSubTable(), [x3, y3], E),
        ("CMulTable", m.CMulTable(), [x3, y3], E),
        ("CDivTable", m.CDivTable(), [x3, np.abs(y3) + 0.5], E),
        ("CMaxTable", m.CMaxTable(), [x3, y3], E),
        ("CMinTable", m.CMinTable(), [x3, y3], E),
        ("JoinTable", m.JoinTable(1, 2), [x3, randn(B, 12, D)], E),
        ("SelectTable", m.SelectTable(-1), [x3, y3], E),
        ("NarrowTable", m.NarrowTable(2, 2),
         [randn(B, 7), x3, y3], E),
        ("FlattenTable", m.FlattenTable(), [x3, [randn(B, 7),
                                                 [y3]]], E),
        ("MixtureTable", m.MixtureTable(),
         [probs(B, 4), [x3, y3, x3[:, ::-1].copy(), y3[:, ::-1].copy()]],
         S),
        ("DotProduct", m.DotProduct(), [x3, y3], S),
        ("PairwiseDistance", m.PairwiseDistance(), [x3, y3], S),
        ("CosineDistance", m.CosineDistance(), [x3, y3], S),
        ("CriterionTable", crit(m.MSECriterion()), [x3, y3], S),
        # shape_ops.py
        ("InferReshape", m.InferReshape((0, -1, D // 2)), x3, E),
        ("Transpose", m.Transpose([(2, 3), (1, 2)]), x3, E),
        ("Replicate", m.Replicate(3, 2), x3, S),
        ("Squeeze", m.Squeeze(4), x3[..., None], E),
        ("Unsqueeze", m.Unsqueeze(2), x3, E),
        ("Padding", m.Padding(2, -3, 2, 0.5), x3, E),
        ("SpatialZeroPadding", m.SpatialZeroPadding(2, -1, 1, -2),
         x3.reshape(B, T_, 16, D // 16), E),
        ("Contiguous", m.Sequential(m.Transpose([(2, 3)]), m.Contiguous()),
         x3, E),
        ("Copy", m.Copy(), x3, E),
        ("Echo", m.Echo(), x3, E),
        # reductions.py
        ("Sum", m.Sum(2), x3, S),
        ("Max", m.Max(3), x3, E),
        ("Min", m.Min(2), x3, E),
        ("Index", m.Index(2), [x3, rs.randint(1, T_ + 1, 64)], S),
        ("Select", m.Select(2, -7), x3, E),
        ("Narrow", m.Narrow(3, 10, -20), x3, E),
        ("MaskedSelect", m.MaskedSelect(),
         [x3, (rs.rand(B, T_, D) > 0.5).astype(np.uint8)], E),
        # dropout.py
        ("L1Penalty", m.L1Penalty(0.01, True), x3, E),
        # conv.py: DCGAN's generator layer, FCN's bilinear upsampling,
        # a DeepLab-v2 ASPP branch, LeNet-5's C3 table, a ResNet 3x3
        ("SpatialFullConvolution", m.SpatialFullConvolution(
            512, 256, 4, 4, 2, 2, 1, 1, **cpu), randn(64, 512, 8, 8), S),
        ("SpatialFullConvolution adj groups", m.SpatialFullConvolution(
            16, 8, 3, 3, 2, 2, 1, 1, 1, 1, 2, **cpu), randn(8, 16, 9, 9),
         S),
        ("SpatialFullConvolution BilinearFiller", m.SpatialFullConvolution(
            21, 21, 4, 4, 2, 2, 1, 1, n_group=21,
            init_method=m.BilinearFiller, **cpu), randn(4, 21, 16, 16), S),
        ("SpatialDilatedConvolution", m.SpatialDilatedConvolution(
            512, 512, 3, 3, 1, 1, 12, 12, 12, 12, **cpu),
         randn(4, 512, 33, 33), S),
        ("SpatialConvolutionMap", m.SpatialConvolutionMap(
            m.SpatialConvolutionMap.random(6, 16, 3, rs), 5, 5, **cpu),
         randn(B, 6, 14, 14), S),
        ("SpatialShareConvolution", m.SpatialShareConvolution(
            64, 64, 3, 3, 1, 1, 1, 1, **cpu), randn(32, 64, 56, 56), S),
        # normalization.py (Torch's local normalisation of 3-channel
        # 32x32 images, a 9x9 gaussian)
        ("SpatialSubtractiveNormalization",
         m.SpatialSubtractiveNormalization(3), randn(B, 3, 32, 32), S),
        ("SpatialDivisiveNormalization",
         m.SpatialDivisiveNormalization(3), randn(B, 3, 32, 32), S),
        ("SpatialContrastiveNormalization",
         m.SpatialContrastiveNormalization(3), randn(B, 3, 32, 32), S),
        # pooling.py: Fast R-CNN's VGG-16 conv5_3 (a 600x800 image)
        ("RoiPooling", m.RoiPooling(7, 7, 1.0 / 16),
         [randn(1, 512, 38, 50), rois], S),
    ]
    return cases


def phase_inventory_classes(torch, ops):
    """(b) of the inventory phase: one forward and backward of every class
    this slice adds on the card against the same module on the CPU from
    the same parameters; the NMS functions on 6,000 proposals.  None of
    them launches a kernel of the port."""
    import copy

    from bigdl_tpu_torch import nn

    def run():
        done = []
        for name, module, x, tol in inventory_cases(torch):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            card = inventory_run(torch, copy.deepcopy(module).cuda(), x,
                                 "cuda")
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            t0 = time.perf_counter()
            cpu = inventory_run(torch, module, x, "cpu")
            cpu_s = time.perf_counter() - t0
            e_out, e_dx, e_p, rule = inventory_held(torch, name, card, cpu,
                                                    tol)
            tol_name = "exact" if tol is EXACT_TOL else "sum"
            print(f"inventory {name}: max |card - CPU| out {e_out:.3e} dx "
                  f"{e_dx:.3e} params {e_p:.3e} (tolerance {tol_name} "
                  f"{tol}, held {rule}); card peak {peak / 2**20:.1f} MiB; "
                  f"CPU {cpu_s:.2f} s")
            done.append(type(module).__name__ if not isinstance(
                module, nn.CriterionTable) else type(
                    module.criterion).__name__)
            del card, cpu
        rs = np.random.RandomState(1)
        n = 6000
        xy = rs.uniform(0, 800, (n, 2))
        boxes = np.concatenate([xy, xy + rs.uniform(16, 300, (n, 2))],
                               1).astype(np.float32)
        scores = rs.rand(n).astype(np.float32)
        bc, sc = torch.from_numpy(boxes), torch.from_numpy(scores)
        t0 = time.perf_counter()
        keep_card = nn.nms_mask(bc.cuda(), sc.cuda(), 0.7)
        torch.cuda.synchronize()
        card_ms = (time.perf_counter() - t0) * 1e3
        keep_cpu = nn.nms_mask(bc, sc, 0.7)
        idx_card = nn.nms_indices(bc.cuda(), sc.cuda(), 0.7).cpu()
        idx_cpu = nn.Nms(0.7)(bc, sc)
        if not (torch.equal(keep_card.cpu(), keep_cpu)
                and torch.equal(idx_card, idx_cpu)):
            raise AssertionError("inventory nms: the card's keep set "
                                 "differs from the CPU's")
        print(f"inventory nms_mask / nms_indices / Nms: {n} proposals at "
              f"IoU 0.7, {int(keep_cpu.sum())} kept, the same on the card "
              f"({card_ms:.2f} ms wall) and the CPU")
        done += ["Nms"]
        return done

    done, counts, _ = run_path(torch, ops, run)
    if ops_nonzero(counts):
        raise AssertionError(f"inventory classes: launches {counts}")
    return done


def phase_inventory(torch, ops):
    """The inventory: (a) examples/train_autoencoder.py on the card, (b)
    every class this slice adds against the CPU."""
    by_path, graph_ran = phase_autoencoder(torch, ops)
    done = phase_inventory_classes(torch, ops)
    print(f"inventory: {len(set(done))} classes ({len(done)} cases) held "
          f"card against CPU")
    return by_path, graph_ran


# the data-parallel slice: examples/train_inception.py --synthetic through
# Optimizer(...) on a sharded dataset, a DistriOptimizer over one NCCL rank
# a card: DSTEPS steps a mode at batch IBATCH a rank, the collectives'
# device time profiled over DPROFILE_STEPS steps after two warm ones; at
# two or more cards the plain run also takes ICHECK_STEPS steps beside
# LocalOptimizer at the global batch
DSTEPS, DPROFILE_STEPS = 20, 5
DMODES = {"plain": {}, "zero1": {"zero1": True},
          "bf16": {"gradient_compression": "bf16"}}
# bf16 against LocalOptimizer: the JAX test's bound
# (tests/test_distributed.py:186-188)
BF16_TOL = dict(rtol=2e-2, atol=2e-3)


def is_nccl_kernel(name):
    return "nccl" in name.lower()


def inception_step_counts(steps):
    """The kernels an Inception-v1 training step launches, ``steps``
    times (no validation)."""
    return {"fused_sgd": steps, "lrn_forward": 2 * steps,
            "lrn_backward": 2 * steps, "maxpool2d_s1_forward": 9 * steps,
            "maxpool2d_s1_backward": 9 * steps,
            "maxpool2d_forward": 4 * steps, "maxpool2d_backward": 4 * steps}


def distri_inputs():
    """Inception-v1's initial parameters (seed 0) and the example's
    synthetic images."""
    from bigdl_tpu_torch.models.inception import Inception_v1
    from bigdl_tpu_torch.nn.module import export_params
    from bigdl_tpu_torch.utils.random import generator

    return (export_params(Inception_v1(ICLASSES, device="cpu",
                                       generator=generator(0))),
            inception_images(IMAGES, ISIZE, 0))


def distri_inception(torch, mode, steps, profile_n=0, batch=IBATCH,
                     inputs=None, grads=False):
    """This rank's Inception-v1 run through ``Optimizer(...)`` on the
    example's sharded dataset (dropout 0), from ``inputs``
    (``distri_inputs``): its losses, parameters, launch counts, ms a
    step, peak memory, with ``grads`` the last step's gradients as the
    update read them, and with ``profile_n`` the device time of the NCCL
    kernels and of every kernel over ``profile_n`` steps after two warm
    ones, beside that window's wall time."""
    from torch.profiler import ProfilerActivity, profile

    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.optim import DistriOptimizer, max_iteration
    from bigdl_tpu_torch.utils.random import RNG

    init, images = inputs if inputs is not None else distri_inputs()
    kw = {} if mode == "local" else dict(distributed=True, **DMODES[mode])

    def make(end):
        RNG.set_seed(0)
        return inception_run(torch, "cuda", init, images, batch, end,
                             dropout=0.0, **kw)

    opt = make(max_iteration(steps))
    if mode != "local" and not isinstance(opt, DistriOptimizer):
        raise AssertionError(f"Optimizer gave {type(opt).__name__} for the "
                             f"sharded dataset")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    opt.optimize()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = {"type": type(opt).__name__, "counts": ops.launch_counts(),
           "losses": [l for _, l in opt.loss_log],
           "params": _params(torch, opt.model),
           "step_ms": wall / steps * 1e3,
           "mem": torch.cuda.max_memory_allocated(),
           "world": getattr(getattr(opt, "mesh", None), "size", 1)}
    if grads:
        out["grads"] = torch.cat([p.grad.detach().reshape(-1).cpu()
                                  for p in opt.model.parameters()])
    fetch_s, fetches = opt.metrics.get("data fetch time")
    out["fetch_ms"] = fetch_s / max(fetches, 1) * 1e3
    if mode != "local" and profile_n:
        out["aligned_ms"], out["wire_bytes"] = aligned_collectives_ms(
            torch, opt)
    agg_s, aggs = opt.metrics.get("aggregate gradient time")
    out["aggregate_ms"] = agg_s / max(aggs, 1) * 1e3
    if profile_n:
        prof_opt = make(max_iteration(2))
        prof_opt.optimize()
        prof_opt.set_end_when(max_iteration(2 + profile_n))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            prof_opt.optimize()
            torch.cuda.synchronize()
            window = time.perf_counter() - t0
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        # busy and wall over one window: the profiled call's profile_n
        # steps and its set-up, the profiler on
        out["busy_ms"] = sum(e.device_time_total for e in rows) / 1e3 \
            / profile_n
        out["window_ms"] = window / profile_n * 1e3
        out["profiled"] = profile_n
        nccl = [(e.key, e.device_time_total / 1e3 / profile_n,
                 e.count / profile_n) for e in rows if is_nccl_kernel(e.key)]
        # NCCL's kernels, and the ``nccl:<op>`` spans the profiler lays
        # on the device timeline over each collective (the only rows of
        # a one-rank collective that copies without an NCCL kernel)
        out["nccl"] = [r for r in nccl if not r[0].startswith("nccl:")]
        out["nccl_ops"] = [r for r in nccl if r[0].startswith("nccl:")]
    return out


def aligned_collectives_ms(torch, opt, reps=10):
    """The gradient collectives of ``opt``'s step alone
    (``DistriOptimizer.gradient_collectives``, the mode's wire), the
    ranks aligned by a barrier and a synchronise before each call:
    (median device ms a call by CUDA events, bytes the rank's gradient
    puts on the wire).  Run after training: it overwrites the flat
    gradient buffers."""
    import torch.distributed as dist

    opt.gradient_collectives()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        dist.barrier(group=opt.mesh.group)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        opt.gradient_collectives()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), opt.wire_bytes


def distri_child(mode, steps, profile_n, batch):
    """One NCCL rank of a multi-card run (``parallel.launch``)."""
    import torch

    from bigdl_tpu_torch.utils.device import pin_fp32

    pin_fp32(torch.device("cuda"))
    out = distri_inception(torch, mode, steps, profile_n, batch)
    if torch.distributed.get_rank() != 0:
        out.pop("params")
    return out


class _FixedBatches:
    """Given host batches in order (LocalOptimizer's reference for a
    multi-card run: each step's global batch of the ranks' shards)."""

    def __init__(self, batches, size):
        self._batches, self._size = batches, size

    def size(self):
        return self._size

    def shuffle(self):
        return self

    def data(self, train):
        return iter(self._batches)


def distri_local_reference(torch, g, steps):
    """LocalOptimizer on the global batches of a ``g``-rank run: each
    step the ranks' local batches of IBATCH, stacked in rank order, each
    drawn as that rank's ShardedDataSet draws it."""
    from bigdl_tpu_torch.dataset import (HFlip, ImgNormalizer, ImgRdmCropper,
                                         ImgToBatch, ShardedDataSet)
    from bigdl_tpu_torch.dataset.sample import MiniBatch
    from bigdl_tpu_torch.models.inception import Inception_v1
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.nn.module import export_params
    from bigdl_tpu_torch.optim import LocalOptimizer, Poly, max_iteration
    from bigdl_tpu_torch.utils.random import RNG, generator
    from bigdl_tpu_torch.utils.table import T

    init = export_params(Inception_v1(ICLASSES, device="cpu",
                                      generator=generator(0)))
    images = inception_images(IMAGES, ISIZE, 0)
    norm = ImgNormalizer((123.0, 117.0, 104.0), (1.0, 1.0, 1.0))
    its = [iter((ShardedDataSet(images, g, r) >> ImgRdmCropper(ICROP, ICROP)
                 >> HFlip() >> norm >> ImgToBatch(IBATCH)).data(train=True))
           for r in range(g)]
    batches = []
    for _ in range(steps):
        parts = [next(it) for it in its]
        batches.append(MiniBatch(np.concatenate([p.data for p in parts]),
                                 np.concatenate([p.labels for p in parts])))
    RNG.set_seed(0)
    model = set_dropout(Inception_v1(ICLASSES, device="cuda")
                        .load_params(init), 0.0)
    opt = LocalOptimizer(model, _FixedBatches(batches, IMAGES),
                         ClassNLLCriterion(), device="cuda")
    opt.set_state(T(learningRate=ILR, weightDecay=IWD, momentum=0.9,
                    dampening=0.0, learningRateSchedule=Poly(0.5, ISTEPS)))
    opt.set_end_when(max_iteration(steps)).optimize()
    return [l for _, l in opt.loss_log], _params(torch, model)


def held_bits(torch, label, got, want, tol=None):
    """A data-parallel run against LocalOptimizer's: bits, or with
    ``tol`` within it (losses rtol, params rtol / atol)."""
    lg, lw = np.asarray(got["losses"]), np.asarray(want["losses"])
    if len(lg) != len(lw) or len(lg) == 0:
        raise AssertionError(f"{label}: {len(lg)} and {len(lw)} losses")
    if tol is None:
        if not (np.array_equal(lg, lw)
                and torch.equal(got["params"], want["params"])):
            rel = float(np.max(np.abs(lg - lw) / np.abs(lw)))
            p_abs = float((got["params"] - want["params"]).abs().max())
            raise AssertionError(f"{label}: not LocalOptimizer's bits "
                                 f"(losses {rel:.3e} relative apart, params "
                                 f"{p_abs:.3e})")
        return "bit for bit"
    rel = float(np.max(np.abs(lg - lw) / np.abs(lw)))
    diff = (got["params"].double() - want["params"].double()).abs()
    over = diff - tol["rtol"] * want["params"].double().abs()
    worst = float(over.max())
    if rel > tol["rtol"] or worst > tol["atol"]:
        raise AssertionError(f"{label}: losses {rel:.3e} relative apart, "
                             f"params {float(diff.max()):.3e} (past rtol "
                             f"{tol['rtol']} by {worst:.3e}, atol "
                             f"{tol['atol']})")
    return (f"within rtol {tol['rtol']} / atol {tol['atol']} (losses "
            f"{rel:.3e} relative apart, params {float(diff.max()):.3e})")


def phase_distri(torch, ops, profile: bool):
    """The data-parallel slice: Inception-v1 as examples/train_inception.py
    --synthetic builds it, through ``Optimizer(...)`` on the sharded
    dataset, a ``DistriOptimizer`` over one NCCL rank a card, DSTEPS steps
    each plain, ``zero1`` and bf16; with one card, plain and ``zero1``
    equal LocalOptimizer bit for bit (deterministic algorithms, dropout
    0) and bf16 is within the JAX test's bound; with more, the plain run
    equals LocalOptimizer at the global batch; the collectives' device ms
    a step under the profiler; then LeNet-5 as examples/train_lenet.py
    --distributed, two epochs, Top1 rising."""
    from bigdl_tpu_torch.models.lenet import LeNet5
    from bigdl_tpu_torch.nn.module import export_params
    from bigdl_tpu_torch.optim import DistriOptimizer, max_epoch
    from bigdl_tpu_torch.parallel.launch import launch
    from bigdl_tpu_torch.utils.engine import Engine
    from bigdl_tpu_torch.utils.random import generator

    smi = smi_line()
    g = torch.cuda.device_count()
    print(f"distri: world {g} ({g} NCCL rank(s), one a card); a multi-rank "
          f"run on the card: {'yes' if g > 1 else 'no'}; [{smi}]")
    runs, by_path = {}, {}
    want = {**untapped(ops.launch_counts()),
            **inception_step_counts(DSTEPS)}
    try:
        if g == 1:
            inputs = distri_inputs()
            with deterministic(torch):
                # warm-up: cuDNN's choices, the NCCL communicator
                for mode in ("local", "plain"):
                    distri_inception(torch, mode, 2, inputs=inputs)
                for mode in ("local", "plain", "zero1", "bf16"):
                    runs[mode] = distri_inception(
                        torch, mode, DSTEPS, (READ["train_profiled"]
                                              or DPROFILE_STEPS)
                        if mode != "local" else 0, inputs=inputs)
                # the bf16 wire against LocalOptimizer: one step's reduced
                # gradient, and ICHECK_STEPS steps (the JAX test's horizon
                # is 4); over DSTEPS the trajectory at lr 0.0898 amplifies
                # the rounding (printed below, not held)
                one = {m: distri_inception(torch, m, 1, inputs=inputs,
                                           grads=True)
                       for m in ("local", "bf16")}
                short = {m: distri_inception(torch, m, ICHECK_STEPS,
                                             inputs=inputs)
                         for m in ("local", "bf16")}
            wire = one["local"]["grads"].bfloat16().float()
            if not torch.equal(one["bf16"]["grads"], wire):
                bad = int((one["bf16"]["grads"] != wire).sum())
                raise AssertionError(f"distri bf16: the reduced gradient is "
                                     f"not LocalOptimizer's rounded to bf16 "
                                     f"({bad} of {wire.numel()} differ)")
            held = held_bits(torch, f"distri bf16, {ICHECK_STEPS} steps",
                             short["bf16"], short["local"], BF16_TOL)
            print(f"distri bf16: one step's reduced gradient is "
                  f"LocalOptimizer's rounded to bf16, bit for bit "
                  f"({wire.numel()} values); {ICHECK_STEPS} steps against "
                  f"LocalOptimizer {held}; [{smi}]")
        else:
            for mode in ("plain", "zero1", "bf16"):
                runs[mode] = launch(distri_child, g, "nccl", args=(
                    mode, DSTEPS, DPROFILE_STEPS, IBATCH))[0]
            runs["local"] = distri_inception(torch, "local", DSTEPS,
                                             batch=IBATCH * g)
        local = runs["local"]
        print(f"distri: LocalOptimizer Inception-v1, batch {IBATCH * g}, "
              f"{DSTEPS} steps: {local['step_ms']:.4f} ms/step, "
              f"max_memory_allocated {local['mem']} B; losses "
              f"{local['losses'][0]:.6f} -> {local['losses'][-1]:.6f}; "
              f"[{smi}]")
        for mode in DMODES:
            run = runs[mode]
            if run["type"] != "DistriOptimizer" or run["world"] != g:
                raise AssertionError(f"distri {mode}: {run['type']} over "
                                     f"{run['world']} ranks")
            if run["counts"] != {**want, "fused_sgd_taps":
                                 run["counts"].get("fused_sgd_taps", 0)}:
                raise AssertionError(f"distri {mode}: launches "
                                     f"{ops_nonzero(run['counts'])}, "
                                     f"expected {ops_nonzero(want)}")
            by_path[f"distri_inception_{mode}"] = run["counts"]
            if g == 1 and mode != "bf16":
                held = held_bits(torch, f"distri {mode}", run, local)
            elif g == 1:
                lw = np.asarray(local["losses"])
                rel = float(np.max(np.abs(np.asarray(run["losses"]) - lw)
                                   / np.abs(lw)))
                p_abs = float((run["params"] - local["params"]).abs().max())
                held = (f"over {ICHECK_STEPS} steps (above); after "
                        f"{DSTEPS}, losses {rel:.3e} relative apart, params "
                        f"{p_abs:.3e} (not held)")
            else:
                held = "held below" if mode == "plain" else "not held"
            nccl = ", ".join(f"{name[:70]} {ms:.4f} ms ({n:.1f}/step)"
                             for name, ms, n in run["nccl"]) or \
                "no NCCL kernel ran"
            spans = ", ".join(f"{name} {ms:.4f} ms ({n:.1f}/step)"
                              for name, ms, n in run["nccl_ops"]) or "none"
            idle = 1 - run["busy_ms"] / run["window_ms"]
            print(f"distri {mode}: DistriOptimizer Inception-v1, world {g}, "
                  f"batch {IBATCH} a rank, {DSTEPS} steps: "
                  f"{run['step_ms']:.4f} ms/step (LocalOptimizer "
                  f"{local['step_ms']:.4f}), {IBATCH * g / run['step_ms'] * 1e3:.1f}"
                  f" images/s, host fetch {run['fetch_ms']:.4f} ms/step, "
                  f"collective enqueue {run['aggregate_ms']:.4f} ms/step, "
                  f"max_memory_allocated {run['mem']} B (LocalOptimizer "
                  f"{local['mem']}); the step's collectives alone, the "
                  f"ranks aligned: {run['aligned_ms']:.4f} ms a step "
                  f"({run['wire_bytes']} B of gradient on the wire, "
                  f"{run['wire_bytes'] / run['aligned_ms'] / 1e6:.2f} GB/s);"
                  f" NCCL kernels' device time a step: "
                  f"{sum(ms for _, ms, _ in run['nccl']):.4f} ms ({nccl}; "
                  f"the collectives' spans on the device timeline: "
                  f"{spans}); "
                  f"profiled over {run['profiled']} steps: wall "
                  f"{run['window_ms']:.4f} ms/step, device busy "
                  f"{run['busy_ms']:.4f} ms/step, idle share "
                  f"{idle:.4f}; launches {ops_nonzero(run['counts'])}; "
                  f"losses {run['losses'][0]:.6f} -> "
                  f"{run['losses'][-1]:.6f}; held against LocalOptimizer "
                  f"{held}; [{smi}]")
        if g > 1:
            check = launch(distri_child, g, "nccl", args=(
                "plain", ICHECK_STEPS, 0, IBATCH))[0]
            losses, params = distri_local_reference(torch, g, ICHECK_STEPS)
            held = held_bits(torch, "distri plain vs LocalOptimizer", check,
                             {"losses": losses, "params": params},
                             dict(rtol=LOSS_RTOL, atol=IPARAM_ATOL))
            print(f"distri plain, world {g}: {ICHECK_STEPS} steps against "
                  f"LocalOptimizer at batch {IBATCH * g} on the same global "
                  f"batches: {held}; [{smi}]")

        # LeNet-5 as examples/train_lenet.py --distributed, held to the
        # LocalOptimizer run of the same records (in this process: a
        # world of one)
        init = export_params(LeNet5(10, device="cuda",
                                    generator=generator(0)))
        with deterministic(torch):
            local = lenet_run(torch, "cuda", init, max_epoch(EPOCHS))
            local.optimize()
            opt = lenet_run(torch, "cuda", init, max_epoch(EPOCHS),
                            distributed=True)
            if not isinstance(opt, DistriOptimizer):
                raise AssertionError(f"LeNet-5: Optimizer gave "
                                     f"{type(opt).__name__}")
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            opt.optimize()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        held = held_same(torch, "distri LeNet-5 vs LocalOptimizer", opt,
                         local, dict(rtol=RTOL, atol=ATOL))
        steps = int(opt.state["neval"]) - 1
        w = opt.mesh.size   # this process's world: one rank
        # each rank validates every w-th batch of a validation
        val_batches = len(opt.validation_log) * -(-(-(-N_VAL // BATCH))
                                                   // w)
        lenet_want = {**untapped(counts), "fused_sgd": steps,
                      "maxpool2d_backward": 2 * steps,
                      "maxpool2d_forward": 2 * steps + 2 * val_batches}
        top1 = [v["Top1Accuracy"] for _, _, v in opt.validation_log]
        if steps != EPOCHS * N_TRAIN // (BATCH * w) or counts != lenet_want:
            raise AssertionError(f"distri LeNet-5: launches {counts} after "
                                 f"{steps} steps, expected {lenet_want}")
        if not top1[-1] > top1[0]:
            raise AssertionError(f"distri LeNet-5: Top1 {top1} did not rise")
        by_path["distri_lenet"] = counts
        print(f"distri LeNet-5: examples/train_lenet.py --distributed, world "
              f"{w}, {steps} steps of {BATCH} a rank over {EPOCHS} epochs, "
              f"{len(top1)} validations: wall {wall:.4f} s; launches "
              f"{ops_nonzero(counts)}; Top1 {top1[0]:.4f} -> {top1[-1]:.4f} "
              f"(uniform-noise digits, random labels: chance is 0.1); held "
              f"against LocalOptimizer on the same records by {held}; "
              f"[{smi}]")
    finally:
        Engine.reset()
    return by_path, {}


# -- the attention family's training -------------------------------------

# examples/train_transformer.py at bench.py's width (bench.py:338-353):
# TransformerClassifier(20 classes, d_model 1024, 4 heads, 6 layers,
# hidden 4096) at batch 16 x T 512 of synthetic embedded documents, SGD
# lr 0.01, Top1 every epoch; A_DOCS documents (the example's 2,048 take
# 4.3 GB), 0.8 of them for training: A_STEPS steps, one epoch
A_CLASSES, A_T, A_BATCH, A_LR = 20, 512, 16, 0.01
A_DOCS, A_STEPS, A_PROFILE = 400, 20, 3
A_PARAMS, A_MOE_PARAMS, A_EXPERTS, A_MOE_STEPS = 75599892, 428185620, 8, 6
# the operations of one step as the JAX round's record counts them
# (BENCH_r05.json, "Transformer-enc bs16 T512 d1024")
A_JAX_OPS = 4033624145920
# each path against the CPU at depth A_CHECK_LAYERS, batch A_CHECK_BATCH,
# A_CHECK_STEPS steps, dropout 0 (the full depth takes minutes there)
A_CHECK_LAYERS, A_CHECK_BATCH, A_CHECK_STEPS = 1, 4, 2
# the world-of-one sequence- and expert-parallel runs against
# LocalOptimizer: A_ONE_STEPS steps at depth A_ONE_LAYERS
A_ONE_LAYERS, A_ONE_STEPS = 2, 3
# TransformerLM at the serving model's width, batch L_BATCH x T L_T on the
# built-in corpus, L_STEPS steps through LocalOptimizer, then lm_decode
L_BATCH, L_T, L_STEPS, L_LR, L_WORDS = 16, 128, 8, 0.1, 32
# examples/train_rnn.py's built-in corpus (examples/train_transformer_lm.py
# trains on it when no file is given)
L_CORPUS = """the quick brown fox jumps over the lazy dog
a stitch in time saves nine
all that glitters is not gold
actions speak louder than words
practice makes perfect every single day
the early bird catches the worm
better late than never they say
birds of a feather flock together"""
# the ring's per-hop step in one process over RING_BLOCKS blocks at the
# flagship's attention shape (B, T, H, hd)
RING_SHAPE, RING_BLOCKS = (A_BATCH, A_T, HEADS, D_MODEL // HEADS), 4
RING_TOL = dict(rtol=1e-4, atol=1e-5)       # tests/test_attention_sp.py:39
RING_GRAD_TOL = dict(rtol=1e-3, atol=1e-3)  # tests/test_attention_sp.py:52


def classifier_ops(batch, t, d, heads, layers, hidden, classes, experts=0,
                   capacity=0):
    """The multiply-adds x 2 of one training step's matrix products
    (forward, and the backward's two products each), from the shapes:
    the projections, the FFN (or each expert's at its capacity), the
    attention's two (T, T) products, the head."""
    n = batch * t
    ffn = (2 * 2 * experts * capacity * d * hidden if experts
           else 2 * 2 * n * d * hidden)
    attn = 2 * 2 * batch * t * t * d
    layer = 4 * 2 * n * d * d + ffn + attn
    return 3 * (layers * layer + 2 * batch * d * classes)


def attention_docs(n, seed=0):
    """examples/train_transformer.py:74-82's synthetic embedded documents:
    (T, d) noise at 0.5 about one of 20 class means; the records, the
    first 0.8 for training."""
    rs = np.random.default_rng(seed)
    means = rs.standard_normal((A_CLASSES, D_MODEL), dtype=np.float32)
    docs = rs.standard_normal((n, A_T, D_MODEL), dtype=np.float32)
    docs *= 0.5
    docs += means[np.arange(n) % A_CLASSES][:, None]
    from bigdl_tpu_torch.dataset import Sample

    samples = [Sample(docs[i], np.asarray([float(i % A_CLASSES + 1)],
                                          np.float32)) for i in range(n)]
    split = int(n * 0.8)
    return samples[:split], samples[split:]


def classifier_model(device, layers=None, experts=0, generator=None):
    from bigdl_tpu_torch.models.transformer import TransformerClassifier

    return TransformerClassifier(A_CLASSES, d_model=D_MODEL, n_heads=HEADS,
                                 n_layers=layers or LAYERS, hidden=HIDDEN,
                                 moe_experts=experts, device=device,
                                 generator=generator)


def classifier_run(torch, device, init, train, batch, end_trigger,
                   layers=None, experts=0, val=None, dropout=None,
                   distri=None):
    """examples/train_transformer.py's optimizer from ``init``: SGD at
    lr 0.01, Top1 every epoch on ``val``; ``distri``, the keyword
    arguments of a ``DistriOptimizer`` (a mesh and its mode) in place
    of ``Optimizer(...)``'s ``LocalOptimizer``."""
    from bigdl_tpu_torch.dataset import DataSet, SampleToBatch
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import (DistriOptimizer, Optimizer,
                                       Top1Accuracy, every_epoch)
    from bigdl_tpu_torch.utils.table import T

    model = with_init(classifier_model(device, layers, experts), init,
                      dropout)
    ds = DataSet.array(train) >> SampleToBatch(batch, drop_last=True)
    if distri is None:
        opt = Optimizer(model, ds, ClassNLLCriterion(),
                        state=T(learningRate=A_LR), end_trigger=end_trigger,
                        device=device)
    else:
        opt = DistriOptimizer(model, ds, ClassNLLCriterion(), device=device,
                              **distri)
        opt.set_state(T(learningRate=A_LR)).set_end_when(end_trigger)
    if val is not None:
        opt.set_validation(every_epoch(), DataSet.array(val)
                           >> SampleToBatch(batch, drop_last=True),
                           [Top1Accuracy()])
    return opt


def dropped_share(model):
    """Tokens the MoE layers dropped in the last forward, over the tokens
    they routed."""
    from bigdl_tpu_torch.nn import MoE

    moes = [m for m in model.modules() if isinstance(m, MoE)]
    return (sum(int(m.dropped) for m in moes)
            / max(sum(m.tokens for m in moes), 1))


def attention_path(torch, ops, label, make, n_params, ops_step, smi,
                   profile_n=A_PROFILE):
    """One training path at full width: a 2-step warm-up, the timed run
    from zero counts, its line (ms a step, tokens/s, peak memory,
    launches), the device time a step and idle share over ``profile_n``
    profiled steps, and the step's bound.  Returns (counts, optimizer,
    ms a step)."""
    from bigdl_tpu_torch.optim import max_iteration

    make(max_iteration(2)).optimize()
    opt = make(None)
    counts, wall = timed_path(torch, ops, opt)
    peak = torch.cuda.max_memory_allocated()
    steps = int(opt.state["neval"]) - 1
    want = {**untapped(counts), "fused_sgd": steps}
    if counts != want:
        raise AssertionError(f"{label}: launches {ops_nonzero(counts)} "
                             f"after {steps} steps, expected "
                             f"{ops_nonzero(want)}")
    step_ms = train_line(torch, label, opt, wall, A_BATCH, n_params, counts)
    tokens = A_BATCH * A_T / step_ms * 1e3
    busy = profile_train(torch, make, profile_n)
    bound = ops_step / FP32_FLOPS * 1e3
    print(f"{label}: {step_ms:.4f} ms/step, {tokens:.1f} tokens/s; device "
          f"busy {busy:.4f} ms/step, idle share {1 - busy / step_ms:.4f}; "
          f"max_memory_allocated {peak} B; "
          f"fused_sgd launches {counts['fused_sgd']}; the step's matrix "
          f"products {ops_step} operations (from the shapes) over fp32's "
          f"{FP32_FLOPS / 1e12:.0f} TFLOP/s: bound {bound:.4f} ms "
          f"({step_ms / bound:.3f}x); [{smi}]")
    return counts, opt, step_ms


def ring_one_card(torch, smi):
    """The ring's per-hop step over RING_BLOCKS blocks in one process, the
    rotation by indexing, at the flagship's attention shape, causal and
    not: forward, dq, dk and dv against ``full_attention`` and
    autograd, each timed (forward and backward)."""
    from bigdl_tpu_torch.parallel.ring_attention import (
        full_attention, ring_attention_blocks)

    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(RING_SHAPE, device="cuda", generator=g)
                   for _ in range(4))
    for causal in (False, True):
        outs = {}
        for name, fn in (("ring", lambda *a: ring_attention_blocks(
                *a, RING_BLOCKS, causal)),
                ("full", lambda *a: full_attention(*a, causal=causal))):
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]

            def step():
                out = fn(*leaves)
                return (out,) + torch.autograd.grad(out, leaves, do)

            outs[name] = step()
            outs[name + "_ms"] = time_queued_ms(torch, step, reps=5)
        errs = []
        for i, (part, tol) in enumerate((("out", RING_TOL),
                                         ("dq", RING_GRAD_TOL),
                                         ("dk", RING_GRAD_TOL),
                                         ("dv", RING_GRAD_TOL))):
            a, b = outs["ring"][i].detach(), outs["full"][i].detach()
            err = float((a - b).abs().max())
            errs.append(f"{part} {err:.3e}")
            if not torch.allclose(a, b, **tol):
                raise AssertionError(f"ring on one card (causal {causal}): "
                                     f"{part} parts from full attention by "
                                     f"{err:.3e} (tolerance {tol})")
        print(f"ring: {RING_BLOCKS} blocks of {RING_SHAPE} (B, T, H, hd), "
              f"causal {causal}, held against full attention and autograd: "
              f"largest |ring - full| {', '.join(errs)}; forward and "
              f"backward {outs['ring_ms']:.4f} ms (full attention "
              f"{outs['full_ms']:.4f} ms); [{smi}]")


def lm_corpus(vocab, n, seed=0):
    """The built-in corpus as one stream of its words, cut into ``n``
    windows of L_T + 1 words at random offsets (each window one
    sentence of examples/train_transformer_lm.py's pipeline); the
    dictionary over the corpus, the model's vocabulary ``vocab`` wide."""
    from bigdl_tpu_torch.dataset.text import Dictionary, WordTokenizer

    lines = L_CORPUS.split("\n")
    words = [w for line in WordTokenizer()(iter(lines)) for w in line]
    dictionary = Dictionary([words], vocab_size=vocab)
    stream = words * (-(-(L_T + 1) * 2 // len(words)) + 1)
    rs = np.random.RandomState(seed)
    starts = rs.randint(0, len(stream) - L_T - 1, n)
    return [stream[s:s + L_T + 1] for s in starts], dictionary


def lm_run(torch, device, init, windows, dictionary, batch, end_trigger,
           layers=None, dropout=None):
    """examples/train_transformer_lm.py's optimizer from ``init``:
    one-hot (T, VOCAB) inputs, TimeDistributedCriterion(ClassNLL,
    size_average=True), SGD at L_LR, through LocalOptimizer."""
    from bigdl_tpu_torch.dataset import DataSet, SampleToBatch
    from bigdl_tpu_torch.dataset.text import (LabeledSentenceToSample,
                                              SentenceToLabeledSentence)
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.nn import (ClassNLLCriterion,
                                    TimeDistributedCriterion)
    from bigdl_tpu_torch.optim import LocalOptimizer
    from bigdl_tpu_torch.utils.table import T

    model = with_init(TransformerLM(VOCAB, D_MODEL, HEADS, layers or LAYERS,
                                    HIDDEN, device=device), init, dropout)
    ds = (DataSet.array(windows) >> SentenceToLabeledSentence(dictionary)
          >> LabeledSentenceToSample(n_input_dims=VOCAB, fixed_length=L_T)
          >> SampleToBatch(batch))
    opt = LocalOptimizer(model, ds, TimeDistributedCriterion(
        ClassNLLCriterion(), size_average=True), device=device)
    opt.set_state(T(learningRate=L_LR)).set_end_when(end_trigger)
    return opt


#: the mesh axis of each DistriOptimizer mode
MODE_AXES = {"sequence_parallel": "seq", "expert_parallel": "expert",
             "tensor_parallel": "model"}


def attention_one_rank(torch, ops, init, train, experts, mode):
    """A world of one: ``DistriOptimizer`` with ``mode`` (sequence, expert
    or tensor parallel) against LocalOptimizer on the same records,
    A_ONE_STEPS steps at depth A_ONE_LAYERS, dropout 0, deterministic
    algorithms; (its launch counts, the held line)."""
    from bigdl_tpu_torch.optim import max_iteration
    from bigdl_tpu_torch.parallel.mesh import make_mesh

    axis = MODE_AXES[mode]
    runs = {}
    with deterministic(torch):
        for kind in ("local", "distri", "local", "distri"):
            distri = (None if kind == "local" else
                      {"mesh": make_mesh({"data": 1, axis: 1}, "cuda"),
                       mode: True})
            opt = classifier_run(torch, "cuda", init, train, A_BATCH,
                                 max_iteration(A_ONE_STEPS),
                                 layers=A_ONE_LAYERS, experts=experts,
                                 dropout=0.0, distri=distri)
            _, counts, _ = run_path(torch, ops, opt.optimize)
            runs[kind] = {"losses": [l for _, l in opt.loss_log],
                          "params": _params(torch, opt.model),
                          "counts": counts, "type": type(opt).__name__}
    got = runs["distri"]
    if got["type"] != "DistriOptimizer" or \
            got["counts"]["fused_sgd"] != A_ONE_STEPS:
        raise AssertionError(f"{mode}: {got['type']} launched "
                             f"{ops_nonzero(got['counts'])}")
    return got["counts"], held_bits(torch, mode, got, runs["local"])


def warm_then_timed(torch, ops, opt, steps):
    """Two warm-up steps of ``opt`` (communicators, cuBLAS plans, the
    flat buffers and the SGD kernel's leaf table), then ``steps`` more
    from zero counts: (counts, ms a step)."""
    from bigdl_tpu_torch.optim import max_iteration

    opt.set_end_when(max_iteration(2))
    opt.optimize()
    opt.set_end_when(max_iteration(2 + steps))
    _, counts, wall = run_path(torch, ops, opt.optimize)
    return counts, wall / steps * 1e3


def attention_child(mode, steps):
    """One rank of a multi-card run: the classifier (``{"data": 2,
    "seq": 2}``) or the MoE classifier (``{"data": 2, "expert": 2}``) at
    full width, depth A_ONE_LAYERS, dropout 0, two warm-up steps and
    ``steps`` timed ones on the global batch of A_BATCH; its losses,
    parameters, launches and ms a step."""
    import torch

    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.optim import max_iteration
    from bigdl_tpu_torch.parallel.mesh import make_mesh
    from bigdl_tpu_torch.utils.random import generator

    experts = A_EXPERTS if mode == "expert_parallel" else 0
    axis = "seq" if mode == "sequence_parallel" else "expert"
    init = init_of(classifier_model("cpu", A_ONE_LAYERS, experts,
                                    generator(3)))
    train, _ = attention_docs(A_BATCH * (steps + 2) * 5 // 4, seed=1)
    opt = classifier_run(
        torch, "cuda", init, train, A_BATCH, max_iteration(2),
        layers=A_ONE_LAYERS, experts=experts, dropout=0.0,
        distri={"mesh": make_mesh({"data": 2, axis: 2}, "cuda"), mode: True})
    counts, step_ms = warm_then_timed(torch, ops, opt, steps)
    return {"losses": [l for _, l in opt.loss_log],
            "params": _params(torch, opt.model), "counts": counts,
            "step_ms": step_ms, "mem": torch.cuda.max_memory_allocated(),
            "coords": opt.mesh.coords()}


def attention_cards(torch, ops, smi):
    """Four cards: the classifier at {"data": 2, "seq": 2} and the MoE
    classifier at {"data": 2, "expert": 2} through NCCL ranks, each
    held to LocalOptimizer on this card over the same global batches;
    {path: counts}."""
    from bigdl_tpu_torch.optim import max_iteration
    from bigdl_tpu_torch.parallel.launch import launch
    from bigdl_tpu_torch.utils.random import generator

    by_path = {}
    for mode in ("sequence_parallel", "expert_parallel"):
        experts = A_EXPERTS if mode == "expert_parallel" else 0
        ranks = launch(attention_child, 4, "nccl", args=(mode, A_ONE_STEPS))
        init = init_of(classifier_model("cpu", A_ONE_LAYERS, experts,
                                        generator(3)))
        train, _ = attention_docs(A_BATCH * (A_ONE_STEPS + 2) * 5 // 4,
                                  seed=1)
        local = classifier_run(torch, "cuda", init, train, A_BATCH,
                               max_iteration(2), layers=A_ONE_LAYERS,
                               experts=experts, dropout=0.0)
        _, local_ms = warm_then_timed(torch, ops, local, A_ONE_STEPS)
        want = {"losses": [l for _, l in local.loss_log],
                "params": _params(torch, local.model)}
        for r, run in enumerate(ranks):
            if run["counts"]["fused_sgd"] != A_ONE_STEPS:
                raise AssertionError(f"{mode}, rank {r}: launches "
                                     f"{ops_nonzero(run['counts'])}")
            held = held_bits(torch, f"{mode} on 4 cards, rank {r}", run, want,
                             dict(rtol=LOSS_RTOL, atol=PARAM_ATOL))
        by_path[f"attention_4card_{mode}"] = ranks[0]["counts"]
        print(f"attention {mode}, 4 cards ({ranks[0]['coords']} ...): "
              f"depth {A_ONE_LAYERS} at full width, global batch {A_BATCH} "
              f"x T {A_T}, 2 warm-up steps, then {A_ONE_STEPS}: "
              f"{ranks[0]['step_ms']:.4f} ms/step (LocalOptimizer on one "
              f"card {local_ms:.4f}), max_memory_allocated "
              f"{ranks[0]['mem']} B a rank; held against LocalOptimizer "
              f"over all {2 + A_ONE_STEPS} steps {held}; launches "
              f"{ops_nonzero(ranks[0]['counts'])}; [{smi}]")
    return by_path


def phase_attention(torch, ops, profile: bool):
    """The attention family's training: the ring's step on one card; the
    flagship classifier at bench.py's width through
    ``Optimizer(...).optimize()`` (every step through ``fused_sgd``),
    three steps at depth 1 against the CPU; the MoE classifier likewise,
    its dropped share printed; the LM at the serving width through
    LocalOptimizer, held to the CPU, then ``lm_decode`` from its weights
    through ``paged_attention``; the sequence- and expert-parallel
    ``DistriOptimizer`` at a world of one against LocalOptimizer bit for
    bit (``phase_attention_cards`` takes them across four cards)."""
    from bigdl_tpu_torch.models.transformer import lm_decode
    from bigdl_tpu_torch.optim import max_iteration
    from bigdl_tpu_torch.utils.engine import Engine
    from bigdl_tpu_torch.utils.random import RNG, generator

    smi = smi_line()
    by_path = {}
    ring_one_card(torch, smi)

    # the flagship classifier
    init = init_of(classifier_model("cpu", generator=generator(0)))
    n_params = sum(v.size for v in _leaves(init["params"]))
    if n_params != A_PARAMS:
        raise AssertionError(f"TransformerClassifier has {n_params} "
                             f"parameters, bench.py's has {A_PARAMS}")
    train, val = attention_docs(A_DOCS)
    RNG.set_seed(0)   # the dropout masks
    ops_step = classifier_ops(A_BATCH, A_T, D_MODEL, HEADS, LAYERS, HIDDEN,
                              A_CLASSES)
    print(f"attention classifier: {len(train)} training and {len(val)} "
          f"validation documents of ({A_T}, {D_MODEL}) (the example "
          f"builds 2048); the step's matrix products {ops_step} "
          f"operations from the shapes, the JAX record's count "
          f"{A_JAX_OPS} ({A_JAX_OPS / FP32_FLOPS * 1e3:.4f} ms at fp32's "
          f"peak)")
    counts, opt, _ = attention_path(
        torch, ops, "attention classifier: TransformerClassifier at "
        "bench.py's width", lambda end: classifier_run(
            torch, "cuda", init, train, A_BATCH,
            end or max_iteration(A_STEPS), val=None if end else val),
        n_params, ops_step, smi)
    by_path["attention_classifier"] = counts
    del opt
    check = init_of(classifier_model("cpu", A_CHECK_LAYERS,
                                     generator=generator(1)))
    diff = card_vs_cpu(torch, check["params"], lambda device: classifier_run(
        torch, device, check, train[:A_CHECK_BATCH * A_CHECK_STEPS],
        A_CHECK_BATCH, max_iteration(A_CHECK_STEPS),
        layers=A_CHECK_LAYERS, dropout=0.0), routed=True)
    print_vs_cpu(f"attention classifier (depth {A_CHECK_LAYERS} of "
                 f"{LAYERS}, full width)", A_CHECK_BATCH, diff, PARAM_ATOL)
    held_vs_cpu("attention classifier", diff, PARAM_ATOL)

    # the MoE classifier
    init = init_of(classifier_model("cpu", experts=A_EXPERTS,
                                    generator=generator(2)))
    n_params = sum(v.size for v in _leaves(init["params"]))
    if n_params != A_MOE_PARAMS:
        raise AssertionError(f"the MoE classifier has {n_params} parameters")
    cap = int(1.25 * A_BATCH * A_T / A_EXPERTS)
    counts, opt, _ = attention_path(
        torch, ops, f"attention MoE classifier: {A_EXPERTS} experts, "
        f"dispatch ({A_BATCH * A_T}, {A_EXPERTS}, {cap}) a layer",
        lambda end: classifier_run(torch, "cuda", init, train, A_BATCH,
                                   end or max_iteration(A_MOE_STEPS),
                                   experts=A_EXPERTS),
        n_params, classifier_ops(A_BATCH, A_T, D_MODEL, HEADS, LAYERS,
                                 HIDDEN, A_CLASSES, A_EXPERTS, cap), smi,
        profile_n=2)
    print(f"attention MoE classifier: dropped share of the last step "
          f"{dropped_share(opt.model):.4f} (capacity {cap} a layer and "
          f"expert)")
    by_path["attention_moe"] = counts
    del opt
    check = init_of(classifier_model("cpu", A_CHECK_LAYERS, A_EXPERTS,
                                     generator(3)))
    # routed: a gate a rounding apart from the next sends a token to
    # another expert (or over the capacity) on one side only, and an
    # expert's pre-activation a rounding from 0 flips its ReLU
    diff = card_vs_cpu(torch, check["params"], lambda device: classifier_run(
        torch, device, check, train[:A_CHECK_BATCH * A_CHECK_STEPS],
        A_CHECK_BATCH, max_iteration(A_CHECK_STEPS), layers=A_CHECK_LAYERS,
        experts=A_EXPERTS, dropout=0.0), routed=True)
    print_vs_cpu(f"attention MoE classifier (depth {A_CHECK_LAYERS}, full "
                 f"width)", A_CHECK_BATCH, diff, PARAM_ATOL)
    held_vs_cpu("attention MoE classifier", diff, PARAM_ATOL)

    # the LM, then lm_decode from its trained weights
    from bigdl_tpu_torch.models.transformer import TransformerLM

    windows, dictionary = lm_corpus(VOCAB, L_BATCH * L_STEPS)
    init = init_of(TransformerLM(VOCAB, D_MODEL, HEADS, LAYERS, HIDDEN,
                                 device="cpu", generator=generator(4)))
    lm_ops = 3 * (LAYERS * (4 * 2 * L_BATCH * L_T * D_MODEL ** 2
                            + 2 * 2 * L_BATCH * L_T * D_MODEL * HIDDEN
                            + 2 * 2 * L_BATCH * L_T * L_T * D_MODEL)
                  + 2 * 2 * L_BATCH * L_T * D_MODEL * VOCAB)
    lm_run(torch, "cuda", init, windows, dictionary, L_BATCH,
           max_iteration(2)).optimize()
    opt = lm_run(torch, "cuda", init, windows, dictionary, L_BATCH,
                 max_iteration(L_STEPS))
    counts, wall = timed_path(torch, ops, opt)
    want = {**untapped(counts), "fused_sgd": L_STEPS}
    if counts != want:
        raise AssertionError(f"the LM launched {ops_nonzero(counts)}")
    by_path["attention_lm"] = counts
    peak = torch.cuda.max_memory_allocated()
    losses = [l for _, l in opt.loss_log]
    step_ms = wall / L_STEPS * 1e3
    fetch_s, fetches = opt.metrics.get("data fetch time")
    busy = profile_train(torch, lambda end: lm_run(
        torch, "cuda", init, windows, dictionary, L_BATCH, end), A_PROFILE)
    print(f"attention LM: TransformerLM({VOCAB}, {D_MODEL}, {HEADS} heads, "
          f"{LAYERS} layers, hidden {HIDDEN}) on the built-in corpus "
          f"({dictionary.vocab_size()} words in {len(windows)} windows of "
          f"{L_T + 1}), batch {L_BATCH} x T {L_T}, {L_STEPS} steps: "
          f"{step_ms:.4f} ms/step, {L_BATCH * L_T / step_ms * 1e3:.1f} "
          f"tokens/s; host: the one-hot batch and its H2D copy "
          f"{fetch_s / fetches * 1e3:.4f} ms/batch; device busy "
          f"{busy:.4f} ms/step, idle share {1 - busy / step_ms:.4f}; "
          f"max_memory_allocated {peak} B, launches {ops_nonzero(counts)}, "
          f"losses {losses[0]:.6f} -> {losses[-1]:.6f}; bound "
          f"{lm_ops / FP32_FLOPS * 1e3:.4f} ms ({lm_ops} operations); "
          f"[{smi}]")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the LM's loss did not fall: {losses}")
    seed = [dictionary.index(w) for w in L_CORPUS.split("\n")[0].split()]
    opt.model.evaluate()
    ops.reset_launch_counts()
    row = lm_decode(opt.model, seed, L_WORDS, device="cuda")
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    n_pos = len(seed) + L_WORDS - 1
    if counts["paged_attention"] != LAYERS * n_pos:
        raise AssertionError(f"lm_decode launched {ops_nonzero(counts)}")
    gaps = forced_gaps(torch, opt.model, row, len(seed))
    if float(gaps.max()) > 1e-3:
        raise AssertionError(f"lm_decode's tokens sit {float(gaps.max()):.3e}"
                             f" below the full forward's maximum")
    by_path["attention_lm_decode"] = counts
    print(f"attention LM: lm_decode from the trained weights, {L_WORDS} "
          f"words after '{L_CORPUS.split(chr(10))[0]}': "
          f"{' '.join(dictionary.word(i) for i in row[len(seed):])!r}; "
          f"paged_attention launches {counts['paged_attention']}; every "
          f"token the full forward's argmax (largest gap "
          f"{float(gaps.max()):.3e})")
    del opt
    check = init_of(TransformerLM(VOCAB, D_MODEL, HEADS, A_CHECK_LAYERS,
                                  HIDDEN, device="cpu",
                                  generator=generator(5)))
    diff = card_vs_cpu(torch, check["params"], lambda device: lm_run(
        torch, device, check, windows[:A_CHECK_BATCH * A_CHECK_STEPS],
        dictionary, A_CHECK_BATCH, max_iteration(A_CHECK_STEPS),
        layers=A_CHECK_LAYERS, dropout=0.0), routed=True)
    print_vs_cpu(f"attention LM (depth {A_CHECK_LAYERS}, full width)",
                 A_CHECK_BATCH, diff, PARAM_ATOL)
    held_vs_cpu("attention LM", diff, PARAM_ATOL)

    # sequence and expert parallelism: a world of one on this card, then
    # four cards where the machine has them
    try:
        for mode, experts in (("sequence_parallel", 0),
                              ("expert_parallel", A_EXPERTS)):
            init = init_of(classifier_model("cpu", A_ONE_LAYERS, experts,
                                            generator(3)))
            counts, held = attention_one_rank(torch, ops, init, train,
                                              experts, mode)
            by_path[f"attention_one_rank_{mode}"] = counts
            print(f"attention {mode}: DistriOptimizer at a world of one, "
                  f"depth {A_ONE_LAYERS} at full width, {A_ONE_STEPS} steps "
                  f"against LocalOptimizer: {held}; [{smi}]")
    finally:
        Engine.reset()
    return by_path, {}


def phase_attention_cards(torch, ops):
    """Sequence and expert parallelism across four cards (``attention_
    cards``), where the machine has them."""
    smi = smi_line()
    if torch.cuda.device_count() < 4:
        print(f"attention cards: {torch.cuda.device_count()} card(s): the "
              f"four-card sequence- and expert-parallel runs need four; "
              f"[{smi}]")
        return {}, {}
    return attention_cards(torch, ops, smi), {}


# -- tensor and pipeline parallelism ---------------------------------------

# VGG on CIFAR-10 in pipeline stages as examples/train_vgg.py --pipeline
# trains it: vgg_run's data and SGD (batch VBATCH), PMICRO microbatches,
# PSTEPS timed steps of each schedule after PWARM; PHELD_STEPS steps held
# to the serial program (deterministic algorithms, dropout 0),
# PCHECK_STEPS at batch VCHECK_BATCH as PCHECK_MICRO microbatches to the
# CPU; one validation of the VVAL images after the held steps.  The CPU
# check runs at microbatches of 4: over microbatches of 2 (BN over two
# images) one fp32 rounding of the parameters carries the CPU against
# itself past the params limit within two steps (``--parallel-vs-cpu``)
PSTEPS, PWARM, PSHORT, PHELD_STEPS, PPROFILE = 20, 2, 4, 3, 8
# the steady state's short and long calls, this many pairs (the median;
# READ["pairs"] in this process, the default in a spawned rank's)
STEADY_PAIRS = 3
PCHECK_STEPS, PCHECK_MICRO = 3, 4
# a schedule against the serial program in its order: bits, or within
# this.  The data replicas of a hybrid mesh sum their parts of a
# microbatch's gradient in another order than the serial program, and
# VGG's BN, ReLU and pool ties carry a rounding through three steps
# (GPipe held to the serial program in 1F1B's order parts past
# PIPE_TOL): four cards are held as the smoke holds them to
# LocalOptimizer, bits or LOSS_RTOL / PARAM_ATOL
PIPE_TOL = dict(rtol=1e-6, atol=1e-6)
# the classifier's steady state across cards: A_SHORT, then A_LONG steps
A_SHORT, A_LONG = 2, 8
# the deterministic MLP gate of __graft_entry__.py:290-330 on 4 ranks
GATE_TOL = dict(rtol=1e-4, atol=1e-6)


def world_for(torch, device):
    """A world of one on ``device``'s backend: a world of the other
    backend left by an earlier run is taken down first."""
    import torch.distributed as dist

    from bigdl_tpu_torch.utils.engine import Engine, backend_for

    if dist.is_initialized() and dist.get_world_size() == 1 and \
            dist.get_backend() != backend_for(device):
        Engine.reset()


def pipe_vgg_run(torch, device, init, images, batch, end_trigger, stages,
                 schedule, axes=None, dropout=None, remat=False,
                 val_images=None, micro=PMICRO):
    """vgg_run's data, model and SGD through ``DistriOptimizer(
    pipeline_stages=stages, pipeline_schedule=schedule,
    pipeline_microbatches=micro)`` on the mesh ``axes`` (``{"pipe":
    stages}`` when None); GPipe checkpoints each stage with ``remat``;
    Top1 after PHELD_STEPS iterations on ``val_images``."""
    from bigdl_tpu_torch.dataset import (DataSet, HFlip, ImgNormalizer,
                                         ImgRdmCropper, ImgToBatch, cifar)
    from bigdl_tpu_torch.models.vgg import VggForCifar10
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import (DistriOptimizer, Top1Accuracy,
                                       several_iteration)
    from bigdl_tpu_torch.parallel import make_mesh
    from bigdl_tpu_torch.utils.table import T

    world_for(torch, device)
    norm = ImgNormalizer(cifar.TRAIN_MEAN, cifar.TRAIN_STD)
    train = (DataSet.array(images) >> norm >> ImgRdmCropper(32, 32, padding=4)
             >> HFlip() >> ImgToBatch(batch))
    model = with_init(VggForCifar10(10, device=device), init, dropout)
    opt = DistriOptimizer(
        model, train, ClassNLLCriterion(), device=device,
        mesh=make_mesh(axes or {"pipe": stages}, device),
        pipeline_stages=stages, pipeline_schedule=schedule,
        pipeline_microbatches=micro)
    opt.set_state(T(learningRate=VLR, momentum=0.9, weightDecay=VWD))
    opt.set_end_when(end_trigger).set_gradient_checkpointing(remat)
    if val_images is not None:
        opt.set_validation(several_iteration(PHELD_STEPS + 1),
                           DataSet.array(val_images) >> norm
                           >> ImgToBatch(batch), [Top1Accuracy()])
    return opt


def vgg_serial(torch, init, images, micro, val_images=None, order="1f1b"):
    """The pipeline's serial program on this card: vgg_run's
    LocalOptimizer on the same batches, dropout 0, each step the whole
    model run microbatch by microbatch through the pipeline's stage
    function (its seeds), each microbatch's loss / ``micro``
    backpropagated in the schedule's ``order`` (1F1B: as it is computed;
    GPipe: after every forward, the last microbatch's first), one
    ``fused_sgd`` update; PHELD_STEPS steps, Top1 after them on
    ``val_images``.  Returns the optimizer after its run."""
    from bigdl_tpu_torch.optim import max_iteration, several_iteration
    from bigdl_tpu_torch.parallel.pipeline import stage_function

    world_for(torch, "cuda")
    opt = vgg_run(torch, "cuda", init, images, VBATCH,
                  max_iteration(PHELD_STEPS), val_images, dropout=0.0)
    opt.validation_trigger = several_iteration(PHELD_STEPS + 1)
    mods = list(opt.model._modules.values())

    def step(params, opt_state, x, y, hyper, taps=None):
        opt._zero_grads(params)
        run = stage_function(mods, 0, int(opt.state["neval"]), x.device)
        mb = x.shape[0] // micro
        loss = torch.zeros((), device=x.device)
        held = []
        for m in range(micro):
            rows = slice(m * mb, (m + 1) * mb)
            lm = opt.criterion(run(x[rows], m), y[rows]) * (1.0 / micro)
            if order == "1f1b":
                lm.backward()
            else:
                held.append(lm)
            loss = loss + lm.detach().float()
        for lm in reversed(held):
            lm.backward()
        finite = torch.isfinite(loss)
        opt._update([p.grad for p in params], opt_state, params, hyper,
                    finite)
        return loss, finite

    opt._train_step = step
    opt.optimize()
    return opt


def run_of(torch, opt):
    """An optimizer's trajectory for ``held_bits``: losses, parameters,
    Top1 of its validations."""
    return {"losses": [l for _, l in opt.loss_log],
            "params": _params(torch, opt.model),
            "top1": [v["Top1Accuracy"] for _, _, v in opt.validation_log]}


def held_pipe(torch, label, got, want, tol=PIPE_TOL):
    """A pipeline run against the serial program: bits and the same Top1,
    or within ``tol``."""
    held = _bits_or(torch, label, got, want, tol)
    if held == "bits" and got["top1"] != want["top1"]:
        raise AssertionError(f"{label}: Top1 {got['top1']} against the "
                             f"serial program's {want['top1']}")
    return held


def _bits_or(torch, label, got, want, tol):
    lg, lw = np.asarray(got["losses"]), np.asarray(want["losses"])
    if len(lg) != len(lw) or len(lg) == 0:
        raise AssertionError(f"{label}: {len(lg)} and {len(lw)} losses")
    if np.array_equal(lg, lw) and torch.equal(got["params"], want["params"]):
        return "bits"
    rel = float(np.max(np.abs(lg - lw) / np.abs(lw)))
    p_abs = float((got["params"] - want["params"]).abs().max())
    if rel > tol["rtol"] or p_abs > tol["atol"]:
        raise AssertionError(f"{label}: losses {rel:.3e} relative, params "
                             f"{p_abs:.3e} apart, beyond {tol}")
    return (f"within rtol {tol['rtol']} / atol {tol['atol']} (losses "
            f"{rel:.3e}, params {p_abs:.3e})")


def pipe_counts(steps, fwd_runs=1):
    """The launches of ``steps`` pipeline steps of VGG (no validation):
    one ``fused_sgd`` a step, each microbatch's five pools forward
    (``fwd_runs`` times under checkpointing) and backward."""
    return {"fused_sgd": steps,
            "maxpool2d_forward": 5 * PMICRO * steps * fwd_runs,
            "maxpool2d_backward": 5 * PMICRO * steps}


def only_counts(label, counts, want):
    want = {**untapped(counts), **want}
    if counts != want:
        raise AssertionError(f"{label}: launches {ops_nonzero(counts)}, "
                             f"expected {ops_nonzero(want)}")


def steady_ms(torch, ops, opt, short, long):
    """``opt``'s ms a step in its steady state, after a warm-up call:
    READ["pairs"] times a call of ``short`` more steps, then one of
    ``long``,
    each from zero counts; the difference of a pair's walls over ``long -
    short`` steps leaves out what a call spends before its first step
    and after its last (a pipeline's stages moved and gathered, the
    tensor-parallel rows sliced and gathered, the model broadcast), and
    the median over the pairs the host's noise in one pair.  Returns (the
    last long call's counts, ms a step, ms of a call's own set-up: the
    medians)."""
    from bigdl_tpu_torch.optim import max_iteration

    done = int(opt.state["neval"]) - 1
    steps, setups = [], []
    for _ in range(READ["pairs"]):
        walls = []
        for n in (short, long):
            done += n
            opt.set_end_when(max_iteration(done))
            _, counts, wall = run_path(torch, ops, opt.optimize)
            walls.append(wall)
        step = (walls[1] - walls[0]) / (long - short)
        steps.append(step * 1e3)
        setups.append((walls[0] - short * step) * 1e3)
    return counts, statistics.median(steps), statistics.median(setups)


def nccl_window(torch, opt, n):
    """``n`` more steps of ``opt`` under the profiler: (device busy ms a
    step, wall ms a step, [(NCCL kernel, device ms a step, launches a
    step)]).  Busy counts the kernels other than NCCL's: those run on
    streams of their own beside the compute, a SendRecv waiting for its
    peer the whole while, so their sum with the compute's can outlast
    the wall."""
    from torch.profiler import ProfilerActivity, profile

    from bigdl_tpu_torch.optim import max_iteration

    opt.set_end_when(max_iteration(int(opt.state["neval"]) - 1 + n))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        opt.optimize()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time_total for e in rows
               if not is_nccl_kernel(e.key)) / 1e3 / n
    nccl = [(e.key[:60], e.device_time_total / 1e3 / n, e.count / n)
            for e in rows if is_nccl_kernel(e.key)
            and not e.key.startswith("nccl:")]
    return busy, wall / n * 1e3, sorted(nccl, key=lambda r: -r[1])


def parallel_vgg_one(torch, ops, init, images, val, smi):
    """VGG at full width through ``pipeline_stages=1`` on this card: each
    schedule PSTEPS timed steps (launch counts, ms a step, images/s,
    device busy and idle share, peak memory) and PHELD_STEPS steps held
    to the serial program with one validation, each pool geometry they
    met one the kernel phase holds; GPipe under checkpointing against
    GPipe; {path: counts}."""
    from bigdl_tpu_torch.optim import max_iteration

    by_path = {}
    with deterministic(torch):
        serial = {order: run_of(torch, vgg_serial(torch, init, images,
                                                  PMICRO, val, order))
                  for order in ("1f1b", "gpipe")}
        for schedule, remat in (("1f1b", False), ("gpipe", False),
                                ("gpipe", True)):
            label = f"parallel vgg {schedule}" + (" remat" if remat else "")
            opt = pipe_vgg_run(torch, "cuda", init, images, VBATCH,
                               max_iteration(PHELD_STEPS), 1, schedule,
                               dropout=0.0, remat=remat, val_images=val)
            with Routes(torch, opt.model, geometry_only=True) as seen:
                _, counts, _ = run_path(torch, ops, opt.optimize)
            held_standalone(label, seen)
            want = pipe_counts(PHELD_STEPS, 2 if remat else 1)
            want["maxpool2d_forward"] += 5 * -(-VVAL // VBATCH)
            only_counts(label, counts, want)
            held = held_pipe(torch, label, run_of(torch, opt),
                             serial[schedule], PIPE_TOL)
            print(f"{label}: {PHELD_STEPS} steps of {VBATCH} as {PMICRO} "
                  f"microbatches at one stage against the serial program "
                  f"(the stage run microbatch by microbatch, backpropagated "
                  f"in {schedule}'s order): {held}; Top1 "
                  f"{serial[schedule]['top1']}; launches "
                  f"{ops_nonzero(counts)}")
            if remat:
                by_path["parallel_vgg_gpipe_remat"] = counts
    for schedule in ("1f1b", "gpipe"):
        label = f"parallel vgg {schedule}"
        counts, step_ms, setup_ms, peak, opt = pipe_vgg_timed(
            torch, ops, init, images, 1, schedule)
        only_counts(label, counts, pipe_counts(PSTEPS))
        profiled = READ["pipe_profiled"] or PPROFILE
        busy, window, _ = nccl_window(torch, opt, profiled)
        losses = [l for _, l in opt.loss_log]
        print(f"{label}: VggForCifar10 in 1 stage, {PMICRO} microbatches "
              f"of {VBATCH // PMICRO}: {step_ms:.4f} ms/step in the steady "
              f"state (the median of {READ['pairs']} pairs of calls of "
              f"{PSHORT} and {PSTEPS} steps; a call's own set-up "
              f"{setup_ms:.4f} ms), {VBATCH / step_ms * 1e3:.1f} "
              f"images/s; device busy {busy:.4f} ms/step over a profiled "
              f"call of {profiled} steps, {window:.4f} ms/step of its wall "
              f"(its set-up inside), idle share {1 - busy / window:.4f}; "
              f"max_memory_allocated {peak} B; peak microbatches in flight "
              f"{opt.pipe_result.peak_in_flight}; launches "
              f"{ops_nonzero(counts)}; losses {losses[0]:.6f} -> "
              f"{losses[-1]:.6f}; [{smi}]")
        by_path[f"parallel_vgg_{schedule}"] = counts
    return by_path


def pipe_vgg_timed(torch, ops, init, images, stages, schedule, axes=None):
    """VGG in ``stages`` pipeline stages: PWARM warm-up steps, then the
    steady state's ms a step over PSTEPS (``steady_ms``); (the PSTEPS
    call's counts, ms a step, a call's set-up ms, peak memory over that
    call, the optimizer)."""
    from bigdl_tpu_torch.optim import max_iteration

    opt = pipe_vgg_run(torch, "cuda", init, images, VBATCH,
                       max_iteration(PWARM), stages, schedule, axes)
    opt.optimize()
    torch.cuda.reset_peak_memory_stats()
    counts, step_ms, setup_ms = steady_ms(torch, ops, opt, PSHORT, PSTEPS)
    return counts, step_ms, setup_ms, torch.cuda.max_memory_allocated(), opt


def phase_parallel(torch, ops, profile: bool):
    """Tensor and pipeline parallelism on one card, a world of one: VGG
    at full width through ``pipeline_stages=1`` under 1F1B and GPipe
    (``parallel_vgg_one``), three steps at batch 16 held to the CPU; the
    flagship classifier through ``tensor_parallel=True`` on ``{"data":
    1, "model": 1}`` bit-equal to LocalOptimizer."""
    from bigdl_tpu_torch.dataset import cifar
    from bigdl_tpu_torch.models.vgg import VggForCifar10
    from bigdl_tpu_torch.utils.engine import Engine
    from bigdl_tpu_torch.utils.random import RNG, generator

    smi = smi_line()
    try:
        init = init_of(VggForCifar10(10, device="cpu",
                                     generator=generator(0)))
        images, val = cifar.synthetic(VTRAIN), cifar.synthetic(VVAL, seed=1)
        RNG.set_seed(0)   # the dropout masks
        by_path = parallel_vgg_one(torch, ops, init, images, val, smi)
        diff = pipe_vs_cpu(torch, init, PCHECK_STEPS, PCHECK_MICRO)
        held_vs_cpu("parallel vgg", diff, PARAM_ATOL, scope="model")
        world_for(torch, "cuda")
        train, _ = attention_docs(A_DOCS)
        init = init_of(classifier_model("cpu", A_ONE_LAYERS,
                                        generator=generator(3)))
        counts, held = attention_one_rank(torch, ops, init, train, 0,
                                          "tensor_parallel")
        by_path["parallel_tensor_one_rank"] = counts
        print(f"parallel tensor_parallel: DistriOptimizer on {{'data': 1, "
              f"'model': 1}}, the classifier at depth {A_ONE_LAYERS} of "
              f"{LAYERS} at full width (d_model {D_MODEL}, {HEADS} heads, "
              f"hidden {HIDDEN}; batch {A_BATCH} x T {A_T}), "
              f"{A_ONE_STEPS} steps against LocalOptimizer: {held}; "
              f"launches {ops_nonzero(counts)}; [{smi}]")
    finally:
        Engine.reset()
    return by_path, {}


def pipe_vs_cpu(torch, init, steps, micro):
    """VGG through ``pipeline_stages=1`` under 1F1B, ``steps`` steps at
    batch VCHECK_BATCH as ``micro`` microbatches, dropout 0, on the card
    against the CPU (``card_vs_cpu``, routed); printed, and returned."""
    from bigdl_tpu_torch.dataset import cifar
    from bigdl_tpu_torch.optim import max_iteration

    check = cifar.synthetic(VCHECK_BATCH * steps, seed=2)
    diff = card_vs_cpu(torch, init["params"], lambda device: pipe_vgg_run(
        torch, device, init, check, VCHECK_BATCH, max_iteration(steps), 1,
        "1f1b", dropout=0.0, micro=micro), routed=True)
    print_vs_cpu(f"parallel vgg 1f1b, {steps} steps as {micro} microbatches "
                 f"of {VCHECK_BATCH // micro}", VCHECK_BATCH, diff,
                 PARAM_ATOL)
    return diff


def perturbed(init, seed=0):
    """``init`` with every parameter moved by one fp32 rounding (a
    relative 2^-24 of either sign)."""
    rs = np.random.RandomState(seed)

    def move(tree):
        return {k: ({n: (v * (1 + rs.choice([-1.0, 1.0], v.shape)
                               * 2.0 ** -24)).astype(v.dtype)
                     for n, v in sub.items()} if k == "~" else move(sub))
                for k, sub in tree.items()}
    return {"params": move(init["params"]), "state": init["state"]}


def cpu_spread(torch, init, steps, micro):
    """Two CPU runs of ``pipe_vs_cpu``'s configuration, from ``init`` and
    from ``init`` moved by one rounding (``perturbed``): how far one
    rounding carries in fp32 alone, with no card in it.  (losses'
    largest relative difference, parameters' largest absolute
    difference, running statistics' largest over their buffer's largest
    entry)."""
    from bigdl_tpu_torch.dataset import cifar
    from bigdl_tpu_torch.optim import max_iteration

    check = cifar.synthetic(VCHECK_BATCH * steps, seed=2)
    runs = []
    for start in (init, perturbed(init)):
        opt = pipe_vgg_run(torch, "cpu", start, check, VCHECK_BATCH,
                           max_iteration(steps), 1, "1f1b", dropout=0.0,
                           micro=micro)
        opt.optimize()
        runs.append((np.asarray([l for _, l in opt.loss_log]),
                     _params(torch, opt.model),
                     [b.detach().double() for b in opt.model.buffers()
                      if b.is_floating_point()]))
    (la, pa, sa), (lb, pb, sb) = runs
    return (float(np.max(np.abs(la - lb) / np.abs(lb))),
            float((pa - pb).abs().max()),
            max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                for a, b in zip(sa, sb)))


def phase_parallel_vs_cpu(torch, ops, profile: bool):
    """A reading, not a gate: VGG's pipeline on the card against the CPU
    at batch VCHECK_BATCH over 2 and 3 steps, as 8 microbatches of 2 and
    as 4 of 4, each with the parts of ``held_vs_cpu``'s gate it fails,
    and beside it the CPU against itself from parameters one rounding
    apart (``cpu_spread``).  The phase's own check, PCHECK_STEPS at
    PCHECK_MICRO, runs in ``phase_parallel``."""
    from bigdl_tpu_torch.models.vgg import VggForCifar10
    from bigdl_tpu_torch.utils.engine import Engine
    from bigdl_tpu_torch.utils.random import RNG, generator

    smi = smi_line()
    try:
        init = init_of(VggForCifar10(10, device="cpu",
                                     generator=generator(0)))
        for micro in (8, 4):
            for steps in (2, 3):
                RNG.set_seed(0)
                diff = pipe_vs_cpu(torch, init, steps, micro)
                failed = vs_cpu_failures(diff, PARAM_ATOL, scope="model")
                limit = max(BILSTM_BWD_TOL["rtol"],
                            BILSTM_VS_64 * diff["cpu_norm_64"])
                print(f"parallel_vs_cpu {steps} steps as {micro} "
                      f"microbatches of {VCHECK_BATCH // micro}: "
                      f"held_vs_cpu's gate (scope model) "
                      f"{'fails ' + ', '.join(failed) if failed else 'holds'}"
                      f"; whole gradient from float64 card "
                      f"{diff['card_norm_64']:.4e} CPU "
                      f"{diff['cpu_norm_64']:.4e} (limit {limit:.4e}), "
                      f"card - CPU {diff['grad_norm_rel']:.4e}; losses "
                      f"{diff['loss_rel']:.4e} (limit {LOSS_RTOL}); params "
                      f"{diff['param_abs']:.4e} (limit {PARAM_ATOL}); "
                      f"running statistics {diff['state_rel']:.4e} "
                      f"({diff['state_leaf']}; limit {STATE_RTOL}); [{smi}]")
                spread = cpu_spread(torch, init, steps, micro)
                print(f"parallel_vs_cpu {steps} steps as {micro} "
                      f"microbatches of {VCHECK_BATCH // micro}, the CPU "
                      f"against itself from parameters one rounding apart: "
                      f"losses {spread[0]:.4e}, params {spread[1]:.4e}, "
                      f"running statistics {spread[2]:.4e}")
    finally:
        Engine.reset()
    return {}, {}


def parallel_child(jobs):
    """One NCCL rank of the four-card run: each job of ``jobs`` in turn
    (``parallel_job``); rank 0's results in full, the others' without
    the parameters."""
    import torch
    import torch.distributed as dist

    from bigdl_tpu_torch.utils.device import pin_fp32

    pin_fp32(torch.device("cuda"))
    out = []
    for job in jobs:
        res = parallel_job(torch, *job)
        if dist.get_rank() != 0:
            res.pop("params", None)
        out.append(res)
        dist.barrier()
    return out


def parallel_job(torch, kind, arg):
    """One run of the four-card phase on this rank: ``("vgg", (schedule,
    axes))`` VGG in pipeline stages, PHELD_STEPS held steps with a
    validation, then PWARM + PSTEPS timed and PPROFILE under the
    profiler; ``("classifier", mode kwargs)`` the classifier at depth
    A_ONE_LAYERS (dropout 0) over 2 + A_ONE_STEPS steps, then PPROFILE
    under the profiler; ``("gate", None)`` __graft_entry__.py's
    deterministic MLP, plain DP and hybrid dp x pp."""
    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.dataset import cifar
    from bigdl_tpu_torch.models.vgg import VggForCifar10
    from bigdl_tpu_torch.optim import max_iteration
    from bigdl_tpu_torch.parallel import make_mesh
    from bigdl_tpu_torch.utils.random import RNG, generator

    torch.cuda.reset_peak_memory_stats()
    if kind == "gate":
        return mlp_gate(torch)
    if kind == "classifier":
        init = init_of(classifier_model("cpu", A_ONE_LAYERS,
                                        generator=generator(3)))
        train, _ = attention_docs(A_BATCH * (A_ONE_STEPS + 2) * 5 // 4,
                                  seed=1)
        axes = {"data": 4} if not arg else {"data": 2, "model": 2}
        opt = classifier_run(torch, "cuda", init, train, A_BATCH,
                             max_iteration(2), layers=A_ONE_LAYERS,
                             dropout=0.0, distri={
                                 "mesh": make_mesh(axes, "cuda"), **arg})
        counts, _ = warm_then_timed(torch, ops, opt, A_ONE_STEPS)
        out = {"losses": [l for _, l in opt.loss_log],
               "params": _params(torch, opt.model), "counts": counts,
               "coords": opt.mesh.coords(),
               "gathered": dict(opt.tp_gathered_leaves)}
        torch.cuda.reset_peak_memory_stats()
        _, out["step_ms"], out["setup_ms"] = steady_ms(torch, ops, opt,
                                                       A_SHORT, A_LONG)
        out["mem"] = torch.cuda.max_memory_allocated()
    else:
        schedule, axes = arg
        stages = axes["pipe"]
        init = init_of(VggForCifar10(10, device="cpu",
                                     generator=generator(0)))
        images, val = cifar.synthetic(VTRAIN), cifar.synthetic(VVAL, seed=1)
        RNG.set_seed(0)
        with deterministic(torch):
            opt = pipe_vgg_run(torch, "cuda", init, images, VBATCH,
                               max_iteration(PHELD_STEPS), stages, schedule,
                               axes, dropout=0.0, val_images=val)
            with Routes(torch, opt.model, geometry_only=True) as seen:
                opt.optimize()
        out = run_of(torch, opt)
        out["ranges"] = opt._pipe.plan.ranges
        out["pools"] = sorted(seen.pools)
        counts, step_ms, setup_ms, mem, opt = pipe_vgg_timed(
            torch, ops, init, images, stages, schedule, axes)
        out.update(counts=counts, step_ms=step_ms, setup_ms=setup_ms,
                   mem=mem, coords=opt.mesh.coords(),
                   bubble=opt.pipe_result.bubble,
                   peak=opt.pipe_result.peak_in_flight,
                   gathered=dict(opt.tp_gathered_leaves))
    out["busy_ms"], out["window_ms"], out["nccl"] = nccl_window(
        torch, opt, PPROFILE)
    return out


def mlp_gate(torch):
    """__graft_entry__.py:290-330 on four ranks: Linear(6, 8), ReLU,
    Linear(8, 3), LogSoftMax from one seed, 32 records in batches of 16,
    momentum SGD at lr 0.05, two steps as plain DP on {"data": 4} and as
    hybrid dp x pp on {"data": 2, "pipe": 2} (the default 4 microbatches
    of 4, each split over the data axis)."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToBatch
    from bigdl_tpu_torch.optim import DistriOptimizer, max_iteration
    from bigdl_tpu_torch.parallel import make_mesh
    from bigdl_tpu_torch.utils.random import generator
    from bigdl_tpu_torch.utils.table import T

    rs = np.random.RandomState(7)
    samples = [Sample(rs.randn(6).astype(np.float32),
                      np.asarray([float(i % 3 + 1)], np.float32))
               for i in range(32)]
    losses = {}
    for name, axes, kw in (("dp", {"data": 4}, {}),
                           ("dp_pp", {"data": 2, "pipe": 2},
                            {"pipeline_stages": 2})):
        g = generator(31)
        model = nn.Sequential(
            nn.Linear(6, 8, device="cuda", generator=g), nn.ReLU(True),
            nn.Linear(8, 3, device="cuda", generator=g), nn.LogSoftMax())
        opt = DistriOptimizer(model, DataSet.array(samples)
                              >> SampleToBatch(16), nn.ClassNLLCriterion(),
                              mesh=make_mesh(axes, "cuda"), device="cuda",
                              **kw)
        opt.set_state(T(learningRate=0.05, momentum=0.9))
        opt.set_end_when(max_iteration(2)).optimize()
        losses[name] = [l for _, l in opt.loss_log]
    return {"losses": losses}


def idle_of(results):
    """Each rank's idle share over its profiled window."""
    return [round(1 - x["busy_ms"] / x["window_ms"], 4) for x in results]


def parallel_cards(torch, ops, smi):
    """Four cards: VGG in four pipeline stages under 1F1B and GPipe and at
    {"data": 2, "pipe": 2}, each held to the serial program on this card;
    the MLP gate; the classifier at {"data": 2, "model": 2} with and
    without zero1 and as plain DP at {"data": 4}, each held to
    LocalOptimizer on this card; {path: counts}."""
    from bigdl_tpu_torch.dataset import cifar
    from bigdl_tpu_torch.models.vgg import VggForCifar10
    from bigdl_tpu_torch.optim import max_iteration
    from bigdl_tpu_torch.parallel.launch import launch
    from bigdl_tpu_torch.utils.random import RNG, generator

    jobs = [("vgg", ("1f1b", {"pipe": 4})), ("vgg", ("gpipe", {"pipe": 4})),
            ("vgg", ("1f1b", {"data": 2, "pipe": 2})), ("gate", None),
            ("classifier", {"tensor_parallel": True}),
            ("classifier", {"tensor_parallel": True, "zero1": True}),
            ("classifier", {})]
    ranks = launch(parallel_child, 4, "nccl", args=(jobs,))
    by_path = {}
    # this card's references
    init = init_of(VggForCifar10(10, device="cpu", generator=generator(0)))
    images, val = cifar.synthetic(VTRAIN), cifar.synthetic(VVAL, seed=1)
    RNG.set_seed(0)
    with deterministic(torch):
        serial = {(m, order): run_of(torch, vgg_serial(
            torch, init, images, m, val, order))
            for m, order in ((PMICRO, "1f1b"), (PMICRO, "gpipe"),
                             (2 * PMICRO, "1f1b"))}
    one = {}
    for schedule in ("1f1b", "gpipe"):
        _, step_ms, _, mem, _ = pipe_vgg_timed(torch, ops, init, images, 1,
                                               schedule)
        one[schedule] = (step_ms, mem)
    for (_, (schedule, axes)), results in zip(jobs[:3], zip(*ranks)):
        steps = PSTEPS
        label = f"parallel_cards vgg {schedule} {axes}"
        r0 = results[0]
        # hybrid: each replica's half of each microbatch is a microbatch
        # of the serial program (its running statistics the replicas'
        # mean: Top1 is not the serial program's)
        want = serial[(PMICRO * axes.get("data", 1), schedule)]
        held = held_pipe(torch, label, r0, want,
                         dict(rtol=LOSS_RTOL, atol=PARAM_ATOL))
        # every rank's pool geometries, each one the kernel phase holds
        geoms = {p for res in results for p in res["pools"]}
        held_standalone(label, types.SimpleNamespace(pools=geoms, s1=set(),
                                                     lrn=set()))
        for r, res in enumerate(results):
            if res["counts"]["fused_sgd"] != steps:
                raise AssertionError(f"{label}, rank {r}: launches "
                                     f"{ops_nonzero(res['counts'])}")
        pools = sum(res["counts"]["maxpool2d_backward"] for res in results)
        if pools != 5 * PMICRO * steps * axes.get("data", 1) or sum(
                res["counts"]["maxpool2d_forward"] for res in results) != pools:
            raise AssertionError(f"{label}: pool launches over the ranks "
                                 f"{[ops_nonzero(x['counts']) for x in results]}")
        ms1, mem1 = one[schedule]
        print(f"{label}: stages {r0['ranges']}; {PHELD_STEPS} steps "
              f"against the serial program on one card: {held}; Top1 "
              f"{r0['top1']}; steady state (the median of {STEADY_PAIRS} "
              f"pairs of calls of {PSHORT} and {steps} steps): "
              f"{r0['step_ms']:.4f} ms/step by rank "
              f"{[round(x['step_ms'], 4) for x in results]} (a call's set-up "
              f"{r0['setup_ms']:.4f} ms; "
              f"{VBATCH / r0['step_ms'] * 1e3:.1f} images/s; one card, "
              f"one stage: {ms1:.4f} ms/step, max_memory_allocated "
              f"{mem1} B); bubble of the schedule {r0['bubble']:.4f} (idle "
              f"ticks over ticks), peak microbatches in flight by rank "
              f"{[x['peak'] for x in results]}; max_memory_allocated by "
              f"rank {[x['mem'] for x in results]} B; device busy by rank "
              f"{[round(x['busy_ms'], 4) for x in results]} ms/step (NCCL's "
              f"kernels apart) over a profiled call of {PPROFILE} steps, of "
              f"its wall (its "
              f"set-up inside) {[round(x['window_ms'], 4) for x in results]}"
              f" ms/step: idle share by rank {idle_of(results)}; NCCL "
              f"kernels of rank 0 "
              f"{[(k, round(ms, 4), n) for k, ms, n in r0['nccl']]}; "
              f"launches by rank {[ops_nonzero(x['counts']) for x in results]}"
              f"; {len(geoms)} pool geometries, each held standalone; "
              f"tp_gathered_leaves "
              f"{r0['gathered']}; [{smi}]")
        by_path[f"parallel_cards_vgg_{schedule}_{len(axes)}"] = r0["counts"]
    for r, res in enumerate(ranks):
        dp, pp = (np.asarray(res[3]["losses"][k]) for k in ("dp", "dp_pp"))
        if not np.allclose(pp, dp, **GATE_TOL):
            raise AssertionError(f"gate, rank {r}: hybrid dp x pp losses {pp}"
                                 f" against plain DP's {dp}")
    print(f"parallel_cards gate: __graft_entry__.py's deterministic MLP, "
          f"hybrid dp x pp on {{'data': 2, 'pipe': 2}} losses "
          f"{ranks[0][3]['losses']['dp_pp']} against plain DP's "
          f"{ranks[0][3]['losses']['dp']} (rtol {GATE_TOL['rtol']}, atol "
          f"{GATE_TOL['atol']}); [{smi}]")
    # the classifier against LocalOptimizer on this card
    init = init_of(classifier_model("cpu", A_ONE_LAYERS,
                                    generator=generator(3)))
    train, _ = attention_docs(A_BATCH * (A_ONE_STEPS + 2) * 5 // 4, seed=1)
    local = classifier_run(torch, "cuda", init, train, A_BATCH,
                           max_iteration(2), layers=A_ONE_LAYERS,
                           dropout=0.0)
    warm_then_timed(torch, ops, local, A_ONE_STEPS)
    want = {"losses": [l for _, l in local.loss_log],
            "params": _params(torch, local.model)}
    torch.cuda.reset_peak_memory_stats()
    _, local_ms, _ = steady_ms(torch, ops, local, A_SHORT, A_LONG)
    local_mem = torch.cuda.max_memory_allocated()
    dp_mem = [res[6]["mem"] for res in ranks]
    for i, name in ((4, "tensor_parallel"), (5, "tensor_parallel zero1"),
                    (6, "data parallel")):
        results = [res[i] for res in ranks]
        for r, res in enumerate(results):
            if res["counts"]["fused_sgd"] != A_ONE_STEPS:
                raise AssertionError(f"{name}, rank {r}: launches "
                                     f"{ops_nonzero(res['counts'])}")
        held = held_bits(torch, f"classifier {name} on 4 cards",
                         results[0], want,
                         dict(rtol=LOSS_RTOL, atol=PARAM_ATOL))
        r0 = results[0]
        print(f"parallel_cards classifier {name} (rank 0 at "
              f"{r0['coords']}): depth "
              f"{A_ONE_LAYERS} at full width, global batch {A_BATCH} x T "
              f"{A_T}: held against LocalOptimizer over {2 + A_ONE_STEPS} "
              f"steps {held}; steady state (the median of {STEADY_PAIRS} "
              f"pairs of calls of {A_SHORT} and {A_LONG} steps) "
              f"{r0['step_ms']:.4f} ms/step by rank "
              f"{[round(x['step_ms'], 4) for x in results]} (a call's set-up "
              f"{r0['setup_ms']:.4f} ms; LocalOptimizer on one card "
              f"{local_ms:.4f}, max_memory_allocated {local_mem} B); "
              f"max_memory_allocated by rank over those steps "
              f"{[x['mem'] for x in results]} B (plain DP's {dp_mem}); "
              f"device busy by rank "
              f"{[round(x['busy_ms'], 4) for x in results]} ms/step (NCCL's "
              f"kernels apart) over a profiled call of {PPROFILE} steps, "
              f"of its wall "
              f"{[round(x['window_ms'], 4) for x in results]} ms/step: "
              f"idle share by rank {idle_of(results)}; NCCL "
              f"kernels of rank 0 "
              f"{[(k, round(ms, 4), n) for k, ms, n in r0['nccl']]}; "
              f"tp_gathered_leaves {r0['gathered']}; launches "
              f"{ops_nonzero(r0['counts'])}; [{smi}]")
        by_path[f"parallel_cards_classifier_{name.replace(' ', '_')}"] = \
            r0["counts"]
    return by_path


def phase_parallel_cards(torch, ops):
    """Tensor and pipeline parallelism across four cards
    (``parallel_cards``), where the machine has them."""
    smi = smi_line()
    if torch.cuda.device_count() < 4:
        print(f"parallel cards: {torch.cuda.device_count()} card(s): the "
              f"four-card tensor- and pipeline-parallel runs need four; "
              f"[{smi}]")
        return {}, {}
    from bigdl_tpu_torch.utils.engine import Engine

    try:
        return parallel_cards(torch, ops, smi), {}
    finally:
        Engine.reset()


# -- the dtype policy: the kernels' bf16 forms and bench.py's six
# configurations trained under BF16_COMPUTE ---------------------------------

BF16_FLOPS = 989e12               # H100 SXM data sheet, bf16 dense
# the pools the six configurations give the bf16 forms: LeNet-5's two at
# batch 256, VGG's five at 128, Inception-v1's four 3x3 s2 at 128 and
# ResNet-50's stem at 64 (bench.py:286-364); the stride-1 pools and LRNs
# are Inception's (INCEPTION_S1_POOLS, INCEPTION_LRNS)
BF16_S2_POOLS = ([((256, 6, 24, 24), (2, 2), (2, 2), ((0, 0), (0, 0))),
                  ((256, 12, 8, 8), (2, 2), (2, 2), ((0, 0), (0, 0)))]
                 + VGG_POOLS + INCEPTION_POOLS
                 + [((64,) + RESNET50_POOL[0][1:],) + RESNET50_POOL[1:]])
# (T, D, B, H, zx in bf16): small cases of either zx dtype, the Bi-LSTM
# configuration's width (zx bf16: BiRecurrent's projection), one
# direction (zx f32: Recurrent's) and the largest H (filled in at run
# time); lstm_scan at the classifier's width from a given state
BF16_BILSTM_CASES = [(7, 2, 3, 5, True), (9, 1, 4, 5, False),
                     (13, 2, 37, 100, True), (7, 2, 37, 203, False),
                     (2, 1, 3, None, True), (TSEQ, 2, TBATCH, THIDDEN, True),
                     (TSEQ, 1, TBATCH, THIDDEN, False)]
# the six configurations against FP32 on the card: the first step's loss
# from the same parameters and batch (BF16_LOSS_RTOL relative); against
# the CPU under the same policy at a small batch, dropout off: the first
# batch's loss (BF16_LOSS_RTOL), its whole-model gradient (||card - CPU||
# / ||CPU||, BF16_GRAD_RTOL), BF16_CHECK_STEPS steps' losses and the final
# parameters (BF16_PARAM_ATOL).  Each rounds a bf16 product's result at
# its own place (cuDNN against oneDNN): the limits are two bf16 ulps
# (1.6e-2) with room, as the CPU tests hold the port to JAX
BF16_LOSS_RTOL, BF16_GRAD_RTOL, BF16_PARAM_ATOL = 2e-2, 3e-2, 1e-3
BF16_CHECK_STEPS, BF16_LR = 2, 0.01
# the wrappers whose kernels have a bf16 form: their launches under the
# policy count as <name>_bf16
BF16_FORMS = ("maxpool2d_forward", "maxpool2d_backward",
              "maxpool2d_s1_forward", "maxpool2d_s1_backward",
              "lrn_forward", "lrn_backward", "bilstm_forward",
              "bilstm_backward", "lstm_scan", "rnn_forward", "rnn_backward")
# the rnn's bf16-weight form (Recurrent(RnnCell) under BF16_COMPUTE):
# (T, D, B, H, from h0, activation kind) at SimpleRNN's bptt-8 sequence
# from zeros and from an h0, and at (500, 2, 128, 128) under tanh (no
# pre-pass) and sigmoid (the pre-pass on the bf16 weight)
BF16_RNN_CASES = [(RSEQ, 1, RBATCH, RHIDDEN, False, "tanh"),
                  (RSEQ, 1, RBATCH, RHIDDEN, True, "tanh"),
                  (TSEQ, 2, TBATCH, THIDDEN, False, "tanh"),
                  (TSEQ, 2, TBATCH, THIDDEN, True, "sigmoid")]
# SimpleRNN under BF16_COMPUTE: steps of examples/train_rnn.py's defaults
BF16_RNN_STEPS = 8


def bench_configs():
    """bench.py's six configurations (bench.py:286-364) from the port's
    models: (label, build(device, generator), input shape, classes,
    records a batch, unit, steps a dispatch (bench.py:360-364), kernel
    launches a step besides fused_sgd, the CPU check's batch and depth).
    VGG's CPU
    check runs at 64 images: under BF16_COMPUTE its gradient moves with
    the last bits of an f32 sum (a bf16 rounding flips, and BN over a
    small batch spreads it), and at 8 images that alone parts two CPU
    runs past BF16_GRAD_RTOL (vgg_bf16_sensitivity.py)."""
    from bigdl_tpu_torch.models.inception import Inception_v1
    from bigdl_tpu_torch.models.lenet import LeNet5
    from bigdl_tpu_torch.models.resnet import ResNet
    from bigdl_tpu_torch.models.textclassifier import TextClassifierBiLSTM
    from bigdl_tpu_torch.models.transformer import TransformerClassifier
    from bigdl_tpu_torch.models.vgg import VggForCifar10

    def transformer(layers):
        return lambda dev, gen: TransformerClassifier(
            A_CLASSES, d_model=D_MODEL, n_heads=HEADS, n_layers=layers,
            hidden=HIDDEN, device=dev, generator=gen)

    pools = lambda n: {"maxpool2d_forward": n, "maxpool2d_backward": n}
    return [
        ("LeNet-5 bs256", lambda dev, gen: LeNet5(10, dev, gen),
         (256, 1, 28, 28), 10, 256, "images/s", 32, pools(2), (16, None)),
        ("VGG-16 bs128", lambda dev, gen: VggForCifar10(10, device=dev,
                                                        generator=gen),
         (128, 3, 32, 32), 10, 128, "images/s", 32, pools(5), (64, None)),
        ("Inception-v1 bs128", lambda dev, gen: Inception_v1(
            ICLASSES, device=dev, generator=gen),
         (128, 3, 224, 224), ICLASSES, 128, "images/s", 8,
         {**pools(4), "maxpool2d_s1_forward": 9, "maxpool2d_s1_backward": 9,
          "lrn_forward": 2, "lrn_backward": 2}, (2, None)),
        ("Bi-LSTM bs128 T500", lambda dev, gen: TextClassifierBiLSTM(
            TCLASSES, TEMBED, THIDDEN, device=dev, generator=gen),
         (TBATCH, TSEQ, TEMBED), TCLASSES, TBATCH * TSEQ, "tokens/s", 8,
         {"bilstm_forward": 1, "bilstm_backward": 1, "bilstm_dwh": 1},
         (4, None)),
        ("ResNet-50 bs64", lambda dev, gen: ResNet(50, ICLASSES, device=dev,
                                                   generator=gen),
         (64, 3, 224, 224), ICLASSES, 64, "images/s", 8, pools(1),
         (2, None)),
        ("Transformer-enc bs16 T512 d1024", transformer(LAYERS),
         (A_BATCH, A_T, D_MODEL), A_CLASSES, A_BATCH * A_T, "tokens/s", 8,
         {}, (2, transformer(A_CHECK_LAYERS))),
    ]


def bf16_name(name):
    return f"{name}_bf16" if name in BF16_FORMS else name


def bf16_ulps(torch, a, b):
    """The largest |a - b| in bf16 ulps of the larger magnitude of the
    two (0 where both are 0)."""
    a, b = a.float(), b.float()
    big = torch.maximum(a.abs(), b.abs())
    ulp = torch.ldexp(torch.ones_like(big), torch.frexp(big).exponent - 8)
    return float(((a - b).abs() / ulp).max())


def held_ulps(torch, name, got, want, limit):
    """``got`` within ``limit`` bf16 ulps of ``want`` (0: bit for bit);
    returns the largest |got - want|."""
    if limit == 0:
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: not bit for bit")
    elif bf16_ulps(torch, got, want) > limit:
        raise AssertionError(f"{name}: {bf16_ulps(torch, got, want)} bf16 "
                             f"ulps from the plain version, limit {limit}")
    return float((got.float() - want.float()).abs().max())


def bf16_tied(torch, g, shape):
    """N(0, 1) rounded to halves, in bf16: ties in every window."""
    return (torch.randn(shape, generator=g, device="cuda").mul_(2).round_()
            .div_(2).bfloat16())


def pool_bwd_in_gather_order(torch, arg, gy, win, st, pads, xshape):
    """The any-stride pool's backward as the gather kernels sum it (and
    the one-thread-an-element bf16 kernel before the staged one did):
    each dx the g of its covering outputs whose argmax names it, added
    in (oh, ow) order in f32 from 0.0f, rounded to g's dtype once.  For
    one element the outputs in (oh, ow) order are its taps (i, j) in
    descending order, so the windows' taps are added tap by tap from
    (kh - 1, kw - 1) down, each onto the frame's strided view (+0.0f
    where the argmax names another tap: x + 0.0f == x)."""
    (kh, kw), (sh, sw) = win, st
    (plh, phh), (plw, phw) = pads
    n, c, h, w = xshape
    oh, ow = arg.shape[2:]
    frame = torch.zeros(n, c, h + plh + phh + kh, w + plw + phw + kw,
                        device=gy.device)
    g32 = gy.float()
    for i in reversed(range(kh)):
        for j in reversed(range(kw)):
            frame[:, :, i:i + sh * oh:sh, j:j + sw * ow:sw] += torch.where(
                arg == i * kw + j, g32, torch.zeros_like(g32))
    return frame[:, :, plh:plh + h, plw:plw + w].to(gy.dtype)


def pool_bwd_plan_line(ops, shape, win, st, pads, dtype):
    """The plan the built library takes for the any-stride pool's
    backward of ``dtype`` at ``shape``; one line."""
    p = ops.maxpool.kernel_plan(shape, win, st, pads, dtype)
    how = (f"staged, {p['planes']} planes a block, {p['rows']} rows a tile, "
           f"{p['smem_bytes']} B" if p["staged"] else "through L1")
    loop = f"{p['mr']}x{p['mc']} unrolled" if p["mr"] else "any window"
    return (f"maxpool2d_backward {str(dtype).replace('torch.', '')} plan "
            f"{shape} {win[0]}x{win[1]} s{st[0]}: {how}, {p['threads']} "
            f"threads, {loop}"), p


def check_pool_bf16(torch, ops, g, shape, win, st, pads):
    """The bf16 form of the any-stride pool against its plain version on
    tied inputs: y, the primal y and the argmax bit for bit; dx bit for
    bit where windows do not overlap, within one bf16 ulp where they do,
    and bit for bit against the sum in the gather's (oh, ow) order (what
    the one-thread-an-element bf16 kernel wrote); the autograd path the
    wrappers' bits; the backward's plan printed (staged).  Returns
    (forward error, backward error)."""
    x = bf16_tied(torch, g, shape)
    y, arg = ops.maxpool2d_forward(x, win, st, pads)
    y_only = ops.maxpool2d_forward(x, win, st, pads, with_argmax=False)
    y_ref, arg_ref = ops.maxpool2d_forward_reference(x, win, st, pads)
    gy = torch.randn(y.shape, generator=g, device="cuda").bfloat16()
    dx = ops.maxpool2d_backward(arg, gy, win, st, pads, shape)
    dx_ref = ops.maxpool2d_backward_reference(arg_ref, gy, win, st, pads,
                                              shape)
    xg = x.clone().requires_grad_()
    ops.maxpool2d(xg, win, st, pads).backward(gy)
    torch.cuda.synchronize()
    name = f"maxpool2d bf16 {shape} {win} s{st}"
    e_f = held_ulps(torch, name + " y", y, y_ref, 0)
    held_ulps(torch, name + " primal y", y_only, y, 0)
    if not torch.equal(arg, arg_ref):
        raise AssertionError(f"{name}: the argmax differs")
    overlap = win[0] > st[0] or win[1] > st[1]
    e_b = held_ulps(torch, name + " dx", dx, dx_ref, 1 if overlap else 0)
    held_ulps(torch, name + " autograd dx", xg.grad, dx, 0)
    held_ulps(torch, name + " dx against the (oh, ow)-order sum", dx,
              pool_bwd_in_gather_order(torch, arg, gy, win, st, pads,
                                       shape), 0)
    line, plan = pool_bwd_plan_line(ops, shape, win, st, pads,
                                    torch.bfloat16)
    print(line)
    if not plan["staged"]:
        raise AssertionError(f"{name}: the backward is not staged")
    return e_f, e_b


def pool_times_bf16(torch, ops, flush, g, shape, win, st, pads):
    """The bf16 form's forward (with argmax) and backward rows: kernel,
    plain and library (``F.max_pool2d`` on bf16 with indices, and its
    backward) times; bounds: x read, y (2 bytes) and the argmax (4)
    written; g and the argmax read, dx written."""
    import torch.nn.functional as F

    x = torch.randn(shape, generator=g, device="cuda").bfloat16()
    y, arg = ops.maxpool2d_forward(x, win, st, pads)
    gy = torch.randn(y.shape, generator=g, device="cuda").bfloat16()
    (plh, phh), (plw, phw) = pads
    ceil = phh > plh or phw > plw
    lib = dict(kernel_size=win, stride=st, padding=(plh, plw),
               ceil_mode=ceil)
    y_lib, idx = F.max_pool2d(x, return_indices=True, **lib)
    if not torch.equal(y_lib, y):
        raise AssertionError("F.max_pool2d on bf16 is not the same pool")
    fwd = timed(torch, flush,
                lambda: ops.maxpool2d_forward(x, win, st, pads),
                lambda: ops.maxpool2d_forward_reference(x, win, st, pads),
                lambda: F.max_pool2d(x, return_indices=True, **lib))
    bwd = timed(
        torch, flush,
        lambda: ops.maxpool2d_backward(arg, gy, win, st, pads, shape),
        lambda: ops.maxpool2d_backward_reference(arg, gy, win, st, pads,
                                                 shape),
        lambda: torch.ops.aten.max_pool2d_with_indices_backward(
            gy, x, win, st, (plh, plw), (1, 1), ceil, idx))
    for row in (fwd, bwd):
        row.update(byte_bound(2 * x.numel() + 6 * y.numel(), 0))
    return fwd, bwd


def check_pool_s1_bf16(torch, ops, g, shape, win, pads):
    """The stride-1 pool's bf16 form against its plain version on tied
    inputs: y bit for bit (and the any-stride form's y); dx within one
    bf16 ulp (3x3 windows overlap); y and dx bit for bit against the
    unstaged bf16 kernels (the form's kernels before it was staged); the
    autograd path the wrappers' bits; the plan (the mirror held to the
    library's) staged."""
    x = bf16_tied(torch, g, shape)
    y = ops.maxpool2d_s1_forward(x, win, pads)
    y_ref = ops.maxpool2d_s1_forward_reference(x, win, pads)
    y_any = ops.maxpool2d_forward(x, win, (1, 1), pads, with_argmax=False)
    gy = torch.randn(y.shape, generator=g, device="cuda").bfloat16()
    dx = ops.maxpool2d_s1_backward(x, gy, win, pads)
    dx_ref = ops.maxpool2d_s1_backward_reference(x, gy, win, pads)
    xg = x.clone().requires_grad_()
    ops.maxpool2d_s1(xg, win, pads).backward(gy)
    torch.cuda.synchronize()
    name = f"maxpool2d_s1 bf16 {shape} {win}"
    e_f = held_ulps(torch, name + " y", y, y_ref, 0)
    held_ulps(torch, name + " any-stride y", y_any, y, 0)
    e_b = held_ulps(torch, name + " dx", dx, dx_ref, 1)
    held_ulps(torch, name + " autograd dx", xg.grad, dx, 0)
    s1 = ops.maxpool_s1
    held_ulps(torch, name + " y against the unstaged kernel", y,
              s1.unstaged_forward(x, win, pads), 0)
    held_ulps(torch, name + " dx against the unstaged kernel", dx,
              s1.unstaged_backward(x, gy, win, pads), 0)
    print(pool_s1_plan_line(ops, shape, win, pads, torch.bfloat16))
    for bwd in (False, True):
        if s1.plan(shape, win, pads, bwd, torch.bfloat16)["path"] == "direct":
            raise AssertionError(f"{name}: the bf16 plan is unstaged")
    return e_f, e_b


def pool_s1_times_bf16(torch, ops, flush, g, shape, win, pads):
    """The stride-1 bf16 form's rows; library ``F.max_pool2d`` on bf16
    with indices and its backward; bounds at 2 bytes an element."""
    import torch.nn.functional as F

    (plh, _), (plw, _) = pads
    x = torch.randn(shape, generator=g, device="cuda").bfloat16()
    y = ops.maxpool2d_s1_forward(x, win, pads)
    gy = torch.randn(y.shape, generator=g, device="cuda").bfloat16()
    lib = dict(kernel_size=win, stride=1, padding=(plh, plw))
    _, idx = F.max_pool2d(x, return_indices=True, **lib)
    taps = win[0] * win[1]
    fwd = timed(torch, flush, lambda: ops.maxpool2d_s1_forward(x, win, pads),
                lambda: ops.maxpool2d_s1_forward_reference(x, win, pads),
                lambda: F.max_pool2d(x, return_indices=True, **lib))
    fwd.update(byte_bound(2 * (x.numel() + y.numel()), taps * y.numel()))
    bwd = timed(
        torch, flush, lambda: ops.maxpool2d_s1_backward(x, gy, win, pads),
        lambda: ops.maxpool2d_s1_backward_reference(x, gy, win, pads),
        lambda: torch.ops.aten.max_pool2d_with_indices_backward(
            gy, x, win, (1, 1), (plh, plw), (1, 1), False, idx))
    bwd.update(byte_bound(2 * (2 * x.numel() + y.numel()),
                          taps * (y.numel() + 2 * x.numel())))
    return fwd, bwd


def check_lrn_bf16(torch, ops, g, shape, hyper):
    """The LRN's bf16 form against its plain version: y and dx within one
    bf16 ulp, z (f32) within LRN_FWD_TOL, the primal y and the autograd
    path the wrappers' bits."""
    x = torch.randn(shape, generator=g, device="cuda").bfloat16()
    gy = torch.randn(shape, generator=g, device="cuda").bfloat16()
    y, z = ops.lrn_forward(x, *hyper)
    y_only = ops.lrn_forward(x, *hyper, with_z=False)
    y_ref, z_ref = ops.lrn_forward_reference(x, *hyper)
    dx = ops.lrn_backward(x, z, gy, *hyper)
    dx_ref = ops.lrn_backward_reference(x, z_ref, gy, *hyper)
    xg = x.clone().requires_grad_()
    ops.lrn_channel(xg, *hyper).backward(gy)
    torch.cuda.synchronize()
    name = f"lrn bf16 {shape}"
    if z.dtype != torch.float32:
        raise AssertionError(f"{name}: z is {z.dtype}")
    torch.testing.assert_close(z, z_ref, **LRN_FWD_TOL)
    e_f = held_ulps(torch, name + " y", y, y_ref, 1)
    held_ulps(torch, name + " primal y", y_only, y, 0)
    e_b = held_ulps(torch, name + " dx", dx, dx_ref, 1)
    held_ulps(torch, name + " autograd dx", xg.grad, dx, 0)
    return e_f, e_b


def lrn_times_bf16(torch, ops, flush, g, shape, hyper):
    """The LRN's bf16 rows; library ``F.local_response_norm`` on bf16 and
    its backward; bounds: x read, y written (2 bytes), z written (4);
    backward x, g read, dx written (2), z read (4); operations as the f32
    rows'."""
    import torch.nn.functional as F

    size, alpha, beta, k = hyper
    x = torch.randn(shape, generator=g, device="cuda").bfloat16()
    gy = torch.randn(shape, generator=g, device="cuda").bfloat16()
    _, z = ops.lrn_forward(x, *hyper)
    xl = x.clone().requires_grad_()
    yl = F.local_response_norm(xl, size, alpha, beta, k)
    n = x.numel()
    fwd = timed(torch, flush, lambda: ops.lrn_forward(x, *hyper),
                lambda: ops.lrn_forward_reference(x, *hyper),
                lambda: F.local_response_norm(x, size, alpha, beta, k))
    fwd.update(byte_bound(8 * n, (2 * size + 6) * n))
    bwd = timed(torch, flush, lambda: ops.lrn_backward(x, z, gy, *hyper),
                lambda: ops.lrn_backward_reference(x, z, gy, *hyper),
                lambda: torch.autograd.grad(yl, xl, gy, retain_graph=True))
    bwd.update(byte_bound(10 * n, (size + 11) * n))
    return fwd, bwd


def bf16_bilstm_inputs(torch, g, t, nd, b, h, zx_bf16):
    zx, wht, gout = bilstm_inputs(torch, g, t, nd, b, h)
    return (zx.bfloat16() if zx_bf16 else zx), wht.bfloat16(), gout


def check_bilstm_bf16(torch, ops, g, case):
    """The recurrence's bf16 forms against the plain versions: the
    forward's h and c, the backward's dzx and the weight gradient, each
    by ``held`` (within the f32 tolerances, or no further from a float64
    run on the same bf16 operands, exact in float64, than twice the
    plain version); the autograd path is the wrappers' bits, its
    gradients cast to zx's and wht's dtypes."""
    *shape, zx_bf16 = case
    zx, wht, gout = bf16_bilstm_inputs(torch, g, *shape, zx_bf16)
    hs, cs = ops.bilstm_forward(zx, wht)
    h_only = ops.bilstm_forward(zx, wht, with_c=False)
    dzx = ops.bilstm_backward(zx, wht, hs, cs, gout)
    dwh = ops.bilstm_dwh(hs, dzx)
    zg, wg = zx.clone().requires_grad_(), wht.clone().requires_grad_()
    ops.bilstm_recurrence(zg, wg).backward(gout)
    torch.cuda.synchronize()
    if not (torch.equal(h_only, hs) and torch.equal(zg.grad, dzx.to(zx.dtype))
            and torch.equal(wg.grad, dwh.to(wht.dtype))
            and hs.dtype == dzx.dtype == torch.float32):
        raise AssertionError(f"bilstm bf16 {case}: the primal forward or the "
                             f"autograd path differs from the wrappers")
    hs_p, cs_p = ops.bilstm_forward_reference(zx, wht)
    dzx_p = ops.bilstm_backward_reference(zx, wht, hs, cs, gout)
    dwh_p = ops.bilstm_dwh_reference(hs, dzx)
    z64, w64, h64, c64 = zx.double(), wht.double(), hs.double(), cs.double()
    hs_64, cs_64 = ops.bilstm_forward_reference(z64, w64)
    dzx_64 = ops.bilstm_backward_reference(z64, w64, h64, c64, gout.double())
    dwh_64 = ops.bilstm_dwh_reference(h64, dzx.double())
    name = f"bilstm bf16 {case}"
    return {"h": held(torch, name + " h", hs, hs_p, hs_64, BILSTM_FWD_TOL),
            "c": held(torch, name + " c", cs, cs_p, cs_64, BILSTM_FWD_TOL),
            "dzx": held(torch, name + " dzx", dzx, dzx_p, dzx_64,
                        BILSTM_BWD_TOL),
            "dwh": held(torch, name + " dwh", dwh, dwh_p, dwh_64,
                        BILSTM_BWD_TOL)}


def check_lstm_scan_bf16(torch, ops, g):
    """``lstm_scan`` on a bf16 wht (zx f32, Recurrent's route) from a
    given state against its plain version by ``held``, and from zero
    state the bits of ``bilstm_forward``'s bf16 form at D = 1."""
    zx, wht, _ = bf16_bilstm_inputs(torch, g, TSEQ, 1, TBATCH, THIDDEN,
                                    False)
    h0 = torch.randn(TBATCH, THIDDEN, generator=g, device="cuda") * 0.5
    c0 = torch.randn(TBATCH, THIDDEN, generator=g, device="cuda") * 0.5
    hs = ops.lstm_scan(zx[:, 0], wht[0], h0, c0)
    hs_p = ops.lstm_scan_reference(zx[:, 0], wht[0], h0, c0)
    hs_64 = ops.lstm_scan_reference(zx[:, 0].double(), wht[0].double(),
                                    h0.double(), c0.double())
    zero = torch.zeros_like(h0)
    if not torch.equal(ops.lstm_scan(zx[:, 0], wht[0], zero, zero),
                       ops.bilstm_forward(zx, wht, with_c=False)[:, 0]):
        raise AssertionError("lstm_scan bf16 from zero state is not "
                             "bilstm_forward's bits")
    return held(torch, "lstm_scan bf16 h", hs, hs_p, hs_64, BILSTM_FWD_TOL)


def bilstm_times_bf16(torch, ops, flush, g):
    """The recurrence's bf16 rows at the Bi-LSTM configuration's width
    (zx bf16): forward (with c) and backward.  Bounds: forward zx (2
    bytes) and wht (2) read, hs and cs (4) written; backward zx, wht,
    hs, cs and gout read, dzx (4) written; the recurrent products at the
    bf16 dense peak (the gate arithmetic left out)."""
    case = (TSEQ, 2, TBATCH, THIDDEN)
    zx, wht, gout = bf16_bilstm_inputs(torch, g, *case, True)
    hs, cs = ops.bilstm_forward(zx, wht)
    n_h, n_w = hs.numel(), wht.numel()
    flops = 2 * n_h * 4 * THIDDEN
    rows = {
        "forward": (lambda: ops.bilstm_forward(zx, wht),
                    lambda: ops.bilstm_forward_reference(zx, wht),
                    2 * 4 * n_h + 2 * n_w + 4 * 2 * n_h, flops),
        "backward": (lambda: ops.bilstm_backward(zx, wht, hs, cs, gout),
                     lambda: ops.bilstm_backward_reference(zx, wht, hs, cs,
                                                           gout),
                     2 * 4 * n_h + 2 * n_w + 4 * 3 * n_h + 4 * 4 * n_h,
                     2 * flops)}
    out = {}
    for name, (kernel, plain, nbytes, n_ops) in rows.items():
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = n_ops / BF16_FLOPS * 1e3
        out[name] = {"ms": time_ms(torch, kernel, flush),
                     "plain_ms": yard_ms(torch, plain, flush, reps=5),
                     "queued_ms": time_queued_ms(torch, kernel),
                     "library_ms": None, "bound_ms": max(t_bytes, t_ops),
                     "bytes": nbytes,
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations"}
    return out


def bf16_layer_times(torch, flush, g):
    """The yardstick the port never calls: cuDNN's bidirectional
    ``nn.LSTM`` in bf16 at the configuration's width beside the port's
    ``BiRecurrent`` under BF16_COMPUTE (its bf16 kernels), forward
    (autograd on) and backward ms over one (128, 500, 200) batch."""
    from bigdl_tpu_torch import tensor as bt
    from bigdl_tpu_torch.nn import BiRecurrent, LSTMCell
    from bigdl_tpu_torch.utils.random import generator

    gen = generator(3)
    port = BiRecurrent(*[LSTMCell(TEMBED, THIDDEN, device="cuda",
                                  generator=gen) for _ in range(2)])
    lib = torch.nn.LSTM(TEMBED, THIDDEN, batch_first=True,
                        bidirectional=True).cuda().bfloat16()
    lib.flatten_parameters()
    x = torch.randn(TBATCH, TSEQ, TEMBED, generator=g, device="cuda")
    gy = torch.randn(TBATCH, TSEQ, 2 * THIDDEN, generator=g, device="cuda")
    xb, gb = x.bfloat16().requires_grad_(), gy.bfloat16()
    xp = x.clone().requires_grad_()
    bt.set_policy(bt.BF16_COMPUTE)
    try:
        yl, yp = lib(xb)[0], port(xp)
        return {"library_fwd_ms": yard_ms(torch, lambda: lib(xb), flush),
                "port_fwd_ms": yard_ms(torch, lambda: port(xp), flush),
                "library_bwd_ms": yard_ms(torch, lambda: torch.autograd.grad(
                    yl, [xb, *lib.parameters()], gb, retain_graph=True),
                    flush),
                "port_bwd_ms": yard_ms(torch, lambda: torch.autograd.grad(
                    yp, [xp, *port.parameters()], gy, retain_graph=True),
                    flush)}
    finally:
        bt.set_policy(bt.FP32)


def check_rnn_bf16(torch, ops, g, case):
    """The rnn's bf16-weight form (zx f32, wht bf16) against its plain
    version by ``held`` (within the f32 tolerances, or no further from a
    float64 run on the same bf16 weight, exact in float64, than twice the
    plain version): the forward's h, the backward's dzx and the weight
    gradient; the autograd path is the wrappers' bits, its weight
    gradient cast to bf16."""
    t, nd, b, h, with_h0, kind = case
    act = ops.Act(kind)
    zx, wht, gout, h0 = rnn_inputs(torch, g, t, nd, b, h, with_h0)
    wht = wht.bfloat16()
    hs = ops.rnn_forward(zx, wht, h0, act)
    dzx = ops.rnn_backward(wht, hs, gout, act, zx, h0)
    dwh = ops.rnn_dwh(hs, dzx, h0)
    zg, wg = zx.clone().requires_grad_(), wht.clone().requires_grad_()
    y = ops.rnn_recurrence(zg, wg, h0, act)
    y.backward(gout)
    torch.cuda.synchronize()
    if not (torch.equal(y, hs) and torch.equal(zg.grad, dzx)
            and torch.equal(wg.grad, dwh.bfloat16())
            and hs.dtype == dzx.dtype == dwh.dtype == torch.float32):
        raise AssertionError(f"rnn bf16 {case}: the autograd path differs "
                             f"from the wrappers")
    d64 = lambda v: None if v is None else v.double()
    z64, w64, h64, g64 = zx.double(), wht.double(), hs.double(), gout.double()
    name = f"rnn bf16 {case}"
    return {"h": held(torch, name + " h", hs,
                      ops.rnn_forward_reference(zx, wht, h0, act),
                      ops.rnn_forward_reference(z64, w64, d64(h0), act),
                      BILSTM_FWD_TOL),
            "dzx": held(torch, name + " dzx", dzx,
                        ops.rnn_backward_reference(wht, hs, gout, act, zx, h0),
                        ops.rnn_backward_reference(w64, h64, g64, act, z64,
                                                   d64(h0)),
                        BILSTM_BWD_TOL),
            "dwh": held(torch, name + " dwh", dwh,
                        ops.rnn_dwh_reference(hs, dzx, h0),
                        ops.rnn_dwh_reference(h64, dzx.double(), d64(h0)),
                        BILSTM_BWD_TOL)}


def rnn_times_bf16(torch, ops, flush, g, case):
    """The rnn bf16 form's forward and backward rows at ``case`` (tanh,
    from zeros).  Bounds: forward zx (4 bytes) and wht (2) read, hs (4)
    written; backward wht, hs and gout read, dzx written; the recurrent
    product at the bf16 dense peak (tanh left out)."""
    zx, wht, gout, _ = rnn_inputs(torch, g, *case, False)
    wht = wht.bfloat16()
    hs = ops.rnn_forward(zx, wht)
    n_h, n_w = hs.numel(), wht.numel()
    flops = 2 * n_h * case[3]
    out = {}
    for name, kernel, plain, nbytes in (
            ("forward", lambda: ops.rnn_forward(zx, wht),
             lambda: ops.rnn_forward_reference(zx, wht),
             4 * 2 * n_h + 2 * n_w),
            ("backward", lambda: ops.rnn_backward(wht, hs, gout),
             lambda: ops.rnn_backward_reference(wht, hs, gout),
             4 * 3 * n_h + 2 * n_w)):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOPS * 1e3
        out[name] = {"ms": time_ms(torch, kernel, flush),
                     "plain_ms": yard_ms(torch, plain, flush, reps=5),
                     "queued_ms": time_queued_ms(torch, kernel),
                     "library_ms": None, "bound_ms": max(t_bytes, t_ops),
                     "bytes": nbytes,
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations"}
    return out


def rnn_bf16_layer_times(torch, flush, g):
    """The yardstick the port never calls: cuDNN's ``nn.RNN`` (tanh) in
    bf16 at the classifier's width (batch 128, T 500, 200 -> 128), with
    the port's ``Recurrent(RnnCell)`` weights, beside that layer under
    BF16_COMPUTE (the rnn's bf16-weight form): forward (autograd on) and
    backward ms, and how far apart their outputs are."""
    from bigdl_tpu_torch import tensor as bt
    from bigdl_tpu_torch.nn import Recurrent, RnnCell
    from bigdl_tpu_torch.utils.random import generator

    port = Recurrent().add(RnnCell(TEMBED, THIDDEN, device="cuda",
                                   generator=generator(5)))
    lib = torch.nn.RNN(TEMBED, THIDDEN, nonlinearity="tanh",
                       batch_first=True).cuda()
    with torch.no_grad():
        cell = port.cell
        for mine, theirs in ((cell.i2h, "weight_ih_l0"),
                             (cell.h2h, "weight_hh_l0"),
                             (cell.bias_i, "bias_ih_l0"),
                             (cell.bias_h, "bias_hh_l0")):
            getattr(lib, theirs).copy_(mine)
    lib = lib.bfloat16()
    lib.flatten_parameters()   # else cuDNN compacts the weights every call
    x = torch.randn(TBATCH, TSEQ, TEMBED, generator=g, device="cuda")
    gy = torch.randn(TBATCH, TSEQ, THIDDEN, generator=g, device="cuda")
    xb, gb = x.bfloat16().requires_grad_(), gy.bfloat16()
    xp = x.clone().requires_grad_()
    bt.set_policy(bt.BF16_COMPUTE)
    try:
        yl, yp = lib(xb)[0], port(xp)
        return {"same_layer_diff": float((yl.float() - yp).detach().abs()
                                         .max()),
                "library_fwd_ms": yard_ms(torch, lambda: lib(xb), flush),
                "port_fwd_ms": yard_ms(torch, lambda: port(xp), flush),
                "library_bwd_ms": yard_ms(torch, lambda: torch.autograd.grad(
                    yl, [xb, *lib.parameters()], gb, retain_graph=True),
                    flush),
                "port_bwd_ms": yard_ms(torch, lambda: torch.autograd.grad(
                    yp, [xp, *port.parameters()], gy, retain_graph=True),
                    flush)}
    finally:
        bt.set_policy(bt.FP32)


def phase_rnn_bf16(torch, ops, g, flush):
    """The rnn's bf16-weight form at BF16_RNN_CASES by ``check_rnn_bf16``,
    each case's plans (the mirror held to the library's), H one past
    MAX_HIDDEN refused on a bf16 weight, the rows at (500, 2, 128, 128)
    with cuDNN's bf16 ``nn.RNN`` as the layer's yardstick; returns
    ({row name: row}, {row name: max_abs_err})."""
    from bigdl_tpu_torch.ops import rnn

    errs = {case: check_rnn_bf16(torch, ops, g, case)
            for case in BF16_RNN_CASES}
    print_errs("rnn bf16", errs)
    for t, nd, b, h, *_ in BF16_RNN_CASES:
        for cell, bwd in (("RnnFwdBf16", False), ("RnnBwdBf16", True)):
            cluster_plan_line(f"rnn bf16 {(t, nd, b, h)} {cell}", "rnn_bf16",
                              cell,
                              rnn.plan(nd, b, h, bwd, torch.bfloat16),
                              rnn.kernel_plan(nd, b, h, bwd, torch.bfloat16),
                              nd, b)
    h = rnn.MAX_HIDDEN + 1
    refused(torch, f"rnn bf16 H={h}", lambda: ops.rnn_forward(
        torch.zeros(2, 1, 3, h, device="cuda"),
        torch.zeros(1, h, h, device="cuda", dtype=torch.bfloat16)))
    full = (TSEQ, 2, TBATCH, THIDDEN)
    rows = rnn_times_bf16(torch, ops, flush, g, full)
    layer = rnn_bf16_layer_times(torch, flush, g)
    for name, key in (("forward", "fwd"), ("backward", "bwd")):
        rows[name]["layer_library_ms"] = layer[f"library_{key}_ms"]
        rows[name]["layer_port_ms"] = layer[f"port_{key}_ms"]
    print_rows("rnn_bf16", full, rows)
    print(f"rnn bf16 layer (128, 500, 200) -> (128, 500, 128): port "
          f"Recurrent(RnnCell) under BF16_COMPUTE forward "
          f"{layer['port_fwd_ms']:.5f} ms, backward "
          f"{layer['port_bwd_ms']:.5f} ms; cuDNN bf16 nn.RNN forward "
          f"{layer['library_fwd_ms']:.5f} ms, backward "
          f"{layer['library_bwd_ms']:.5f} ms; outputs "
          f"{layer['same_layer_diff']:.3e} apart (cuDNN rounds its "
          f"projection and h to bf16)")
    return ({f"rnn_{name}": row for name, row in rows.items()},
            {"rnn_forward": max(r["h"]["err"] for r in errs.values()),
             "rnn_backward": max(r["dzx"]["err"] for r in errs.values())})


def phase_bf16_kernels(torch, ops):
    """The bf16 forms of the pool, stride-1 pool, LRN, LSTM and RNN
    kernels against their plain versions at the shapes the six
    configurations (and SimpleRNN) give them, the staged pools also bit
    for bit against the outputs of the kernels they replaced (the
    unstaged stride-1 kernels, the (oh, ow)-order sum) with their plans
    printed, timed (L2 flushed,
    median of 25) beside their bounds, the plain versions and the library
    calls; H one past MAX_HIDDEN refused on a bf16 weight too."""
    from bigdl_tpu_torch.ops import bilstm

    g = torch.Generator(device="cuda").manual_seed(19)
    flush = torch.empty(64 * 2**20, device="cuda")   # 256 MB > 50 MB L2
    errs = {name: [0.0] for name in BF16_FORMS}
    rows, sums = {}, {}
    for case in BF16_S2_POOLS:
        e_f, e_b = check_pool_bf16(torch, ops, g, *case)
        errs["maxpool2d_forward"].append(e_f)
        errs["maxpool2d_backward"].append(e_b)
    for case in INCEPTION_POOLS:
        for name, row in zip(("forward", "backward"),
                             pool_times_bf16(torch, ops, flush, g, *case)):
            print_pool_row(f"maxpool2d_{name}_bf16", case, row)
            step_sum(sums, f"maxpool2d_{name}", row, 1)
            rows.setdefault(f"maxpool2d_{name}", row)   # the first: 3x3 s2
    for case in [c[:3] for c in INCEPTION_S1_POOLS] + [INCEPTION_V2_S1]:
        e_f, e_b = check_pool_s1_bf16(torch, ops, g, *case)
        errs["maxpool2d_s1_forward"].append(e_f)
        errs["maxpool2d_s1_backward"].append(e_b)
    for *case, n in INCEPTION_S1_POOLS:
        for name, row in zip(("forward", "backward"),
                             pool_s1_times_bf16(torch, ops, flush, g, *case)):
            print_pool_row(f"maxpool2d_s1_{name}_bf16",
                           (case[0], case[1], None, case[2]), row)
            step_sum(sums, f"maxpool2d_s1_{name}", row, n)
            if case[0] == S1_CASES[4][0]:
                rows[f"maxpool2d_s1_{name}"] = row
    for case in INCEPTION_LRNS:
        e_f, e_b = check_lrn_bf16(torch, ops, g, *case)
        errs["lrn_forward"].append(e_f)
        errs["lrn_backward"].append(e_b)
        for name, row in zip(("forward", "backward"),
                             lrn_times_bf16(torch, ops, flush, g, *case)):
            print_pool_row(f"lrn_{name}_bf16", (case[0], (5, 5), None, "-"),
                           row)
            step_sum(sums, f"lrn_{name}", row, 1)
            rows[f"lrn_{name}"] = row   # the last: Inception-v1's 2nd
    for name in ("maxpool2d_forward", "maxpool2d_backward",
                 "maxpool2d_s1_forward", "maxpool2d_s1_backward",
                 "lrn_forward", "lrn_backward"):
        rows[name] = dict(rows[name], **sums[name])
        print(f"{name}_bf16: Inception-v1's step, "
              f"{sums[name]['inception_launches_step']} launches: kernel "
              f"{sums[name]['inception_ms']:.5f} ms, bound "
              f"{sums[name]['inception_bound_ms']:.5f} ms, library "
              f"{sums[name]['inception_library_ms']:.5f} ms")
    cases = [c if c[3] is not None else c[:3] + (bilstm.MAX_HIDDEN, c[4])
             for c in BF16_BILSTM_CASES]
    rec_errs = {case: check_bilstm_bf16(torch, ops, g, case)
                for case in cases}
    print_errs("bilstm bf16", rec_errs)
    for t, nd, b, h, _ in cases:
        for bwd in (False, True):
            plan = bilstm.plan(nd, b, h, bwd, dtype=torch.bfloat16)
            got = bilstm.kernel_plan(nd, b, h, bwd, dtype=torch.bfloat16)
            if plan != got:
                raise AssertionError(f"bilstm bf16 plan at {(nd, b, h)} "
                                     f"bwd={bwd}: the mirror's {plan}, the "
                                     f"library's {got}")
            print(f"bilstm bf16 {(t, nd, b, h)} {'LstmBwdBf16' if bwd else 'LstmFwdBf16'}: "
                  f"C={plan['C']} R={plan['R']} RT={plan['RT']} "
                  f"KP={plan['KP']} depth={plan['depth']} weight "
                  f"{'in shared memory' if plan['staged'] else 'through L2'} "
                  f"smem={plan['bytes']} B")
    scan = check_lstm_scan_bf16(torch, ops, g)
    print(f"lstm_scan bf16 (T {TSEQ}, B {TBATCH}, H {THIDDEN}) from h0, c0: "
          f"max_abs_err={scan['err']:.3e} ({scan['rule']}; vs float64 card "
          f"{scan['card_vs_64']:.3e} plain {scan['plain_vs_64']:.3e}); from "
          f"zero state bilstm_forward's bits")
    h = bilstm.MAX_HIDDEN + 1
    refused(torch, f"bilstm bf16 H={h}", lambda: ops.bilstm_forward(
        torch.zeros(2, 1, 3, 4 * h, device="cuda", dtype=torch.bfloat16),
        torch.zeros(1, h, 4 * h, device="cuda", dtype=torch.bfloat16)))
    rec = bilstm_times_bf16(torch, ops, flush, g)
    layer = bf16_layer_times(torch, flush, g)
    for name, key in (("forward", "fwd"), ("backward", "bwd")):
        rec[name]["layer_library_ms"] = layer[f"library_{key}_ms"]
        rec[name]["layer_port_ms"] = layer[f"port_{key}_ms"]
        rows[f"bilstm_{name}"] = rec[name]
    print_rows("bilstm_bf16", (TSEQ, 2, TBATCH, THIDDEN), rec)
    zx, wht, _ = bf16_bilstm_inputs(torch, g, TSEQ, 1, TBATCH, THIDDEN, False)
    h0 = torch.zeros(TBATCH, THIDDEN, device="cuda")
    n_h = TSEQ * TBATCH * THIDDEN
    t_bytes = (4 * 4 * n_h + 2 * wht.numel() + 4 * n_h) / HBM_BYTES_PER_S
    t_ops = 2 * n_h * 4 * THIDDEN / BF16_FLOPS
    rows["lstm_scan"] = {
        "ms": time_ms(torch, lambda: ops.lstm_scan(zx[:, 0], wht[0], h0, h0),
                      flush),
        "plain_ms": yard_ms(torch, lambda: ops.lstm_scan_reference(
            zx[:, 0], wht[0], h0, h0), flush, reps=5),
        "queued_ms": time_queued_ms(
            torch, lambda: ops.lstm_scan(zx[:, 0], wht[0], h0, h0)),
        "library_ms": None, "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    print(f"lstm_scan_bf16 {(TSEQ, TBATCH, THIDDEN)}: kernel_ms="
          f"{rows['lstm_scan']['ms']:.5f} plain_ms="
          f"{rows['lstm_scan']['plain_ms']:.5f} bound_ms="
          f"{rows['lstm_scan']['bound_ms']:.5f}")
    rnn_rows, rnn_errs = phase_rnn_bf16(torch, ops, g, flush)
    rows |= rnn_rows
    errs["rnn_forward"] = [rnn_errs["rnn_forward"]]
    errs["rnn_backward"] = [rnn_errs["rnn_backward"]]
    errs["bilstm_forward"] = [max(max(r["h"]["err"], r["c"]["err"])
                                  for r in rec_errs.values())]
    errs["bilstm_backward"] = [max(r["dzx"]["err"]
                                   for r in rec_errs.values())]
    errs["lstm_scan"] = [scan["err"]]
    src = "bigdl_tpu_torch/csrc/"
    at = "bigdl_tpu/ops/pallas_kernels.py:"
    where = {"maxpool2d_forward": ("maxpool2d.cu", 1164),
             "maxpool2d_backward": ("maxpool2d.cu", 1204),
             "maxpool2d_s1_forward": ("maxpool2d_s1.cu", 264),
             "maxpool2d_s1_backward": ("maxpool2d_s1.cu", 288),
             "lrn_forward": ("lrn.cu", 408), "lrn_backward": ("lrn.cu", 408),
             "bilstm_forward": ("bilstm.cu", 606),
             "bilstm_backward": ("bilstm.cu", 631),
             "lstm_scan": ("bilstm.cu", 148),
             "rnn_forward": ("rnn_bf16.cu", 948),
             "rnn_backward": ("rnn_bf16.cu", 969)}
    print(f"bf16 forms: {len(BF16_S2_POOLS)} any-stride pools, "
          f"{len(INCEPTION_S1_POOLS) + 1} stride-1 pools, "
          f"{len(INCEPTION_LRNS)} LRNs, {len(cases)} LSTM recurrences, "
          f"lstm_scan and {len(BF16_RNN_CASES)} RNN recurrences held; "
          f"max_abs_err "
          + ", ".join(f"{n} {max(errs[n]):.3e}" for n in where))
    return [{"name": bf16_name(name), "route": "cuda", "ok": True,
             "source": src + where[name][0],
             "replaces": at + str(where[name][1]),
             "max_abs_err": max(errs[name]), **rows[name]}
            for name in where]


def bench_batch(shape, classes, seed):
    """bench.py's synthetic batch: N(0, 1) inputs and labels 1..classes."""
    from bigdl_tpu_torch.dataset.sample import MiniBatch

    rs = np.random.RandomState(seed)
    return MiniBatch(rs.randn(*shape).astype(np.float32),
                     rs.randint(1, classes + 1, (shape[0],)).astype(
                         np.float32))


def bench_opt(torch, model, batch, n, dispatches, device="cuda", graph=True):
    """``model`` on ``batch`` repeated, SGD at lr BF16_LR through
    ``Optimizer``, ``n`` steps a dispatch (one CUDA graph on the card)."""
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import Optimizer
    from bigdl_tpu_torch.utils.table import T

    rows = len(batch.labels)
    data = _FixedBatches([batch] * (n * dispatches), n * dispatches * rows)
    opt = Optimizer(model, data, ClassNLLCriterion(),
                    state=T(learningRate=BF16_LR), device=device)
    return graph_or_eager(opt, n, graph and device == "cuda")


def dispatch_walls(torch, opt, dispatches, trace=False):
    """One call of ``opt`` (n steps a dispatch, one CUDA graph each) of
    ``1 + dispatches`` dispatches: the first captures, the rest replay.
    The loop's end trigger records a CUDA event on the loop's stream at
    the top of each iteration, so the card's ms between two events is one
    dispatch as the card lived it (the replay, and any wait for the host's
    batch); returns those ms for the ``dispatches`` past the capturing
    one.  With ``trace``, the card alone is traced over those dispatches,
    and the device busy ms and the wall ms of that span come too: the
    profiler starts at the top of the first replayed dispatch (the card
    still runs the capturing one's replay, as in any steady state), busy
    is what the card ran from then to the end, wall the host's clock over
    the same span.  Busy sums the raw trace's device events: building the
    profiler's event tables for a few replayed dispatches of these models
    costs seconds a call."""
    from torch.profiler import ProfilerActivity, profile

    from bigdl_tpu_torch.optim import max_iteration

    n = opt.iters_per_dispatch
    end = max_iteration(int(opt.state["neval"]) - 1 + (1 + dispatches) * n)
    events, window = [], {}
    prof = profile(activities=[ProfilerActivity.CUDA]) if trace else None

    def trigger(state):
        if prof is not None and len(events) == 1:
            prof.start()
            window["t0"] = time.perf_counter()
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
        return end(state)

    opt.set_end_when(trigger).optimize()
    torch.cuda.synchronize()
    walls = [a.elapsed_time(b) for a, b in zip(events[1:-1], events[2:])]
    if prof is None:
        return walls
    wall = (time.perf_counter() - window["t0"]) * 1e3
    prof.stop()
    cuda = torch.autograd.DeviceType.CUDA
    busy = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == cuda) / 1e6
    return walls, busy, wall


def bench_run(torch, ops, cfg, init, batch, pol):
    """One configuration under policy ``pol`` from ``init``: n steps a
    dispatch through ``Optimizer(...).optimize()`` on the card, one CUDA
    graph a dispatch after the first (eager) chunk.  A first call of n
    steps (the eager chunk: the first loss, and the warm-up); a call of
    1 + READ["dispatches"] dispatches from zero launch counts, whose
    dispatches past the capturing one give the ms a step (their median,
    ``dispatch_walls``); another such call with the card traced over the
    replayed ones, whose busy and wall give the idle share.  A call
    captures its first dispatch anew (each starts from zero velocity),
    and the capture is left out of both.  Returns the figures and the
    timed call's launch counts (one capture's n steps)."""
    from bigdl_tpu_torch import tensor as bt
    from bigdl_tpu_torch.optim import max_iteration
    from bigdl_tpu_torch.utils.random import RNG

    label, build, _, _, records, unit, n = cfg[:7]
    bt.set_policy(pol)
    try:
        RNG.set_seed(0)
        model = with_init(build("cuda", None), init)
        dispatches = READ["dispatches"]
        opt = bench_opt(torch, model, batch, n, 3 + 2 * dispatches)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        opt.set_end_when(max_iteration(n)).optimize()
        first = opt.loss_log[0][1]
        walls, counts, _ = run_path(torch, ops, lambda: dispatch_walls(
            torch, opt, dispatches))
        step_ms = statistics.median(walls) / n
        _, busy, window = dispatch_walls(torch, opt, dispatches,
                                         trace=True)
        steps = dispatches * n
        peak = torch.cuda.max_memory_allocated()
        losses = [l for _, l in opt.loss_log]
        if not np.isfinite(losses).all():
            raise AssertionError(f"{label} {pol}: losses {losses}")
        return {"step_ms": step_ms, "rate": records / step_ms * 1e3,
                "unit": unit, "spread": (min(walls) / n, max(walls) / n),
                "busy_ms": busy / steps, "window_ms": window / steps,
                "idle": 1 - busy / window, "peak": peak,
                "first_loss": first, "last_loss": losses[-1],
                "captures": opt.captures, "replays": opt.replays}, counts
    finally:
        bt.set_policy(bt.FP32)
        torch.cuda.empty_cache()


def bf16_vs_cpu(torch, cfg, init):
    """The configuration under BF16_COMPUTE on the card against the CPU
    (plain versions) at the check's batch (and depth), dropout off, from
    the same parameters: the first batch's loss and whole-model gradient,
    then BF16_CHECK_STEPS eager steps' losses and the final parameters.
    The CPU runs replay the card's routing (``Routes``: its ReLU masks and
    pool argmaxes, which bf16's rounding makes ties of far more often than
    f32's), so the runs part by their arithmetic, not by a flipped tie.
    The losses hold BF16_LOSS_RTOL, the gradient BF16_GRAD_RTOL and the
    parameters BF16_PARAM_ATOL."""
    from bigdl_tpu_torch import tensor as bt
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import max_iteration
    from bigdl_tpu_torch.optim.local_optimizer import to_device
    from bigdl_tpu_torch.utils.random import generator

    label, build, shape, classes = cfg[:4]
    check_batch, check_build = cfg[8]
    if check_build is not None:   # a cut depth: its own parameters
        build, init = check_build, init_of(check_build("cpu", generator(1)))
    batch = bench_batch((check_batch,) + shape[1:], classes, 1)
    out, routes = {}, {}

    def run(device):
        bt.set_policy(bt.BF16_COMPUTE)
        try:
            model = with_init(build(device, None), init, dropout=0.0)
            dev = torch.device(device)
            model.train()
            with Routes(torch, model, replay=routes.get("probe")) as seen:
                loss = ClassNLLCriterion()(model(to_device(batch.data, dev)),
                                           to_device(batch.labels, dev))
            routes.setdefault("probe", seen)
            loss.backward()
            grads = [p.grad.detach().float().cpu()
                     for p in model.parameters()]
            model.zero_grad(set_to_none=True)
            model.load_state(init["state"])
            opt = bench_opt(torch, model, batch, 1, BF16_CHECK_STEPS,
                            device=device, graph=False)
            opt.set_end_when(max_iteration(BF16_CHECK_STEPS))
            with Routes(torch, model, replay=routes.get("steps")) as steps:
                opt.optimize()
            routes.setdefault("steps", steps)
        finally:
            bt.set_policy(bt.FP32)
        out[device] = (float(loss.detach()), grads,
                     [l for _, l in opt.loss_log], _params(torch, model),
                     (seen.differ, seen.choices, steps.differ,
                      steps.choices))

    run("cuda")
    run("cpu")
    (l_g, g_g, ls_g, p_g, _), (l_c, g_c, ls_c, p_c, flips) = (
        out["cuda"], out["cpu"])
    diff = {"loss": (l_g, l_c), "loss_rel": abs(l_g - l_c) / abs(l_c),
            "grad_rel": model_rel(g_g, g_c),
            "steps_rel": float(np.max(np.abs(np.subtract(ls_g, ls_c))
                                      / np.abs(ls_c))),
            "param_abs": float((p_g - p_c).abs().max())}
    failed = [part for part, bad in (
        ("first loss", diff["loss_rel"] > BF16_LOSS_RTOL),
        ("gradients", diff["grad_rel"] > BF16_GRAD_RTOL),
        ("losses", diff["steps_rel"] > BF16_LOSS_RTOL),
        ("params", diff["param_abs"] > BF16_PARAM_ATOL)) if bad]
    print(f"bf16 {label} vs CPU, batch {check_batch}"
          f"{' at depth ' + str(A_CHECK_LAYERS) if check_build else ''}, "
          f"BF16_COMPUTE on both: first loss card {l_g:.6f} CPU {l_c:.6f} "
          f"({diff['loss_rel']:.3e} relative, limit {BF16_LOSS_RTOL}); "
          f"gradient ||card - CPU|| / ||CPU|| {diff['grad_rel']:.3e} (limit "
          f"{BF16_GRAD_RTOL}); {BF16_CHECK_STEPS} steps' losses "
          f"{diff['steps_rel']:.3e} apart; params {diff['param_abs']:.3e} "
          f"(limit {BF16_PARAM_ATOL}); the CPU took the card's "
          f"routing ({flips[0]} of its own {flips[1]} first-batch choices "
          f"and {flips[2]} of {flips[3]} in the steps differed)")
    if failed:
        raise AssertionError(f"bf16 {label}: the card's training left the "
                             f"CPU's: {', '.join(failed)}")
    return diff


def simple_rnn_bf16(torch, ops):
    """examples/train_rnn.py's SimpleRNN at the smoke's defaults (hidden
    40, batch 4, seqLength 8, bptt 4) under BF16_COMPUTE: BF16_RNN_STEPS
    steps through ``Optimizer(...).optimize()``, each two chunks of the
    rnn's bf16-weight form (the launch counts say so: ``rnn_*_bf16``, the
    f32 forms none), and RCHECK_STEPS steps against the CPU under the
    same policy through ``held_vs_cpu``.  Returns the launch counts."""
    from bigdl_tpu_torch import tensor as bt
    from bigdl_tpu_torch.models.rnn import SimpleRNN
    from bigdl_tpu_torch.nn.module import export_params
    from bigdl_tpu_torch.optim import max_iteration
    from bigdl_tpu_torch.utils.random import generator

    tokens, dictionary, vocab = rnn_data(rnn_corpus(RSENTENCES))
    init = export_params(SimpleRNN(vocab, RHIDDEN, vocab, RBPTT, device="cpu",
                                   generator=generator(0)))
    run = lambda device, steps: rnn_run(torch, device, init, tokens,
                                        dictionary, max_iteration(steps))
    bt.set_policy(bt.BF16_COMPUTE)
    try:
        run("cuda", 2).optimize()     # warm-up
        opt = run("cuda", BF16_RNN_STEPS)
        _, counts, wall = run_path(torch, ops, opt.optimize)
        diff = card_vs_cpu(torch, init,
                           lambda device: run(device, RCHECK_STEPS))
    finally:
        bt.set_policy(bt.FP32)
    steps = BF16_RNN_STEPS
    only_counts("bf16 SimpleRNN", counts, {
        "fused_sgd": steps, "rnn_forward_bf16": 2 * steps,
        "rnn_backward_bf16": 2 * steps, "rnn_dwh": 2 * steps})
    losses = [l for _, l in opt.loss_log]
    if len(losses) != steps or not np.isfinite(losses).all():
        raise AssertionError(f"bf16 SimpleRNN losses: {losses}")
    print(f"bf16 SimpleRNN (Recurrent(RnnCell), zx f32, wht bf16) at bptt "
          f"{RBPTT}: {steps} steps in {wall:.4f} s ({wall / steps * 1e3:.4f} "
          f"ms/step); losses {[round(l, 6) for l in losses]}; launches "
          f"{ops_nonzero(counts)}")
    print_vs_cpu("bf16 simple_rnn", RBATCH, diff, PARAM_ATOL)
    held_vs_cpu("bf16 SimpleRNN", diff)
    return counts


def phase_bf16(torch, ops, profile: bool):
    """bench.py's six configurations (bench.py:286-364) at their full
    width and batch, from the port's models, trained through
    ``Optimizer(...).optimize()`` under FP32 and under BF16_COMPUTE
    (bench.py:420) at bench.py's steps a dispatch, each dispatch after the
    first one CUDA graph: ms a step, records a second, device busy, idle
    share and peak memory each way; under BF16_COMPUTE the launch counts
    show each pool, LRN and recurrence ran its bf16 form (fused_sgd f32;
    the stride-1 pool's and the s2 backward's staged kernels, whose plans
    ``phase_bf16_kernels`` held at these shapes);
    the first step's loss within BF16_LOSS_RTOL of FP32's from the same
    parameters and batch; each configuration under BF16_COMPUTE against
    the CPU (``bf16_vs_cpu``).  Then the LSTM classifier's single
    direction (``Recurrent(LSTMCell)``, zx f32) 2 steps and one validation
    batch under BF16_COMPUTE: the recurrence's bf16-weight form and
    ``lstm_scan``'s; then SimpleRNN under BF16_COMPUTE
    (``simple_rnn_bf16``): the rnn's bf16-weight form."""
    from bigdl_tpu_torch import tensor as bt
    from bigdl_tpu_torch.optim import max_iteration
    from bigdl_tpu_torch.utils.random import generator

    smi = smi_line()
    by_path = {}
    for i, cfg in enumerate(bench_configs()):
        t_cfg = time.perf_counter()
        label, build, shape, classes, _, unit, n, per_step = cfg[:8]
        init = init_of(build("cpu", generator(i)))
        batch = bench_batch(shape, classes, i)
        fig, fig_counts = {}, {}
        for name, pol in (("FP32", bt.FP32), ("BF16_COMPUTE",
                                               bt.BF16_COMPUTE)):
            fig[name], fig_counts[name] = bench_run(torch, ops, cfg, init,
                                                    batch, pol)
        step = {"fused_sgd": 1, **per_step}
        for name, rename in (("FP32", lambda k: k), ("BF16_COMPUTE",
                                                     bf16_name)):
            # the timed call's one capture: n steps (a replay calls none)
            want = {rename(k): v * n for k, v in step.items()}
            only_counts(f"bf16 {label} {name}", fig_counts[name], want)
        rel = abs(fig["BF16_COMPUTE"]["first_loss"] - fig["FP32"]["first_loss"]
                  ) / abs(fig["FP32"]["first_loss"])
        for name, f in fig.items():
            print(f"bf16 {label} {name}: {f['step_ms']:.4f} ms/step (the "
                  f"median of {READ['dispatches']} replayed dispatches of {n} "
                  f"steps on the card's clock; they ranged "
                  f"{f['spread'][0]:.4f}-{f['spread'][1]:.4f}), "
                  f"{f['rate']:.1f} {unit}; over another call's "
                  f"{READ['dispatches']} replayed dispatches traced, device "
                  f"busy {f['busy_ms']:.4f} ms/step of {f['window_ms']:.4f} "
                  f"ms/step of wall, idle share {f['idle']:.4f}; "
                  f"max_memory_allocated {f['peak']} B; "
                  f"{n} steps a dispatch, {f['captures']} captures "
                  f"{f['replays']} replays; losses {f['first_loss']:.6f} -> "
                  f"{f['last_loss']:.6f}; launches "
                  f"{ops_nonzero(fig_counts[name])} [{smi}]")
        print(f"bf16 {label}: BF16_COMPUTE {fig['FP32']['step_ms'] / fig['BF16_COMPUTE']['step_ms']:.3f}x "
              f"FP32's rate; first step's loss {rel:.3e} from FP32's "
              f"(limit {BF16_LOSS_RTOL})")
        if rel > BF16_LOSS_RTOL:
            raise AssertionError(f"bf16 {label}: the first loss is {rel:.3e} "
                                 f"from FP32's")
        t_cpu = time.perf_counter()
        bf16_vs_cpu(torch, cfg, init)
        t_cpu = time.perf_counter() - t_cpu
        by_path[f"bf16 {label}"] = fig_counts["BF16_COMPUTE"]
        print(f"bf16 {label}: {time.perf_counter() - t_cfg:.1f} s (wall), "
              f"{t_cpu:.1f} s of it against the CPU")
    # Recurrent(LSTMCell) under the policy: zx f32 (the bf16w form), and
    # the no-grad validation through lstm_scan's bf16 form
    docs = text_docs(3 * TBATCH)
    init = init_of(lstm_classifier("cpu", generator(0)))["params"]
    bt.set_policy(bt.BF16_COMPUTE)
    try:
        opt = bilstm_run(torch, "cuda", init, docs[:2 * TBATCH], TBATCH,
                         max_iteration(2), docs[2 * TBATCH:],
                         build=lstm_classifier)
        _, counts, wall = run_path(torch, ops, opt.optimize)
    finally:
        bt.set_policy(bt.FP32)
    only_counts("bf16 LSTM classifier", counts, {
        "fused_sgd": 2, "bilstm_forward_bf16": 2, "bilstm_backward_bf16": 2,
        "bilstm_dwh": 2, "lstm_scan_bf16": len(opt.validation_log)})
    print(f"bf16 LSTM classifier (Recurrent(LSTMCell), zx f32): 2 steps "
          f"and 1 validation batch in {wall:.4f} s; losses "
          f"{[round(l, 6) for _, l in opt.loss_log]}; launches "
          f"{ops_nonzero(counts)}")
    by_path["bf16 LSTM classifier"] = counts
    by_path["bf16 SimpleRNN"] = simple_rnn_bf16(torch, ops)
    return by_path, {}


def phase_table(torch, ops, profile, rows):
    """Every phase in run order: (name, kind, run).  A "kernels" phase's
    ``run()`` returns its rows of the kernels line (the state phase adds
    to the ``rows`` before it); a "path" phase's returns the launch
    counts of each path it drove, read right after that path ran from
    zero, and the kernel runs the profiler counted in each CUDA-graph
    path's replays."""
    carry = {}

    def slice_():
        counts, *carry["serving"] = phase_slice(torch, ops, profile)
        return {"serving": counts}, {}

    def with_figures(name, phase):
        def run():
            counts, carry[name] = phase(torch, ops, profile)
            return {name: counts}, {}
        return run

    def counts_of(name, phase):
        return lambda: ({name: phase(torch, ops, profile)}, {})

    # the serving phases load the attention library alone and run while
    # the recurrences' libraries, the slowest, compile
    return [
        ("kernels", "kernels", lambda: [
            phase_kernels(torch, ops),
            phase_int8_attention_kernels(torch, ops)]),
        ("verify_kernels", "kernels",
         lambda: phase_verify_kernels(torch, ops, rows) or []),
        ("serving", "path", slice_),
        ("serving_int8", "path", lambda: ({
            "serving_int8": phase_serving_int8(
                torch, ops, *carry["serving"], profile)}, {})),
        ("serve_features", "path", lambda: (phase_serve_features(
            torch, ops, *carry["serving"]), {})),
        ("serve_tp", "path", lambda: (phase_serve_tp(
            torch, ops, *carry["serving"]), {})),
        ("serve_cards", "path", lambda: (phase_serve_cards(
            torch, ops, *carry["serving"]), {})),
        ("train_kernels", "kernels", lambda: phase_train_kernels(torch, ops)),
        ("conv_kernels", "kernels", lambda: phase_conv_kernels(torch, ops)),
        ("bilstm_kernels", "kernels",
         lambda: phase_bilstm_kernels(torch, ops)),
        ("lstm_scan_kernels", "kernels",
         lambda: [phase_lstm_scan_kernels(torch, ops)]),
        ("rnn_gru_kernels", "kernels",
         lambda: phase_rnn_gru_kernels(torch, ops)),
        ("state_kernels", "kernels",
         lambda: phase_state_kernels(torch, ops, rows) or []),
        ("bf16_kernels", "kernels", lambda: phase_bf16_kernels(torch, ops)),
        ("lenet", "path", counts_of("lenet", phase_train)),
        ("inception", "path", counts_of("inception", phase_inception)),
        ("bilstm", "path", counts_of("bilstm", phase_bilstm)),
        ("lstm", "path", with_figures("lstm", phase_lstm)),
        ("simple_rnn", "path",
         lambda: (phase_simple_rnn(torch, ops, profile), {})),
        ("gru", "path", with_figures("gru", phase_gru)),
        ("truncation", "path", lambda: (phase_truncation(
            torch, ops, profile, {"lstm": carry["lstm"],
                                  "gru": carry["gru"]}), {})),
        ("harness", "path", lambda: phase_harness(torch, ops)),
        ("harness_api", "path",
         lambda: phase_harness_api(torch, ops, carry.get("serving"))),
        ("obs", "path", lambda: phase_obs(torch, ops, carry.get("serving"))),
        ("vgg", "path", counts_of("vgg", phase_vgg)),
        ("resnet50", "path", counts_of("resnet50", phase_resnet50)),
        ("imagenet", "path", lambda: phase_imagenet(torch, ops, profile)),
        ("bn_harness", "path", lambda: phase_bn_harness(torch, ops)),
        ("model_zoo", "path", lambda: (phase_model_zoo(torch, ops), {})),
        ("inventory", "path", lambda: phase_inventory(torch, ops)),
        ("distri", "path", lambda: phase_distri(torch, ops, profile)),
        ("attention", "path", lambda: phase_attention(torch, ops, profile)),
        ("attention_cards", "path",
         lambda: phase_attention_cards(torch, ops)),
        ("parallel", "path", lambda: phase_parallel(torch, ops, profile)),
        ("parallel_cards", "path",
         lambda: phase_parallel_cards(torch, ops)),
        ("parallel_vs_cpu", "path",
         lambda: phase_parallel_vs_cpu(torch, ops, profile)),
        ("bf16", "path", lambda: phase_bf16(torch, ops, profile)),
    ]


# phases that run only where an option names them: readings, not checks
# of the main path
ASKED_ONLY = ("parallel_vs_cpu",)


# the phases each option runs alone (no option: every phase); a run of
# some phases prints what they found and never the closing result line
ONLY = {
    # the kernel phases: to time two trees' kernels in turns
    "--kernels": ("kernels", "train_kernels", "conv_kernels",
                  "bilstm_kernels", "lstm_scan_kernels", "rnn_gru_kernels",
                  "state_kernels", "verify_kernels", "bf16_kernels"),
    # serving: the attention kernels (the verify window among them), the
    # greedy fp32 and int8 paths and the request features
    "--serve": ("kernels", "verify_kernels", "serving", "serving_int8",
                "serve_features", "serve_tp", "serve_cards"),
    # serving's tensor parallelism across four cards: the serving phase
    # (its model and requests) and the four-card decoder
    "--serve-cards": ("serving", "serve_cards"),
    # the training kernels' checks and the harness
    "--harness": ("train_kernels", "harness"),
    # the rest of the harness's API: fused_sgd's checks (its scaled form)
    # and the harness_api phase
    "--harness-api": ("train_kernels", "harness_api"),
    # the batch-normalisation slice: its kernel checks and four paths
    "--bn": ("train_kernels", "conv_kernels", "vgg", "resnet50",
             "bn_harness", "model_zoo"),
    # the inventory slice: fused_sgd's checks and the inventory phase
    "--inventory": ("train_kernels", "inventory"),
    # the data-parallel slice: fused_sgd's checks and the distri phase
    "--distri": ("train_kernels", "distri"),
    # the attention family's training: the SGD and attention kernels'
    # checks and the attention phase
    "--attention": ("kernels", "train_kernels", "attention",
                    "attention_cards"),
    # sequence and expert parallelism across four cards alone
    "--attention-cards": ("attention_cards",),
    # tensor and pipeline parallelism: the SGD and pool kernels' checks,
    # the one-card phase and the four-card one
    "--parallel": ("train_kernels", "conv_kernels", "parallel",
                   "parallel_cards"),
    # tensor and pipeline parallelism across four cards alone
    "--parallel-cards": ("parallel_cards",),
    # VGG's pipeline against the CPU at two microbatch sizes, a reading
    "--parallel-vs-cpu": ("parallel_vs_cpu",),
    # the dtype policy: the kernels' bf16 forms and bench.py's six
    # configurations under BF16_COMPUTE
    "--bf16": ("bf16_kernels", "bf16"),
    # the observability plane on the LeNet-5 and serving paths
    "--obs": ("obs",),
    # config 5's input path: the SGD and pool checks and the imagenet phase
    "--imagenet": ("train_kernels", "conv_kernels", "imagenet"),
}
# the kernels line: each row's keys (queued_ms: calls queued back to back,
# the device's time where it outlasts the wrapper's host work, no L2
# flush), then the keys some rows add: the recurrence rows also carry the
# whole layer's times: cuDNN's nn.LSTM and nn.RNN beside the port's layer
# (the same function), and nn.GRU beside the port's as a same-size
# reference (another function); the GRU weight gradient's two einsums;
# lstm_scan's row bilstm_forward's primal forward at D = 1 on its inputs;
# the int8 attention row the two-call reference (dequantize, then SDPA);
# the rnn forward and backward rows also their time at SimpleRNN's chunk;
# the attention rows their split count, their time at serving's own
# context and on the speculative verify window (verify_*: S = 5, shared
# head pages; SDPA for fp32, dequantize + SDPA for int8), and at a
# tensor-parallel rank's heads (local_heads: by H, its split count, the
# kernel's, plain and yardstick times and bound); the pool rows the sums
# over an Inception step's pools at their own shapes (kernel, bound and
# library ms, launches a step); the s2 pool rows also over a VGG step's
# five pools and ResNet-50's stem pool; the stride-1 rows a PyTorch copy or add moving their bytes; the bilstm and
# gru rows their time at the truncated classifiers' chunk from zeros and
# from a carried state; the rnn forward and backward rows their time
# under each activation kind; the harness's kernels the runs of their
# kernel in each CUDA-graph path's profiled replays (the wrappers count
# the capture's launches, not the replays')
ROW_KEYS = ("name", "route", "source", "replaces", "launches",
            "launches_by_path", "max_abs_err", "ms", "queued_ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "ok")
ROW_EXTRA = ("layer_library_ms", "layer_port_ms", "same_size_library_ms",
             "two_einsum_ms", "dequant_sdpa_ms", "bilstm_forward_ms",
             "simplernn_ms", "simplernn_bound_ms", "splits", "serving_ms",
             "serving_plain_ms", "serving_library_ms", "serving_bound_ms",
             "inception_ms", "inception_bound_ms", "inception_library_ms",
             "inception_launches_step", "vgg_ms", "vgg_bound_ms",
             "vgg_library_ms", "vgg_launches_step", "resnet50_ms",
             "resnet50_bound_ms", "resnet50_library_ms",
             "resnet50_launches_step", "vgg_pipe_ms", "vgg_pipe_bound_ms",
             "vgg_pipe_library_ms", "vgg_pipe_launches_step",
             "same_bytes_ms", "chunk_ms", "scaled_ms", "scaled_queued_ms",
             "scaled_plain_ms", "scaled_bound_ms", "scaled_launches",
             "chunk_state_ms", "act_ms", "device_lr_ms",
             "graph_kernel_runs", "verify_ms", "verify_plain_ms",
             "verify_library_ms", "verify_dequant_sdpa_ms",
             "verify_bound_ms", "local_heads", "taps_ms", "taps_queued_ms",
             "taps_plain_ms", "taps_bound_ms", "taps_launches", "taps_ratio",
             "taps_max_rel_err")


def main(argv) -> int:
    import traceback

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.utils.device import pin_fp32

    pin_fp32(torch.device("cuda"))
    smi = smi_line()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device "
          f"{torch.cuda.get_device_name(0)}")
    # one nvcc a library, all started now; the phases run on the first
    # libraries while the slower compile, each load waiting for its own
    t0 = time.perf_counter()
    _build.start()
    print(f"kernel build: {len(_build.SOURCES)} libraries started "
          f"(parallel; a phase waits for the ones it loads)")

    only = next((ONLY[a] for a in argv if a in ONLY), None)
    if only is None and "--profile" not in argv:
        short_readings()
    rows, by_path, graph_ran, failed = [], {}, {}, []
    for name, kind, run in phase_table(torch, ops, "--profile" in argv,
                                       rows):
        if (only is None and name in ASKED_ONLY) or (
                only is not None and name not in only):
            continue
        t_phase = time.perf_counter()
        try:
            out = run()
        except Exception:
            traceback.print_exc()
            failed.append(name)
            continue
        finally:
            print(f"phase {name}: {time.perf_counter() - t_phase:.1f} s "
                  f"(wall)")
        if kind == "kernels":
            rows += out
        else:
            by_path |= out[0]
            graph_ran |= out[1]
    built = _build.build()   # any library no phase loaded
    print(f"kernel build: {len(built)} left to wait for after the phases; "
          f"every library built from the checkout's sources "
          f"({time.perf_counter() - t0:.1f} s since the build started)")
    for name in _build.SOURCES:
        log = _build.target(name).with_suffix(".log")
        for line in ptxas_lines(log.read_text() if log.exists() else ""):
            print(f"  {name}: {line}")
    for row in rows:
        row["launches_by_path"] = {path: counts.get(row["name"], 0)
                                   for path, counts in by_path.items()}
        row["launches"] = sum(row["launches_by_path"].values())
        if "scaled_ms" in row:
            row["scaled_launches"] = sum(
                counts.get(f"{row['name']}_scaled", 0)
                for counts in by_path.values())
        if "taps_ms" in row:
            row["taps_launches"] = sum(
                counts.get(f"{row['name']}_taps", 0)
                for counts in by_path.values())
        ran = {path: c[row["name"]] for path, c in graph_ran.items()
               if row["name"] in c}
        if ran:
            row["graph_kernel_runs"] = ran
    kernels = [{k: r[k] for k in ROW_KEYS}
               | {k: r[k] for k in ROW_EXTRA if k in r} for r in rows]
    if only is not None or failed:
        print(json.dumps({"kernels": kernels,
                          "paths": {p: ops_nonzero(c)
                                    for p, c in by_path.items()},
                          "graph_kernel_runs": graph_ran,
                          "failed": failed}))
        return 1 if failed else 0
    for row in rows:
        if row["launches"] == 0 or row.get("scaled_launches") == 0 \
                or row.get("taps_launches") == 0:
            raise AssertionError(f"{row['name']}: no launch on any path")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
