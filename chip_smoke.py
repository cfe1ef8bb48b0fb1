#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``bigdl_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py            # the smoke, a few minutes
    python3 chip_smoke.py --profile  # plus torch.profiler breakdowns
    python3 chip_smoke.py --kernels  # phases 1-2 alone, no result line

Phases, each failing with a non-zero exit:

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
   sets, timed at LeNet's and at the serving model's parameter counts;
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
   fp32 stream are printed;
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
10. one JSON line of kernels, then the card line, then the result line.

Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np

RTOL, ATOL = 1e-4, 1e-5          # fp32, summation order differs
HBM_BYTES_PER_S = 3.35e12         # H100 SXM data sheet
FP32_FLOPS = 67e12                # H100 SXM data sheet, non-tensor fp32
VOCAB, D_MODEL, HEADS, LAYERS, HIDDEN = 4000, 1024, 4, 6, 4096
SLOTS, N_POS, PAGE = 8, 1024, 16
N_REQ, N_WORDS = 16, 128
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
# Inception-v1 training slice: examples/train_inception.py --synthetic
IBATCH, ICLASSES, IMAGES, ISIZE, ICROP = 128, 1000, 4 * 128, 256, 224
ILR, IWD, ISTEPS, IVAL = 0.0898, 1e-4, 20, 256
ICHECK_BATCH, ICHECK_STEPS = 16, 3
# Inception card vs CPU.  conv1's weight gradient sums 16 x 112 x 112
# products of pixels of +-128 that mostly cancel: each fp32 run lands
# ~2e-3 of the leaf's scale from the float64 value (the card 2.53e-3,
# the CPU 2.17e-3 in the run that set these), so the card is held to
# twice the CPU's own fp32 error against float64, not to the CPU; three
# steps at lr 0.0898 carry that into conv1's weights (4.6e-4 apart).
IGRAD_VS_CPU64, IPARAM_ATOL = 2.0, 1e-3
IPARAMS = 6998552
LRN = (5, 1e-4, 0.75, 1.0)            # models/inception.py:37,42
LRN_FWD_TOL = dict(rtol=1e-5, atol=1e-6)   # tests/test_pallas_ops.py:148
LRN_BWD_TOL = dict(rtol=1e-4, atol=1e-5)   # tests/test_pallas_ops.py:155
# (shape, (size, alpha, beta, k)): tests/test_pallas_ops.py:116-121 (an
# even size, ragged H*W), then Inception-v1's two LRNs at batch 128
LRN_CASES = [
    ((2, 8, 16, 8), (5, 1.0, 0.75, 1.0)),
    ((2, 6, 16, 16), (3, 2e-4, 0.9, 2.0)),
    ((2, 8, 7, 9), (5, 1.0, 0.75, 1.0)),
    ((2, 8, 16, 8), (4, 1.0, 0.75, 1.0)),
    ((IBATCH, 64, 56, 56), LRN),
    ((IBATCH, 192, 56, 56), LRN),
]
# (shape, window, pads), stride 1: tests/test_pallas_ops.py:80-84, then
# Inception-v1's 3a, 3b, 4a and 5a pools at batch 128, a plane cut into
# row bands, a window whose backward bands need more than two blocks an SM
# of shared memory, and a window no band holds (the unstaged kernels);
# then 7x7 planes whose groups of 73 start off 16-byte boundaries (NC 150:
# two misaligned starts, a tail group of 4), a plane too large for a block
# (360 KB) cut into 8-row bands with W not a multiple of 4, and a 5x5
# window with pads 2 on 14x14 planes (the runtime-window kernels)
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
# tests/test_pallas_ops.py:37-44
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
            "plain_ms": time_ms(torch, plain, flush),
            "library_ms": time_ms(torch, library, flush),
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


def live_key_rows(pos, n_view):
    """Key rows a call needs: per batch row, those up to its largest query
    position (none for a row whose positions are all < 0), summed."""
    return int((pos.max(dim=1).values + 1).clamp(0, n_view).sum())


def paged_bound(args):
    """Least time for this call's work: each live K/V row read once, q,
    pos, ptab read and out written once, over the memory rate; its
    QK and PV flops over the fp32 rate.  Rows past a row's last query
    position are not needed and not counted."""
    q, kpool, _, ptab, pos = args
    bsz, S, H, hd = q.shape
    ps, P = kpool.shape[1], ptab.shape[1]
    live_keys = pos.clamp(min=-1).cpu().numpy() + 1          # (B, S)
    kv = 2 * live_key_rows(pos, P * ps) * H * hd * 4
    io = 2 * q.numel() * 4 + pos.numel() * 4 + ptab.numel() * 4
    flops = 4 * hd * H * int(live_keys.sum())
    t_bytes = (kv + io) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), kv + io


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
        "plain_ms": time_ms(
            torch, lambda: ops.paged_attention_reference(*full), flush),
        "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
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
    return {"name": "paged_attention", "route": "cuda",
            "source": "bigdl_tpu_torch/csrc/paged_attention.cu",
            "replaces": "bigdl_tpu/ops/pallas_kernels.py:1299",
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


def inception_sum(sums, name, row, n):
    """Adds ``n`` launches of ``row`` to a pass's Inception step totals:
    kernel, bound and library ms and launches a step."""
    out = sums.setdefault(name, {"inception_ms": 0.0,
                                 "inception_bound_ms": 0.0,
                                 "inception_library_ms": 0.0,
                                 "inception_launches_step": 0})
    out["inception_ms"] += n * row["ms"]
    out["inception_bound_ms"] += n * row["bound_ms"]
    out["inception_library_ms"] += n * row["library_ms"]
    out["inception_launches_step"] += n


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
    # the library's padding is symmetric: the high pad becomes ceil mode
    ceil = (phh, phw) != (plh, plw)
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


def pool_s1_plan_line(ops, shape, win, pads):
    """The plan each pass takes at ``shape`` (``ops.maxpool_s1.plan``),
    held equal to the one the built library computes; one line."""
    plans = []
    for bwd in (False, True):
        want = ops.maxpool_s1.plan(shape, win, pads, bwd)
        got = ops.maxpool_s1.kernel_plan(shape, win, pads, bwd)
        if want != got:
            raise AssertionError(f"maxpool2d_s1 plan at {shape} {win} "
                                 f"{pads} bwd={bwd}: the library's {got}, "
                                 f"the mirror's {want}")
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
    return (f"maxpool2d_s1 plan {shape} {win[0]}x{win[1]} pads {pads}: "
            f"forward {plans[0]}; backward {plans[1]}")


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
        fwd["same_bytes_ms"] = time_ms(torch, lambda: out.copy_(x), flush)
        bwd["same_bytes_ms"] = time_ms(
            torch, lambda: torch.add(x, gy, out=out), flush)
    return fwd, bwd


def phase_conv_kernels(torch, ops):
    """The Inception slice's new kernels against their plain versions,
    with times at Inception-v1's shapes at batch 128: both LRNs, the 3a
    and 3b pools (3b's input is the largest a stride-1 pool takes)."""
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
    for case in LRN_CASES[-2:]:
        fwd, bwd = lrn_times(torch, ops, flush, g, *case)
        for name, row in (("forward", fwd), ("backward", bwd)):
            print(f"lrn_{name} {case[0]} {case[1:]}: "
                  f"kernel_ms={row['ms']:.5f} "
                  f"queued_ms={row['queued_ms']:.5f} "
                  f"plain_ms={row['plain_ms']:.5f} "
                  f"library_ms={row['library_ms']:.5f} "
                  f"bound_ms={row['bound_ms']:.5f} ({row['bound_by']}, "
                  f"{row['bytes']} bytes)")
            rows[f"lrn_{name}"] = row   # the last, largest case
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
            inception_sum(inception, name, row, n)
            if case[0] == S1_CASES[4][0]:
                rows[f"maxpool2d_s1_{name}"] = row
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
                   "plain_ms": time_ms(torch, plain, flush, reps=5),
                   "queued_ms": time_queued_ms(torch, kernel),
                   "library_ms": None, **byte_bound(nbytes, n_ops)}
            for name, (kernel, plain, nbytes, n_ops) in rows_of.items()}


def einsum_yardstick(torch, flush, row, hs, dzx, kernel):
    """The weight gradient's library_ms: one einsum of the h stack read at
    t - 1 and dzx (the t = 0 term is zero), timed beside ``kernel()``;
    the yardstick only, the port never calls it."""
    library = lambda: torch.einsum("tdbk,tdbj->dkj", hs[:-1], dzx[1:])
    row["library_ms"] = time_ms(torch, library, flush)
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
    rows["dwh"]["two_einsum_ms"] = time_ms(torch, lambda: (
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
        "library_fwd_ms": time_ms(torch, lambda: lib(x), flush),
        "port_fwd_ms": time_ms(torch, lambda: port(x), flush),
        "library_bwd_ms": time_ms(torch, lambda: torch.autograd.grad(
            yl, [xl, *lib.parameters()], gy, retain_graph=True), flush),
        "port_bwd_ms": time_ms(torch, lambda: torch.autograd.grad(
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
    ps, P = kpool.shape[1], ptab.shape[1]
    kv = 2 * live_key_rows(pos, P * ps) * H * (hd + 4)
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
           "plain_ms": time_ms(torch, lambda: (
               ops.paged_attention_int8_reference(*full)), flush),
           "queued_ms": time_queued_ms(
               torch, lambda: ops.paged_attention_int8(*full)),
           "library_ms": None,
           "dequant_sdpa_ms": time_ms(torch, dequant_sdpa, flush),
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
    return {"name": "paged_attention_int8", "route": "cuda",
            "source": "bigdl_tpu_torch/csrc/paged_attention.cu",
            "replaces": "bigdl_tpu/ops/pallas_kernels.py:1299",
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
                "layer_library_ms": time_ms(torch, lambda: lib(x), flush),
                "layer_port_ms": time_ms(torch, lambda: port(x), flush)}


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


def check_sgd(torch, ops, g):
    """Three steps of the kernel and of the plain version on every hyper
    set, over leaves that no chunk or vector width divides, the gradients
    moved to new memory before the last step (the cached leaf table must
    give way to a new one); then a step with the finite flag False
    changes nothing."""
    shapes = [(130, 7), (7,), (4097,), (100,), (3, 5, 5), (10001,)]
    err = 0.0
    for h in SGD_HYPERS:
        p, gr, v = sgd_leaves(torch, g, shapes)
        p2, v2 = [t.clone() for t in p], [t.clone() for t in v]
        kw = dict(momentum=h.get("momentum", 0.0),
                  weight_decay=h.get("weight_decay", 0.0),
                  dampening=h.get("dampening", 0.0),
                  nesterov=h.get("nesterov", False))
        for step in range(3):
            if step == 2:
                gr = [t.clone() for t in gr]
            ops.fused_sgd(p, gr, v, h["lr"], **kw)
            ops.fused_sgd_reference(p2, gr, v2, h["lr"], **kw)
        torch.cuda.synchronize()
        for a, b in zip(p + v, p2 + v2):
            torch.testing.assert_close(a, b, **SGD_TOL)
            err = max(err, float((a - b).abs().max()))
        kept = [t.clone() for t in p + v]
        ops.fused_sgd(p, gr, v, h["lr"], finite=torch.zeros(
            (), dtype=torch.bool, device="cuda"), **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(p + v, kept)):
            raise AssertionError("fused_sgd wrote on a non-finite step")
    return err


def sgd_times(torch, ops, flush, g, shapes):
    """Kernel, plain and library (``torch.optim.SGD(fused=True).step()``,
    timing only: its first step's dampening differs) times of one step
    of the training slice's hypers over leaves of ``shapes``, and the
    byte bound: p, g, v read and p, v written, 20 bytes a parameter."""
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
    row["params"] = sum(t.numel() for t in p)
    row.update(byte_bound(20 * row["params"], 0))
    return row


def phase_train_kernels(torch, ops):
    """The training slice's kernels against their plain versions, with
    times at LeNet's shapes and at larger shapes models of the repo have:
    Inception-v1's first pool at batch 32 (the rows' shape) and its four
    3x3 s2 pools at batch 128, the serving model's parameters."""
    from bigdl_tpu_torch.models.lenet import LeNet5
    from bigdl_tpu_torch.models.transformer import TransformerLM

    g = torch.Generator(device="cuda").manual_seed(1)
    errs = [check_pool(torch, ops, g, *case)
            for case in POOL_CASES + INCEPTION_POOLS]
    errs += [check_pool(torch, ops, g, *POOL_CASES[k], nan=True)
             for k in NAN_POOL_CASES]
    sgd_err = check_sgd(torch, ops, g)
    flush = torch.empty(64 * 2**20, device="cuda")   # 256 MB > 50 MB L2
    inception = {}
    for case in POOL_CASES[-3:] + INCEPTION_POOLS:
        rows = pool_times(torch, ops, flush, g, *case)
        for name, row in zip(("forward", "backward"), rows):
            print_pool_row(f"maxpool2d_{name}", case, row)
            if case in INCEPTION_POOLS:
                inception_sum(inception, name, row, 1)
        if case == POOL_CASES[-1]:
            fwd, bwd = rows   # the rows' shape
    lenet = [tuple(p.shape) for p in LeNet5(device="cuda").parameters()]
    serving = [tuple(p.shape) for p in TransformerLM(
        VOCAB, D_MODEL, HEADS, LAYERS, HIDDEN, dropout=0.0,
        device="meta").parameters()]
    for shapes in (lenet, serving):
        sgd = sgd_times(torch, ops, flush, g, shapes)
        print(f"fused_sgd {sgd['params']} params in {len(shapes)} leaves: "
              f"kernel_ms={sgd['ms']:.5f} plain_ms={sgd['plain_ms']:.5f} "
              f"library_ms={sgd['library_ms']:.5f} "
              f"bound_ms={sgd['bound_ms']:.5f} ({20 * sgd['params']} bytes) "
              f"queued_ms={sgd['queued_ms']:.5f}")
    for name, row in (("forward", fwd), ("backward", bwd)):
        row.update(inception[name])
    fwd_err = max(e[0] for e in errs)
    bwd_err = max(e[1] for e in errs)
    print(f"maxpool2d: {len(POOL_CASES) + len(INCEPTION_POOLS)} geometries "
          f"with ties and "
          f"{len(NAN_POOL_CASES)} with NaNs, forward and argmax equal, "
          f"backward max_abs_err={bwd_err:.3e}; fused_sgd: "
          f"{len(SGD_HYPERS)} hyper sets x 3 steps, max_abs_err="
          f"{sgd_err:.3e}, a non-finite step writes nothing")
    common = {"route": "cuda", "ok": True}
    pool_src = {"source": "bigdl_tpu_torch/csrc/maxpool2d.cu"}
    return [
        {"name": "fused_sgd", "source": "bigdl_tpu_torch/csrc/fused_sgd.cu",
         "replaces": "bigdl_tpu/ops/pallas_kernels.py:59",
         "max_abs_err": sgd_err, **common, **sgd},
        {"name": "maxpool2d_forward", **pool_src,
         "replaces": "bigdl_tpu/ops/pallas_kernels.py:1162",
         "max_abs_err": fwd_err, **common, **fwd},
        {"name": "maxpool2d_backward", **pool_src,
         "replaces": "bigdl_tpu/ops/pallas_kernels.py:1202",
         "max_abs_err": bwd_err, **common, **bwd},
    ]


def lenet_run(torch, device, init_tree, end_trigger, validate=True):
    """``examples/train_lenet.py`` on synthetic MNIST, from ``init_tree``:
    an optimizer ready to run."""
    from bigdl_tpu_torch.dataset import (DataSet, ImgNormalizer, ImgToBatch,
                                         mnist)
    from bigdl_tpu_torch.models.lenet import LeNet5
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import Optimizer, Top1Accuracy, every_epoch
    from bigdl_tpu_torch.utils.table import T

    norm = ImgNormalizer(mnist.TRAIN_MEAN, mnist.TRAIN_STD)
    train = DataSet.array(mnist.synthetic(N_TRAIN)) >> norm >> ImgToBatch(
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
    want_l = np.asarray([l for _, l in cpu.loss_log])
    got_l = np.asarray(losses)
    rel = float(np.max(np.abs(got_l - want_l) / np.abs(want_l)))
    p_err = max(float((a.detach().cpu() - b.detach()).abs().max())
                for a, b in zip(opt.model.parameters(),
                                cpu.model.parameters()))
    print(f"train vs CPU: {len(want_l)} flushed losses, largest relative "
          f"difference {rel:.3e} (limit {LOSS_RTOL}); final params, largest "
          f"absolute difference {p_err:.3e} (limit {PARAM_ATOL}); Top1 "
          f"card {[v for _, _, v in opt.validation_log]} CPU "
          f"{[v for _, _, v in cpu.validation_log]}")
    if len(want_l) != len(got_l) or rel > LOSS_RTOL or p_err > PARAM_ATOL:
        raise AssertionError("the card's training left the CPU's")
    if profile:
        busy_ms = profile_train(torch, lambda end: lenet_run(
            torch, "cuda", init, end, validate=False), 16)
        print(f"profile: device idle share of the unprofiled train step "
              f"{1 - busy_ms / step_ms:.4f} ({busy_ms:.4f} of "
              f"{step_ms:.4f} ms/step busy)")
    return counts


def profile_train(torch, make_opt, n):
    """Device time by kernel over a window of ``n`` train steps (no
    validation) of the optimizer ``make_opt(end_trigger)`` builds, after
    two warm steps."""
    from torch.profiler import ProfilerActivity, profile

    from bigdl_tpu_torch.optim import max_iteration

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
    return busy / n


def inception_images(n, size, seed):
    """examples/train_inception.py:55-58 (``--synthetic``): ``n`` RGB
    images of ``size`` x ``size``, uniform [0, 255), labels 1..1000."""
    from bigdl_tpu_torch.dataset import LabeledImage

    rng = np.random.RandomState(seed)
    return [LabeledImage(rng.uniform(0, 255, (size, size, 3)),
                         rng.randint(1, ICLASSES + 1)) for _ in range(n)]


def inception_run(torch, device, init_tree, images, batch, end_trigger,
                  val_images=None, dropout=None):
    """examples/train_inception.py:59-82 from ``init_tree``: random
    224 crops, flips and the mean subtraction over ``images``, the SGD
    state with Poly(0.5, ISTEPS); validation (Top1, Top5) after ISTEPS
    iterations when ``val_images`` are given.  An optimizer ready to
    run."""
    from bigdl_tpu_torch.dataset import (DataSet, HFlip, ImgNormalizer,
                                         ImgRdmCropper, ImgToBatch)
    from bigdl_tpu_torch.models.inception import Inception_v1
    from bigdl_tpu_torch.nn import ClassNLLCriterion, Dropout
    from bigdl_tpu_torch.optim import (Optimizer, Poly, Top1Accuracy,
                                       Top5Accuracy, several_iteration)
    from bigdl_tpu_torch.utils.table import T

    norm = ImgNormalizer((123.0, 117.0, 104.0), (1.0, 1.0, 1.0))
    train = (DataSet.array(images) >> ImgRdmCropper(ICROP, ICROP) >> HFlip()
             >> norm >> ImgToBatch(batch))
    model = Inception_v1(ICLASSES, device=device).load_params(init_tree)
    if dropout is not None:
        for m in model.modules():
            if isinstance(m, Dropout):
                m.set_p(dropout)
    opt = Optimizer(model, train, ClassNLLCriterion(), state=T(
        learningRate=ILR, weightDecay=IWD, momentum=0.9, dampening=0.0,
        learningRateSchedule=Poly(0.5, ISTEPS)), end_trigger=end_trigger,
        device=device)
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
    want = {**dict.fromkeys(counts, 0), "fused_sgd": steps,
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
    if (abs(diff["loss"][0] - diff["loss"][1]) > LOSS_RTOL * diff["loss"][1]
            or diff["card_vs_64"] > IGRAD_VS_CPU64 * diff["cpu_vs_64_max"]
            or diff["loss_rel"] > LOSS_RTOL
            or diff["param_abs"] > IPARAM_ATOL):
        raise AssertionError("the card's Inception training left the CPU's")
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
    want = {**dict.fromkeys(counts, 0), "fused_sgd": steps,
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
    held_to_cpu("Bi-LSTM", diff)
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
    SGD at lr 0.1, one iteration a dispatch.  An optimizer ready to
    run."""
    from bigdl_tpu_torch.dataset import DataSet, SampleToBatch
    from bigdl_tpu_torch.dataset.text import (LabeledSentenceToSample,
                                              SentenceToLabeledSentence)
    from bigdl_tpu_torch.models.rnn import SimpleRNN
    from bigdl_tpu_torch.nn import (ClassNLLCriterion,
                                    TimeDistributedCriterion)
    from bigdl_tpu_torch.optim import LocalOptimizer
    from bigdl_tpu_torch.utils.table import T

    vocab = dictionary.vocab_size() + 1
    ds = (DataSet.array(tokens)
          >> SentenceToLabeledSentence(dictionary)
          >> LabeledSentenceToSample(n_input_dims=vocab, fixed_length=RSEQ)
          >> SampleToBatch(RBATCH))
    model = (SimpleRNN(vocab, RHIDDEN, vocab, bptt_truncate=bptt,
                       device=device) if build is None
             else build(vocab, device)).load_params(init_tree)
    opt = LocalOptimizer(model, ds, TimeDistributedCriterion(
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
    want = {**dict.fromkeys(counts, 0), "fused_sgd": steps,
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
    want8 = {**dict.fromkeys(counts8, 0), "fused_sgd": 8, "rnn_forward": 8,
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
    want_g = {**dict.fromkeys(counts_g, 0), "rnn_forward": RWORDS}
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
    held_to_cpu("SimpleRNN", diff)
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
    want = {**dict.fromkeys(counts, 0), "fused_sgd": steps,
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
    held_to_cpu("GRU", diff)
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
    want = {**dict.fromkeys(counts, 0), "fused_sgd": steps,
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
    held_to_cpu("LSTM", diff)
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
    want = {**dict.fromkeys(counts, 0), "fused_sgd": steps,
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
    held_to_cpu(f"truncated {label}", diff)
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
        want = {**dict.fromkeys(counts, 0), "fused_sgd": steps,
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
        held_to_cpu(f"SimpleRNN {act.__name__}", diff)
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


def held_to_cpu(label, diff):
    """A recurrence path's card-vs-CPU gate: the first batch's loss and
    the steps' losses within LOSS_RTOL, the final params within
    PARAM_ATOL, the gradients within the backward tolerance or no further
    from float64 than BILSTM_VS_64 times the CPU's own fp32 error."""
    grads_ok = (diff["grad_rel"] <= BILSTM_BWD_TOL["rtol"]
                or diff["card_vs_64"] <= BILSTM_VS_64 * diff["cpu_vs_64_max"])
    if (abs(diff["loss"][0] - diff["loss"][1]) > LOSS_RTOL * diff["loss"][1]
            or not grads_ok or diff["loss_rel"] > LOSS_RTOL
            or diff["param_abs"] > PARAM_ATOL):
        raise AssertionError(f"the card's {label} training left the CPU's")


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
          f"update is {diff['param_step']:.3e}; limit {param_limit}); CPU "
          f"{diff['cpu_s']:.2f} s")


def card_vs_cpu(torch, init, make_run):
    """The card against the CPU (plain versions) from the same parameters
    ``init`` on the same batches: the first batch's loss (under the run's
    criterion) and gradients, then the optimizer's steps' losses and final
    parameters.
    ``make_run(device)`` builds the optimizer of a few steps on
    ``device`` (Inception: dropout off, since the two draw different
    masks)."""
    from bigdl_tpu_torch.optim.local_optimizer import to_device

    names = [".".join(k) for k in _paths(init)]
    out = {}
    for device in ("cuda", "cpu"):
        run = make_run(device)
        batch = next(run.dataset.data(train=True))
        dev = torch.device(device)
        run.model.train()
        loss = run.criterion(run.model(to_device(batch.data, dev)),
                             to_device(batch.labels, dev))
        loss.backward()
        grads = [p.grad.detach().cpu() for p in run.model.parameters()]
        run.model.zero_grad(set_to_none=True)
        t1 = time.perf_counter()
        run.optimize()
        out[device] = (float(loss.detach()), grads, run,
                       time.perf_counter() - t1)
    (loss_g, grad_g, card, _), (loss_c, grad_c, cpu, cpu_s) = (
        out["cuda"], out["cpu"])
    # the same first batch on the CPU in float64: how far each fp32 run's
    # gradients lie from it, leaf by leaf, over the leaf's largest entry
    ref = make_run("cpu")
    batch = next(ref.dataset.data(train=True))
    ref.model.double().train()
    ref.criterion(ref.model(torch.from_numpy(batch.data).double()),
                  torch.from_numpy(batch.labels)).backward()
    grad_64 = [p.grad for p in ref.model.parameters()]

    def rel(a, b):
        return float((a.double() - b).abs().max()
                     / b.abs().max().clamp_min(1e-30))

    g_rel = [rel(a, b.double()) for a, b in zip(grad_g, grad_c)]
    e_card = [rel(a, b) for a, b in zip(grad_g, grad_64)]
    e_cpu = [rel(a, b) for a, b in zip(grad_c, grad_64)]
    init_leaves = [torch.from_numpy(v) for v in _leaves(init)]
    p_abs, p_step = [], []
    for a, b, p0 in zip(card.model.parameters(), cpu.model.parameters(),
                        init_leaves):
        p_abs.append(float((a.detach().cpu() - b.detach()).abs().max()))
        p_step.append(float((b.detach() - p0).abs().max()))
    got_l = np.asarray([l for _, l in card.loss_log])
    want_l = np.asarray([l for _, l in cpu.loss_log])
    gi, pi = int(np.argmax(g_rel)), int(np.argmax(p_abs))
    ei = int(np.argmax(e_card))
    return {"loss": (float(loss_g), float(loss_c)),
            "grad_rel": g_rel[gi], "grad_leaf": names[gi],
            "card_vs_64": e_card[ei], "cpu_vs_64": e_cpu[ei],
            "leaf_64": names[ei], "cpu_vs_64_max": max(e_cpu),
            "losses": (got_l.tolist(), want_l.tolist()),
            "loss_rel": float(np.max(np.abs(got_l - want_l)
                                     / np.abs(want_l))),
            "param_abs": p_abs[pi], "param_leaf": names[pi],
            "param_step": p_step[pi],
            "cpu_s": cpu_s}


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
    if counts != {**dict.fromkeys(counts, 0),
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
    if st["pool"]["in_use"] != 0:
        raise AssertionError(f"pages leaked: {st['pool']}")

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
    if counts != {**dict.fromkeys(counts, 0),
                  "paged_attention_int8": LAYERS * dec.steps}:
        raise AssertionError(f"int8 serving launches {counts}, expected "
                             f"paged_attention_int8 {LAYERS} x {dec.steps} "
                             f"steps and no other kernel")
    if st["pool"]["in_use"] != 0 or st["kv_quant"] != "int8":
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


def main(argv) -> int:
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
    t0 = time.perf_counter()
    built = _build.build()
    print(f"kernel build: {len(built)} built in "
          f"{time.perf_counter() - t0:.2f} s (wall, parallel)")
    for name, info in built.items():
        for line in ptxas_lines(info["log"]):
            print(f"  {name}: {line}")

    kernel_rows = ([phase_kernels(torch, ops),
                    phase_int8_attention_kernels(torch, ops)]
                   + phase_train_kernels(torch, ops)
                   + phase_conv_kernels(torch, ops)
                   + phase_bilstm_kernels(torch, ops)
                   + [phase_lstm_scan_kernels(torch, ops)]
                   + phase_rnn_gru_kernels(torch, ops))
    phase_state_kernels(torch, ops, kernel_rows)
    if "--kernels" in argv:
        # the kernel phase alone: to time two trees' kernels in turns
        print(json.dumps({"kernels": kernel_rows}))
        return 0
    # each path's counts are read right after it ran, from zero
    profile = "--profile" in argv
    serving, model, seeds, fp_rows = phase_slice(torch, ops, profile)
    by_path = {"serving": serving,
               "serving_int8": phase_serving_int8(torch, ops, model, seeds,
                                                  fp_rows, profile),
               "lenet": phase_train(torch, ops, profile),
               "inception": phase_inception(torch, ops, profile),
               "bilstm": phase_bilstm(torch, ops, profile)}
    by_path["lstm"], lstm_figures = phase_lstm(torch, ops, profile)
    by_path |= phase_simple_rnn(torch, ops, profile)
    by_path["gru"], gru_figures = phase_gru(torch, ops, profile)
    by_path |= phase_truncation(torch, ops, profile, {
        "lstm": lstm_figures, "gru": gru_figures})
    for row in kernel_rows:
        row["launches_by_path"] = {path: counts.get(row["name"], 0)
                                   for path, counts in by_path.items()}
        row["launches"] = sum(row["launches_by_path"].values())
        if row["launches"] == 0:
            raise AssertionError(f"{row['name']}: no launch on any path")
    # queued_ms: calls queued back to back, the device's time where it
    # outlasts the wrapper's host work (no L2 flush)
    keys = ("name", "route", "source", "replaces", "launches",
            "launches_by_path", "max_abs_err", "ms", "queued_ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "ok")
    # the recurrence rows also carry the whole layer's times: cuDNN's
    # nn.LSTM and nn.RNN beside the port's layer (the same function), and
    # nn.GRU beside the port's as a same-size reference (another
    # function); the GRU weight gradient's two einsums; lstm_scan's row
    # bilstm_forward's primal forward at D = 1 on its inputs; the int8
    # attention row the two-call reference (dequantize, then SDPA); the
    # rnn forward and backward rows also their time at SimpleRNN's chunk;
    # the attention rows their split count and their time at serving's
    # own context; the pool rows the sums over an Inception step's pools
    # at their own shapes (kernel, bound and library ms, launches a step);
    # the stride-1 rows a PyTorch copy or add moving their bytes; the
    # bilstm and gru rows their time at the truncated classifiers' chunk
    # from zeros and from a carried state; the rnn forward and backward
    # rows their time under each activation kind
    extra = ("layer_library_ms", "layer_port_ms", "same_size_library_ms",
             "two_einsum_ms", "dequant_sdpa_ms", "bilstm_forward_ms",
             "simplernn_ms", "simplernn_bound_ms", "splits", "serving_ms",
             "serving_plain_ms", "serving_library_ms", "serving_bound_ms",
             "inception_ms", "inception_bound_ms", "inception_library_ms",
             "inception_launches_step", "same_bytes_ms", "chunk_ms",
             "chunk_state_ms", "act_ms")
    print(json.dumps({"kernels": [
        {k: r[k] for k in keys} | {k: r[k] for k in extra if k in r}
        for r in kernel_rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
