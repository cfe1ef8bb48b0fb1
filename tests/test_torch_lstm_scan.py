"""The port's forward-only LSTM (bigdl_tpu_torch/ops/lstm_scan.py)
against the JAX package's ``lstm_scan`` run through the Pallas
interpreter, from non-zero initial states h0 and c0, at T of 1 to 13 and
ragged batches, and against a float64 loop; the gate order; the cluster
plan and sizes mirrored from ``csrc/bilstm.cu`` (whose forward the scan
launches) and ``csrc/recurrence_cluster.cuh``, and H past ``MAX_HIDDEN``
refused before a launch.  Tolerance: the JAX recurrence tests' forward
one, rtol 1e-5 / atol 1e-6.

On the CPU the wrapper takes its plain version and counts no launch; the
CUDA kernel is held against that plain version on the card by
``chip_smoke.py``.
"""
import importlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.ops import pallas_kernels as pk
from bigdl_tpu_torch import ops
from bigdl_tpu_torch.ops import _recurrence as rec

scan = importlib.import_module("bigdl_tpu_torch.ops.lstm_scan")
FWD = dict(rtol=1e-5, atol=1e-6)
CSRC = Path(scan.__file__).parents[1] / "csrc"
# (T, B, H): T = 1, ragged batches and H, tests/test_recurrent.py's
# LSTMCell(6, 5) over (4, 9, 6) as a scan, a wider H
CASES = [(1, 2, 4), (9, 4, 5), (13, 37, 4), (7, 3, 33)]


def _inputs(t, b, h, seed):
    """zx N(0, 1), wht from the LSTMCell init's U(-1/sqrt(H), 1/sqrt(H)),
    h0 in (-1, 1) and c0 N(0, 1)."""
    rs = np.random.RandomState(seed)
    zx = rs.randn(t, b, 4 * h).astype(np.float32)
    wht = (rs.uniform(-1, 1, (h, 4 * h)) / np.sqrt(h)).astype(np.float32)
    h0 = np.tanh(rs.randn(b, h)).astype(np.float32)
    c0 = rs.randn(b, h).astype(np.float32)
    return zx, wht, h0, c0


@pytest.mark.parametrize("case", list(enumerate(CASES)))
def test_matches_the_pallas_kernel(case):
    seed, (t, b, h) = case
    args = _inputs(t, b, h, seed)
    want = np.asarray(pk.lstm_scan(*(jnp.asarray(a) for a in args),
                                   interpret=True))
    got = ops.lstm_scan(*(torch.from_numpy(a) for a in args))
    assert tuple(got.shape) == (t, b, h) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **FWD)


def test_against_a_float64_loop():
    """The plain version against its own float64 run: the loop is the
    function, not only the JAX kernel's rounding."""
    args = [torch.from_numpy(a) for a in _inputs(13, 5, 9, 11)]
    got = ops.lstm_scan(*args)
    want = scan.lstm_scan_reference(*(a.double() for a in args))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **FWD)


def test_zero_state_is_the_primal_bilstm_forward():
    """From h0 = c0 = 0 the scan is ``bilstm_forward``'s primal forward
    at D = 1, the function the training path runs."""
    zx, wht, _, _ = (torch.from_numpy(a) for a in _inputs(9, 4, 5, 3))
    zero = torch.zeros(4, 5)
    got = ops.lstm_scan(zx, wht, zero, zero)
    want = ops.bilstm_forward(zx[:, None], wht[None], with_c=False)[:, 0]
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_gate_order_is_i_f_g_o():
    """One step from c0: c = sig(f) c0 + sig(i) tanh(g), h = sig(o)
    tanh(c), with each gate's slice pushed to +-inf in turn."""
    h = 3
    zx = torch.zeros(1, 1, 4 * h)
    zx[0, 0, :h] = 50.0            # i -> 1
    zx[0, 0, h:2 * h] = -50.0      # f -> 0: c0 forgotten
    zx[0, 0, 2 * h:3 * h] = 0.5    # g = tanh(0.5)
    zx[0, 0, 3 * h:] = 50.0        # o -> 1
    c0 = torch.full((1, h), 7.0)
    out = ops.lstm_scan(zx, torch.zeros(h, 4 * h), torch.zeros(1, h), c0)
    torch.testing.assert_close(out[0, 0], torch.tanh(torch.tanh(
        torch.full((h,), 0.5))))


def test_takes_no_gradient_and_counts_no_launch():
    zx, wht, h0, c0 = (torch.from_numpy(a) for a in _inputs(4, 2, 3, 5))
    ops.reset_launch_counts()
    out = ops.lstm_scan(zx.requires_grad_(), wht.requires_grad_(), h0, c0)
    assert not out.requires_grad
    assert ops.launch_counts()["lstm_scan"] == 0
    assert ops.lstm_scan in ops.KERNELS


def test_no_kernel_for_other_devices():
    z, w, s = (torch.zeros(2, 3, 16, device="meta"),
               torch.zeros(4, 16, device="meta"),
               torch.zeros(3, 4, device="meta"))
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.lstm_scan(z, w, s, s)


def test_hidden_limit_mirrors_the_kernel_source():
    """The wrapper's cell is csrc/bilstm.cu's LstmFwd, the forward that
    ``bilstm_forward`` launches, on the cluster plan of
    csrc/recurrence_cluster.cuh; the limit is the largest H whose 16-block
    cluster of one batch row fits a block's shared memory, at least PR
    6's 5,811, and every H up to it has a plan."""
    src = (CSRC / "bilstm.cu").read_text()
    assert not (CSRC / "lstm_scan.cu").exists()
    assert '#include "recurrence_cluster.cuh"' in src
    assert '#include "recurrence_block.cuh"' not in src
    body = src[src.index("struct LstmFwd {"):].split("};")[0]
    g, e, has_c = scan.CELL
    assert f"static constexpr int G = {g}, V = 1, E = {e};" in body
    head = src[src.index("struct LstmFwd {"):]
    head = head[:head.index("update(")]
    assert "input(int q) { return {0, q, 4, 0}; }" in head   # zx's gates
    assert f"kHasC = {str(has_c).lower()}" in body
    # one entry for the scan and both bilstm forwards: h0, c0 and the c
    # stack are pointers that may be null
    assert src.count("launch_planned<LstmFwd>") == 1
    assert "plan_of<LstmFwd>(D, B, H, C, R)" in src
    assert scan.MAX_HIDDEN == 20656 >= 5811
    assert max(scan.smem_bytes(scan.MAX_HIDDEN)) <= rec.MAX_SMEM
    assert max(scan.smem_bytes(scan.MAX_HIDDEN + 1)) > rec.MAX_SMEM
    for h in (1, 2, 15, 16, 17, 128, 5811, scan.MAX_HIDDEN):
        assert scan.plan(3, h)["C"] > 0
    assert scan.plan(9, scan.MAX_HIDDEN)["C"] == 16


# (B, H) -> (C, R, RT, KP, S, staged, depth, bytes): the classifier's
# validation width (wht's 256 KB split over 2 blocks), a shape whose
# wht fits one block, ragged H at 2 and 4 blocks with B = 37, H =
# 1,001 and the largest H (16 blocks, wht through L2)
SCAN_PLANS = {
    (128, 128): (2, 2, 2, 4, 64, 1, 8, 152064),
    (37, 100): (1, 1, 1, 2, 100, 1, 8, 175600),
    (37, 151): (2, 1, 1, 2, 76, 1, 8, 197280),
    (37, 203): (4, 2, 2, 4, 51, 1, 8, 185632),
    (37, 1001): (16, 8, 4, 2, 63, 0, 8, 130592),
    (9, 20656): (16, 1, 1, 1, 1291, 0, 3, 232384),
}


@pytest.mark.parametrize("shape", list(SCAN_PLANS))
def test_plan_is_pinned(shape):
    """The plan at each shape: a function of (B, H) alone, the smallest
    cluster that holds its wht slices in shared memory where one does."""
    got = scan.plan(*shape)
    assert tuple(got[f] for f in rec.PLAN_FIELDS) == SCAN_PLANS[shape]
    assert got["bytes"] <= rec.MAX_SMEM
    if got["staged"] and got["C"] > 1:
        c = got["C"] // 2
        smaller = rec.cluster_plan_at(*scan.CELL, shape[1],
                                      rec.fill_rows(1, shape[0], c), c)
        assert not (smaller["C"] and smaller["staged"])


def test_hidden_above_the_limit_raises_before_a_launch():
    """H = MAX_HIDDEN + 1 is refused by name; MAX_HIDDEN gets past the
    limit (and here stops at the device check)."""
    def call(h):
        return ops.lstm_scan(torch.zeros(2, 3, 4 * h, device="meta"),
                             torch.zeros(h, 4 * h, device="meta"),
                             torch.zeros(3, h, device="meta"),
                             torch.zeros(3, h, device="meta"))

    with pytest.raises(NotImplementedError,
                       match=f"run H <= {scan.MAX_HIDDEN}"):
        call(scan.MAX_HIDDEN + 1)
    with pytest.raises(ValueError, match="no kernel for device"):
        call(scan.MAX_HIDDEN)
