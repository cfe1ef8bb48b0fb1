"""The port's tanh-RNN recurrence (bigdl_tpu_torch/ops/rnn.py) against the
JAX package's ``rnn_recurrence`` run through the Pallas interpreter: the
plain forward (h stack), backward (dzx) and weight gradient (dwht)
against the kernel and its ``jax.vjp`` for one and two directions, T of
1 to 13 and ragged batches, and against the JAX kernel's multi-step
blocking (``test_pallas_ops.py::test_rnn_blocked``'s shape at
``block_t=4``); the initial state h0, which the JAX kernel does not
take, against a float64 loop; the ``torch.autograd.Function`` by
``gradcheck`` in float64.  Tolerances are the JAX tests' own: forward
rtol 1e-5 / atol 1e-6, gradients rtol 1e-4 / atol 1e-5.

Also the shared build and row rules: the kernels' block sizes mirror
``csrc/rnn.cu``, H past ``MAX_HIDDEN`` is refused before a launch, and
the library's cache key moves with the bytes of a header it includes.

On the CPU the wrappers take their plain versions; the CUDA kernels are
held against those on the card by ``chip_smoke.py``.
"""
import re
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.ops.pallas_kernels import rnn_recurrence
from bigdl_tpu_torch import ops
from bigdl_tpu_torch.ops import _build
from bigdl_tpu_torch.ops import _recurrence as rec
from bigdl_tpu_torch.ops import rnn

FWD = dict(rtol=1e-5, atol=1e-6)
BWD = dict(rtol=1e-4, atol=1e-5)
# (T, D, B, H): tests/test_pallas_ops.py:283, tests/test_recurrent.py's
# Recurrent(RnnCell(6, 5)) over (4, 9, 6), T = 1, ragged batches, and
# SimpleRNN's chunk at a narrow width
CASES = [(9, 2, 3, 6), (9, 1, 4, 5), (1, 2, 3, 5), (1, 1, 2, 4),
         (13, 2, 37, 4), (4, 1, 4, 7)]
CSRC = Path(rnn.__file__).parents[1] / "csrc"


def _inputs(t, nd, b, h, seed=0):
    rs = np.random.RandomState(seed)
    zx = rs.randn(t, nd, b, h).astype(np.float32)
    wht = (rs.randn(nd, h, h) * 0.3).astype(np.float32)
    go = rs.randn(t, nd, b, h).astype(np.float32)
    return zx, wht, go


def _jax(zx, wht, go, block_t=1):
    hs, vjp = jax.vjp(lambda a, w: rnn_recurrence(a, w, True, block_t),
                      jnp.asarray(zx), jnp.asarray(wht))
    dzx, dwht = vjp(jnp.asarray(go))
    return np.asarray(hs), np.asarray(dzx), np.asarray(dwht)


@pytest.mark.parametrize("case", CASES)
def test_plain_versions_match_the_pallas_kernel(case):
    """hs, dzx and dwht of the wrappers (plain versions on the CPU) and of
    the autograd path against the JAX kernel pair interpreted."""
    zx, wht, go = _inputs(*case)
    hs_j, dzx_j, dw_j = _jax(zx, wht, go)
    z, w, g = map(torch.from_numpy, (zx, wht, go))
    hs = ops.rnn_forward(z, w)
    np.testing.assert_allclose(hs.numpy(), hs_j, **FWD)
    dzx = ops.rnn_backward(w, hs, g)
    np.testing.assert_allclose(dzx.numpy(), dzx_j, **BWD)
    np.testing.assert_allclose(ops.rnn_dwh(hs, dzx).numpy(), dw_j, **BWD)
    zt, wt = z.clone().requires_grad_(), w.clone().requires_grad_()
    y = ops.rnn_recurrence(zt, wt)
    (y * g).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), hs_j, **FWD)
    np.testing.assert_allclose(zt.grad.numpy(), dzx_j, **BWD)
    np.testing.assert_allclose(wt.grad.numpy(), dw_j, **BWD)


def test_rnn_blocked():
    """test_pallas_ops.py::test_rnn_blocked: the JAX kernel at block_t = 4
    over T = 9 (time zero-padded to 12) is the same function."""
    zx, wht, go = _inputs(9, 2, 3, 6, seed=2)
    hs_j, dzx_j, dw_j = _jax(zx, wht, go, block_t=4)
    zt = torch.from_numpy(zx).requires_grad_()
    wt = torch.from_numpy(wht).requires_grad_()
    y = ops.rnn_recurrence(zt, wt)
    (y * torch.from_numpy(go)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), hs_j, **FWD)
    np.testing.assert_allclose(zt.grad.numpy(), dzx_j, **BWD)
    np.testing.assert_allclose(wt.grad.numpy(), dw_j, **BWD)


@pytest.mark.parametrize("case", [(9, 2, 3, 6), (1, 1, 4, 5)])
def test_initial_state_against_a_float64_loop(case):
    """From h0 != 0: h_t = tanh(zx_t + h_{t-1} wht), and the gradients of
    sum(hs * g) in zx and wht, the t = 0 term of dwht being h0^T dz_0,
    against a plain float64 loop; h0 itself gets no gradient."""
    zx, wht, go = _inputs(*case, seed=5)
    h0 = np.tanh(np.random.RandomState(6).randn(*case[1:]))
    h, hs = h0, []
    for step in range(case[0]):
        h = np.tanh(zx[step] + np.einsum("dbk,dkj->dbj", h, wht))
        hs.append(h)
    hs = np.stack(hs)
    dh, dzx = np.zeros_like(h0), np.zeros_like(hs)
    for step in reversed(range(case[0])):
        dzx[step] = (go[step] + dh) * (1 - hs[step] ** 2)
        dh = np.einsum("dbj,dkj->dbk", dzx[step], wht)
    hprev = np.concatenate([h0[None], hs[:-1]])
    dw = np.einsum("tdbk,tdbj->dkj", hprev, dzx)
    zt = torch.from_numpy(zx).requires_grad_()
    wt = torch.from_numpy(wht).requires_grad_()
    h0t = torch.from_numpy(h0.astype(np.float32)).requires_grad_()
    y = ops.rnn_recurrence(zt, wt, h0t)
    (y * torch.from_numpy(go)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), hs, **FWD)
    np.testing.assert_allclose(zt.grad.numpy(), dzx, **BWD)
    np.testing.assert_allclose(wt.grad.numpy(), dw, **BWD)
    assert h0t.grad is None


def test_function_gradcheck_in_float64():
    rs = np.random.RandomState(4)
    zx = torch.from_numpy(rs.randn(4, 2, 3, 5)).requires_grad_()
    wht = torch.from_numpy(rs.randn(2, 5, 5) * 0.4).requires_grad_()
    h0 = torch.from_numpy(np.tanh(rs.randn(2, 3, 5)))
    assert torch.autograd.gradcheck(
        lambda a, w: ops.rnn_recurrence(a, w, h0), (zx, wht))


def test_cpu_path_counts_no_launch():
    zx, wht, go = _inputs(7, 2, 3, 5)
    ops.reset_launch_counts()
    zt = torch.from_numpy(zx).requires_grad_()
    (ops.rnn_recurrence(zt, torch.from_numpy(wht))
     * torch.from_numpy(go)).sum().backward()
    counts = ops.launch_counts()
    assert counts["rnn_forward"] == counts["rnn_backward"] == 0
    assert counts["rnn_dwh"] == 0
    for k in (ops.rnn_forward, ops.rnn_backward, ops.rnn_dwh):
        assert k in ops.KERNELS


def test_no_kernel_for_other_devices():
    z = torch.zeros(2, 1, 3, 8, device="meta")
    w = torch.zeros(1, 8, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.rnn_forward(z, w)
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.rnn_dwh(z, z)


def test_hidden_limit_mirrors_the_kernel_source():
    """The wrapper's block sizes are csrc/rnn.cu's, on the shared row
    rule of csrc/recurrence_block.cuh; every H up to the limit fits one
    row, and 8 rows fit SimpleRNN's H 40 and the classifier's 128."""
    src = (CSRC / "rnn.cu").read_text()
    assert "R * 3 * H + (G > 1 ? G * R * H : 0)" in src
    assert "R * 4 * H + (G > 1 ? G * R * H : 0)" in src
    assert "const int G = groups(H, H);" in src
    assert rnn.MAX_HIDDEN == 14528
    assert max(rnn.smem_bytes(rnn.MAX_HIDDEN, 1)) <= rec.MAX_SMEM
    assert max(rnn.smem_bytes(rnn.MAX_HIDDEN + 1, 1)) > rec.MAX_SMEM
    assert rnn.rows_for(40) == rnn.rows_for(128) == 8
    assert rnn.rows_for(rnn.MAX_HIDDEN) == 1


@pytest.mark.parametrize("which", ["forward", "backward"])
def test_hidden_above_the_limit_raises_before_a_launch(which):
    def call(h):
        z = torch.zeros(2, 1, 3, h, device="meta")
        w = torch.zeros(1, h, h, device="meta")
        if which == "forward":
            return ops.rnn_forward(z, w)
        return ops.rnn_backward(w, z, z)

    with pytest.raises(NotImplementedError,
                       match=f"run H <= {rnn.MAX_HIDDEN}"):
        call(rnn.MAX_HIDDEN + 1)
    with pytest.raises(ValueError, match="no kernel for device"):
        call(rnn.MAX_HIDDEN)


def test_row_rule_is_the_block_headers():
    """ops._recurrence mirrors csrc/recurrence_block.cuh: the row choices,
    the block's threads and shared memory, and the split of a product."""
    src = (CSRC / "recurrence_block.cuh").read_text()
    assert re.search(r"constexpr int kRowChoices\[\] = \{8, 4, 2, 1\};", src)
    assert f"constexpr int kThreads = {rec.THREADS};" in src
    assert f"constexpr int kMaxSmem = {rec.MAX_SMEM};" in src
    assert rec.ROW_CHOICES == (8, 4, 2, 1)
    assert "if (N >= kThreads) return 1;" in src
    assert [rec.groups(m, n) for m, n in ((40, 40), (128, 512), (4, 100),
                                          (600, 600))] == [12, 1, 4, 1]


@pytest.mark.parametrize("t,b,k,j,nd,want", [
    (500, 128, 128, 128, 2, (33, 1952)),
    (4, 4, 40, 40, 1, (1, 16)),
    (0, 3, 5, 5, 1, (1, 16)),
])
def test_weight_gradient_slices(t, b, k, j, nd, want):
    s, per = rec.dwh_slices(t, b, k, j, nd)
    assert (s, per) == want
    assert per % 16 == 0 and (s - 1) * per < max(t * b, 1) <= s * per


def test_build_key_follows_included_headers(tmp_path, monkeypatch):
    """A library's cache key hashes its source and every local header it
    includes: editing recurrence_dwh.cuh moves the key of all three
    recurrence libraries and of nothing else."""
    csrc = tmp_path / "csrc"
    shutil.copytree(CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert [p.name for p in _build.sources("rnn")] == [
        "rnn.cu", "recurrence_block.cuh", "recurrence_dwh.cuh"]
    before = {n: _build.target(n) for n in _build.SOURCES}
    header = csrc / "recurrence_dwh.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build.target(n) for n in _build.SOURCES}
    moved = {n for n in _build.SOURCES if before[n] != after[n]}
    assert moved == {"bilstm", "rnn", "gru"}
