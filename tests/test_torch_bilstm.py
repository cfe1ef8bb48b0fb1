"""The port's LSTM recurrence (bigdl_tpu_torch/ops/bilstm.py) against the
JAX package's ``bilstm_recurrence`` run through the Pallas interpreter:
the plain forward (h and c stacks), the plain backward (dzx) and weight
gradient (dwht) against the kernel and its ``jax.vjp``, for one and two
directions, T of 1, 7 and 13, ragged batches and gate blocks whose
inputs differ, and against the JAX kernel's multi-step blocking
(``block_t=4``); the primal forward; the ``torch.autograd.Function`` by
``gradcheck`` in float64.  Tolerances are the JAX tests' own: forward
rtol 1e-5 / atol 1e-6, gradients rtol 1e-4 / atol 1e-5 (the products sum
in other orders).

On the CPU the wrappers take their plain versions; the CUDA kernels are
held against those on the card by ``chip_smoke.py``.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.ops.pallas_kernels import _bilstm_fwd_call, bilstm_recurrence
from bigdl_tpu_torch import ops
from bigdl_tpu_torch.ops import _recurrence as rec
from bigdl_tpu_torch.ops import bilstm
from bigdl_tpu_torch.ops.bilstm import dwh_slices

FWD = dict(rtol=1e-5, atol=1e-6)
BWD = dict(rtol=1e-4, atol=1e-5)
# (T, D, B, H): tests/test_recurrent.py:129,211, test_pallas_ops.py:240,
# then T = 1 and ragged batches
CASES = [(7, 2, 3, 5), (9, 1, 4, 5), (13, 2, 37, 4), (1, 2, 3, 5),
         (1, 1, 2, 4), (13, 1, 5, 3), (7, 2, 1, 6)]
# added to each gate block's inputs: a gate order that differs from
# i, f, g, o changes every output
GATE_SHIFT = (1.5, -1.0, 0.5, -2.0)


def _inputs(t, nd, b, h, seed=0, shift=False):
    rs = np.random.RandomState(seed)
    zx = rs.randn(t, nd, b, 4 * h).astype(np.float32)
    if shift:
        zx += np.repeat(np.asarray(GATE_SHIFT, np.float32), h)
    wht = (rs.randn(nd, h, 4 * h) * 0.3).astype(np.float32)
    go = rs.randn(t, nd, b, h).astype(np.float32)
    return zx, wht, go


def _jax(zx, wht, go, block_t=1):
    hs, vjp = jax.vjp(lambda a, w: bilstm_recurrence(a, w, True, block_t),
                      jnp.asarray(zx), jnp.asarray(wht))
    dzx, dwht = vjp(jnp.asarray(go))
    return np.asarray(hs), np.asarray(dzx), np.asarray(dwht)


@pytest.mark.parametrize("shift", [False, True], ids=["plain", "gates"])
@pytest.mark.parametrize("case", CASES)
def test_plain_versions_match_the_pallas_kernel(case, shift):
    """h and c stacks, dzx and dwht of the wrappers (plain versions on the
    CPU) and of the autograd path against the JAX kernel pair
    interpreted."""
    zx, wht, go = _inputs(*case, shift=shift)
    hs_j, dzx_j, dw_j = _jax(zx, wht, go)
    _, cs_j = _bilstm_fwd_call(jnp.asarray(zx), jnp.asarray(wht),
                               interpret=True)
    z, w, g = map(torch.from_numpy, (zx, wht, go))
    hs, cs = ops.bilstm_forward(z, w)
    np.testing.assert_allclose(hs.numpy(), hs_j, **FWD)
    np.testing.assert_allclose(cs.numpy(), np.asarray(cs_j), **FWD)
    dzx = ops.bilstm_backward(z, w, hs, cs, g)
    np.testing.assert_allclose(dzx.numpy(), dzx_j, **BWD)
    np.testing.assert_allclose(ops.bilstm_dwh(hs, dzx).numpy(), dw_j, **BWD)
    zt, wt = z.clone().requires_grad_(), w.clone().requires_grad_()
    y = ops.bilstm_recurrence(zt, wt)
    (y * g).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), hs_j, **FWD)
    np.testing.assert_allclose(zt.grad.numpy(), dzx_j, **BWD)
    np.testing.assert_allclose(wt.grad.numpy(), dw_j, **BWD)


def test_matches_the_blocked_kernel():
    """The JAX kernel at block_t = 4 over T = 13 (time zero-padded to 16)
    is the same function."""
    zx, wht, go = _inputs(13, 2, 37, 4, seed=1)
    hs_j, dzx_j, dw_j = _jax(zx, wht, go, block_t=4)
    zt = torch.from_numpy(zx).requires_grad_()
    wt = torch.from_numpy(wht).requires_grad_()
    y = ops.bilstm_recurrence(zt, wt)
    (y * torch.from_numpy(go)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), hs_j, **FWD)
    np.testing.assert_allclose(zt.grad.numpy(), dzx_j, **BWD)
    np.testing.assert_allclose(wt.grad.numpy(), dw_j, **BWD)


def test_gate_order_is_i_f_g_o():
    """One step from h = c = 0 with no recurrent weight: c = s(i) tanh(g)
    and h = s(o) tanh(c), whatever f is."""
    zx, wht, _ = _inputs(1, 1, 2, 3, seed=2, shift=True)
    wht[:] = 0.0
    i, _, g, o = np.split(zx[0, 0].astype(np.float64), 4, axis=-1)
    sig = lambda v: 1.0 / (1.0 + np.exp(-v))
    c = sig(i) * np.tanh(g)
    hs, cs = ops.bilstm_forward(torch.from_numpy(zx), torch.from_numpy(wht))
    np.testing.assert_allclose(cs[0, 0].numpy(), c, **FWD)
    np.testing.assert_allclose(hs[0, 0].numpy(), sig(o) * np.tanh(c), **FWD)


@pytest.mark.parametrize("case", [CASES[0], CASES[3]])
def test_primal_forward_writes_no_c_stack(case):
    """The no-grad forward returns the with-c forward's h stack alone, and
    ``bilstm_recurrence`` takes it when nothing needs a gradient."""
    zx, wht, _ = _inputs(*case, seed=3)
    z, w = torch.from_numpy(zx), torch.from_numpy(wht)
    hs, _ = ops.bilstm_forward(z, w)
    primal = ops.bilstm_forward(z, w, with_c=False)
    assert isinstance(primal, torch.Tensor)
    assert torch.equal(primal, hs)
    with torch.no_grad():
        assert torch.equal(ops.bilstm_recurrence(z.requires_grad_(), w), hs)


def test_function_gradcheck_in_float64():
    rs = np.random.RandomState(4)
    zx = torch.from_numpy(rs.randn(3, 2, 2, 8)).requires_grad_()
    wht = torch.from_numpy(rs.randn(2, 2, 8) * 0.5).requires_grad_()
    assert torch.autograd.gradcheck(ops.bilstm_recurrence, (zx, wht))


def test_cpu_path_counts_no_launch():
    zx, wht, go = _inputs(7, 2, 3, 5)
    ops.reset_launch_counts()
    zt = torch.from_numpy(zx).requires_grad_()
    (ops.bilstm_recurrence(zt, torch.from_numpy(wht))
     * torch.from_numpy(go)).sum().backward()
    with torch.no_grad():
        ops.bilstm_recurrence(torch.from_numpy(zx), torch.from_numpy(wht))
    counts = ops.launch_counts()
    assert counts["bilstm_forward"] == counts["bilstm_backward"] == 0
    assert counts["bilstm_dwh"] == 0
    for k in (ops.bilstm_forward, ops.bilstm_backward, ops.bilstm_dwh):
        assert k in ops.KERNELS


def test_no_kernel_for_other_devices():
    z = torch.zeros(2, 1, 3, 8, device="meta")
    w = torch.zeros(1, 2, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.bilstm_forward(z, w)


def test_hidden_limit_mirrors_the_kernel_source():
    """The wrapper's cells are csrc/bilstm.cu's, on the cluster plan of
    csrc/recurrence_cluster.cuh: the forward (LstmFwd, also lstm_scan's)
    and the backward (LstmBwd, dz four values a unit, wht's rows read in
    place); the limit is the largest H whose forward and backward
    16-block clusters of one batch row fit a block's shared memory, at
    least the former row rule's 4,470, and every H up to it has both plans."""
    csrc = Path(bilstm.__file__).parents[1] / "csrc"
    src = (csrc / "bilstm.cu").read_text()
    assert '#include "recurrence_cluster.cuh"' in src
    assert '#include "recurrence_block.cuh"' not in src
    for cell, (g, e, has_c), v in (("LstmFwd", bilstm.FWD_CELL, 1),
                                   ("LstmBwd", bilstm.BWD_CELL,
                                    bilstm.BWD_VALUES)):
        body = src[src.index(f"struct {cell} {{"):].split("};")[0]
        assert f"static constexpr int G = {g}, V = {v}, E = {e};" in body
        assert f"kHasC = {str(has_c).lower()}" in body
    # where each unit's E inputs come from: the forward's four gates of
    # zx; the backward's four activated gates, c_t, c_{t-1} and gout
    assert "input(int q) { return {0, q, 4, 0}; }" in src
    assert ("return q < 4 ? In{0, q, 4, 0}\n"
            "                 : (q == 6 ? In{2, 0, 1, 0} : "
            "In{1, 0, 1, q == 5 ? -1 : 0});") in src
    assert "lstm_fwd_kernel" not in src and "lstm_bwd_kernel" not in src
    assert "launch_transpose" not in src   # no wht^T scratch
    assert "launch_planned<LstmFwd>" in src
    assert "launch_planned<LstmBwd>" in src
    assert not (csrc / "lstm_scan.cu").exists()   # one forward template
    assert bilstm.MAX_HIDDEN == 6197 >= 4470
    fwd, bwd = bilstm.smem_bytes(bilstm.MAX_HIDDEN)
    assert fwd < bwd <= rec.MAX_SMEM   # the backward's dz state sets it
    assert max(bilstm.smem_bytes(bilstm.MAX_HIDDEN + 1)) > rec.MAX_SMEM
    for h in (1, 2, 5, 15, 16, 17, 128, 558, 1200, 4470, bilstm.MAX_HIDDEN):
        for bwd_ in (False, True):
            assert bilstm.plan(2, 3, h, bwd_)["C"] > 0
    assert bilstm.plan(1, 3, bilstm.MAX_HIDDEN, True)["C"] == 16


# (D, B, H) -> (C, R, RT, KP, S, staged, depth, bytes) of the forward and
# the backward: the Bi-LSTM and LSTM classifiers' widths (wht[d]'s 256 KB
# split over 2 blocks), a ragged H in one block, ragged H whose clusters
# take 4, 8 and 16 blocks with B = 37, H = 1,200 (16 blocks, wht through
# L2) and the largest H
PLANS = {
    (2, 128, 128): ((2, 4, 4, 4, 64, 1, 8, 171008),
                    (2, 4, 4, 4, 64, 1, 8, 207872)),
    (1, 128, 128): ((2, 2, 2, 4, 64, 1, 8, 152064),
                    (2, 2, 2, 4, 64, 1, 8, 170496)),
    (2, 37, 100): ((1, 1, 1, 2, 100, 1, 8, 175600),
                   (1, 1, 1, 2, 100, 1, 8, 187600)),
    (2, 37, 203): ((4, 4, 4, 4, 51, 1, 8, 202320),
                   (4, 4, 4, 4, 51, 1, 6, 229968)),
    (2, 37, 250): ((8, 8, 4, 4, 32, 1, 8, 181792),
                   (8, 8, 4, 4, 32, 1, 4, 225696)),
    (2, 37, 330): ((16, 16, 4, 2, 21, 1, 8, 202752),
                   (16, 16, 4, 2, 21, 0, 6, 226752)),
    (2, 9, 1200): ((16, 4, 4, 2, 75, 0, 8, 78000),
                   (16, 4, 4, 2, 75, 0, 8, 222000)),
    (1, 3, 6197): ((16, 1, 1, 1, 388, 0, 8, 100816),
                   (16, 1, 1, 1, 388, 0, 3, 232448)),
}


@pytest.mark.parametrize("shape", list(PLANS))
def test_plan_is_pinned(shape):
    """The forward's and backward's plans at each shape: a function of the
    shape alone, within a block's shared memory, its units split into C
    slices that cover H, its clusters side by side on the SMs; the
    primal and with-c forwards and lstm_scan share the forward's."""
    nd, b, h = shape
    for want, bwd in zip(PLANS[shape], (False, True)):
        got = bilstm.plan(nd, b, h, bwd)
        assert tuple(got[f] for f in rec.PLAN_FIELDS) == want
        c, rows = got["C"], got["R"]
        assert got["bytes"] <= rec.MAX_SMEM and got["depth"] >= rec.MIN_DEPTH
        assert sum((k + 1) * h // c - k * h // c for k in range(c)) == h
        assert nd * -(-b // rows) * c <= rec.SMS or rows == 16


@pytest.mark.parametrize("which", ["forward", "backward"])
def test_hidden_above_the_limit_raises_before_a_launch(which):
    """H = MAX_HIDDEN + 1 is refused by name; MAX_HIDDEN gets past the
    limit (and here stops at the device check)."""
    def call(h):
        z = torch.zeros(2, 1, 3, 4 * h, device="meta")
        w = torch.zeros(1, h, 4 * h, device="meta")
        hs = torch.zeros(2, 1, 3, h, device="meta")
        if which == "forward":
            return ops.bilstm_forward(z, w)
        return ops.bilstm_backward(z, w, hs, hs, hs)

    with pytest.raises(NotImplementedError,
                       match=f"run H <= {bilstm.MAX_HIDDEN}"):
        call(bilstm.MAX_HIDDEN + 1)
    with pytest.raises(ValueError, match="no kernel for device"):
        call(bilstm.MAX_HIDDEN)


def test_plain_versions_at_four_rows_a_block():
    """H = 600 at D = 2, B = 9: a plan unlike the classifier's (clusters
    of 16 blocks of 4 batch rows, wht through L2, both ways): the plain
    versions against the JAX kernel pair interpreted."""
    for bwd in (False, True):
        plan = bilstm.plan(2, 9, 600, bwd)
        assert (plan["C"], plan["R"], plan["staged"]) == (16, 4, 0)
    zx, wht, go = _inputs(2, 2, 9, 600, seed=9)
    hs_j, dzx_j, dw_j = _jax(zx, wht, go)
    z, w, g = map(torch.from_numpy, (zx, wht, go))
    hs, cs = ops.bilstm_forward(z, w)
    np.testing.assert_allclose(hs.numpy(), hs_j, **FWD)
    dzx = ops.bilstm_backward(z, w, hs, cs, g)
    np.testing.assert_allclose(dzx.numpy(), dzx_j, **BWD)
    np.testing.assert_allclose(ops.bilstm_dwh(hs, dzx).numpy(), dw_j, **BWD)


@pytest.mark.parametrize("t,b,h,nd,want", [
    (500, 128, 128, 2, (9, 7120)),     # the classifier: 288 blocks
    (13, 37, 4, 2, (8, 64)),
    (1, 3, 5, 2, (1, 16)),
    (0, 3, 5, 2, (1, 16)),
])
def test_weight_gradient_slices(t, b, h, nd, want):
    """The slices of the weight gradient's split depend on the shape
    alone and cover every time*batch row once."""
    s, per = dwh_slices(t, b, h, nd)
    assert (s, per) == want
    assert per % 16 == 0 and (s - 1) * per < max(t * b, 1) <= s * per


def _lstm_loop64(zx, wht, h0, c0):
    """The JAX LSTMCell's step (``_gates``: i, f, g, o; c' = sig(f) c +
    sig(i) tanh(g), h' = sig(o) tanh(c')) over zx (T, D, B, 4H) in float64
    from h0, c0: the h stack and the last c."""
    hdim = wht.shape[1]
    h, c, hs = h0, c0, []
    for z_t in zx:
        i, f, g, o = torch.split(z_t + torch.matmul(h, wht), hdim, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs), c


@pytest.mark.parametrize("case", [(7, 2, 3, 5), (1, 1, 4, 5), (9, 1, 4, 6)])
def test_initial_state_against_a_float64_loop(case):
    """From h0, c0 != 0 (a truncated run's carried state): the plain
    forward, backward and weight gradient (hprev and cprev h0 and c0 at
    t = 0) and the differentiable entry point, its last c too, against a
    float64 loop of the JAX cell's step and its autograd gradients of
    sum(hs * g) in zx and wht; h0 and c0 get no gradient."""
    zx, wht, go = _inputs(*case, seed=7)
    rs = np.random.RandomState(8)
    h0, c0 = np.tanh(rs.randn(*case[1:])), rs.randn(*case[1:])
    z64 = torch.from_numpy(zx).double().requires_grad_()
    w64 = torch.from_numpy(wht).double().requires_grad_()
    hs64, c64 = _lstm_loop64(z64, w64, torch.from_numpy(h0),
                             torch.from_numpy(c0))
    (hs64 * torch.from_numpy(go).double()).sum().backward()
    zt, wt, gt = map(torch.from_numpy, (zx, wht, go))
    h0t, c0t = (torch.from_numpy(v.astype(np.float32)) for v in (h0, c0))
    hs, cs = ops.bilstm_forward_reference(zt, wt, h0=h0t, c0=c0t)
    dzx = ops.bilstm_backward_reference(zt, wt, hs, cs, gt, h0t, c0t)
    np.testing.assert_allclose(hs.numpy(), hs64.detach().numpy(), **FWD)
    np.testing.assert_allclose(cs[-1].numpy(), c64.detach().numpy(), **FWD)
    np.testing.assert_allclose(dzx.numpy(), z64.grad.numpy(), **BWD)
    np.testing.assert_allclose(ops.bilstm_dwh_reference(hs, dzx, h0t)
                               .numpy(), w64.grad.numpy(), **BWD)
    zg, wg = zt.clone().requires_grad_(), wt.clone().requires_grad_()
    h0g, c0g = h0t.clone().requires_grad_(), c0t.clone().requires_grad_()
    y, last_c = ops.bilstm_recurrence(zg, wg, h0g, c0g, with_last_c=True)
    (y * gt).sum().backward()
    assert not last_c.requires_grad
    np.testing.assert_allclose(y.detach().numpy(), hs64.detach().numpy(),
                               **FWD)
    np.testing.assert_allclose(last_c.numpy(), c64.detach().numpy(), **FWD)
    np.testing.assert_allclose(zg.grad.numpy(), z64.grad.numpy(), **BWD)
    np.testing.assert_allclose(wg.grad.numpy(), w64.grad.numpy(), **BWD)
    assert h0g.grad is None and c0g.grad is None
    with torch.no_grad():
        y2, c2 = ops.bilstm_recurrence(zt, wt, h0t, c0t, with_last_c=True)
    assert torch.equal(y2, y.detach()) and torch.equal(c2, last_c)
