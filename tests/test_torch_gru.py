"""The port's GRU recurrence (bigdl_tpu_torch/ops/gru.py) against the JAX
package's ``gru_recurrence`` run through the Pallas interpreter: the
plain forward (h stack), backward (dzrz, dzn) and weight gradients
(dwrz, dwh) against the kernel and its ``jax.vjp`` for one and two
directions, T of 1 to 13 and ragged batches, and against the JAX
kernel's multi-step blocking (``test_pallas_ops.py::test_gru_blocked``'s
shape at ``block_t=4``); the r o hprev stack the backward hands the
weight gradient; the ``torch.autograd.Function`` by ``gradcheck`` in
float64.  Tolerances are the JAX tests' own: forward rtol 1e-5 / atol
1e-6, gradients rtol 1e-4 / atol 1e-5.  Also the two-phase cluster
plan of ``csrc/gru.cu`` on ``csrc/recurrence_cluster.cuh``, mirrored by
``ops.gru.plan``, and the limit it sets.

On the CPU the wrappers take their plain versions; the CUDA kernels are
held against those on the card by ``chip_smoke.py``.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.ops.pallas_kernels import gru_recurrence
from bigdl_tpu_torch import ops
from bigdl_tpu_torch.ops import _recurrence as rec
from bigdl_tpu_torch.ops import gru

FWD = dict(rtol=1e-5, atol=1e-6)
BWD = dict(rtol=1e-4, atol=1e-5)
# (T, D, B, H): tests/test_pallas_ops.py:260, tests/test_recurrent.py's
# GRUCell(6, 5) over (4, 9, 6), T = 1, ragged batches, two directions
CASES = [(13, 1, 5, 100), (9, 1, 4, 5), (1, 2, 3, 5), (1, 1, 2, 4),
         (7, 2, 37, 4), (5, 2, 3, 6)]


def _inputs(t, nd, b, h, seed=1):
    """test_gru_blocked's draws: N(0, 1) projections, weights x 0.1."""
    rs = np.random.RandomState(seed)
    zrz = rs.randn(t, nd, b, 2 * h).astype(np.float32)
    zn = rs.randn(t, nd, b, h).astype(np.float32)
    wrz = (rs.randn(nd, h, 2 * h) * 0.1).astype(np.float32)
    wh = (rs.randn(nd, h, h) * 0.1).astype(np.float32)
    go = rs.randn(t, nd, b, h).astype(np.float32)
    return (zrz, zn, wrz, wh), go


def _jax(args, go, block_t=1):
    hs, vjp = jax.vjp(lambda *a: gru_recurrence(*a, True, block_t),
                      *map(jnp.asarray, args))
    return np.asarray(hs), [np.asarray(v) for v in vjp(jnp.asarray(go))]


@pytest.mark.parametrize("case", CASES)
def test_plain_versions_match_the_pallas_kernel(case):
    """hs; dzrz, dzn and the r o hprev stack; dwrz and dwh of the
    wrappers (plain versions on the CPU) and of the autograd path against
    the JAX kernel pair interpreted."""
    args, go = _inputs(*case)
    hs_j, grads_j = _jax(args, go)
    a = [torch.from_numpy(v) for v in args]
    g = torch.from_numpy(go)
    hs = ops.gru_forward(*a)
    np.testing.assert_allclose(hs.numpy(), hs_j, **FWD)
    dzrz, dzn, rh = ops.gru_backward(*a, hs, g)
    for got, want in zip((dzrz, dzn) + ops.gru_dwh(hs, rh, dzrz, dzn),
                         grads_j):
        np.testing.assert_allclose(got.numpy(), want, **BWD)
    # rh is r o hprev: r from the same gates, hprev the h stack at t - 1
    zrz = a[0]
    hprev = rec.shift_prev(hs)
    r = torch.sigmoid(zrz + torch.matmul(hprev, a[2]))[..., :case[3]]
    np.testing.assert_allclose(rh.numpy(), (r * hprev).numpy(), **FWD)
    at = [v.clone().requires_grad_() for v in a]
    y = ops.gru_recurrence(*at)
    (y * g).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), hs_j, **FWD)
    for v, want in zip(at, grads_j):
        np.testing.assert_allclose(v.grad.numpy(), want, **BWD)


def test_gru_blocked():
    """test_pallas_ops.py::test_gru_blocked: the JAX kernel at block_t = 4
    over T = 13 (time zero-padded to 16) is the same function."""
    args, go = _inputs(13, 1, 5, 100)
    hs_j, grads_j = _jax(args, go, block_t=4)
    at = [torch.from_numpy(v).requires_grad_() for v in args]
    y = ops.gru_recurrence(*at)
    (y * torch.from_numpy(go)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), hs_j, **FWD)
    for v, want in zip(at, grads_j):
        np.testing.assert_allclose(v.grad.numpy(), want, **BWD)


def test_gate_order_is_r_then_z():
    """One step from h = 0 with no recurrent weight: n = tanh(zn) and
    h = (1 - z) n with z the second half of zrz."""
    (zrz, zn, wrz, wh), _ = _inputs(1, 1, 2, 3, seed=2)
    wrz[:], wh[:] = 0.0, 0.0
    z = 1.0 / (1.0 + np.exp(-zrz[0, 0, :, 3:].astype(np.float64)))
    hs = ops.gru_forward(*map(torch.from_numpy, (zrz, zn, wrz, wh)))
    np.testing.assert_allclose(hs[0, 0].numpy(),
                               (1 - z) * np.tanh(zn[0, 0]), **FWD)


def test_function_gradcheck_in_float64():
    rs = np.random.RandomState(4)
    args = [torch.from_numpy(v).requires_grad_() for v in (
        rs.randn(3, 2, 2, 8), rs.randn(3, 2, 2, 4), rs.randn(2, 4, 8) * 0.5,
        rs.randn(2, 4, 4) * 0.5)]
    assert torch.autograd.gradcheck(ops.gru_recurrence, args)


def test_cpu_path_counts_no_launch():
    args, go = _inputs(7, 2, 3, 5)
    ops.reset_launch_counts()
    at = [torch.from_numpy(v).requires_grad_() for v in args]
    (ops.gru_recurrence(*at) * torch.from_numpy(go)).sum().backward()
    counts = ops.launch_counts()
    assert counts["gru_forward"] == counts["gru_backward"] == 0
    assert counts["gru_dwh"] == 0
    for k in (ops.gru_forward, ops.gru_backward, ops.gru_dwh):
        assert k in ops.KERNELS


def _meta(t, nd, b, h):
    return (torch.zeros(t, nd, b, 2 * h, device="meta"),
            torch.zeros(t, nd, b, h, device="meta"),
            torch.zeros(nd, h, 2 * h, device="meta"),
            torch.zeros(nd, h, h, device="meta"))


def test_no_kernel_for_other_devices():
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.gru_forward(*_meta(2, 1, 3, 8))


def test_hidden_limit_mirrors_the_kernel_source():
    """The wrapper's cells are csrc/gru.cu's two-phase cells on the cluster
    plan of csrc/recurrence_cluster.cuh: the forward (GruFwd: r, z over h,
    then n over r o h) and the backward (GruBwd: dq over dr, dz with
    wrz's rows in place, then drh over dn with wh's); the limit is the
    largest H whose forward and backward 16-block clusters of one batch
    row fit a block's shared memory, above the former row rule's 5,282,
    and every H up to it has both plans."""
    csrc = Path(gru.__file__).parents[1] / "csrc"
    src = (csrc / "gru.cu").read_text()
    assert '#include "recurrence_cluster.cuh"' in src
    assert not (csrc / "recurrence_block.cuh").exists()
    for path in csrc.iterdir():
        assert "recurrence_block.cuh" not in path.read_text(), path.name
    for cell, (g, e, n_loc), v, (g1, v1), reverse, weight_t in (
            ("GruFwd", gru.FWD_CELL, gru.FWD_VALUES, gru.FWD_PHASE1,
             "false", "false"),
            ("GruBwd", gru.BWD_CELL, gru.BWD_VALUES, gru.BWD_PHASE1,
             "true", "true")):
        body = src[src.index(f"struct {cell} {{"):]
        body = body[:body.index("\n};\n")]
        assert f"static constexpr int E = {e}, L = {n_loc};" in body
        assert f"kReverse = {reverse}, kHasC = false;" in body
        p0 = body[body.index("struct P0 {"):body.index("struct P1 {")]
        p1 = body[body.index("struct P1 {"):]
        assert f"static constexpr int G = {g}, V = {v};" in p0
        assert f"static constexpr int G = {g1}, V = {v1};" in p1
        for phase in (p0, p1):
            assert f"kWeightT = {weight_t};" in phase
    # where each unit's E inputs come from: zr, zz of zrz and zn; the
    # backward's r, z (dzrz), n (dzn), h_{t-1} (hs at t - 1) and gout
    assert "return q < 2 ? In{0, q, 2, 0} : In{1, 0, 1, 0};" in src
    assert ("return q < 2 ? In{0, q, 2, 0}\n"
            "                 : (q == 2 ? In{1, 0, 1, 0}\n"
            "                           : (q == 3 ? In{2, 0, 1, -1} : "
            "In{3, 0, 1, 0}));") in src
    assert "__global__ void __launch_bounds__(kThreads)" not in src
    assert "launch_transpose" not in src   # the rows read in place
    assert "launch_planned<GruFwd>" in src and "launch_planned<GruBwd>" in src
    head = (csrc / "recurrence_cluster.cuh").read_text()
    assert "struct Phases<Cell, std::void_t<typename Cell::P1>>" in head
    assert "static constexpr int n = 2, L = Cell::L;" in head
    assert gru.MAX_HIDDEN == 14302 > 5282
    fwd, bwd = gru.smem_bytes(gru.MAX_HIDDEN)
    assert fwd < bwd <= rec.MAX_SMEM   # the backward's dr, dz state sets it
    assert max(gru.smem_bytes(gru.MAX_HIDDEN + 1)) > rec.MAX_SMEM
    for h in (1, 2, 5, 15, 16, 17, 128, 1200, 5282, gru.MAX_HIDDEN):
        for bwd_ in (False, True):
            assert gru.plan(2, 3, h, bwd_)["C"] > 0
    assert gru.plan(1, 3, gru.MAX_HIDDEN, True)["C"] == 16


# (D, B, H) -> (C, R, RT, KP, S, staged, depth, bytes) of the forward and
# the backward: the GRU classifier's width in both directions and in one
# (both weight slices in one block: no cluster), ragged H whose clusters
# take 2, 4, 8 and 16 blocks with B = 37, H = 700 and 1,500 (16 blocks,
# the weights through L2) and the largest H
PLANS = {
    (2, 128, 128): ((1, 2, 2, 2, 128, 1, 8, 229376),
                    (1, 2, 2, 2, 128, 1, 5, 231424)),
    (1, 128, 128): ((1, 1, 1, 2, 128, 1, 8, 215040),
                    (1, 1, 1, 2, 128, 1, 8, 223744)),
    (2, 37, 100): ((1, 1, 1, 2, 100, 1, 8, 134400),
                   (1, 1, 1, 2, 100, 1, 8, 141200)),
    (2, 37, 150): ((2, 2, 2, 2, 75, 1, 8, 157872),
                   (2, 2, 2, 2, 75, 1, 8, 168672)),
    (2, 37, 200): ((4, 4, 4, 4, 50, 1, 8, 153600),
                   (4, 4, 4, 4, 50, 1, 8, 169600)),
    (2, 37, 301): ((8, 8, 8, 4, 38, 1, 8, 197776),
                   (8, 8, 8, 4, 38, 1, 8, 226864)),
    (2, 37, 400): ((16, 16, 8, 4, 25, 1, 8, 225600),
                   (16, 16, 8, 4, 25, 0, 8, 144000)),
    (2, 37, 700): ((16, 16, 8, 2, 44, 0, 8, 162816),
                   (16, 16, 8, 2, 44, 0, 6, 224512)),
    (2, 9, 1500): ((16, 4, 4, 2, 94, 0, 8, 87104),
                   (16, 4, 4, 2, 94, 0, 8, 135168)),
    (1, 3, 14302): ((16, 1, 1, 1, 894, 0, 8, 207472),
                    (16, 1, 1, 1, 894, 0, 3, 232448)),
}


@pytest.mark.parametrize("shape", list(PLANS))
def test_plan_is_pinned(shape):
    """The forward's and backward's plans at each shape: a function of the
    shape alone, within a block's shared memory, its units split into C
    slices that cover H, its clusters side by side on the SMs; RT keeps
    a lane's accumulators (rows x two weights a unit) within 16."""
    nd, b, h = shape
    for want, bwd in zip(PLANS[shape], (False, True)):
        got = gru.plan(nd, b, h, bwd)
        assert tuple(got[f] for f in rec.PLAN_FIELDS) == want
        c, rows = got["C"], got["R"]
        assert got["bytes"] <= rec.MAX_SMEM and got["depth"] >= rec.MIN_DEPTH
        assert got["RT"] * 2 <= rec.MAX_ACC
        assert sum((k + 1) * h // c - k * h // c for k in range(c)) == h
        assert nd * -(-b // rows) * c <= rec.SMS or rows == 16


def test_two_phase_sizes_mirror_the_header():
    """A two-phase block holds each phase's state once (the other phase's
    barrier separates its reads from its next writes), L local values a
    unit, both weight slices where staged (phase 0's product reads phase
    1's V values a unit, and the other way round) and the ring; a
    one-phase block the same sizes as before, its state double-buffered."""
    h, rows, c, depth = 128, 2, 1, 5
    s = h
    ws = lambda n: -(-h * (s * n + 4) // 4) * 4
    want = (h * rows + 2 * h * rows + 2 * rows * s + ws(1 * 2) + ws(1 * 1)
            + depth * 5 * rows * s)
    assert rec.cluster_smem_floats(*gru.BWD_CELL, h, rows, c, True, depth,
                                   v=gru.BWD_VALUES,
                                   phase1=gru.BWD_PHASE1) == want
    # one phase (the LSTM forward): two buffers of h, c, one weight slice
    assert rec.cluster_smem_floats(4, 4, True, h, rows, c, True, depth) == (
        2 * h * rows + rows * s + ws(4) + depth * 4 * rows * s)


@pytest.mark.parametrize("which", ["forward", "backward"])
def test_hidden_above_the_limit_raises_before_a_launch(which):
    def call(h):
        args = _meta(2, 1, 3, h)
        if which == "forward":
            return ops.gru_forward(*args)
        hs = args[1]
        return ops.gru_backward(*args, hs, hs)

    with pytest.raises(NotImplementedError,
                       match=f"run H <= {gru.MAX_HIDDEN}"):
        call(gru.MAX_HIDDEN + 1)
    with pytest.raises(ValueError, match="no kernel for device"):
        call(gru.MAX_HIDDEN)


def _gru_loop64(zrz, zn, wrz, wh, h0):
    """The JAX GRUCell's step (r, z = sig(zrz + h wrz), n = tanh(zn + (r o
    h) wh), h' = (1 - z) n + z h) over T in float64 from h0."""
    hdim = wh.shape[-1]
    h, hs = h0, []
    for a, b in zip(zrz, zn):
        r, z = torch.split(torch.sigmoid(a + torch.matmul(h, wrz)), hdim,
                           dim=-1)
        n = torch.tanh(b + torch.matmul(r * h, wh))
        h = (1 - z) * n + z * h
        hs.append(h)
    return torch.stack(hs)


@pytest.mark.parametrize("case", [(5, 2, 3, 6), (1, 1, 2, 4), (9, 1, 4, 5)])
def test_initial_state_against_a_float64_loop(case):
    """From h0 != 0 (a truncated run's carried state): the plain forward,
    backward (hprev and r o hprev from h0 at t = 0) and both weight
    gradients, and the differentiable entry point, against a float64 loop
    of the JAX cell's step and its autograd gradients of sum(hs * g) in
    all four inputs; h0 gets no gradient."""
    args, go = _inputs(*case, seed=9)
    h0 = np.tanh(np.random.RandomState(10).randn(*case[1:]))
    x64 = [torch.from_numpy(a).double().requires_grad_() for a in args]
    hs64 = _gru_loop64(*x64, torch.from_numpy(h0))
    (hs64 * torch.from_numpy(go).double()).sum().backward()
    xt = [torch.from_numpy(a) for a in args]
    gt, h0t = torch.from_numpy(go), torch.from_numpy(h0.astype(np.float32))
    hs = ops.gru_forward_reference(*xt, h0t)
    dzrz, dzn, rh = ops.gru_backward_reference(*xt, hs, gt, h0t)
    dwrz, dwh = ops.gru_dwh_reference(hs, rh, dzrz, dzn, h0t)
    np.testing.assert_allclose(hs.numpy(), hs64.detach().numpy(), **FWD)
    for got, want in zip((dzrz, dzn, dwrz, dwh), x64):
        np.testing.assert_allclose(got.numpy(), want.grad.numpy(), **BWD)
    xg = [v.clone().requires_grad_() for v in xt]
    h0g = h0t.clone().requires_grad_()
    y = ops.gru_recurrence(*xg, h0g)
    (y * gt).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), hs64.detach().numpy(),
                               **FWD)
    for got, want in zip(xg, x64):
        np.testing.assert_allclose(got.grad.numpy(), want.grad.numpy(),
                                   **BWD)
    assert h0g.grad is None
