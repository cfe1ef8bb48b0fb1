"""The port's GRU recurrence (bigdl_tpu_torch/ops/gru.py) against the JAX
package's ``gru_recurrence`` run through the Pallas interpreter: the
plain forward (h stack), backward (dzrz, dzn) and weight gradients
(dwrz, dwh) against the kernel and its ``jax.vjp`` for one and two
directions, T of 1 to 13 and ragged batches, and against the JAX
kernel's multi-step blocking (``test_pallas_ops.py::test_gru_blocked``'s
shape at ``block_t=4``); the r o hprev stack the backward hands the
weight gradient; the ``torch.autograd.Function`` by ``gradcheck`` in
float64.  Tolerances are the JAX tests' own: forward rtol 1e-5 / atol
1e-6, gradients rtol 1e-4 / atol 1e-5.

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
    """The wrapper's block sizes are csrc/gru.cu's; every H up to the
    limit fits one row, and 8 rows fit the classifier's 128."""
    src = (Path(gru.__file__).parents[1] / "csrc" / "gru.cu").read_text()
    assert ("R * 9 * H + red_floats(groups(H, 2 * H), 2 * H, groups(H, H), "
            "H, R)") in src
    assert ("R * 11 * H + red_floats(groups(H, H), H, groups(2 * H, H), H, "
            "R)") in src
    assert gru.MAX_HIDDEN == 5282
    assert max(gru.smem_bytes(gru.MAX_HIDDEN, 1)) <= rec.MAX_SMEM
    assert max(gru.smem_bytes(gru.MAX_HIDDEN + 1, 1)) > rec.MAX_SMEM
    assert gru.rows_for(128) == gru.rows_for(100) == 8
    assert gru.rows_for(gru.MAX_HIDDEN) == 1


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
