"""The bf16 forms of the port's pool, stride-1 pool, LRN, LSTM and RNN
kernels (the kernels a reduced dtype policy runs) on the CPU: each plain
version on bf16 inputs against the JAX Pallas kernel in the interpreter
on the same inputs, the wrappers' dispatch on dtype (the C entry of each
form, in its source; a ``TypeError`` for a dtype no form takes; the bf16
launches counted apart), and the plans of the bf16 forms (the stride-1
pool's staged groups, the RNN's cluster plans and largest H).  The CUDA
forms themselves run on the card (``chip_smoke.py --bf16``).

Tolerances: the pools' forwards bit for bit (the max of bf16 values is
exact), their backwards within one bf16 ulp (the sums of overlapping
windows are taken in f32 in another order, then rounded once); the LRN
within one bf16 ulp (f32 arithmetic rounded once to bf16 in both); the
LSTM and the RNN within rtol 1e-3 / atol 1e-4 at T <= 9: only the f32
accumulation order differs, but one flipped bf16 rounding of h (dz) can
move a product."""
import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.ops import pallas_kernels as pk
from bigdl_tpu_torch import ops
from bigdl_tpu_torch.ops import _activation
from bigdl_tpu_torch.ops import _recurrence as rec
from bigdl_tpu_torch.ops import bilstm, lrn, maxpool, maxpool_s1, rnn

scan = importlib.import_module("bigdl_tpu_torch.ops.lstm_scan")
CSRC = Path(bilstm.__file__).parents[1] / "csrc"
LSTM_TOL = dict(rtol=1e-3, atol=1e-4)


def _bf16(shape, seed, scale=1.0, halves=False):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32) * scale
    if halves:   # ties in every window
        x = np.round(x * 2) / 2
    t = torch.from_numpy(x).bfloat16()
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _ulps(a, b):
    """The largest |a - b| in bf16 ulps of the larger magnitude."""
    a, b = _f32(a).astype(np.float64), _f32(b).astype(np.float64)
    big = np.maximum(np.abs(a), np.abs(b))
    _, e = np.frexp(big)
    return float(np.max(np.abs(a - b) / np.ldexp(1.0, e - 8)))


POOLS = [((2, 5, 13, 17), (3, 3), (2, 2), ((1, 1), (1, 1))),
         ((1, 4, 9, 11), (2, 2), (2, 2), ((0, 1), (1, 0))),
         ((2, 3, 12, 12), (2, 2), (2, 2), ((0, 0), (0, 0))),
         ((2, 3, 13, 13), (3, 3), (2, 2), ((0, 1), (0, 1)))]


@pytest.mark.parametrize("shape,win,st,pads", POOLS)
def test_pool_bf16_plain_matches_the_mosaic_kernel(shape, win, st, pads):
    x, xj = _bf16(shape, 0, halves=True)
    y, arg = ops.maxpool2d_forward_reference(x, win, st, pads)
    yj, vjp = jax.vjp(lambda v: pk.mosaic_maxpool2d(v, win, st, pads, True),
                      xj)
    assert y.dtype == torch.bfloat16 and yj.dtype == jnp.bfloat16
    np.testing.assert_array_equal(_f32(y), _f32(yj))
    g, gj = _bf16(y.shape, 1)
    dx = ops.maxpool2d_backward_reference(arg, g, win, st, pads, shape)
    (dxj,) = vjp(gj)
    assert dx.dtype == torch.bfloat16 and dxj.dtype == jnp.bfloat16
    assert _ulps(dx, dxj) <= 1


@pytest.mark.parametrize("shape,win,pads", [
    ((2, 4, 7, 7), (3, 3), ((1, 1), (1, 1))),
    ((2, 3, 10, 12), (2, 2), ((0, 1), (1, 0))),
    ((1, 2, 8, 8), (3, 3), ((1, 1), (1, 1)))])
def test_pool_s1_bf16_plain_matches_the_kernel(shape, win, pads):
    x, xj = _bf16(shape, 2, halves=True)
    y = ops.maxpool2d_s1_forward_reference(x, win, pads)
    yj, vjp = jax.vjp(lambda v: pk.maxpool2d(v, win, (1, 1), pads, True), xj)
    assert y.dtype == torch.bfloat16 and yj.dtype == jnp.bfloat16
    np.testing.assert_array_equal(_f32(y), _f32(yj))
    g, gj = _bf16(y.shape, 3)
    dx = ops.maxpool2d_s1_backward_reference(x, g, win, pads)
    (dxj,) = vjp(gj)
    assert dx.dtype == torch.bfloat16
    assert _ulps(dx, dxj) <= 1


@pytest.mark.parametrize("shape,hyper", [
    ((2, 8, 16, 8), (5, 1.0, 0.75, 1.0)),
    ((2, 8, 7, 9), (5, 1e-4, 0.75, 1.0)),
    ((2, 6, 16, 16), (3, 2e-4, 0.9, 2.0))])
def test_lrn_bf16_plain_matches_the_kernel(shape, hyper):
    x, xj = _bf16(shape, 4, scale=2.0)
    y, z = ops.lrn_forward_reference(x, *hyper)
    yj, vjp = jax.vjp(lambda v: pk.lrn_channel(v, *hyper, True), xj)
    assert y.dtype == torch.bfloat16 and yj.dtype == jnp.bfloat16
    assert z.dtype == torch.float32     # the residual stays f32, as JAX's
    assert _ulps(y, yj) <= 1
    g, gj = _bf16(shape, 5)
    dx = ops.lrn_backward_reference(x, z, g, *hyper)
    (dxj,) = vjp(gj)
    assert dx.dtype == torch.bfloat16
    assert _ulps(dx, dxj) <= 1


def _lstm_inputs(t, nd, b, h, zx_bf16, seed=6):
    rs = np.random.RandomState(seed)
    zx = rs.randn(t, nd, b, 4 * h).astype(np.float32)
    wht = ((rs.rand(nd, h, 4 * h) * 2 - 1) / np.sqrt(h)).astype(np.float32)
    gout = rs.randn(t, nd, b, h).astype(np.float32)
    zt = torch.from_numpy(zx)
    zt = zt.bfloat16() if zx_bf16 else zt
    wt = torch.from_numpy(wht).bfloat16()
    zj = jnp.asarray(zt.float().numpy(),
                     jnp.bfloat16 if zx_bf16 else jnp.float32)
    return zt, wt, torch.from_numpy(gout), zj, \
        jnp.asarray(wt.float().numpy(), jnp.bfloat16), jnp.asarray(gout)


@pytest.mark.parametrize("t,nd,b,h", [(7, 2, 3, 5), (8, 1, 4, 6),
                                      (5, 2, 2, 9)])
@pytest.mark.parametrize("zx_bf16", [True, False])
def test_bilstm_bf16_plain_matches_the_kernel(t, nd, b, h, zx_bf16):
    """Forward and VJP from zeros, D = 1 and 2, zx bf16 (BiRecurrent's)
    and f32 (Recurrent's), wht bf16: the hs stack, dzx and dwht in zx's
    and wht's dtypes, as the JAX VJP returns them."""
    zx, wht, gout, zj, wj, gj = _lstm_inputs(t, nd, b, h, zx_bf16)
    zg, wg = zx.clone().requires_grad_(), wht.clone().requires_grad_()
    hs = ops.bilstm_recurrence(zg, wg)
    hs.backward(gout)
    hj, vjp = jax.vjp(lambda z, w: pk.bilstm_recurrence(z, w, True), zj, wj)
    dzj, dwj = vjp(gj)
    assert hs.dtype == torch.float32 and hj.dtype == jnp.float32
    np.testing.assert_allclose(_f32(hs.detach()), _f32(hj), **LSTM_TOL)
    assert zg.grad.dtype == zx.dtype and wg.grad.dtype == torch.bfloat16
    assert str(dzj.dtype) == str(zx.dtype).replace("torch.", "")
    assert dwj.dtype == jnp.bfloat16
    np.testing.assert_allclose(_f32(zg.grad), _f32(dzj), **LSTM_TOL)
    np.testing.assert_allclose(_f32(wg.grad), _f32(dwj), **LSTM_TOL)


@pytest.mark.parametrize("t,b,h", [(7, 3, 5), (8, 4, 6)])
def test_lstm_scan_bf16_plain_matches_the_kernel(t, b, h):
    """From h0, c0 on a bf16 wht (zx f32): the JAX kernel's
    ``bf16(h) . wht``."""
    zx, wht, _, zj, wj, _ = _lstm_inputs(t, 1, b, h, False, seed=7)
    rs = np.random.RandomState(8)
    h0 = (rs.randn(b, h) * 0.5).astype(np.float32)
    c0 = (rs.randn(b, h) * 0.5).astype(np.float32)
    hs = ops.lstm_scan_reference(zx[:, 0], wht[0], torch.from_numpy(h0),
                                 torch.from_numpy(c0))
    hj = pk.lstm_scan(zj[:, 0], wj[0], jnp.asarray(h0), jnp.asarray(c0),
                      interpret=True)
    assert hs.dtype == torch.float32
    np.testing.assert_allclose(_f32(hs), _f32(hj), **LSTM_TOL)


@pytest.mark.parametrize("t,nd,b,h", [(9, 2, 3, 6), (8, 1, 4, 5),
                                      (5, 1, 2, 9)])
def test_rnn_bf16_plain_matches_the_kernel(t, nd, b, h):
    """Forward and VJP from zeros on a bf16 wht (zx f32: Recurrent's
    projection): the hs stack and dzx f32, dwht bf16, as the JAX VJP
    returns them (``bf16(h) . wht`` forward, ``bf16(dz) . wht^T``
    backward, dwh summed in f32)."""
    rs = np.random.RandomState(10)
    zx = rs.randn(t, nd, b, h).astype(np.float32)
    wht = torch.from_numpy(((rs.rand(nd, h, h) * 2 - 1) / np.sqrt(h))
                           .astype(np.float32)).bfloat16()
    gout = rs.randn(t, nd, b, h).astype(np.float32)
    zg = torch.from_numpy(zx).requires_grad_()
    wg = wht.clone().requires_grad_()
    hs = ops.rnn_recurrence(zg, wg)
    hs.backward(torch.from_numpy(gout))
    hj, vjp = jax.vjp(lambda z, w: pk.rnn_recurrence(z, w, True),
                      jnp.asarray(zx),
                      jnp.asarray(wht.float().numpy(), jnp.bfloat16))
    dzj, dwj = vjp(jnp.asarray(gout))
    assert hs.dtype == torch.float32 and hj.dtype == jnp.float32
    np.testing.assert_allclose(_f32(hs.detach()), _f32(hj), **LSTM_TOL)
    assert zg.grad.dtype == torch.float32 and dzj.dtype == jnp.float32
    assert wg.grad.dtype == torch.bfloat16 and dwj.dtype == jnp.bfloat16
    np.testing.assert_allclose(_f32(zg.grad), _f32(dzj), **LSTM_TOL)
    np.testing.assert_allclose(_f32(wg.grad), _f32(dwj), **LSTM_TOL)
    # the wrappers' own forms: the h stack and dzx f32, dwh f32
    dzx = ops.rnn_backward(wht, hs.detach(), torch.from_numpy(gout))
    assert torch.equal(dzx, zg.grad)
    assert torch.equal(ops.rnn_dwh(hs.detach(), dzx).bfloat16(), wg.grad)


def test_rnn_bf16_plain_rounds_at_the_product_only():
    """From an h0, under an activation other than tanh: the bf16 form's
    plain forward is the f32 loop on bf16(h) . wht, and its backward's
    pre-activations are zx + bf16(hprev) . wht."""
    rs = np.random.RandomState(11)
    zx = torch.from_numpy(rs.randn(6, 1, 3, 7).astype(np.float32))
    wht = torch.from_numpy(rs.randn(1, 7, 7).astype(np.float32) * 0.3)
    wb = wht.bfloat16()
    h0 = torch.from_numpy(rs.randn(1, 3, 7).astype(np.float32)).tanh()
    act = ops.Act("softsign")
    hs = ops.rnn_forward(zx, wb, h0, act)
    h, want = h0, []
    for step in range(6):
        pre = zx[step] + torch.matmul(h.bfloat16().float(), wb.float())
        h = pre / (1 + pre.abs())
        want.append(h)
    torch.testing.assert_close(hs, torch.stack(want), rtol=0, atol=0)
    gout = torch.from_numpy(rs.randn(6, 1, 3, 7).astype(np.float32))
    dzx = ops.rnn_backward(wb, hs, gout, act, zx, h0)
    pre = zx + torch.matmul(rec.shift_prev(hs, h0).bfloat16().float(),
                            wb.float())
    dh = torch.zeros(1, 3, 7)
    for step in reversed(range(6)):
        dz = (gout[step] + dh) * _activation.derivative(act, pre[step],
                                                        hs[step])
        torch.testing.assert_close(dzx[step], dz, rtol=0, atol=0)
        dh = torch.matmul(dz.bfloat16().float(), wb.float().transpose(1, 2))


def test_rnn_bf16_plans_and_largest_hidden():
    """A bf16 weight's slice takes half the f32 bytes, so the RNN's bf16
    plans are their own (SimpleRNN's and the (500, 2, 128, 128) ones in
    less shared memory); the largest H is the f32 form's, 24,464, its
    16-block plan reading the weight through L2 in both forms."""
    bf = torch.bfloat16
    assert rnn.FORMS == {torch.float32: "f32", torch.bfloat16: "bf16"}
    assert rnn.plan(1, 4, 40, dtype=bf) == dict(
        C=1, R=1, RT=1, KP=4, S=40, staged=1, depth=8, bytes=5120)
    assert rnn.plan(1, 4, 40)["bytes"] == 8640
    assert rnn.plan(2, 128, 128, dtype=bf) == dict(
        C=1, R=2, RT=2, KP=2, S=128, staged=1, depth=8, bytes=44032)
    assert rnn.plan(2, 128, 128, True, dtype=bf)["bytes"] == 52224
    assert rnn.MAX_HIDDEN == 24464
    for bwd in (False, True):
        p = rnn.plan(1, 3, rnn.MAX_HIDDEN, bwd, dtype=bf)
        assert p["C"] == 16 and not p["staged"]
        assert p == rnn.plan(1, 3, rnn.MAX_HIDDEN, bwd)
    with pytest.raises(NotImplementedError, match="run H <= 24464"):
        ops.rnn_forward(torch.zeros(2, 1, 3, 24465, device="meta"),
                        torch.zeros(1, 24465, 24465, device="meta",
                                    dtype=bf))
    with pytest.raises(TypeError, match="no kernel for"):
        rnn.plan(1, 4, 40, dtype=torch.float16)


def test_no_grad_lstm_bf16_is_the_grad_route_s_forward():
    zx, wht, *_ = _lstm_inputs(6, 1, 3, 5, False)
    zero = torch.zeros(3, 5)
    with torch.no_grad():
        got = ops.lstm_scan(zx[:, 0], wht[0], zero, zero)
    want = ops.bilstm_forward_reference(zx, wht, with_c=False)[:, 0]
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# -- the wrappers' dispatch on dtype ---------------------------------------

@pytest.mark.parametrize("module,source,names", [
    (maxpool, "maxpool2d.cu", ("fwd", "bwd")),
    (maxpool_s1, "maxpool2d_s1.cu", ("fwd", "bwd")),
    (lrn, "lrn.cu", ("fwd", "bwd")),
    (rnn, "rnn*.cu", ("fwd", "bwd"))])
def test_a_bf16_tensor_reaches_the_bf16_form(module, source, names):
    """The dispatch table: each dtype's C entry exists in the kernel's
    sources, bf16 names its own form (never the f32 one), and a dtype no
    form takes raises before any launch."""
    src = "".join(p.read_text() for p in sorted(CSRC.glob(source)))
    for which in names:
        f32 = module.entry(which, torch.float32)
        bf16 = module.entry(which, torch.bfloat16)
        assert f32.endswith("_f32") and bf16.endswith("_bf16")
        for name in (f32, bf16):
            assert f"int {name}(" in src, name
        for bad in (torch.float64, torch.float16):
            with pytest.raises(TypeError, match="no kernel for"):
                module.entry(which, bad)


def test_the_lstm_forms_by_zx_and_wht():
    src = (CSRC / "bilstm.cu").read_text()
    forms = {(torch.float32, torch.float32): "f32",
             (torch.bfloat16, torch.bfloat16): "bf16",
             (torch.float32, torch.bfloat16): "bf16w"}
    assert bilstm.FORMS == forms
    for (zx_dt, wht_dt), form in forms.items():
        for which in ("fwd", "bwd"):
            name = bilstm.entry(which, zx_dt, wht_dt)
            assert name == f"bigdl_lstm_{which}_{form}"
            assert f"int {name}(" in src
    for zx_dt, wht_dt in ((torch.bfloat16, torch.float32),
                          (torch.float64, torch.float64)):
        with pytest.raises(TypeError, match="no kernel for"):
            bilstm.entry("fwd", zx_dt, wht_dt)
    # each bf16 entry launches a cell on a bf16 weight
    assert "struct LstmFwdBf16 : LstmFwd {" in src
    assert "struct LstmFwdBf16W : LstmFwd {" in src
    assert "struct LstmBwdBf16 : LstmBwd {" in src
    assert "lstm_fwd<LstmFwdBf16>(" in src and "lstm_fwd<LstmFwdBf16W>(" in src
    assert src.count("lstm_bwd<LstmBwdBf16>(") == 2


def test_bf16_weight_plans_mirror_the_slice_bytes():
    """A bf16 weight slice takes half the f32 floats (whole 16-byte
    granules), so the bf16 plans are their own; the largest H is the
    same in both forms, its plan reading the weight through L2."""
    src = (CSRC / "recurrence_cluster.cuh").read_text()
    assert ("return ((long long)H * ws * (long long)sizeof(WT) + 15) / 16 * 4;"
            in src)
    for hdim, ws in ((128, 260), (5, 24), (6197, 1556)):
        assert rec._slice_floats(hdim, ws, 4) == (hdim * ws + 3) // 4 * 4
        assert rec._slice_floats(hdim, ws, 2) == -(-hdim * ws * 2 // 16) * 4
    # the Bi-LSTM's width: one 128-row block holds the whole bf16 weight
    assert bilstm.plan(2, 128, 128, dtype=torch.bfloat16) == dict(
        C=1, R=2, RT=2, KP=2, S=128, staged=1, depth=8, bytes=167936)
    assert bilstm.plan(2, 128, 128, True, dtype=torch.bfloat16)["C"] == 1
    assert bilstm.plan(2, 128, 128)["C"] == 2       # f32: two blocks
    assert scan.plan(128, 128, torch.bfloat16) == bilstm.plan(
        1, 128, 128, dtype=torch.bfloat16)
    assert bilstm.MAX_HIDDEN == 6197
    for bwd in (False, True):
        p = bilstm.plan(1, 3, bilstm.MAX_HIDDEN, bwd, dtype=torch.bfloat16)
        assert p["C"] == 16 and not p["staged"]


def test_the_bf16_launches_are_counted_apart():
    ops.reset_launch_counts()
    counts = ops.launch_counts()
    bf16 = {k for k in counts if k.endswith("_bf16")}
    assert bf16 == {f"{k}_bf16" for k in (
        "maxpool2d_forward", "maxpool2d_backward", "maxpool2d_s1_forward",
        "maxpool2d_s1_backward", "lrn_forward", "lrn_backward",
        "bilstm_forward", "bilstm_backward", "lstm_scan", "rnn_forward",
        "rnn_backward")}
    assert "rnn_dwh_bf16" not in counts    # dwh has its f32 form only
    # a CPU tensor runs the plain version and counts no launch
    x, _ = _bf16((1, 2, 6, 6), 9)
    ops.maxpool2d(x.requires_grad_(), (2, 2), (2, 2),
                  ((0, 0), (0, 0))).sum().backward()
    wht = torch.zeros(1, 3, 3, dtype=torch.bfloat16, requires_grad=True)
    ops.rnn_recurrence(torch.ones(2, 1, 2, 3, requires_grad=True),
                       wht).sum().backward()
    assert set(ops.launch_counts().values()) == {0}
    for k in ops.KERNELS:
        if hasattr(k, "launches_bf16"):
            k.launches_bf16 = 3
    assert {ops.launch_counts()[k] for k in bf16} == {3}
    ops.reset_launch_counts()
    assert set(ops.launch_counts().values()) == {0}


def test_sm90_build_of_every_form():
    """The bf16 forms live in the same sources the build compiles for
    sm_90a (one library a source, no new file): the stride-1 pool's
    staged kernels and its unstaged test entries for both forms, the
    rnn's bf16-weight entries and plan, the pre-pass on a typed weight;
    the any-stride pool's one-thread-an-element bf16 backward is gone,
    both backwards the one staged kernel."""
    from bigdl_tpu_torch.ops import _build

    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    for name in ("maxpool2d", "maxpool2d_s1", "lrn", "bilstm", "rnn",
                 "rnn_bf16"):
        assert _build.SOURCES[name] == f"{name}.cu"
        assert "#include <cuda_bf16.h>" in "".join(
            p.read_text() for p in _build.sources(name))
    s1 = (CSRC / "maxpool2d_s1.cu").read_text()
    for which in ("fwd", "bwd"):
        assert f"int bigdl_maxpool2d_s1_{which}_bf16_unstaged(" in s1
    with pytest.raises(TypeError, match="take bf16 CUDA tensors"):
        maxpool_s1.unstaged_forward(torch.zeros(1, 1, 3, 3), *S1_3x3)
    assert "s1_fwd_staged<3, 3, T>" in s1
    assert "s1_bwd_staged<3, 3, uint8_t, T>" in s1
    assert "int kh, int kw, int bwd, int eb," in s1    # the plan's bytes
    s2 = (CSRC / "maxpool2d.cu").read_text()
    assert "maxpool2d_bwd_bf16_kernel" not in s2
    assert s2.count("return launch_bwd_planned(g, argmax, dx,") == 2
    # the rnn's two forms: two libraries on one cells header, so that
    # nvcc builds them in parallel; the bf16 kernels only in rnn_bf16.cu
    cells = (CSRC / "rnn_cells.cuh").read_text()
    f32_src, bf16_src = ((CSRC / f).read_text()
                         for f in ("rnn.cu", "rnn_bf16.cu"))
    assert "struct RnnFwdBf16 : RnnFwd<TANH> {" in cells
    assert "struct RnnBwdBf16 : RnnBwd<TANH> {" in cells
    for src in (f32_src, bf16_src):
        assert '#include "rnn_cells.cuh"' in src
    assert "return rnn_fwd<RnnFwdBf16>(" in bf16_src
    assert "return rnn_bwd<RnnBwdBf16>(" in bf16_src
    assert "RnnFwdBf16>(" not in f32_src and "RnnBwdBf16>(" not in f32_src
    assert ("void bigdl_rnn_plan_bf16(int bwd, int D, int B, int H, "
            "int* out) {") in f32_src
    assert rnn._LIBRARY == {torch.float32: "rnn", torch.bfloat16: "rnn_bf16"}
    dwh = (CSRC / "recurrence_dwh.cuh").read_text()
    assert "template <int EPI, bool RH, class WT>" in dwh
    assert "? at_product<WT>(arow[k]) : 0.0f;" in dwh


# the bf16 stride-1 plans at Inception-v1's pools (batch 128, 3x3 p1) and
# the zoo's (8, 1024, 7, 7), beside test_torch_maxpool_s1.py's f32 PLANS:
# (path, planes a group, rows, threads, groups, shared bytes) forward and
# backward.  The groups are the f32 form's (a group's tasks bound them),
# in half the f32 stages' bytes
BF16_S1_PLANS = {
    (128, 192, 28, 28): (("planes", 4, 28, 448, 6144, 31440),
                         ("planes", 4, 28, 448, 6144, 47152)),
    (128, 256, 28, 28): (("planes", 4, 28, 448, 8192, 31440),
                         ("planes", 4, 28, 448, 8192, 47152)),
    (128, 480, 14, 14): (("planes", 18, 14, 512, 3414, 35360),
                         ("planes", 18, 14, 512, 3414, 53040)),
    (128, 512, 14, 14): (("planes", 18, 14, 512, 3641, 35360),
                         ("planes", 18, 14, 512, 3641, 53040)),
    (128, 528, 14, 14): (("planes", 18, 14, 512, 3755, 35360),
                         ("planes", 18, 14, 512, 3755, 53040)),
    (128, 832, 7, 7): (("planes", 73, 7, 512, 1459, 35840),
                       ("planes", 73, 7, 512, 1459, 53760)),
    (8, 1024, 7, 7): (("planes", 73, 7, 512, 113, 35840),
                      ("planes", 73, 7, 512, 113, 53760)),
}
S1_3x3 = ((3, 3), ((1, 1), (1, 1)))


@pytest.mark.parametrize("shape", list(BF16_S1_PLANS), ids=str)
def test_bf16_s1_plan_is_pinned(shape):
    """The bf16 form's plans at Inception's nine pools' six shapes and
    the zoo's 7x7: staged whole planes, as the f32 form's."""
    want_f, want_b = BF16_S1_PLANS[shape]
    for want, bwd in ((want_f, False), (want_b, True)):
        got = maxpool_s1.plan(shape, *S1_3x3, backward=bwd,
                              dtype=torch.bfloat16)
        assert (got["path"], got["planes"], got["rows"], got["threads"],
                got["groups"], got["smem_bytes"]) == want
        f32 = maxpool_s1.plan(shape, *S1_3x3, backward=bwd)
        assert {k: got[k] for k in ("planes", "rows", "groups", "threads")
                } == {k: f32[k] for k in ("planes", "rows", "groups",
                                          "threads")}
        assert got["smem_bytes"] <= maxpool_s1.SMEM_CAP


def test_bf16_s1_plan_is_staged_where_the_f32_plan_is():
    """``plan(dtype=torch.bfloat16)`` is no longer "direct" wherever the
    f32 plan is staged: at every geometry the smoke checks (bands too),
    the bf16 plan takes the f32 path or a staged one of its own (a band
    of two-byte rows fits where the f32 one did)."""
    from tests.test_torch_maxpool_s1 import PLANS

    for geom in PLANS:
        for bwd in (False, True):
            f32 = maxpool_s1.plan(*geom, backward=bwd)
            bf = maxpool_s1.plan(*geom, backward=bwd, dtype=torch.bfloat16)
            if f32["path"] == "direct":
                assert bf["path"] == "direct", geom   # too tall a window
            else:
                assert bf["path"] in ("planes", "bands"), geom
                assert bf["smem_bytes"] < f32["smem_bytes"]
                assert bf["groups"] <= f32["groups"]
