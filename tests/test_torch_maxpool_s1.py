"""The port's stride-1 max pool (bigdl_tpu_torch/ops/maxpool_s1.py, and
``nn.SpatialMaxPooling`` at stride 1) against the JAX package: the plain
versions against the stride-1 Pallas ``maxpool2d`` in interpret mode on
tests/test_pallas_ops.py's three geometries, with inputs quantized to
halves so that ties occur (the forward exact, the gradient rtol/atol
1e-5, the JAX test's own); the module against the JAX module under
``_PALLAS_POOL = "interpret"``, Inception's 3x3/s1/p1 ceil pool.

The NaN rule is the port's any-stride pool's (a NaN counts only at a
window's first tap), not the JAX stride-1 kernel's, which spreads a NaN
from any tap: the last test pins that documented difference.

On the CPU the wrappers take their plain versions; the CUDA kernels are
held against those on the card by ``chip_smoke.py``.  What the CPU can
reach of the kernels is their plan, mirrored by ``ops.maxpool_s1.plan``:
its constants are read from the source here, and its cut of every
geometry the smoke checks on the card is pinned.
"""
import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.nn import pooling as jax_pooling
from bigdl_tpu.nn.module import Context
from bigdl_tpu.ops.pallas_kernels import maxpool2d as jax_maxpool2d
from bigdl_tpu_torch import nn, ops
from bigdl_tpu_torch.nn import pooling
from bigdl_tpu_torch.ops import maxpool_s1

TOL = dict(rtol=1e-5, atol=1e-5)
CASES = [   # tests/test_pallas_ops.py TestPallasMaxPool
    ((2, 4, 14, 14), (3, 3), ((1, 1), (1, 1))),
    ((1, 2, 8, 8), (3, 3), ((1, 1), (1, 1))),
    ((2, 3, 10, 12), (2, 2), ((0, 1), (1, 0))),
    # the geometries the kernels' plan cuts differently, at small NC: 7x7
    # planes with NC not a multiple of 4, a plane cut into row bands with
    # W not a multiple of 4, a 5x5 window with pads 2 on 14x14 planes
    ((1, 6, 7, 7), (3, 3), ((1, 1), (1, 1))),
    ((1, 1, 40, 130), (3, 3), ((1, 1), (1, 1))),
    ((2, 3, 14, 14), (5, 5), ((2, 2), (2, 2))),
]
ROOT = Path(__file__).resolve().parents[1]
# chip_smoke.py's S1_CASES -> the plan of the forward and of the backward:
# path, then planes a group, rows a group, threads, groups, shared bytes
# (the unstaged path has no group)
PLANS = {
    ((2, 4, 14, 14), (3, 3), ((1, 1), (1, 1))):
        (("planes", 8, 14, 224, 1, 31440), ("planes", 8, 14, 224, 1, 45584)),
    ((1, 2, 8, 8), (3, 3), ((1, 1), (1, 1))):
        (("planes", 2, 8, 32, 1, 2640), ("planes", 2, 8, 32, 1, 3824)),
    ((2, 3, 10, 12), (2, 2), ((0, 1), (1, 0))):
        (("planes", 6, 10, 160, 1, 14480), ("planes", 6, 10, 160, 1, 20992)),
    ((128, 192, 28, 28), (3, 3), ((1, 1), (1, 1))):
        (("planes", 4, 28, 448, 6144, 62800),
         ("planes", 4, 28, 448, 6144, 91056)),
    ((128, 256, 28, 28), (3, 3), ((1, 1), (1, 1))):
        (("planes", 4, 28, 448, 8192, 62800),
         ("planes", 4, 28, 448, 8192, 91056)),
    ((128, 480, 14, 14), (3, 3), ((1, 1), (1, 1))):
        (("planes", 18, 14, 512, 3414, 70640),
         ("planes", 18, 14, 512, 3414, 102432)),
    ((128, 832, 7, 7), (3, 3), ((1, 1), (1, 1))):
        (("planes", 73, 7, 512, 1459, 71600),
         ("planes", 73, 7, 512, 1459, 103824)),
    ((2, 3, 112, 112), (3, 3), ((1, 1), (1, 1))):
        (("bands", 1, 32, 448, 24, 74448), ("bands", 1, 32, 512, 24, 112336)),
    ((1, 2, 100, 100), (40, 40), ((0, 0), (0, 0))):
        (("bands", 1, 40, 320, 4, 114400), ("bands", 1, 40, 512, 6, 188208)),
    ((1, 1, 243, 243), (242, 242), ((0, 0), (0, 0))):
        (("direct",), ("direct",)),
    ((3, 50, 7, 7), (3, 3), ((1, 1), (1, 1))):
        (("planes", 73, 7, 512, 3, 71600), ("planes", 73, 7, 512, 3, 103824)),
    ((1, 2, 301, 299), (3, 3), ((1, 1), (1, 1))):
        (("bands", 1, 8, 320, 76, 55120), ("bands", 1, 8, 512, 76, 91632)),
    ((4, 37, 14, 14), (5, 5), ((2, 2), (2, 2))):
        (("planes", 18, 14, 512, 9, 70640), ("planes", 18, 14, 512, 9, 102432)),
    ((8, 1024, 7, 7), (3, 3), ((1, 1), (1, 1))):
        (("planes", 73, 7, 512, 113, 71600),
         ("planes", 73, 7, 512, 113, 103824)),
}


def _quantized(rs, shape):
    return (np.round(rs.randn(*shape) * 2) / 2).astype(np.float32)


@pytest.mark.parametrize("shape,win,pads", CASES)
def test_plain_versions_match_the_pallas_kernel(shape, win, pads):
    rs = np.random.RandomState(0)
    x = _quantized(rs, shape)
    y_jax = jax_maxpool2d(jnp.asarray(x), win, (1, 1), pads, True)
    g = rs.randn(*y_jax.shape).astype(np.float32)
    d_jax = jax.grad(lambda v: (jax_maxpool2d(v, win, (1, 1), pads, True)
                                * g).sum())(jnp.asarray(x))

    xt = torch.from_numpy(x).requires_grad_()
    y = ops.maxpool2d_s1(xt, win, pads)
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(y_jax))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(d_jax), **TOL)
    y2 = ops.maxpool2d_s1_forward(torch.from_numpy(x), win, pads)
    dx = ops.maxpool2d_s1_backward(torch.from_numpy(x), torch.from_numpy(g),
                                   win, pads)
    np.testing.assert_array_equal(y2.numpy(), np.asarray(y_jax))
    np.testing.assert_allclose(dx.numpy(), np.asarray(d_jax), **TOL)


@pytest.mark.parametrize("shape", [(2, 6, 7, 7), (1, 3, 14, 10),
                                   (4, 5, 5)])
def test_module_routes_stride_one_pools_and_matches_jax(monkeypatch, shape):
    """``SpatialMaxPooling(3, 3, 1, 1, 1, 1).ceil()`` (every inception
    module's pool branch) goes through ``maxpool2d_s1``, never the
    argmax pool, and equals the JAX module forward and backward; one CHW
    sample is a batch of one."""
    monkeypatch.setattr(jax_pooling, "_PALLAS_POOL", "interpret")
    calls = []

    def s1(*a):
        calls.append("s1")
        return ops.maxpool2d_s1(*a)

    def strided(*a):
        calls.append("strided")
        return ops.maxpool2d(*a)

    monkeypatch.setattr(pooling, "maxpool2d_s1", s1)
    monkeypatch.setattr(pooling, "maxpool2d", strided)
    rs = np.random.RandomState(2)
    x = _quantized(rs, shape)
    jm = jnn.SpatialMaxPooling(3, 3, 1, 1, 1, 1).ceil()
    y_jax = jm.forward(jnp.asarray(x))
    g = rs.randn(*y_jax.shape).astype(np.float32)
    ctx = Context(training=True)
    d_jax = jax.grad(lambda v: (jm.apply(jm.params(), v, jm.state(),
                                         ctx)[0] * g).sum())(jnp.asarray(x))

    xt = torch.from_numpy(x).requires_grad_()
    y = nn.SpatialMaxPooling(3, 3, 1, 1, 1, 1).ceil()(xt)
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(y_jax))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(d_jax), **TOL)
    nn.SpatialMaxPooling(3, 3, 2, 2).ceil()(torch.from_numpy(x))
    assert calls == ["s1", "strided"]


@pytest.mark.parametrize("shape,win,pads", CASES)
def test_nan_rule_is_the_any_stride_pools(shape, win, pads):
    """With NaNs, the stride-1 pool gives the any-stride pool's output and
    gradient at stride 1, so a module's answer does not depend on its
    stride; the JAX stride-1 kernel instead spreads every NaN it meets."""
    rs = np.random.RandomState(7)
    x = _quantized(rs, shape)
    x[rs.rand(*shape) < 0.15] = np.nan
    xt = torch.from_numpy(x)
    y = ops.maxpool2d_s1_forward(xt, win, pads)
    y_any = ops.maxpool2d_forward(xt, win, (1, 1), pads, with_argmax=False)
    torch.testing.assert_close(y, y_any, rtol=0, atol=0, equal_nan=True)
    g = torch.from_numpy(rs.randn(*y.shape).astype(np.float32))
    a, b = xt.clone().requires_grad_(), xt.clone().requires_grad_()
    (ops.maxpool2d_s1(a, win, pads) * g).sum().backward()
    (ops.maxpool2d(b, win, (1, 1), pads) * g).sum().backward()
    torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=0)
    y_jax = np.asarray(jax_maxpool2d(jnp.asarray(x), win, (1, 1), pads, True))
    assert np.isnan(y_jax).sum() > np.isnan(y.numpy()).sum()


def test_plan_mirrors_the_kernel_source():
    """``ops.maxpool_s1``'s constants are csrc/maxpool2d_s1.cu's: the
    threads (a group's tasks), the strip rows, the ring's stages, the
    bulk copy's alignment and both shared-memory caps; and the source's
    plan takes the rules the mirror takes: whole planes where one plane's
    tasks and bytes fit, bands cut against the two caps in turn, taps of
    one or two bytes, copies of the 16-byte cover of a run counted in
    elements, buffers sized in the element's bytes."""
    src = (Path(maxpool_s1.__file__).parents[1] / "csrc"
           / "maxpool2d_s1.cu").read_text()

    def const(name):
        return eval(re.search(rf"constexpr \w+ {name} = ([^;,]+);",
                              src).group(1))

    assert const("kMaxThreads") == maxpool_s1.MAX_THREADS == 512
    assert const("kStripRows") == maxpool_s1.STRIP_ROWS == 8
    assert const("kStages") == maxpool_s1.STAGES == 3
    assert const("kAlign") == maxpool_s1.ALIGN == 16
    assert const("kSmemCap") == maxpool_s1.SMEM_CAP
    assert const("kSmemMax") == maxpool_s1.SMEM_MAX
    # two blocks an SM under the cap: 2 x (cap + 64 static + 1 KB) = 228 KB
    assert 2 * (maxpool_s1.SMEM_CAP + 64 + 1024) == 228 * 1024
    assert maxpool_s1.SMEM_MAX + 64 == 232448   # a block's most, 227 KB
    for line in (
            "if (tasks <= kMaxThreads && p.smem <= (long long)kSmemCap) {",
            "long long planes = kMaxThreads / tasks;",
            "const size_t caps[2] = {kSmemCap, kSmemMax};",
            "return taps <= 256 ? 1 : (taps <= 65536 ? 2 : 0);",
            "constexpr int kVec = kAlign / (int)sizeof(T);",
            "return (int)((reinterpret_cast<uintptr_t>(p) & (kAlign - 1)) / "
            "sizeof(T));",
            "return n > 0 ? (unsigned)((lead_of(src) + n + kVec<T> - 1) / "
            "kVec<T> *",
            "if (bytes) bulk_copy(buf, src - lead_of(src), bytes, bar);",
            "p->xbuf = round_up((long long)planes * p->xrows * W + v - 1, v);",
            "p->smem = eb * (kStages * p->xbuf + 2 * p->obuf);"):
        assert line in src, line
    assert maxpool_s1._tap_bytes(16, 16) == 1
    assert maxpool_s1._tap_bytes(16, 17) == 2
    assert maxpool_s1._tap_bytes(256, 256) == 2
    assert maxpool_s1._tap_bytes(256, 257) == 0


@pytest.mark.parametrize("geom", list(PLANS), ids=str)
def test_plan_is_pinned(geom):
    """The plan of each geometry chip_smoke.py checks on the card (where
    the library's own plan is held equal to the mirror): Inception's
    planes whole, several a group; 112x112 and 301x299 planes and the
    40x40 window in row bands (the backward's over two blocks' cap); the
    242x242 window on the unstaged kernels."""
    want_f, want_b = PLANS[geom]
    for want, bwd in ((want_f, False), (want_b, True)):
        got = maxpool_s1.plan(*geom, backward=bwd)
        assert got["stages"] == maxpool_s1.STAGES
        key = (got["path"],) if got["path"] == "direct" else (
            got["path"], got["planes"], got["rows"], got["threads"],
            got["groups"], got["smem_bytes"])
        assert key == want
        if got["path"] != "direct":
            cap = maxpool_s1.SMEM_MAX if got["path"] == "bands" else \
                maxpool_s1.SMEM_CAP
            assert got["smem_bytes"] <= cap
            assert got["threads"] <= maxpool_s1.MAX_THREADS


def test_pinned_plans_are_the_smokes_geometries():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert set(PLANS) == {tuple(c) for c in smoke.S1_CASES}
    paths = {maxpool_s1.plan(*c)["path"] for c in smoke.S1_CASES}
    assert paths == {"planes", "bands", "direct"}


def test_cpu_path_counts_no_launch():
    ops.reset_launch_counts()
    x = torch.randn(2, 3, 6, 6, requires_grad=True)
    ops.maxpool2d_s1(x, (3, 3), ((1, 1), (1, 1))).sum().backward()
    counts = ops.launch_counts()
    assert counts["maxpool2d_s1_forward"] == 0
    assert counts["maxpool2d_s1_backward"] == 0
    assert ops.maxpool2d_s1_forward in ops.KERNELS
    assert ops.maxpool2d_s1_backward in ops.KERNELS
