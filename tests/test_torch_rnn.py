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

Also the shared build and plan rules: the cluster plan and shared-memory
sizes mirror ``csrc/recurrence_cluster.cuh`` and ``csrc/rnn.cu``, H past
``MAX_HIDDEN`` is refused before a launch, and the library's cache key
moves with the bytes of a header it includes.

On the CPU the wrappers take their plain versions; the CUDA kernels are
held against those on the card by ``chip_smoke.py``.
"""
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
    """The wrapper's cells and sizes are csrc/rnn.cu's (its cells in
    rnn_cells.cuh, which rnn_bf16.cu shares), on the cluster plan of
    csrc/recurrence_cluster.cuh; the limit is the largest H whose 16-block
    cluster of one batch row fits a block's shared memory, at least PR
    5's 14,528, and every H up to it has a plan."""
    src = "".join((CSRC / f).read_text() for f in ("rnn.cu",
                                                     "rnn_cells.cuh"))
    assert '#include "recurrence_cluster.cuh"' in src
    assert '#include "recurrence_block.cuh"' not in src
    # the forward's one input is zx; the backward's two are gout and h
    for cell, (g, e, has_c), where in (
            ("RnnFwd", rnn.FWD_CELL, "input(int) { return {0, 0, 1, 0}; }"),
            ("RnnBwd", rnn.BWD_CELL,
             "input(int q) { return {q, 0, 1, 0}; }")):
        body = src[src.index(f"struct {cell} {{"):]
        body = body[:body.index("update(")]
        assert f"static constexpr int G = {g}, V = 1, E = {e};" in body
        assert f"kHasC = {str(has_c).lower()}" in body
        assert where in body
    assert "rnn_fwd_kernel" not in src and "rnn_bwd_kernel" not in src
    assert "__global__" not in src   # the kernels are the header's template
    assert "launch_transpose" not in src
    assert rnn.MAX_HIDDEN == 24464 >= 14528
    assert max(rnn.smem_bytes(rnn.MAX_HIDDEN)) <= rec.MAX_SMEM
    assert max(rnn.smem_bytes(rnn.MAX_HIDDEN + 1)) > rec.MAX_SMEM
    for h in (1, 2, 15, 16, 17, 40, 128, 5000, rnn.MAX_HIDDEN):
        for bwd in (False, True):
            assert rnn.plan(2, 3, h, bwd)["C"] > 0
    assert rnn.plan(1, 3, rnn.MAX_HIDDEN)["C"] == 16


def test_cluster_header_constants_are_mirrored():
    """ops._recurrence mirrors csrc/recurrence_cluster.cuh: the block's
    threads and shared memory, the ring's depth rule, the SMs the rows
    fill, the run length of a lane's sum, the cluster sizes and batch rows
    the plan tries, the accumulators a lane holds, the weight slice's
    stride and the plan's order of choice."""
    src = (CSRC / "recurrence_cluster.cuh").read_text()
    for line in (f"constexpr int kThreads = {rec.CLUSTER_THREADS};",
                 f"constexpr int kMaxSmem = {rec.MAX_SMEM};",
                 f"constexpr int kMinDepth = {rec.MIN_DEPTH};",
                 f"constexpr int kMaxDepth = {rec.MAX_DEPTH};",
                 f"constexpr int kSms = {rec.SMS};",
                 f"constexpr int kChunk = {rec.CHUNK};",
                 "constexpr int kClusterSizes[] = {1, 2, 4, 8, 16};",
                 "constexpr int kRowChoices[] = {1, 2, 4, 8, 16};",
                 f"constexpr int kMaxAcc = {rec.MAX_ACC};",
                 "return S * G + 4;",
                 "p.staged = fixed + kMinDepth * stage <= cap;",
                 "p.depth = depth < kMaxDepth ? (int)depth : kMaxDepth;",
                 "if (p.C != 0 && p.staged) return p;",
                 "for (int R = fill_rows(D, B, 16); R >= 1; R /= 2) {",
                 "if ((long long)D * ((B + R - 1) / R) * C <= kSms) return R;"):
        assert line in src, line
    assert rec.CLUSTER_SIZES == rec.CLUSTER_ROWS == (1, 2, 4, 8, 16)
    assert "cudaLaunchAttributeClusterDimension" in src
    assert "cudaOccupancyMaxActiveClusters" in src
    assert "barrier.cluster.arrive.release.aligned" in src
    assert "st.shared::cluster.v4.f32" in src


# (D, B, H) -> (C, R, RT, KP, S, staged, depth, bytes) of the forward and
# the backward: SimpleRNN's chunk, the classifier's width in both
# directions and in one, ragged H at 2, 4, 8 and 16 blocks with B = 37
# (no R divides it), H = 1,001 and the largest H (16 blocks, wht
# through L2)
PLANS = {
    (1, 4, 40): ((1, 1, 1, 4, 40, 1, 8, 8640),
                 (1, 1, 1, 4, 40, 1, 8, 9920)),
    (2, 128, 128): ((1, 2, 2, 2, 128, 1, 8, 77824),
                    (1, 2, 2, 2, 128, 1, 8, 86016)),
    (1, 128, 128): ((1, 1, 1, 2, 128, 1, 8, 72704),
                    (1, 1, 1, 2, 128, 1, 8, 76800)),
    (2, 37, 301): ((2, 2, 2, 1, 151, 1, 8, 201184),
                   (2, 2, 2, 1, 151, 1, 8, 210784)),
    (2, 37, 331): ((4, 4, 4, 2, 83, 1, 8, 136416),
                   (4, 4, 4, 2, 83, 1, 8, 147040)),
    (2, 37, 471): ((8, 8, 8, 4, 59, 1, 8, 163952),
                   (8, 8, 8, 4, 59, 1, 8, 179056)),
    (2, 37, 669): ((16, 16, 16, 4, 42, 1, 8, 230240),
                   (16, 16, 16, 4, 42, 1, 4, 230240)),
    (2, 37, 1001): ((16, 16, 16, 4, 63, 0, 8, 160384),
                    (16, 16, 16, 4, 63, 0, 8, 192640)),
    (1, 3, 24464): ((16, 1, 1, 1, 1529, 0, 5, 226352),
                    (16, 1, 1, 1, 1529, 0, 3, 232432)),
}


@pytest.mark.parametrize("shape", list(PLANS))
def test_plan_is_pinned(shape):
    """The plan at each shape, forward and backward: a function of the
    shape alone, within a block's shared memory, its units split into C
    slices that cover H, its clusters side by side on the SMs."""
    for want, bwd in zip(PLANS[shape], (False, True)):
        got = rnn.plan(*shape, backward=bwd)
        assert tuple(got[f] for f in rec.PLAN_FIELDS) == want
        nd, b, h = shape
        c, rows = got["C"], got["R"]
        assert got["bytes"] <= rec.MAX_SMEM and got["depth"] >= rec.MIN_DEPTH
        assert sum((k + 1) * h // c - k * h // c for k in range(c)) == h
        assert nd * -(-b // rows) * c <= rec.SMS or rows == 16


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


@pytest.mark.parametrize("t,b,k,j,nd,want", [
    (500, 128, 128, 128, 2, (33, 1952)),
    (4, 4, 40, 40, 1, (1, 16)),
    (0, 3, 5, 5, 1, (1, 16)),
])
def test_weight_gradient_slices(t, b, k, j, nd, want):
    s, per = rec.dwh_slices(t, b, k, j, nd)
    assert (s, per) == want
    assert per % 16 == 0 and (s - 1) * per < max(t * b, 1) <= s * per


@pytest.mark.parametrize("header,moved", [
    ("recurrence_dwh.cuh", {"bilstm", "rnn", "rnn_bf16", "gru"}),
    ("recurrence_cluster.cuh", {"rnn", "rnn_bf16", "bilstm", "gru"}),
    ("rnn_cells.cuh", {"rnn", "rnn_bf16"}),
])
def test_build_key_follows_included_headers(tmp_path, monkeypatch, header,
                                            moved):
    """A library's cache key hashes its source and every local header it
    includes: editing recurrence_dwh.cuh or recurrence_cluster.cuh moves
    the keys of the recurrence libraries (the rnn's two forms among them),
    rnn_cells.cuh the rnn's two, and nothing else."""
    csrc = tmp_path / "csrc"
    shutil.copytree(CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    for name in ("rnn", "rnn_bf16"):
        assert [p.name for p in _build.sources(name)] == [
            f"{name}.cu", "rnn_cells.cuh", "recurrence_cluster.cuh",
            "recurrence_dwh.cuh"]
    assert [p.name for p in _build.sources("bilstm")] == [
        "bilstm.cu", "recurrence_cluster.cuh", "recurrence_dwh.cuh"]
    assert [p.name for p in _build.sources("gru")] == [
        "gru.cu", "recurrence_cluster.cuh", "recurrence_dwh.cuh"]
    before = {n: _build.target(n) for n in _build.SOURCES}
    path = csrc / header
    path.write_text(path.read_text() + "\n// edited\n")
    after = {n: _build.target(n) for n in _build.SOURCES}
    assert {n for n in _build.SOURCES if before[n] != after[n]} == moved


def test_start_builds_in_the_background_and_build_waits(tmp_path,
                                                       monkeypatch):
    """``_build.start`` starts one compiler a library and returns at once;
    ``build`` (which ``load`` calls) of a library waits for its own
    compiler and leaves the others running; ``build()`` collects the
    rest, and a library already built starts nothing."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\nwhile [ $# -gt 0 ]; do\n"
                    '  if [ "$1" = "-o" ]; then out="$2"; fi; shift\n'
                    'done\nsleep 0.5\necho built > "$out"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "build_dir", lambda: tmp_path / "build")
    names = ["rnn", "rnn_bf16", "gru"]
    _build.start(names)
    assert set(_build._PENDING) == set(names)
    assert not any(_build.target(n).exists() for n in names)
    assert set(_build.build(["rnn"])) == {"rnn"}
    assert _build.target("rnn").exists()
    assert set(_build._PENDING) == {"rnn_bf16", "gru"}
    assert set(_build.build(names)) == {"rnn_bf16", "gru"}
    assert not _build._PENDING
    _build.start(names)
    assert not _build._PENDING and _build.build(names) == {}


# every kind of ops.Act with parameters, beside an independent float64
# version of it (PyTorch's own functions), and whether its inputs must be
# kept in its domain (sqrt, log, a fractional power)
LIB_ACTS = [
    (ops.Act("tanh"), torch.tanh, None),
    (ops.Act("relu"), torch.relu, None),
    (ops.Act("relu6"), torch.nn.functional.relu6, None),
    (ops.Act("tanhshrink"), torch.nn.functional.tanhshrink, None),
    (ops.Act("sigmoid"), torch.sigmoid, None),
    (ops.Act("logsigmoid"), torch.nn.functional.logsigmoid, None),
    (ops.Act("softplus", 2.0),
     lambda x: torch.nn.functional.softplus(x, beta=2.0), None),
    (ops.Act("softsign"), torch.nn.functional.softsign, None),
    (ops.Act("softshrink", 0.5),
     lambda x: torch.nn.functional.softshrink(x, 0.5), None),
    (ops.Act("hardshrink", 0.5),
     lambda x: torch.nn.functional.hardshrink(x, 0.5), None),
    (ops.Act("hardtanh", -0.5, 0.5),
     lambda x: torch.nn.functional.hardtanh(x, -0.5, 0.5), None),
    (ops.Act("threshold", 0.1, -0.2),
     lambda x: torch.nn.functional.threshold(x, 0.1, -0.2), None),
    (ops.Act("leakyrelu", 0.05),
     lambda x: torch.nn.functional.leaky_relu(x, 0.05), None),
    (ops.Act("elu", 0.7), lambda x: torch.nn.functional.elu(x, 0.7), None),
    (ops.Act("abs"), torch.abs, None),
    (ops.Act("sqrt"), torch.sqrt, "domain"),
    (ops.Act("square"), torch.square, "grow"),
    (ops.Act("power", 1.5, 0.5, 0.2), lambda x: (0.2 + 0.5 * x) ** 1.5,
     "domain"),
    (ops.Act("exp"), torch.exp, "grow"),
    (ops.Act("log"), torch.log, "domain"),
]


@pytest.mark.parametrize("act,lib,domain", LIB_ACTS,
                         ids=[a[0].kind for a in LIB_ACTS])
def test_every_activation_against_a_float64_loop(act, lib, domain):
    """The plain forward, backward (from the pre-activation zx + hprev .
    wht, hprev h0 at t = 0, except tanh's 1 - h^2) and weight gradient
    under each activation descriptor, and the differentiable entry, from
    h0, against a float64 loop of h' = act(zx + h . wht) with PyTorch's
    own function of each kind and its autograd gradients (random inputs
    meet no kink).  Sqrt, log and the fractional power take |zx| + 3, an
    h0 in [1, 2) and wht x 0.1: every pre-activation stays positive;
    square and exp take zx / 2 and wht x 0.1, so that the nine steps do
    not overflow."""
    zx, wht, go = _inputs(9, 2, 3, 6, seed=11)
    h0 = np.tanh(np.random.RandomState(12).randn(2, 3, 6))
    if domain == "domain":
        zx, wht, h0 = np.abs(zx) + 3, wht * 0.1, np.abs(h0) + 1
    elif domain == "grow":
        zx, wht = zx / 2, wht * 0.1
    z64 = torch.from_numpy(zx).double().requires_grad_()
    w64 = torch.from_numpy(wht).double().requires_grad_()
    h, hs64 = torch.from_numpy(h0), []
    for z_t in z64:
        h = lib(z_t + torch.matmul(h, w64))
        hs64.append(h)
    hs64 = torch.stack(hs64)
    (hs64 * torch.from_numpy(go).double()).sum().backward()
    assert bool(torch.isfinite(hs64).all())
    zt, wt, gt = map(torch.from_numpy, (zx, wht, go))
    h0t = torch.from_numpy(h0.astype(np.float32))
    hs = ops.rnn_forward_reference(zt, wt, h0t, act)
    dzx = ops.rnn_backward_reference(wt, hs, gt, act, zt, h0t)
    np.testing.assert_allclose(hs.numpy(), hs64.detach().numpy(), **FWD)
    np.testing.assert_allclose(dzx.numpy(), z64.grad.numpy(), **BWD)
    np.testing.assert_allclose(ops.rnn_dwh_reference(hs, dzx, h0t).numpy(),
                               w64.grad.numpy(), **BWD)
    zg, wg = zt.clone().requires_grad_(), wt.clone().requires_grad_()
    y = ops.rnn_recurrence(zg, wg, h0t, act)
    (y * gt).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), hs64.detach().numpy(),
                               **FWD)
    np.testing.assert_allclose(zg.grad.numpy(), z64.grad.numpy(), **BWD)
    np.testing.assert_allclose(wg.grad.numpy(), w64.grad.numpy(), **BWD)


def test_activation_kinds_mirror_the_kernel_source():
    """ops._activation.KINDS lists csrc/rnn.cu's ActKind codes (in
    rnn_cells.cuh) in order, and the backward reads h for tanh alone."""
    src = (CSRC / "rnn_cells.cuh").read_text()
    body = src[src.index("enum ActKind {"):]
    body = body[:body.index("};")]
    names = [n.strip() for n in body[body.index("{") + 1:].split(",")]
    assert len(names) == len(ops._activation.KINDS) == 20
    assert names[0] == "kTanhAct"
    assert [ops.Act(k).entry_args[0] for k in ops._activation.KINDS] == \
        list(range(20))
    assert [k for k in ops._activation.KINDS if ops.Act(k).from_h] == ["tanh"]
    assert "if (act != kTanhAct) {" in src
