"""The port's recurrence modules (bigdl_tpu_torch/nn/recurrent.py) and
``Mean`` against the JAX package: ``Recurrent`` of ``LSTMCell``,
``GRUCell`` and ``RnnCell`` forward and reverse, ``BiRecurrent`` on its
fused two-direction paths (LSTM and GRU, concat and add) and on its
two-child path, and ``Recurrent(RnnCell)`` with truncated BPTT against
the JAX chunked scan: outputs, input gradients and every parameter
gradient, with the weights carried across by ``load_jax_params``.  The
JAX modules run on both of their routes: the Pallas kernel pairs through
the interpreter (``_PALLAS_BILSTM = "interpret"``) and ``lax.scan``
(False); a truncated run takes the scan on either.  Tolerances are the
JAX tests' own: forward rtol 1e-5 / atol 1e-6, gradients rtol 1e-4 /
atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.nn import recurrent as jax_recurrent
from bigdl_tpu.nn.module import Context
from bigdl_tpu.utils.random import set_seed
from bigdl_tpu_torch import nn, ops
from bigdl_tpu_torch.nn.module import export_params, load_jax_params
from bigdl_tpu_torch.optim import LocalOptimizer

FWD = dict(rtol=1e-5, atol=1e-6)
BWD = dict(rtol=1e-4, atol=1e-5)
ROUTES = pytest.mark.parametrize("route", ["interpret", False],
                                 ids=["pallas", "scan"])


def _tree(m):
    return jax.tree_util.tree_map(np.asarray, m.params())


def _grads(module):
    tree = {"~": {k: p.grad for k, p in module._parameters.items()}}
    for name, m in module._modules.items():
        tree[name] = _grads(m)
    return tree


def _assert_trees_close(got, want, **tol):
    g, w = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w) > 0
    for a, b in zip(g, w):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


def _compare(jm, pm, shape, seed):
    """Output, input gradient and parameter gradients of the port module
    ``pm`` against the JAX module ``jm`` under ``(y * g).sum()``."""
    rs = np.random.RandomState(seed)
    x = rs.randn(*shape).astype(np.float32)
    ctx = Context(training=False, key=jax.random.PRNGKey(0))
    y_j = np.asarray(jm.apply(jm.params(), jnp.asarray(x), jm.state(),
                              ctx)[0])
    g = rs.randn(*y_j.shape).astype(np.float32)
    dp_j, dx_j = jax.grad(lambda p, v: (jm.apply(p, v, jm.state(), ctx)[0]
                                        * g).sum(), argnums=(0, 1))(
        jm.params(), jnp.asarray(x))
    load_jax_params(pm, _tree(jm))
    xt = torch.from_numpy(x).requires_grad_()
    y = pm(xt)
    (y * torch.from_numpy(g)).sum().backward()
    assert tuple(y.shape) == y_j.shape
    np.testing.assert_allclose(y.detach().numpy(), y_j, **FWD)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j), **BWD)
    _assert_trees_close(_grads(pm), dp_j, **BWD)
    with torch.no_grad():
        np.testing.assert_allclose(pm(torch.from_numpy(x)).numpy(), y_j,
                                   **FWD)


@ROUTES
@pytest.mark.parametrize("reverse", [False, True])
def test_recurrent_lstm_matches_jax(monkeypatch, route, reverse):
    """tests/test_recurrent.py:211's shapes: the kernel's D = 1 case."""
    monkeypatch.setattr(jax_recurrent, "_PALLAS_BILSTM", route)
    set_seed(7)
    jm = jnn.Recurrent(reverse=reverse).add(jnn.LSTMCell(6, 5))
    pm = nn.Recurrent(reverse=reverse).add(nn.LSTMCell(6, 5, device="cpu"))
    _compare(jm, pm, (4, 9, 6), seed=3)


@ROUTES
@pytest.mark.parametrize("merge", ["concat", "add"])
def test_birecurrent_fused_matches_jax(monkeypatch, route, merge):
    """Both directions in one D = 2 call against the JAX fused path."""
    monkeypatch.setattr(jax_recurrent, "_PALLAS_BILSTM", route)
    set_seed(5)
    jm = jnn.BiRecurrent(jnn.LSTMCell(6, 5), jnn.LSTMCell(6, 5), merge=merge)
    pm = nn.BiRecurrent(nn.LSTMCell(6, 5), nn.LSTMCell(6, 5), merge=merge)
    assert pm._fused_lstm_eligible() and jm._fused_lstm_eligible()
    _compare(jm, pm, (3, 7, 6), seed=1)


@pytest.mark.parametrize("make,bptt", [
    (lambda N: (N.LSTMCell(6, 5), N.LSTMCell(6, 4)), 0),   # unequal cells
    (lambda N: (N.LSTMCell(6, 5), N.LSTMCell(6, 5)), 7),   # bptt >= T
])
def test_birecurrent_two_children_match_jax(monkeypatch, make, bptt):
    """Cells that cannot share one call run as two D = 1 calls, as the
    JAX module runs two scans."""
    monkeypatch.setattr(jax_recurrent, "_PALLAS_BILSTM", "interpret")
    set_seed(6)
    jm = jnn.BiRecurrent(*make(jnn), bptt_truncate=bptt)
    pm = nn.BiRecurrent(*make(nn), bptt_truncate=bptt)
    assert not pm._fused_lstm_eligible()
    assert not jm._fused_lstm_eligible()
    _compare(jm, pm, (3, 7, 6), seed=2)


def test_fused_path_is_one_kernel_call_of_two_directions(monkeypatch):
    """The fused BiRecurrent hands the recurrence (T, 2, N, 4H) and
    (2, H, 4H); a Recurrent (T, 1, N, 4H) and (1, H, 4H)."""
    from bigdl_tpu_torch.nn import recurrent
    shapes = []

    def spy(zx, wht):
        shapes.append((tuple(zx.shape), tuple(wht.shape)))
        return ops.bilstm_recurrence(zx, wht)

    monkeypatch.setattr(recurrent, "bilstm_recurrence", spy)
    x = torch.randn(3, 7, 6)
    nn.BiRecurrent(nn.LSTMCell(6, 5), nn.LSTMCell(6, 5))(x)
    nn.Recurrent(reverse=True).add(nn.LSTMCell(6, 4))(x)
    assert shapes == [((7, 2, 3, 20), (2, 5, 20)), ((7, 1, 3, 16), (1, 4, 16))]


def _spy_routes(monkeypatch):
    """Count the calls of each LSTM route nn.recurrent takes."""
    from bigdl_tpu_torch.nn import recurrent
    calls = []
    for name in ("bilstm_recurrence", "lstm_scan"):
        real = getattr(recurrent, name)
        monkeypatch.setattr(recurrent, name, lambda *a, _n=name, _f=real: (
            calls.append(_n), _f(*a))[1])
    return calls


@pytest.mark.parametrize("reverse", [False, True])
def test_no_grad_lstm_runs_lstm_scan(monkeypatch, reverse):
    """A forward that takes no gradient (grad mode off, or nothing that
    requires grad) goes through lstm_scan from zero state, one call;
    a forward that takes one keeps bilstm_recurrence at D = 1; both give
    the JAX module's output."""
    calls = _spy_routes(monkeypatch)
    monkeypatch.setattr(jax_recurrent, "_PALLAS_BILSTM", "interpret")
    set_seed(7)
    jm = jnn.Recurrent(reverse=reverse).add(jnn.LSTMCell(6, 5))
    pm = nn.Recurrent(reverse=reverse).add(nn.LSTMCell(6, 5, device="cpu"))
    load_jax_params(pm, _tree(jm))
    x = np.random.RandomState(3).randn(4, 9, 6).astype(np.float32)
    want = np.asarray(jm.apply(jm.params(), jnp.asarray(x), jm.state(),
                               Context(training=False,
                                       key=jax.random.PRNGKey(0)))[0])
    with torch.no_grad():
        y = pm(torch.from_numpy(x))
    assert calls == ["lstm_scan"]
    np.testing.assert_allclose(y.numpy(), want, **FWD)
    for p in pm.parameters():
        p.requires_grad_(False)
    np.testing.assert_allclose(pm(torch.from_numpy(x)).numpy(), want, **FWD)
    assert calls == ["lstm_scan"] * 2
    for p in pm.parameters():
        p.requires_grad_(True)
    y = pm(torch.from_numpy(x))
    assert calls == ["lstm_scan"] * 2 + ["bilstm_recurrence"]
    assert y.requires_grad
    np.testing.assert_allclose(y.detach().numpy(), want, **FWD)


def test_no_grad_birecurrent_children_run_lstm_scan(monkeypatch):
    """Unequal cells: each child, forward and reverse, takes lstm_scan
    without a gradient and bilstm_recurrence with one; the fused call of
    two equal cells stays one D = 2 bilstm_recurrence either way."""
    calls = _spy_routes(monkeypatch)
    x = torch.randn(3, 7, 6)
    two = nn.BiRecurrent(nn.LSTMCell(6, 5), nn.LSTMCell(6, 4))
    fused = nn.BiRecurrent(nn.LSTMCell(6, 5), nn.LSTMCell(6, 5))
    with torch.no_grad():
        y_scan = two(x)
        fused(x)
    assert calls == ["lstm_scan", "lstm_scan", "bilstm_recurrence"]
    y_grad = two(x)
    fused(x)
    assert calls[3:] == ["bilstm_recurrence"] * 3
    torch.testing.assert_close(y_scan, y_grad.detach(), rtol=1e-6,
                               atol=1e-7)


def test_param_tree_carries_across():
    set_seed(8)
    jm = jnn.BiRecurrent(jnn.LSTMCell(6, 5), jnn.LSTMCell(6, 5))
    pm = load_jax_params(nn.BiRecurrent(nn.LSTMCell(6, 5),
                                        nn.LSTMCell(6, 5)), _tree(jm))
    got = jax.tree_util.tree_leaves_with_path(export_params(pm))
    want = jax.tree_util.tree_leaves_with_path(_tree(jm))
    assert [(k, v.shape) for k, v in got] == [(k, v.shape) for k, v in want]
    _assert_trees_close(export_params(pm), jm.params(), rtol=0, atol=0)


def test_lstm_cell_init():
    """U(-1/sqrt(H), 1/sqrt(H)) for w (4H, D+H) and bias (4H), as the JAX
    cell draws them; the same generator seed gives the same weights."""
    from bigdl_tpu_torch.utils.random import generator
    cell = nn.LSTMCell(200, 128, generator=generator(0))
    bound = 1 / np.sqrt(128)
    for p, shape in ((cell.w, (512, 328)), (cell.bias, (512,))):
        assert tuple(p.shape) == shape
        assert bound * 0.99 < float(p.detach().abs().max()) <= bound
    set_seed(9)
    jc = jnn.LSTMCell(200, 128)
    for k, v in _tree(jc)["~"].items():
        assert v.shape == tuple(getattr(cell, k).shape)
        assert bound * 0.99 < np.abs(v).max() <= bound
    again = nn.LSTMCell(200, 128, generator=generator(0))
    assert torch.equal(again.w, cell.w) and torch.equal(again.bias, cell.bias)


@pytest.mark.parametrize("args,shape", [
    ((1, 2), (3, 7, 4)), ((1, 2), (7, 4)), ((2,), (3, 7, 4)),
    ((1, -1, False), (3, 7, 4)), ((3, 2), (2, 3, 5, 4)),
])
def test_mean_matches_jax(args, shape):
    x = np.random.RandomState(5).randn(*shape).astype(np.float32)
    want = np.asarray(jnn.Mean(*args).forward(jnp.asarray(x)))
    got = nn.Mean(*args)(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **FWD)


@ROUTES
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("cell", ["rnn", "gru"])
def test_recurrent_rnn_and_gru_match_jax(monkeypatch, route, reverse, cell):
    """tests/test_recurrent.py:198's shapes, the kernels' D = 1 case."""
    monkeypatch.setattr(jax_recurrent, "_PALLAS_BILSTM", route)
    set_seed(11)
    make = {"rnn": lambda N, **kw: N.RnnCell(6, 5, **kw),
            "gru": lambda N, **kw: N.GRUCell(6, 5, **kw)}[cell]
    jm = jnn.Recurrent(reverse=reverse).add(make(jnn))
    pm = nn.Recurrent(reverse=reverse).add(make(nn, device="cpu"))
    _compare(jm, pm, (4, 9, 6), seed=12)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("bptt,t", [(4, 9), (4, 8), (3, 7), (1, 4)])
def test_truncated_rnn_matches_the_jax_chunked_scan(monkeypatch, reverse,
                                                    bptt, t):
    """Chunks of ``bptt`` steps, each one kernel call from the last h of
    the one before, detached: the JAX chunked lax.scan with the carry
    stop-gradiented (the kernel gate is on, but truncation takes the
    scan)."""
    monkeypatch.setattr(jax_recurrent, "_PALLAS_BILSTM", "interpret")
    set_seed(13)
    jm = jnn.Recurrent(bptt, reverse=reverse).add(jnn.RnnCell(6, 5))
    pm = nn.Recurrent(bptt, reverse=reverse).add(nn.RnnCell(6, 5))
    _compare(jm, pm, (3, t, 6), seed=14)


def test_truncation_cuts_the_gradient_at_chunk_boundaries():
    """tests/test_recurrent.py::test_bptt_truncation_stops_gradient: the
    last step's output does not reach x_0 through a chunk boundary."""
    def grad_x0(bptt):
        torch.manual_seed(0)
        m = nn.Recurrent(bptt).add(nn.RnnCell(3, 4))
        x = torch.randn(2, 8, 3, requires_grad=True)
        m(x)[:, -1].sum().backward()
        return float(x.grad[:, 0].abs().max())

    assert grad_x0(0) > 0 and grad_x0(8) > 0
    assert grad_x0(4) == 0.0


def test_truncated_forward_without_gradient_is_one_call(monkeypatch):
    """Chunks only where a gradient is taken: a no-grad forward (the
    validation's and the sampler's) runs the whole sequence in one call,
    and gives the chunked forward's values."""
    from bigdl_tpu_torch.nn import recurrent
    calls = []

    def spy(zx, wht, h0=None):
        calls.append(zx.shape[0])
        return ops.rnn_recurrence(zx, wht, h0)

    monkeypatch.setattr(recurrent, "rnn_recurrence", spy)
    m = nn.Recurrent(4).add(nn.RnnCell(6, 5))
    x = torch.randn(3, 10, 6)
    y = m(x)
    assert calls == [4, 4, 2]
    with torch.no_grad():
        np.testing.assert_allclose(m(x).numpy(), y.detach().numpy(), **FWD)
    assert calls == [4, 4, 2, 10]


@ROUTES
@pytest.mark.parametrize("merge", ["concat", "add"])
def test_birecurrent_gru_fused_matches_jax(monkeypatch, route, merge):
    """Both GRU directions in one D = 2 call against the JAX fused path
    (route pallas) and its two scans (route scan)."""
    monkeypatch.setattr(jax_recurrent, "_PALLAS_BILSTM", route)
    set_seed(15)
    jm = jnn.BiRecurrent(jnn.GRUCell(6, 5), jnn.GRUCell(6, 5), merge=merge)
    pm = nn.BiRecurrent(nn.GRUCell(6, 5), nn.GRUCell(6, 5), merge=merge)
    assert pm._fused_gru_eligible() and not pm._fused_lstm_eligible()
    assert jm._fused_gru_eligible() == (route == "interpret")
    _compare(jm, pm, (3, 7, 6), seed=16)


def test_birecurrent_of_rnn_cells_runs_two_calls(monkeypatch):
    """No fused RNN form, in the JAX package either: two D = 1 calls."""
    from bigdl_tpu_torch.nn import recurrent
    shapes = []

    def spy(zx, wht, h0=None):
        shapes.append(tuple(zx.shape))
        return ops.rnn_recurrence(zx, wht, h0)

    monkeypatch.setattr(recurrent, "rnn_recurrence", spy)
    monkeypatch.setattr(jax_recurrent, "_PALLAS_BILSTM", "interpret")
    set_seed(17)
    jm = jnn.BiRecurrent(jnn.RnnCell(6, 5), jnn.RnnCell(6, 5))
    pm = nn.BiRecurrent(nn.RnnCell(6, 5), nn.RnnCell(6, 5))
    _compare(jm, pm, (3, 7, 6), seed=18)
    assert shapes[:2] == [(7, 1, 3, 5), (7, 1, 3, 5)]


def test_fused_gru_path_is_one_kernel_call(monkeypatch):
    """The fused GRU BiRecurrent hands the recurrence (T, 2, N, 2H),
    (T, 2, N, H), (2, H, 2H) and (2, H, H)."""
    from bigdl_tpu_torch.nn import recurrent
    shapes = []

    def spy(*args):
        shapes.append([tuple(a.shape) for a in args])
        return ops.gru_recurrence(*args)

    monkeypatch.setattr(recurrent, "gru_recurrence", spy)
    nn.BiRecurrent(nn.GRUCell(6, 5), nn.GRUCell(6, 5))(torch.randn(3, 7, 6))
    assert shapes == [[(7, 2, 3, 10), (7, 2, 3, 5), (2, 5, 10), (2, 5, 5)]]


@pytest.mark.parametrize("cell", ["rnn", "gru"])
def test_rnn_and_gru_param_trees_carry_across(cell):
    """The JAX cells' parameter names and shapes (an RnnCell's activation
    is no child), drawn U(-1/sqrt(H), 1/sqrt(H)); the JAX tree goes in
    and comes out unchanged."""
    from bigdl_tpu_torch.utils.random import generator
    set_seed(19)
    make = {"rnn": lambda N, **kw: N.RnnCell(7, 40, **kw),
            "gru": lambda N, **kw: N.GRUCell(7, 40, **kw)}[cell]
    jm = jnn.Recurrent().add(make(jnn))
    pm = nn.Recurrent().add(make(nn, generator=generator(2)))
    got = jax.tree_util.tree_leaves_with_path(export_params(pm))
    want = jax.tree_util.tree_leaves_with_path(_tree(jm))
    assert [(k, v.shape) for k, v in got] == [(k, v.shape) for k, v in want]
    bound = 1 / np.sqrt(40)
    assert all(bound * 0.9 < np.abs(v).max() <= bound for _, v in got)
    load_jax_params(pm, _tree(jm))
    _assert_trees_close(export_params(pm), jm.params(), rtol=0, atol=0)


@pytest.mark.parametrize("build,match", [
    (lambda: nn.Recurrent(bptt_truncate=2).add(nn.LSTMCell(6, 5))(
        torch.zeros(3, 7, 6)), "truncated BPTT"),
    (lambda: nn.Recurrent(bptt_truncate=2).add(nn.GRUCell(6, 5))(
        torch.zeros(3, 7, 6)), "truncated BPTT .* of GRUCell"),
    (lambda: nn.Recurrent().add(nn.RnnCell(6, 5, nn.ReLU()))(
        torch.zeros(3, 7, 6)), "RnnCell with ReLU: only Tanh"),
    (lambda: nn.Recurrent().add(type("MyCell", (nn.LSTMCell,), {})(6, 5))(
        torch.zeros(3, 7, 6)), "only LSTMCell"),
    (lambda: LocalOptimizer(nn.Recurrent().add(nn.RnnCell(6, 5)), None,
                            None, device="cpu")
     .set_iterations_per_dispatch(2), "several iterations"),
])
def test_what_is_not_ported_raises(build, match):
    with pytest.raises(NotImplementedError, match=match):
        build()


def test_one_iteration_per_dispatch_is_accepted():
    opt = LocalOptimizer(nn.Recurrent().add(nn.RnnCell(6, 5)), None, None,
                         device="cpu")
    assert opt.set_iterations_per_dispatch(1) is opt
