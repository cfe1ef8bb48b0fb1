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


def _compare(jm, pm, shape, seed, x_scale=1.0):
    """Output, input gradient and parameter gradients of the port module
    ``pm`` against the JAX module ``jm`` under ``(y * g).sum()``, on an
    N(0, x_scale^2) input."""
    rs = np.random.RandomState(seed)
    x = (rs.randn(*shape) * x_scale).astype(np.float32)
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


@pytest.mark.parametrize("cell", ["rnn", "lstm", "gru"])
def test_truncation_cuts_the_gradient_at_chunk_boundaries(cell):
    """tests/test_recurrent.py::test_bptt_truncation_stops_gradient, for
    each cell: the last step's output does not reach x_0 through a chunk
    boundary."""
    make = {"rnn": nn.RnnCell, "lstm": nn.LSTMCell, "gru": nn.GRUCell}[cell]

    def grad_x0(bptt):
        torch.manual_seed(0)
        m = nn.Recurrent(bptt).add(make(3, 4))
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

    def spy(zx, wht, h0=None, act=ops.Act()):
        calls.append(zx.shape[0])
        return ops.rnn_recurrence(zx, wht, h0, act)

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

    def spy(zx, wht, h0=None, act=ops.Act()):
        shapes.append(tuple(zx.shape))
        return ops.rnn_recurrence(zx, wht, h0, act)

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


@pytest.mark.parametrize("bptt", [2])
def test_two_iterations_a_dispatch_run_as_one_chunk(bptt):
    """``set_iterations_per_dispatch(2)`` (before, a NotImplementedError):
    a Recurrent(RnnCell) tagger through TimeDistributedCriterion takes two
    steps a dispatch, each on its own batch, with the bits of one step a
    dispatch under a constant lr."""
    from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToBatch
    from bigdl_tpu_torch.optim import max_iteration
    from bigdl_tpu_torch.utils.random import generator
    from bigdl_tpu_torch.utils.table import T

    rs = np.random.RandomState(3)
    samples = [Sample(rs.randn(7, 6).astype(np.float32),
                      (rs.randint(0, 5, 7) + 1).astype(np.float32))
               for _ in range(12)]

    def run(n):
        g = generator(5)
        model = nn.Sequential(
            nn.Recurrent(bptt).add(nn.RnnCell(6, 5, generator=g)),
            nn.TimeDistributed(nn.LogSoftMax()))
        ds = DataSet.array(samples, seed=4) >> SampleToBatch(3)
        opt = LocalOptimizer(model, ds, nn.TimeDistributedCriterion(
            nn.ClassNLLCriterion(), size_average=True), device="cpu")
        opt.set_state(T(learningRate=0.3)).set_end_when(max_iteration(6))
        opt.set_iterations_per_dispatch(n).optimize()
        return opt, torch.cat([p.detach().reshape(-1)
                               for p in model.parameters()])

    (one, p1), (two, p2) = run(1), run(2)
    assert [ne for ne, _ in two.loss_log] == list(range(1, 7))
    assert two.loss_log == one.loss_log
    assert torch.equal(p1, p2)
    assert two.state["neval"] == 7 and two.state["epoch"] == 2


@pytest.mark.parametrize("per_step,weights,size_average", [
    (True, None, True), (True, None, False), (False, None, True),
    (True, [0.5, 1.0, 2.0, 1.5], True)])
def test_time_distributed_criterion_is_one_batched_call(per_step, weights,
                                                       size_average):
    """The port's TimeDistributedCriterion calls its criterion once over
    all T steps (batched), and its loss and input gradient equal the JAX
    criterion's (which vmaps over T)."""
    rs = np.random.RandomState(8)
    x = np.array(jax.nn.log_softmax(rs.randn(3, 6, 4).astype(np.float32)))
    target = (rs.randint(0, 4, (3, 6) if per_step else (3,)) + 1).astype(
        np.float32)
    jc = jnn.TimeDistributedCriterion(jnn.ClassNLLCriterion(weights),
                                      size_average)
    inner = nn.ClassNLLCriterion(weights)
    calls = []
    apply = inner.apply_loss
    inner.apply_loss = lambda i, t: calls.append(1) or apply(i, t)
    pc = nn.TimeDistributedCriterion(inner, size_average)
    want = jc.forward(jnp.asarray(x), jnp.asarray(target))
    want_g = jc.backward(jnp.asarray(x), jnp.asarray(target))
    got = pc.forward(torch.from_numpy(x), torch.from_numpy(target))
    assert len(calls) == 1
    got_g = pc.backward(torch.from_numpy(x), torch.from_numpy(target))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-5,
                               atol=1e-6)


def test_one_iteration_per_dispatch_is_accepted():
    opt = LocalOptimizer(nn.Recurrent().add(nn.RnnCell(6, 5)), None, None,
                         device="cpu")
    assert opt.set_iterations_per_dispatch(1) is opt


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("bptt,t", [(4, 9), (4, 8), (3, 7), (1, 4)])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_truncated_lstm_and_gru_match_the_jax_chunked_scan(
        monkeypatch, cell, reverse, bptt, t):
    """LSTM and GRU cells in chunks of ``bptt`` steps, each one kernel call
    from the last state of the one before (the LSTM's h and c), detached:
    the JAX chunked lax.scan with the carry stop-gradiented.  No step
    route is taken."""
    from bigdl_tpu_torch.nn import recurrent
    monkeypatch.setattr(jax_recurrent, "_PALLAS_BILSTM", "interpret")
    set_seed(21)
    make = {"lstm": lambda N: N.LSTMCell(6, 5),
            "gru": lambda N: N.GRUCell(6, 5)}[cell]
    jm = jnn.Recurrent(bptt, reverse=reverse).add(make(jnn))
    pm = nn.Recurrent(bptt, reverse=reverse).add(make(nn))
    before = recurrent.step_route_calls
    _compare(jm, pm, (3, t, 6), seed=22)
    assert recurrent.step_route_calls == before


@pytest.mark.parametrize("merge", ["concat", "add"])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_truncated_birecurrent_matches_jax(monkeypatch, cell, merge):
    """A truncated BiRecurrent keeps its two Recurrents (no fused call),
    as the JAX module's ``_cells_eligible``; outputs, dx and every
    parameter gradient against the JAX two chunked scans."""
    monkeypatch.setattr(jax_recurrent, "_PALLAS_BILSTM", "interpret")
    set_seed(23)
    make = {"lstm": lambda N: N.LSTMCell(6, 5),
            "gru": lambda N: N.GRUCell(6, 5)}[cell]
    jm = jnn.BiRecurrent(make(jnn), make(jnn), merge=merge, bptt_truncate=3)
    pm = nn.BiRecurrent(make(nn), make(nn), merge=merge, bptt_truncate=3)
    assert not pm._fused_lstm_eligible() and not pm._fused_gru_eligible()
    _compare(jm, pm, (3, 7, 6), seed=24)


def test_truncated_chunks_are_kernel_calls_from_the_carried_state(
        monkeypatch):
    """Each chunk is one D = 1 call: the LSTM's from the previous chunk's
    h and c, the GRU's from its h (None for the first); a forward that
    takes no gradient is one whole-sequence call."""
    from bigdl_tpu_torch.nn import recurrent
    calls = []

    def lstm_spy(zx, wht, h0=None, c0=None, with_last_c=False):
        calls.append(("lstm", zx.shape[0], h0 is None, c0 is None))
        return ops.bilstm_recurrence(zx, wht, h0, c0, with_last_c)

    def gru_spy(zrz, zn, wrz, wh, h0=None):
        calls.append(("gru", zn.shape[0], h0 is None))
        return ops.gru_recurrence(zrz, zn, wrz, wh, h0)

    monkeypatch.setattr(recurrent, "bilstm_recurrence", lstm_spy)
    monkeypatch.setattr(recurrent, "gru_recurrence", gru_spy)
    x = torch.randn(2, 10, 6)
    nn.Recurrent(4).add(nn.LSTMCell(6, 5))(x)
    nn.Recurrent(4).add(nn.GRUCell(6, 5))(x)
    assert calls == [("lstm", 4, True, True), ("lstm", 4, False, False),
                     ("lstm", 2, False, False), ("gru", 4, True),
                     ("gru", 4, False), ("gru", 2, False)]
    with torch.no_grad():
        nn.Recurrent(4).add(nn.GRUCell(6, 5))(x)
    assert calls[6:] == [("gru", 10, True)]


# every _Elementwise class of the JAX package, with its arguments
ELEMENTWISE = [
    ("ReLU", ()), ("ReLU6", ()), ("Tanh", ()), ("TanhShrink", ()),
    ("Sigmoid", ()), ("LogSigmoid", ()), ("LogSoftMax", ()), ("SoftMax", ()),
    ("SoftMin", ()), ("SoftPlus", (2.0,)), ("SoftSign", ()),
    ("SoftShrink", (0.5,)), ("HardShrink", (0.5,)),
    ("HardTanh", (-0.5, 0.5)), ("Clamp", (-1, 1)),
    ("Threshold", (0.1, -0.2)), ("LeakyReLU", (0.05,)), ("ELU", (0.7,)),
    ("Abs", ()), ("Sqrt", ()), ("Square", ()), ("Power", (0.5, 1.0, 0.2)),
    ("Exp", ()), ("Log", ()),
]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("bptt", [0, 3])
@pytest.mark.parametrize("name,args", ELEMENTWISE,
                         ids=[e[0] for e in ELEMENTWISE])
def test_rnn_cell_with_every_elementwise_activation_matches_jax(
        monkeypatch, name, args, bptt, reverse):
    """``Recurrent(RnnCell(6, 5, act))`` for every element-wise activation
    of the JAX package, whole and truncated, against its lax.scan: the
    twenty kernel kinds through ``rnn_recurrence`` with the activation's
    descriptor, the three soft-maxes (row-wise: they cross the kernel's
    blocks) through the step route.  Sqrt, Log and the fractional Power
    meet negative pre-activations on these inputs and compare NaN for
    NaN (``assert_allclose`` takes equal NaNs);
    test_domain_limited_activations_on_positive_pre_activations holds
    them where they are defined.  Exp's h = e^pre feeds the next step's
    pre, so a unit input drives it to e^19 within seven steps, where one
    ulp of pre is a relative 1e-6 of h and compounds: its input is scaled
    by 1/4 to keep the chain well conditioned in fp32."""
    from bigdl_tpu_torch.nn import recurrent
    monkeypatch.setattr(jax_recurrent, "_PALLAS_BILSTM", "interpret")
    set_seed(25)
    jm = jnn.Recurrent(bptt, reverse=reverse).add(
        jnn.RnnCell(6, 5, getattr(jnn, name)(*args)))
    act = getattr(nn, name)(*args)
    pm = nn.Recurrent(bptt, reverse=reverse).add(nn.RnnCell(6, 5, act))
    before = recurrent.step_route_calls
    _compare(jm, pm, (2, 7, 6), seed=26,
             x_scale=0.25 if name == "Exp" else 1.0)
    row_wise = name in ("SoftMax", "SoftMin", "LogSoftMax")
    assert (recurrent.kernel_act(act) is None) == row_wise
    assert (recurrent.step_route_calls > before) == row_wise


@pytest.mark.parametrize("name,args", [("Sqrt", ()), ("Log", ()),
                                       ("Power", (0.5, 1.0, 0.2))])
def test_domain_limited_activations_on_positive_pre_activations(name, args):
    """Non-negative inputs and weights and biases of at least 0.6 each
    keep every pre-activation above 1 (so log(pre) > 0 feeds the next
    step a non-negative h): all values finite, against the JAX scan."""
    set_seed(27)
    jm = jnn.Recurrent(3).add(jnn.RnnCell(6, 5, getattr(jnn, name)(*args)))
    pm = nn.Recurrent(3).add(nn.RnnCell(6, 5, getattr(nn, name)(*args)))
    rs = np.random.RandomState(28)
    tree = {"~": {}, "0": {"~": {
        "i2h": rs.uniform(0, 0.3, (5, 6)).astype(np.float32),
        "h2h": rs.uniform(0, 0.3, (5, 5)).astype(np.float32),
        "bias_i": rs.uniform(0.6, 1.0, 5).astype(np.float32),
        "bias_h": rs.uniform(0.6, 1.0, 5).astype(np.float32)}}}
    jm.load_params(tree)
    x = np.abs(rs.randn(2, 7, 6)).astype(np.float32)
    ctx = Context(training=False, key=jax.random.PRNGKey(0))
    want = np.asarray(jm.apply(jm.params(), jnp.asarray(x), jm.state(),
                               ctx)[0])
    assert np.isfinite(want).all()
    load_jax_params(pm, _tree(jm))
    xt = torch.from_numpy(x).requires_grad_()
    y = pm(xt)
    g = rs.randn(*want.shape).astype(np.float32)
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), want, **FWD)
    dp_j, dx_j = jax.grad(lambda p, v: (jm.apply(p, v, jm.state(), ctx)[0]
                                        * g).sum(), argnums=(0, 1))(
        jm.params(), jnp.asarray(x))
    assert np.isfinite(np.asarray(dx_j)).all()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j), **BWD)
    _assert_trees_close(_grads(pm), dp_j, **BWD)


class _JaxPeephole(jnn.LSTMCell):
    """A JAX LSTMCell subclass with its own step."""

    def _step(self, P, x, hc, ctx):
        out, (h, c) = super()._step(P, x, hc, ctx)
        return out * 0.5 + 0.25 * hc[0], (h, c * 0.9)


class _Peephole(nn.LSTMCell):
    """The port's counterpart of ``_JaxPeephole``."""

    def step(self, x, hidden):
        out, (h, c) = super().step(x, hidden)
        return out * 0.5 + 0.25 * hidden[0], (h, c * 0.9)


@pytest.mark.parametrize("bptt", [0, 3])
@pytest.mark.parametrize("own_step", [False, True])
def test_cell_subclass_takes_the_step_route(monkeypatch, own_step, bptt):
    """A subclass of LSTMCell, with and without its own step, runs its
    step in a loop (the JAX package's lax.scan: only exact types take the
    kernels), chunked and detached where truncated; no kernel launch."""
    from bigdl_tpu_torch.nn import recurrent
    monkeypatch.setattr(jax_recurrent, "_PALLAS_BILSTM", "interpret")
    set_seed(31)
    jcls = _JaxPeephole if own_step else type("JSub", (jnn.LSTMCell,), {})
    pcls = _Peephole if own_step else type("PSub", (nn.LSTMCell,), {})
    jm = jnn.Recurrent(bptt).add(jcls(6, 5))
    pm = nn.Recurrent(bptt).add(pcls(6, 5))
    calls = _spy_routes(monkeypatch)
    before = recurrent.step_route_calls
    _compare(jm, pm, (3, 7, 6), seed=32)
    assert calls == [] and recurrent.step_route_calls > before


@pytest.mark.parametrize("cell", ["rnn", "rnn_relu", "lstm", "gru"])
@pytest.mark.parametrize("table", [False, True])
def test_standalone_cell_forward_matches_jax(cell, table):
    """``cell.forward([x, h])`` (or ``Table(x, h)``) returns the step's
    output, as the JAX ``Cell._forward`` on ``Table(x, h)``: the output
    and the gradients of x, h and every parameter."""
    from bigdl_tpu.utils.table import Table as JTable
    from bigdl_tpu_torch.utils.table import Table
    set_seed(33)
    make = {"rnn": lambda N: N.RnnCell(6, 5),
            "rnn_relu": lambda N: N.RnnCell(6, 5, N.ReLU()),
            "lstm": lambda N: N.LSTMCell(6, 5),
            "gru": lambda N: N.GRUCell(6, 5)}[cell]
    jc, pc = make(jnn), make(nn)
    load_jax_params(pc, _tree(jc))
    rs = np.random.RandomState(34)
    x = rs.randn(3, 6).astype(np.float32)
    hs = [rs.randn(3, 5).astype(np.float32)
          for _ in range(2 if cell == "lstm" else 1)]
    ctx = Context(training=False, key=jax.random.PRNGKey(0))

    def j_out(p, xv, hv):
        h = tuple(hv) if cell == "lstm" else hv[0]
        return jc.apply(p, JTable(xv, h), jc.state(), ctx)[0]

    want = np.asarray(j_out(jc.params(), jnp.asarray(x),
                            [jnp.asarray(h) for h in hs]))
    g = rs.randn(*want.shape).astype(np.float32)
    dp_j, dx_j, dh_j = jax.grad(lambda p, xv, hv: (j_out(p, xv, hv)
                                                   * g).sum(),
                                argnums=(0, 1, 2))(
        jc.params(), jnp.asarray(x), [jnp.asarray(h) for h in hs])
    xt = torch.from_numpy(x).requires_grad_()
    ht = [torch.from_numpy(h).requires_grad_() for h in hs]
    hidden = tuple(ht) if cell == "lstm" else ht[0]
    y = pc(Table(xt, hidden) if table else [xt, hidden])
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), want, **FWD)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j), **BWD)
    for a, b in zip(ht, dh_j):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), **BWD)
    _assert_trees_close(_grads(pc), dp_j, **BWD)


def test_init_hidden_is_the_jax_cells():
    """Zeros (batch, H), a tuple (h, c) for the LSTM, on the cell's
    device."""
    for cell in (nn.RnnCell(6, 5), nn.GRUCell(6, 5)):
        h = cell.init_hidden(3)
        assert tuple(h.shape) == (3, 5) and not h.any()
    h, c = nn.LSTMCell(6, 5).init_hidden(3)
    assert tuple(h.shape) == tuple(c.shape) == (3, 5)
