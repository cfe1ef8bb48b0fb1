"""The port's dtype policy (``bigdl_tpu_torch.tensor``) against the JAX
package's (``bigdl_tpu.tensor``): the policy object and its casts, then
module by module under FP32, BF16_COMPUTE and BF16_ACT with the
parameters carried across (``load_jax_params`` / ``load_jax_state``):
each output's and gradient's dtype equal to JAX's and its values within
two bf16 ulps (forward rtol 1.6e-2 / atol 1e-2, gradients 3e-2 / 3e-2:
the two packages round a bf16 product's result at different places);
the two JAX tests of the policy's rewrites word for word; three steps of
LeNet-5, the Bi-LSTM classifier and the Transformer classifier at small
sizes; the routes the policy picks (the recurrence kernels only where
the output dtype is f32, a CUDA graph keyed on the policy, ``Recurrent(
RnnCell)`` on its kernel route under BF16_COMPUTE); and the
``DistriOptimizer``
under BF16_COMPUTE on two gloo ranks against ``LocalOptimizer``.

The JAX side runs as its own tests run it on the CPU: the Mosaic pools
and the recurrence kernels in the Pallas interpreter, each flag set
inside the test and restored after it."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
import bigdl_tpu.nn.pooling as jax_pooling
import bigdl_tpu.nn.recurrent as jax_recurrent
from bigdl_tpu import tensor as jt
from bigdl_tpu.nn.module import Context
from bigdl_tpu.utils.random import set_seed
from bigdl_tpu_torch import nn
from bigdl_tpu_torch import tensor as pt
from bigdl_tpu_torch.nn.module import (export_params, export_state,
                                       load_jax_params, load_jax_state)
from bigdl_tpu_torch.optim import local_optimizer as lopt
from bigdl_tpu_torch.parallel.launch import launch
from tests.helpers import torch_distri_workers as W
from tests.helpers.torch_parity import keep_torch_rng  # noqa: F401

POLICIES = ("FP32", "BF16_COMPUTE", "BF16_ACT")
# FP32: the f32 tolerance the module tests hold (summation order); the
# reduced policies: two bf16 ulps forward, 3e-2 on gradients
FWD_TOL = {"FP32": dict(rtol=1e-4, atol=1e-5),
           "BF16": dict(rtol=1.6e-2, atol=1e-2)}
BWD_TOL = {"FP32": dict(rtol=1e-4, atol=1e-5),
           "BF16": dict(rtol=3e-2, atol=3e-2)}


def _tol(table, name):
    return table["FP32" if name == "FP32" else "BF16"]


@contextlib.contextmanager
def policy(name):
    """Both packages under the named policy, FP32 restored after."""
    jt.set_policy(getattr(jt, name))
    pt.set_policy(getattr(pt, name))
    try:
        yield
    finally:
        jt.set_policy(jt.FP32)
        pt.set_policy(pt.FP32)


def _dtype_name(a):
    """The dtype's name (``bfloat16``, ``float32``) of an array, a tensor
    or a dtype of either package."""
    return str(getattr(a, "dtype", a)).replace("torch.", "")


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def run_pair(jm, pm, x, name, training=False, seed=1):
    """``jm`` and ``pm`` (its parameters and state loaded from ``jm``'s)
    on the f32 input ``x`` under policy ``name``: the outputs, their
    dtypes, the input's gradient and every parameter's under one seeded
    cotangent (in the output's dtype), and the state after."""
    load_jax_params(pm, jax.tree_util.tree_map(np.asarray, jm.params()))
    load_jax_state(pm, jax.tree_util.tree_map(np.asarray, jm.state()))
    pm.train(training)
    ctx = Context(training=training, key=jax.random.PRNGKey(0))
    with policy(name):
        y_j, vjp, s_j = jax.vjp(
            lambda p, v: jm.apply(p, v, jm.state(), ctx), jm.params(),
            jnp.asarray(x), has_aux=True)
        g = np.random.RandomState(seed).randn(*y_j.shape)
        dp_j, dx_j = vjp(jnp.asarray(g, y_j.dtype))
        xt = torch.from_numpy(x).requires_grad_()
        y_p = pm(xt)
        y_p.backward(torch.from_numpy(g).to(y_p.dtype))
    dp_p = {path: p.grad for path, p in zip(
        _flat(export_params(pm)), pm.parameters())}
    return {"y": (y_j, y_p), "dx": (dx_j, xt.grad),
            "dp": (_flat(jax.tree_util.tree_map(np.asarray, dp_j)), dp_p),
            "state": (_flat(jax.tree_util.tree_map(np.asarray, s_j or {})),
                      _flat(export_state(pm)))}


def check_pair(res, name, fwd_tol=None, bwd_tol=None):
    """Dtypes equal to JAX's, values within the policy's tolerances."""
    fwd_tol = fwd_tol or _tol(FWD_TOL, name)
    bwd_tol = bwd_tol or _tol(BWD_TOL, name)
    y_j, y_p = res["y"]
    assert _dtype_name(y_p) == _dtype_name(y_j), (y_p.dtype, y_j.dtype)
    np.testing.assert_allclose(_np(y_p), _np(y_j), **fwd_tol)
    dx_j, dx_p = res["dx"]
    assert _dtype_name(dx_p) == _dtype_name(dx_j)
    np.testing.assert_allclose(_np(dx_p), _np(dx_j), **bwd_tol)
    dp_j, dp_p = res["dp"]
    assert set(dp_j) == set(dp_p)
    for path, g in dp_j.items():
        assert _dtype_name(dp_p[path]) == _dtype_name(g), path
        np.testing.assert_allclose(_np(dp_p[path]), _np(g), **bwd_tol,
                                   err_msg=str(path))


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# -- the policy object -------------------------------------------------------

def test_policies_are_the_jax_package_s():
    assert pt.policy() is pt.FP32          # the default after import
    for name in POLICIES:
        j, p = getattr(jt, name), getattr(pt, name)
        for field in ("param_dtype", "compute_dtype", "output_dtype"):
            assert _dtype_name(getattr(p, field)) == _dtype_name(
                getattr(j, field))
    assert not pt.FP32.reduced and pt.BF16_COMPUTE.reduced
    assert pt.BF16_ACT.reduced


def test_set_policy_and_the_casts_follow_jax():
    x = _x((3, 4))
    for name in POLICIES:
        with policy(name):
            assert pt.policy() is getattr(pt, name)
            for cast in ("cast_compute", "cast_output"):
                got = getattr(pt.policy(), cast)(torch.from_numpy(x))
                want = getattr(jt.policy(), cast)(jnp.asarray(x))
                assert _dtype_name(got) == str(want.dtype)
                np.testing.assert_array_equal(_np(got), _np(want))
    assert pt.policy() is pt.FP32
    with pytest.raises(TypeError):
        pt.set_policy("bf16")


def test_narrow_and_select_are_one_based():
    x = _x((4, 5, 6))
    for dim, index, size in ((1, 2, 2), (2, 1, 5), (3, 4, 3)):
        np.testing.assert_array_equal(
            pt.narrow(torch.from_numpy(x), dim, index, size).numpy(),
            np.asarray(jt.narrow(jnp.asarray(x), dim, index, size)))
    for dim, index in ((1, 4), (2, 3), (3, 1)):
        np.testing.assert_array_equal(
            pt.select(torch.from_numpy(x), dim, index).numpy(),
            np.asarray(jt.select(jnp.asarray(x), dim, index)))


def test_default_dtype_registers_parameters():
    assert pt.default_dtype() == torch.float32
    try:
        pt.set_default_dtype(torch.float64)
        m = nn.Linear(3, 2, device="cpu")
        assert m.weight.dtype == m.bias.dtype == torch.float64
        y = m(torch.ones(1, 3, dtype=torch.float64))
        assert y.dtype == torch.float64    # FP32 casts nothing
    finally:
        pt.set_default_dtype(torch.float32)
    assert nn.Linear(3, 2, device="cpu").weight.dtype == torch.float32
    with pytest.raises(TypeError):
        pt.set_default_dtype(torch.int32)


# -- module by module --------------------------------------------------------

def _linear():
    return jnn.Linear(6, 5), nn.Linear(6, 5, device="cpu")


def _conv():
    return (jnn.SpatialConvolution(3, 4, 3, 3, 1, 1, 1, 1),
            nn.SpatialConvolution(3, 4, 3, 3, 1, 1, 1, 1, device="cpu"))


def _grouped():
    return (jnn.SpatialConvolution(4, 6, 3, 3, 2, 2, 0, 0, n_group=2),
            nn.SpatialConvolution(4, 6, 3, 3, 2, 2, 0, 0, n_group=2,
                                  device="cpu"))


def _lrn():
    return (jnn.SpatialCrossMapLRN(5, 1e-4, 0.75, 1.0),
            nn.SpatialCrossMapLRN(5, 1e-4, 0.75, 1.0))


def _layernorm():
    return jnn.LayerNorm(8), nn.LayerNorm(8, device="cpu")


def _mhsa(causal):
    return lambda: (jnn.MultiHeadSelfAttention(8, 2, causal=causal),
                    nn.MultiHeadSelfAttention(8, 2, causal=causal,
                                              device="cpu"))


def _moe():
    return (jnn.MoE(8, 16, 4, capacity_factor=4.0),
            nn.MoE(8, 16, 4, capacity_factor=4.0, device="cpu"))


def _logsoftmax():
    return jnn.LogSoftMax(), nn.LogSoftMax()


MODULES = {
    "linear": (_linear, (4, 6)),
    "conv": (_conv, (2, 3, 7, 7)),
    "conv_grouped": (_grouped, (2, 4, 9, 9)),
    "lrn": (_lrn, (2, 8, 5, 5)),
    "layernorm": (_layernorm, (2, 3, 8)),
    "mhsa": (_mhsa(False), (2, 6, 8)),
    "mhsa_causal": (_mhsa(True), (2, 6, 8)),
    "moe": (_moe, (2, 5, 8)),
    "logsoftmax": (_logsoftmax, (3, 7)),
}


@pytest.mark.parametrize("name", POLICIES)
@pytest.mark.parametrize("module", sorted(MODULES))
def test_module_matches_jax_under_the_policy(module, name):
    make, shape = MODULES[module]
    set_seed(3)
    jm, pm = make()
    check_pair(run_pair(jm, pm, _x(shape, 1), name), name)


POOLS = {"2x2s2": (2, 2, 2, 2, 0, 0, False),
         "3x3s2p1_ceil": (3, 3, 2, 2, 1, 1, True),
         "3x3s1p1": (3, 3, 1, 1, 1, 1, False)}


@pytest.mark.parametrize("name", POLICIES)
@pytest.mark.parametrize("pool", sorted(POOLS))
def test_max_pooling_matches_jax_under_the_policy(monkeypatch, pool, name):
    """The JAX Mosaic route (the port's first-max rule) in the Pallas
    interpreter; the inputs are halves, so windows tie."""
    monkeypatch.setattr(jax_pooling, "_PALLAS_POOL", "interpret")
    kw, kh, dw, dh, pw, ph, ceil = POOLS[pool]
    jm = jnn.SpatialMaxPooling(kw, kh, dw, dh, pw, ph)
    pm = nn.SpatialMaxPooling(kw, kh, dw, dh, pw, ph)
    if ceil:
        jm, pm = jm.ceil(), pm.ceil()
    x = np.round(_x((2, 3, 9, 9), 2) * 2) / 2
    check_pair(run_pair(jm, pm, x.astype(np.float32), name), name)


@pytest.mark.parametrize("name", POLICIES)
@pytest.mark.parametrize("training", [True, False])
def test_batchnorm_matches_jax_under_the_policy(name, training):
    set_seed(4)
    jm = jnn.SpatialBatchNormalization(4)
    pm = nn.SpatialBatchNormalization(4, device="cpu")
    x = _x((3, 4, 5, 5), 5) * 2 + 1
    res = run_pair(jm, pm, x, name, training=training)
    check_pair(res, name)
    s_j, s_p = res["state"]
    if training:
        for path, v in s_j.items():
            # the statistics come from the f32 input under every policy
            assert s_p[path].dtype == np.float32
            np.testing.assert_allclose(s_p[path], v, rtol=1e-6,
                                       atol=1e-7)


# the recurrences: the JAX kernel route in the interpreter (the port's
# kernels' plain versions) where its gate opens, lax.scan under BF16_ACT
RNN_T, RNN_B, RNN_D, RNN_H = 5, 3, 4, 6


def _recurrent(cell):
    def make():
        jc, pc = {"lstm": (jnn.LSTMCell, nn.LSTMCell),
                  "gru": (jnn.GRUCell, nn.GRUCell)}[cell]
        return (jnn.Recurrent().add(jc(RNN_D, RNN_H)),
                nn.Recurrent().add(pc(RNN_D, RNN_H, device="cpu")))
    return make


def _birecurrent():
    return (jnn.BiRecurrent(jnn.LSTMCell(RNN_D, RNN_H),
                            jnn.LSTMCell(RNN_D, RNN_H)),
            nn.BiRecurrent(nn.LSTMCell(RNN_D, RNN_H, device="cpu"),
                           nn.LSTMCell(RNN_D, RNN_H, device="cpu")))


RECURRENCES = {"lstm": _recurrent("lstm"), "bilstm": _birecurrent,
               "gru": _recurrent("gru")}


@pytest.mark.parametrize("name", POLICIES)
@pytest.mark.parametrize("rec", sorted(RECURRENCES))
def test_recurrence_matches_jax_under_the_policy(monkeypatch, rec, name):
    monkeypatch.setattr(jax_recurrent, "_PALLAS_BILSTM", "interpret")
    set_seed(5)
    jm, pm = RECURRENCES[rec]()
    res = run_pair(jm, pm, _x((RNN_B, RNN_T, RNN_D), 6), name,
                   training=True)
    check_pair(res, name)


def test_recurrent_lstm_no_grad_route_is_the_grad_route():
    """The no-grad LSTM (``lstm_scan``, bf16 wht) gives what the grad
    route (``bilstm_recurrence``) gives under the same policy."""
    pm = nn.Recurrent().add(nn.LSTMCell(RNN_D, RNN_H, device="cpu"))
    x = torch.from_numpy(_x((RNN_B, RNN_T, RNN_D), 7))
    with policy("BF16_COMPUTE"):
        with torch.no_grad():
            y0 = pm(x)
        y1 = pm(x)
    assert y1.requires_grad and y0.dtype == y1.dtype == torch.float32
    torch.testing.assert_close(y0, y1.detach(), rtol=1e-6, atol=1e-7)


# -- the JAX tests of the policy's rewrites (tests/test_perf_rewrites.py) ---

def test_batchnorm_compute_dtype_keeps_f32_stats():
    """BN under a reduced-precision policy: the APPLY chain runs in the
    compute dtype, but batch statistics and running-stat EMAs stay f32
    and the output dtype is preserved."""
    torch.manual_seed(6)
    m = nn.SpatialBatchNormalization(4, device="cpu")
    x = torch.from_numpy(np.random.RandomState(0).randn(8, 4, 5, 5)
                         .astype(np.float32))
    s0 = export_state(m)

    y32 = m(x)
    s32 = export_state(m)
    load_jax_state(m, s0)
    pt.set_policy(pt.BF16_COMPUTE)
    try:
        ybf = m(x)
    finally:
        pt.set_policy(pt.FP32)
    sbf = export_state(m)
    assert ybf.dtype == torch.float32
    for k in s32["~"]:
        assert sbf["~"][k].dtype == np.float32
        # stats identical: they are computed from the f32 input either way
        np.testing.assert_allclose(sbf["~"][k], s32["~"][k], rtol=1e-6)
    np.testing.assert_allclose(ybf.detach().numpy(), y32.detach().numpy(),
                               rtol=2e-2, atol=3e-2)


def test_maxpool_compute_dtype_scoped_to_policy():
    m = nn.SpatialMaxPooling(2, 2, 2, 2)
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 4, 8, 8)
                         .astype(np.float32))

    y_f32 = m(x)
    assert y_f32.dtype == torch.float32

    pt.set_policy(pt.BF16_COMPUTE)
    try:
        y_bf = m(x)
    finally:
        pt.set_policy(pt.FP32)
    # output dtype preserved; values equal up to bf16 rounding of the max
    assert y_bf.dtype == torch.float32
    np.testing.assert_allclose(y_bf.numpy(), y_f32.numpy(), rtol=8e-3,
                               atol=1e-6)
    # FP32 policy: bitwise identical to the pool of the f32 input as it is
    y_off = nn.SpatialMaxPooling(2, 2, 2, 2)(x)
    np.testing.assert_array_equal(y_f32.numpy(), y_off.numpy())


# -- the routes --------------------------------------------------------------

def test_fp32_policy_reproduces_the_default_bits():
    """Setting FP32 explicitly casts nothing: a conv net's and an LSTM's
    forward and gradients keep their bits, and a float64 model stays
    float64."""
    torch.manual_seed(0)
    model = nn.Sequential(
        nn.SpatialConvolution(3, 4, 3, 3, device="cpu"), nn.ReLU(),
        nn.SpatialMaxPooling(2, 2), nn.SpatialCrossMapLRN(5, 1e-4),
        nn.SpatialBatchNormalization(4, device="cpu"))
    rnn = nn.BiRecurrent(nn.LSTMCell(4, 5, device="cpu"),
                         nn.LSTMCell(4, 5, device="cpu"))
    x = torch.from_numpy(_x((2, 3, 8, 8)))
    s = torch.from_numpy(_x((2, 5, 4)))

    def run(m, v):
        state = export_state(m)
        out = m(v.clone().requires_grad_())
        out.sum().backward()
        grads = [p.grad.clone() for p in m.parameters()]
        m.zero_grad(set_to_none=True)
        load_jax_state(m, state)
        return out.detach(), grads

    for m, v in ((model, x), (rnn, s)):
        before = run(m, v)
        with policy("FP32"):
            after = run(m, v)
        assert torch.equal(before[0], after[0])
        assert all(torch.equal(a, b) for a, b in zip(before[1], after[1]))
    with policy("FP32"):
        y64 = model.double()(x.double())
    assert y64.dtype == torch.float64


def test_a_captured_chunk_is_keyed_on_the_policy():
    """The CUDA-graph capture's key (``_capture_key``) names the policy:
    a step after ``set_policy`` captures anew, never replaying a graph
    recorded under another policy."""
    m = nn.Linear(3, 2, device="cpu")
    (m(torch.ones(1, 3)).sum()).backward()
    params = list(m.parameters())
    x, y = torch.ones(2, 1, 3), torch.ones(2, 1)
    keys = {}
    for name in POLICIES:
        with policy(name):
            keys[name] = lopt._capture_key(params, m, {}, x, y, {"lr": 0.1})
    assert len(set(keys.values())) == 3
    assert lopt._capture_key(params, m, {}, x, y, {"lr": 0.1}) == keys["FP32"]


def test_bf16_act_takes_the_step_route_as_jax_does():
    """Under BF16_ACT the recurrence kernels' gate is shut (the JAX
    ``_pallas_gate``): every cell walks its step, a BiRecurrent of LSTMs
    its fused step loop; under BF16_COMPUTE the kernels run."""
    from bigdl_tpu_torch.nn import recurrent as rec

    x = torch.from_numpy(_x((2, 4, 3)))
    for make in (lambda: nn.Recurrent().add(nn.LSTMCell(3, 4, device="cpu")),
                 lambda: nn.Recurrent().add(nn.GRUCell(3, 4, device="cpu")),
                 lambda: nn.BiRecurrent(nn.LSTMCell(3, 4, device="cpu"),
                                        nn.LSTMCell(3, 4, device="cpu"))):
        m = make()
        for name, stepped in (("BF16_ACT", 1), ("BF16_COMPUTE", 0),
                              ("FP32", 0)):
            before = rec.step_route_calls
            with policy(name):
                m(x)
                assert rec.kernel_gate() == (name != "BF16_ACT")
            assert rec.step_route_calls - before == stepped, (make, name)


# Recurrent(RnnCell) under BF16_COMPUTE: the port's kernel route (its
# bf16-weight form's plain version) for every kind and for truncated
# chunks, against the JAX module with shared weights: the JAX kernel route
# (interpreted) for Tanh at full BPTT, its lax.scan of ``_step`` for
# another kind and for a truncated run.  The file's bf16 tolerances: the
# step route sums the biases in another order than the kernel route (an
# f32 rounding, which can flip a bf16 rounding of h at the product), and
# its backward carries the cotangents through ``_step``'s bf16 casts (a
# bf16 product's gradient is bf16) where the kernel keeps dz f32 and
# rounds it at the product only: the outputs agree within ~1e-7, the
# gradients of the step-route cases within ~3e-2 (i2h's), Tanh's within
# ~6e-7.
RNN_CELLS = {"tanh": (lambda: jnn.Tanh(), lambda: nn.Tanh(), 0),
             "relu": (lambda: jnn.ReLU(), lambda: nn.ReLU(), 0),
             "tanh_truncated": (lambda: jnn.Tanh(), lambda: nn.Tanh(), 2)}


@pytest.mark.parametrize("case", sorted(RNN_CELLS))
def test_rnn_cell_under_bf16_compute_matches_jax(monkeypatch, case):
    from bigdl_tpu_torch.nn import recurrent as rec

    monkeypatch.setattr(jax_recurrent, "_PALLAS_BILSTM", "interpret")
    j_act, p_act, k = RNN_CELLS[case]
    set_seed(5)
    jm = jnn.Recurrent(bptt_truncate=k).add(
        jnn.RnnCell(RNN_D, RNN_H, j_act()))
    pm = nn.Recurrent(bptt_truncate=k).add(
        nn.RnnCell(RNN_D, RNN_H, p_act(), device="cpu"))
    before = rec.step_route_calls
    res = run_pair(jm, pm, _x((RNN_B, RNN_T, RNN_D), 6), "BF16_COMPUTE",
                   training=True)
    assert rec.step_route_calls == before      # the kernel route, no step
    check_pair(res, "BF16_COMPUTE")


def test_rnn_cell_routes_under_each_policy():
    """BF16_ACT takes the step route (its output bf16), as JAX does;
    BF16_COMPUTE the kernel route with an f32 output and the bf16-weight
    form; FP32 the f32 form."""
    from bigdl_tpu_torch.nn import recurrent as rec

    m = nn.Recurrent().add(nn.RnnCell(3, 4, device="cpu"))
    x = torch.from_numpy(_x((2, 4, 3)))
    for name, dtype, stepped in (("BF16_COMPUTE", torch.float32, 0),
                                 ("BF16_ACT", torch.bfloat16, 1),
                                 ("FP32", torch.float32, 0)):
        before = rec.step_route_calls
        with policy(name):
            y = m(x)
        assert y.dtype == dtype, name
        assert rec.step_route_calls - before == stepped, name


# -- the slice's gate: three steps of three models ---------------------------

def _lenet():
    from bigdl_tpu.models.lenet import LeNet5 as J
    from bigdl_tpu_torch.models.lenet import LeNet5 as P
    return J(10), P(10, device="cpu"), (8, 1, 28, 28), 10


def _textclassifier():
    from bigdl_tpu.models.textclassifier import TextClassifierBiLSTM as J
    from bigdl_tpu_torch.models.textclassifier import (
        TextClassifierBiLSTM as P)
    return J(5, 6, hidden_size=7), P(5, 6, 7, device="cpu"), (4, 6, 6), 5


def _transformer():
    from bigdl_tpu.models.transformer import TransformerClassifier as J
    from bigdl_tpu_torch.models.transformer import (
        TransformerClassifier as P)
    kw = dict(d_model=16, n_heads=2, n_layers=1, hidden=32, dropout=0.0)
    return J(4, **kw), P(4, **kw, device="cpu"), (3, 6, 16), 4


def _jax_steps(jm, x, y, steps, lr):
    from bigdl_tpu.nn.criterion import ClassNLLCriterion

    crit = ClassNLLCriterion()
    params = jm.params()
    ctx = Context(training=True, key=jax.random.PRNGKey(0))

    def loss_fn(p):
        out, _ = jm.apply(p, jnp.asarray(x), jm.state(), ctx)
        return crit.forward(out, jnp.asarray(y))

    losses = []
    for _ in range(steps):
        loss, g = jax.value_and_grad(loss_fn)(params)
        params = jax.tree_util.tree_map(lambda p, d: p - lr * d, params, g)
        losses.append(float(loss))
    return losses, params


def _port_steps(pm, x, y, steps, lr):
    crit = nn.ClassNLLCriterion()
    losses = []
    for _ in range(steps):
        loss = crit(pm(torch.from_numpy(x)), torch.from_numpy(y))
        pm.zero_grad(set_to_none=True)
        loss.backward()
        with torch.no_grad():
            for p in pm.parameters():
                p -= lr * p.grad
        losses.append(float(loss.detach()))
    return losses


@pytest.mark.parametrize("model", ["lenet", "textclassifier",
                                   "transformer"])
def test_three_steps_under_bf16_compute_match_jax(monkeypatch, model):
    monkeypatch.setattr(jax_recurrent, "_PALLAS_BILSTM", "interpret")
    monkeypatch.setattr(jax_pooling, "_PALLAS_POOL", "interpret")
    set_seed(8)
    jm, pm, shape, classes = {"lenet": _lenet,
                              "textclassifier": _textclassifier,
                              "transformer": _transformer}[model]()
    load_jax_params(pm, jax.tree_util.tree_map(np.asarray, jm.params()))
    pm.train()
    rs = np.random.RandomState(9)
    x = rs.randn(*shape).astype(np.float32)
    y = rs.randint(1, classes + 1, (shape[0],)).astype(np.float32)
    with policy("BF16_COMPUTE"):
        want, params = _jax_steps(jm, x, y, 3, 0.05)
        got = _port_steps(pm, x, y, 3, 0.05)
    np.testing.assert_allclose(got, want, **FWD_TOL["BF16"])
    flat = _flat(jax.tree_util.tree_map(np.asarray, params))
    mine = _flat(export_params(pm))
    assert set(flat) == set(mine)
    for path, v in flat.items():
        np.testing.assert_allclose(mine[path], v, **BWD_TOL["BF16"],
                                   err_msg=str(path))


# -- the DistriOptimizer under the policy ------------------------------------

@pytest.fixture(scope="module")
def distri_bf16_runs():
    """Plain DP on two gloo ranks and LocalOptimizer on the global batch
    (tests/test_torch_distri_optimizer.py's MLP specs), both under
    BF16_COMPUTE, 3 steps."""
    from tests.test_torch_distri_optimizer import _spec

    specs = [_spec(iters=3), _spec(optimizer="local", iters=3)]
    return launch(W.policy_case, 2, "gloo", ("BF16_COMPUTE", specs))


def test_distri_optimizer_under_bf16_compute_matches_local(distri_bf16_runs):
    """test_plain_matches_local_and_jax's pair under BF16_COMPUTE.  The
    losses hold its tolerance (TOL: rtol 1e-4, atol 1e-5); the weights
    the bf16 gradient wire's pair's (BF16_TOL): under the policy a
    weight's gradient is a bf16 product, as in the JAX package, so each
    rank's partial sum over its half of the batch is rounded to bf16
    before the f32 all-reduce, where LocalOptimizer rounds the whole
    batch's sum once (~5e-5 apart after 3 steps at lr 0.1)."""
    from tests.test_torch_distri_optimizer import (BF16_TOL, TOL,
                                                   assert_trees)

    for dp, local in distri_bf16_runs:
        assert dp["type"] == "DistriOptimizer" and dp["world"] == 2
        assert dp["compute_dtype"] == local["compute_dtype"] == (
            "torch.bfloat16")
        np.testing.assert_allclose(dp["loss"], local["loss"], **TOL)
        assert_trees(dp["params"], local["params"], **BF16_TOL)
