"""The port's OptimMethods against the JAX package's on the CPU: the
functional ``optimize(feval, x)`` of ``SGD``, ``Adagrad`` and ``LBFGS``
(on tests/test_optim.py's quadratic and Rosenbrock, :102-140, and on a
small MLP's loss), ``Adagrad`` through ``LocalOptimizer`` (the setup of
tests/test_training.py:60-69, with and without ``learningRateDecay``;
the n-step chunk; a resume from a JAX-written checkpoint), and SGD's
per-parameter learning rates (``state['learningRates']``, the port of
tests/test_compat_surface.py:277-305, and trajectories at mixed scales
under momentum and nesterov).

The same inputs, made with numpy from a seed, go through both packages.
Tolerances: the functional steps rtol 1e-5, atol 1e-6 (f32, sums in
another order); L-BFGS over 100 Rosenbrock iterations and the training
trajectories rtol 1e-4, atol 1e-5 (tests/test_torch_dispatch.py's: f32
reductions of a batch in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.dataset import DataSet as JaxDataSet
from bigdl_tpu.dataset import Sample as JaxSample
from bigdl_tpu.dataset import SampleToBatch as JaxSampleToBatch
from bigdl_tpu.obs import events as obs_events
from bigdl_tpu.optim import LBFGS as JaxLBFGS
from bigdl_tpu.optim import SGD as JaxSGD
from bigdl_tpu.optim import Adagrad as JaxAdagrad
from bigdl_tpu.optim import LocalOptimizer as JaxLocalOptimizer
from bigdl_tpu.optim import max_iteration as jax_max_iteration
from bigdl_tpu.optim import several_iteration as jax_several_iteration
from bigdl_tpu.utils import file as JaxFile
from bigdl_tpu.utils.random import set_seed
from bigdl_tpu.utils.table import T as JaxT
from bigdl_tpu_torch import nn, ops
from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToBatch
from bigdl_tpu_torch.nn.module import (export_params, load_jax_params,
                                       tree_of)
from bigdl_tpu_torch.optim import (LBFGS, SGD, Adagrad, DistriOptimizer,
                                   LocalOptimizer, Step, max_iteration,
                                   several_iteration)
from bigdl_tpu_torch.optim.lbfgs import ls_wolfe
from bigdl_tpu_torch.utils import file as File
from bigdl_tpu_torch.utils.table import T

STEP_TOL = dict(rtol=1e-5, atol=1e-6)
TOL = dict(rtol=1e-4, atol=1e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch_tree(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  tree)


def _assert_tree(got, want, **tol):
    a = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(lambda t: t.numpy(), got))
    b = jax.tree_util.tree_leaves_with_path(_np(want))
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        np.testing.assert_allclose(x, y, **tol,
                                   err_msg=jax.tree_util.keystr(path))


# -- feval on both packages ---------------------------------------------

def jax_quadratic(x):
    """f = sum((x - 3)^2) over a pytree (tests/test_optim.py:19-23)."""
    loss = sum(((v - 3.0) ** 2).sum() for v in jax.tree_util.tree_leaves(x))
    return loss, jax.tree_util.tree_map(lambda v: 2 * (v - 3.0), x)


def port_quadratic(x):
    leaves = jax.tree_util.tree_leaves(x)
    loss = sum(((v - 3.0) ** 2).sum() for v in leaves)
    return loss, jax.tree_util.tree_map(lambda v: 2 * (v - 3.0), x)


def _rosen(w):
    return (1 - w[0]) ** 2 + 100 * (w[1] - w[0] ** 2) ** 2


def jax_rosenbrock(x):
    v = x["v"]
    return _rosen(v), {"v": jax.grad(_rosen)(v)}


def port_rosenbrock(x):
    v = x["v"].detach().requires_grad_(True)
    loss = _rosen(v)
    (g,) = torch.autograd.grad(loss, v)
    return loss.detach(), {"v": g}


def _mlp_problem(seed=0):
    """A 6-16-3 Tanh MLP's mean NLL on 32 fixed records: the JAX params
    tree (numpy), and the feval of each package over a tree of that
    layout."""
    set_seed(seed)
    jm = jnn.Sequential(jnn.Linear(6, 16), jnn.Tanh(), jnn.Linear(16, 3),
                        jnn.LogSoftMax())
    params = _np(jm.params())
    rs = np.random.RandomState(seed)
    xs = rs.randn(32, 6).astype(np.float32)
    ys = (rs.randint(0, 3, 32) + 1).astype(np.float32)
    jcrit = jnn.ClassNLLCriterion()
    from bigdl_tpu.nn.module import Context

    def jloss(p):
        out, _ = jm.apply(p, jnp.asarray(xs), jm.state(), Context())
        return jcrit.apply_loss(out, jnp.asarray(ys))

    def jfeval(p):
        return jax.value_and_grad(jloss)(p)

    pm = load_jax_params(nn.Sequential(nn.Linear(6, 16), nn.Tanh(),
                                       nn.Linear(16, 3), nn.LogSoftMax()),
                         params)
    pcrit = nn.ClassNLLCriterion()
    tx, ty = torch.from_numpy(xs), torch.from_numpy(ys)

    def pfeval(p):
        pm.load_params(p)
        pm.zero_grad(set_to_none=True)
        loss = pcrit(pm(tx), ty)
        loss.backward()
        return loss.detach(), tree_of(pm, [q.grad.clone()
                                           for q in pm.parameters()])

    return params, jfeval, pfeval


SGD_CONFIGS = [
    {"learningRate": 0.1},
    {"learningRate": 0.1, "momentum": 0.9},
    {"learningRate": 0.1, "momentum": 0.9, "dampening": 0.0,
     "nesterov": True},
    {"learningRate": 0.05, "momentum": 0.5, "weightDecay": 1e-2,
     "learningRateDecay": 0.1},
]


@pytest.mark.parametrize("cfg", SGD_CONFIGS, ids=lambda c: "-".join(c))
def test_sgd_optimize_matches_jax_on_the_quadratic(cfg):
    """Ten ``SGD.optimize`` calls on a dict pytree: every iterate, the
    losses, ``evalCounter``, the momentum buffer ``dfdx`` and the
    negative ``currentLearningRate`` as in JAX."""
    x0 = {"a": np.zeros(4, np.float32), "b": np.ones((2, 2), np.float32)}
    jx, px = _np(x0), _torch_tree(x0)
    jc, pc = JaxT(**cfg), T(**cfg)
    jm, pm = JaxSGD(), SGD()
    for _ in range(10):
        jx, jl = jm.optimize(jax_quadratic, jx, jc, jc)
        px, pl = pm.optimize(port_quadratic, px, pc, pc)
        _assert_tree(px, jx, **STEP_TOL)
        np.testing.assert_allclose(float(pl[0]), float(jl[0]), **STEP_TOL)
    assert pc["evalCounter"] == jc["evalCounter"] == 10
    assert pc["currentLearningRate"] == pytest.approx(
        jc["currentLearningRate"], rel=1e-12)
    assert pc["currentLearningRate"] < 0
    if cfg.get("momentum"):
        _assert_tree(pc["dfdx"], jc["dfdx"], **STEP_TOL)
    else:
        assert "dfdx" not in pc
    assert pm.get_hyper_parameter(pc) == jm.get_hyper_parameter(jc)
    pm.clear_history(pc)
    assert "dfdx" not in pc


def test_sgd_optimize_with_learning_rates_matches_jax():
    x0 = {"a": np.zeros(4, np.float32), "b": np.ones((2, 2), np.float32)}
    lrs = {"a": np.asarray([0.0, 0.5, 1.0, 2.0], np.float32),
           "b": np.full((2, 2), 0.5, np.float32)}
    jx, px = _np(x0), _torch_tree(x0)
    jc = JaxT(learningRate=0.1, momentum=0.9, learningRates=lrs)
    pc = T(learningRate=0.1, momentum=0.9, learningRates=lrs)
    for _ in range(5):
        jx, _ = JaxSGD().optimize(jax_quadratic, jx, jc, jc)
        px, _ = SGD().optimize(port_quadratic, px, pc, pc)
    _assert_tree(px, jx, **STEP_TOL)
    assert float(px["a"][0]) == 0.0   # a zero rate never moves


@pytest.mark.parametrize("lrd", [0.0, 0.05])
def test_adagrad_optimize_matches_jax_on_the_quadratic(lrd):
    """tests/test_optim.py:109-116: 200 steps from zeros converge to 3;
    every 20th iterate, ``paramVariance`` and ``evalCounter`` equal
    JAX's."""
    x0 = {"a": np.zeros(4, np.float32), "b": np.full((3,), -1, np.float32)}
    jx, px = _np(x0), _torch_tree(x0)
    cfg = {"learningRate": 1.0, "learningRateDecay": lrd,
           "weightDecay": 1e-3}
    jc, pc = JaxT(**cfg), T(**cfg)
    for i in range(200):
        jx, _ = JaxAdagrad().optimize(jax_quadratic, jx, jc, jc)
        px, _ = Adagrad().optimize(port_quadratic, px, pc, pc)
        if i % 20 == 19:
            _assert_tree(px, jx, **STEP_TOL)
    _assert_tree(pc["paramVariance"], jc["paramVariance"], **STEP_TOL)
    assert pc["evalCounter"] == jc["evalCounter"] == 200
    if lrd == 0.0:
        np.testing.assert_allclose(px["a"].numpy(), 3.0, atol=1e-2)
    Adagrad().clear_history(pc)
    assert "paramVariance" not in pc


def test_lbfgs_quadratic_one_call_matches_jax():
    """tests/test_optim.py:120-126: one call converges; the iterate and
    f_hist equal JAX's; the state keeps the reference's keys."""
    x = {"a": np.zeros(6, np.float32)}
    jc, pc = JaxT(maxIter=20), T(maxIter=20)
    jx, jh = JaxLBFGS().optimize(jax_quadratic, _np(x), jc, jc)
    px, ph = LBFGS().optimize(port_quadratic, _torch_tree(x), pc, pc)
    np.testing.assert_allclose(px["a"].numpy(), 3.0, atol=1e-4)
    _assert_tree(px, jx, **STEP_TOL)
    np.testing.assert_allclose(ph, jh, **STEP_TOL)
    assert ph[-1] < ph[0]
    assert {"old_dirs", "old_stps", "g_prev", "d", "H_diag",
            "funcEval"} <= set(pc.keys())
    assert pc["funcEval"] == jc["funcEval"]
    LBFGS().clear_history(pc)
    assert "old_dirs" not in pc and "funcEval" not in pc


def test_lbfgs_rosenbrock_matches_jax():
    """tests/test_optim.py:128-140: 100 iterations reach (1, 1); the
    iterate and f_hist against JAX at the trajectories' tolerance."""
    x = {"v": np.zeros(2, np.float32)}
    jc, pc = JaxT(maxIter=100), T(maxIter=100)
    jx, jh = JaxLBFGS().optimize(jax_rosenbrock, _np(x), jc, jc)
    px, ph = LBFGS().optimize(port_rosenbrock, _torch_tree(x), pc, pc)
    np.testing.assert_allclose(px["v"].numpy(), [1.0, 1.0], atol=1e-2)
    assert len(ph) == len(jh)
    np.testing.assert_allclose(ph, jh, rtol=1e-4, atol=1e-6)
    _assert_tree(px, jx, **TOL)


@pytest.mark.parametrize("line_search", [True, False])
def test_lbfgs_on_an_mlp_matches_jax(line_search):
    params, jfeval, pfeval = _mlp_problem()
    cfg = dict(maxIter=8, lineSearch=line_search, learningRate=0.5)
    jc, pc = JaxT(**cfg), T(**cfg)
    jx, jh = JaxLBFGS().optimize(jfeval, params, jc, jc)
    px, ph = LBFGS().optimize(pfeval, _torch_tree(params), pc, pc)
    assert len(ph) == len(jh) and ph[-1] < ph[0]
    np.testing.assert_allclose(ph, jh, **TOL)
    _assert_tree(px, jx, **TOL)


@pytest.mark.parametrize("method", ["sgd", "adagrad"])
def test_first_order_optimize_on_an_mlp_matches_jax(method):
    """Five steps of the functional face on an MLP's loss, the tree in
    the JAX layout."""
    params, jfeval, pfeval = _mlp_problem(1)
    cfg = ({"learningRate": 0.5, "momentum": 0.9} if method == "sgd"
           else {"learningRate": 0.1, "learningRateDecay": 0.01})
    jm, pm = ((JaxSGD(), SGD()) if method == "sgd"
              else (JaxAdagrad(), Adagrad()))
    jc, pc = JaxT(**cfg), T(**cfg)
    jx, px = params, _torch_tree(params)
    for _ in range(5):
        jx, jl = jm.optimize(jfeval, jx, jc, jc)
        px, pl = pm.optimize(pfeval, px, pc, pc)
        np.testing.assert_allclose(float(pl[0]), float(jl[0]), **STEP_TOL)
    _assert_tree(px, jx, **STEP_TOL)


def test_optimize_takes_a_tensor_and_a_list():
    t = torch.zeros(3)
    out, _ = Adagrad().optimize(lambda v: ((v - 3).pow(2).sum(), 2 * (v - 3)),
                                t, T(learningRate=0.5))
    assert isinstance(out, torch.Tensor) and out.shape == (3,)
    lst = [torch.zeros(2), torch.ones(3)]
    out, _ = SGD().optimize(
        lambda v: (sum((a - 3).pow(2).sum() for a in v),
                   [2 * (a - 3) for a in v]), lst, T(learningRate=0.1))
    assert isinstance(out, list) and [o.shape for o in out] == [(2,), (3,)]
    np.testing.assert_allclose(out[0].numpy(), 0.6, rtol=1e-6)


def test_ls_wolfe_finds_a_wolfe_step():
    """The line search alone on the quadratic: the step it returns
    meets the sufficient decrease condition."""
    def feval(v):
        return float(((v - 3) ** 2).sum()), 2 * (v - 3)
    x = torch.zeros(4)
    f, g = feval(x)
    d = -g
    gtd = float(torch.dot(g, d))
    f_new, _, x_new, t, n = ls_wolfe(feval, x, 1.0, d, f, g, gtd)
    assert f_new <= f + 1e-4 * t * gtd and n >= 1
    np.testing.assert_allclose(x_new.numpy(), x.numpy() + t * d.numpy())


# -- Adagrad in the loop ----------------------------------------------------

def make_classification(n=128, d=6, classes=3, seed=0):
    """tests/test_training.py:19-24."""
    rng = np.random.RandomState(seed)
    w = rng.randn(d, classes) * 2
    xs = rng.randn(n, d).astype(np.float32)
    ys = (xs @ w + 0.1 * rng.randn(n, classes)).argmax(1) + 1.0
    return list(zip(xs, ys))


def _jax_linear():
    set_seed(2)
    return jnn.Sequential(jnn.Linear(6, 16), jnn.Tanh(), jnn.Linear(16, 3),
                          jnn.LogSoftMax())


def _port_linear(params):
    return load_jax_params(nn.Sequential(nn.Linear(6, 16), nn.Tanh(),
                                         nn.Linear(16, 3), nn.LogSoftMax()),
                           params)


@pytest.fixture()
def ring_log():
    log = obs_events.configure(None)
    yield log
    obs_events.reset()


def _jax_loop(state, iters, method, checkpoint=None, seed=5, model=None,
              records=None):
    jm = model or _jax_linear()
    records = records or make_classification()
    jds = JaxDataSet.array([JaxSample(x, np.asarray([y]))
                            for x, y in records]) >> JaxSampleToBatch(32)
    jopt = JaxLocalOptimizer(jm, jds, jnn.ClassNLLCriterion())
    jopt.set_optim_method(method)
    jopt.set_state(JaxT(**state))
    jopt.set_end_when(jax_max_iteration(iters))
    if checkpoint is not None:
        jopt.set_checkpoint(checkpoint, jax_several_iteration(4))
    set_seed(seed)
    jopt.optimize()
    return jm, jopt


def _port_loop(params, state, iters, method, seed=5, n=1, records=None):
    records = records or make_classification()
    pds = DataSet.array([Sample(x, np.asarray([y])) for x, y in records],
                        seed=seed) >> SampleToBatch(32)
    pm = _port_linear(params)
    popt = LocalOptimizer(pm, pds, nn.ClassNLLCriterion(), device="cpu")
    popt.set_optim_method(method)
    popt.set_state(T(**state))
    popt.set_end_when(max_iteration(iters))
    popt.set_iterations_per_dispatch(n)
    popt.optimize()
    return pm, popt


@pytest.mark.parametrize("lrd", [0.0, 0.01])
def test_adagrad_local_optimizer_matches_jax(lrd, ring_log):
    """tests/test_training.py:60-69 (Adagrad, lr 0.5, 30 iterations) from
    shared weights over the same epoch order: every step's loss, the
    final params, the variance and the step counter equal JAX's."""
    state = {"learningRate": 0.5, "learningRateDecay": lrd}
    jm = _jax_linear()
    init = _np(jm.params())
    _, jopt = _jax_loop(state, 30, JaxAdagrad(), model=jm)
    jlosses = [e["loss"] for e in ring_log.ring_events()
               if e["type"] == "step"]
    pm, popt = _port_loop(init, state, 30, Adagrad())
    plosses = [l for _, l in popt.loss_log]
    assert len(plosses) == len(jlosses) == 30
    np.testing.assert_allclose(plosses, jlosses, **TOL)
    assert popt.state["loss"] < 1.0          # the JAX test's bar
    _assert_tree(jax.tree_util.tree_map(torch.from_numpy,
                                        export_params(pm)),
                 jm.params(), **TOL)
    st = popt._export_opt_state(popt.opt_state)
    assert set(st) == {"variance", "step"}
    assert st["step"].dtype == np.int32 and int(st["step"]) == 30
    assert popt.opt_state["step"].device == torch.device("cpu")


def test_adagrad_chunk_equals_single_steps():
    """Four steps a dispatch (the CUDA graph's shape: one capture, the
    counter read on the device) give the bits of one a dispatch.  The
    schedule holds the base lr (the Default schedule, as in JAX, would
    also decay it once a dispatch), so Adagrad's own decay, from its
    step counter, is what moves the rate within a chunk."""
    params = _np(_jax_linear().params())
    state = {"learningRate": 0.5, "learningRateDecay": 0.05,
             "learningRateSchedule": Step(10 ** 6, 1.0)}
    one, o1 = _port_loop(params, state, 8, Adagrad(), n=1)
    four, o4 = _port_loop(params, state, 8, Adagrad(), n=4)
    assert o1.loss_log == o4.loss_log
    for a, b in zip(one.parameters(), four.parameters()):
        assert torch.equal(a, b)
    assert int(o1.opt_state["step"]) == int(o4.opt_state["step"]) == 8


def test_adagrad_nonfinite_step_keeps_everything():
    p = [torch.randn(3, 2), torch.randn(5)]
    g = [torch.randn(3, 2), torch.randn(5)]
    m = Adagrad()
    st = m.init_state(p)
    m.update(g, st, p, {"lr": 0.1, "lr_decay": 0.1})
    kept = [t.clone() for t in p + st["variance"]] + [st["step"].clone()]
    g[0][0, 0] = float("nan")
    m.update(g, st, p, {"lr": 0.1, "lr_decay": 0.1},
             finite=torch.tensor(False))
    for a, b in zip(p + st["variance"] + [st["step"]], kept):
        assert torch.equal(a, b)
    g[0][0, 0] = 1.0
    m.update(g, st, p, {"lr": 0.1, "lr_decay": 0.1},
             finite=torch.tensor(True))
    assert int(st["step"]) == 2 and not torch.equal(p[1], kept[1])


def test_adagrad_update_matches_jax_with_a_device_lr():
    """``update`` with lr a 0-d tensor (a captured graph's form) gives
    the bits of a float lr, and both equal the JAX ``update``."""
    rs = np.random.RandomState(4)
    p0 = {"w": rs.randn(4, 3).astype(np.float32),
          "b": rs.randn(3).astype(np.float32)}
    g0 = {"w": rs.randn(4, 3).astype(np.float32),
          "b": rs.randn(3).astype(np.float32)}
    hyper = {"lr": 0.3, "lr_decay": 0.2, "weight_decay": 1e-2}
    jp, jg = _np(p0), _np(g0)
    jst = JaxAdagrad().init_state(jp)
    for _ in range(3):
        jp, jst = JaxAdagrad().update(jg, jst, jp, hyper)
    outs = []
    for lr in (0.3, torch.tensor(0.3)):
        tp = [torch.from_numpy(p0[k].copy()) for k in ("b", "w")]
        tg = [torch.from_numpy(g0[k].copy()) for k in ("b", "w")]
        st = Adagrad().init_state(tp)
        for _ in range(3):
            Adagrad().update(tg, st, tp, dict(hyper, lr=lr))
        outs.append(tp)
        for t, k in zip(tp, ("b", "w")):
            np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]),
                                       **STEP_TOL)
        for t, k in zip(st["variance"], ("b", "w")):
            np.testing.assert_allclose(t.numpy(),
                                       np.asarray(jst["variance"][k]),
                                       **STEP_TOL)
        assert int(st["step"]) == int(jst["step"]) == 3
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_a_jax_adagrad_checkpoint_resumes_in_the_port(tmp_path, ring_log):
    """The JAX LocalOptimizer writes ``state.4`` with Adagrad's
    ``{"variance": tree, "step": int32}``; the port resumes from it and
    its next four steps equal the uninterrupted JAX run's; the port's
    own checkpoint of the same run has the JAX layout and resumes in the
    JAX package."""
    state = {"learningRate": 0.5, "learningRateDecay": 0.02}
    records = make_classification(32)      # one batch an epoch
    jm = _jax_linear()
    init = _np(jm.params())
    _jax_loop(state, 8, JaxAdagrad(), checkpoint=str(tmp_path / "jax"),
              model=jm, records=records)
    blob = File.load(str(tmp_path / "jax" / "state.4"))
    assert set(blob["opt_state"]) == {"variance", "step"}
    mid = JaxFile.load_module(str(tmp_path / "jax" / "model.4"))

    pds = DataSet.array([Sample(x, np.asarray([y])) for x, y in records],
                        seed=5) >> SampleToBatch(32)
    pm = _port_linear(_np(mid.params()))
    popt = LocalOptimizer(pm, pds, nn.ClassNLLCriterion(), device="cpu")
    popt.set_optim_method(Adagrad())
    popt.set_state(blob["state"])
    popt.set_optim_state(blob["opt_state"])
    popt.set_end_when(max_iteration(8))
    popt.optimize()
    assert int(popt.opt_state["step"]) == 8
    _assert_tree(jax.tree_util.tree_map(torch.from_numpy,
                                        export_params(pm)),
                 jm.params(), **TOL)

    # the port's file, resumed by the JAX package
    pm2 = _port_linear(init)
    popt2 = LocalOptimizer(pm2, pds, nn.ClassNLLCriterion(), device="cpu")
    popt2.set_optim_method(Adagrad()).set_state(T(**state))
    popt2.set_end_when(max_iteration(4))
    popt2.set_checkpoint(str(tmp_path / "port"), several_iteration(4))
    popt2.optimize()
    pblob = JaxFile.load(str(tmp_path / "port" / "state.4"))
    assert set(pblob["opt_state"]) == {"variance", "step"}
    assert np.asarray(pblob["opt_state"]["step"]).dtype == np.int32
    jm2 = JaxFile.load_module_into(_jax_linear(),
                                   str(tmp_path / "port" / "model.4"))
    jds = JaxDataSet.array([JaxSample(x, np.asarray([y]))
                            for x, y in records]) >> JaxSampleToBatch(32)
    jopt2 = JaxLocalOptimizer(jm2, jds, jnn.ClassNLLCriterion())
    jopt2.set_optim_method(JaxAdagrad())
    jopt2.set_state(pblob["state"])
    jopt2.set_optim_state(pblob["opt_state"])
    jopt2.set_end_when(jax_max_iteration(8))
    set_seed(5)
    jopt2.optimize()
    _assert_tree(jax.tree_util.tree_map(torch.from_numpy,
                                        export_params(pm)),
                 jm2.params(), **TOL)


# -- SGD's per-parameter learning rates ---------------------------------------

def test_per_param_learning_rates():
    """tests/test_compat_surface.py:277-305 on the port: a zero rate on
    the first Linear freezes it bit for bit; the second moves."""
    xs = np.random.RandomState(0).randn(32, 4).astype(np.float32)
    ys = np.float32(np.random.RandomState(1).randint(1, 3, size=(32,)))
    ds = DataSet.array([Sample(x, np.asarray([y], np.float32))
                        for x, y in zip(xs, ys)]) >> SampleToBatch(16)
    model = nn.Sequential(nn.Linear(4, 8), nn.ReLU(), nn.Linear(8, 2),
                          nn.LogSoftMax())
    before = export_params(model)
    scales = jax.tree_util.tree_map(np.ones_like, before)
    scales["0"]["~"] = {k: np.zeros_like(v)
                        for k, v in scales["0"]["~"].items()}
    opt = LocalOptimizer(model, ds, nn.ClassNLLCriterion(), device="cpu")
    opt.set_state(T(learningRate=0.5, learningRates=scales))
    opt.set_end_when(max_iteration(3))
    opt.optimize()
    after = export_params(model)
    for k, v in before["0"]["~"].items():
        np.testing.assert_array_equal(after["0"]["~"][k], v)
    assert any(not np.allclose(after["2"]["~"][k], before["2"]["~"][k])
               for k in before["2"]["~"])


@pytest.mark.parametrize("kind", ["momentum", "nesterov"])
def test_scaled_trajectory_matches_jax(kind, ring_log):
    """Rates 0, 0.5 and 2 (a scalar leaf, a per-row vector and a full
    leaf: each broadcast to its parameter) under momentum or nesterov,
    weight decay on: the losses and params of 12 steps equal JAX's, and
    the zero-rate leaf is bit-equal to its start."""
    jm = _jax_linear()
    init = _np(jm.params())
    scales = {"~": {},
              "0": {"~": {"weight": np.float32(0.0),
                          "bias": np.full((16,), 0.5, np.float32)}},
              "1": {"~": {}},
              "2": {"~": {"weight": np.full((3, 1), 2.0, np.float32),
                          "bias": np.asarray([0.5, 2.0, 0.0], np.float32)}},
              "3": {"~": {}}}
    state = {"learningRate": 0.2, "momentum": 0.9, "weightDecay": 1e-3,
             "learningRates": scales}
    if kind == "nesterov":
        state.update(dampening=0.0, nesterov=True)
    _jax_loop(state, 12, JaxSGD(), model=jm)
    jlosses = [e["loss"] for e in ring_log.ring_events()
               if e["type"] == "step"]
    pm, popt = _port_loop(init, state, 12, SGD())
    np.testing.assert_allclose([l for _, l in popt.loss_log], jlosses,
                               **TOL)
    _assert_tree(jax.tree_util.tree_map(torch.from_numpy,
                                        export_params(pm)),
                 jm.params(), **TOL)
    np.testing.assert_array_equal(export_params(pm)["0"]["~"]["weight"],
                                  init["0"]["~"]["weight"])


@pytest.mark.parametrize("h", [{"momentum": 0.0}, {"momentum": 0.9},
                               {"momentum": 0.9, "nesterov": True,
                                "weight_decay": 1e-3}],
                         ids=["plain", "momentum", "nesterov"])
def test_all_ones_scales_give_the_unscaled_bits(h):
    """The plain version at every scale 1 is bit-equal to the unscaled
    step, over three steps, params and velocity."""
    rs = np.random.RandomState(6)
    shapes = [(130, 7), (7,), (4097,), (100,)]
    base = [[torch.from_numpy(rs.randn(*s).astype(np.float32))
             for s in shapes] for _ in range(3)]
    runs = []
    for scaled in (False, True):
        p, g, v = ([t.clone() for t in ts] for ts in base)
        sc = [torch.ones(s) for s in shapes] if scaled else None
        for _ in range(3):
            ops.fused_sgd(p, g, v, 0.1, scales=sc, **h)
        runs.append(p + v)
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert ops.launch_counts()["fused_sgd_scaled"] == 0   # the CPU


def test_scaled_plain_version_matches_the_jax_update():
    """``ops.fused_sgd(..., scales=)`` over three steps equals the JAX
    ``SGD.update`` with ``lr_scales`` (its unfused path)."""
    rs = np.random.RandomState(7)
    keys = ("b", "w")
    p0 = {"w": rs.randn(6, 5).astype(np.float32),
          "b": rs.randn(5).astype(np.float32)}
    g0 = {k: rs.randn(*v.shape).astype(np.float32) for k, v in p0.items()}
    sc = {"w": rs.uniform(0, 2, (6, 5)).astype(np.float32),
          "b": np.float32(0.5)}
    hyper = {"lr": 0.1, "momentum": 0.9, "dampening": 0.1,
             "weight_decay": 1e-3}
    jp, jst = _np(p0), JaxSGD().init_state(_np(p0))
    for _ in range(3):
        jp, jst = JaxSGD().update(_np(g0), jst, jp,
                                  dict(hyper, lr_scales=_np(sc)))
    tp = [torch.from_numpy(p0[k].copy()) for k in keys]
    tg = [torch.from_numpy(g0[k].copy()) for k in keys]
    st = SGD().init_state(tp)
    scales = [torch.as_tensor(np.asarray(sc[k])) for k in keys]
    for _ in range(3):
        SGD().update(tg, st, tp, dict(hyper, lr_scales=scales))
    for t, k in zip(tp, keys):
        np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]), **STEP_TOL)
    for t, k in zip(st["velocity"], keys):
        np.testing.assert_allclose(t.numpy(),
                                   np.asarray(jst["velocity"][k]),
                                   **STEP_TOL)


def test_scales_are_checked():
    p = [torch.zeros(3, 2)]
    g, v = [torch.ones(3, 2)], [torch.zeros(3, 2)]
    with pytest.raises(ValueError, match="does not broadcast"):
        ops.fused_sgd(p, g, v, 0.1, scales=[torch.ones(4)])
    with pytest.raises(TypeError, match="float32"):
        ops.fused_sgd(p, g, v, 0.1, scales=[torch.ones(3, 2,
                                                       dtype=torch.float64)])
    with pytest.raises(ValueError, match="scales for"):
        ops.fused_sgd(p, g, v, 0.1, scales=[])
    ops.fused_sgd(p, g, v, 0.1, scales=[torch.tensor([[2.0], [0.0],
                                                      [1.0]])])
    np.testing.assert_allclose(p[0].numpy(),
                               [[-0.2, -0.2], [0.0, 0.0], [-0.1, -0.1]],
                               rtol=1e-6)


def _rates_run(method, **kw):
    records = make_classification(32)
    ds = DataSet.array([Sample(x, np.asarray([y])) for x, y in records],
                       seed=5) >> SampleToBatch(16)
    model = _port_linear(_np(_jax_linear().params()))
    scales = jax.tree_util.tree_map(np.ones_like, export_params(model))
    cls = DistriOptimizer if kw else LocalOptimizer
    opt = cls(model, ds, nn.ClassNLLCriterion(), device="cpu", **kw)
    opt.set_optim_method(method)
    opt.set_state(T(learningRate=0.1, learningRates=scales))
    opt.set_end_when(max_iteration(2))
    return opt


def test_learning_rates_with_another_method_raise_the_jax_error():
    with pytest.raises(ValueError, match="only supported by SGD, not "
                                         "Adagrad"):
        _rates_run(Adagrad()).optimize()


@pytest.mark.parametrize("kw", [{"zero1": True}, {"pipeline_stages": 1}],
                         ids=["zero1", "pipeline_stages"])
def test_learning_rates_under_zero1_and_pipeline_raise(kw):
    """As the JAX DistriOptimizer (bigdl_tpu/optim/distri_optimizer.py
    :621-628, :843-846)."""
    with pytest.raises(ValueError, match="learningRates"):
        _rates_run(SGD(), **kw).optimize()
