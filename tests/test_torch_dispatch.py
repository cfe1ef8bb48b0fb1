"""n iterations a dispatch in the port (``set_iterations_per_dispatch``)
against the JAX package's on the CPU, where the port runs the chunk as an
eager loop of n steps: from shared weights, over a dataset whose epochs
end inside chunks, under a Poly lr read once a dispatch, the losses of
each dispatch's last step, the lr sequence, ``neval``, ``epoch`` and the
final parameters equal the JAX run's (rtol 1e-4, atol 1e-5: fp32 sums
in another order).  Then tests/test_training.py's learnability check,
ported."""
import jax
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.dataset import DataSet as JaxDataSet
from bigdl_tpu.dataset import Sample as JaxSample
from bigdl_tpu.dataset import SampleToBatch as JaxSampleToBatch
from bigdl_tpu.obs import events as obs_events
from bigdl_tpu.optim import LocalOptimizer as JaxLocalOptimizer
from bigdl_tpu.optim import Poly as JaxPoly
from bigdl_tpu.optim import max_iteration as jax_max_iteration
from bigdl_tpu.utils.random import set_seed
from bigdl_tpu.utils.table import T as JaxT
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToBatch
from bigdl_tpu_torch.nn.module import export_params, load_jax_params
from bigdl_tpu_torch.optim import (LocalOptimizer, Poly, max_epoch,
                                   max_iteration)
from bigdl_tpu_torch.utils.random import generator
from bigdl_tpu_torch.utils.table import T

TOL = dict(rtol=1e-4, atol=1e-5)


def _data(n=20, d=5, seed=0):
    rs = np.random.RandomState(seed)
    xs = rs.randn(n, d).astype(np.float32)
    ys = (rs.randint(0, 3, n) + 1).astype(np.float32)
    return list(zip(xs, ys))


@pytest.fixture()
def ring_log():
    log = obs_events.configure(None)
    yield log
    obs_events.reset()


def _record_lr(opt):
    """Wrap the optimizer's lr read so that each dispatch's lr is kept."""
    seen, read = [], opt._current_lr

    def current_lr():
        seen.append(read())
        return seen[-1]
    opt._current_lr = current_lr
    return seen


@pytest.mark.parametrize("n", [2, 3])
def test_chunked_dispatch_matches_jax(n, ring_log):
    """20 samples in batches of 4: 5 steps an epoch, so a chunk of 2 or 3
    steps ends an epoch inside it; 11 iterations under Poly(0.5, 12)."""
    set_seed(1)
    jm = jnn.Sequential(jnn.Linear(5, 8), jnn.Tanh(), jnn.Linear(8, 3),
                        jnn.LogSoftMax())
    pm = load_jax_params(
        nn.Sequential(nn.Linear(5, 8), nn.Tanh(), nn.Linear(8, 3),
                      nn.LogSoftMax()),
        jax.tree_util.tree_map(np.asarray, jm.params()))
    state = dict(learningRate=0.2, momentum=0.9)

    jds = JaxDataSet.array([JaxSample(x, np.asarray([y]))
                            for x, y in _data()]) >> JaxSampleToBatch(4)
    jopt = JaxLocalOptimizer(jm, jds, jnn.ClassNLLCriterion())
    jopt.set_state(JaxT(**state, learningRateSchedule=JaxPoly(0.5, 12)))
    jopt.set_iterations_per_dispatch(n)
    jopt.set_end_when(jax_max_iteration(11))
    jlr = _record_lr(jopt)
    set_seed(5)
    jopt.optimize()
    jlosses = [e["loss"] for e in ring_log.ring_events()
               if e["type"] == "step"]

    pds = DataSet.array([Sample(x, np.asarray([y])) for x, y in _data()],
                        seed=5) >> SampleToBatch(4)
    popt = LocalOptimizer(pm, pds, nn.ClassNLLCriterion(), device="cpu")
    popt.set_state(T(**state, learningRateSchedule=Poly(0.5, 12)))
    popt.set_iterations_per_dispatch(n)
    popt.set_end_when(max_iteration(11))
    plr = _record_lr(popt)
    popt.optimize()
    dispatches = -(-11 // n)
    plosses = [l for ne, l in popt.loss_log if ne % n == 0]

    assert len(popt.loss_log) == dispatches * n
    assert len(jlr) == len(plr) == len(jlosses) == len(plosses) == \
        dispatches
    np.testing.assert_allclose(plr, jlr, rtol=1e-12)
    assert len(set(plr)) == dispatches          # the lr moved every dispatch
    assert popt.state["neval"] == jopt.state["neval"] == 1 + dispatches * n
    assert popt.state["epoch"] == jopt.state["epoch"]
    assert popt.state["epoch"] == 1 + dispatches * n // 5
    np.testing.assert_allclose(plosses, jlosses, **TOL)
    np.testing.assert_allclose(popt.state["loss"], jopt.state["loss"], **TOL)
    for a, b in zip(jax.tree_util.tree_leaves(export_params(pm)),
                    jax.tree_util.tree_leaves(jm.params())):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)


def test_the_chunk_runs_the_steps_of_one_a_dispatch():
    """Under a constant lr, over an epoch of whole chunks, n = 4 a dispatch
    gives the bits of one a dispatch."""
    def run(n):
        ds = DataSet.array([Sample(x, np.asarray([y])) for x, y in _data()],
                           seed=3) >> SampleToBatch(5)
        g = generator(7)
        model = nn.Sequential(nn.Linear(5, 8, generator=g), nn.Tanh(),
                              nn.Linear(8, 3, generator=g), nn.LogSoftMax())
        opt = LocalOptimizer(model, ds, nn.ClassNLLCriterion(), device="cpu")
        opt.set_state(T(learningRate=0.1, momentum=0.9))
        opt.set_iterations_per_dispatch(n).set_end_when(max_iteration(8))
        opt.optimize()
        return opt, torch.cat([p.detach().reshape(-1)
                               for p in model.parameters()])

    (one, p1), (four, p4) = run(1), run(4)
    assert one.loss_log == four.loss_log
    assert torch.equal(p1, p4)
    assert four.state["neval"] == one.state["neval"] == 9
    assert four.state["epoch"] == one.state["epoch"] == 3


def _classification(n=128, d=6, classes=3, seed=0):
    rng = np.random.RandomState(seed)
    w = rng.randn(d, classes) * 2
    xs = rng.randn(n, d).astype(np.float32)
    ys = (xs @ w + 0.1 * rng.randn(n, classes)).argmax(1) + 1.0
    return [Sample(x, np.asarray([y])) for x, y in zip(xs, ys)]


@pytest.mark.parametrize("n", [1, 4])
def test_learns_linearly_separable(n):
    """tests/test_training.py::TestLocalOptimizer::
    test_learns_linearly_separable on the port, at one and four
    iterations a dispatch."""
    samples = _classification()
    ds = DataSet.array(samples, seed=2) >> SampleToBatch(32)
    g = generator(2)
    model = nn.Sequential(nn.Linear(6, 16, generator=g), nn.Tanh(),
                          nn.Linear(16, 3, generator=g), nn.LogSoftMax())
    opt = LocalOptimizer(model, ds, nn.ClassNLLCriterion(), device="cpu")
    opt.set_state(T(learningRate=0.5, momentum=0.9))
    opt.set_iterations_per_dispatch(n).set_end_when(max_epoch(15))
    opt.optimize()
    xs = torch.from_numpy(np.stack([s.feature for s in samples]))
    ys = np.asarray([s.label[0] for s in samples])
    with torch.no_grad():
        preds = model.evaluate()(xs).argmax(1).numpy() + 1
    assert (preds == ys).mean() > 0.9
