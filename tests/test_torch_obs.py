"""The port's observability on its training paths against the JAX
package's (bigdl_tpu/obs, tests/test_obs.py): LeNet-5 through both
``LocalOptimizer``s from the same weights and batches, events to a run
directory each, taps read at a cadence and TensorBoard sinks attached.
Every line the port writes passes the JAX ``validate_event``; the kinds,
step numbers, losses and taps are the JAX run's; the monitor's
materialized steps follow the JAX gate for eager and chunked runs; an
injected NaN gives the JAX ``nonfinite_grads`` and an abort bundle with
the JAX file set; two gloo ranks' taps equal the JAX ``DistriOptimizer``'s
on two CPU devices (its jit step and its ``shard_map`` one); the taps
form's plain version holds against float64 sums; the spans are
``torch.profiler`` ranges.

The process-wide logs and registries of both packages are reset around
every test (the suite runs under ``xdist --dist loadfile``)."""
import glob
import os

import jax
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.dataset import DataSet as JaxDataSet
from bigdl_tpu.dataset import mnist as jax_mnist
from bigdl_tpu.models.lenet import LeNet5 as JaxLeNet5
from bigdl_tpu.nn import pooling as jax_pooling
from bigdl_tpu.obs import events as jax_events
from bigdl_tpu.obs import metrics as jax_metrics
from bigdl_tpu.obs import summary as jax_summary
from bigdl_tpu.obs import taps as jax_taps
from bigdl_tpu.optim import SGD as JaxSGD
from bigdl_tpu.optim import Adagrad as JaxAdagrad
from bigdl_tpu.optim import DistriOptimizer as JaxDistriOptimizer
from bigdl_tpu.optim import LocalOptimizer as JaxLocalOptimizer
from bigdl_tpu.optim import Loss as JaxLoss
from bigdl_tpu.optim import NonFiniteGradError as JaxNonFinite
from bigdl_tpu.optim import every_epoch as jax_every_epoch
from bigdl_tpu.optim import max_iteration as jax_max_iteration
from bigdl_tpu.parallel.mesh import data_parallel_mesh
from bigdl_tpu.utils.random import set_seed
from bigdl_tpu.utils.table import T as JaxT
from bigdl_tpu_torch import nn, obs, ops
from bigdl_tpu_torch.dataset import DataSet, ImgNormalizer, ImgToBatch, mnist
from bigdl_tpu_torch.models.lenet import LeNet5
from bigdl_tpu_torch.nn.module import load_jax_params
from bigdl_tpu_torch.obs import events, ledger, metrics, recorder
from bigdl_tpu_torch.obs import summary, taps
from bigdl_tpu_torch.optim import (SGD, Adagrad, LocalOptimizer, Loss,
                                   NonFiniteGradError, every_epoch,
                                   max_iteration)
from bigdl_tpu_torch.optim.local_optimizer import _capture_key
from bigdl_tpu_torch.parallel.launch import launch
from bigdl_tpu_torch.utils.table import T
from tests.helpers import torch_obs_workers as OW

TAP_TOL = dict(rtol=1e-5, atol=1e-7)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
STATE = dict(learningRate=0.05, momentum=0.9)
#: the JAX crash bundle's files (bigdl_tpu/obs/diagnostics.py)
BUNDLE = {"reason.txt", "events.jsonl", "threads.txt", "config.json",
          "memory.json", "extra.json"}


def reset_obs():
    for mod in (events, recorder):
        mod.reset()
    metrics.reset()
    ledger.reset()
    jax_events.reset()
    jax_metrics.reset()


@pytest.fixture(autouse=True)
def _fresh_obs():
    reset_obs()
    state = torch.random.get_rng_state()
    yield
    reset_obs()
    torch.random.set_rng_state(state)


@pytest.fixture()
def mosaic_pools(monkeypatch):
    monkeypatch.setattr(jax_pooling, "_PALLAS_POOL", "interpret")


def _sets(n=32, batch=8, poison=None):
    """The same synthetic digits for both packages (record ``poison`` NaN
    where given): (JAX dataset, port dataset)."""
    recs_j = jax_mnist.synthetic(n, 0)
    recs_p = mnist.synthetic(n, 0)
    if poison is not None:
        recs_j[poison].data[0, 0] = np.nan
        recs_p[poison].data[0, 0] = np.nan
    from bigdl_tpu.dataset.image import ImgNormalizer as JaxNormalizer
    from bigdl_tpu.dataset.image import ImgToBatch as JaxToBatch
    j = (JaxDataSet.array(recs_j)
         >> JaxNormalizer(jax_mnist.TRAIN_MEAN, jax_mnist.TRAIN_STD)
         >> JaxToBatch(batch))
    p = (DataSet.array(recs_p, seed=5)
         >> ImgNormalizer(mnist.TRAIN_MEAN, mnist.TRAIN_STD)
         >> ImgToBatch(batch))
    return j, p


def _pair(iters, cadence, n_disp=1, method="sgd", poison=None,
          abort_after=None, validate=False, tmp=None):
    """Both LocalOptimizers from one JAX LeNet-5 init; returns the two
    optimizers (trained)."""
    set_seed(1)
    jm = JaxLeNet5(10)
    pm = load_jax_params(LeNet5(10, device="cpu"),
                         jax.tree_util.tree_map(np.asarray, jm.params()))
    jset, pset = _sets(poison=poison)
    jo = JaxLocalOptimizer(jm, jset, jnn.ClassNLLCriterion())
    po = LocalOptimizer(pm, pset, nn.ClassNLLCriterion(), device="cpu")
    jo.set_optim_method(JaxSGD(fused=True) if method == "sgd"
                        else JaxAdagrad())
    po.set_optim_method(SGD(fused=True) if method == "sgd" else Adagrad())
    for o, t, mi in ((jo, JaxT, jax_max_iteration), (po, T, max_iteration)):
        o.set_state(t(**STATE)).set_end_when(mi(iters))
        o.set_taps(True, cadence)
        if n_disp > 1:
            o.set_iterations_per_dispatch(n_disp)
        if abort_after is not None:
            o.set_nonfinite_policy(abort_after)
    if validate:
        jval, pval = _sets(16, 8)
        jo.set_validation(jax_every_epoch(), jval,
                          [JaxLoss(jnn.ClassNLLCriterion())])
        po.set_validation(every_epoch(), pval,
                          [Loss(nn.ClassNLLCriterion())])
    if tmp is not None:
        jo.set_train_summary(jax_summary.TrainSummary(str(tmp / "j"), "lenet"))
        po.set_train_summary(summary.TrainSummary(str(tmp / "p"), "lenet"))
        jo.set_val_summary(jax_summary.ValidationSummary(str(tmp / "j"),
                                                         "lenet"))
        po.set_val_summary(summary.ValidationSummary(str(tmp / "p"),
                                                     "lenet"))
    return jo, po


def _run(opt, seed=None, expect=None):
    if seed is not None:
        set_seed(seed)   # the JAX epoch order draws from this stream
    if expect is None:
        opt.optimize()
    else:
        with pytest.raises(expect):
            opt.optimize()
    return opt


@pytest.fixture(scope="module")
def lenet_runs(tmp_path_factory):
    """One epoch of LeNet-5 (4 steps of 8), taps at cadence 2, a
    validation at the epoch's end, TensorBoard sinks, events of each
    package into its own run directory."""
    tmp = tmp_path_factory.mktemp("obs")
    jax_pooling._PALLAS_POOL, was = "interpret", jax_pooling._PALLAS_POOL
    try:
        reset_obs()
        jax_events.configure(str(tmp / "jax_run"))
        events.configure(str(tmp / "port_run"))
        jo, po = _pair(4, 2, validate=True, tmp=tmp)
        po._peak_flops = 1e12   # a given peak, as a card's: train_mfu
        _run(jo, seed=5)
        _run(po)
        jpath, ppath = jax_events.get().path, events.get().path
        for s in (jo._train_summary, jo._val_summary, po._train_summary,
                  po._val_summary):
            s.close()
        out = dict(jo=jo, po=po, tmp=tmp,
                   jax=jax_events.read_events(jpath),
                   port=events.read_events(ppath),
                   prom=metrics.render_prometheus(metrics.get().snapshot()))
    finally:
        jax_pooling._PALLAS_POOL = was
        reset_obs()
    return out


def _of(evs, kind):
    return [e for e in evs if e["type"] == kind]


def test_every_port_line_passes_the_jax_validator(lenet_runs):
    assert lenet_runs["port"]
    for e in lenet_runs["port"]:
        jax_events.validate_event(e)
        events.validate_event(e)
    assert {e["proc"] for e in lenet_runs["port"]} == {0}


def test_kinds_and_step_numbers_are_the_jax_runs(lenet_runs):
    keep = ("run_start", "step", "validation", "checkpoint", "run_end")

    def seq(evs):
        return [(e["type"], e.get("step")) for e in evs if e["type"] in keep]
    assert seq(lenet_runs["port"]) == seq(lenet_runs["jax"])
    assert [e["step"] for e in _of(lenet_runs["port"], "step")] == [1, 2, 3, 4]
    # the port's top-level phases are names the JAX run reports
    jp = {e["name"] for e in _of(lenet_runs["jax"], "phase")}
    pp = {e["name"] for e in _of(lenet_runs["port"], "phase")}
    assert {"data-load", "dispatch", "h2d", "host-wait"} <= pp
    assert pp - {"validate"} <= jp
    assert _of(lenet_runs["port"], "ledger")[0]["kind"] == "exec"


def test_losses_and_taps_are_the_jax_runs(lenet_runs):
    js, ps = _of(lenet_runs["jax"], "step"), _of(lenet_runs["port"], "step")
    np.testing.assert_allclose([e["loss"] for e in ps],
                               [e["loss"] for e in js], **LOSS_TOL)
    tapped = [(j, p) for j, p in zip(js, ps) if "taps" in j]
    assert [p["step"] for _, p in tapped] == [2, 4]
    for j, p in tapped:
        assert set(p["taps"]) == set(taps.TAP_NAMES)
        for k in taps.TAP_NAMES:
            np.testing.assert_allclose(p["taps"][k], j["taps"][k], **TAP_TOL)
    assert (list(lenet_runs["po"]._taps_monitor.materialized_steps)
            == list(lenet_runs["jo"]._taps_monitor.materialized_steps))
    jend, pend = _of(lenet_runs["jax"], "run_end")[0], \
        _of(lenet_runs["port"], "run_end")[0]
    assert pend["steps"] == jend["steps"] == 4
    # the tail was read at step 4 already: no tail in either run_end
    assert ("taps" in pend) == ("taps" in jend) == False   # noqa: E712


def test_validation_events_and_summaries_cross_read(lenet_runs):
    jv, pv = (_of(lenet_runs["jax"], "validation"),
              _of(lenet_runs["port"], "validation"))
    assert [(e["step"], e["method"]) for e in pv] == \
        [(e["step"], e["method"]) for e in jv] == [(2, "Loss"), (5, "Loss")]
    # the first is the JAX run's; at the epoch's end the port reads the
    # trained model, which the JAX ``validate`` of the trained JAX model
    # gives (the JAX loop's own reading there parts from it)
    from bigdl_tpu.optim import validate as jax_validate
    jval, _ = _sets(16, 8)
    jo = lenet_runs["jo"]
    (_, end), = jax_validate(jo.model, jo.model.params(), jo.model.state(),
                             jval, [JaxLoss(jnn.ClassNLLCriterion())])
    np.testing.assert_allclose([e["value"] for e in pv],
                               [jv[0]["value"], end.result()[0]],
                               **LOSS_TOL)
    tmp = lenet_runs["tmp"]
    for mine, theirs, reader in (("p", "j", jax_summary.read_scalars),
                                 ("j", "p", summary.read_scalars)):
        for part in ("train", "validation"):
            f_mine, = glob.glob(str(tmp / mine / "lenet" / part / "*"))
            f_theirs, = glob.glob(str(tmp / theirs / "lenet" / part / "*"))
            got, want = reader(f_mine), reader(f_theirs)
            assert [(s, t) for s, t, _ in got] == \
                [(s, t) for s, t, _ in want]
            if part == "validation":
                # each file holds its own run's validation events
                evs = jv if mine == "j" else pv
                np.testing.assert_allclose([v for *_, v in got],
                                           [e["value"] for e in evs],
                                           rtol=1e-6)
                continue
            for (_, tag, a), (_, _, b) in zip(got, want):
                if tag != "Throughput":
                    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_the_step_events_and_gauges_carry_the_loop(lenet_runs):
    prom = lenet_runs["prom"]
    assert 'train_step_wall_seconds{optimizer="local"}' in prom
    mfu = [v for n, lab, v in metrics.parse_prometheus(prom)
           if n == "train_mfu"]
    assert len(mfu) == 1 and 0 < mfu[0] <= 1
    assert "ledger_flops" in prom


@pytest.mark.parametrize("n_disp,cadence,iters", [
    (1, 1, 4), (1, 3, 8), (1, 10, 4), (4, 10, 12), (3, 4, 12)])
def test_materialized_steps_follow_the_jax_gate(mosaic_pools, n_disp,
                                                cadence, iters):
    jo, po = _pair(iters, cadence, n_disp=n_disp)
    _run(jo, seed=5)
    _run(po)
    assert list(po._taps_monitor.materialized_steps) == \
        list(jo._taps_monitor.materialized_steps)
    assert int(po.state["neval"]) == int(jo.state["neval"])
    # the first dispatch's taps (the same batches) are the JAX ones
    (js, jv), (ps, pv) = jo._taps_monitor.history[0], \
        po._taps_monitor.history[0]
    assert ps == js
    if ps + n_disp - 1 <= 4:   # the chunk's last step in the first epoch
        for k in taps.TAP_NAMES:
            np.testing.assert_allclose(pv[k], jv[k], **TAP_TOL)


def test_taps_add_no_host_read(mosaic_pools):
    """The taps ride the window's one read: the same host syncs with the
    taps on and off."""
    counts = []
    for on in (True, False):
        _, po = _pair(8, 3)
        po.set_taps(on, 3)
        _run(po)
        counts.append(po.host_syncs)
        assert bool(po._taps_monitor.history) == on
    # reads at 3 (cadence), 4 (the epoch's end), 7 (cadence), 8 (the end)
    assert counts[0] == counts[1] == 4


def test_adagrad_taps_match_jax(mosaic_pools):
    jo, po = _pair(2, 1, method="adagrad")
    _run(jo, seed=5)
    _run(po)
    for (js, jv), (ps, pv) in zip(jo._taps_monitor.history,
                                  po._taps_monitor.history):
        assert ps == js
        for k in taps.TAP_NAMES:
            np.testing.assert_allclose(pv[k], jv[k], **TAP_TOL)


def test_injected_nan_counts_and_bundles_as_jax(mosaic_pools, tmp_path):
    """Record 0 is NaN: its batch's step is skipped with the JAX
    ``nonfinite_grads``; with the abort threshold at 1 both runs raise
    and write a bundle with the same files."""
    jax_events.configure(str(tmp_path / "jax"))
    events.configure(str(tmp_path / "port"))
    jo, po = _pair(4, 1, poison=0, abort_after=1)
    _run(jo, seed=5, expect=JaxNonFinite)
    _run(po, expect=NonFiniteGradError)
    js = _of(jax_events.read_events(jax_events.get().path), "step")
    ps = _of(events.read_events(events.get().path), "step")
    assert [e["step"] for e in ps] == [e["step"] for e in js]
    bad_j = [e["taps"]["nonfinite_grads"] for e in js]
    bad_p = [e["taps"]["nonfinite_grads"] for e in ps]
    assert bad_p == bad_j and max(bad_p) > 0
    for e in ps:
        assert e["taps"]["update_ratio"] == 0.0 or \
            e["taps"]["nonfinite_grads"] == 0
    port_evs = events.read_events(events.get().path)
    abort, = _of(port_evs, "abort")
    jabort, = _of(jax_events.read_events(jax_events.get().path), "abort")
    assert (abort["step"], abort["reason"]) == (jabort["step"],
                                               jabort["reason"])
    bundle, = _of(port_evs, "crash_bundle")
    jbundle, = _of(jax_events.read_events(jax_events.get().path),
                   "crash_bundle")
    assert set(os.listdir(bundle["path"])) == \
        set(os.listdir(jbundle["path"])) == BUNDLE
    import json
    with open(os.path.join(bundle["path"], "config.json")) as f:
        cfg = json.load(f)
    assert cfg["world_size"] == 1 and "torch" in cfg
    with open(os.path.join(bundle["path"], "memory.json")) as f:
        assert json.load(f) == {"cpu": None}
    for e in events.read_events(os.path.join(bundle["path"],
                                             "events.jsonl")):
        jax_events.validate_event(e)


@pytest.mark.parametrize("seed,bad", [(0, False), (1, False), (2, True)])
def test_compute_matches_jax(seed, bad):
    rs = np.random.RandomState(seed)
    shapes = [(6, 5), (7,), (3, 2, 4), (1,)]
    g = [rs.randn(*s).astype(np.float32) for s in shapes]
    p = [rs.randn(*s).astype(np.float32) for s in shapes]
    q = [a - 0.01 * b for a, b in zip(p, g)]
    if bad:
        g[1][3] = np.nan
        g[2][0, 1, 2] = np.inf
    want = jax_taps.compute(g, p, q)
    got = taps.compute(*[[torch.from_numpy(a) for a in t]
                         for t in (g, p, q)])
    for k in taps.TAP_NAMES:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   **TAP_TOL)


@pytest.mark.parametrize("mom,wd,damp,nesterov,scaled,finite", [
    (0.0, 0.0, 0.0, False, False, True),
    (0.9, 1e-4, 0.9, False, False, True),
    (0.9, 5e-4, 0.0, True, False, True),
    (0.9, 0.0, 0.1, False, True, True),
    (0.9, 1e-4, 0.9, False, False, False),
])
def test_taps_form_plain_version_against_float64(mom, wd, damp, nesterov,
                                                 scaled, finite):
    """The plain version of ``fused_sgd``'s taps form: p' and v' are the
    bits of the form without taps, and the four sums are the float64
    sums of what it read and wrote (p' = p on a non-finite step)."""
    rs = np.random.RandomState(3)
    shapes = [(5, 3), (4099,), (1,), (2, 3, 7)]
    p0 = [rs.randn(*s).astype(np.float32) for s in shapes]
    g = [rs.randn(*s).astype(np.float32) for s in shapes]
    v0 = [rs.randn(*s).astype(np.float32) for s in shapes]
    sc = ([rs.rand(*s).astype(np.float32) for s in shapes] if scaled
          else None)
    runs = []
    for with_taps in (False, True):
        P = [torch.from_numpy(a.copy()) for a in p0]
        V = [torch.from_numpy(a.copy()) for a in v0]
        buf = taps.new_sums("cpu") if with_taps else None
        ops.fused_sgd(P, [torch.from_numpy(a) for a in g], V, 0.05,
                      momentum=mom, weight_decay=wd, dampening=damp,
                      nesterov=nesterov, finite=torch.tensor(finite),
                      scales=None if sc is None else
                      [torch.from_numpy(a) for a in sc], taps=buf)
        runs.append((P, V, buf))
    (P1, V1, _), (P2, V2, buf) = runs
    for a, b in zip(P1 + V1, P2 + V2):
        assert torch.equal(a, b)
    f64 = lambda xs: [x.astype(np.float64) for x in xs]   # noqa: E731
    pn = [a.numpy().astype(np.float64) for a in P2]
    want = [sum((x ** 2).sum() for x in f64(g)),
            sum((x ** 2).sum() for x in f64(p0)),
            sum(((b - a) ** 2).sum() for a, b in zip(f64(p0), pn)),
            0.0]
    np.testing.assert_allclose(buf.numpy(), want, rtol=1e-5, atol=1e-12)
    if not finite:
        assert buf[2] == 0
    assert ops.launch_counts()["fused_sgd_taps"] == 0    # the CPU


def test_taps_form_counts_non_finite_gradients():
    g = torch.tensor([1.0, float("nan"), float("inf"), -float("inf"), 2.0])
    p = torch.ones(5)
    buf = taps.new_sums("cpu")
    ops.fused_sgd([p], [g], [torch.zeros(5)], 0.1,
                  finite=torch.tensor(False), taps=buf)
    assert float(buf[3]) == 3.0 and float(buf[1]) == 5.0
    assert float(buf[2]) == 0.0 and torch.equal(p, torch.ones(5))
    with pytest.raises(ValueError, match="taps must be"):
        ops.fused_sgd([p], [g], [torch.zeros(5)], 0.1,
                      taps=torch.zeros(4, dtype=torch.float32))


def test_the_capture_key_holds_the_taps_flag():
    params = [torch.zeros(3, requires_grad=True)]
    params[0].grad = torch.zeros(3)
    model = torch.nn.Module()
    x, y = torch.zeros(2, 4, 3), torch.zeros(2, 4)
    keys = {_capture_key(params, model, {"velocity": [torch.zeros(3)]}, x,
                         y, {"lr": 0.1}, on) for on in (False, True)}
    assert len(keys) == 2


def test_spans_are_profiler_ranges(mosaic_pools):
    """The phase spans run under ``record_function``: a profiler trace of
    a run holds the event log's phase names."""
    _, po = _pair(2, 1, validate=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _run(po)
    names = {e.name for e in prof.events()}
    assert {"data-load", "h2d", "dispatch", "host-wait",
            "validate"} <= names
    rows = {path for path, *_ in po.spans.rows()}
    assert {"data-load", "dispatch", "host-wait", "validate"} <= rows
    assert "span: dispatch" in po.metrics.summary()


def test_obs_off_writes_nothing(monkeypatch, tmp_path, mosaic_pools):
    monkeypatch.setenv("BIGDL_OBS", "0")
    monkeypatch.setenv("BIGDL_OBS_DIR", str(tmp_path))
    events.reset()
    _, po = _pair(2, 1, poison=0, abort_after=1)
    _run(po, expect=NonFiniteGradError)
    assert events.get() is None and os.listdir(tmp_path) == []


# -- two gloo ranks against the JAX DistriOptimizer on two CPU devices ---

def _distri_data():
    rs = np.random.RandomState(0)
    w = rs.randn(8, 4)
    xs = rs.randn(64, 8).astype(np.float32)
    return xs, (xs @ w).argmax(1) + 1.0


def _jax_mlp():
    set_seed(7)
    return jnn.Sequential(jnn.Linear(8, 17), jnn.ReLU(), jnn.Linear(17, 4),
                          jnn.LogSoftMax())


DISTRI = {"plain": {}, "zero1": {"zero1": True},
          "bf16": {"gradient_compression": "bf16"},
          "bf16_zero1": {"gradient_compression": "bf16", "zero1": True}}
DSTATE = {"learningRate": 0.1, "momentum": 0.9, "weightDecay": 1e-4}


def _jax_distri_taps(kw, iters=4):
    from bigdl_tpu.dataset import Sample as JaxSample
    from bigdl_tpu.dataset import SampleToBatch as JaxSampleToBatch
    xs, ys = _distri_data()
    model = _jax_mlp()
    ds = JaxDataSet.array([JaxSample(x, np.asarray([y]))
                           for x, y in zip(xs, ys)]) >> JaxSampleToBatch(32)
    opt = JaxDistriOptimizer(model, ds, jnn.ClassNLLCriterion(),
                             mesh=data_parallel_mesh(jax.devices()[:2]),
                             **kw)
    opt.set_state(JaxT(**DSTATE)).set_end_when(jax_max_iteration(iters))
    opt.set_taps(True, 1)
    set_seed(5)
    opt.optimize()
    return list(opt._taps_monitor.history)


@pytest.fixture(scope="module")
def world2_taps(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("obs_world2")
    xs, ys = _distri_data()
    init = jax.tree_util.tree_map(np.asarray, _jax_mlp().params())
    names = list(DISTRI) + ["abort"]
    specs = [dict(model="mlp17", init=init, xs=xs, ys=ys, batch=32, seed=5,
                  iters=4, state=DSTATE, kw=DISTRI.get(k, {}))
             for k in names]
    specs[-1].update(poison={1: 2}, abort_after=1)
    dirs = [str(tmp / k) for k in names]
    per_rank = launch(OW.taps_cases, 2, "gloo", args=(specs, dirs))
    return {k: [r[i] for r in per_rank] for i, k in enumerate(names)}


@pytest.mark.parametrize("mode", list(DISTRI))
def test_two_gloo_ranks_taps_match_jax(world2_taps, mode):
    want = _jax_distri_taps(DISTRI[mode])
    r0, r1 = world2_taps[mode]
    assert r0["taps"] == r1["taps"]          # every rank reads the same
    assert [s for s, _ in r0["taps"]] == [s for s, _ in want] == [1, 2, 3, 4]
    for (_, got), (_, exp) in zip(r0["taps"], want):
        for k in taps.TAP_NAMES:
            np.testing.assert_allclose(got[k], exp[k], **TAP_TOL,
                                       err_msg=f"{mode} {k}")
    for r in (r0, r1):
        evs = events.read_events(r["path"])
        assert os.path.basename(r["path"]) == f"events.p{r['rank']}.jsonl"
        for e in evs:
            jax_events.validate_event(e)
        assert [e["step"] for e in _of(evs, "step")] == [1, 2, 3, 4]
    # the spans' top-level phases gathered from both ranks at the run's end
    header, *rows = r0["per_host"].splitlines()
    assert header.split() == ["phase", "host0", "host1"]
    assert [row.split()[0] for row in rows] == list(obs.PHASES)


def test_two_gloo_ranks_abort_with_a_bundle_each(world2_taps):
    """Rank 1's input is NaN at step 2: the skip agrees over the ranks,
    each rank's taps count the reduced gradient's non-finite elements,
    and with the threshold at 1 every rank aborts with its bundle."""
    for r in world2_taps["abort"]:
        assert r["error"] == "NonFiniteGradError"
        # both ranks' bundles land in the shared run directory
        assert len(r["bundles"]) == 2
        assert any(f"-p{r['rank']}-" in b for b in r["bundles"])
        evs = events.read_events(r["path"])
        abort, = _of(evs, "abort")
        assert abort["step"] == 3
        steps = _of(evs, "step")
        assert steps[-1]["taps"]["nonfinite_grads"] > 0
        assert steps[-1]["taps"]["update_ratio"] == 0.0
