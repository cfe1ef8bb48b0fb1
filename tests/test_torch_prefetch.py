"""The port's background input pipeline (``bigdl_tpu_torch.dataset
.prefetch``) on the CPU, mirroring tests/test_prefetch.py: the loss
trajectory and final parameters are bit-identical with ``BIGDL_PREFETCH``
on and off (one and two iterations a dispatch, with dropout, across epoch
shuffles, and through random crops and flips); the runner matches the
serial iterator, gives the stream back at close as of the last consumed
batch, raises its producer's error, keeps the order through the worker
fan-out; ``stack_chunk`` checks shapes; validation rides a background
thread with the serial results."""
import threading

import numpy as np
import pytest
import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset import (DataSet, HFlip, ImgNormalizer,
                                     ImgRdmCropper, ImgToBatch, LabeledImage,
                                     MiniBatch, Sample, SampleToBatch)
from bigdl_tpu_torch.dataset import prefetch as pf
from bigdl_tpu_torch.dataset.transformer import Transformer
from bigdl_tpu_torch.optim import (LocalOptimizer, Top1Accuracy,
                                   max_iteration, validate)
from bigdl_tpu_torch.utils.random import RNG, generator
from bigdl_tpu_torch.utils.table import T


def _samples(n=24, d=5, seed=0):
    rs = np.random.RandomState(seed)
    xs = rs.randn(n, d).astype(np.float32)
    ys = (rs.randint(0, 3, n) + 1).astype(np.float32)
    return [Sample(x, np.asarray([y])) for x, y in zip(xs, ys)]


def _grey_images(n=16, hw=8, seed=1):
    rs = np.random.RandomState(seed)
    return [LabeledImage(rs.rand(hw, hw).astype(np.float32),
                         float(i % 3 + 1)) for i in range(n)]


def _params_vec(model):
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()])


def _mlp(dropout, d=5):
    g = generator(4)
    layers = [nn.Linear(d, 8, generator=g), nn.Tanh()]
    if dropout:
        layers.append(nn.Dropout(0.5))
    layers += [nn.Linear(8, 3, generator=g), nn.LogSoftMax()]
    return nn.Sequential(*layers)


def _run_mlp(monkeypatch, on, n_disp=1, steps=8, dropout=False):
    monkeypatch.setenv(pf.ENV_PREFETCH, "1" if on else "0")
    RNG.set_seed(5)
    ds = DataSet.array(_samples(), seed=5) >> SampleToBatch(8)
    opt = LocalOptimizer(_mlp(dropout), ds, nn.ClassNLLCriterion(),
                         device="cpu")
    opt.set_state(T(learningRate=0.2, momentum=0.9))
    opt.set_iterations_per_dispatch(n_disp)
    opt.set_end_when(max_iteration(steps)).optimize()
    return opt.loss_log, _params_vec(opt.model), opt


@pytest.mark.parametrize("n_disp", [1, 2])
def test_local_trajectory_parity(monkeypatch, n_disp):
    """8 iterations over a 24-sample epoch (3 steps an epoch): the run
    crosses epoch shuffles with dropout masks drawn."""
    l_on, p_on, opt = _run_mlp(monkeypatch, True, n_disp, dropout=True)
    l_off, p_off, _ = _run_mlp(monkeypatch, False, n_disp, dropout=True)
    assert len(l_on) == 8
    assert l_on == l_off
    assert torch.equal(p_on, p_off)
    assert opt.state["epoch"] == 3


def _run_image(monkeypatch, on, steps=7):
    """Random crop and flip draw from the dataset's stream record by
    record (16 images in batches of 8: 7 steps cross three shuffles)."""
    monkeypatch.setenv(pf.ENV_PREFETCH, "1" if on else "0")
    ds = (DataSet.array(_grey_images(), seed=5) >> ImgRdmCropper(6, 6)
          >> HFlip() >> ImgToBatch(8))
    model = nn.Sequential(nn.Reshape([36]), nn.Linear(36, 3,
                                                      generator=generator(1)),
                          nn.LogSoftMax())
    opt = LocalOptimizer(model, ds, nn.ClassNLLCriterion(), device="cpu")
    opt.set_state(T(learningRate=0.1)).set_end_when(max_iteration(steps))
    opt.optimize()
    return opt.loss_log, _params_vec(model), (ds.rng.get_state(),
                                              pf.decompose(ds)[0].order)


def test_random_image_pipeline_parity(monkeypatch):
    l_on, p_on, _ = _run_image(monkeypatch, True)
    l_off, p_off, _ = _run_image(monkeypatch, False)
    assert len(l_on) == 7
    assert l_on == l_off
    assert torch.equal(p_on, p_off)


def test_stream_after_run_matches_serial(monkeypatch):
    """close() leaves the dataset's stream and its records' order where a
    serial run leaves them: the draws and epoch shuffles of batches
    prefetched but never consumed are undone."""
    *_, (s_on, o_on) = _run_image(monkeypatch, True, steps=5)
    *_, (s_off, o_off) = _run_image(monkeypatch, False, steps=5)
    np.testing.assert_array_equal(s_on[1], s_off[1])
    assert s_on[2] == s_off[2]
    np.testing.assert_array_equal(o_on, o_off)


def test_runner_matches_serial_iterator():
    ds = DataSet.array(_samples(n=32), seed=11) >> SampleToBatch(8)
    serial = [np.array(b.data) for b, _ in zip(ds.data(train=True),
                                                range(6))]
    ds = DataSet.array(_samples(n=32), seed=11) >> SampleToBatch(8)
    runner = pf.PipelineRunner(ds, train=True)
    got = [np.array(runner.get()[0].x) for _ in range(6)]
    runner.close()
    for a, b in zip(serial, got):
        np.testing.assert_array_equal(a, b)


def _image_set(seed=13):
    return (DataSet.array(_grey_images(n=16), seed=seed)
            >> ImgRdmCropper(6, 6) >> HFlip() >> ImgToBatch(8))


def test_close_restores_the_consumed_stream():
    ds = _image_set()
    it = ds.data(train=True)
    for _ in range(3):
        next(it)
    serial = ds.rng.get_state()
    ds = _image_set()
    runner = pf.PipelineRunner(ds, train=True, epoch_size=10 ** 9)
    for _ in range(3):
        runner.get()
    assert RNG.stream_owner(ds.rng) == runner._producer.ident
    runner.close()
    got = ds.rng.get_state()
    np.testing.assert_array_equal(serial[1], got[1])
    assert serial[2] == got[2]
    assert RNG.stream_owner(ds.rng) is None


def test_the_main_thread_may_not_draw_while_the_producer_owns():
    ds = _image_set()
    runner = pf.PipelineRunner(ds, train=True, epoch_size=10 ** 9)
    try:
        runner.get()
        with pytest.raises(RuntimeError, match="owns"):
            ds.shuffle()
    finally:
        runner.close()
    ds.shuffle()   # given back


class _Boom(Transformer):
    def __call__(self, iterator):
        for _ in iterator:
            raise RuntimeError("decode failed")
            yield


def test_producer_error_propagates():
    ds = DataSet.array(_samples()) >> _Boom() >> SampleToBatch(8)
    runner = pf.PipelineRunner(ds, train=True, epoch_size=24)
    with pytest.raises(RuntimeError, match="decode failed"):
        runner.get()
    runner.close()


class _Scale(Transformer):
    """A pure per-record stage that records the threads it ran on."""

    pure_per_record = True

    def __init__(self):
        self.threads = set()

    def __call__(self, iterator):
        for img in iterator:
            self.threads.add(threading.get_ident())
            yield LabeledImage(img.data * 2.0, img.label)


def test_worker_fanout_keeps_order_and_trajectory():
    """The pure stage fans out to the workers; the record order and the
    stochastic stages' draws are those of one producer."""
    def run(n_workers):
        scale = _Scale()
        ds = (DataSet.array(_grey_images(n=16), seed=17) >> scale
              >> ImgNormalizer(0.5, 2.0) >> ImgRdmCropper(6, 6) >> HFlip()
              >> ImgToBatch(8))
        runner = pf.PipelineRunner(ds, train=True, epoch_size=16,
                                   n_workers=n_workers)
        out = [np.array(runner.get()[0].x) for _ in range(5)]
        producer = runner._producer.ident
        runner.close()
        return out, scale.threads - {producer}

    fanout, worker_threads = run(4)
    serial, none = run(0)
    assert worker_threads and not none
    for a, b in zip(serial, fanout):
        np.testing.assert_array_equal(a, b)


def test_stack_chunk_checks_shapes():
    a = MiniBatch(np.ones((4, 3), np.float32), np.ones((4,)))
    b = MiniBatch(np.zeros((4, 3), np.float32), np.zeros((4,)))
    xs, ys = pf.stack_chunk([a, b])
    assert xs.shape == (2, 4, 3) and ys.shape == (2, 4)
    bad = MiniBatch(np.ones((5, 3), np.float32), np.ones((5,)))
    with pytest.raises(ValueError, match="uniform batch shapes"):
        pf.stack_chunk([a, bad])


def test_background_is_one_pass_in_order():
    ds = DataSet.array(_samples(n=20)) >> SampleToBatch(8)
    serial = [np.array(b.data) for b in ds.data(train=False)]
    got = [np.array(b.data) for b in pf.background(ds.data(train=False), 2)]
    assert len(got) == len(serial) == 3
    for a, b in zip(serial, got):
        np.testing.assert_array_equal(a, b)


def test_validate_results_match_serial(monkeypatch):
    ds = DataSet.array(_samples(n=40)) >> SampleToBatch(8)
    model = _mlp(False)

    def run(on):
        monkeypatch.setenv(pf.ENV_PREFETCH, "1" if on else "0")
        (_, r), = validate(model, ds, [Top1Accuracy()], "cpu")
        return r.correct, r.count

    assert run(True) == run(False)


def test_stage_attributes():
    assert ImgNormalizer(0.0, 1.0).pure_per_record
    assert not ImgNormalizer(0.0, 1.0).stochastic
    for t in (HFlip(), ImgRdmCropper(2, 2)):
        assert t.stochastic and not t.pure_per_record
    assert pf.has_stochastic_stage(_image_set())
    assert not pf.has_stochastic_stage(
        DataSet.array(_samples()) >> SampleToBatch(8))


@pytest.mark.parametrize("raw,on,depth", [
    (None, False, 2), ("0", False, 2), ("1", True, 2), ("4", True, 4),
    ("x", True, 2)])
def test_switches(monkeypatch, raw, on, depth):
    if raw is None:
        monkeypatch.delenv(pf.ENV_PREFETCH, raising=False)
    else:
        monkeypatch.setenv(pf.ENV_PREFETCH, raw)
    assert pf.enabled() is on
    assert pf.depth() == depth
    monkeypatch.setenv(pf.ENV_WORKERS, "3")
    assert pf.workers() == 3
