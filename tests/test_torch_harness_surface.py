"""The rest of the training harness's surface on the CPU, each against the
JAX package: ``utils/log.py``; ``SampleToBatch(reuse_buffers=,
global_batch_size=)`` (the global batch over more than one rank is in
tests/test_torch_distri_harness.py); ``EvaluateMethods``; the package
exports (every name of the JAX ``__all__``s of ``utils``, ``models``,
``dataset`` and ``optim`` exists in the port, or waits for a named
queue item of ROADMAP.md); and the port of tests/test_training.py::
TestBiLSTMClassifier::test_bilstm_learns_synthetic_text (:147-168): the
same seed, data and bar (top-1 above 0.6, chance 1/3).
"""
import logging

import numpy as np
import pytest
import torch

import bigdl_tpu.dataset as jdataset
import bigdl_tpu.models as jmodels
import bigdl_tpu.optim as joptim
import bigdl_tpu.utils as jutils
from bigdl_tpu.dataset import Sample as JaxSample
from bigdl_tpu.dataset import SampleToBatch as JaxSampleToBatch
from bigdl_tpu.optim import EvaluateMethods as JaxEvaluateMethods
from bigdl_tpu.utils import log as jlog
import bigdl_tpu_torch.dataset as pdataset
import bigdl_tpu_torch.models as pmodels
import bigdl_tpu_torch.optim as poptim
import bigdl_tpu_torch.utils as putils
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToBatch
from bigdl_tpu_torch.optim import (EvaluateMethods, LocalOptimizer,
                                   Top1Accuracy, max_epoch, validate)
from bigdl_tpu_torch.utils import log as plog
from bigdl_tpu_torch.utils.random import set_seed
from bigdl_tpu_torch.utils.table import T

# names of the JAX __all__s the port does not export yet, each with the
# ROADMAP.md queue item it waits for
WAITING = {
    "utils": {},
    "optim": {"Predictor": "item 7.6", "DLClassifier": "item 7.6"},
    "dataset": {},
    "models": {},
}
PACKAGES = {"utils": (jutils, putils), "models": (jmodels, pmodels),
            "dataset": (jdataset, pdataset), "optim": (joptim, poptim)}


@pytest.mark.parametrize("name", sorted(PACKAGES))
def test_every_jax_export_exists_in_the_port(name):
    jax_pkg, port_pkg = PACKAGES[name]
    waiting = WAITING[name]
    missing = [n for n in jax_pkg.__all__
               if not hasattr(port_pkg, n) and n not in waiting]
    assert missing == []
    # a name that now exists leaves the waiting list
    assert [n for n in waiting if hasattr(port_pkg, n)] == []
    assert set(waiting) <= set(jax_pkg.__all__)
    assert all(n in port_pkg.__all__ for n in jax_pkg.__all__
               if n not in waiting)


def test_harness_imports():
    from bigdl_tpu_torch.optim import (LBFGS, Adagrad, DistriValidator,
                                       LocalValidator, Validator,
                                       distri_validate)
    assert issubclass(LocalValidator, Validator)
    assert issubclass(DistriValidator, Validator)
    assert callable(distri_validate)
    assert Adagrad and LBFGS


# -- log.py -----------------------------------------------------------------

@pytest.fixture()
def warn_caches():
    plog.reset_warn_cache()
    jlog.reset_warn_cache()
    yield
    plog.reset_warn_cache()
    jlog.reset_warn_cache()


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


@pytest.mark.parametrize("env", [{}, {"BIGDL_WARN_INTERVAL": "0"},
                                 {"BIGDL_WARN_INTERVAL_X_Y": "1000"},
                                 {"BIGDL_WARN_INTERVAL": "soon"}],
                         ids=["default", "global", "per-logger", "bad"])
def test_warn_every_and_warn_interval_match_jax(env, warn_caches,
                                                monkeypatch):
    """Five warnings of one key in a row: the same ones go out in both
    packages, under the interval's environment overrides."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    out = {}
    for pkg, mod in (("jax", jlog), ("port", plog)):
        logger = logging.getLogger("x.y")
        h = _Lines()
        logger.addHandler(h)
        try:
            sent = [mod.warn_every(logger, "k", 60.0, "step %d", i)
                    for i in range(5)]
            interval = mod.warn_interval(logger, 60.0)
        finally:
            logger.removeHandler(h)
        out[pkg] = (sent, interval, h.lines)
    assert out["port"] == out["jax"]
    plog.reset_warn_cache()
    assert plog.warn_every(logging.getLogger("x.y"), "k", 60.0, "again")


def test_init_logging_and_header_match_jax(tmp_path):
    path = str(tmp_path / "run.log")
    logger = plog.init_logging(logging.DEBUG, path)
    try:
        again = plog.init_logging(logging.DEBUG, path)
        assert again is logger and logger.name == "bigdl_tpu_torch"
        assert len(logger.handlers) == 2 and logger.level == logging.DEBUG
        logging.getLogger("bigdl_tpu_torch.optim").info("hello")
        for h in logger.handlers:
            h.flush()
        assert "INFO bigdl_tpu_torch.optim: hello" in open(path).read()
    finally:
        for h in list(logger.handlers):
            logger.removeHandler(h)
            h.close()
        logger.setLevel(logging.NOTSET)
    assert plog.header(2, 64, 128, 9, 1.5) == jlog.header(2, 64, 128, 9,
                                                          1.5)


# -- SampleToBatch ----------------------------------------------------------

def _records(n=10, seed=0, ragged=False):
    rs = np.random.RandomState(seed)
    return [(rs.randn(3 + (i % 3 if ragged else 0), 2).astype(np.float32),
             np.asarray([i % 4 + 1.0], np.float32)) for i in range(n)]


@pytest.mark.parametrize("case", [
    dict(batch_size=4, reuse_buffers=3),
    dict(batch_size=4, reuse_buffers=2, drop_last=True),
    dict(batch_size=3, reuse_buffers=2, feature_padding=0.0,
         fixed_length=5, ragged=True),
    dict(batch_size=3, reuse_buffers=2, feature_padding=-1.0, ragged=True),
    dict(global_batch_size=4),
    dict(global_batch_size=3, reuse_buffers=2)],
    ids=["ring", "ring-drop", "ring-padded", "padded-unfixed", "global",
         "global-ring"])
def test_sample_to_batch_matches_jax(case):
    """Every batch equals the JAX transformer's, copied as it comes (a
    ring's batch is valid until N - 1 more are drawn); with a ring the
    batches live in its N buffers."""
    case = dict(case)
    ragged = case.pop("ragged", False)
    recs = _records(ragged=ragged)
    jb = [(b.data.copy(), b.labels.copy()) for b in JaxSampleToBatch(**case)(
        JaxSample(x, y) for x, y in recs)]
    port = SampleToBatch(**case)
    got, ids = [], set()
    for b in port(Sample(x, y) for x, y in recs):
        got.append((b.data.copy(), b.labels.copy()))
        ids.add(id(b.data))
    assert len(got) == len(jb)
    for (a, b), (c, d) in zip(got, jb):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    n = case.get("reuse_buffers", 0)
    if n and not (case.get("feature_padding") is not None
                  and case.get("fixed_length") is None):
        whole = [g for g in got if g[0].shape[0] == got[0][0].shape[0]]
        assert len(ids) <= n + (len(got) - len(whole))


def test_sample_to_batch_refusals_are_the_jax_words():
    for kw in ({"batch_size": 4, "reuse_buffers": 1}, {},
               {"batch_size": 4, "global_batch_size": 8}):
        with pytest.raises(ValueError) as want:
            JaxSampleToBatch(**kw)
        with pytest.raises(ValueError) as got:
            SampleToBatch(**kw)
        assert str(got.value) == str(want.value)
    # a global batch the world does not divide raises when a pass starts
    from bigdl_tpu_torch.dataset.dataset import get_batch_size
    with pytest.raises(ValueError, match="cannot be divided"):
        get_batch_size(3, 2)


# -- EvaluateMethods --------------------------------------------------------

def test_evaluate_methods_match_jax():
    rs = np.random.RandomState(3)
    out = rs.randn(20, 7).astype(np.float32)
    tgt = (rs.randint(0, 7, 20) + 1).astype(np.float32)
    for name in ("calc_accuracy", "calc_top5_accuracy"):
        want = getattr(JaxEvaluateMethods, name)(out, tgt)
        assert getattr(EvaluateMethods, name)(out, tgt) == want
        assert getattr(EvaluateMethods, name)(torch.from_numpy(out),
                                              torch.from_numpy(tgt)) == want
    assert EvaluateMethods.calc_accuracy(out[0], tgt[:1]) == \
        JaxEvaluateMethods.calc_accuracy(out[0], tgt[:1])


# -- the Bi-LSTM classifier learns -----------------------------------------

def test_bilstm_learns_synthetic_text():
    """tests/test_training.py:147-168 on the port: the same seed and
    data (three classes, T 20, embedding 8, hidden 16), six epochs of SGD
    at lr 0.1 and momentum 0.9, top-1 on the held-out 30 above 0.6."""
    from bigdl_tpu_torch.models.textclassifier import TextClassifierBiLSTM

    set_seed(3)
    rng = np.random.RandomState(0)
    classes, seq, embed = 3, 20, 8
    means = rng.randn(classes, embed) * 1.5
    samples = []
    for i in range(180):
        c = i % classes
        doc = (rng.randn(seq, embed) * 0.5 + means[c]).astype(np.float32)
        samples.append(Sample(doc, np.asarray([c + 1.0])))
    train = DataSet.array(samples[:150]) >> SampleToBatch(30, drop_last=True)
    val = DataSet.array(samples[150:]) >> SampleToBatch(30, drop_last=True)
    model = TextClassifierBiLSTM(classes, embed, hidden_size=16,
                                 device="cpu")
    opt = LocalOptimizer(model, train, nn.ClassNLLCriterion(), device="cpu")
    opt.set_state(T(learningRate=0.1, momentum=0.9))
    opt.set_end_when(max_epoch(6))
    trained = opt.optimize()
    res = validate(trained, val, [Top1Accuracy()], "cpu")
    assert res[0][1].result()[0] > 0.6  # chance = 1/3
