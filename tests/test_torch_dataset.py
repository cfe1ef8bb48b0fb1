"""The port's host side of training against the JAX package's: MNIST
synthetic data, the ``ImgNormalizer >> ImgToBatch`` batches, the epoch
order of ``DataSet.array``, ``SampleToBatch``, the triggers, the state
``Table`` and the learning-rate schedules.  All numpy or plain Python on
both sides, so every comparison is exact.
"""
import numpy as np
import pytest

from bigdl_tpu.dataset import DataSet as JaxDataSet
from bigdl_tpu.dataset import Sample as JaxSample
from bigdl_tpu.dataset import SampleToBatch as JaxSampleToBatch
from bigdl_tpu.dataset import mnist as jax_mnist
from bigdl_tpu.dataset.image import ImgNormalizer as JaxNormalizer
from bigdl_tpu.dataset.image import ImgToBatch as JaxToBatch
from bigdl_tpu.optim import optim_method as jax_om
from bigdl_tpu.optim import trigger as jax_trigger
from bigdl_tpu.utils.random import set_seed
from bigdl_tpu.utils.table import T as JaxT
from bigdl_tpu_torch.dataset import (DataSet, ImgNormalizer, ImgToBatch,
                                     Sample, SampleToBatch, mnist)
from bigdl_tpu_torch.optim import Metrics
from bigdl_tpu_torch.optim import optim_method as om
from bigdl_tpu_torch.optim import trigger
from bigdl_tpu_torch.utils.table import T


def _batches(ds):
    return [(b.data, b.labels) for b in ds.data(train=False)]


def test_mnist_synthetic_and_constants_equal():
    want = jax_mnist.synthetic(20, seed=3)
    got = mnist.synthetic(20, seed=3)
    assert len(got) == 20
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.data, b.data)
        assert a.label == b.label and 1.0 <= a.label <= 10.0
    assert (mnist.TRAIN_MEAN, mnist.TRAIN_STD, mnist.TEST_MEAN,
            mnist.TEST_STD) == (jax_mnist.TRAIN_MEAN, jax_mnist.TRAIN_STD,
                                jax_mnist.TEST_MEAN, jax_mnist.TEST_STD)


def test_normalized_batches_equal_and_records_untouched():
    """The first pass gives the JAX batches bit for bit (NCHW, 1-based
    float labels, a partial tail batch); a second pass gives the same
    again, because the port's normalizer leaves the records as they
    were."""
    def chain(pkg):
        if pkg == "jax":
            return (JaxDataSet.array(jax_mnist.synthetic(10, 0))
                    >> JaxNormalizer(jax_mnist.TRAIN_MEAN, jax_mnist.TRAIN_STD)
                    >> JaxToBatch(4))
        return (DataSet.array(mnist.synthetic(10, 0))
                >> ImgNormalizer(mnist.TRAIN_MEAN, mnist.TRAIN_STD)
                >> ImgToBatch(4))

    want, port = _batches(chain("jax")), chain("torch")
    got = _batches(port)
    assert [x.shape for x, _ in got] == [(4, 1, 28, 28)] * 2 + [(2, 1, 28, 28)]
    for (x, y), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(x, wx)
        np.testing.assert_array_equal(y, wy)
        assert y.dtype == np.float32
    for (x, y), (x2, y2) in zip(got, _batches(port)):
        np.testing.assert_array_equal(x, x2)


def test_epoch_order_equals_jax_after_set_seed():
    """Two epochs as LocalOptimizer walks them: draw an epoch from the
    looped iterator, shuffle the records, start a new iterator."""
    def walk(ds, n):
        out, it = [], ds.data(train=True)
        for _ in range(2):
            out += [next(it) for _ in range(n)]
            ds.shuffle()
            it = ds.data(train=True)
        return out

    set_seed(7)
    want = walk(JaxDataSet.array(list(range(11))), 11)
    got = walk(DataSet.array(list(range(11)), seed=7), 11)
    assert got == want
    assert sorted(got[:11]) == list(range(11)) and got[:11] != got[11:]
    assert list(DataSet.array(range(5)).data(train=False)) == list(range(5))


@pytest.mark.parametrize("kw", [
    dict(batch_size=3),
    dict(batch_size=3, drop_last=True),
    dict(batch_size=2, feature_padding=-1.0, label_padding=0.0),
    dict(batch_size=2, feature_padding=0.0, fixed_length=6),
])
def test_sample_to_batch_equals_jax(kw):
    rs = np.random.RandomState(0)
    lens = [3, 5, 2, 4, 5] if "feature_padding" in kw else [4] * 5
    recs = [(rs.randn(n, 2).astype(np.float32),
             np.full((n if "label_padding" in kw else 1,), i + 1.0,
                     np.float32)) for i, n in enumerate(lens)]
    want = _batches(JaxDataSet.array([JaxSample(*r) for r in recs])
                    >> JaxSampleToBatch(**kw))
    got = _batches(DataSet.array([Sample(*r) for r in recs])
                   >> SampleToBatch(**kw))
    assert len(got) == len(want)
    for (x, y), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(x, wx)
        np.testing.assert_array_equal(y, wy)


def test_triggers_fire_on_the_same_states():
    states = [dict(epoch=e, neval=n, loss=l) for e, n, l in
              [(1, 1, 3.0), (1, 2, 2.0), (1, 3, 1.0), (2, 4, 0.5),
               (2, 5, 0.4), (2, 6, 0.3), (3, 7, 0.2), (3, 9, 0.1)]]
    pairs = [(jax_trigger.every_epoch(), trigger.every_epoch()),
             (jax_trigger.several_iteration(3), trigger.several_iteration(3)),
             (jax_trigger.max_epoch(2), trigger.max_epoch(2)),
             (jax_trigger.max_iteration(5), trigger.max_iteration(5)),
             (jax_trigger.min_loss(0.45), trigger.min_loss(0.45))]
    pairs.append((jax_trigger.and_trigger(pairs[1][0], pairs[2][0]),
                  trigger.and_trigger(pairs[1][1], pairs[2][1])))
    pairs.append((jax_trigger.or_trigger(pairs[3][0], pairs[4][0]),
                  trigger.or_trigger(pairs[3][1], pairs[4][1])))
    for jt, pt in pairs:
        want = [jt(JaxT(**s)) for s in states]
        assert [pt(T(**s)) for s in states] == want, repr(pt)
        assert any(want)


def test_table_equals_jax():
    j, p = JaxT("a", "b", lr=0.1), T("a", "b", lr=0.1)
    for t in (j, p):
        t.insert("c")
        t.insert(1, "z")
        t.remove(2)
        t.get_or_update("epoch", 1)
    assert list(p) == list(j) == ["z", "b", "c"]
    assert dict(p.items()) == dict(j.items())
    assert p.length() == j.length() == 3


@pytest.mark.parametrize("name,args", [
    ("Default", ()), ("Step", (3, 0.5)), ("Poly", (0.5, 10)),
    ("EpochStep", (2, 0.1)), ("EpochDecay", (lambda e: e // 2,)),
])
def test_lr_schedules_equal_jax(name, args):
    for ev, ep in [(0, 1), (4, 2), (9, 3), (12, 5)]:
        cfg = dict(learningRate=0.05, learningRateDecay=0.01,
                   evalCounter=ev, epoch=ep)
        j, p = JaxT(**cfg), T(**cfg)
        getattr(jax_om, name)(*args).update_hyper_parameter(j, j)
        getattr(om, name)(*args).update_hyper_parameter(p, p)
        assert p["currentLearningRate"] == j["currentLearningRate"]
    if name in ("Default", "Step", "Poly"):
        for step in (0, 4, 11):
            assert (getattr(om, name)(*args).scale_at(step, T(**cfg))
                    == pytest.approx(float(getattr(jax_om, name)(
                        *args).scale_at(step, JaxT(**cfg)))))


def test_epoch_schedule_equals_jax():
    def regimes(mod, t):
        r = mod.EpochSchedule.Regime
        return mod.EpochSchedule([r(1, 2, t(learningRate=0.1)),
                                  r(3, 5, t(learningRate=0.01))])
    for ep in (1, 3, 6):
        j, p = JaxT(epoch=ep), T(epoch=ep)
        regimes(jax_om, JaxT).update_hyper_parameter(j, j)
        regimes(om, T).update_hyper_parameter(p, p)
        assert p["currentLearningRate"] == j["currentLearningRate"]


def test_metrics_timers():
    m = Metrics()
    m.add("train time", 0.5)
    m.add("train time", 1.5)
    with m.timer("fetch"):
        pass
    assert m.mean("train time") == 1.0 and m.get("fetch")[1] == 1
    assert "train time : 1.0" in m.summary()


@pytest.mark.parametrize("gz", [False, True])
def test_mnist_load_equals_jax(tmp_path, gz):
    import gzip
    import struct

    rs = np.random.RandomState(8)
    imgs = rs.randint(0, 256, (5, 28, 28)).astype(np.uint8)
    labels = rs.randint(0, 10, 5).astype(np.uint8)
    suffix, opener = (".gz", gzip.open) if gz else ("", open)
    with opener(tmp_path / f"t10k-images-idx3-ubyte{suffix}", "wb") as f:
        f.write(struct.pack(">IIII", 2051, 5, 28, 28) + imgs.tobytes())
    with opener(tmp_path / f"t10k-labels-idx1-ubyte{suffix}", "wb") as f:
        f.write(struct.pack(">II", 2049, 5) + labels.tobytes())
    want = jax_mnist.load(str(tmp_path), training=False)
    got = mnist.load(str(tmp_path), training=False)
    assert [g.label for g in got] == [w.label for w in want] \
        == list(labels + 1.0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.data, w.data)
    with pytest.raises(FileNotFoundError):
        mnist.load(str(tmp_path), training=True)


@pytest.mark.parametrize("to_chw", [True, False])
def test_color_images_to_batch_equal_jax(to_chw):
    from bigdl_tpu.dataset.image import LabeledImage as JaxImage
    from bigdl_tpu_torch.dataset import LabeledImage

    rs = np.random.RandomState(9)
    recs = [(rs.rand(4, 5, 3).astype(np.float32), i + 1.0) for i in range(3)]
    mean, std = (0.4, 0.5, 0.6), (0.2, 0.25, 0.3)
    want = _batches(JaxDataSet.array([JaxImage(*r) for r in recs])
                    >> JaxNormalizer(mean, std) >> JaxToBatch(2, to_chw))
    got = _batches(DataSet.array([LabeledImage(*r) for r in recs])
                   >> ImgNormalizer(mean, std) >> ImgToBatch(2, to_chw))
    for (x, y), (wx, wy) in zip(got, want):
        np.testing.assert_allclose(x, wx, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(y, wy)
    assert got[0][0].shape == ((2, 3, 4, 5) if to_chw else (2, 4, 5, 3))


def _color_records(n=10, h=12, w=10, seed=0):
    rs = np.random.RandomState(seed)
    return [(rs.uniform(0, 255, (h, w, 3)).astype(np.float32),
             float(rs.randint(1, 11))) for _ in range(n)]


@pytest.mark.parametrize("padding", [0, 1])
def test_crop_flip_pipeline_equals_jax_first_pass(padding):
    """``DataSet.array(records, seed) >> ImgRdmCropper >> HFlip >>
    ImgNormalizer >> ImgToBatch`` gives, over its first pass, the JAX
    pipeline's batches after ``set_seed(seed)`` bit for bit: the epoch
    permutation, each record's two crop offsets and its flip draw come
    from one stream in the same order.  The records are left untouched
    (the JAX crop and flip rebind them, so its later passes differ)."""
    from bigdl_tpu.dataset.image import HFlip as JaxHFlip
    from bigdl_tpu.dataset.image import ImgRdmCropper as JaxCropper
    from bigdl_tpu.dataset.image import LabeledImage as JaxImage
    from bigdl_tpu_torch.dataset import HFlip, ImgRdmCropper, LabeledImage

    recs = _color_records()
    mean, std = (123.0, 117.0, 104.0), (1.0, 1.0, 1.0)
    set_seed(4)
    jax_ds = (JaxDataSet.array([JaxImage(d.copy(), lbl) for d, lbl in recs])
              >> JaxCropper(8, 6, padding) >> JaxHFlip()
              >> JaxNormalizer(mean, std) >> JaxToBatch(5))
    it = jax_ds.data(train=True)
    want = [next(it) for _ in range(2)]
    records = [LabeledImage(d.copy(), lbl) for d, lbl in recs]
    port = (DataSet.array(records, seed=4) >> ImgRdmCropper(8, 6, padding)
            >> HFlip() >> ImgNormalizer(mean, std) >> ImgToBatch(5))
    it = port.data(train=True)
    got = [next(it) for _ in range(2)]
    for b, w in zip(got, want):
        assert b.data.shape == (5, 3, 6, 8)
        np.testing.assert_array_equal(b.data, w.data)
        np.testing.assert_array_equal(b.labels, w.labels)
    for r, (d, lbl) in zip(records, recs):
        np.testing.assert_array_equal(r.data, d)
        assert r.data.shape == (12, 10, 3) and r.label == lbl


def test_random_stages_take_their_own_stream_or_the_datasets():
    """A stage's own ``rng`` wins over the dataset's; a stage with none,
    chained onto nothing, has no stream to draw from."""
    from bigdl_tpu_torch.dataset import HFlip, ImgRdmCropper, LabeledImage

    recs = [LabeledImage(d, lbl) for d, lbl in _color_records(4)]
    own = np.random.RandomState(3)
    crop = ImgRdmCropper(4, 4, rng=own)
    flip = HFlip(threshold=1.0)
    ds = DataSet.array(recs, seed=9) >> (crop >> flip)
    assert crop.rng is own and flip.rng is ds.rng is ds.base.rng
    out = list(ds.data(train=False))
    ref = np.random.RandomState(3)
    for img, rec in zip(out, recs):
        y0, x0 = ref.randint(0, 9), ref.randint(0, 7)
        np.testing.assert_array_equal(
            img.data, rec.data[y0:y0 + 4, x0:x0 + 4][:, ::-1])
    with pytest.raises(ValueError, match="no random stream"):
        list(HFlip()(iter(recs)))
