"""The port's checkpoints on the CPU (``utils/file.py``,
``optim/optimizer.py``, ``LocalOptimizer.set_checkpoint``): ports of
tests/test_training.py::TestLocalOptimizer::test_checkpoint_and_resume
and tests/test_prefetch.py::TestChaosAndResume::
test_resume_replays_serial_trajectory (with the negative control), the
fallback past corrupt snapshots, retention, and the format read across
packages both ways: a JAX checkpoint of a momentum LeNet-5 resumed by the
port and a port checkpoint resumed by the JAX package, each continued
three steps and held to the other package's run at the LeNet parity
tests' tolerance (rtol 1e-4, atol 1e-5: fp32 sums in another order)."""
import os

import jax
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.dataset import DataSet as JaxDataSet
from bigdl_tpu.dataset import mnist as jax_mnist
from bigdl_tpu.dataset.image import ImgNormalizer as JaxNormalizer
from bigdl_tpu.dataset.image import ImgToBatch as JaxToBatch
from bigdl_tpu.models.lenet import LeNet5 as JaxLeNet5
from bigdl_tpu.nn import pooling as jax_pooling
from bigdl_tpu.optim import SGD as JaxSGD
from bigdl_tpu.optim import LocalOptimizer as JaxLocalOptimizer
from bigdl_tpu.optim import load_latest_checkpoint as jax_load_latest
from bigdl_tpu.optim import max_iteration as jax_max_iteration
from bigdl_tpu.optim import several_iteration as jax_several_iteration
from bigdl_tpu.utils import file as JaxFile
from bigdl_tpu.utils.random import RNG as JaxRNG
from bigdl_tpu.utils.random import set_seed
from bigdl_tpu.utils.table import T as JaxT
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset import (DataSet, HFlip, ImgNormalizer,
                                     ImgRdmCropper, ImgToBatch, LabeledImage,
                                     Sample, SampleToBatch, mnist)
from bigdl_tpu_torch.dataset import prefetch as pf
from bigdl_tpu_torch.models.lenet import LeNet5
from bigdl_tpu_torch.nn.module import export_params, load_jax_params
from bigdl_tpu_torch.optim import (SGD, LocalOptimizer, list_checkpoints,
                                   load_latest_checkpoint, max_iteration,
                                   prune_checkpoints, several_iteration,
                                   snapshot_files, snapshot_valid)
from bigdl_tpu_torch.utils import file as File
from bigdl_tpu_torch.utils.random import RNG, generator
from bigdl_tpu_torch.utils.table import T, Table

TOL = dict(rtol=1e-4, atol=1e-5)


def make_classification(n=128, d=6, classes=3, seed=0):
    rng = np.random.RandomState(seed)
    w = rng.randn(d, classes) * 2
    xs = rng.randn(n, d).astype(np.float32)
    ys = (xs @ w + 0.1 * rng.randn(n, classes)).argmax(1) + 1.0
    return [Sample(x, np.asarray([y])) for x, y in zip(xs, ys)]


def linear_model(seed=2, d=6, classes=3):
    g = generator(seed)
    return nn.Sequential(nn.Linear(d, 16, generator=g), nn.Tanh(),
                         nn.Linear(16, classes, generator=g), nn.LogSoftMax())


def _params_vec(model):
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()])


def test_checkpoint_and_resume(tmp_path):
    ds = DataSet.array(make_classification(), seed=2) >> SampleToBatch(32)
    model = linear_model()
    opt = LocalOptimizer(model, ds, nn.ClassNLLCriterion(), device="cpu")
    opt.set_state(T(learningRate=0.2, momentum=0.9))
    opt.set_end_when(max_iteration(8))
    opt.set_checkpoint(str(tmp_path), several_iteration(4))
    opt.optimize()
    files = sorted(os.listdir(tmp_path))
    assert {"model.4", "state.4", "model.8", "state.8",
            "model.4.crc32", "state.8.crc32"} <= set(files)
    assert list_checkpoints(str(tmp_path)) == [8, 4]

    # into a fresh model: the params of the snapshot
    model2 = linear_model(seed=99)
    File.load_module_into(model2, str(tmp_path / "model.8"))
    blob = File.load(str(tmp_path / "state.8"))
    assert isinstance(blob["state"], Table)
    assert blob["neval"] == 8 and blob["state"]["neval"] >= 8
    assert set(blob["opt_state"]) == {"velocity"}
    assert set(blob["rng"]) >= {"seed", "generators", "np_state"}
    # the whole module back, architecture included
    rebuilt = File.load_module(str(tmp_path / "model.8"), device="cpu")
    assert type(rebuilt) is type(model)
    assert torch.equal(_params_vec(rebuilt), _params_vec(model2))
    # training goes on from the snapshot
    opt2 = LocalOptimizer(model2, ds, nn.ClassNLLCriterion(), device="cpu")
    opt2.set_state(T(learningRate=0.2, momentum=0.9,
                     neval=blob["state"]["neval"],
                     epoch=blob["state"]["epoch"]))
    opt2.set_optim_state(blob["opt_state"])
    opt2.set_end_when(max_iteration(blob["state"]["neval"] + 3))
    opt2.optimize()
    assert opt2.state["neval"] == blob["state"]["neval"] + 4


def _image_set(distinct):
    """16 grey images (copies of one, as the JAX test has them, or 16
    different ones: the checkpoint carries the records' shuffled order),
    normalised, cropped and flipped at random, one batch an epoch: every
    checkpoint lands on an epoch boundary."""
    rs = np.random.RandomState(2)
    img = rs.randint(0, 255, (8, 8)).astype(np.float32)
    records = [LabeledImage(rs.randint(0, 255, (8, 8)).astype(np.float32)
                            if distinct else img, 1.0 + k % 3 * distinct)
               for k in range(16)]
    return (DataSet.array(records, seed=7) >> ImgNormalizer(128.0, 128.0)
            >> ImgRdmCropper(6, 6) >> HFlip() >> ImgToBatch(16))


def _dropout_model():
    return nn.Sequential(nn.Reshape([36]), nn.Dropout(0.5),
                         nn.Linear(36, 3, generator=generator(3)),
                         nn.LogSoftMax())


@pytest.mark.parametrize("distinct", [False, True])
@pytest.mark.parametrize("prefetch", ["1", "0"])
def test_resume_replays_serial_trajectory(tmp_path, monkeypatch, prefetch,
                                          distinct):
    """The random payload is pinned to the last consumed batch: a resume
    replays the uninterrupted run, crops, flips, dropout masks and the
    records' order included; without the payload it forks."""
    monkeypatch.setenv(pf.ENV_PREFETCH, prefetch)
    RNG.set_seed(7)
    opt_a = LocalOptimizer(_dropout_model(), _image_set(distinct),
                           nn.ClassNLLCriterion(), device="cpu")
    opt_a.set_state(T(learningRate=0.05))
    opt_a.set_checkpoint(str(tmp_path), several_iteration(2))
    opt_a.set_end_when(max_iteration(5)).optimize()
    assert opt_a.state["loss"] > 0
    final = _params_vec(opt_a.model)
    # the newer snapshots (2, 4 and 6 were written) corrupt: the resume
    # falls back to 2, mid-run, where the prefetch had drawn ahead
    (tmp_path / "model.4").write_bytes(b"rot")
    (tmp_path / "model.6").write_bytes(b"rot")

    def resume(restore_rng):
        RNG.set_seed(12345 if restore_rng else 999)
        ds = _image_set(distinct)
        module, blob, neval = load_latest_checkpoint(
            str(tmp_path), restore_rng=restore_rng, device="cpu", dataset=ds)
        assert neval == 2
        opt_b = LocalOptimizer(module, ds, nn.ClassNLLCriterion(),
                               device="cpu")
        opt_b.set_state(blob["state"]).set_optim_state(blob["opt_state"])
        opt_b.set_end_when(max_iteration(5)).optimize()
        return _params_vec(opt_b.model)

    assert torch.equal(resume(restore_rng=True), final)
    assert not torch.equal(resume(restore_rng=False), final)


def _snapshots(tmp_path, every=2, steps=6):
    ds = DataSet.array(make_classification(), seed=2) >> SampleToBatch(32)
    opt = LocalOptimizer(linear_model(), ds, nn.ClassNLLCriterion(),
                         device="cpu")
    opt.set_state(T(learningRate=0.2, momentum=0.9))
    opt.set_checkpoint(str(tmp_path), several_iteration(every))
    opt.set_end_when(max_iteration(steps)).optimize()
    return opt


@pytest.mark.parametrize("damage", ["flip", "truncate", "sidecar",
                                    "no_state"])
def test_resume_falls_back_past_a_corrupt_snapshot(tmp_path, damage):
    _snapshots(tmp_path)
    assert list_checkpoints(str(tmp_path)) == [6, 4, 2]
    path = tmp_path / ("model.6" if damage != "no_state" else "state.6")
    data = bytearray(path.read_bytes())
    if damage == "flip":
        data[len(data) // 2] ^= 0x10
        path.write_bytes(bytes(data))
    elif damage == "truncate":
        path.write_bytes(bytes(data[:len(data) // 2]))
    elif damage == "sidecar":
        (tmp_path / "model.6.crc32").write_bytes(b"00000000 1\n")
    else:
        path.unlink()
    if damage == "no_state":
        assert list_checkpoints(str(tmp_path)) == [4, 2]
    else:
        assert not snapshot_valid(str(tmp_path), 6)
        with pytest.raises(File.ChecksumError):
            File.load(str(path))
    assert snapshot_valid(str(tmp_path), 4)
    _, blob, neval = load_latest_checkpoint(str(tmp_path), device="cpu")
    assert neval == 4 and blob["neval"] == 4


def test_prune_keeps_the_newest_and_the_newest_valid(tmp_path, monkeypatch):
    _snapshots(tmp_path, every=1, steps=5)
    assert list_checkpoints(str(tmp_path)) == [6, 5, 4, 3, 2]
    (tmp_path / "model.6").write_bytes(b"rot")
    (tmp_path / "model.5").write_bytes(b"rot")
    removed = prune_checkpoints(str(tmp_path), 2)
    # 6 and 5 kept by the window, 4 as the newest valid snapshot
    assert list_checkpoints(str(tmp_path)) == [6, 5, 4]
    assert "model.2" in removed and "state.3.crc32" in removed
    assert sorted(snapshot_files(str(tmp_path), 4)) == [
        "model.4", "model.4.crc32", "state.4", "state.4.crc32"]
    # BIGDL_CKPT_KEEP prunes after every snapshot the loop writes
    monkeypatch.setenv("BIGDL_CKPT_KEEP", "2")
    _snapshots(tmp_path / "kept", every=1, steps=5)
    assert list_checkpoints(str(tmp_path / "kept")) == [6, 5]


def test_urls_and_foreign_classes_are_refused(tmp_path):
    with pytest.raises(ValueError, match="local paths"):
        File.save({"a": 1}, "gs://bucket/x")
    import pickle

    class Foreign:
        pass

    Foreign.__module__ = "bigdl_tpu.nn.linear"
    Foreign.__qualname__ = "Linear"
    import sys
    import types
    mod = types.ModuleType("bigdl_tpu.nn.linear")
    mod.Linear = Foreign
    old = sys.modules.get("bigdl_tpu.nn.linear")
    sys.modules["bigdl_tpu.nn.linear"] = mod
    try:
        data = pickle.dumps({"m": Foreign()})
    finally:
        if old is None:
            del sys.modules["bigdl_tpu.nn.linear"]
        else:
            sys.modules["bigdl_tpu.nn.linear"] = old
    (tmp_path / "blob").write_bytes(data)
    with pytest.raises(pickle.UnpicklingError, match="no counterpart"):
        File.load(str(tmp_path / "blob"))


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------

@pytest.fixture()
def mosaic_pools(monkeypatch):
    monkeypatch.setattr(jax_pooling, "_PALLAS_POOL", "interpret")


def _mnist_set(pkg, seed=5):
    if pkg == "jax":
        ds = JaxDataSet.array(jax_mnist.synthetic(32, 0))
        return ds >> JaxNormalizer(jax_mnist.TRAIN_MEAN,
                                   jax_mnist.TRAIN_STD) >> JaxToBatch(8)
    ds = DataSet.array(mnist.synthetic(32, 0), seed=seed)
    return ds >> ImgNormalizer(mnist.TRAIN_MEAN,
                               mnist.TRAIN_STD) >> ImgToBatch(8)


STATE = dict(learningRate=0.05, momentum=0.9)
K = 3


def _jax_continue(model, blob, neval):
    """The JAX package's LeNet-5 continued K steps from a snapshot."""
    jopt = JaxLocalOptimizer(model, _mnist_set("jax"),
                             jnn.ClassNLLCriterion())
    jopt.set_optim_method(JaxSGD(fused=True)).set_state(JaxT(**STATE))
    jopt.set_state(blob["state"]).set_optim_state(blob["opt_state"])
    jopt.set_end_when(jax_max_iteration(neval + K - 1))
    jopt.optimize()
    return jopt


def _port_continue(model, blob, neval):
    ds = _mnist_set("torch")
    RNG.restore(blob["rng"], ds.rng)
    popt = LocalOptimizer(model, ds, nn.ClassNLLCriterion(), device="cpu")
    popt.set_optim_method(SGD(fused=True)).set_state(T(**STATE))
    popt.set_state(blob["state"]).set_optim_state(blob["opt_state"])
    popt.set_end_when(max_iteration(neval + K - 1))
    popt.optimize()
    return popt


def _assert_trees_close(got, want):
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **TOL)


def test_a_jax_checkpoint_resumes_in_the_port(tmp_path, mosaic_pools):
    set_seed(1)
    jmodel = JaxLeNet5(10)
    jopt = JaxLocalOptimizer(jmodel, _mnist_set("jax"),
                             jnn.ClassNLLCriterion())
    jopt.set_optim_method(JaxSGD(fused=True)).set_state(JaxT(**STATE))
    jopt.set_checkpoint(str(tmp_path), jax_several_iteration(4))
    jopt.set_end_when(jax_max_iteration(4))
    set_seed(5)
    jopt.optimize()
    # the JAX package resumes its own snapshot ...
    set_seed(77)
    jmod, jblob, neval = jax_load_latest(str(tmp_path), restore_rng=True)
    assert neval == 4
    want = _jax_continue(jmod, jblob, neval)
    # ... and the port resumes the same files
    with pytest.raises(ValueError, match="load_module_into"):
        File.load_module(str(tmp_path / "model.4"), device="cpu")
    port = File.load_module_into(LeNet5(10, device="cpu"),
                                 str(tmp_path / "model.4"))
    blob = File.load(str(tmp_path / "state.4"))
    assert isinstance(blob["state"], Table)
    vel = blob["opt_state"]["velocity"]
    assert np.abs(vel["1"]["~"]["weight"]).max() > 0   # momentum carried
    got = _port_continue(port, blob, neval)
    assert got.state["neval"] == want.state["neval"] == neval + K
    assert got.state["epoch"] == want.state["epoch"]
    np.testing.assert_allclose(got.state["loss"], want.state["loss"], **TOL)
    _assert_trees_close(export_params(got.model), want.model.params())


def test_a_port_checkpoint_resumes_in_the_jax_package(tmp_path,
                                                      mosaic_pools):
    set_seed(1)
    init = jax.tree_util.tree_map(np.asarray, JaxLeNet5(10).params())
    popt = LocalOptimizer(load_jax_params(LeNet5(10, device="cpu"), init),
                          _mnist_set("torch"), nn.ClassNLLCriterion(),
                          device="cpu")
    popt.set_optim_method(SGD(fused=True)).set_state(T(**STATE))
    popt.set_checkpoint(str(tmp_path), several_iteration(4))
    popt.set_end_when(max_iteration(4)).optimize()
    # the port resumes its own snapshot ...
    ds = _mnist_set("torch")
    module, blob, neval = load_latest_checkpoint(str(tmp_path), device="cpu",
                                                 dataset=ds)
    assert neval == 4
    want = _port_continue(module, blob, neval)
    # ... and the JAX package resumes the same files
    jmodel = JaxFile.load_module_into(JaxLeNet5(10),
                                      str(tmp_path / "model.4"))
    jblob = JaxFile.load(str(tmp_path / "state.4"))
    JaxRNG.restore(dict(JaxRNG.snapshot(), np_state=jblob["rng"]["np_state"]))
    got = _jax_continue(jmodel, jblob, neval)
    assert got.state["neval"] == want.state["neval"] == neval + K
    assert got.state["epoch"] == want.state["epoch"]
    np.testing.assert_allclose(got.state["loss"], want.state["loss"], **TOL)
    _assert_trees_close(got.model.params(), export_params(want.model))


# ---------------------------------------------------------------------------
# across packages with module state: ResNetCifar(8)'s running statistics
# ---------------------------------------------------------------------------

def _cifar_set(pkg, seed=5):
    from bigdl_tpu.dataset import cifar as jax_cifar
    from bigdl_tpu_torch.dataset import cifar

    norm = (cifar.TRAIN_MEAN, cifar.TRAIN_STD)
    if pkg == "jax":
        return (JaxDataSet.array(jax_cifar.synthetic(16, 0))
                >> JaxNormalizer(*norm) >> JaxToBatch(4))
    return (DataSet.array(cifar.synthetic(16, 0), seed=seed)
            >> ImgNormalizer(*norm) >> ImgToBatch(4))


BN_STATE = dict(learningRate=0.05, momentum=0.9, dampening=0.0,
                nesterov=True)


def _jax_resnet(seed=1):
    from bigdl_tpu.models.resnet import ResNetCifar as JaxResNetCifar

    set_seed(seed)
    return JaxResNetCifar(8, 10)


def _bn_continue(pkg, model, blob, neval):
    """Either package's ResNetCifar(8) continued K steps from a
    snapshot's state, optimizer state and random payload."""
    if pkg == "jax":
        JaxRNG.restore(dict(JaxRNG.snapshot(),
                            np_state=blob["rng"]["np_state"]))
        opt = JaxLocalOptimizer(model, _cifar_set("jax"),
                                jnn.ClassNLLCriterion())
        opt.set_state(JaxT(**BN_STATE))
        end = jax_max_iteration(neval + K - 1)
    else:
        ds = _cifar_set("torch")
        RNG.restore(blob["rng"], ds.rng)
        opt = LocalOptimizer(model, ds, nn.ClassNLLCriterion(), device="cpu")
        opt.set_state(T(**BN_STATE))
        end = max_iteration(neval + K - 1)
    opt.set_state(blob["state"]).set_optim_state(blob["opt_state"])
    opt.set_end_when(end)
    opt.optimize()
    return opt


def _state_of(model):
    from bigdl_tpu_torch.nn.module import export_state

    if isinstance(model, torch.nn.Module):
        return export_state(model)
    return jax.tree_util.tree_map(np.asarray, model.state())


def test_a_jax_bn_checkpoint_resumes_in_the_port(tmp_path):
    """A JAX ResNetCifar(8) snapshot (params, running statistics,
    velocity) resumed by the port: equal statistics at the resume, and
    the next K losses, params and statistics of the JAX package's own
    resume."""
    from bigdl_tpu_torch.models.resnet import ResNetCifar

    jmodel = _jax_resnet()
    jopt = JaxLocalOptimizer(jmodel, _cifar_set("jax"),
                             jnn.ClassNLLCriterion())
    jopt.set_state(JaxT(**BN_STATE))
    jopt.set_checkpoint(str(tmp_path), jax_several_iteration(4))
    jopt.set_end_when(jax_max_iteration(4))
    set_seed(5)
    jopt.optimize()
    set_seed(77)
    jmod, jblob, neval = jax_load_latest(str(tmp_path), restore_rng=True)
    assert neval == 4
    saved = _state_of(jmod)
    want = _bn_continue("jax", jmod, jblob, neval)
    port = File.load_module_into(ResNetCifar(8, 10, device="cpu"),
                                 str(tmp_path / "model.4"))
    at_resume = _state_of(port)
    for a, b in zip(jax.tree_util.tree_leaves(at_resume),
                    jax.tree_util.tree_leaves(saved)):
        np.testing.assert_array_equal(a, b)
    assert max(float(np.abs(v - 1).max()) for v in jax.tree_util.tree_leaves(
        at_resume) if v.ndim == 1) > 0.01   # statistics moved off (0, 1)
    got = _bn_continue("torch", port, File.load(str(tmp_path / "state.4")),
                       neval)
    assert got.state["neval"] == want.state["neval"] == neval + K
    np.testing.assert_allclose(got.state["loss"], want.state["loss"], **TOL)
    _assert_trees_close(export_params(got.model), want.model.params())
    _assert_trees_close(_state_of(got.model), _state_of(want.model))


def test_a_port_bn_checkpoint_resumes_in_the_jax_package(tmp_path):
    from bigdl_tpu.models.resnet import ResNetCifar as JaxResNetCifar
    from bigdl_tpu_torch.models.resnet import ResNetCifar

    init = jax.tree_util.tree_map(np.asarray, _jax_resnet().params())
    popt = LocalOptimizer(load_jax_params(ResNetCifar(8, 10, device="cpu"),
                                          init),
                          _cifar_set("torch"), nn.ClassNLLCriterion(),
                          device="cpu")
    popt.set_state(T(**BN_STATE))
    popt.set_checkpoint(str(tmp_path), several_iteration(4))
    popt.set_end_when(max_iteration(4)).optimize()
    ds = _cifar_set("torch")
    module, blob, neval = load_latest_checkpoint(str(tmp_path), device="cpu",
                                                 dataset=ds)
    assert neval == 4
    saved = _state_of(module)
    want = _bn_continue("torch", module, blob, neval)
    jmodel = JaxFile.load_module_into(JaxResNetCifar(8, 10),
                                      str(tmp_path / "model.4"))
    for a, b in zip(jax.tree_util.tree_leaves(_state_of(jmodel)),
                    jax.tree_util.tree_leaves(saved)):
        np.testing.assert_array_equal(a, b)
    got = _bn_continue("jax", jmodel, JaxFile.load(str(tmp_path / "state.4")),
                       neval)
    assert got.state["neval"] == want.state["neval"] == neval + K
    np.testing.assert_allclose(got.state["loss"], want.state["loss"], **TOL)
    _assert_trees_close(got.model.params(), export_params(want.model))
    _assert_trees_close(_state_of(got.model), _state_of(want.model))
