"""The port's ``models/utils`` and the slice as a whole against the JAX
package on the CPU: ``run_perf`` returns the JAX harness's keys;
``train_and_eval_image_folder`` over a 2-class folder of 8 PNGs that
Pillow writes gives the JAX run's ``top1``, ``n_records``, ``n_classes``
and loss trajectory (the loss at 1, 3 and 6 iterations, rtol 1e-4 /
atol 1e-5); and config 5's input path at small size: 16 PNGs of about
40x36 in 4 classes packed into 2 shards by ``imagenet_tools``, streamed
by ``ShardFolder(distributed=True)`` through
examples/train_resnet50_imagenet.py's chain into ``Optimizer(...)``,
which routes to the ``DistriOptimizer`` in both packages (a world of
one), trains a ResNet three steps with the example's SGD, and follows the
JAX trajectory step by step (rtol 1e-4 / atol 1e-5,
tests/test_torch_resnet.py's tolerance).

The slice's ResNet is ``ResNetCifar(8)`` on 32x32 crops of images
decoded at 36x36: both packages' ImageNet ``ResNet`` ends in a fixed 7x7
average pool that needs 224x224 inputs, too dear for a CPU test, and
``ResNetCifar``'s fixed 8x8 pool needs 32x32 crops.  The JAX pools run
their Mosaic kernel in interpret mode (the port's first-max tie rule)."""
import os

import numpy as np
import pytest
from PIL import Image

from bigdl_tpu import nn as jnn
from bigdl_tpu.dataset import imagenet_tools as jax_tools
from bigdl_tpu.dataset import image as jimage
from bigdl_tpu.dataset.shardfile import ShardFolder as JaxShardFolder
from bigdl_tpu.models import resnet as jax_resnet
from bigdl_tpu.models.utils import perf as jax_perf
from bigdl_tpu.models.utils import real_data as jax_real_data
from bigdl_tpu.nn import pooling as jax_pooling
from bigdl_tpu.optim import DistriOptimizer as JaxDistriOptimizer
from bigdl_tpu.optim import Optimizer as JaxOptimizer
from bigdl_tpu.optim import max_iteration as jax_max_iteration
from bigdl_tpu.optim import several_iteration as jax_several_iteration
from bigdl_tpu.optim.optim_method import EpochStep as JaxEpochStep
from bigdl_tpu.parallel.mesh import data_parallel_mesh
from bigdl_tpu.utils import file as jax_file
from bigdl_tpu.utils.random import set_seed
from bigdl_tpu.utils.table import T as JaxT
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset import (BytesToImg, ColorJitter, HFlip,
                                     ImgNormalizer, ImgRdmCropper,
                                     ImgToBatch, Lighting, imagenet_tools)
from bigdl_tpu_torch.dataset.shardfile import ShardFolder
from bigdl_tpu_torch.models import resnet
from bigdl_tpu_torch.models.utils import (distri_optimizer_perf,
                                          local_optimizer_perf, perf,
                                          real_data)
from bigdl_tpu_torch.nn.module import export_params, load_jax_params
from bigdl_tpu_torch.optim import (DistriOptimizer, EpochStep, Optimizer,
                                   max_iteration, several_iteration)
from bigdl_tpu_torch.utils import file as port_file
from bigdl_tpu_torch.utils.engine import Engine
from bigdl_tpu_torch.utils.table import T

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture()
def mosaic_pools(monkeypatch):
    monkeypatch.setattr(jax_pooling, "_PALLAS_POOL", "interpret")


def _np(tree):
    import jax
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    import jax
    return [np.asarray(v) for v in jax.tree_util.tree_leaves(tree)]


def test_run_perf_returns_the_jax_keys(capsys):
    want = {"model", "batch_size", "iters_per_dispatch", "distributed",
            "devices", "step_time_ms", "throughput_records_per_sec",
            "compile_time_s", "loss"}
    got = perf.run_perf("lenet5", 4, 2, warmup=1, data_type="float",
                        device="cpu")
    assert set(got) == want
    assert got["devices"] == 1 and got["iters_per_dispatch"] == 1
    assert np.isfinite(got["loss"]) and got["step_time_ms"] > 0
    chunk = perf.run_perf("lenet5", 4, 1, warmup=1, data_type="bf16",
                          iters_per_dispatch=2, device="cpu")
    assert chunk["iters_per_dispatch"] == 2 and np.isfinite(chunk["loss"])
    local_optimizer_perf.main(["-m", "lenet5", "-b", "4", "-i", "1",
                               "--dataType", "float", "--device", "cpu"])
    assert '"model": "lenet5"' in capsys.readouterr().out
    with pytest.raises(SystemExit):
        local_optimizer_perf.main(["-m", "lenet5", "--distributed",
                                   "--device", "cpu"])
    assert set(perf.MODELS) == {"alexnet", "alexnetowt", "googlenet_v1",
                                "inception_v1", "googlenet_v2",
                                "inception_v2", "vgg16", "vgg19", "lenet5"}
    jax_perf._register()
    assert set(perf.MODELS) == set(jax_perf.MODELS)
    assert all(perf.MODELS[k][1:] == jax_perf.MODELS[k][1:]
               for k in perf.MODELS)
    try:
        distri_optimizer_perf.main(
            ["-m", "lenet5", "-b", "4", "-i", "1", "--warmup", "1",
             "--dataType", "float", "--device", "cpu", "--distributed"])
        assert '"distributed": true' in capsys.readouterr().out
    finally:
        Engine.reset()


def _png_folder(root, n_classes, per_class, hw, seed=0):
    """Class-per-subfolder PNGs that Pillow writes: smooth images whose
    brightness tells the class."""
    rs = np.random.RandomState(seed)
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w]
    for c in range(n_classes):
        d = os.path.join(root, f"class{c}")
        os.makedirs(d)
        for i in range(per_class):
            base = 40 + 180 * c / max(n_classes - 1, 1)
            wave = 30 * np.sin(xx / (3 + i) + rs.uniform(0, 6))[..., None] \
                * np.array([1.0, 0.6, 0.3])
            img = np.clip(base + wave + rs.uniform(-10, 10, (h, w, 3)),
                          0, 255).astype(np.uint8)
            Image.fromarray(img).save(os.path.join(d, f"{i:03d}.png"))
    return root


def test_train_and_eval_image_folder_follows_jax(tmp_path, mosaic_pools):
    folder = _png_folder(str(tmp_path / "f"), 2, 4, (20, 22))
    for iterations in (1, 3, 6):
        want = jax_real_data.train_and_eval_image_folder(
            folder, image_size=16, iterations=iterations, seed=5)
        set_seed(5)
        jm = jax_real_data.small_convnet(2, 16)
        pm = load_jax_params(real_data.small_convnet(2, 16, device="cpu"),
                             _np(jm.params()))
        got = real_data.train_and_eval_image_folder(
            folder, image_size=16, iterations=iterations, seed=5, model=pm,
            device="cpu")
        assert set(got) == set(want)
        for k in ("top1", "top5", "n_records", "n_classes", "iterations"):
            assert got[k] == want[k], k
        np.testing.assert_allclose(got["loss"], want["loss"], **TOL)
    assert got["n_records"] == 8 and got["n_classes"] == 2
    alone = real_data.train_and_eval_image_folder(
        folder, image_size=16, iterations=6, seed=5, device="cpu")
    assert alone["n_records"] == 8 and np.isfinite(alone["loss"])
    (tmp_path / "empty" / "c").mkdir(parents=True)
    with pytest.raises(ValueError, match="no decodable images"):
        real_data.train_and_eval_image_folder(str(tmp_path / "empty"),
                                              device="cpu")


MEAN, STD = (123.0, 117.0, 104.0), (58.4, 57.1, 57.4)
SGD = dict(learningRate=0.1, weightDecay=1e-4, momentum=0.9,
           dampening=0.0, nesterov=True)
STEPS = 3


def _snapshots(path):
    return sorted(int(f[6:]) for f in os.listdir(path)
                  if f.startswith("model.") and f[6:].isdigit())


def _shards(tmp_path):
    folder = _png_folder(str(tmp_path / "train"), 4, 4, (40, 36), seed=3)
    paths, n_classes = imagenet_tools.generate(folder, str(tmp_path / "sh"),
                                               2)
    jpaths, _ = jax_tools.generate(folder, str(tmp_path / "jsh"), 2)
    assert [open(p, "rb").read() for p in paths] == \
        [open(p, "rb").read() for p in jpaths]
    assert n_classes == 4 and len(paths) == 2
    return str(tmp_path / "sh")


def test_config5_input_path_follows_jax_step_by_step(tmp_path, mosaic_pools):
    shards = _shards(tmp_path)
    set_seed(21)
    jm = jax_resnet.ResNetCifar(8, 4)
    init = _np(jm.params())
    pm = load_jax_params(resnet.ResNetCifar(8, 4, device="cpu"), init)
    jds = (JaxShardFolder(shards, distributed=True)
           >> jimage.BytesToImg(36) >> jimage.ImgRdmCropper(32, 32)
           >> jimage.HFlip() >> jimage.ColorJitter(channel_order="rgb")
           >> jimage.Lighting() >> jimage.ImgNormalizer(MEAN, STD)
           >> jimage.ImgToBatch(4))
    import jax
    jopt = JaxOptimizer(jm, jds, jnn.ClassNLLCriterion(),
                        mesh=data_parallel_mesh(jax.devices()[:1]))
    assert isinstance(jopt, JaxDistriOptimizer)
    jopt.set_state(JaxT(**SGD, learningRateSchedule=JaxEpochStep(30, 0.1)))
    jopt.set_end_when(jax_max_iteration(STEPS))
    jopt.set_checkpoint(str(tmp_path / "jck"), jax_several_iteration(1))
    set_seed(8)
    jopt.optimize()

    pds = (ShardFolder(shards, distributed=True, seed=8)
           >> BytesToImg(36) >> ImgRdmCropper(32, 32) >> HFlip()
           >> ColorJitter(channel_order="rgb") >> Lighting()
           >> ImgNormalizer(MEAN, STD) >> ImgToBatch(4))
    try:
        popt = Optimizer(pm, pds, nn.ClassNLLCriterion(), state=T(
            **SGD, learningRateSchedule=EpochStep(30, 0.1)),
            end_trigger=max_iteration(STEPS), device="cpu")
        assert isinstance(popt, DistriOptimizer)
        assert popt.mesh.shape == {"data": 1}
        popt.set_checkpoint(str(tmp_path / "pck"), several_iteration(1))
        popt.optimize()
    finally:
        Engine.reset()
    assert popt.state["neval"] == jopt.state["neval"] == STEPS + 1
    np.testing.assert_allclose(popt.state["loss"], jopt.state["loss"], **TOL)
    labels = _snapshots(tmp_path / "pck")
    assert labels == _snapshots(tmp_path / "jck") == [2, 3, 4]
    for n in labels:
        want = jax_file.load_module(str(tmp_path / "jck" / f"model.{n}"))
        got = port_file.load_module(str(tmp_path / "pck" / f"model.{n}"),
                                    device="cpu")
        for a, b in zip(_leaves(export_params(got)), _leaves(want.params())):
            np.testing.assert_allclose(a, b, **TOL)
    moved = max(float(np.abs(a - b).max()) for a, b in zip(
        _leaves(export_params(popt.model)), _leaves(init)))
    assert moved > 1e-3
