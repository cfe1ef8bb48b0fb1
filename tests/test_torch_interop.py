"""The port's weight import (``utils/caffe_loader.py``,
``utils/torch_file.py``) against the JAX package, following
tests/test_interop.py's cases: the protobuf wire parser reads the same
layers in both formats, ``load`` copies the named layers in place and
raises where JAX raises; a ``.caffemodel`` of ``Inception_v1``'s and
``AlexNet``'s named layers loads into both packages' models, and their
forwards agree (rtol 1e-4 / atol 1e-5, tests/test_torch_models.py's
tolerance); ``.t7`` files written by the port equal the JAX bytes, and a
module file of either package loads into the other's model bit for bit
(the RNN layers too)."""
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.models import alexnet as jax_alexnet
from bigdl_tpu.models import inception as jax_inception
from bigdl_tpu.models import lenet as jax_lenet
from bigdl_tpu.models import resnet as jax_resnet
from bigdl_tpu.models import textclassifier as jax_textclassifier
from bigdl_tpu.utils import caffe_loader as jax_caffe
from bigdl_tpu.utils import torch_file as jax_t7
from bigdl_tpu.utils.random import set_seed
from bigdl_tpu.utils.table import T as JaxT
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.models import alexnet, inception, lenet, resnet
from bigdl_tpu_torch.models import textclassifier
from bigdl_tpu_torch.nn.module import (export_params, export_state,
                                       load_jax_params, load_jax_state)
from bigdl_tpu_torch.utils import CaffeLoader, TorchFile
from bigdl_tpu_torch.utils import caffe_loader, torch_file
from bigdl_tpu_torch.utils.table import T

TOL = dict(rtol=1e-4, atol=1e-5)


def _varint(v):
    out = b""
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _field(num, wire, payload):
    return _varint((num << 3) | wire) + payload


def _len_delim(num, data):
    return _field(num, 2, _varint(len(data)) + data)


def _blob(arr, legacy_dims=False):
    arr = np.asarray(arr, np.float32)
    if legacy_dims:          # num/channels/height/width, padded to 4-D
        dims = (1,) * (4 - arr.ndim) + arr.shape
        blob = b"".join(_field(i + 1, 0, _varint(d))
                        for i, d in enumerate(dims))
    else:
        shape_msg = b"".join(_field(1, 0, _varint(d)) for d in arr.shape)
        blob = _len_delim(7, shape_msg)  # BlobShape
    return blob + _len_delim(5, arr.tobytes())  # packed float data


def _layer_v2(name, blobs):
    msg = _len_delim(1, name.encode()) + _len_delim(2, b"Convolution")
    return msg + b"".join(_len_delim(7, _blob(b)) for b in blobs)


def _layer_v1(name, blobs):
    msg = _len_delim(4, name.encode())
    return msg + b"".join(_len_delim(6, _blob(b, True)) for b in blobs)


def _read_both(path):
    got, want = caffe_loader.read_caffemodel(path), \
        jax_caffe.read_caffemodel(path)
    assert list(got) == list(want)
    for k in want:
        assert len(got[k]) == len(want[k])
        for a, b in zip(got[k], want[k]):
            assert a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    return got


def test_parse_new_and_legacy_formats_equal_jax(tmp_path):
    w = np.random.RandomState(0).randn(4, 3, 3, 3).astype(np.float32)
    b = np.zeros(4, np.float32)
    fc = np.ones((2, 5), np.float32)
    p = tmp_path / "m.caffemodel"
    p.write_bytes(_len_delim(100, _layer_v2("conv1", [w, b]))
                  + _len_delim(2, _layer_v1("fc", [fc]))
                  + _len_delim(3, b"ignored field"))
    layers = _read_both(str(p))
    np.testing.assert_array_equal(layers["conv1"][0], w)
    np.testing.assert_array_equal(layers["fc"][0], fc)
    assert layers["fc"][0].shape == (2, 5)


def _tiny(pkg_nn, **kw):
    return pkg_nn.Sequential(
        pkg_nn.SpatialConvolution(3, 8, 3, 3, **kw).set_name("conv1"),
        pkg_nn.ReLU(),
        pkg_nn.SpatialAveragePooling(6, 6),
        pkg_nn.Reshape([8]),
        pkg_nn.Linear(8, 10, **kw).set_name("fc1"))


def test_load_into_model_in_place_as_jax(tmp_path):
    rs = np.random.RandomState(1)
    w, b = rs.randn(8, 3, 3, 3), rs.randn(8)
    fcw, fcb = rs.randn(10, 8), np.zeros(10)
    p = tmp_path / "net.caffemodel"
    p.write_bytes(_len_delim(100, _layer_v2("conv1", [w, b]))
                  + _len_delim(100, _layer_v2("fc1", [fcw, fcb])))
    model = _tiny(nn, device="cpu")
    weight = model.get(1).weight
    _, copied = CaffeLoader.load(model, str(p))
    _, jcopied = jax_caffe.load(_tiny(jnn), str(p))
    assert copied == jcopied == {"conv1", "fc1"}
    assert model.get(1).weight is weight     # copied in place
    np.testing.assert_array_equal(weight.detach().numpy(),
                                  w.astype(np.float32))
    np.testing.assert_array_equal(model.get(5).weight.detach().numpy(),
                                  fcw.astype(np.float32))


def test_match_all_missing_raises(tmp_path):
    p = tmp_path / "net.caffemodel"
    p.write_bytes(_len_delim(100, _layer_v2(
        "conv1", [np.ones((1, 1, 1, 1), np.float32)])))
    model = nn.Sequential(nn.Linear(2, 2, device="cpu").set_name(
        "unknown_fc"))
    with pytest.raises(ValueError, match="has no blobs"):
        caffe_loader.load(model, str(p))
    _, copied = caffe_loader.load(model, str(p), match_all=False)
    assert copied == set()
    # a layer with fewer blobs than the module's parameters
    q = tmp_path / "short.caffemodel"
    q.write_bytes(_len_delim(100, _layer_v2(
        "conv1", [np.zeros((8, 3, 3, 3), np.float32)])))
    with pytest.raises(ValueError, match="has 1 blobs but the module "
                       "needs 2"):
        caffe_loader.load(_tiny(nn, device="cpu"), str(q), match_all=False)


def _model_and_blob(tmp_path, wshape=(4, 3, 3, 3), bshape=(4,)):
    rng = np.random.RandomState(0)
    w = rng.randn(*wshape).astype(np.float32)
    b = rng.randn(*bshape).astype(np.float32)
    layer = (_len_delim(1, b"conv1")
             + _len_delim(7, _blob(w)) + _len_delim(7, _blob(b)))
    p = tmp_path / "net.caffemodel"
    p.write_bytes(_len_delim(100, layer))
    model = nn.Sequential(
        nn.SpatialConvolution(3, 4, 3, 3, device="cpu").set_name("conv1"))
    return model, str(p)


def test_prototxt_parse_equals_jax(tmp_path):
    proto = tmp_path / "deploy.prototxt"
    proto.write_text('''
name: "TinyNet"
layer {
  name: "conv1"
  type: "Convolution"
  convolution_param { num_output: 4 kernel_size: 3 }
}
layer { name: "relu1" type: "ReLU" }
layers { name: "legacy_fc" type: INNER_PRODUCT }
''')
    layers = caffe_loader.read_prototxt(str(proto))
    assert layers == jax_caffe.read_prototxt(str(proto))
    assert [l["name"] for l in layers] == ["conv1", "relu1", "legacy_fc"]
    assert layers[0]["type"] == "Convolution"
    assert "num_output" not in layers[0]


def test_load_with_prototxt_validates_names(tmp_path):
    model, cp = _model_and_blob(tmp_path)
    proto = tmp_path / "deploy.prototxt"
    proto.write_text('layer { name: "conv1" type: "Convolution" }')
    _, copied = caffe_loader.load(model, cp, prototxt_path=str(proto))
    assert copied == {"conv1"}
    bad = nn.Sequential(
        nn.SpatialConvolution(3, 4, 3, 3, device="cpu").set_name("convX"))
    with pytest.raises(ValueError, match="not layers of"):
        caffe_loader.load(bad, cp, prototxt_path=str(proto),
                          match_all=False)


def test_blob_shape_mismatch_raises(tmp_path):
    model, cp = _model_and_blob(tmp_path, wshape=(4, 3, 5, 5))
    with pytest.raises(ValueError, match="does not match"):
        caffe_loader.load(model, cp)


def _set_p0(model):
    for m in model.modules():
        if isinstance(m, nn.Dropout):
            m.set_p(0.0)


def _caffemodel_of(jm, path, seed):
    """A .caffemodel holding new values for every named layer of the JAX
    model ``jm`` (half the layers in the legacy V1 format)."""
    rs = np.random.RandomState(seed)
    body, names = b"", []
    for i, (name, m) in enumerate(sorted(
            jax_caffe._named_param_modules(jm).items())):
        blobs = [rs.randn(*np.shape(m._params[k])).astype(np.float32) * 0.05
                 for k in ("weight", "bias") if k in m._params]
        body += (_len_delim(100, _layer_v2(name, blobs)) if i % 2 else
                 _len_delim(2, _layer_v1(name, blobs)))
        names.append(name)
    path.write_bytes(body)
    return set(names)


@pytest.mark.parametrize("name,shape", [("Inception_v1", (1, 3, 224, 224)),
                                        ("AlexNet", (1, 3, 227, 227))])
def test_zoo_caffemodel_loads_into_both_packages(tmp_path, name, shape):
    """``Inception_v1`` (conv1, conv2's two, loss3/classifier) and
    ``AlexNet`` (conv1-5, fc6-8) take their named layers from one
    .caffemodel in both packages, the rest from the JAX init through the
    tree carrier; the evaluation forwards agree at TOL."""
    jmod, pmod = {"Inception_v1": (jax_inception, inception),
                  "AlexNet": (jax_alexnet, alexnet)}[name]
    set_seed(3)
    jm = getattr(jmod, name)(20)
    pm = getattr(pmod, name)(20, device="cpu")
    load_jax_params(pm, _np(jm.params()))
    path = tmp_path / "zoo.caffemodel"
    names = _caffemodel_of(jm, path, 4)
    _, jcopied = jax_caffe.load(jm, str(path), match_all=False)
    _, copied = caffe_loader.load(pm, str(path), match_all=False)
    assert copied == jcopied == names and len(names) in (4, 8)
    blobs = caffe_loader.read_caffemodel(str(path))
    for n, m in caffe_loader._named_param_modules(pm).items():
        np.testing.assert_array_equal(m.weight.detach().numpy(),
                                      blobs[n][0].reshape(m.weight.shape))
    jm.evaluate()
    pm.evaluate()
    x = (np.random.RandomState(5).randn(*shape) * 40).astype(np.float32)
    want = np.asarray(jm.forward(x))
    got = pm(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (1, 20)
    np.testing.assert_allclose(got, want, **TOL)


def test_resnet_has_no_named_layers_in_either_package(tmp_path):
    """The JAX ``ResNet`` names no layer, so a name-matched Caffe load
    copies nothing in either package (a limitation of the reference
    model, kept)."""
    set_seed(2)
    jm = jax_resnet.ResNetCifar(8, 10)
    pm = resnet.ResNetCifar(8, 10, device="cpu")
    path = tmp_path / "r.caffemodel"
    path.write_bytes(_len_delim(100, _layer_v2(
        "conv1", [np.zeros((16, 3, 3, 3), np.float32)])))
    assert jax_caffe.load(jm, str(path), match_all=False)[1] == set()
    assert caffe_loader.load(pm, str(path), match_all=False)[1] == set()


def _np(tree):
    import jax
    return jax.tree_util.tree_map(np.asarray, tree)


# -- Torch7 -----------------------------------------------------------------

def test_plain_objects_equal_jax_bytes_and_load_back(tmp_path):
    obj = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
           "d": np.linspace(0, 1, 4), "i": np.arange(3, dtype=np.int64),
           "n": 3.5, "s": "text", "b": True, "z": None,
           "t": {1: "one", 2: np.ones((2, 2), np.float32)}}
    a, b = tmp_path / "p.t7", tmp_path / "j.t7"
    torch_file.save(obj, str(a))
    jax_t7.save(obj, str(b))
    assert a.read_bytes() == b.read_bytes()
    torch_file.save(T(1.0, "x"), str(a))
    jax_t7.save(JaxT(1.0, "x"), str(b))
    assert a.read_bytes() == b.read_bytes()
    torch_file.save({"t": torch.arange(4, dtype=torch.float32),
                     "h": torch.ones(2, dtype=torch.bfloat16)}, str(a))
    got = jax_t7.load(str(a))
    np.testing.assert_array_equal(got["t"], np.arange(4, dtype=np.float32))
    assert got["h"].dtype == np.float32
    back = torch_file.load(str(b))
    assert back == jax_t7.load(str(b))


ZOO = {
    "lenet": (lambda: jax_lenet.LeNet5(10),
              lambda: lenet.LeNet5(10, device="cpu"), (2, 1, 28, 28)),
    "resnet20": (lambda: jax_resnet.ResNetCifar(depth=20, class_num=10),
                 lambda: resnet.ResNetCifar(20, 10, device="cpu"),
                 (2, 3, 32, 32)),
    "inception-v1": (lambda: jax_inception.Inception_v1(50),
                     lambda: inception.Inception_v1(50, device="cpu"),
                     None),
    "bilstm": (lambda: jax_textclassifier.TextClassifierBiLSTM(
        4, embed_dim=6, hidden_size=5),
        lambda: textclassifier.TextClassifierBiLSTM(
            4, embed_dim=6, hidden_size=5, device="cpu"), (2, 9, 6)),
}


def _leaves(tree):
    import jax
    return [np.asarray(v) for v in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("name", sorted(ZOO))
def test_module_files_cross_packages_bit_for_bit(tmp_path, name):
    """A JAX model with moved running statistics is saved by both
    packages (the same bytes); its file loads into a port model of
    another init, and the port's file into a JAX model, each bit for
    bit, buffers included; the port model's forward then equals the JAX
    one's at TOL."""
    jbuild, pbuild, shape = ZOO[name]
    set_seed(11)
    jm = jbuild()
    if shape is not None and name == "resnet20":
        jm.training()
        jm.forward(np.random.RandomState(0).randn(*shape).astype(
            np.float32))
    src = pbuild()
    load_jax_params(src, _np(jm.params()))
    load_jax_state(src, _np(jm.state()))
    j7, p7 = tmp_path / "j.t7", tmp_path / "p.t7"
    jax_t7.save_module(jm, str(j7))
    TorchFile.save_module(src, str(p7))
    assert p7.read_bytes() == j7.read_bytes()

    dst = pbuild()
    TorchFile.load_module_weights(dst, str(j7))
    for a, b in zip(_leaves(export_params(dst)), _leaves(jm.params())):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(_leaves(export_state(dst)), _leaves(jm.state())):
        np.testing.assert_array_equal(a, b)
    set_seed(12)
    jdst = jbuild()
    jax_t7.load_module_weights(jdst, str(p7))
    for a, b in zip(_leaves(jdst.params()), _leaves(export_params(src))):
        np.testing.assert_array_equal(a, b)
    if shape is not None:
        jm.evaluate()
        dst.evaluate()
        x = np.random.RandomState(1).randn(*shape).astype(np.float32)
        np.testing.assert_allclose(dst(torch.from_numpy(x)).detach().numpy(),
                                   np.asarray(jm.forward(x)), **TOL)


def test_strict_raises_on_missing_param(tmp_path):
    src = nn.Linear(4, 3, device="cpu")
    p = tmp_path / "nobias.t7"
    torch_file.save({"torch_typename": "nn.Linear",
                     "weight": src.weight.detach().numpy()}, str(p))
    dst = nn.Linear(4, 3, device="cpu")
    with pytest.raises(ValueError, match="parameter field"):
        torch_file.load_module_weights(dst, str(p))
    with pytest.warns(UserWarning, match="lacks"):
        torch_file.load_module_weights(dst, str(p), strict=False)
    np.testing.assert_array_equal(dst.weight.detach().numpy(),
                                  src.weight.detach().numpy())
    jdst = jnn.Linear(4, 3)
    with pytest.raises(ValueError, match="parameter field"):
        jax_t7.load_module_weights(jdst, str(p))
    with pytest.raises(ValueError, match="module count mismatch"):
        torch_file.load_module_weights(_tiny(nn, device="cpu"), str(p))
