"""The port's layers new in this slice against the JAX package's: the
linear-algebra layers, shape ops, reductions and indexing, L1Penalty,
the convolution family, the bilinear filler, the local normalisations,
RoiPooling and NMS.  Each class is held on seeded numpy inputs, its
parameters carried from the JAX module (``load_jax_params``), in the
forward, the inputs' gradients and every parameter's gradient; then the
points the JAX derivative sets (ties of Max and Min), the documented
differences (MaskedSelect's gradient, RoiPooling's split of a tie
across rows of different counts), the construction of parameters on
the card by default and on the CPU when asked, and the inventory
counted class for class.  Tolerances: forward rtol 1e-5 / atol 1e-6,
where a sum's order differs (convolutions, products, normalisations)
rtol 1e-4 / atol 1e-5; gradients rtol 1e-4 / atol 1e-5
(tests/test_nn_layers.py holds the JAX layers at rtol 1e-4 to 1e-6)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.nn import nms as jax_nms
from bigdl_tpu.utils.random import set_seed
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.nn.module import export_params
from bigdl_tpu_torch.utils.table import Table
from tests.helpers.torch_parity import EVAL, check_module
from tests.helpers.torch_parity import keep_torch_rng  # noqa: F401

FWD = dict(rtol=1e-5, atol=1e-6)
SUM = dict(rtol=1e-4, atol=1e-5)
BWD = dict(rtol=1e-4, atol=1e-5)


def _randn(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _dev(m):
    """The constructor arguments that put a port layer on the CPU."""
    return {"device": "cpu"} if m is nn else {}


def _conn():
    """A random 6 -> 16 connection table of fan-in 3."""
    return nn.SpatialConvolutionMap.random(6, 16, 3,
                                           np.random.RandomState(3))


# (id, builder over a package, input, forward tolerance)
LAYERS = [
    # linear.py
    ("Bilinear", lambda m: m.Bilinear(4, 3, 5, **_dev(m)),
     [_randn(6, 4), _randn(6, 3, seed=1)], SUM),
    ("Bilinear_no_bias", lambda m: m.Bilinear(4, 3, 2, False, **_dev(m)),
     [_randn(6, 4), _randn(6, 3, seed=1)], SUM),
    ("CMul", lambda m: m.CMul((1, 5), **_dev(m)), _randn(3, 5), FWD),
    ("CMul_broadcast", lambda m: m.CMul((4, 1, 1), **_dev(m)),
     _randn(2, 4, 3, 3), FWD),
    ("CAdd", lambda m: m.CAdd((3, 5), **_dev(m)), _randn(3, 5), FWD),
    ("Mul", lambda m: m.Mul(**_dev(m)), _randn(3, 5), FWD),
    ("Add", lambda m: m.Add(5, **_dev(m)), _randn(3, 5), FWD),
    ("Add_scalar", lambda m: m.Add(5, True, **_dev(m)), _randn(3, 5), FWD),
    ("MulConstant", lambda m: m.MulConstant(-1.5), _randn(3, 5), FWD),
    ("AddConstant", lambda m: m.AddConstant(2.5), _randn(3, 5), FWD),
    ("MM", lambda m: m.MM(), [_randn(3, 4), _randn(4, 2, seed=1)], SUM),
    ("MM_batched_trans", lambda m: m.MM(True, True),
     [_randn(2, 4, 3), _randn(2, 5, 4, seed=1)], SUM),
    ("MV", lambda m: m.MV(), [_randn(2, 3, 4), _randn(2, 4, seed=1)], SUM),
    ("MV_trans", lambda m: m.MV(True), [_randn(4, 3), _randn(4, seed=1)],
     SUM),
    ("Cosine", lambda m: m.Cosine(5, 3, **_dev(m)), _randn(4, 5), SUM),
    ("Euclidean", lambda m: m.Euclidean(5, 3, **_dev(m)), _randn(4, 5),
     SUM),
    ("LookupTable", lambda m: m.LookupTable(9, 4, **_dev(m)),
     np.asarray([[1, 3, 9, 3], [2, 2, 5, 1]], np.int64), FWD),
    ("LookupTable_max_norm",
     lambda m: m.LookupTable(9, 4, max_norm=1.5, **_dev(m)),
     np.asarray([[1, 3, 9, 3], [2, 2, 5, 1]], np.int64), SUM),
    ("LookupTable_max_norm_L1",
     lambda m: m.LookupTable(9, 4, max_norm=2.0, norm_type=1.0, **_dev(m)),
     np.asarray([4, 8, 8, 6], np.int64), SUM),
    # shape_ops.py
    ("InferReshape", lambda m: m.InferReshape((0, -1, 2)), _randn(3, 4, 6),
     FWD),
    ("InferReshape_batch", lambda m: m.InferReshape((-1, 3), True),
     _randn(2, 4, 3), FWD),
    ("Transpose", lambda m: m.Transpose([(1, 3), (2, 3)]), _randn(2, 3, 4),
     FWD),
    ("Replicate", lambda m: m.Replicate(3, 2), _randn(2, 4), FWD),
    ("Squeeze", lambda m: m.Squeeze(), _randn(2, 1, 3, 1), FWD),
    ("Squeeze_dim", lambda m: m.Squeeze(2), _randn(2, 1, 3, 1), FWD),
    ("Squeeze_dim_kept", lambda m: m.Squeeze(1), _randn(2, 1, 3), FWD),
    ("Unsqueeze", lambda m: m.Unsqueeze(3), _randn(2, 3), FWD),
    ("Padding", lambda m: m.Padding(1, 2, 2, 0.5), _randn(3, 4, 5), FWD),
    ("Padding_front", lambda m: m.Padding(2, -3, 2, -1.0, 2),
     _randn(4, 5), FWD),
    ("SpatialZeroPadding", lambda m: m.SpatialZeroPadding(1, 2, 0, 3),
     _randn(2, 3, 4, 5), FWD),
    ("SpatialZeroPadding_crop", lambda m: m.SpatialZeroPadding(-1, 2, -2, 1),
     _randn(3, 6, 5), FWD),
    ("Contiguous", lambda m: m.Contiguous(), _randn(3, 4), FWD),
    ("Copy", lambda m: m.Copy(), _randn(3, 4), FWD),
    ("Echo", lambda m: m.Echo(), _randn(3, 4), FWD),
    # reductions.py
    ("Sum", lambda m: m.Sum(2), _randn(3, 4, 5), FWD),
    ("Sum_batched_average", lambda m: m.Sum(1, 2, True, False),
     _randn(3, 4, 5), FWD),
    ("Max", lambda m: m.Max(2), _randn(3, 4, 5), FWD),
    ("Min", lambda m: m.Min(3), _randn(3, 4, 5), FWD),
    ("Index", lambda m: m.Index(2),
     [_randn(3, 4, 5), np.asarray([[4, 1], [2, 2]], np.int64)], FWD),
    ("Select", lambda m: m.Select(2, 3), _randn(3, 4, 5), FWD),
    ("Select_negative", lambda m: m.Select(3, -1), _randn(3, 4, 5), FWD),
    ("Narrow", lambda m: m.Narrow(2, 2, 2), _randn(3, 4, 5), FWD),
    ("Narrow_negative_length", lambda m: m.Narrow(3, 2, -2),
     _randn(3, 4, 5), FWD),
    # dropout.py
    ("L1Penalty", lambda m: m.L1Penalty(0.3), _randn(3, 4), FWD),
    ("L1Penalty_average", lambda m: m.L1Penalty(0.3, True), _randn(3, 4),
     FWD),
    # conv.py
    ("SpatialShareConvolution",
     lambda m: m.SpatialShareConvolution(3, 4, 3, 3, 1, 1, 1, 1,
                                         **_dev(m)), _randn(2, 3, 7, 6), SUM),
    ("SpatialDilatedConvolution",
     lambda m: m.SpatialDilatedConvolution(3, 4, 3, 3, 1, 1, 2, 2, 2, 2,
                                           **_dev(m)),
     _randn(2, 3, 9, 8), SUM),
    ("SpatialDilatedConvolution_strided_3d",
     lambda m: m.SpatialDilatedConvolution(2, 3, 3, 2, 2, 1, 1, 0, 3, 2,
                                           **_dev(m)),
     _randn(2, 11, 10), SUM),
    ("SpatialFullConvolution",
     lambda m: m.SpatialFullConvolution(4, 3, 4, 4, 2, 2, 1, 1, **_dev(m)),
     _randn(2, 4, 5, 6), SUM),
    ("SpatialFullConvolution_adj_groups",
     lambda m: m.SpatialFullConvolution(4, 6, 3, 3, 2, 2, 1, 1, 1, 1, 2,
                                        **_dev(m)),
     _randn(2, 4, 5, 4), SUM),
    ("SpatialFullConvolution_no_bias_3d",
     lambda m: m.SpatialFullConvolution(3, 2, 2, 3, 3, 1, 0, 1, 2, 0,
                                        no_bias=True, **_dev(m)),
     _randn(3, 4, 5), SUM),
    ("SpatialConvolutionMap",
     lambda m: m.SpatialConvolutionMap(_conn(), 5, 5, **_dev(m)),
     _randn(2, 6, 14, 14), SUM),
    ("SpatialConvolutionMap_one_to_one_padded",
     lambda m: m.SpatialConvolutionMap(
         nn.SpatialConvolutionMap.one_to_one(3), 3, 3, 2, 2, 1, 1,
         **_dev(m)), _randn(3, 9, 8), SUM),
    # normalization.py
    ("SpatialSubtractiveNormalization",
     lambda m: m.SpatialSubtractiveNormalization(3), _randn(2, 3, 10, 11),
     SUM),
    ("SpatialSubtractiveNormalization_1d_kernel",
     lambda m: m.SpatialSubtractiveNormalization(
         2, np.asarray([1.0, 2.0, 4.0, 2.0], np.float32)),
     _randn(2, 7, 6), SUM),
    ("SpatialDivisiveNormalization",
     lambda m: m.SpatialDivisiveNormalization(3), _randn(2, 3, 10, 11),
     SUM),
    ("SpatialDivisiveNormalization_threshold",
     lambda m: m.SpatialDivisiveNormalization(
         2, np.ones((3, 3), np.float32), 0.8, 0.5), _randn(1, 2, 6, 7) * 0.7,
     SUM),
    ("SpatialContrastiveNormalization",
     lambda m: m.SpatialContrastiveNormalization(3), _randn(2, 3, 10, 11),
     SUM),
    ("SpatialContrastiveNormalization_3d",
     lambda m: m.SpatialContrastiveNormalization(
         1, np.asarray([1.0, 3.0, 1.0], np.float32)), _randn(1, 8, 9), SUM),
]


@pytest.mark.parametrize("name,build,x,fwd", LAYERS,
                         ids=[c[0] for c in LAYERS])
def test_layer_matches_jax(name, build, x, fwd):
    set_seed(5)
    check_module(build(jnn), build(nn), x, fwd, BWD)


def _rois(r, n, h, w, scale, seed=0):
    """(r, 5) rois in image coordinates over (n, ., h, w) features at
    ``scale``: a batch index, then x1 <= x2 and y1 <= y2, some reaching
    past the map."""
    rs = np.random.RandomState(seed)
    b = rs.randint(0, n, r)
    x1 = rs.uniform(-2, w / scale, r)
    y1 = rs.uniform(-2, h / scale, r)
    x2 = x1 + rs.uniform(0, w / scale, r)
    y2 = y1 + rs.uniform(0, h / scale, r)
    return np.stack([b, x1, y1, x2, y2], 1).astype(np.float32)


@pytest.mark.parametrize("pooled,scale,seed", [
    ((3, 2), 0.5, 0), ((7, 7), 1.0 / 16, 1), ((2, 3), 1.0, 2)])
def test_roi_pooling_matches_jax(pooled, scale, seed):
    """Fast R-CNN's max pooling over rois (round-half-up coordinates, a
    0-based batch index, 0 in an empty bin): the output and the features'
    gradient."""
    h, w = 12, 14
    data = _randn(2, 3, h, w, seed=seed)
    rois = _rois(9, 2, h, w, scale, seed)
    rois[0, 1:] = [w / scale + 5, 1, w / scale + 8, 3]    # off the map
    jm = jnn.RoiPooling(pooled[0], pooled[1], scale)
    pm = nn.RoiPooling(pooled[0], pooled[1], scale)
    y, _ = check_module(jm, pm, [data, rois], FWD, BWD)
    assert y[0].shape == (9, 3, pooled[1], pooled[0])
    assert (y[0][0] == 0).all()


def test_roi_pooling_splits_a_tie_across_rows_per_stage():
    """A documented difference: the port's two maxima split a tie's
    gradient evenly at each stage, so three tied pixels of one bin, two
    in one row and one in the next, get 1/4, 1/4 and 1/2; the JAX
    module's single maximum gives each 1/3.  The forward is the same."""
    data = np.zeros((1, 1, 4, 4), np.float32)
    data[0, 0, 0, 0] = data[0, 0, 0, 1] = data[0, 0, 1, 0] = 5.0
    rois = np.asarray([[0, 0, 0, 1, 1]], np.float32)     # one 2x2 bin
    jm, pm = jnn.RoiPooling(1, 1, 1.0), nn.RoiPooling(1, 1, 1.0)

    def jax_out(v):
        return jm.apply({}, _jt(v, rois), {}, EVAL)[0]

    dx_j = np.asarray(jax.grad(lambda v: jax_out(v).sum())(
        jnp.asarray(data)))
    d = torch.from_numpy(data).requires_grad_()
    y = pm(Table(d, torch.from_numpy(rois)))
    y.sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(),
                                  np.asarray(jax_out(jnp.asarray(data))))
    np.testing.assert_allclose(dx_j[0, 0, :2, :2], [[1 / 3, 1 / 3],
                                                    [1 / 3, 0]], **FWD)
    np.testing.assert_allclose(d.grad.numpy()[0, 0, :2, :2],
                               [[0.25, 0.25], [0.5, 0]], **FWD)


def test_max_and_min_split_a_tie_as_jax():
    """At a tie ``Max`` and ``Min`` give each tied entry an equal share of
    the gradient, as JAX's reductions do (``x.max(dim)`` would give it
    all to one)."""
    x = np.asarray([[1.0, 3.0, 3.0], [2.0, 2.0, 2.0], [0.0, -1.0, 0.0]],
                   np.float32)
    for name in ("Max", "Min"):
        _, dx = check_module(getattr(jnn, name)(2), getattr(nn, name)(2), x,
                             FWD, BWD)
        assert np.count_nonzero(dx[0][1]) == 3


def test_masked_select_forward_and_its_documented_gradient():
    """``MaskedSelect``'s forward equals the JAX module's; the JAX module
    computes in numpy, so no gradient flows there, while the port's
    backward scatters the gradient into zeros at the selected entries."""
    src = _randn(3, 4)
    mask = (np.random.RandomState(1).rand(3, 4) > 0.5).astype(np.uint8)
    want = jnn.MaskedSelect().forward(_jt(src, mask))
    s = torch.from_numpy(src).requires_grad_()
    got = nn.MaskedSelect()(Table(s, torch.from_numpy(mask)))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    g = torch.arange(1.0, got.numel() + 1)
    got.backward(g)
    expect = np.zeros_like(src)
    expect[mask != 0] = g.numpy()
    np.testing.assert_array_equal(s.grad.numpy(), expect)
    with pytest.raises(Exception):
        jax.grad(lambda v: jnn.MaskedSelect().apply(
            {}, _jt(v, mask), {}, EVAL)[0].sum())(jnp.asarray(src))


def _jt(*xs):
    from bigdl_tpu.utils.table import T
    return T(*[jnp.asarray(x) for x in xs])


def test_l1_penalty_is_the_identity_with_a_sign_gradient():
    x = _randn(3, 4)
    xt = torch.from_numpy(x).requires_grad_()
    y = nn.L1Penalty(0.3, True)(xt)
    assert torch.equal(y, xt)
    y.backward(torch.ones(3, 4))
    np.testing.assert_allclose(xt.grad.numpy(),
                               1 + 0.3 / 12 * np.sign(x), **FWD)


def test_bilinear_filler_draws_the_jax_kernel():
    """``SpatialFullConvolution(init_method=BilinearFiller)`` starts from
    the JAX module's kernel (no draw) and a zero bias."""
    jm = jnn.SpatialFullConvolution(3, 4, 4, 4, 2, 2, 1, 1,
                                    init_method=jnn.BilinearFiller)
    pm = nn.SpatialFullConvolution(3, 4, 4, 4, 2, 2, 1, 1,
                                   init_method=nn.BilinearFiller,
                                   device="cpu")
    np.testing.assert_array_equal(pm.weight.detach().numpy(),
                                  np.asarray(jm.params()["~"]["weight"]))
    assert not pm.bias.detach().any()
    np.testing.assert_array_equal(
        nn.init.bilinear_filler((2, 1, 3, 5)).numpy(),
        jnn.init.bilinear_filler((2, 1, 3, 5)))
    assert nn.InitializationMethod.BILINEAR_FILLER == nn.BilinearFiller


def test_convolution_map_gradient_is_zero_outside_the_table():
    conn = _conn()
    pm = nn.SpatialConvolutionMap(conn, 5, 5, device="cpu")
    mask = np.zeros((16, 6), bool)
    mask[conn[:, 1] - 1, conn[:, 0] - 1] = True
    assert not pm.weight.detach().numpy()[~mask].any()
    pm(torch.from_numpy(_randn(2, 6, 14, 14))).sum().backward()
    g = pm.weight.grad.numpy()
    assert not g[~mask].any() and g[mask].any()
    assert (mask.sum(1) == 3).all()


def test_map_table_builders_match_jax():
    np.testing.assert_array_equal(nn.SpatialConvolutionMap.full(3, 2),
                                  jnn.SpatialConvolutionMap.full(3, 2))
    np.testing.assert_array_equal(nn.SpatialConvolutionMap.one_to_one(4),
                                  jnn.SpatialConvolutionMap.one_to_one(4))


@pytest.mark.parametrize("n,threshold,seed", [
    (40, 0.5, 0), (200, 0.7, 1), (64, 0.3, 2), (1, 0.7, 3)])
def test_nms_matches_jax(n, threshold, seed):
    """The keep mask, the kept indices by score and ``Nms``, against the
    JAX greedy loop."""
    rs = np.random.RandomState(seed)
    xy = rs.uniform(0, 100, (n, 2))
    boxes = np.concatenate([xy, xy + rs.uniform(5, 40, (n, 2))],
                           1).astype(np.float32)
    scores = rs.rand(n).astype(np.float32)
    want = np.asarray(jax_nms.nms_mask(jnp.asarray(boxes),
                                       jnp.asarray(scores), threshold))
    got = nn.nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores),
                      threshold)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        nn.nms_indices(boxes, scores, threshold).numpy(),
        jax_nms.nms_indices(boxes, scores, threshold))
    np.testing.assert_array_equal(
        nn.Nms(threshold)(torch.from_numpy(boxes), scores).numpy(),
        jnn.Nms(threshold)(boxes, scores))
    assert torch.equal(nn.Nms(threshold).keep_mask(boxes, scores), got)


def test_nms_resolves_a_chain_of_suppressions():
    """Boxes in a row, each overlapping the next by more than the
    threshold, scores falling: greedy keeps every other one."""
    boxes = np.asarray([[10 * i, 0, 10 * i + 16, 10] for i in range(9)],
                       np.float32)
    scores = np.linspace(1.0, 0.1, 9).astype(np.float32)
    got = nn.nms_mask(boxes, scores, 0.2).numpy()
    np.testing.assert_array_equal(got, np.arange(9) % 2 == 0)
    np.testing.assert_array_equal(
        got, np.asarray(jax_nms.nms_mask(jnp.asarray(boxes),
                                         jnp.asarray(scores), 0.2)))


@pytest.mark.parametrize("build", [
    lambda **d: nn.Bilinear(3, 2, 4, **d), lambda **d: nn.CMul((2, 3), **d),
    lambda **d: nn.CAdd((3,), **d), lambda **d: nn.Mul(**d),
    lambda **d: nn.Add(3, **d), lambda **d: nn.Cosine(3, 2, **d),
    lambda **d: nn.Euclidean(3, 2, **d),
    lambda **d: nn.LookupTable(5, 2, **d),
    lambda **d: nn.SpatialDilatedConvolution(2, 2, 3, 3, **d),
    lambda **d: nn.SpatialFullConvolution(2, 2, 3, 3, **d),
    lambda **d: nn.SpatialConvolutionMap(
        nn.SpatialConvolutionMap.full(2, 2), 3, 3, **d)],
    ids=["Bilinear", "CMul", "CAdd", "Mul", "Add", "Cosine", "Euclidean",
         "LookupTable", "SpatialDilatedConvolution",
         "SpatialFullConvolution", "SpatialConvolutionMap"])
def test_parameterised_layers_default_to_the_card(build):
    """A new parameterised layer is made on the card unless the CPU is
    asked for; with no card that is an error, not the CPU."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()
    m = build(device="cpu", generator=torch.Generator().manual_seed(0))
    assert all(p.device.type == "cpu" for p in m.parameters())
    again = build(device="cpu", generator=torch.Generator().manual_seed(0))
    for a, b in zip(m.parameters(), again.parameters()):
        assert torch.equal(a, b)


def test_every_jax_layer_is_ported():
    """Every class of the JAX ``nn`` but ``MoE`` has its counterpart in
    the port, a ``Module`` where the JAX one is a ``Module``, and this
    file holds each layer the slice adds."""
    jax_names = {n for n in jnn.__dict__ if isinstance(jnn.__dict__[n], type)
                 and n not in ("MoE", "Context")}
    assert all(hasattr(nn, n) for n in jax_names)
    for n in jax_names:
        if issubclass(jnn.__dict__[n], jnn.Module):
            assert issubclass(getattr(nn, n), nn.Module), n
    held = {type(c[1](jnn)).__name__ for c in LAYERS} | {"RoiPooling"}
    new = {"Bilinear", "CMul", "CAdd", "Mul", "Add", "AddConstant", "MM",
           "MV", "Cosine", "Euclidean", "LookupTable", "InferReshape",
           "Transpose", "Replicate", "Squeeze", "Unsqueeze", "Padding",
           "SpatialZeroPadding", "Contiguous", "Copy", "Echo", "Sum", "Max",
           "Min", "Index", "Select", "Narrow", "L1Penalty",
           "SpatialShareConvolution", "SpatialDilatedConvolution",
           "SpatialFullConvolution", "SpatialConvolutionMap",
           "SpatialSubtractiveNormalization",
           "SpatialDivisiveNormalization",
           "SpatialContrastiveNormalization", "RoiPooling"}
    assert new <= held


def test_lookup_table_max_norm_rescales_without_touching_the_weight():
    """The documented choice: ``max_norm`` rescales the rows in the
    forward, differentiably (the JAX module's), and leaves the stored
    table as it was (Torch renormalises it in place)."""
    m = nn.LookupTable(6, 3, max_norm=0.5, device="cpu",
                       generator=torch.Generator().manual_seed(1))
    before = m.weight.detach().clone()
    y = m(torch.tensor([1, 2, 6]))
    assert torch.equal(m.weight, before)
    assert (torch.linalg.vector_norm(y, dim=1) <= 0.5 + 1e-6).all()
    assert set(export_params(m)["~"]) == {"weight"}
