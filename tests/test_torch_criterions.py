"""The port's criterion inventory (bigdl_tpu_torch/nn/criterion.py)
against the JAX package's (bigdl_tpu/nn/criterion.py): all 23 criteria,
the loss and the input's gradient (each element's, for a Table input) on
the same seeded numpy inputs, 1-based class targets, Table inputs and
targets; each tensor criterion again under ``TimeDistributedCriterion``
(the port's ``torch.func.vmap`` against the JAX ``jax.vmap``); the
derivative at the ties and kinks the JAX criteria set; ``backward`` on a
Table input; and a list taken as the Table of its elements.
Tolerances: the loss rtol 1e-5 / atol 1e-6, the gradients rtol 1e-4 /
atol 1e-5 (tests/test_criterions.py holds the JAX criteria at rel 1e-4
to 1e-5)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.utils.table import T as JT
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.utils.table import Table
from tests.helpers.torch_parity import check_criterion
from tests.helpers.torch_parity import keep_torch_rng  # noqa: F401

FWD = dict(rtol=1e-5, atol=1e-6)
BWD = dict(rtol=1e-4, atol=1e-5)


def _rs(seed):
    return np.random.RandomState(seed)


def _randn(*shape, seed=0):
    return _rs(seed).randn(*shape).astype(np.float32)


def _probs(*shape, seed=0):
    return _rs(seed).uniform(0.05, 0.95, shape).astype(np.float32)


def _log_softmax(x):
    return np.asarray(torch.log_softmax(torch.from_numpy(x), -1))


def _sign(*shape, seed=0):
    return np.where(_rs(seed).rand(*shape) > 0.5, 1.0, -1.0).astype(
        np.float32)


def _classes(n, c, seed=0):
    return _rs(seed).randint(1, c + 1, n).astype(np.int64)


_W5 = [0.5, 1.0, 2.0, 0.25, 1.5]
_MULTI_LABEL = np.asarray([[3, 1, 0, 0, 0], [2, 0, 0, 0, 0],
                           [5, 4, 3, 0, 0], [1, 2, 3, 4, 5]], np.int64)


def _with(c, *pairs):
    for crit, w in pairs:
        c.add(crit, w)
    return c


# (id, builder of (JAX criterion, port criterion), input, target)
CASES = [
    ("MSE", lambda m: m.MSECriterion(), _randn(4, 5), _randn(4, 5, seed=1)),
    ("MSE_sum", lambda m: m.MSECriterion(size_average=False), _randn(4, 5),
     _randn(4, 5, seed=1)),
    ("Abs", lambda m: m.AbsCriterion(), _randn(4, 5), _randn(4, 5, seed=1)),
    ("Abs_sum", lambda m: m.AbsCriterion(False), _randn(4, 5),
     _randn(4, 5, seed=1)),
    ("BCE", lambda m: m.BCECriterion(), _probs(4, 5),
     (_rs(1).rand(4, 5) > 0.5).astype(np.float32)),
    ("BCE_weights_sum", lambda m: m.BCECriterion(_W5, size_average=False),
     _probs(4, 5), (_rs(1).rand(4, 5) > 0.5).astype(np.float32)),
    ("DistKLDiv", lambda m: m.DistKLDivCriterion(),
     _log_softmax(_randn(4, 5)),
     np.where(_rs(2).rand(4, 5) > 0.3, _probs(4, 5, seed=1), 0.0).astype(
         np.float32)),
    ("DistKLDiv_sum", lambda m: m.DistKLDivCriterion(False),
     _log_softmax(_randn(4, 5)), _probs(4, 5, seed=1)),
    ("ClassSimplex", lambda m: m.ClassSimplexCriterion(5), _randn(6, 5),
     _classes(6, 5)),
    ("CosineEmbedding", lambda m: m.CosineEmbeddingCriterion(0.1),
     [_randn(6, 5), _randn(6, 5, seed=1)], _sign(6)),
    ("CosineEmbedding_1d", lambda m: m.CosineEmbeddingCriterion(-0.2),
     [_randn(5), _randn(5, seed=1)], np.asarray([-1.0], np.float32)),
    ("HingeEmbedding", lambda m: m.HingeEmbeddingCriterion(1.0),
     _randn(8), _sign(8)),
    ("HingeEmbedding_sum", lambda m: m.HingeEmbeddingCriterion(0.5, False),
     _randn(3, 4), _sign(3, 4)),
    ("L1HingeEmbedding", lambda m: m.L1HingeEmbeddingCriterion(4.0),
     [_randn(6, 5), _randn(6, 5, seed=1)], _sign(6)),
    ("Margin", lambda m: m.MarginCriterion(), _randn(8), _sign(8)),
    ("Margin_sum", lambda m: m.MarginCriterion(0.5, False), _randn(3, 4),
     _sign(3, 4)),
    ("MarginRanking", lambda m: m.MarginRankingCriterion(0.5),
     [_randn(8), _randn(8, seed=1)], _sign(8)),
    ("MarginRanking_table_target",
     lambda m: m.MarginRankingCriterion(0.2, False),
     [_randn(8), _randn(8, seed=1)], [_sign(8)]),
    ("Multi", lambda m: _with(m.MultiCriterion(), (m.MSECriterion(), 0.3),
                              (m.AbsCriterion(), 0.7)),
     _randn(4, 5), _randn(4, 5, seed=1)),
    ("Parallel", lambda m: _with(m.ParallelCriterion(),
                                 (m.MSECriterion(), 0.5),
                                 (m.ClassNLLCriterion(), 1.0)),
     [_randn(4, 5), _log_softmax(_randn(4, 3, seed=1))],
     [_randn(4, 5, seed=2), _classes(4, 3)]),
    ("Parallel_repeat", lambda m: _with(m.ParallelCriterion(True),
                                        (m.MSECriterion(), 0.5),
                                        (m.AbsCriterion(), 2.0)),
     [_randn(4, 5), _randn(4, 5, seed=1)], _randn(4, 5, seed=2)),
    ("MultiLabelMargin", lambda m: m.MultiLabelMarginCriterion(),
     _randn(4, 5), _MULTI_LABEL),
    ("MultiLabelMargin_1d", lambda m: m.MultiLabelMarginCriterion(False),
     _randn(5), _MULTI_LABEL[2]),
    ("MultiLabelSoftMargin", lambda m: m.MultiLabelSoftMarginCriterion(),
     _randn(4, 5) * 3, (_rs(1).rand(4, 5) > 0.5).astype(np.float32)),
    ("MultiLabelSoftMargin_weights",
     lambda m: m.MultiLabelSoftMarginCriterion(_W5, size_average=False),
     _randn(4, 5) * 3, (_rs(1).rand(4, 5) > 0.5).astype(np.float32)),
    ("MultiMargin", lambda m: m.MultiMarginCriterion(), _randn(6, 5),
     _classes(6, 5)),
    ("MultiMargin_p2_weights",
     lambda m: m.MultiMarginCriterion(2, _W5, 0.5, False), _randn(6, 5),
     _classes(6, 5)),
    ("SmoothL1", lambda m: m.SmoothL1Criterion(), _randn(4, 5) * 2,
     _randn(4, 5, seed=1)),
    ("SmoothL1_sum", lambda m: m.SmoothL1Criterion(False), _randn(4, 5) * 2,
     _randn(4, 5, seed=1)),
    ("SmoothL1WithWeights", lambda m: m.SmoothL1CriterionWithWeights(2.0),
     _randn(4, 8), [_randn(4, 8, seed=1), _probs(4, 8, seed=2),
                    _probs(4, 8, seed=3)]),
    ("SmoothL1WithWeights_num",
     lambda m: m.SmoothL1CriterionWithWeights(0.5, 10), _randn(4, 8) * 3,
     _randn(4, 8, seed=1)),
    ("SoftMargin", lambda m: m.SoftMarginCriterion(), _randn(8) * 3,
     _sign(8)),
    ("SoftMargin_sum", lambda m: m.SoftMarginCriterion(False),
     _randn(3, 4) * 3, _sign(3, 4)),
    ("SoftmaxWith", lambda m: m.SoftmaxWithCriterion(),
     _randn(2, 4, 3, 3), _rs(1).randint(1, 5, (2, 3, 3))),
    ("SoftmaxWith_ignore", lambda m: m.SoftmaxWithCriterion(2),
     _randn(2, 4, 3, 3), _rs(1).randint(1, 5, (2, 3, 3))),
    ("SoftmaxWith_batch_size",
     lambda m: m.SoftmaxWithCriterion(3, "batch_size"), _randn(2, 4, 3, 3),
     _rs(1).randint(1, 5, (2, 3, 3))),
    ("SoftmaxWith_full", lambda m: m.SoftmaxWithCriterion(1, "full"),
     _randn(2, 4, 3, 3), _rs(1).randint(1, 5, (2, 3, 3))),
    ("SoftmaxWith_ignore_255", lambda m: m.SoftmaxWithCriterion(255),
     _randn(2, 4, 3, 3), np.where(_rs(2).rand(2, 3, 3) > 0.7, 255,
                                  _rs(1).randint(1, 5, (2, 3, 3)))),
    ("SoftmaxWith_none", lambda m: m.SoftmaxWithCriterion(None, "none"),
     _randn(5, 4), _classes(5, 4)),
    ("L1Cost", lambda m: m.L1Cost(), _randn(4, 5), _randn(4, 5, seed=1)),
    ("ClassNLL", lambda m: m.ClassNLLCriterion(), _log_softmax(_randn(6, 5)),
     _classes(6, 5)),
    ("CrossEntropy_weights", lambda m: m.CrossEntropyCriterion(_W5),
     _randn(6, 5), _classes(6, 5)),
]


@pytest.mark.parametrize("name,build,x,target", CASES,
                         ids=[c[0] for c in CASES])
def test_matches_jax(name, build, x, target):
    """The loss and the input's gradient against the JAX criterion."""
    check_criterion(build(jnn), build(nn), x, target, FWD, BWD)


def test_every_jax_criterion_is_ported():
    """The JAX module's 23 criteria, class for class, each held above."""
    names = {n for n in dir(jnn.criterion)
             if isinstance(getattr(jnn.criterion, n), type)
             and issubclass(getattr(jnn.criterion, n), jnn.Criterion)
             and n != "Criterion"}
    assert len(names) == 23
    held = {type(c[1](nn)).__name__ for c in CASES} | {
        "TimeDistributedCriterion"}
    assert names <= held
    for n in names:
        assert issubclass(getattr(nn, n), nn.Criterion), n


# (id, builder, per-step input shape (N, ...), target maker): each tensor
# criterion over a (N, T, ...) input, the target per step where it has
# more than one dim
TD_CASES = [
    ("MSE", lambda m: m.MSECriterion(), (4, 5), lambda s: _randn(*s, seed=1)),
    ("Abs", lambda m: m.AbsCriterion(), (4, 5), lambda s: _randn(*s, seed=1)),
    ("BCE", lambda m: m.BCECriterion(_W5), (4, 5),
     lambda s: (_rs(1).rand(*s) > 0.5).astype(np.float32)),
    ("DistKLDiv", lambda m: m.DistKLDivCriterion(), (4, 5),
     lambda s: _probs(*s, seed=1)),
    ("ClassSimplex", lambda m: m.ClassSimplexCriterion(5), (4, 5),
     lambda s: _rs(1).randint(1, 6, s[:2])),
    ("HingeEmbedding", lambda m: m.HingeEmbeddingCriterion(), (4,),
     lambda s: _sign(*s)),
    ("Margin", lambda m: m.MarginCriterion(), (4,), lambda s: _sign(*s)),
    ("MultiLabelMargin", lambda m: m.MultiLabelMarginCriterion(), (4, 5),
     lambda s: np.repeat(_MULTI_LABEL[:, None], s[1], axis=1)),
    ("MultiLabelSoftMargin", lambda m: m.MultiLabelSoftMarginCriterion(),
     (4, 5), lambda s: (_rs(1).rand(*s) > 0.5).astype(np.float32)),
    ("MultiMargin", lambda m: m.MultiMarginCriterion(2, _W5), (4, 5),
     lambda s: _rs(1).randint(1, 6, s[:2])),
    ("SmoothL1", lambda m: m.SmoothL1Criterion(), (4, 5),
     lambda s: _randn(*s, seed=1) * 2),
    ("SmoothL1WithWeights", lambda m: m.SmoothL1CriterionWithWeights(2.0),
     (4, 5), lambda s: _randn(*s, seed=1)),
    ("SoftMargin", lambda m: m.SoftMarginCriterion(), (4,),
     lambda s: _sign(*s)),
    ("SoftmaxWith", lambda m: m.SoftmaxWithCriterion(2), (4, 5),
     lambda s: _rs(1).randint(1, 6, s[:2])),
    ("L1Cost", lambda m: m.L1Cost(), (4, 5), lambda s: _randn(*s, seed=1)),
    ("MultiCriterion", lambda m: _with(m.MultiCriterion(),
                                       (m.MSECriterion(), 0.3),
                                       (m.SmoothL1Criterion(), 0.7)),
     (4, 5), lambda s: _randn(*s, seed=1)),
]


@pytest.mark.parametrize("name,build,step,make_target", TD_CASES,
                         ids=[c[0] for c in TD_CASES])
@pytest.mark.parametrize("size_average", [False, True])
def test_time_distributed_vmaps_each_criterion(name, build, step,
                                               make_target, size_average):
    """``TimeDistributedCriterion`` over 3 steps of each tensor
    criterion: one ``torch.func.vmap`` over time, against the JAX
    ``jax.vmap``."""
    shape = (step[0], 3) + step[1:]
    x = _randn(*shape) * 2
    if name == "DistKLDiv":
        x = _log_softmax(x)
    if name == "BCE":
        x = _probs(*shape)
    check_criterion(jnn.TimeDistributedCriterion(build(jnn), size_average),
                    nn.TimeDistributedCriterion(build(nn), size_average),
                    x, make_target(shape), FWD, BWD)


# (id, builder, input, target): inputs on the tie or kink of the JAX
# derivative: jnp.maximum(0, v) at v = 0 gives 1/2, jnp.abs at 0 gives 1
KINKS = [
    ("Hinge_at_margin", lambda m: m.HingeEmbeddingCriterion(1.0),
     np.asarray([1.0, 0.5, 1.0, -2.0], np.float32),
     np.asarray([-1.0, -1.0, -1.0, 1.0], np.float32)),
    ("Margin_at_margin", lambda m: m.MarginCriterion(1.0),
     np.asarray([1.0, -1.0, 0.5], np.float32),
     np.asarray([1.0, -1.0, 1.0], np.float32)),
    ("Abs_at_zero", lambda m: m.AbsCriterion(),
     np.asarray([0.5, -1.0, 2.0], np.float32),
     np.asarray([0.5, -1.0, 1.0], np.float32)),
    ("L1Cost_at_zero", lambda m: m.L1Cost(),
     np.asarray([0.0, -1.0, 2.0], np.float32),
     np.zeros(3, np.float32)),
    ("SmoothL1_at_one", lambda m: m.SmoothL1Criterion(),
     np.asarray([1.0, 0.0, -1.0, 3.0], np.float32),
     np.zeros(4, np.float32)),
    ("MarginRanking_at_margin", lambda m: m.MarginRankingCriterion(1.0),
     [np.asarray([2.0, 0.0], np.float32), np.asarray([1.0, 1.0],
                                                     np.float32)],
     np.asarray([1.0, -1.0], np.float32)),
    ("L1HingeEmbedding_at_zero_distance",
     lambda m: m.L1HingeEmbeddingCriterion(1.0),
     [np.asarray([[1.0, 2.0]], np.float32),
      np.asarray([[1.0, 2.0]], np.float32)], np.asarray([1.0], np.float32)),
]


@pytest.mark.parametrize("name,build,x,target", KINKS,
                         ids=[k[0] for k in KINKS])
def test_derivative_at_the_kinks_is_the_jax_one(name, build, x, target):
    """Where ``clamp`` or ``torch.abs`` would give another derivative
    than the JAX criterion's, the port's is the JAX one."""
    check_criterion(build(jnn), build(nn), x, target, FWD, BWD)


def test_backward_on_a_table_input_gives_a_table():
    """``Criterion.backward`` of a Table input: the Table of each
    element's gradient, equal to the JAX criterion's."""
    a, b, y = _randn(6, 5), _randn(6, 5, seed=1), _sign(6)
    jg = jnn.CosineEmbeddingCriterion(0.1).backward(
        JT(jnp.asarray(a), jnp.asarray(b)), jnp.asarray(y))
    pg = nn.CosineEmbeddingCriterion(0.1).backward(
        [torch.from_numpy(a), torch.from_numpy(b)], torch.from_numpy(y))
    assert isinstance(pg, Table) and pg.length() == 2
    for i in (1, 2):
        np.testing.assert_allclose(pg[i].numpy(), np.asarray(jg[i]), **BWD)


def test_backward_on_a_tensor_input():
    x, t = _randn(4, 5), _randn(4, 5, seed=1)
    want = jnn.SmoothL1Criterion().backward(jnp.asarray(x), jnp.asarray(t))
    got = nn.SmoothL1Criterion().backward(torch.from_numpy(x),
                                          torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BWD)


def test_a_list_input_is_the_table_of_its_elements():
    """A list given where a Table is taken is 1-based like one:
    ``input[1]`` is its first element."""
    a, b, y = _randn(8), _randn(8, seed=1), _sign(8)
    c = nn.MarginRankingCriterion(0.5)
    ta, tb, ty = map(torch.from_numpy, (a, b, y))
    assert torch.equal(c.forward([ta, tb], ty),
                       c.forward(Table(ta, tb), ty))
    assert not torch.equal(c.forward([ta, tb], ty),
                           c.forward([tb, ta], ty))
