"""Seeded dropout (bigdl_tpu_torch/nn/dropout.py, utils/random.py): the
mask comes from the package stream ``RNG``, as the JAX package draws it
from its seeded key stream, so one ``RNG.set_seed`` gives one training
trajectory and another seed another; PyTorch's global generator plays no
part.  Bit equality with the JAX masks is out of reach (the generators
differ); the keep rate and the 1/(1-p) scale are the JAX module's.
"""
import numpy as np
import pytest
import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToBatch
from bigdl_tpu_torch.optim import Optimizer, max_iteration
from bigdl_tpu_torch.utils.random import RNG, generator, set_seed
from bigdl_tpu_torch.utils.table import T


def _model():
    return nn.Sequential(nn.Linear(6, 16, device="cpu",
                                   generator=generator(0)),
                         nn.ReLU(), nn.Dropout(0.4),
                         nn.Linear(16, 3, device="cpu",
                                   generator=generator(1)),
                         nn.LogSoftMax())


def _train(seed, reseed_torch=None):
    """Four SGD steps of a Dropout(0.4) model after ``RNG.set_seed(seed)``;
    the losses, the final parameters and each step's zero pattern after
    the dropout (its mask and the ReLU's)."""
    rs = np.random.RandomState(0)
    samples = [Sample(rs.randn(6).astype(np.float32),
                      np.asarray([rs.randint(3) + 1.0])) for _ in range(32)]
    RNG.set_seed(seed)
    if reseed_torch is not None:
        torch.manual_seed(reseed_torch)
    model = _model()
    masks = []
    model.get(3).register_forward_hook(
        lambda m, i, o: masks.append((o != 0).clone()))
    opt = Optimizer(model, DataSet.array(samples) >> SampleToBatch(8),
                    nn.ClassNLLCriterion(), state=T(learningRate=0.1),
                    end_trigger=max_iteration(4), device="cpu")
    opt.optimize()
    return ([l for _, l in opt.loss_log],
            [p.detach().clone() for p in model.parameters()], masks)


def test_one_seed_gives_one_trajectory():
    losses, params, masks = _train(5)
    again = _train(5, reseed_torch=123)     # the global generator moved
    assert len(masks) == 4
    assert losses == again[0]
    assert all(torch.equal(a, b) for a, b in zip(params, again[1]))
    assert all(torch.equal(a, b) for a, b in zip(masks, again[2]))


def test_two_seeds_give_two_trajectories():
    losses, params, masks = _train(5)
    other = _train(6)
    assert not all(torch.equal(a, b) for a, b in zip(masks, other[2]))
    assert losses != other[0]
    assert not all(torch.equal(a, b) for a, b in zip(params, other[1]))


def test_global_generator_changes_nothing():
    """torch.manual_seed between draws leaves the package stream alone;
    set_seed restarts it."""
    d = nn.Dropout(0.4)
    x = torch.ones(64, 64)
    set_seed(3)
    first = [d(x) for _ in range(3)]
    set_seed(3)
    torch.manual_seed(0)
    a = d(x)
    torch.manual_seed(0)
    b = d(x)
    assert torch.equal(a, first[0]) and torch.equal(b, first[1])
    assert not torch.equal(a, b)
    assert RNG.get_seed() == 3


@pytest.mark.parametrize("p", [0.2, 0.4, 0.75])
def test_keep_rate_and_scale(p):
    """Kept units scale by 1/(1-p) and about 1-p of them are kept; in
    evaluate() mode, and at p = 0, the identity."""
    d = nn.Dropout(p)
    x = torch.rand(200, 500) + 0.5
    set_seed(9)
    y = d(x)
    kept = y != 0
    torch.testing.assert_close(y[kept], x[kept] / (1 - p))
    assert abs(float(kept.float().mean()) - (1 - p)) < 0.01
    assert d.evaluate()(x) is x
    assert nn.Dropout(0.0)(x) is x

