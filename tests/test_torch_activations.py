"""The port's activation inventory (bigdl_tpu_torch/nn/activations.py)
against the JAX package's (bigdl_tpu/nn/activations.py): all 27 classes,
forward and input gradient (and PReLU's weight gradient) on the same
seeded numpy input, then the derivative at each class's kinks, which
pins the JAX derivative (a clip's bound 1/2, ReLU's 0 at 0, abs and
LeakyReLU 1 at 0, a shrink's and the threshold's 0 at their points).
RReLU draws its training slopes from the port's own stream (no bit
equality with the JAX draws, as with Dropout): its evaluation mode is
held to the JAX module's and its training mode to its contract.  The
element-wise classes' ``act()`` descriptors are the ``ops.Act`` the RNN
kernel applies.  Tolerances: forward rtol 1e-5 / atol 1e-6, gradients
rtol 1e-4 / atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.nn.module import Context
from bigdl_tpu_torch import nn, ops
from bigdl_tpu_torch.nn.module import load_jax_params
from bigdl_tpu_torch.utils.random import RNG

FWD = dict(rtol=1e-5, atol=1e-6)
BWD = dict(rtol=1e-4, atol=1e-5)
# (class, constructor arguments, input domain): "pos" keeps the input
# inside the domain of Sqrt, Log and a fractional Power
CASES = [
    ("ReLU", (), "any"), ("ReLU6", (), "any"), ("Tanh", (), "any"),
    ("TanhShrink", (), "any"), ("Sigmoid", (), "any"),
    ("LogSigmoid", (), "any"), ("LogSoftMax", (), "any"),
    ("SoftMax", (), "any"), ("SoftMin", (), "any"),
    ("SoftPlus", (2.0,), "any"), ("SoftSign", (), "any"),
    ("SoftShrink", (0.5,), "any"), ("HardShrink", (0.5,), "any"),
    ("HardTanh", (-0.5, 1.5), "any"), ("Clamp", (-1, 2), "any"),
    ("Threshold", (0.1, -0.3), "any"), ("LeakyReLU", (0.05,), "any"),
    ("ELU", (0.7,), "any"), ("Abs", (), "any"), ("Sqrt", (), "pos"),
    ("Square", (), "any"), ("Power", (2.5, 0.5, 1.0), "pos"),
    ("Power", (2,), "any"), ("Exp", (), "any"), ("Log", (), "pos"),
    ("PReLU", (0,), "any"), ("PReLU", (3,), "any"),
    ("RReLU", (), "any"), ("GradientReversal", (0.7,), "any"),
]
EVAL = Context(training=False, key=jax.random.PRNGKey(0))


def _jax_run(jm, x, g):
    """(y, dx, dparams) of the JAX module in evaluation mode under
    (y * g).sum()."""
    def loss(p, v):
        return (jm.apply(p, v, jm.state(), EVAL)[0] * g).sum()
    y = np.asarray(jm.apply(jm.params(), jnp.asarray(x), jm.state(),
                            EVAL)[0])
    dp, dx = jax.grad(loss, argnums=(0, 1))(jm.params(), jnp.asarray(x))
    return y, np.asarray(dx), dp


def _port_run(pm, x, g):
    xt = torch.from_numpy(x).requires_grad_()
    y = pm(xt)
    (y * torch.from_numpy(g)).sum().backward()
    return y.detach().numpy(), xt.grad.numpy()


def _compare(name, args, x, seed=1):
    jm = getattr(jnn, name)(*args)
    pm = getattr(nn, name)(*args).evaluate()
    load_jax_params(pm, jax.tree_util.tree_map(np.asarray, jm.params()))
    g = np.random.RandomState(seed).randn(*x.shape).astype(np.float32)
    y_j, dx_j, dp_j = _jax_run(jm, x, g)
    y, dx = _port_run(pm, x, g)
    assert y.shape == y_j.shape
    np.testing.assert_allclose(y, y_j, **FWD)
    np.testing.assert_allclose(dx, dx_j, **BWD)
    if name == "PReLU":
        np.testing.assert_allclose(pm.weight.grad.numpy(),
                                   np.asarray(dp_j["~"]["weight"]), **BWD)
    return pm


@pytest.mark.parametrize("name,args,domain", CASES,
                         ids=[f"{c[0]}{c[1]}" for c in CASES])
def test_matches_jax(name, args, domain):
    """Forward and input gradient (PReLU: and its weight's) of each class
    against the JAX one on a seeded (4, 3, 5) input."""
    x = np.random.RandomState(0).randn(4, 3, 5).astype(np.float32)
    if domain == "pos":
        x = np.abs(x) + 0.1
    _compare(name, args, x)


def test_all_27_classes_are_ported():
    """The JAX module's inventory, class for class."""
    names = {c[0] for c in CASES}
    assert len(names) == 27
    for name in names:
        assert issubclass(getattr(nn, name), nn.TensorModule), name


# (class, arguments, kink points): where the JAX derivative is set by a
# tie or a strict comparison
KINKS = [
    ("ReLU", (), [0.0]), ("ReLU6", (), [0.0, 6.0]),
    ("HardTanh", (-0.5, 1.5), [-0.5, 1.5]), ("Clamp", (-1, 2), [-1.0, 2.0]),
    ("LeakyReLU", (0.05,), [0.0]), ("SoftShrink", (0.5,), [-0.5, 0.5]),
    ("HardShrink", (0.5,), [-0.5, 0.5]), ("Threshold", (0.1, -0.3), [0.1]),
    ("ELU", (0.7,), [0.0]), ("Abs", (), [0.0]), ("SoftSign", (), [0.0]),
    ("PReLU", (0,), [0.0]), ("RReLU", (), [0.0]),
]


@pytest.mark.parametrize("name,args,points", KINKS,
                         ids=[k[0] for k in KINKS])
def test_derivative_at_the_kinks_is_the_jax_one(name, args, points):
    """The input gradient at each kink, beside points just off it, equals
    the JAX one (torch.clamp and torch.abs would give 1 and 0 where JAX
    gives 1/2 and 1)."""
    x = np.asarray([[p + d for p in points for d in (0.0, -0.25, 0.25)]],
                   np.float32)
    pm = _compare(name, args, x)
    if name in ("ReLU6", "HardTanh", "Clamp"):
        xt = torch.from_numpy(x).requires_grad_()
        pm(xt).sum().backward()
        np.testing.assert_array_equal(xt.grad.numpy()[0, ::3], 0.5)


@pytest.mark.parametrize("name,args,want", [
    ("Tanh", (), ops.Act()), ("ReLU", (), ops.Act("relu")),
    ("SoftPlus", (2.0,), ops.Act("softplus", 2.0)),
    ("HardTanh", (-0.5, 1.5), ops.Act("hardtanh", -0.5, 1.5)),
    ("Clamp", (-1, 2), ops.Act("hardtanh", -1.0, 2.0)),
    ("Threshold", (0.1, -0.3), ops.Act("threshold", 0.1, -0.3)),
    ("Power", (2.5, 0.5, 1.0), ops.Act("power", 2.5, 0.5, 1.0)),
])
def test_elementwise_classes_describe_their_kernel_activation(name, args,
                                                              want):
    assert getattr(nn, name)(*args).act() == want


def test_rrelu_training_draws_from_the_package_stream():
    """In training every negative input takes a slope in [lower, upper]
    drawn from ``RNG``: one seed, one output; another seed, another; the
    non-negative inputs pass unchanged."""
    x = torch.from_numpy(np.random.RandomState(2).randn(64, 8)
                         .astype(np.float32))
    m = nn.RReLU(0.1, 0.3)

    def run(seed):
        RNG.set_seed(seed)
        return m(x)

    a, b, c = run(3), run(3), run(4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    neg = x < 0
    slope = a[neg] / x[neg]
    assert float(slope.min()) >= 0.1 and float(slope.max()) <= 0.3
    assert torch.equal(a[~neg], x[~neg])
    m.evaluate()
    np.testing.assert_allclose(m(x)[neg].numpy(), (x[neg] * 0.2).numpy(),
                               **FWD)


def test_gradient_reversal_set_lambda():
    m = nn.GradientReversal().set_lambda(2.5)
    x = torch.ones(3, requires_grad=True)
    m(x).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), -2.5)
