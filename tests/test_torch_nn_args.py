"""Constructor arguments of the port's layers against the JAX package's:
``Linear(with_bias=, init_method=)``, ``Dropout(init_p, inplace, scale)``,
``LayerNorm(affine=)``, ``SpatialConvolution(propagate_back=)`` and
``SinusoidalPositionalEncoding(base=)``, each held on seeded numpy
inputs with its parameters carried from the JAX module (forward, input
and parameter gradients: ``tests/helpers/torch_parity.py``); then every
class both packages' ``nn`` define compared by its constructor's
signature, so the inventory counts arguments as well as classes.
Tolerances: forward rtol 1e-5 / atol 1e-6 (rtol 1e-4 / atol 1e-5 where a
sum's order differs), gradients rtol 1e-4 / atol 1e-5."""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.nn.module import Context
from bigdl_tpu.utils.random import set_seed
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.utils.random import RNG
from tests.helpers.torch_parity import check_module
from tests.helpers.torch_parity import keep_torch_rng  # noqa: F401

FWD = dict(rtol=1e-5, atol=1e-6)
SUM = dict(rtol=1e-4, atol=1e-5)
BWD = dict(rtol=1e-4, atol=1e-5)
CPU = {"device": "cpu"}


def _randn(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# (id, JAX module, port module, input, forward tolerance)
CASES = [
    ("Linear_no_bias", lambda: jnn.Linear(5, 3, with_bias=False),
     lambda: nn.Linear(5, 3, with_bias=False, **CPU), _randn(4, 5), SUM),
    ("Linear_xavier", lambda: jnn.Linear(5, 3, init_method=jnn.Xavier),
     lambda: nn.Linear(5, 3, init_method=nn.Xavier, **CPU), _randn(4, 5),
     SUM),
    ("Linear_positional", lambda: jnn.Linear(5, 3, False, jnn.Xavier),
     lambda: nn.Linear(5, 3, False, nn.Xavier, **CPU), _randn(4, 5), SUM),
    ("Dropout_unscaled_eval", lambda: jnn.Dropout(0.3, False, False),
     lambda: nn.Dropout(0.3, False, False).evaluate(), _randn(4, 5), FWD),
    ("LayerNorm_no_affine", lambda: jnn.LayerNorm(6, 1e-3, affine=False),
     lambda: nn.LayerNorm(6, 1e-3, affine=False, **CPU), _randn(2, 3, 6),
     SUM),
    ("LayerNorm_affine", lambda: jnn.LayerNorm(6, affine=True),
     lambda: nn.LayerNorm(6, affine=True, **CPU), _randn(2, 3, 6), SUM),
    ("SpatialConvolution_propagate_back",
     lambda: jnn.SpatialConvolution(3, 4, 3, 3, 1, 1, 1, 1, 1, False),
     lambda: nn.SpatialConvolution(3, 4, 3, 3, 1, 1, 1, 1, 1, False, **CPU),
     _randn(2, 3, 6, 6), SUM),
    ("SpatialConvolution_positional_tail",
     lambda: jnn.SpatialConvolution(3, 4, 3, 3, 1, 1, 0, 0, 1, True,
                                    jnn.Xavier, False),
     lambda: nn.SpatialConvolution(3, 4, 3, 3, 1, 1, 0, 0, 1, True,
                                   nn.Xavier, False, **CPU),
     _randn(2, 3, 6, 6), SUM),
    ("SinusoidalPositionalEncoding_base",
     lambda: jnn.SinusoidalPositionalEncoding(8, base=500.0),
     lambda: nn.SinusoidalPositionalEncoding(8, base=500.0),
     _randn(2, 7, 8), FWD),
]


@pytest.mark.parametrize("name,jax_build,port_build,x,fwd", CASES,
                         ids=[c[0] for c in CASES])
def test_argument_matches_jax(name, jax_build, port_build, x, fwd):
    set_seed(3)
    jm, pm = jax_build(), port_build()
    assert sorted(n for n, _ in pm.named_parameters(recurse=False)) == \
        sorted(jm.params()["~"])
    check_module(jm, pm, x, fwd, BWD)


def test_xavier_linear_draws_the_weight_only():
    """Xavier draws the weight from U(-sqrt(6/(in+out)), ...) with a zero
    bias; the default draws both (the JAX ``Linear.reset``)."""
    g = torch.Generator().manual_seed(0)
    m = nn.Linear(40, 10, init_method=nn.Xavier, device="cpu", generator=g)
    bound = float(np.sqrt(6.0 / 50))
    w = m.weight.detach()
    assert 0.5 * bound < float(w.abs().max()) <= bound
    assert bool((m.bias == 0).all())
    d = nn.Linear(40, 10, device="cpu", generator=g)
    assert float(d.bias.detach().abs().max()) > 0


def test_unscaled_dropout_keeps_units_as_they_are():
    """In training, ``scale=False`` keeps each unit as it is or zeroes it,
    in the port as in the JAX module (their masks come from different
    generators, so the rule is held, not the mask)."""
    x = _randn(64, 32) + 5.0
    RNG.set_seed(1)
    y = nn.Dropout(0.5, scale=False)(torch.from_numpy(x)).numpy()
    yj, _ = jnn.Dropout(0.5, scale=False).apply(
        {"~": {}}, jnp.asarray(x), {"~": {}},
        Context(training=True, key=jax.random.PRNGKey(0)))
    for out in (y, np.asarray(yj)):
        kept = out != 0
        assert 0.3 < kept.mean() < 0.7
        np.testing.assert_array_equal(out[kept], x[kept])
    scaled = nn.Dropout(0.5)(torch.from_numpy(x)).numpy()
    kept = scaled != 0
    np.testing.assert_allclose(scaled[kept], 2 * x[kept], rtol=1e-6)


def test_positional_table_follows_base():
    t = nn.SinusoidalPositionalEncoding(16, base=100.0).table(9).numpy()
    want = jnn.SinusoidalPositionalEncoding(16, base=100.0).table(9)
    np.testing.assert_array_equal(t, want)
    assert not np.array_equal(
        t, nn.SinusoidalPositionalEncoding(16).table(9).numpy())


def _signatures():
    for name, cls in sorted(vars(jnn).items()):
        if isinstance(cls, type) and isinstance(getattr(nn, name, None),
                                                type):
            yield name, cls, getattr(nn, name)


SIGNED = [n for n, _, _ in _signatures()]


@pytest.mark.parametrize("name", SIGNED)
def test_constructor_signature_matches_jax(name):
    """Every argument the JAX constructor takes, the port's takes under
    the same name, in the same position and with the same default; the
    port may add arguments after them (``device``, ``generator``)."""
    def params(cls):
        return [p for n, p in inspect.signature(cls.__init__)
                .parameters.items()
                if n != "self" and p.kind not in (p.VAR_POSITIONAL,
                                                  p.VAR_KEYWORD)]

    want = params(getattr(jnn, name))
    got = params(getattr(nn, name))
    assert [p.name for p in got[:len(want)]] == [p.name for p in want]
    for w, g in zip(want, got):
        assert g.default == w.default, (w.name, w.default, g.default)
        assert g.kind == w.kind, w.name


def test_every_shared_class_is_signature_checked():
    assert len(SIGNED) >= 130
    assert {"Linear", "Dropout", "LayerNorm", "SpatialConvolution",
            "SinusoidalPositionalEncoding"} <= set(SIGNED)
