"""Tables in the port (bigdl_tpu_torch/nn/containers.py, table_ops.py)
against the JAX package: ``ConcatTable``, ``ParallelTable`` and
``MapTable`` emit a 1-based ``Table`` (``ConcatTable(a, b)(x)[1]`` is
branch ``a``'s output, as in JAX; the port's ``ConcatTable`` returned a
0-based list before), the containers and all 15 table ops held against
the JAX modules in the forward, the inputs' gradients and the
parameters' gradients, ``MapTable``'s one shared child, and the residual
sum (``CAddTable`` over a ``ConcatTable``) unchanged in its bits.
Tolerances: forward rtol 1e-5 / atol 1e-6, gradients rtol 1e-4 / atol
1e-5 (tests/test_containers.py holds the JAX ops with np.allclose)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.nn.module import Context
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.nn.module import export_params, load_jax_params
from bigdl_tpu_torch.utils.table import Table
from tests.helpers.torch_parity import check_module
from tests.helpers.torch_parity import keep_torch_rng  # noqa: F401

FWD = dict(rtol=1e-5, atol=1e-6)
BWD = dict(rtol=1e-4, atol=1e-5)
EVAL = Context(training=False, key=jax.random.PRNGKey(0))


def _randn(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_concat_table_element_1_is_the_first_branch():
    """The Table repair: element 1 of ``ConcatTable(a, b)(x)`` is branch
    ``a``'s output, as in the JAX package (a 0-based list made it
    ``b``'s)."""
    jm = jnn.ConcatTable(jnn.Linear(4, 3), jnn.Linear(4, 2))
    pm = nn.ConcatTable(nn.Linear(4, 3), nn.Linear(4, 2))
    load_jax_params(pm, jax.tree_util.tree_map(np.asarray, jm.params()))
    x = _randn(5, 4)
    want = jm.apply(jm.params(), jnp.asarray(x), jm.state(), EVAL)[0]
    got = pm(torch.from_numpy(x))
    assert got[1].shape == (5, 3)
    np.testing.assert_allclose(got[1].detach().numpy(), np.asarray(want[1]),
                               **FWD)
    np.testing.assert_allclose(got[2].detach().numpy(), np.asarray(want[2]),
                               **FWD)


@pytest.mark.parametrize("build,x", [
    (lambda m: m.ConcatTable(m.Linear(4, 3), m.Identity()), _randn(2, 4)),
    (lambda m: m.ParallelTable(m.Linear(4, 3), m.Identity()),
     [_randn(2, 4), _randn(2, 5, seed=1)]),
    (lambda m: m.MapTable(m.Linear(4, 3)),
     [_randn(2, 4), _randn(2, 4, seed=1)]),
], ids=["ConcatTable", "ParallelTable", "MapTable"])
def test_table_containers_emit_a_one_based_table(build, x):
    pm = build(nn)
    xs = (torch.from_numpy(x) if not isinstance(x, list)
          else Table(*map(torch.from_numpy, x)))
    out = pm(xs)
    assert isinstance(out, Table)
    assert out.length() == 2 and 0 not in out
    assert out[1].shape == (2, 3)


# (id, builder over a package, input): containers of the slice
CONTAINERS = [
    ("ConcatTable", lambda m: m.ConcatTable(m.Linear(4, 3), m.Identity(),
                                            m.Linear(4, 2)), _randn(3, 4)),
    ("ParallelTable", lambda m: m.ParallelTable(m.Linear(4, 2),
                                                m.Linear(3, 5)),
     [_randn(2, 4), _randn(2, 3, seed=1)]),
    ("MapTable", lambda m: m.MapTable(m.Linear(4, 2)),
     [_randn(2, 4), _randn(2, 4, seed=1), _randn(3, 4, seed=2)]),
    ("Bottle", lambda m: m.Bottle(m.Linear(4, 2), 2, 2), _randn(3, 5, 4)),
    ("Bottle_4d", lambda m: m.Bottle(m.Linear(4, 3)), _randn(2, 3, 5, 4)),
    ("residual", lambda m: m.Sequential(
        m.ConcatTable(m.Identity(), m.Sequential(m.Linear(4, 4), m.Tanh())),
        m.CAddTable()), _randn(3, 4)),
    ("nested", lambda m: m.Sequential(
        m.ConcatTable(m.Linear(4, 3), m.Linear(4, 3)),
        m.ParallelTable(m.Tanh(), m.Sigmoid()), m.CSubTable()),
     _randn(3, 4)),
]


@pytest.mark.parametrize("name,build,x", CONTAINERS,
                         ids=[c[0] for c in CONTAINERS])
def test_container_matches_jax(name, build, x):
    check_module(build(jnn), build(nn), x, FWD, BWD)


def test_map_table_has_one_shared_child():
    """``MapTable``'s parameter tree has the one child ``'0'``, as the
    JAX module's, and every element's gradient lands on it."""
    jm, pm = jnn.MapTable(jnn.Linear(4, 2)), nn.MapTable(nn.Linear(4, 2))
    assert set(export_params(pm)) == set(jm.params()) == {"~", "0"}
    assert len(list(pm.parameters())) == 2
    xs = [_randn(2, 4), _randn(2, 4, seed=1)]
    check_module(jm, pm, xs, FWD, BWD)
    shared, single = nn.MapTable(nn.Linear(4, 2)), nn.Linear(4, 2)
    single.load_params(export_params(shared)["0"])
    x0, x1 = (torch.from_numpy(x) for x in xs)
    out = shared(Table(x0, x1))
    (out[1].sum() + out[2].sum()).backward()
    (single(x0).sum() + single(x1).sum()).backward()
    torch.testing.assert_close(shared.get(1).weight.grad, single.weight.grad)


def test_cadd_table_on_a_table_gives_the_list_sum_bits():
    """The residual sum over the Table is the sum over the branches in
    order, bit for bit as it was over the list."""
    a, b, c = (torch.from_numpy(_randn(64, 33, seed=s)) for s in range(3))
    assert torch.equal(nn.CAddTable()(Table(a, b, c)), (a + b) + c)
    assert torch.equal(nn.CAddTable()([a, b, c]), (a + b) + c)


def _pos(*shape, seed=0):
    return np.abs(_randn(*shape, seed=seed)) + 0.5


# (id, builder over a package, input): the table ops
OPS = [
    ("CAddTable", lambda m: m.CAddTable(),
     [_randn(3, 4), _randn(3, 4, seed=1), _randn(3, 4, seed=2)]),
    ("CSubTable", lambda m: m.CSubTable(), [_randn(3, 4),
                                            _randn(3, 4, seed=1)]),
    ("CMulTable", lambda m: m.CMulTable(),
     [_randn(3, 4), _randn(3, 4, seed=1), _randn(3, 4, seed=2)]),
    ("CDivTable", lambda m: m.CDivTable(), [_randn(3, 4), _pos(3, 4, seed=1)]),
    ("CMaxTable", lambda m: m.CMaxTable(),
     [_randn(3, 4), _randn(3, 4, seed=1), _randn(3, 4, seed=2)]),
    ("CMinTable", lambda m: m.CMinTable(),
     [_randn(3, 4), _randn(3, 4, seed=1), _randn(3, 4, seed=2)]),
    ("JoinTable", lambda m: m.JoinTable(2),
     [_randn(3, 4), _randn(3, 2, seed=1)]),
    ("JoinTable_batched", lambda m: m.JoinTable(1, 1),
     [_randn(3, 4), _randn(3, 2, seed=1)]),
    ("JoinTable_unbatched", lambda m: m.JoinTable(1, 2),
     [_randn(3, 4), _randn(2, 4, seed=1)]),
    ("SelectTable", lambda m: m.SelectTable(2),
     [_randn(3, 4), _randn(2, 5, seed=1), _randn(1, 2, seed=2)]),
    ("SelectTable_negative", lambda m: m.SelectTable(-1),
     [_randn(3, 4), _randn(2, 5, seed=1), _randn(1, 2, seed=2)]),
    ("NarrowTable", lambda m: m.NarrowTable(2, 2),
     [_randn(3, 4), _randn(2, 5, seed=1), _randn(1, 2, seed=2)]),
    ("NarrowTable_negative", lambda m: m.NarrowTable(1, -2),
     [_randn(3, 4), _randn(2, 5, seed=1), _randn(1, 2, seed=2)]),
    ("FlattenTable", lambda m: m.FlattenTable(),
     [_randn(3, 4), [_randn(2, 5, seed=1), [_randn(1, 2, seed=2),
                                            _randn(4, seed=3)]],
      _randn(2, seed=4)]),
    ("MixtureTable", lambda m: m.MixtureTable(),
     [_randn(3, 2), [_randn(3, 5, seed=1), _randn(3, 5, seed=2)]]),
    ("MixtureTable_tensor", lambda m: m.MixtureTable(),
     [_randn(3, 4), _randn(3, 4, 2, 5, seed=1)]),
    ("DotProduct", lambda m: m.DotProduct(), [_randn(3, 4),
                                              _randn(3, 4, seed=1)]),
    ("DotProduct_1d", lambda m: m.DotProduct(), [_randn(4),
                                                 _randn(4, seed=1)]),
    ("PairwiseDistance", lambda m: m.PairwiseDistance(),
     [_randn(3, 4), _randn(3, 4, seed=1)]),
    ("PairwiseDistance_L1", lambda m: m.PairwiseDistance(1),
     [_randn(3, 4), _randn(3, 4, seed=1)]),
    ("PairwiseDistance_1d", lambda m: m.PairwiseDistance(3),
     [_randn(4), _randn(4, seed=1)]),
    ("CosineDistance", lambda m: m.CosineDistance(),
     [_randn(3, 4), _randn(3, 4, seed=1)]),
    ("CosineDistance_1d", lambda m: m.CosineDistance(),
     [_randn(4), _randn(4, seed=1)]),
    ("CriterionTable", lambda m: m.CriterionTable(m.MSECriterion()),
     [_randn(3, 4), _randn(3, 4, seed=1)]),
    ("CriterionTable_nll", lambda m: m.CriterionTable(m.ClassNLLCriterion()),
     [_randn(3, 4), np.asarray([1, 4, 2], np.int64)]),
]


@pytest.mark.parametrize("name,build,x", OPS, ids=[c[0] for c in OPS])
def test_table_op_matches_jax(name, build, x):
    check_module(build(jnn), build(nn), x, FWD, BWD)


def test_every_jax_table_op_is_ported():
    """The JAX module's 15 table ops, each held above."""
    names = {n for n in dir(jnn.table_ops)
             if isinstance(getattr(jnn.table_ops, n), type)
             and issubclass(getattr(jnn.table_ops, n), jnn.Module)
             and n not in ("Module", "Table")}
    assert len(names) == 15
    assert names == {type(c[1](nn)).__name__ for c in OPS}


def test_cmax_table_splits_a_tie_as_jax():
    """At a tie ``CMaxTable`` and ``CMinTable`` give each tied input half
    the gradient, as ``jnp.maximum`` does."""
    a = np.asarray([[1.0, 2.0, 3.0]], np.float32)
    b = np.asarray([[1.0, 0.0, 3.0]], np.float32)
    for name in ("CMaxTable", "CMinTable"):
        _, dx = check_module(getattr(jnn, name)(), getattr(nn, name)(),
                             [a, b], FWD, BWD)
        assert dx[0][0, 0] != 0 and dx[0][0, 0] == dx[1][0, 0]


def test_list_input_counts_as_the_table_of_its_elements():
    a, b = (torch.from_numpy(_randn(3, 4, seed=s)) for s in (0, 1))
    assert torch.equal(nn.CSubTable()([a, b]), a - b)
    assert torch.equal(nn.SelectTable(1)([a, b]), a)
    assert torch.equal(nn.JoinTable(1)((a, b)), torch.cat([a, b]))
