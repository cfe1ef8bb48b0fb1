"""One module (or criterion) of the JAX package against its port on the
same seeded numpy inputs: the forward output, the gradient of every
floating-point input and of every parameter, under the cotangent ``g``
(a seeded random array for each output).

An input is a numpy array, or a Python list standing for a 1-based
Table of inputs (nested lists for nested Tables); integer arrays (class
targets, indices) get no gradient.  The JAX module runs in evaluation
mode (``Context(training=False)``), the port's as built."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.nn.module import Context
from bigdl_tpu.utils.table import Table as JTable
from bigdl_tpu_torch.nn.module import load_jax_params
from bigdl_tpu_torch.utils.table import Table

EVAL = Context(training=False, key=jax.random.PRNGKey(0))


def _leaves(x):
    if isinstance(x, list):
        return [leaf for v in x for leaf in _leaves(v)]
    return [x]


def _rebuild(x, it, table):
    if isinstance(x, list):
        return table(*[_rebuild(v, it, table) for v in x])
    return next(it)


def _is_diff(a):
    return np.issubdtype(np.asarray(a).dtype, np.floating)


def _out_leaves(y):
    if isinstance(y, (Table, JTable)):
        return [leaf for v in y for leaf in _out_leaves(v)]
    return [y]


def jax_run(fn, params, x, g_seed=1):
    """(outputs, cotangents, input grads, param grads) of ``fn(params,
    x)`` in JAX; the loss is sum(y * g) over the outputs."""
    leaves = _leaves(x)
    diff = [i for i, a in enumerate(leaves) if _is_diff(a)]

    def build(dleaves):
        vals = [jnp.asarray(a) for a in leaves]
        for i, v in zip(diff, dleaves):
            vals[i] = v
        return _rebuild(x, iter(vals), JTable)

    ys = [np.asarray(y) for y in _out_leaves(fn(params, build(
        [jnp.asarray(leaves[i]) for i in diff])))]
    rs = np.random.RandomState(g_seed)
    gs = [rs.randn(*y.shape).astype(y.dtype) if y.shape else
          np.asarray(rs.randn(), y.dtype) for y in ys]

    def loss(p, dleaves):
        out = _out_leaves(fn(p, build(dleaves)))
        return sum((o * g).sum() for o, g in zip(out, gs))

    dp, dx = jax.grad(loss, argnums=(0, 1))(
        params, [jnp.asarray(leaves[i]) for i in diff])
    return ys, gs, [np.asarray(v) for v in dx], dp


def port_run(fn, x, gs):
    """(outputs, input grads) of ``fn(x)`` in the port under the same
    cotangents; parameter grads land on the module's ``.grad``."""
    leaves = [torch.from_numpy(np.array(a)) for a in _leaves(x)]
    diff = [t.requires_grad_() for t in leaves if t.is_floating_point()]
    out = _out_leaves(fn(_rebuild(x, iter(leaves), Table)))
    loss = sum((o * torch.from_numpy(g)).sum() for o, g in zip(out, gs))
    grads = torch.autograd.grad(loss, diff, allow_unused=True,
                                retain_graph=True) if diff else []
    if loss.requires_grad:
        loss.backward()
    return ([o.detach().numpy() for o in out],
            [np.zeros(t.shape, np.float32) if d is None else d.numpy()
             for t, d in zip(diff, grads)])


def assert_close(got, want, tol):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, (a.shape, b.shape)
        np.testing.assert_allclose(a, b, **tol)


def check_module(jm, pm, x, fwd_tol, bwd_tol):
    """The JAX module ``jm`` and the port's ``pm`` (its parameters loaded
    from ``jm``'s) on ``x``: outputs, input grads and parameter grads.
    Returns the outputs and grads for further checks."""
    load_jax_params(pm, jax.tree_util.tree_map(np.asarray, jm.params()))
    ys, gs, dx_j, dp_j = jax_run(
        lambda p, v: jm.apply(p, v, jm.state(), EVAL)[0], jm.params(), x)
    y, dx = port_run(pm, x, gs)
    assert_close(y, ys, fwd_tol)
    assert_close(dx, dx_j, bwd_tol)
    want = [np.asarray(v) for v in jax.tree_util.tree_leaves(dp_j)]
    got = [p.grad.numpy() if p.grad is not None
           else np.zeros(p.shape, np.float32) for p in _param_order(pm)]
    assert_close(got, want, bwd_tol)
    return y, dx


def _param_order(module):
    """Parameters in the sorted-key order of ``jax.tree_util.tree_leaves``
    over the nested tree (dict keys sorted)."""
    out = []
    own = dict(module._parameters)
    kids = dict(module._modules)
    for key in sorted(["~"] + list(kids)):
        if key == "~":
            out += [own[k] for k in sorted(own)]
        else:
            out += _param_order(kids[key])
    return out


def check_criterion(jc, pc, x, target, fwd_tol, bwd_tol):
    """A JAX criterion and the port's on (input ``x``, ``target``): the
    loss and the input's gradient."""
    tl = _leaves(target)

    def jt():
        return _rebuild(target, iter([jnp.asarray(a) for a in tl]), JTable)

    ys, gs, dx_j, _ = jax_run(lambda p, v: jc.apply_loss(v, jt()), {}, x)

    def port(v):
        t = _rebuild(target, iter([torch.from_numpy(np.array(a))
                                   for a in tl]), Table)
        return pc.apply_loss(v, t)

    y, dx = port_run(port, x, gs)
    assert_close(y, ys, fwd_tol)
    assert_close(dx, dx_j, bwd_tol)
    return y, dx


@pytest.fixture(autouse=True)
def keep_torch_rng():
    """A test that draws from PyTorch's global generator (a layer built
    without a ``generator``) gives it back as it found it, so the files
    that run after it in one process see the same stream."""
    state = torch.random.get_rng_state()
    yield
    torch.random.set_rng_state(state)
