"""The port's momentum-SGD update (bigdl_tpu_torch/ops/sgd.py and
``optim.SGD``) against the JAX package's ``fused_sgd`` Pallas kernel (run
in interpret mode, as tests/test_pallas_ops.py runs it) and its
``SGD.update``.

On the CPU ``ops.fused_sgd`` takes its plain version; the CUDA kernel is
held against that same plain version on the card by ``chip_smoke.py``.
Inputs come from a numpy seed and go through both packages; the
tolerance is tests/test_pallas_ops.py's (rtol 1e-5, atol 1e-6).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.ops.pallas_kernels import fused_sgd as jax_fused_sgd
from bigdl_tpu.optim import SGD as JaxSGD
from bigdl_tpu_torch import ops
from bigdl_tpu_torch.optim import SGD

TOL = dict(rtol=1e-5, atol=1e-6)
# tests/test_pallas_ops.py:37-44
HYPERS = [
    {"lr": 0.1},
    {"lr": 0.1, "dampening": 0.9},   # momentum 0: dampening is ignored
    {"lr": 0.1, "momentum": 0.9},
    {"lr": 0.1, "momentum": 0.9, "dampening": 0.9},
    {"lr": 0.1, "momentum": 0.9, "nesterov": True},
    {"lr": 0.1, "momentum": 0.9, "weight_decay": 1e-3},
]
# 4097 and 100 are not multiples of the kernel's 4096-element chunk, of
# its 4-element vectors or of the Pallas block
SHAPES = {"w": (130, 7), "b": (7,), "big": (4097,), "odd": (100,)}


def _trees(seed):
    rs = np.random.RandomState(seed)
    return [{k: rs.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
            for _ in range(3)]


def _kw(h):
    return dict(momentum=h.get("momentum", 0.0),
                weight_decay=h.get("weight_decay", 0.0),
                dampening=h.get("dampening", 0.0),
                nesterov=h.get("nesterov", False))


def _torch(tree):
    return [torch.from_numpy(tree[k].copy()) for k in SHAPES]


def _assert_close(got, want):
    for t, k in zip(got, SHAPES):
        np.testing.assert_allclose(t.numpy(), np.asarray(want[k]), **TOL)


@pytest.mark.parametrize("h", HYPERS, ids=lambda h: "-".join(h))
def test_plain_fused_sgd_matches_pallas(h):
    """Three steps of ``ops.fused_sgd`` (velocity starting nonzero) equal
    three steps of the JAX kernel."""
    p, g, v = _trees(0)
    jp, jv = ({k: jnp.asarray(a) for k, a in t.items()} for t in (p, v))
    jg = {k: jnp.asarray(a) for k, a in g.items()}
    tp, tg, tv = _torch(p), _torch(g), _torch(v)
    for _ in range(3):
        jp, jv = jax_fused_sgd(jp, jg, jv, h["lr"], **_kw(h))
        ops.fused_sgd(tp, tg, tv, h["lr"], **_kw(h))
    _assert_close(tp, jp)
    _assert_close(tv, jv)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("h", HYPERS, ids=lambda h: "-".join(h))
def test_sgd_update_matches_jax(h, fused):
    """The port's ``SGD(fused=...).update`` over a parameter list equals
    the JAX ``SGD(fused=...).update`` over the same leaves, params and
    velocity, over three steps from a zero velocity."""
    p, g, _ = _trees(1)
    jax_m, port_m = JaxSGD(fused=fused), SGD(fused=fused)
    jp = {k: jnp.asarray(a) for k, a in p.items()}
    jg = {k: jnp.asarray(a) for k, a in g.items()}
    js = jax_m.init_state(jp)
    tp, tg = _torch(p), _torch(g)
    ts = port_m.init_state(tp)
    for _ in range(3):
        jp, js = jax_m.update(jg, js, jp, h)
        port_m.update(tg, ts, tp, h)
    _assert_close(tp, jp)
    _assert_close(ts["velocity"], js["velocity"])


@pytest.mark.parametrize("fused", [True, False])
def test_nonfinite_step_keeps_params_and_velocity(fused):
    p, g, v = _trees(2)
    tp, tg = _torch(p), _torch(g)
    m = SGD(fused=fused)
    st = m.init_state(tp)
    m.update(tg, st, tp, {"lr": 0.1, "momentum": 0.9})
    before = [t.clone() for t in tp + st["velocity"]]
    tg[0][0, 0] = float("nan")
    m.update(tg, st, tp, {"lr": 0.1, "momentum": 0.9},
             finite=torch.tensor(False))
    for a, b in zip(tp + st["velocity"], before):
        assert torch.equal(a, b)
    m.update(tg, st, tp, {"lr": 0.1, "momentum": 0.9},
             finite=torch.tensor(True))
    assert not torch.equal(tp[1], before[1])


def test_cpu_counts_no_launch():
    ops.reset_launch_counts()
    p, g, v = (_torch(t) for t in _trees(3))
    SGD(fused=True).update(g, {"velocity": v}, p, {"lr": 0.1})
    assert ops.launch_counts()["fused_sgd"] == 0


def test_no_plain_path_off_the_cpu():
    """A leaf that is not on the CPU never reaches the plain version:
    the wrapper launches its kernel or raises."""
    p, g, v = ([t.to("meta") for t in _torch(tr)] for tr in _trees(4))
    with pytest.raises(ValueError, match="no kernel"):
        ops.fused_sgd(p, g, v, 0.1, momentum=0.9)


def test_lr_scales_raise():
    p, g, v = (_torch(t) for t in _trees(5))
    with pytest.raises(NotImplementedError, match="learning rates"):
        SGD(fused=True).update(g, {"velocity": v}, p,
                               {"lr": 0.1, "lr_scales": [1.0] * len(p)})
