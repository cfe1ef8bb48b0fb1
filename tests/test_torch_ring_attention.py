"""The port's ring attention, its collectives and the mesh's ``seq`` and
``expert`` axes, held against the JAX package: ``ring_attention`` at 2
and 4 gloo ranks, causal and not, against the JAX ``full_attention``
and its gradients (tests/test_attention_sp.py:28-55's tolerances), the
one-process block ring (what the card checks) likewise, ``ppermute``,
``ring_shift`` and ``all_to_all`` against the ``lax`` collectives'
definitions, and a rank's mesh coordinates against the JAX mesh's device
order.  The ranks import the port alone
(``tests/helpers/torch_distri_workers.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.parallel.mesh import make_mesh as jax_make_mesh
from bigdl_tpu.parallel.ring_attention import full_attention as jax_full
from bigdl_tpu_torch.parallel.launch import launch
from bigdl_tpu_torch.parallel.ring_attention import (full_attention,
                                                     ring_attention_blocks)
from tests.helpers import torch_distri_workers as W

FWD = dict(rtol=1e-4, atol=1e-5)    # tests/test_attention_sp.py:39
GRAD = dict(rtol=1e-3, atol=1e-3)   # tests/test_attention_sp.py:52
SHAPE = (2, 16, 2, 8)               # B, T, H, hd


def _qkvg(seed):
    rs = np.random.RandomState(seed)
    return [rs.randn(*SHAPE).astype(np.float32) for _ in range(4)]


def _jax_ref(q, k, v, g, causal):
    """JAX full attention's output and (dq, dk, dv) under cotangent g."""
    def f(q, k, v):
        return (jax_full(q, k, v, causal=causal) * g).sum()
    out = jax_full(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=causal)
    grads = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v))
    return [np.asarray(out)] + [np.asarray(a) for a in grads]


CASES = [(False, 0), (True, 1)]


@pytest.fixture(scope="module", params=[2, 4])
def ring(request):
    n = request.param
    per_case = []
    for causal, seed in CASES:
        q, k, v, g = _qkvg(seed)
        per_case.append(launch(W.ring_case, n, "gloo",
                               args=(q, k, v, g, causal)))
    return n, per_case


@pytest.mark.parametrize("case", range(len(CASES)))
def test_ring_matches_jax_full_attention(ring, case):
    """Each rank's block of the output and of dq, dk, dv, put together,
    against JAX's full softmax attention and jax.grad."""
    n, per_case = ring
    causal, seed = CASES[case]
    want = _jax_ref(*_qkvg(seed), causal)
    ranks = per_case[case]
    got = [np.concatenate([r[i] for r in ranks], axis=1) for i in range(4)]
    np.testing.assert_allclose(got[0], want[0], **FWD)
    for name, a, b in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        np.testing.assert_allclose(a, b, **GRAD, err_msg=name)


@pytest.mark.parametrize("n_blocks", [1, 2, 4])
@pytest.mark.parametrize("causal", [False, True])
def test_block_ring_in_one_process_matches_jax(n_blocks, causal):
    """The per-hop steps over P blocks in one process (the card's check
    of the step) against JAX full attention and its gradients."""
    q, k, v, g = _qkvg(2)
    want = _jax_ref(q, k, v, g, causal)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = ring_attention_blocks(*ts, n_blocks, causal)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), want[0], **FWD)
    for a, b in zip(grads, want[1:]):
        np.testing.assert_allclose(a.numpy(), b, **GRAD)


def test_full_attention_matches_jax_with_its_gradients():
    q, k, v, g = _qkvg(3)
    for causal in (False, True):
        want = _jax_ref(q, k, v, g, causal)
        ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        out = full_attention(*ts, causal=causal)
        grads = torch.autograd.grad(out, ts, torch.from_numpy(g))
        np.testing.assert_allclose(out.detach().numpy(), want[0], **FWD)
        for a, b in zip(grads, want[1:]):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-5)


def test_a_masked_block_adds_nothing():
    """Causal, the blocks wholly above the diagonal are skipped (JAX adds
    0 for them, :55): the first query block's output is its own block's
    attention alone, and no NaN comes of -inf minus -inf."""
    q, k, v, _ = _qkvg(4)
    ts = [torch.from_numpy(a) for a in (q, k, v)]
    out = ring_attention_blocks(*ts, 4, causal=True)
    first = full_attention(*(t[:, :4] for t in ts), causal=True)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out[:, :4].numpy(), first.numpy(), **FWD)


# -- the collectives ------------------------------------------------------

@pytest.fixture(scope="module")
def p2p():
    x = np.arange(8, dtype=np.float32).reshape(4, 2) * 10.0
    return x, launch(W.collectives_p2p_case, 4, "gloo", args=(x,))


def test_ppermute_and_ring_shift(p2p):
    """lax.ppermute: a rank no pair sends to gets zeros; ring_shift by s
    lands rank i's value on rank i + s."""
    x, ranks = p2p
    n = len(ranks)
    for r, out in enumerate(ranks):
        want = x + 0 if r == n - 1 else np.zeros_like(x)
        np.testing.assert_array_equal(out["ppermute"], want)
        np.testing.assert_array_equal(out["shift"], x + (r - 1) % n)
        np.testing.assert_array_equal(out["shift2"], x + (r + 1) % n)


def test_all_to_all_is_lax_all_to_all(p2p):
    """Tiled: rank r's chunk j (of dim 0) goes to rank j and the received
    chunks join along dim 1 in rank order; untiled: received chunk s at
    index s; the gradient returns each chunk to its sender."""
    x, ranks = p2p
    n = len(ranks)
    for r, out in enumerate(ranks):
        want = np.concatenate([(x + s)[r:r + 1] for s in range(n)], axis=1)
        np.testing.assert_array_equal(out["a2a"], want)
        np.testing.assert_array_equal(
            out["a2a_untiled"], np.stack([x + s for s in range(n)]))
        # each rank's loss is sum(y * arange): rank r's row j went to
        # rank j's column block r, and its gradient comes back from there
        cot = np.arange(want.size, dtype=np.float32).reshape(want.shape)
        block = cot[0, r * x.shape[1]:(r + 1) * x.shape[1]]
        np.testing.assert_array_equal(out["a2a_grad"],
                                      np.stack([block] * n))


@pytest.fixture(scope="module")
def meshes():
    shapes = [{"data": 2, "seq": 2}, {"data": -1, "expert": 2},
              {"data": 1, "seq": 4}, {"data": 4}]
    return shapes, launch(W.mesh_case, 4, "gloo", args=(shapes,))


def test_mesh_coordinates_follow_the_jax_device_order(meshes):
    """Rank r sits where device r sits in the JAX mesh of the same dict
    (row-major over its axes), and each axis groups the ranks that
    differ only there."""
    shapes, ranks = meshes
    devices = jax.devices()[:4]
    for i, shape in enumerate(shapes):
        jm = jax_make_mesh(shape, devices)
        ids = np.vectorize(lambda d: d.id)(jm.devices)
        for r, per_mesh in enumerate(ranks):
            got_shape, coords, members = per_mesh[i]
            assert got_shape == dict(jm.shape)
            where = tuple(int(a[0]) for a in np.nonzero(ids == devices[r].id))
            assert coords == dict(zip(jm.axis_names, where))
            for ax, name in enumerate(jm.axis_names):
                line = np.moveaxis(ids, ax, -1)[
                    tuple(c for a, c in enumerate(where) if a != ax)]
                want = [int(np.nonzero(
                    [d.id == j for d in devices])[0][0]) for j in line]
                assert list(members[name]) == want


def test_later_axes_and_bad_meshes_raise():
    """The pipe axis goes with the data axis alone; seq and expert do not
    go together; seq needs the data axis."""
    from bigdl_tpu_torch.parallel.mesh import make_mesh
    with pytest.raises(ValueError, match="'pipe' axis with an optional "
                                         "'data' axis"):
        make_mesh({"data": 1, "pipe": 2, "seq": 1}, "cpu")
    with pytest.raises(ValueError, match="one of 'seq', 'expert' and "
                                         "'model'"):
        make_mesh({"data": 1, "seq": 1, "expert": 1}, "cpu")
    with pytest.raises(ValueError, match="'data' axis"):
        make_mesh({"seq": 1}, "cpu")
