"""The port's ``TransformerLM`` (bigdl_tpu_torch/models/transformer.py)
against the JAX package's, with the JAX weights carried across through
``load_jax_params``: full-sequence log-probs, the paged decode window
(log-probs and written pools), greedy ``lm_decode`` and the parameter
round trip.  Small size: the ``lm`` fixture of test_paged_attention.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.models.transformer import TransformerLM as JaxLM
from bigdl_tpu.models.transformer import _lm_forward_window as jax_window
from bigdl_tpu.models.transformer import _lm_handles as jax_handles
from bigdl_tpu.models.transformer import lm_decode as jax_lm_decode
from bigdl_tpu.utils.random import set_seed
from bigdl_tpu_torch.models import transformer as tt

TOL = dict(rtol=1e-4, atol=1e-5)
SEEDS = [[1, 2, 3], [4, 5], [6], [7, 8, 9, 10], [2, 4]]


@pytest.fixture()
def lm():
    set_seed(1)
    return JaxLM(vocab_size=11, d_model=16, n_heads=2, n_layers=2,
                 hidden=32)


@pytest.fixture()
def port(lm):
    m = tt.TransformerLM(vocab_size=11, d_model=16, n_heads=2, n_layers=2,
                         hidden=32, device="cpu")
    tree = jax.tree_util.tree_map(np.asarray, lm.params())
    return tt.load_jax_params(m, tree).evaluate()


def test_full_sequence_log_probs_match(lm, port):
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 11, size=(3, 7))
    x = np.eye(11, dtype=np.float32)[ids]
    lm.evaluate()
    want = np.asarray(lm.forward(jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_paged_window_matches_jax(lm, port):
    """S=1 steps with one row frozen part of the way, then an S=3
    window: log-probs and the written pools match (the port's pools
    carry one extra scratch page, compared without it)."""
    jh = jax_handles(lm)
    ph = tt._lm_handles(port)
    L, H, hd = ph.n_layers, ph.n_heads, ph.hd
    B, ps, P, n_pages = 2, 4, 3, 6
    ptab = np.asarray([[0, 1, 2], [3, 4, 5]], np.int32)
    pe = jh.mods[1].table(P * ps)
    jc = (jnp.zeros((L, n_pages, ps, H, hd)),) * 2
    pc = tt.new_pools(ph, n_pages, ps, "cpu")
    rs = np.random.RandomState(7)
    toks = rs.randint(1, 11, size=(B, 9)).astype(np.int32)

    def step(tok, pos, valid, jc, pc):
        jl, jc = jax_window(jnp.asarray(tok), jnp.asarray(pos), jc, jh,
                            jnp.asarray(pe), (jnp.asarray(ptab), ps),
                            valid=jnp.asarray(valid))
        with torch.no_grad():
            pl, pc = tt._lm_forward_window(
                torch.from_numpy(tok), torch.from_numpy(pos), pc, ph,
                torch.from_numpy(pe), (torch.from_numpy(ptab), ps),
                valid=torch.from_numpy(valid))
        live = valid.all(axis=1)
        np.testing.assert_allclose(pl.numpy()[live], np.asarray(jl)[live],
                                   **TOL)
        return jc, pc

    for t in range(6):
        valid = np.asarray([[True], [t < 4]])       # row 1 frozen at t=4
        jc, pc = step(toks[:, t:t + 1], np.full((B, 1), t, np.int32),
                      valid, jc, pc)
    pos3 = np.broadcast_to(np.arange(6, 9, dtype=np.int32), (B, 3)).copy()
    jc, pc = step(toks[:, 6:9], pos3, np.ones((B, 3), bool), jc, pc)
    for j, p in zip(jc, pc):
        np.testing.assert_allclose(p[:, :n_pages].numpy(), np.asarray(j),
                                   **TOL)


def test_lm_decode_tokens_identical(lm, port):
    want = [jax_lm_decode(lm, s, 5, greedy=True) for s in SEEDS]
    got = [tt.lm_decode(port, s, 5, device="cpu") for s in SEEDS]
    assert got == want
    batch = [[1, 2, 3], [7, 8, 9]]
    assert (tt.lm_decode(port, batch, 4, device="cpu")
            == jax_lm_decode(lm, batch, 4, greedy=True))


def test_lm_decode_spans_pages(lm, port):
    """3 + 20 - 1 = 22 positions cross a DEFAULT_PAGE_SIZE page boundary:
    the rows still match JAX token for token."""
    assert 3 + 20 - 1 > tt.DEFAULT_PAGE_SIZE
    batch = [[1, 2, 3], [9, 4, 6]]
    assert (tt.lm_decode(port, batch, 20, device="cpu")
            == jax_lm_decode(lm, batch, 20, greedy=True))


def test_export_params_round_trip(port):
    tree = tt.export_params(port)
    other = tt.TransformerLM(vocab_size=11, d_model=16, n_heads=2,
                             n_layers=2, hidden=32, device="cpu")
    tt.load_jax_params(other, tree)
    again = tt.export_params(other)
    flat_a = jax.tree_util.tree_leaves(tree)
    flat_b = jax.tree_util.tree_leaves(again)
    assert len(flat_a) == len(flat_b) > 0
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)
    assert (jax.tree_util.tree_structure(tree)
            == jax.tree_util.tree_structure(again))


def test_load_rejects_a_wrong_shape(lm, port):
    tree = jax.tree_util.tree_map(np.asarray, lm.params())
    tree["0"]["0"]["~"]["weight"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="shape"):
        tt.load_jax_params(port, tree)


def test_lm_decode_without_a_card_raises(port, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tt.lm_decode(port, [1, 2], 3)


@pytest.mark.parametrize("build", [
    lambda: tt.TransformerLM(11, 16, 2, 2, 32),
    lambda: tt.encoder_block(16, 2, 32),
])
def test_model_factories_default_to_the_card(build, monkeypatch):
    """Like every entry point of the port, the model factories place the
    weights on the card unless the caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build()
