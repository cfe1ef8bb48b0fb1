"""The port's continuous-batching decoder (bigdl_tpu_torch/serve/decode.py)
against the JAX package's ``continuous_decode`` and ``lm_decode``, with
the JAX weights carried across, over fp32 and int8 KV pools; plus its
failure isolation, page accounting and device rules.
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
from bigdl_tpu.serve.decode import continuous_decode as jax_continuous
from bigdl_tpu.utils.random import set_seed
from bigdl_tpu_torch import quant
from bigdl_tpu_torch.models import transformer as tt
from bigdl_tpu_torch.quant import kv as kvq
from bigdl_tpu_torch.serve import (ContinuousDecoder, PagePool,
                                   RequestTooLongError, continuous_decode)
from bigdl_tpu_torch.serve.decode import _pages_needed

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
    return tt.load_jax_params(
        m, jax.tree_util.tree_map(np.asarray, lm.params())).evaluate()


@pytest.fixture()
def serial(lm):
    return [jax_lm_decode(lm, s, 5, greedy=True) for s in SEEDS]


@pytest.mark.parametrize("max_slots", [2, 4])
def test_token_parity_with_jax(lm, port, serial, max_slots):
    kw = dict(max_slots=max_slots, n_pos=9, sync_interval=3, page_size=4)
    want = jax_continuous(lm, SEEDS, 5, prefix_cache=False, **kw)
    got = continuous_decode(port, SEEDS, 5, device="cpu", **kw)
    assert got == want == serial


def test_too_long_request_fails_only_itself(port, serial):
    dec = ContinuousDecoder(port, max_slots=2, n_pos=9, sync_interval=3,
                            page_size=4, device="cpu")
    futs = [dec.submit(s, 5) for s in SEEDS[:2]]
    bad = dec.submit(list(range(1, 9)), 5)         # 12 positions > 9
    futs.append(dec.submit(SEEDS[2], 5))
    dec.run()
    with pytest.raises(RequestTooLongError):
        bad.result(timeout=0)
    assert [f.result(timeout=0) for f in futs] == serial[:3]


def test_pool_drains_after_run(port):
    dec = ContinuousDecoder(port, max_slots=2, n_pos=9, sync_interval=2,
                            page_size=4, n_pages=5, device="cpu")
    futs = [dec.submit(s, 5) for s in SEEDS]
    dec.run()
    assert all(f.done() for f in futs)
    st = dec.stats()
    # every page is free or held by the prefix cache alone (the seed page
    # [7, 8, 9, 10] donated), and closing the decoder releases those
    assert st["pool"]["in_use"] == st["prefix"]["entries"] == 1
    assert st["admitted"] == st["retired"] == len(SEEDS)
    # the small pool forced head-of-line waits but never over-allocated
    assert 0 < st["pool"]["in_use_hwm"] <= 5
    assert _pages_needed(9, 4) == 3 and _pages_needed(8, 4) == 2
    dec.close()
    assert dec.stats()["pool"]["in_use"] == 0
    assert dec.stats()["pool"]["free"] == 5


def test_host_syncs_only_at_retiring_boundaries(port):
    dec = ContinuousDecoder(port, max_slots=4, n_pos=9, sync_interval=3,
                            page_size=4, device="cpu")
    for s in SEEDS:
        dec.submit(s, 5)
    dec.run()
    st = dec.stats()
    assert st["steps"] % 3 == 0
    assert 1 <= st["host_syncs"] <= st["steps"] // 3


def test_sampling_raises(port, serial):
    """``sampling=`` is validated at submit (a negative temperature or a
    wrong type raises there); a sampled request is served beside a greedy
    one, which stays ``lm_decode``'s row."""
    dec = ContinuousDecoder(port, max_slots=2, n_pos=9, device="cpu")
    with pytest.raises(ValueError, match="temperature"):
        dec.submit([1, 2], 3, sampling={"temperature": -0.7})
    with pytest.raises(TypeError, match="sampling must be"):
        dec.submit([1, 2], 3, sampling=0.7)
    hot = dec.submit([1, 2], 3, sampling={"temperature": 0.7, "seed": 3})
    cold = dec.submit(SEEDS[0], 5, sampling={"temperature": 0.0})
    dec.run()
    assert len(hot.result()) == 5 and hot.result()[:2] == [1, 2]
    assert cold.result() == serial[0]
    assert dec.stats()["sampled"] == 1


def test_no_device_means_the_card(port, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ContinuousDecoder(port)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        continuous_decode(port, SEEDS, 5)


def test_page_pool_guards():
    pool = PagePool(2, 4)
    a, b = pool.alloc_one(), pool.alloc_one()
    with pytest.raises(RuntimeError, match="exhausted"):
        pool.alloc_one()
    pool.release(a)
    with pytest.raises(RuntimeError, match="not allocated"):
        pool.release(a)
    assert pool.stats() == {"pages": 2, "page_size": 4, "in_use": 1,
                            "free": 1, "in_use_hwm": 2}
    assert pool.alloc_one() == a            # the freed page comes back
    assert b not in pool._free


def _jax_int8_gap(lm, row, k, ps):
    """How far token ``row[k]`` sits below the maximum log-prob of its
    position under the JAX int8 window forward of ``row[:k]`` (one
    window, quantized pools of ``ps``-token pages)."""
    h = jax_handles(lm)
    L, H, hd = h.n_layers, h.n_heads, h.hd
    P = -(-k // ps)
    shape = (L, P, ps, H, hd)
    caches = (jnp.zeros(shape, jnp.int8), jnp.zeros(shape, jnp.int8),
              jnp.zeros(shape[:-1]), jnp.zeros(shape[:-1]))
    logp, _ = jax_window(jnp.asarray([row[:k]]), jnp.arange(k)[None],
                         caches, h, jnp.asarray(h.mods[1].table(P * ps)),
                         (jnp.arange(P, dtype=jnp.int32)[None], ps))
    lp = np.asarray(logp[0, k - 1])
    return float(lp.max() - lp[row[k]])


def _held_to_jax_int8(lm, got, want, ps):
    """The decoders' token rule: the rows are equal, or at the first
    position where they part both tokens sit within 1e-3 of that
    position's maximum log-prob under the JAX int8 window forward (the
    rows are compared no further)."""
    for g, w in zip(got, want):
        assert len(g) == len(w)
        k = next((j for j in range(len(g)) if g[j] != w[j]), None)
        if k is not None:
            assert _jax_int8_gap(lm, g, k, ps) <= 1e-3
            assert _jax_int8_gap(lm, w, k, ps) <= 1e-3


@pytest.mark.parametrize("page_size", [4, 5])
@pytest.mark.parametrize("max_slots", [2, 4])
def test_int8_token_parity_with_jax(lm, port, max_slots, page_size):
    """int8 KV pools (page 5 does not divide n_pos = 9) against the JAX
    decoder's int8 stream on the same weights."""
    kw = dict(max_slots=max_slots, n_pos=9, sync_interval=3,
              page_size=page_size, kv_quant="int8")
    want = jax_continuous(lm, SEEDS, 5, prefix_cache=False, **kw)
    got = continuous_decode(port, SEEDS, 5, device="cpu", **kw)
    _held_to_jax_int8(lm, got, want, page_size)
    assert got == continuous_decode(port, SEEDS, 5, device="cpu", **kw)


def test_int8_rule_catches_a_wrong_token(lm):
    """The parity rule is not vacuous: a token far from its position's
    maximum fails it."""
    row = jax_lm_decode(lm, SEEDS[0], 5, greedy=True)
    k = len(SEEDS[0])
    assert _jax_int8_gap(lm, row, k, 4) <= 1e-3
    bad = row[:k] + [(row[k] + 5) % 11] + row[k + 1:]
    with pytest.raises(AssertionError):
        _held_to_jax_int8(lm, [bad], [row], 4)


def test_bench_model_holds_token_parity():
    """tests/test_quant.py::test_bench_model_holds_token_parity ported: at
    the bench model's width (d = 64) the int8 stream equals the fp32
    stream and the JAX ``lm_decode`` oracle."""
    set_seed(1)
    jm = JaxLM(vocab_size=128, d_model=64, n_heads=4, n_layers=2,
               hidden=128)
    model = tt.load_jax_params(
        tt.TransformerLM(vocab_size=128, d_model=64, n_heads=4, n_layers=2,
                         hidden=128, device="cpu"),
        jax.tree_util.tree_map(np.asarray, jm.params())).evaluate()
    rng = np.random.RandomState(0)
    seeds = [rng.randint(1, 128, rng.randint(2, 6)).tolist()
             for _ in range(6)]
    oracle = [jax_lm_decode(jm, s, 8) for s in seeds]
    kw = dict(max_slots=3, n_pos=16, page_size=8, device="cpu")
    rows = continuous_decode(model, seeds, 8, kv_quant="int8", **kw)
    assert rows == continuous_decode(model, seeds, 8, kv_quant="off", **kw)
    assert rows == oracle


def test_pool_round_trip_bound(port):
    """tests/test_quant.py::test_pool_round_trip_bound on the port's
    window forward: every written layer-0 row dequantizes within amax/254
    of the fp32 twin's (per head), deeper layers stay close, and so do
    the log-probs."""
    h = tt._lm_handles(port)
    ps, n_pages = 4, 6
    pe = h.mods[1].table(2 * ps)
    ptab = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    tok = torch.tensor([[1, 2, 3], [4, 5, 6]])
    i = torch.tensor([[0, 1, 2], [0, 1, 2]])
    fp = tt.new_pools(h, n_pages, ps, "cpu")
    q8 = tt.new_pools(h, n_pages, ps, "cpu", kv_quant="int8")
    assert [c.dtype for c in q8] == [torch.int8] * 2 + [torch.float32] * 2
    assert tuple(q8[2].shape) == kvq.scale_shape(q8[0].shape)
    with torch.no_grad():
        logp_fp, (kf, vf) = tt._lm_forward_window(tok, i, fp, h, pe,
                                                  (ptab, ps))
        logp_q, (kq, vq, ks, vs) = tt._lm_forward_window(tok, i, q8, h, pe,
                                                         (ptab, ps))
    dq_k, dq_v = kvq.dequantize_view(kq, ks), kvq.dequantize_view(vq, vs)
    for fp_pool, dq in ((kf[0], dq_k[0]), (vf[0], dq_v[0])):
        amax = fp_pool.abs().amax(dim=-1, keepdim=True)
        assert bool(((fp_pool - dq).abs() <= amax / 254 + 1e-7).all())
    assert float((kf - dq_k).abs().max()) < 0.05
    assert float((vf - dq_v).abs().max()) < 0.05
    assert float((logp_fp - logp_q).abs().max()) < 0.5


def test_invalid_positions_write_values_and_scales_to_scratch(port):
    """A gated write under int8 sends the value AND its scale to the
    scratch page: no page a table references changes."""
    h = tt._lm_handles(port)
    ps, n_pages = 4, 4
    caches = tt.new_pools(h, n_pages, ps, "cpu", kv_quant="int8")
    ptab = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    valid = torch.tensor([[True], [False]])
    with torch.no_grad():
        _, caches = tt._lm_forward_window(
            torch.tensor([[3], [5]]), torch.tensor([[0], [1]]), caches, h,
            h.mods[1].table(2 * ps), (ptab, ps), valid=valid)
    kq, vq, ks, vs = caches
    for pool in (kq, vq, ks, vs):
        assert bool(pool[:, 0, 0].ne(0).any())            # row 0 wrote
        assert bool(pool[:, 1:n_pages].eq(0).all())       # row 1's pages
        assert bool(pool[:, n_pages, 1].ne(0).any())      # its gated write


def test_kv_quant_resolves_and_reports(port, monkeypatch):
    """``kv_quant=None`` reads BIGDL_SERVE_KV_QUANT, as the JAX decoder;
    an unknown mode raises naming it; ``stats()`` reports the mode and
    the pool's bytes per token."""
    monkeypatch.delenv(quant.ENV_KV_QUANT, raising=False)
    kw = dict(max_slots=2, n_pos=9, page_size=4, device="cpu")
    assert ContinuousDecoder(port, **kw).kv_quant == "off"
    monkeypatch.setenv(quant.ENV_KV_QUANT, "int8")
    dec = ContinuousDecoder(port, **kw)
    st = dec.stats()
    assert st["kv_quant"] == "int8"
    assert st["kv_bytes_per_token"] == kvq.bytes_per_token(2, 2, 8, "int8")
    assert [c.dtype for c in dec._caches[:2]] == [torch.int8] * 2
    off = ContinuousDecoder(port, kv_quant="OFF", **kw).stats()
    assert off["kv_quant"] == "off"
    assert off["kv_bytes_per_token"] == kvq.bytes_per_token(2, 2, 8, "off")
    with pytest.raises(ValueError, match="kv_quant='int4'"):
        ContinuousDecoder(port, kv_quant="int4", **kw)
    with pytest.raises(ValueError, match="kv_quant='int4'"):
        continuous_decode(port, SEEDS, 5, kv_quant="int4", **kw)


def test_step_reads_a_table_as_wide_as_its_positions(lm, port,
                                                     monkeypatch):
    """Each cycle's attention gets the page table cut to the pages its
    live rows' positions reach in that cycle (no column past them is
    read), and the tokens are the JAX decoder's all the same."""
    widths = []
    real = tt.paged_attention

    def spy(q, kpool, vpool, ptab, pos, *scales):
        widths.append(ptab.shape[1])
        return real(q, kpool, vpool, ptab, pos, *scales)

    monkeypatch.setattr(tt, "paged_attention", spy)
    seeds = [[1, 2, 3], [4]]
    dec = ContinuousDecoder(port, max_slots=2, n_pos=17, sync_interval=3,
                            page_size=4, device="cpu")
    futs = [dec.submit(s, n) for s, n in zip(seeds, (10, 2))]
    dec.run()
    assert dec.pages_per_slot == 5
    # 12 positions and 2, three steps of two layers a cycle: positions 3,
    # 6, 9 and 12 are reached, so 1, 2, 3 and 3 pages, never the
    # reservation's 5
    assert widths == [1] * 6 + [2] * 6 + [3] * 6 + [3] * 6
    want = jax_continuous(lm, seeds[:1], 10, max_slots=2, n_pos=17,
                          sync_interval=3, page_size=4, prefix_cache=False)
    assert futs[0].result() == want[0]


def test_a_retired_long_request_reads_no_column_past_the_table(lm, port):
    """A slot whose request had more pages than every live one is read at
    position -1 once retired (never at its old last position), so a
    table cut to the live rows' pages holds every column a step indexes;
    the tokens are the JAX decoder's.  Requests of 12, 10 and 8 steps on
    two slots of 4-position pages: the 12-step one (3 pages) retires at
    step 12 while only the 8-step one is live."""
    seeds, n_words = [[1, 2, 3], [4, 5], [6]], (10, 9, 8)
    kw = dict(max_slots=2, n_pos=12, sync_interval=2, page_size=4)
    dec = ContinuousDecoder(port, device="cpu", **kw)
    futs = [dec.submit(s, n) for s, n in zip(seeds, n_words)]
    dec.run()
    assert dec.retired == 3
    for seed, n, fut in zip(seeds, n_words, futs):
        want = jax_continuous(lm, [seed], n, prefix_cache=False, **kw)
        assert fut.result() == want[0]
