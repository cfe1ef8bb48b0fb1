"""The port's self-speculative decode (``ContinuousDecoder(spec_k=k)``)
against the JAX decoder with the same weights: greedy rows token for
token for k in {1, 2, 4}, alone, with prefix reuse, with stop sequences
and over int8 pools (``_held_to_jax_int8``'s rule); the step's
attention calls (k draft steps of ``draft_layers`` layers at S = 1, one
verify window of L layers at S = k+1, each given a table that covers
every position it reads); the acceptance counts; the environment
default."""
import pytest

from bigdl_tpu.models.transformer import lm_decode as jax_lm_decode
from bigdl_tpu.serve.decode import ContinuousDecoder as JaxDecoder
from bigdl_tpu.serve.decode import continuous_decode as jax_continuous
from bigdl_tpu_torch.models import transformer as tt
from bigdl_tpu_torch.serve import ContinuousDecoder, continuous_decode
from bigdl_tpu_torch.serve import decode as port_decode
from tests.helpers.torch_lm import SEEDS, jax_lm, port_of
from tests.test_torch_decode import _held_to_jax_int8


@pytest.fixture(scope="module")
def lm():
    return jax_lm()


@pytest.fixture(scope="module")
def port(lm):
    return port_of(lm)


@pytest.fixture(scope="module")
def serial(lm):
    return [jax_lm_decode(lm, s, 5, greedy=True) for s in SEEDS]


@pytest.mark.parametrize("page_size", [4, 5])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_greedy_rows_equal_jax_for_every_k(lm, port, serial, k, page_size):
    kw = dict(max_slots=2, n_pos=9, sync_interval=2, page_size=page_size,
              spec_k=k)
    got = continuous_decode(port, SEEDS, 5, device="cpu", **kw)
    assert got == jax_continuous(lm, SEEDS, 5, **kw) == serial


@pytest.mark.parametrize("draft_layers", [1, 2])
def test_any_draft_depth_commits_the_greedy_stream(port, serial,
                                                   draft_layers):
    got = continuous_decode(port, SEEDS, 5, max_slots=3, n_pos=9,
                            sync_interval=3, page_size=4, spec_k=3,
                            draft_layers=draft_layers, device="cpu")
    assert got == serial


@pytest.mark.parametrize("k", [1, 2, 4])
def test_spec_with_prefix_reuse_as_jax(lm, port, k):
    sys_p = [7, 3, 9, 1]
    seeds = [sys_p + [2], sys_p + [5]]
    oracle = [jax_lm_decode(lm, s, 4) for s in seeds]
    kw = dict(max_slots=2, n_pos=10, sync_interval=2, page_size=2,
              prefix_cache=True, spec_k=k)
    dec = ContinuousDecoder(port, device="cpu", **kw)
    f0 = dec.submit(seeds[0], 4)
    dec.run()
    futs = [dec.submit(s, 4) for s in seeds]
    dec.run()
    assert [f0.result()] + [f.result() for f in futs] == [oracle[0]] + oracle
    st = dec.stats()
    jdec = JaxDecoder(lm, **kw)
    jdec.submit(seeds[0], 4)
    jdec.run()
    [jdec.submit(s, 4) for s in seeds]
    jdec.run()
    assert st["prefix"]["hits"] == jdec.stats()["prefix"]["hits"] >= 2
    assert st["spec_windows"] > 0
    dec.close()
    jdec.close()


@pytest.mark.parametrize("k", [1, 3])
def test_int8_spec_held_to_jax(lm, port, k):
    kw = dict(max_slots=2, n_pos=9, sync_interval=2, page_size=4, spec_k=k,
              kv_quant="int8")
    got = continuous_decode(port, SEEDS, 5, device="cpu", **kw)
    want = jax_continuous(lm, SEEDS, 5, **kw)
    _held_to_jax_int8(lm, got, want, 4)
    # speculation commits the non-speculative int8 stream of this decoder
    assert got == continuous_decode(port, SEEDS, 5, device="cpu",
                                    **dict(kw, spec_k=0))


def test_spec_stop_sequences_as_jax(lm, port, serial):
    s, row = SEEDS[0], serial[0]
    stop, gen = row[len(s) + 1:len(s) + 3], row[len(s):]
    end = len(s) + 2 + next(j for j in range(len(gen))
                            if gen[j:j + 2] == stop)
    reqs = [(s, 5, {"stop": [stop]}),
            (SEEDS[3], 5, None), (SEEDS[1], 5, {"max_tokens": 2})]
    kw = dict(max_slots=2, n_pos=9, sync_interval=2, page_size=4, spec_k=3)
    out = []
    for dec in (ContinuousDecoder(port, device="cpu", **kw),
                JaxDecoder(lm, prefix_cache=False, **kw)):
        futs = [dec.submit(q, n, sampling=sp) for q, n, sp in reqs]
        dec.run()
        out.append(([f.result(timeout=60) for f in futs],
                    dec.stats()["stop_retired"]))
        dec.close()
    assert out[0] == out[1]
    assert out[0][0][0] == row[:end] and out[0][1] == 1


def test_step_calls_and_tables(lm, port, monkeypatch):
    """Every speculative step makes k * draft_layers attention calls at
    S = 1 and L at S = k+1, each with a table that covers the positions
    its live queries read (so ``paged_attention`` launches equal steps x
    (k * draft_layers + L) on the card); the tokens are the JAX
    decoder's."""
    calls = []
    real = tt.paged_attention

    def spy(q, kpool, vpool, ptab, pos, *scales):
        live = pos[pos >= 0]
        if live.numel():
            assert int(live.max()) < ptab.shape[1] * kpool.shape[1]
        calls.append(q.shape[1])
        return real(q, kpool, vpool, ptab, pos, *scales)

    monkeypatch.setattr(tt, "paged_attention", spy)
    k, Ld, L = 3, 1, 2
    kw = dict(max_slots=2, n_pos=17, sync_interval=2, page_size=4, spec_k=k,
              draft_layers=Ld)
    seeds = [[1, 2, 3], [4, 5, 6, 7, 8, 9]]
    dec = ContinuousDecoder(port, device="cpu", **kw)
    futs = [dec.submit(s, 10) for s in seeds]
    dec.run()
    assert len(calls) == dec.steps * (k * Ld + L)
    per_step = [1] * (k * Ld) + [k + 1] * L
    assert calls == per_step * dec.steps
    assert [f.result() for f in futs] == jax_continuous(
        lm, seeds, 10, prefix_cache=False, **kw)
    dec.close()


def test_acceptance_counts(port):
    k = 3
    dec = ContinuousDecoder(port, max_slots=2, n_pos=9, sync_interval=2,
                            page_size=4, spec_k=k, device="cpu")
    futs = [dec.submit(s, 5) for s in SEEDS]
    dec.run()
    assert all(f.done() for f in futs)
    st = dec.stats()
    assert st["spec_windows"] == sum(st["accept_hist"]) > 0
    assert st["spec_accepted"] == sum(a * n for a, n in
                                      enumerate(st["accept_hist"]))
    assert 0.0 <= st["accept_mean"] <= k
    assert 0 <= st["accept_p50"] <= k
    assert st["spec_k"] == k and st["draft_layers"] == 1
    # one position read a boundary: the host syncs equal the boundaries
    assert st["host_syncs"] == st["steps"] // 2


def test_spec_env_default(port, monkeypatch):
    kw = dict(max_slots=1, n_pos=9, page_size=4, device="cpu")
    monkeypatch.delenv(port_decode.ENV_SPEC_K, raising=False)
    assert ContinuousDecoder(port, **kw).spec_k == 0
    monkeypatch.setenv(port_decode.ENV_SPEC_K, "2")
    dec = ContinuousDecoder(port, **kw)
    assert dec.spec_k == 2 and dec.draft_layers == 1
    assert ContinuousDecoder(port, spec_k=0, **kw).spec_k == 0
    assert ContinuousDecoder(port, spec_k=1, draft_layers=9,
                             **kw).draft_layers == 2


def test_request_filling_its_last_page_needs_no_extra_page(lm, port):
    """Speculation reserves no page: a seed and budget that exactly fill
    their pages admit into exactly that many, the window's overshoot
    gated to the scratch page."""
    seed, n_words = [1, 2, 3, 4], 5             # 8 positions, 2 pages of 4
    dec = ContinuousDecoder(port, max_slots=1, n_pos=8, n_pages=2,
                            page_size=4, sync_interval=2, spec_k=4,
                            prefix_cache=False, device="cpu")
    fut = dec.submit(seed, n_words)
    dec.run()
    assert fut.result() == jax_lm_decode(lm, seed, n_words)
    assert dec.stats()["pool"]["in_use_hwm"] == 2
