"""The port's sampler (bigdl_tpu_torch/serve/sampling.py), its sampled
decode paths and beam search against the JAX package.

- ``SamplingParams``: validation, coercion, seed resolution;
- ``filter_logits`` against the JAX one at static scalars and per-row
  vectors: the same keep sets, the kept values within 1e-6;
- the counter-based generator: uniform within a chi-squared bound, and
  ``sample_tokens`` drawing a filtered row's probabilities (20,000 draws,
  chi-squared under the 0.999 quantile over tokens with p > 0.001);
- ``spec_accept_one``'s committed marginal (tests/test_sampling.py's
  10,000 fixed-key draws, chi-squared(7 df) < 24.3), and the decoder's
  speculative sampled stream against its non-speculative one (two-sample
  chi-squared(10 df) < 35, as there);
- the served sampled lane: greedy rows byte-identical beside sampled
  ones, a sampled row invariant to slot, companions and sync cadence and
  equal to ``lm_decode``'s under the same key; stop sequences and
  ``max_tokens`` against the JAX decoder's rows;
- ``lm_decode``'s draws against the JAX filter's probabilities, and
  ``lm_beam_search`` against tests/test_transformer.py's cases and the
  JAX beam search (rows equal, scores within rtol 1e-4).

The streams are not threefry's: the distributions are held, not bits.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import chi2

from bigdl_tpu.models.transformer import lm_beam_search as jax_beam
from bigdl_tpu.models.transformer import lm_decode as jax_lm_decode
from bigdl_tpu.nn.module import Context
from bigdl_tpu.serve import sampling as jsmp
from bigdl_tpu.serve.decode import ContinuousDecoder as JaxDecoder
from bigdl_tpu_torch.models import transformer as tt
from bigdl_tpu_torch.serve import (GREEDY, ContinuousDecoder, SamplingParams,
                                   continuous_decode)
from bigdl_tpu_torch.serve import sampling as smp
from tests.helpers.torch_lm import (VOCAB, chi2_two_sample, chi2_vs_expected,
                                    jax_lm, port_of)

SEQS = [[1, 2, 3], [4, 5], [6, 7, 8, 9], [2, 4]]
FILTER_TOL = dict(rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def lm():
    return jax_lm()


@pytest.fixture(scope="module")
def port(lm):
    return port_of(lm)


@pytest.fixture(scope="module")
def oracle(lm):
    return [jax_lm_decode(lm, s, 8) for s in SEQS]


def _drive(model, reqs, jax=False, **cfg):
    """reqs = [(seq, n_words, sampling-or-None), ...] -> (rows, stats)."""
    dec = (JaxDecoder(model, prefix_cache=False, **cfg) if jax else
           ContinuousDecoder(model, device="cpu", **cfg))
    futs = [dec.submit(s, n, sampling=sp) for s, n, sp in reqs]
    dec.run()
    rows = [f.result(timeout=60) for f in futs]
    stats = dec.stats()
    dec.close()
    return rows, stats


# ---------------------------------------------------------------------------
# SamplingParams
# ---------------------------------------------------------------------------

def test_defaults_are_greedy():
    assert GREEDY.greedy and GREEDY.seed is None and not GREEDY.stop
    assert SamplingParams.of(None) is GREEDY


def test_validation():
    with pytest.raises(ValueError, match="temperature"):
        SamplingParams(temperature=-0.1)
    with pytest.raises(ValueError, match="top_k"):
        SamplingParams(top_k=-1)
    with pytest.raises(ValueError, match="top_p"):
        SamplingParams(top_p=1.5)
    with pytest.raises(ValueError, match="non-empty"):
        SamplingParams(stop=((),))
    with pytest.raises(ValueError, match="max_tokens"):
        SamplingParams(max_tokens=0)
    with pytest.raises(TypeError, match="sampling must be"):
        SamplingParams.of(42)


def test_dict_roundtrip_matches_jax_form():
    p = SamplingParams(temperature=0.7, top_k=3, top_p=0.9, seed=123,
                       stop=((1, 2), (5,)), max_tokens=9)
    assert SamplingParams.of(p.to_dict()) == p
    assert SamplingParams.of(p) is p
    assert p.to_dict() == jsmp.SamplingParams.of(p.to_dict()).to_dict()


def test_resolved_pins_a_seed_exactly_once():
    r = SamplingParams(temperature=1.0).resolved()
    assert r.seed is not None
    assert r.resolved() is r
    assert GREEDY.resolved() is GREEDY
    stop_only = SamplingParams(stop=((3, 4),))
    assert stop_only.greedy and stop_only.resolved() is stop_only


# ---------------------------------------------------------------------------
# filter_logits against the JAX filter
# ---------------------------------------------------------------------------

def _held_to_jax(got, want):
    """The same keep set (-inf where the JAX filter drops), the kept
    values within 1e-6."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    keep = ~np.isneginf(want)
    np.testing.assert_allclose(got[keep], want[keep], **FILTER_TOL)


@pytest.mark.parametrize("top_p", [0.0, 0.5, 0.9, 1.0])
@pytest.mark.parametrize("top_k", [0, 1, 3, 50])
@pytest.mark.parametrize("temperature", [0.5, 0.7, 1.0, 2.0])
def test_filter_static_scalars_match_jax(temperature, top_k, top_p):
    lp = np.random.RandomState(0).randn(5, 50).astype(np.float32)
    got = smp.filter_logits(torch.from_numpy(lp), temperature, top_k, top_p)
    want = jsmp.filter_logits(jnp.asarray(lp), temperature, top_k, top_p)
    _held_to_jax(got, want)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_filter_per_row_vectors_match_jax(seed):
    rs = np.random.RandomState(seed)
    lp = rs.randn(6, 40).astype(np.float32)
    temps = np.asarray([1.0, 0.5, 2.0, 0.7, 0.0, 1.3], np.float32)
    ks = np.asarray([0, 3, 1, 40, 5, 0], np.int64)
    ps = np.asarray([0.0, 0.9, 0.0, 0.5, 0.3, 0.95], np.float32)
    got = smp.filter_logits(torch.from_numpy(lp), torch.from_numpy(temps),
                            torch.from_numpy(ks), torch.from_numpy(ps))
    want = jsmp.filter_logits(jnp.asarray(lp), jnp.asarray(temps),
                              jnp.asarray(ks), jnp.asarray(ps))
    _held_to_jax(got, want)
    for r in range(6):    # row r as the scalar call on row r alone
        one = smp.filter_logits(torch.from_numpy(lp[r:r + 1]),
                                float(temps[r]), int(ks[r]), float(ps[r]))
        np.testing.assert_array_equal(got[r].numpy(), one[0].numpy())


def test_filter_over_windows_matches_jax():
    """The verify window's form: (B, S, V) logits, (B,) parameters."""
    lp = np.random.RandomState(4).randn(3, 5, 30).astype(np.float32)
    temps, ks = np.asarray([0.8, 0.0, 1.5], np.float32), np.asarray([4, 0, 9])
    ps = np.asarray([0.9, 0.0, 0.6], np.float32)
    got = smp.filter_logits(torch.from_numpy(lp), torch.from_numpy(temps),
                            torch.from_numpy(ks), torch.from_numpy(ps))
    _held_to_jax(got, jsmp.filter_logits(jnp.asarray(lp), jnp.asarray(temps),
                                         jnp.asarray(ks), jnp.asarray(ps)))


def test_top_p_keeps_smallest_prefix_and_the_top_token():
    lp = torch.log(torch.tensor([[0.5, 0.3, 0.15, 0.05]]))
    out = smp.filter_logits(lp, 1.0, 0, 0.7)[0]
    assert bool(torch.isfinite(out[:2]).all())
    assert bool(torch.isneginf(out[2:]).all())
    out = smp.filter_logits(torch.log(torch.tensor([[0.9, 0.06, 0.04]])),
                            1.0, 0, 0.5)[0]
    assert bool(torch.isfinite(out[0])) and bool(torch.isneginf(out[1:]).all())


def test_greedy_rows_pass_through_unscaled():
    lp = torch.tensor([[1.0, 2.0, 3.0], [3.0, 2.0, 1.0]])
    out = smp.filter_logits(lp, torch.tensor([0.0, 0.5]), 0, 0.0)
    assert torch.equal(out[0], lp[0])
    assert torch.equal(out[1], lp[1] / 0.5)


# ---------------------------------------------------------------------------
# the counter-based generator
# ---------------------------------------------------------------------------

def _fold_keys(seed, n):
    return smp.fold_in_rows(smp.key_data(seed).expand(n, 2),
                            torch.arange(n))


def test_uniforms_are_uniform_and_streams_independent():
    """20,000 uniforms in 20 bins under the 0.999 quantile of
    chi-squared(19); the TAG_MAIN and TAG_FIX streams of one key and the
    streams of adjacent seeds correlate below 0.03."""
    keys = _fold_keys(5, 20000)
    u = smp.uniform_rows(keys).numpy()
    assert 0 < u.min() and u.max() < 1
    counts = np.histogram(u, bins=20, range=(0, 1))[0]
    assert chi2_vs_expected(counts, np.full(20, 0.05)) < chi2.ppf(0.999, 19)
    main = smp.uniform_rows(smp.fold_in_rows(keys, smp.TAG_MAIN)).numpy()
    fix = smp.uniform_rows(smp.fold_in_rows(keys, smp.TAG_FIX)).numpy()
    other = smp.uniform_rows(_fold_keys(6, 20000)).numpy()
    for a, b in ((main, fix), (u, other), (u, main)):
        assert abs(np.corrcoef(a, b)[0, 1]) < 0.03


def test_uniform_never_reaches_zero_or_one():
    """The extreme hashes give uniforms strictly inside (0, 1), so every
    Gumbel noise is finite and a -inf logit is never drawn."""
    u = smp._unit(torch.tensor([0, 0xFFFFFFFF], dtype=torch.int64))
    assert 0 < float(u[0]) and float(u[1]) < 1
    assert bool(torch.isfinite(-torch.log(-torch.log(u))).all())


def test_keys_are_a_function_of_seed_and_data():
    a = smp.fold_in_rows(smp.key_data(9), 3)
    assert torch.equal(a, smp.fold_in_rows(smp.key_data(9), 3))
    assert not torch.equal(a, smp.fold_in_rows(smp.key_data(9), 4))
    assert not torch.equal(a, smp.fold_in_rows(smp.key_data(2 ** 32 + 9), 3))
    assert smp.key_words(2 ** 40 + 7) == (2 ** 8, 7)
    assert bool(((a >= 0) & (a < 2 ** 32)).all())


@pytest.mark.parametrize("filt", [(1.0, 0, 0.0), (0.8, 20, 0.9),
                                  (1.3, 0, 0.8)])
def test_sample_tokens_draws_the_filtered_row(filt):
    """20,000 draws of one row under per-draw keys against the
    probabilities of the JAX filter (tokens with p > 0.001; the rest must
    stay undrawn where the filter drops them)."""
    lp = np.random.RandomState(11).randn(50).astype(np.float32) * 1.5
    want = np.asarray(jax.nn.softmax(jsmp.filter_logits(
        jnp.asarray(lp)[None], *filt)[0]), np.float64)
    n = 20000
    toks = smp.sample_tokens(torch.from_numpy(lp).expand(n, 50),
                             _fold_keys(21, n), *filt).numpy()
    counts = np.bincount(toks, minlength=50)
    assert counts[want == 0].sum() == 0
    big = want > 0.001
    rest = counts[~big].sum()
    stat = chi2_vs_expected(np.append(counts[big], rest),
                            np.append(want[big], want[~big].sum()))
    assert stat < chi2.ppf(0.999, int(big.sum()))


def test_per_row_keys_match_single_key_rows():
    lp = torch.from_numpy(np.random.RandomState(3).randn(3, VOCAB)
                          .astype(np.float32))
    keys = torch.stack([smp.key_data(s) for s in (7, 8, 9)])
    batched = smp.sample_tokens(lp, keys, 1.0)
    singles = [int(smp.sample_tokens(lp[i:i + 1], keys[i:i + 1], 1.0)[0])
               for i in range(3)]
    assert batched.tolist() == singles


# ---------------------------------------------------------------------------
# lossless speculative sampling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["disjointish", "filtered",
                                  "draft_equals_target"])
def test_committed_marginal_is_exactly_p(case):
    """tests/test_sampling.py's pin: 10,000 fixed-key draws through
    draft -> accept/reject -> residual match softmax(p), chi-squared(7)
    under 24.3."""
    rng = np.random.RandomState(7)
    p = torch.from_numpy(rng.randn(8).astype(np.float32))
    q = torch.from_numpy(rng.randn(8).astype(np.float32) * 1.5)
    if case == "filtered":
        p = smp.filter_logits(p, 0.8, 4)
        q = smp.filter_logits(q, 0.8, 4)
    elif case == "draft_equals_target":
        q = p
    toks = smp.spec_accept_one(_fold_keys(1234, 10000), p, q).numpy()
    counts = np.bincount(toks, minlength=8)
    probs = torch.softmax(p, dim=-1).double().numpy()
    assert counts[probs == 0].sum() == 0
    assert chi2_vs_expected(counts, probs) < 24.3


def test_rejection_path_is_exercised():
    """With a far-off draft the accept rate is well under 1, so the pin
    above covers the residual branch, not just accepts."""
    p = torch.tensor([2.0, 0.0, -2.0, 0.0])
    q = torch.tensor([-2.0, 0.0, 2.0, 0.0])
    keys = _fold_keys(5, 2000)
    drafts = smp.categorical(smp.fold_in_rows(keys, 0), q)
    toks = smp.spec_accept_one(keys, p, q)
    assert int((toks != drafts).sum()) > 200


def _unigram(port, seed0, **cfg):
    """Unigram counts over 16 sampled requests' generated tails (16
    tokens each)."""
    reqs = [(SEQS[i % len(SEQS)], 16, {"temperature": 1.0, "seed": seed0 + i})
            for i in range(16)]
    rows, _ = _drive(port, reqs, max_slots=4, n_pos=32, page_size=8,
                     sync_interval=4, **cfg)
    toks = np.concatenate([np.asarray(r[len(SEQS[i % len(SEQS)]):])
                           for i, r in enumerate(rows)])
    return np.bincount(toks, minlength=VOCAB)


@pytest.fixture(scope="module")
def nonspec_counts(port):
    return _unigram(port, 10_000)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_spec_matches_nonspec_distribution(port, nonspec_counts, k):
    spec = _unigram(port, 30_000 + 1000 * k, spec_k=k)
    assert spec.sum() == nonspec_counts.sum()
    assert chi2_two_sample(spec, nonspec_counts) < 35.0


def test_spec_matches_nonspec_distribution_int8_kv(port):
    spec = _unigram(port, 40_000, spec_k=3, kv_quant="int8")
    nonspec = _unigram(port, 20_000, kv_quant="int8")
    assert chi2_two_sample(spec, nonspec) < 35.0


# ---------------------------------------------------------------------------
# the served sampled lane
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [
    pytest.param({"page_size": 4}, id="paged"),
    pytest.param({"page_size": 4, "spec_k": 2}, id="spec"),
    pytest.param({"page_size": 4, "kv_quant": "off", "prefix_cache": True},
                 id="prefix"),
])
def test_explicit_greedy_params_are_byte_identical(port, oracle, cfg):
    reqs = [(s, 8, SamplingParams(temperature=0.0)) for s in SEQS]
    rows, _ = _drive(port, reqs, max_slots=2, n_pos=16, sync_interval=3,
                     **cfg)
    assert rows == oracle


@pytest.mark.parametrize("spec_k", [0, 2])
def test_mixed_batch_keeps_greedy_rows_byte_identical(port, oracle, spec_k):
    reqs = [(s, 8, {"temperature": 1.0, "top_k": 5, "top_p": 0.9,
                    "seed": 50 + i} if i % 2 else None)
            for i, s in enumerate(SEQS)]
    kw = dict(max_slots=2, n_pos=16, sync_interval=3, page_size=4,
              spec_k=spec_k)
    rows, stats = _drive(port, reqs, **kw)
    greedy_only, _ = _drive(port, [(s, 8, None) for s in SEQS], **kw)
    for i, (row, ora) in enumerate(zip(rows, oracle)):
        assert len(row) == len(ora)
        if i % 2 == 0:
            assert row == ora == greedy_only[i], f"greedy row {i} drifted"
    assert stats["sampled"] == 2


@pytest.mark.parametrize("spec_k", [0, 3])
def test_sampled_row_is_schedule_invariant(port, spec_k):
    """The replay contract: the same (seed, params) draws the same stream
    in any slot, beside any companions, at any sync cadence; without
    speculation, also after a prefix hit and as ``lm_decode``'s row."""
    sp = {"temperature": 1.0, "top_k": 4, "seed": 77}
    rows = []
    for cfg, extra in ((dict(max_slots=2, n_pos=16, sync_interval=3,
                             page_size=4), 3),
                       (dict(max_slots=4, n_pos=24, sync_interval=5,
                             page_size=8), 0),
                       (dict(max_slots=3, n_pos=16, sync_interval=2,
                             page_size=4), 1)):
        reqs = [(SEQS[i], 8, None) for i in range(extra)]
        reqs.append(([9, 3], 8, sp))
        got, _ = _drive(port, reqs, spec_k=spec_k, **cfg)
        rows.append(got[-1])
    assert rows[0] == rows[1] == rows[2]
    if not spec_k:
        assert rows[0] == tt.lm_decode(port, [9, 3], 8, greedy=False,
                                       key=77, top_k=4, device="cpu")
        seed = [5, 6, 7, 8, 9, 3]          # a page of 4 shared, then a hit
        dec = ContinuousDecoder(port, max_slots=2, n_pos=16,
                                sync_interval=3, page_size=4, device="cpu")
        cold = dec.submit(seed, 8, sampling=sp)
        dec.run()
        hit = dec.submit(seed, 8, sampling=sp)
        dec.run()
        assert dec.stats()["prefix"]["hits"] == 1
        assert hit.result() == cold.result()
        dec.close()


def test_sampled_request_resolves_its_seed(port):
    """A sampled request with no seed is given one at submit; resubmitted
    with it, it redraws the same row."""
    dec = ContinuousDecoder(port, max_slots=2, n_pos=16, page_size=4,
                            device="cpu")
    params = SamplingParams(temperature=0.9).resolved()
    a = dec.submit([1, 2], 6, sampling=params)
    b = dec.submit([1, 2], 6, sampling=params.to_dict())
    dec.run()
    assert a.result() == b.result()
    dec.close()


def _stop_case(oracle):
    """A request of SEQS[0] whose stop sequence is its generated tokens 2
    and 3 (their first occurrence)."""
    s, ora = SEQS[0], oracle[0]
    stop = list(ora[len(s) + 2:len(s) + 4])
    gen = ora[len(s):]
    first = next(j for j in range(len(gen) - 1) if gen[j:j + 2] == stop)
    return s, stop, len(s) + first + 2


@pytest.mark.parametrize("spec_k", [0, 2])
def test_stop_truncates_as_jax(lm, port, oracle, spec_k):
    """The row ends just past the matched stop sequence, as the JAX
    decoder's row for the same request; the saved steps are counted; the
    neighbour runs to full length."""
    s, stop, end = _stop_case(oracle)
    reqs = [(s, 16, {"stop": [stop]}), (SEQS[1], 16, None)]
    kw = dict(max_slots=2, n_pos=32, sync_interval=3, page_size=4,
              spec_k=spec_k)
    rows, stats = _drive(port, reqs, **kw)
    jrows, jstats = _drive(lm, reqs, jax=True, **kw)
    assert rows == jrows
    assert rows[0] == oracle[0][:end]
    assert len(rows[1]) == len(SEQS[1]) + 16
    assert stats["stop_retired"] == jstats["stop_retired"] == 1
    assert stats["steps_saved"] == jstats["steps_saved"] > 0


def test_stop_matches_generated_output_only(port, oracle):
    probe = next(((s, ora, t) for s, ora in zip(SEQS, oracle)
                  for t in s if t not in ora[len(s):]), None)
    assert probe, "the fixture model generates every seed token"
    s, ora, tok = probe
    rows, stats = _drive(port, [(s, 8, {"stop": [[tok]]})], max_slots=2,
                         n_pos=16, sync_interval=3)
    assert rows[0] == ora
    assert stats["stop_retired"] == 0


def test_stop_capacity_overflow_fails_own_future(port):
    dec = ContinuousDecoder(port, max_slots=2, n_pos=16, sync_interval=3,
                            device="cpu")
    bad = dec.submit([1, 2], 4, sampling={"stop": [[1], [2], [3]]})
    ok = dec.submit([1, 2], 4)
    dec.run()
    with pytest.raises(ValueError, match="max_stop_seqs"):
        bad.result()
    assert len(ok.result()) == 6
    dec.close()
    wide = ContinuousDecoder(port, max_slots=2, n_pos=32, sync_interval=3,
                             max_stop_len=12, device="cpu")
    fut = wide.submit([1, 2], 4, sampling={"stop": [list(range(9))]})
    wide.run()
    assert len(fut.result()) == 6
    wide.close()


def test_max_tokens_caps_n_words_as_jax(lm, port, oracle):
    reqs = [(SEQS[0], 8, {"max_tokens": 3}), (SEQS[2], 8, None)]
    kw = dict(max_slots=2, n_pos=16, sync_interval=3, page_size=4)
    rows, _ = _drive(port, reqs, **kw)
    assert rows == _drive(lm, reqs, jax=True, **kw)[0]
    assert rows[0] == oracle[0][:len(SEQS[0]) + 3]


def test_continuous_decode_takes_sampling_per_row(port, oracle):
    sp = {"temperature": 1.0, "seed": 4}
    rows = continuous_decode(port, SEQS, 8, max_slots=2, n_pos=16,
                             page_size=4, sampling=[None, sp, None, sp],
                             device="cpu")
    assert rows[0] == oracle[0] and rows[2] == oracle[2]
    assert rows[1][len(SEQS[1]):] != oracle[1][len(SEQS[1]):] or \
        rows[3][len(SEQS[3]):] != oracle[3][len(SEQS[3]):]
    with pytest.raises(ValueError, match="entries"):
        continuous_decode(port, SEQS, 8, sampling=[None], device="cpu")


# ---------------------------------------------------------------------------
# lm_decode and lm_beam_search
# ---------------------------------------------------------------------------

def test_lm_decode_sampled_validates_and_is_deterministic(port):
    with pytest.raises(ValueError, match="key"):
        tt.lm_decode(port, [1, 2], 4, greedy=False, device="cpu")
    with pytest.raises(ValueError, match="top_p"):
        tt.lm_decode(port, [1, 2], 4, greedy=False, key=0, top_p=1.5,
                     device="cpu")
    with pytest.raises(ValueError, match="temperature"):
        tt.lm_decode(port, [1, 2], 4, greedy=False, key=0, temperature=0,
                     device="cpu")
    a = tt.lm_decode(port, [1, 2, 3], 8, greedy=False, key=42,
                     temperature=0.8, top_k=3, device="cpu")
    b = tt.lm_decode(port, [1, 2, 3], 8, greedy=False, key=42,
                     temperature=0.8, top_k=3, device="cpu")
    assert a == b and len(a) == 11 and all(0 <= t < VOCAB for t in a)


@pytest.mark.parametrize("filt", [(1.0, 0, 0.0), (0.7, 3, 0.0),
                                  (1.2, 0, 0.8)])
def test_lm_decode_draws_follow_the_jax_filter(lm, port, filt):
    """4,000 rows of one seed, each its own key (``key + b``): the first
    generated token's counts against softmax of the JAX filter over the
    JAX model's log-probs at the seed's last position."""
    seed, n = [2, 5, 1], 4000
    x = jnp.asarray(np.eye(VOCAB, dtype=np.float32)[seed])[None]
    lp, _ = lm.apply(lm.params(), x, lm.state(),
                     Context(training=False, key=jax.random.PRNGKey(0)))
    want = np.asarray(jax.nn.softmax(jsmp.filter_logits(lp[0, -1:], *filt)
                                     [0]), np.float64)
    rows = tt.lm_decode(port, [seed] * n, 1, greedy=False, key=1000,
                        temperature=filt[0], top_k=filt[1], top_p=filt[2],
                        device="cpu")
    counts = np.bincount([r[-1] for r in rows], minlength=VOCAB)
    assert counts[want == 0].sum() == 0
    big = want > 0.001
    stat = chi2_vs_expected(np.append(counts[big], counts[~big].sum()),
                            np.append(want[big], want[~big].sum()))
    assert stat < chi2.ppf(0.999, int(big.sum()))


@pytest.fixture(scope="module")
def beam_models():
    lm5 = jax_lm(seed=11, vocab=5, n_layers=1)
    return lm5, port_of(lm5, vocab=5, n_layers=1)


def test_beam_one_equals_greedy_decode(beam_models):
    _, m = beam_models
    seed = [1, 3, 2]
    assert tt.lm_beam_search(m, seed, 6, beam_size=1, device="cpu") == \
        tt.lm_decode(m, seed, 6, device="cpu")


def test_wide_beam_matches_exhaustive_search_and_jax(beam_models):
    """beam_size >= vocab ** n_words is exhaustive: the winner is the
    argmax continuation under the model's own teacher-forced scoring, and
    every row and score is the JAX beam search's."""
    jm, m = beam_models
    V, n_words, seed = 5, 3, [2, 4]

    def score(cont):
        ids = torch.tensor(seed + list(cont))
        with torch.no_grad():
            out = m(torch.nn.functional.one_hot(ids, V).float()[None])[0]
        return sum(float(out[len(seed) - 1 + j, cont[j]])
                   for j in range(n_words))

    best = max(itertools.product(range(V), repeat=n_words), key=score)
    rows, scores = tt.lm_beam_search(m, seed, n_words, beam_size=V ** 3,
                                     return_all=True, device="cpu")
    assert rows[0] == seed + list(best)
    np.testing.assert_allclose(scores[0], score(best), rtol=1e-4)
    assert scores == sorted(scores, reverse=True)
    jrows, jscores = jax_beam(jm, seed, n_words, beam_size=V ** 3,
                              return_all=True)
    assert rows[:10] == jrows[:10]
    np.testing.assert_allclose(scores, jscores, rtol=1e-4)


@pytest.mark.parametrize("beam_size", [2, 3, 4])
def test_beam_rows_match_jax_distinct_and_prefixed(beam_models, beam_size):
    jm, m = beam_models
    seed = [1, 2]
    rows, scores = tt.lm_beam_search(m, seed, 4, beam_size=beam_size,
                                     return_all=True, device="cpu")
    jrows, jscores = jax_beam(jm, seed, 4, beam_size=beam_size,
                              return_all=True)
    assert rows == jrows
    np.testing.assert_allclose(scores, jscores, rtol=1e-4)
    assert len(set(map(tuple, rows))) == beam_size
    assert all(r[:2] == seed for r in rows)


def test_beam_search_over_a_page_boundary(lm, port):
    """A seed and continuation past one 16-token page: the reorder copies
    the pages written so far; rows equal the JAX beam search's."""
    seed = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 1, 2, 3, 4]
    rows = tt.lm_beam_search(port, seed, 6, beam_size=3, return_all=True,
                             device="cpu")
    jrows = jax_beam(lm, seed, 6, beam_size=3, return_all=True)
    assert rows[0] == jrows[0]
    np.testing.assert_allclose(rows[1], jrows[1], rtol=1e-4)


def test_beam_rejects_bad_inputs(beam_models):
    _, m = beam_models
    with pytest.raises(ValueError, match="beam_size"):
        tt.lm_beam_search(m, [1], 2, beam_size=0, device="cpu")
    with pytest.raises(ValueError, match="flat"):
        tt.lm_beam_search(m, [[1, 2]], 2, device="cpu")
