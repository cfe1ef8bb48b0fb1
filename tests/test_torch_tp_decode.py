"""Serving's tensor parallelism in the port (``ContinuousDecoder(mesh=)``,
``continuous_decode(mesh=)``, bigdl_tpu_torch/serve/decode.py) under gloo,
held against the JAX package's tensor-parallel decoder on the conftest
CPU mesh (tests/test_serve_cluster.py:527-582, its model and seeds), its
``lm_decode`` rows and the port's one-device decoder: greedy fp32, the
speculative step at page size 4 (what the JAX
``test_tp_token_parity_flags_on`` specifies), int8 KV by the JAX int8
window rule, a prefix-cache wave, sampled rows and stop sequences, four
heads at mp = 4, a ``{"data": 2, "model": 2}`` mesh; each rank's weight
shards against the JAX weights placed by ``_tp_weight_specs``; each
rank's pools at H/tp heads; the all-reduces and attention calls a step;
the digest guard; the divisibility errors in the JAX words.

The ranks are spawned processes that import the port alone
(``tests/helpers/torch_distri_workers.py`` ``tp_decode_case``); each
world size is spawned once and runs every case of its size."""
import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding

from bigdl_tpu.models.transformer import TransformerLM as JaxLM
from bigdl_tpu.models.transformer import _lm_handles as jax_handles
from bigdl_tpu.models.transformer import lm_decode as jax_lm_decode
from bigdl_tpu.parallel.mesh import hybrid_mesh as jhybrid_mesh
from bigdl_tpu.parallel.mesh import make_mesh as jmake_mesh
from bigdl_tpu.serve.decode import ContinuousDecoder as JaxDecoder
from bigdl_tpu.serve.decode import _tp_weight_specs as jax_tp_specs
from bigdl_tpu.serve.decode import continuous_decode as jax_continuous
from bigdl_tpu.utils.random import set_seed
from bigdl_tpu_torch.parallel.launch import launch
from tests.helpers import torch_distri_workers as W
from tests.test_torch_decode import _held_to_jax_int8

SEEDS = [[1, 2, 3], [4, 5], [6], [7, 8, 9, 10], [2, 4]]   # :546
BASE = dict(max_slots=2, n_pos=9, sync_interval=3)          # :547-548
SPEC = dict(BASE, page_size=4, spec_k=2)                    # :293-294
INT8 = dict(BASE, page_size=4, kv_quant="int8")
INT8_SPEC = dict(INT8, spec_k=2)
# a prefix-cache wave: an 8-token system prompt (two pages of 4) ahead of
# each request's own tail, served twice from one decoder
SYSTEM = [3, 1, 4, 1, 5, 9, 2, 6]
PREFIX_SEEDS = [SYSTEM + t for t in ([7], [8, 2], [10, 10, 1], [5])]
PREFIX = dict(max_slots=2, n_pos=16, sync_interval=3, page_size=4,
              prefix_cache=True)
SAMPLED = [{"temperature": 0.8, "top_k": 5, "seed": 11}, None,
           {"temperature": 1.0, "top_p": 0.9, "seed": 12}, None,
           {"temperature": 0.7, "seed": 13}]


def _arch(n_heads=2, d_model=16, hidden=32):
    return dict(vocab_size=11, d_model=d_model, n_heads=n_heads,
                n_layers=2, hidden=hidden, dropout=0.0)


def _jax_lm(n_heads=2, d_model=16, hidden=32):
    """tests/test_serve_cluster.py:530-534's model (``n_heads`` 4 at mp =
    4), from ``set_seed(1)``."""
    set_seed(1)
    return JaxLM(vocab_size=11, d_model=d_model, n_heads=n_heads,
                 n_layers=2, hidden=hidden)


def _params(lm):
    return jax.tree_util.tree_map(np.asarray, lm.params())


def _stop_case(serial):
    """SEEDS with a stop sequence on the fourth request: its generated
    tokens 1-2 of the greedy row, so it ends just past them."""
    gen = serial[3][len(SEEDS[3]):]
    stop = gen[1:3]
    end = len(SEEDS[3]) + next(j + 2 for j in range(len(gen) - 1)
                               if gen[j:j + 2] == stop)
    sampling = list(SAMPLED)
    sampling[3] = {"stop": [stop]}
    return sampling, end


@pytest.fixture(scope="module")
def lm():
    return _jax_lm()


@pytest.fixture(scope="module")
def serial(lm):
    return [jax_lm_decode(lm, s, 5, greedy=True) for s in SEEDS]


@pytest.fixture(scope="module")
def jmesh():
    return jhybrid_mesh(dp=1, mp=2, devices=jax.devices()[:2])


@pytest.fixture(scope="module")
def world2(lm, serial):
    """Every mp = 2 case on one spawn of two gloo ranks: {name: [rank 0's
    result, rank 1's]}."""
    sampling, _ = _stop_case(serial)
    cases = {
        "greedy": dict(seeds=SEEDS, n_words=5, kw=BASE),
        "spec": dict(seeds=SEEDS, n_words=5, kw=SPEC),
        "int8": dict(seeds=SEEDS, n_words=5, kw=INT8),
        "int8_spec": dict(seeds=SEEDS, n_words=5, kw=INT8_SPEC),
        "prefix": dict(seeds=PREFIX_SEEDS, n_words=5, kw=PREFIX, waves=2),
        "sampled": dict(seeds=SEEDS, n_words=5, kw=BASE, sampling=sampling),
        "sampled_spec": dict(seeds=SEEDS, n_words=5, kw=SPEC,
                             sampling=sampling),
        "unseeded": dict(seeds=SEEDS[:2], n_words=5, kw=BASE,
                         sampling=[None, {"temperature": 0.7}]),
        "mismatch": dict(seeds=SEEDS, n_words=5, kw=BASE, alter=1),
    }
    greedy = [cases["greedy"]]
    ranks = launch(W.calls, 2, "gloo", args=([
        (W.tp_decode_case, (_arch(), _params(lm), 1, 2,
                            list(cases.values()))),
        (W.tp_decode_case, (_arch(), _params(lm), 2, 1, greedy))],))
    out = {name: [r[0][i] for r in ranks] for i, name in enumerate(cases)}
    out["data_only"] = [r[1][0] for r in ranks]
    return out


@pytest.fixture(scope="module")
def world4(lm):
    """mp = 4 (four heads) and ``{"data": 2, "model": 2}`` (the mp = 2
    model) on one spawn of four gloo ranks."""
    lm4 = _jax_lm(n_heads=4)
    cases = [dict(seeds=SEEDS, n_words=5, kw=kw)
             for kw in (BASE, SPEC, INT8_SPEC)]
    ranks = launch(W.calls, 4, "gloo", args=([
        (W.tp_decode_case, (_arch(4), _params(lm4), 1, 4, cases)),
        (W.tp_decode_case, (_arch(), _params(lm), 2, 2, cases[:2]))],))
    return lm4, ranks


def _same_on_every_rank(res):
    rows = [r["tp"]["rows"] for r in res]
    assert all(x == rows[0] for x in rows)
    return rows[0]


def _check_counts(r, spec_k=0, draft_layers=1, layers=2):
    """One attention call a layer of each forward and two all-reduces a
    block, as the one-device decoder's attention calls."""
    tp, one = r["tp"], r["one"]
    steps = tp["stats"][-1]["steps"]
    per_step = spec_k * draft_layers + layers
    assert tp["calls"]["attention"] == per_step * steps
    assert tp["calls"]["all_reduce"] == 2 * tp["calls"]["attention"]
    assert one["calls"] == {"attention": tp["calls"]["attention"],
                            "all_reduce": 0}


# -- greedy fp32 at mp = 2 ------------------------------------------------

def test_greedy_rows_equal_jax_tp_and_serial(world2, lm, serial, jmesh):
    """tests/test_serve_cluster.py:536-546's bar, on every rank: the JAX
    tensor-parallel decoder's rows, ``lm_decode``'s, the one-device
    port's."""
    want = jax_continuous(lm, SEEDS, 5, mesh=jmesh, **BASE)
    res = world2["greedy"]
    got = _same_on_every_rank(res)
    assert got == [want] and want == serial
    assert res[0]["one"]["rows"] == [serial]
    _check_counts(res[0])
    _check_counts(res[1])


def test_spec_window_rows_equal_serial(world2, lm, serial, jmesh):
    """spec_k=2 at page size 4 decodes the serial rows with the attention
    on each rank's local heads (``test_tp_token_parity_flags_on``'s
    contract), as the JAX TP decoder does without the interpret flags."""
    want = jax_continuous(lm, SEEDS, 5, mesh=jmesh, **SPEC)
    res = world2["spec"]
    assert _same_on_every_rank(res) == [serial] == [want]
    assert res[0]["one"]["rows"] == [serial]
    for r in res:
        _check_counts(r, spec_k=2)


# -- int8 KV --------------------------------------------------------------

@pytest.mark.parametrize("name,kw", [("int8", INT8),
                                     ("int8_spec", INT8_SPEC)])
def test_int8_rows_held_to_jax_tp(world2, lm, jmesh, name, kw):
    """int8 pools at H/tp heads, their scales sharded with them: every
    rank's rows are the JAX TP int8 decoder's, or part from them only
    where both tokens sit within 1e-3 of the JAX int8 window forward's
    maximum; and they are the one-device port's int8 rows."""
    want = jax_continuous(lm, SEEDS, 5, mesh=jmesh, **kw)
    res = world2[name]
    got = _same_on_every_rank(res)[0]
    _held_to_jax_int8(lm, got, want, 4)
    assert got == res[0]["one"]["rows"][0]
    for r in res:
        _check_counts(r, spec_k=kw.get("spec_k", 0))


def test_pools_hold_the_ranks_heads(world2):
    """Each rank's pools are its own contiguous arrays of H/tp = 1 head:
    (L, n_pages + 1, ps, 1, hd), int8 with (L, n_pages + 1, ps, 1)
    scales; the one-device pools hold both heads."""
    for r in world2["greedy"]:
        assert r["tp"]["pools"] == [((2, 3, 16, 1, 8), "torch.float32",
                                     True)] * 2
        assert r["one"]["pools"][0][0] == (2, 3, 16, 2, 8)
    for r in world2["int8"]:
        assert r["tp"]["pools"] == (
            [((2, 7, 4, 1, 8), "torch.int8", True)] * 2
            + [((2, 7, 4, 1), "torch.float32", True)] * 2)
        # the whole model's bytes a token, as the JAX decoder reports
        assert (r["tp"]["stats"][0]["kv_bytes_per_token"]
                == r["one"]["stats"][0]["kv_bytes_per_token"]
                == 2 * 2 * (2 * 8 + 2 * 4))


# -- the prefix cache, sampling and stops ---------------------------------

def test_prefix_wave_hits_and_keeps_rows(world2, lm):
    """The second wave maps the first wave's system-prompt pages on every
    rank (every request a hit, fewer steps) and both waves decode the
    serial rows."""
    serial = [jax_lm_decode(lm, s, 5, greedy=True) for s in PREFIX_SEEDS]
    res = world2["prefix"]
    waves = _same_on_every_rank(res)
    assert waves == [serial, serial] == res[0]["one"]["rows"]
    for r in res:
        st = r["tp"]["stats"]
        assert st[1]["prefix"]["hits"] - st[0]["prefix"]["hits"] == 4
        assert st[1]["steps"] - st[0]["steps"] < st[0]["steps"]
        assert st[1]["prefix"] == r["one"]["stats"][1]["prefix"]


@pytest.mark.parametrize("name", ["sampled", "sampled_spec"])
def test_sampled_and_stop_rows_equal_one_device(world2, serial, name):
    """Sampled requests (seeded) and a stop sequence: every rank's rows
    are the one-device port's under the same ``SamplingParams``, the
    greedy rows ``lm_decode``'s and the stop row cut just past its
    match."""
    _, end = _stop_case(serial)
    res = world2[name]
    got = _same_on_every_rank(res)[0]
    assert got == res[0]["one"]["rows"][0]
    assert got[1] == serial[1] and got[3] == serial[3][:end]
    assert res[0]["tp"]["stats"][0]["stop_retired"] == 1
    assert res[0]["tp"]["stats"][0]["sampled"] == 3


def test_unseeded_sampled_request_fails_itself(world2):
    """A sampled request with no seed would draw its key on each rank
    apart: under TP its own future fails, naming the rule."""
    for r in world2["unseeded"]:
        assert r["refused"][0] == "ValueError"
        assert "names its seed" in r["refused"][1]


def test_stats_tp_and_host_syncs(world2):
    """``stats()["tp"]`` is the model axis's size; the boundaries read
    the device as often as the one-device decoder's, and each compares
    the admission digests once."""
    for name in ("greedy", "spec", "int8", "prefix", "sampled"):
        for r in world2[name]:
            for tp, one in zip(r["tp"]["stats"], r["one"]["stats"]):
                assert tp["tp"] == 2 and one["tp"] == 1
                assert tp["host_syncs"] == one["host_syncs"]
                assert tp["steps"] == one["steps"]
                assert tp["tp_checks"] == tp["steps"] // 3


def test_model_axis_of_one_serves_on_one_device(world2, serial):
    """``{"data": 2, "model": 1}``: no tensor parallelism, each rank a
    replica serving the serial rows with its whole model, no all-reduce
    and no digest check."""
    for r in world2["data_only"]:
        tp = r["tp"]
        assert tp["rows"] == [serial] and tp["stats"][0]["tp"] == 1
        assert "tp_checks" not in tp["stats"][0]
        assert tp["calls"]["all_reduce"] == 0
        assert tp["pools"][0][0] == (2, 3, 16, 2, 8)


def test_digest_guard_raises_on_every_rank(world2):
    """Rank 1 submits its second request one token longer: both ranks
    raise at the first boundary, naming their own digest and the group's
    range, and every future fails; nothing hangs."""
    res = world2["mismatch"]
    digests = set()
    for r in res:
        kind, text = r["tp"]["raised"]
        assert kind == "ReplicaMismatchError"
        assert f"model index {r['model_index']} of 2" in text
        assert r["tp"]["futures"] == ["ReplicaMismatchError"] * len(SEEDS)
        digests.add(text.split("admission digest ")[1].split(",")[0])
    assert len(digests) == 2
    for r in res:
        for d in digests:
            assert d in r["tp"]["raised"][1]


# -- the weight shards ----------------------------------------------------

def _jax_shards(lm, jmesh):
    """Each leaf of the JAX decode weights placed by ``_tp_weight_specs``
    with ``NamedSharding``: {path: [model index 0's shard, 1's, ...]}."""
    h = jax_handles(lm)
    tree = {"emb": h.emb, "blocks": h.blocks, "ln_f": h.ln_f,
            "head": h.head}
    placed = jax.device_put(tree, jax.tree_util.tree_map(
        lambda sp: NamedSharding(jmesh, sp), jax_tp_specs(h, "model")))
    names = ("ln1", "attn", "ln2", "lin1", "lin2")
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(placed)[0]:
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        keys = [k for k in keys if k != "~"]
        if keys[0] == "blocks":
            keys = ["blocks", keys[1], names[keys[2]], keys[3]]
        by_dev = {s.device: np.asarray(s.data)
                  for s in leaf.addressable_shards}
        out["/".join(map(str, keys))] = [by_dev[d]
                                         for d in jmesh.devices[0]]
    return out


def test_weight_shards_equal_jax_named_sharding(world2, lm, jmesh):
    want = _jax_shards(lm, jmesh)
    for r in world2["greedy"]:
        got = r["tp"]["handles"]
        assert sorted(got) == sorted(want)
        for path, shards in want.items():
            np.testing.assert_array_equal(got[path],
                                          shards[r["model_index"]],
                                          err_msg=path)


# -- four ranks -----------------------------------------------------------

def test_mp4_rows_equal_jax_tp_and_serial(world4):
    """Four heads over ``hybrid_mesh(1, 4)``: greedy, spec k = 2 and int8
    with spec on every rank, against the JAX TP decoder at mp = 4 and
    ``lm_decode``."""
    lm4, ranks = world4
    jmesh4 = jhybrid_mesh(dp=1, mp=4, devices=jax.devices()[:4])
    serial = [jax_lm_decode(lm4, s, 5, greedy=True) for s in SEEDS]
    res = [r[0] for r in ranks]
    for i, kw in enumerate((BASE, SPEC)):
        want = jax_continuous(lm4, SEEDS, 5, mesh=jmesh4, **kw)
        case = [r[i] for r in res]
        assert _same_on_every_rank(case) == [want] == [serial]
        for r in case:
            _check_counts(r, spec_k=kw.get("spec_k", 0))
            # one of the four heads of 4 values a rank
            assert r["tp"]["pools"][0][0][3:] == (1, 4)
            assert r["tp"]["stats"][0]["tp"] == 4
    want = jax_continuous(lm4, SEEDS, 5, mesh=jmesh4, **INT8_SPEC)
    case = [r[2] for r in res]
    got = _same_on_every_rank(case)[0]
    _held_to_jax_int8(lm4, got, want, 4)
    assert got == case[0]["one"]["rows"][0]


def test_data_axis_replicates(world4, serial):
    """``{"data": 2, "model": 2}``: each data row of the mesh serves the
    same rows over its own model axis, the serial rows."""
    _, ranks = world4
    for i in range(2):
        case = [r[1][i] for r in ranks]
        assert _same_on_every_rank(case) == [serial]
        assert {r["model_index"] for r in case} == {0, 1}


# -- refusals -------------------------------------------------------------

def _jax_refusal(lm, mesh):
    with pytest.raises(ValueError) as e:
        JaxDecoder(lm, max_slots=2, n_pos=8, mesh=mesh)
    return str(e.value)


def test_divisibility_errors_in_the_jax_words():
    """``hybrid_mesh(1, 3)``: two heads, then three heads over a hidden
    dim of 32; the port raises on every rank what the JAX decoder raises
    on ``make_mesh({"model": 3})``."""
    mesh3 = jmake_mesh({"model": 3}, jax.devices()[:3])
    heads, hidden = _jax_lm(), _jax_lm(n_heads=3, d_model=18)
    case = [dict(seeds=SEEDS[:1], n_words=2, kw=dict(max_slots=2,
                                                      n_pos=8))]
    ranks = launch(W.calls, 3, "gloo", args=([
        (W.tp_decode_case, (_arch(), _params(heads), 1, 3, case)),
        (W.tp_decode_case, (_arch(3, 18), _params(hidden), 1, 3, case))],))
    want = [_jax_refusal(heads, mesh3), _jax_refusal(hidden, mesh3)]
    assert "n_heads=2" in want[0] and "FFN hidden dim (32, block 0)" \
        in want[1]
    for r in ranks:
        assert [c[0]["refused"] for c in r] == [("ValueError", w)
                                                for w in want]
