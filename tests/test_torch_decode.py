"""The port's continuous-batching decoder (bigdl_tpu_torch/serve/decode.py)
against the JAX package's ``continuous_decode`` and ``lm_decode``, with
the JAX weights carried across; plus its failure isolation, page
accounting and device rules.
"""
import jax
import numpy as np
import pytest
import torch

from bigdl_tpu.models.transformer import TransformerLM as JaxLM
from bigdl_tpu.models.transformer import lm_decode as jax_lm_decode
from bigdl_tpu.serve.decode import continuous_decode as jax_continuous
from bigdl_tpu.utils.random import set_seed
from bigdl_tpu_torch.models import transformer as tt
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
    assert st["pool"]["in_use"] == 0
    assert st["pool"]["free"] == 5
    assert st["admitted"] == st["retired"] == len(SEEDS)
    # the small pool forced head-of-line waits but never over-allocated
    assert 0 < st["pool"]["in_use_hwm"] <= 5
    assert _pages_needed(9, 4) == 3 and _pages_needed(8, 4) == 2


def test_host_syncs_only_at_retiring_boundaries(port):
    dec = ContinuousDecoder(port, max_slots=4, n_pos=9, sync_interval=3,
                            page_size=4, device="cpu")
    for s in SEEDS:
        dec.submit(s, 5)
    dec.run()
    st = dec.stats()
    assert st["steps"] % 3 == 0
    assert 1 <= st["host_syncs"] <= st["steps"] // 3


def test_sampling_raises(port):
    dec = ContinuousDecoder(port, max_slots=2, n_pos=9, device="cpu")
    with pytest.raises(NotImplementedError, match="sampled-decode slice"):
        dec.submit([1, 2], 3, sampling={"temperature": 0.7})
    dec.submit([1, 2], 3, sampling={"temperature": 0.0})   # greedy is fine


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
