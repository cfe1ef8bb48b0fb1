"""The port's cost ledger (bigdl_tpu_torch/obs/ledger.py; the JAX
package's is tests/test_obs_ledger.py): a LeNet-5 step's flops, counted
once a step shape by ``FlopCounterMode`` on an eager step, equal the hand
count of its convolutions and linears; the peak table holds NVIDIA cards
only, so on the CPU no ``train_mfu`` or ``decode_model_flops_util`` gauge
is published, and a peak passed explicitly gives a utilization in (0, 1];
the ledger's events validate in the JAX schema; the memory helpers."""
import numpy as np
import pytest
import torch

from bigdl_tpu.obs import events as jax_events
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset import DataSet, ImgToBatch, mnist
from bigdl_tpu_torch.models.lenet import LeNet5
from bigdl_tpu_torch.obs import events, ledger, metrics, recorder
from bigdl_tpu_torch.optim import SGD, LocalOptimizer, max_iteration
from bigdl_tpu_torch.serve.decode import ContinuousDecoder
from bigdl_tpu_torch.utils import profiler
from bigdl_tpu_torch.utils.table import T
from tests.helpers.torch_lm import jax_lm, port_of


@pytest.fixture(autouse=True)
def _fresh_obs():
    for mod in (events, recorder):
        mod.reset()
    metrics.reset()
    ledger.reset()
    state = torch.random.get_rng_state()
    yield
    events.reset()
    metrics.reset()
    ledger.reset()
    torch.random.set_rng_state(state)


def lenet_step_flops(b: int) -> int:
    """A LeNet-5 step's products by hand: 2·M·N·K a forward product, the
    backward twice that (the input's gradient and the weight's), except
    the first convolution, whose input needs no gradient."""
    conv1 = 2 * b * 24 * 24 * 6 * (1 * 5 * 5)
    conv2 = 2 * b * 8 * 8 * 12 * (6 * 5 * 5)
    fc1 = 2 * b * 100 * 192
    fc2 = 2 * b * 10 * 100
    fwd = conv1 + conv2 + fc1 + fc2
    return fwd + conv1 + 2 * (conv2 + fc1 + fc2)


def _lenet_opt(batch, iters, n_disp=1, peak=None):
    ds = DataSet.array(mnist.synthetic(4 * batch, 0), seed=1) \
        >> ImgToBatch(batch)
    opt = LocalOptimizer(LeNet5(10, device="cpu"), ds,
                         nn.ClassNLLCriterion(), device="cpu")
    opt._peak_flops = peak
    opt.set_optim_method(SGD()).set_state(T(learningRate=0.01))
    opt.set_end_when(max_iteration(iters)).set_taps(True, 2)
    if n_disp > 1:
        opt.set_iterations_per_dispatch(n_disp)
    return opt


@pytest.mark.parametrize("batch,n_disp", [(4, 1), (8, 1), (8, 2)])
def test_lenet_step_flops_are_the_hand_count(batch, n_disp):
    opt = _lenet_opt(batch, 4, n_disp, peak=1e15)
    opt.optimize()
    assert ledger.get().flops_for(opt._step_fn_key) == \
        lenet_step_flops(batch)
    # counted once: a key a step shape
    assert ledger.get().stats() == {"entries": 1, "captures": 1}


def test_no_mfu_gauge_on_the_cpu():
    assert ledger.device_peak_flops("cpu") is None
    assert ledger.device_peak_flops() is None or torch.cuda.is_available()
    opt = _lenet_opt(4, 4)
    opt.optimize()
    snap = metrics.get().snapshot()
    assert "train_mfu" not in snap
    assert metrics.family_total(snap, "train_step_wall_seconds") > 0
    # no peak: nothing to divide a count by, so no step is counted
    assert ledger.get().stats()["captures"] == 0


def test_a_given_peak_gives_a_utilization_in_0_1():
    opt = _lenet_opt(4, 4, peak=1e12)
    opt.optimize()
    mfu = metrics.family_total(metrics.get().snapshot(), "train_mfu",
                               optimizer="local")
    assert 0 < mfu <= 1


def test_the_peak_table_is_nvidia_cards_only():
    assert ledger.PEAK_FLOPS
    for name, peak in ledger.PEAK_FLOPS.items():
        assert name.startswith("NVIDIA ")
        assert peak == 989e12   # the H100 SXM data sheet, dense bf16
    assert not hasattr(ledger, "DEFAULT_PEAK")


def test_no_decoder_util_gauge_or_count_on_the_cpu():
    dec = ContinuousDecoder(port_of(jax_lm(2)), max_slots=2, n_pos=16,
                            sync_interval=2, device="cpu", name="dl")
    futs = [dec.submit([1, 2, 3], 5), dec.submit([4, 5], 5)]
    dec.run()
    [f.result(timeout=30) for f in futs]
    assert dec._m_util is None
    snap = metrics.get().snapshot()
    assert "decode_model_flops_util" not in snap
    assert metrics.family_total(snap, "decode_tokens_per_s",
                                decoder="dl") > 0
    # no peak: the step is not counted
    assert ledger.get().stats()["captures"] == 0
    tenant = metrics.family_total(snap, "hbm_tenant_bytes", decoder="dl",
                                  tenant="kv_pool")
    assert tenant == ledger.tree_nbytes(dec._caches) > 0
    dec.close()


def test_decoder_util_with_a_given_peak(monkeypatch):
    monkeypatch.setattr(ledger, "device_peak_flops", lambda device=None: 1e12)
    dec = ContinuousDecoder(port_of(jax_lm(2)), max_slots=2, n_pos=16,
                            sync_interval=2, device="cpu", name="dm")
    dec.submit([1, 2, 3], 6)
    dec.run()
    util = metrics.family_total(metrics.get().snapshot(),
                                "decode_model_flops_util", decoder="dm")
    assert 0 < util <= 1
    # the step counted once, on its first run
    assert ledger.get().flops_for(dec._step_fn_key) > 0
    assert ledger.get().stats()["captures"] == 1
    dec.close()


def test_counted_runs_once_a_key_and_ledger_events_validate(tmp_path):
    events.configure(str(tmp_path))
    calls = []

    def step():
        calls.append(1)
        a = torch.ones(4, 8)
        return a @ torch.ones(8, 3)
    led = ledger.get()
    for _ in range(3):
        out = led.counted(("probe", 1), ("probe", 1, "k"), step)
    assert out.shape == (4, 3) and len(calls) == 3
    assert led.flops_for(("probe", 1)) == 2 * 4 * 8 * 3
    led.counted(("probe", 1), ("probe", 1, "k2"),
                lambda: torch.ones(1, 2) @ torch.ones(2, 1))
    assert led.flops_for(("probe", 1)) == 4      # the newest key
    ledger.note_tenant("kv_pool", 4096, decoder="x")
    evs = events.read_events(events.get().path)
    assert [e["kind"] for e in evs] == ["exec", "exec", "tenant"]
    for e in evs:
        jax_events.validate_event(e)
    assert metrics.family_total(metrics.get().snapshot(), "ledger_flops",
                                fn="probe") == 2 * 4 * 8 * 3 + 4


def test_ledger_switch(monkeypatch):
    monkeypatch.setenv("BIGDL_LEDGER", "0")
    assert ledger.get().counted("f", "k", lambda: 7) == 7
    assert ledger.get().stats()["captures"] == 0


def test_tree_nbytes_and_memory_stats():
    tree = {"a": torch.zeros(3, 4), "b": [np.zeros(5, np.float64),
                                          torch.zeros(2, dtype=torch.int8)],
            "c": "not sized"}
    assert ledger.tree_nbytes(tree) == 48 + 40 + 2
    if not torch.cuda.is_available():
        assert profiler.device_memory_stats() == {"cpu": None}
    sampler = ledger.DeviceMemorySampler(
        stats_fn=lambda: {"cuda:0": {"bytes_in_use": 10,
                                     "peak_bytes_in_use": 30,
                                     "bytes_limit": 100}})
    assert sampler.sample_once() == {"cuda:0": {"in_use": 10, "peak": 30,
                                                "limit": 100}}
    snap = metrics.get().snapshot()
    assert metrics.family_total(snap, "hbm_bytes_peak", device="cuda:0") \
        == 30
    assert ledger.DeviceMemorySampler(
        stats_fn=profiler.device_memory_stats).sample_once() == {} or \
        torch.cuda.is_available()


def test_profiler_trace_annotations_and_module_times(tmp_path):
    """``utils.profiler``: a trace written as Chrome JSON holding the
    annotated ranges, and the per-module time table."""
    import json
    with profiler.trace(str(tmp_path)):
        with profiler.step_annotation("7"), profiler.annotation("phase-x"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    names = {e.get("name") for e in json.load(
        open(tmp_path / "trace.json"))["traceEvents"]}
    assert {"step:7", "phase-x"} <= names
    assert profiler.stop_trace() is None          # nothing left open
    model = LeNet5(10, device="cpu")
    model(torch.zeros(2, 1, 28, 28))
    table = profiler.format_module_times(model, top_n=3)
    assert table.splitlines()[0].split() == ["module", "fwd_s", "bwd_s"]
    assert len(table.splitlines()) == 4

