"""Straggler dropping in the port: its ``StragglerPolicy`` (a copy of the
JAX package's host logic) against the JAX one on the same schedules,
every case of ``TestStragglerPolicy`` (tests/test_straggler.py:22-165),
and the masked data-parallel runs of ``TestStragglerIntegration``
(:167-323) at four gloo ranks with an injected ``time_source``, against
the JAX masked run on a mesh of four virtual devices."""
import jax
import numpy as np
import pytest

from bigdl_tpu import nn as jnn
from bigdl_tpu.dataset import DataSet as JaxDataSet
from bigdl_tpu.dataset import Sample as JaxSample
from bigdl_tpu.dataset import SampleToBatch as JaxSampleToBatch
from bigdl_tpu.optim import DistriOptimizer as JaxDistriOptimizer
from bigdl_tpu.optim import max_iteration as jax_max_iteration
from bigdl_tpu.optim.straggler import StragglerPolicy as JaxPolicy
from bigdl_tpu.parallel.mesh import data_parallel_mesh
from bigdl_tpu.utils.random import set_seed
from bigdl_tpu.utils.table import T as JaxT
from bigdl_tpu_torch.optim.straggler import StragglerPolicy, kth_largest
from bigdl_tpu_torch.parallel.launch import launch
from tests.helpers import torch_distri_workers as W

N = 4
TOL = dict(rtol=1e-4, atol=1e-5)       # tests/test_straggler.py:183
EXACT = dict(rtol=1e-6, atol=1e-7)     # tests/test_straggler.py:300


# -- the policy: both packages through the same schedules ----------------

def _warmup_and_first_threshold(cls):
    pol = cls(n_tasks=4, drop_percentage=0.25, max_drop_percentage=0.5,
              compute_threshold_batch_size=2, warmup_iteration=0)
    seen = [pol.mask(), pol.armed]
    pol.record([1.0, 1.0, 1.0, 5.0], seen[0])
    seen.append(pol.armed)
    pol.record([1.0, 1.0, 1.0, 6.0], pol.mask())
    return seen + [pol.armed, pol.threshold, pol.mask()]


def _relax(cls):
    pol = cls(n_tasks=4, drop_percentage=0.25, max_drop_percentage=0.5,
              compute_threshold_batch_size=2, warmup_iteration=0)
    pol.record([1.0, 1.0, 1.0, 5.0], pol.mask())
    pol.record([1.0, 1.0, 1.0, 6.0], pol.mask())
    seen = [pol.threshold]
    m3 = pol.mask()
    pol.record([1.0, 1.0, 1.0, 7.0], m3)
    pol.record([1.0, 1.0, 1.0, 1.0], pol.mask())
    return seen + [m3, pol.threshold]


def _window(cls):
    pol = cls(n_tasks=2, drop_percentage=0.5, max_drop_percentage=0.5,
              compute_threshold_batch_size=3, warmup_iteration=6)
    for _ in range(5):
        pol.record([1.0, 1.0], pol.mask())
    seen = [len(pol._window)]
    pol.record([9.0, 9.0], pol.mask())
    for _ in range(3):
        pol.record([1.0, 1.0], pol.mask())
    return seen + [pol.iteration, pol.threshold]


def _accepts(cls):
    pol = cls(n_tasks=8, drop_percentage=0.1, max_drop_percentage=0.25)
    return [pol.accepts(np.asarray([1, 1, 1, 1, 1, 1, 0, 0], np.float32)),
            pol.accepts(np.asarray([1, 1, 1, 1, 1, 0, 0, 0], np.float32))]


def _uniform(cls):
    pol = cls(n_tasks=4, drop_percentage=0.25, max_drop_percentage=0.5,
              compute_threshold_batch_size=2, warmup_iteration=0)
    pol.record([1.0, 1.0, 1.0, 1.0], pol.mask())
    pol.record([1.0, 1.0, 1.0, 1.0], pol.mask())
    seen = [pol.threshold]
    pol.record([7.0, 7.0, 7.0, 7.0], pol.mask())
    return seen + [pol.mask()]


def _empty(cls):
    pol = cls(4, drop_percentage=1.0, max_drop_percentage=1.0)
    return [pol.accepts(np.zeros(4, np.float32)),
            pol.accepts(np.asarray([1, 0, 0, 0], np.float32))]


def _reject(cls):
    """A rejected iteration forgets the measurements: the next mask is
    all ones, and the window counts the drops."""
    pol = cls(n_tasks=4, drop_percentage=0.5, max_drop_percentage=0.5,
              compute_threshold_batch_size=2, warmup_iteration=0)
    pol.record([1.0, 1.0, 1.0, 1.0], pol.mask())
    pol.record([9.0, 9.0, 9.0, 1.0], pol.mask())
    m = pol.mask()
    seen = [pol.threshold, m, pol.accepts(m)]
    pol.reject(m)
    return seen + [pol.mask(), pol._dropped_in_window, pol.iteration]


# (case, what the JAX test asserts on it)
CASES = {
    "warmup_and_first_threshold": (_warmup_and_first_threshold, lambda s: (
        np.array_equal(s[0], np.ones(4)) and not s[1] and not s[2] and s[3]
        and s[4] == pytest.approx(5.0)
        and np.array_equal(s[5], [1, 1, 1, 0]))),
    "relax_when_window_already_dropped_share": (_relax, lambda s: (
        s[0] == pytest.approx(5.0) and np.array_equal(s[1], [1, 1, 1, 0])
        and s[2] == pytest.approx(5.0 * 1.01))),
    "window_is_one_batch_sized": (_window, lambda s: (
        s[0] == 6 and s[1] == 9 and s[2] == pytest.approx(1.0))),
    "accepts_max_drop_guard": (_accepts, lambda s: s == [True, False]),
    "uniform_slowness_masks_nobody": (_uniform, lambda s: (
        s[0] == pytest.approx(1.0) and np.array_equal(s[1], np.ones(4)))),
    "never_accepts_empty_mask": (_empty, lambda s: s == [False, True]),
    "rejection_forgets_the_measurements": (_reject, lambda s: (
        s[0] == pytest.approx(1.0) and not s[2]
        and np.array_equal(s[3], np.ones(4)) and s[5] == 2)),
}


def _same(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b)) and \
            np.asarray(a).dtype == np.asarray(b).dtype
    return a == b


@pytest.mark.parametrize("case", sorted(CASES))
def test_policy_follows_jax(case):
    run, expect = CASES[case]
    got, want = run(StragglerPolicy), run(JaxPolicy)
    assert len(got) == len(want)
    assert all(_same(a, b) for a, b in zip(got, want)), (got, want)
    assert expect(got)


def test_validates_percentages():
    for cls in (StragglerPolicy, JaxPolicy):
        with pytest.raises(ValueError):
            cls(4, drop_percentage=0.5, max_drop_percentage=0.2)
        with pytest.raises(ValueError):
            cls(4, drop_percentage=-0.1, max_drop_percentage=0.5)


def test_kth_largest():
    v = np.asarray([3.0, 9.0, 1.0, 9.0, 4.0])
    assert [kth_largest(v, k) for k in range(1, 6)] == [9, 9, 4, 3, 1]


def test_time_source_wins():
    pol = StragglerPolicy(4, 0.25, 0.5, time_source=lambda wall: [wall] * 4)
    np.testing.assert_array_equal(pol.task_times(2.5), np.full(4, 2.5))
    pol = StragglerPolicy(4, 0.25, 0.5)
    np.testing.assert_array_equal(pol.task_times(1.5), np.full(4, 1.5))


# -- masked runs at four ranks against the JAX masked run ----------------

def _data(n=64, d=8, classes=4):
    rng = np.random.RandomState(0)
    w = rng.randn(d, classes)
    xs = rng.randn(n, d).astype(np.float32)
    ys = (xs @ w).argmax(1) + 1.0
    return xs, ys


def _jax_model():
    set_seed(7)
    return jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 4),
                          jnn.LogSoftMax())


def _drop(**kw):
    return dict(dict(drop_percentage=0.25, max_drop_percentage=0.5,
                     batch_size=2, warmup_iteration=0), **kw)


#: (drop arguments, schedule, samples, DistriOptimizer arguments)
RUNS = {
    "plain": (None, None, 64, {}),
    "ones": (_drop(), W.Schedule(N), 64, {}),
    # task 3 always slow: k = int(0.4·2·4) = 3, the 3rd largest of two
    # 9.0 and six 1.0 is 1.0, so task 3 is dropped from iteration 3
    "slow": (_drop(drop_percentage=0.4), W.Schedule(N, slow=[3]), 256, {}),
    "slow_plain": (None, None, 256, {}),
    # iteration 2: three slow tasks; k = 4 over eight slots gives 1.0, so
    # iteration 3 keeps one task < 4·(1 - 0.5): rejected
    "reject": (_drop(drop_percentage=0.5, max_drop_percentage=0.5),
               W.Schedule(N, slow=[0, 1, 2], calls=[2]), 64, {}),
    # iteration 3: every task slow at once; nobody is a straggler
    "spike": (_drop(), W.Schedule(N, calls=[3], every=9.0), 64, {}),
    "bf16": (None, None, 64, {"gradient_compression": "bf16"}),
    "bf16_ones": (_drop(), W.Schedule(N), 64,
                  {"gradient_compression": "bf16"}),
    "bf16z1": (None, None, 64, {"gradient_compression": "bf16",
                                "zero1": True}),
    "bf16z1_ones": (_drop(), W.Schedule(N), 64,
                    {"gradient_compression": "bf16", "zero1": True}),
}


def _spec(name):
    drop, schedule, n, kw = RUNS[name]
    xs, ys = _data(n)
    set_seed(7)
    init = jax.tree_util.tree_map(np.asarray, _jax_model().params())
    spec = dict(model="mlp", init=init, xs=xs, ys=ys, batch=32, seed=3,
                iters=4, state={"learningRate": 0.1}, kw=kw)
    if drop is not None:
        spec["drop"] = dict(drop, time_source=schedule)
    return spec


def _jax_run(name):
    drop, schedule, n, kw = RUNS[name]
    xs, ys = _data(n)
    model = _jax_model()
    ds = JaxDataSet.array([JaxSample(x, np.asarray([y]))
                           for x, y in zip(xs, ys)]) >> JaxSampleToBatch(32)
    opt = JaxDistriOptimizer(model, ds, jnn.ClassNLLCriterion(),
                             mesh=data_parallel_mesh(jax.devices()[:N]),
                             **kw)
    if drop is not None:
        opt.set_drop_module_property(time_source=W.Schedule(
            schedule.n_tasks, schedule.slow, schedule.value,
            schedule.calls, schedule.every), **drop)
    opt.set_state(JaxT(learningRate=0.1))
    opt.set_end_when(jax_max_iteration(4))
    set_seed(3)
    opt.optimize()
    pol = opt._straggler
    return (jax.tree_util.tree_map(np.asarray, model.params()),
            None if pol is None else (pol.iteration, pol.threshold))


@pytest.fixture(scope="module")
def ranks():
    names = list(RUNS)
    per_rank = launch(W.runs, N, "gloo", args=([_spec(k) for k in names],))
    return [dict(zip(names, rank)) for rank in per_rank]


def assert_trees(got, want, **tol):
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


def _differ(a, b, **tol):
    return any(not np.allclose(x, y, **tol) for x, y in zip(
        jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)))


@pytest.mark.parametrize("name", ["ones", "slow", "reject", "spike"])
def test_masked_run_matches_jax(ranks, name):
    """The masked aggregation sum(w·g)/sum(w), the rejection and the
    uniform spike, as the JAX masked run on four devices takes them;
    every rank holds the same policy state."""
    params, policy = _jax_run(name)
    for rank in ranks:
        got = rank[name]
        assert got["straggler"] == pytest.approx(policy)
        assert_trees(got["params"], params, **TOL)
        assert_trees(got["params"], ranks[0][name]["params"], rtol=0, atol=0)
    assert ranks[0]["reject"]["rejected"] == 1
    assert all(ranks[0][k]["rejected"] == 0 for k in ("ones", "slow",
                                                      "spike"))


def test_no_skew_trains_like_plain_dp(ranks):
    """A uniform schedule never bites: mean of the ranks' means is the
    global mean."""
    for name in ("ones", "spike"):
        assert_trees(ranks[0][name]["params"], ranks[0]["plain"]["params"],
                     **TOL)


def test_a_dropped_rank_leaves_the_mean(ranks):
    """Task 3 is masked from iteration 3 on: the run parts from plain DP
    on the same batches (and matches JAX, above)."""
    assert ranks[0]["slow"]["straggler"][1] == pytest.approx(1.0)
    assert _differ(ranks[0]["slow"]["params"],
                   ranks[0]["slow_plain"]["params"], **TOL)


@pytest.mark.parametrize("masked,unmasked", [("bf16_ones", "bf16"),
                                             ("bf16z1_ones", "bf16z1")])
def test_all_ones_mask_leaves_the_bf16_wire_exact(ranks, masked, unmasked):
    """test_all_ones_compression_matches_compressed and
    test_all_ones_composes_with_zero1_compression: w = 1 and /sum(w)
    against /n are exact."""
    for rank in ranks:
        assert_trees(rank[masked]["params"], rank[unmasked]["params"],
                     **EXACT)


def test_invalid_combinations_raise():
    """Masks are recomputed every iteration: n steps a dispatch is
    refused when the run starts (on its rank, raised here); with pipeline
    stages the JAX words refuse it (the tasks are data replicas)."""
    from bigdl_tpu_torch.optim import DistriOptimizer
    spec = dict(_spec("ones"), n_disp=4)
    with pytest.raises(ValueError, match="iterations_per_dispatch"):
        launch(W.run, 1, "gloo", args=(spec,))
    with pytest.raises(ValueError, match="straggler drop masks "
                                         "per-DATA-replica gradients"):
        DistriOptimizer(W.build("mlp"), None, None, pipeline_stages=4,
                        drop_percentage=0.1, device="cpu")
