"""Pipeline parallelism of the port under gloo
(``DistriOptimizer(pipeline_stages=P)``, ``parallel/pipeline.py``,
``parallel/pipeline_model.py``), held against the JAX package on the
conftest CPU mesh: the stage ranges of ``partition_sequential``; the
schedule functions against ``pipeline_apply`` / ``pipeline_train_1f1b``
and the serial program (tests/test_pipeline_moe.py ``TestPipeline``,
``Test1F1B``, ``test_pipeline_remat_memory_and_equivalence``); the
optimizer against ``LocalOptimizer`` and the JAX pipeline
(tests/test_pipeline_optimizer.py), with its tolerances; its refusals
in the JAX words.  ``test_pipeline_with_adagrad`` has no counterpart
here: the port has no ``Adagrad`` yet (ROADMAP queue 1, item 3.6.4).

The ranks are spawned processes that import the port alone
(``tests/helpers/torch_distri_workers.py``); one spawn of four ranks
runs every case (``W.runs`` and the case functions in turn)."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bigdl_tpu import nn as jnn
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.dataset import Sample as JSample
from bigdl_tpu.dataset import SampleToBatch as JSampleToBatch
from bigdl_tpu.models.inception import Inception_v1_NoAuxClassifier as JInc
from bigdl_tpu.models.vgg import VggForCifar10 as JVgg
from bigdl_tpu.optim import LocalOptimizer as JLocalOptimizer
from bigdl_tpu.optim import max_iteration as jmax_iteration
from bigdl_tpu.optim import several_iteration as jseveral_iteration
from bigdl_tpu.optim.distri_optimizer import DistriOptimizer as JDistri
from bigdl_tpu.parallel.mesh import make_mesh as jmake_mesh
from bigdl_tpu.parallel.pipeline import pipeline_apply as jpipeline_apply
from bigdl_tpu.parallel.pipeline import pipeline_train_1f1b as j1f1b
from bigdl_tpu.parallel.pipeline import stack_stage_params
from bigdl_tpu.parallel.pipeline_model import \
    partition_sequential as jpartition
from bigdl_tpu.utils import file as JFile
from bigdl_tpu.utils.random import set_seed
from bigdl_tpu.utils.table import T as JT
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset import DataSet, SampleToBatch
from bigdl_tpu_torch.models.inception import Inception_v1_NoAuxClassifier
from bigdl_tpu_torch.models.vgg import VggForCifar10
from bigdl_tpu_torch.optim import DistriOptimizer
from bigdl_tpu_torch.parallel import pipeline as P
from bigdl_tpu_torch.parallel.launch import launch
from bigdl_tpu_torch.parallel.mesh import Mesh, make_mesh
from bigdl_tpu_torch.parallel.pipeline_model import partition_sequential
from bigdl_tpu_torch.utils import file as File
from tests.helpers import torch_distri_workers as W

LOSS_ATOL = 1e-5                     # tests/test_pipeline_optimizer.py:95
PARAM_TOL = dict(rtol=2e-5, atol=2e-6)   # tests/test_pipeline_optimizer.py:96
FN_TOL = dict(rtol=1e-4, atol=1e-5)      # tests/test_pipeline_moe.py:189
MOM = {"learningRate": 0.1, "momentum": 0.9}


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_mlp():
    set_seed(7)
    return jnn.Sequential(
        jnn.Linear(12, 32), jnn.ReLU(True), jnn.Linear(32, 32), jnn.Tanh(),
        jnn.Linear(32, 16), jnn.ReLU(True), jnn.Linear(16, 5),
        jnn.LogSoftMax())


def _jax_bn_conv(p1=0.3, p2=0.5):
    set_seed(3)
    return jnn.Sequential(
        jnn.SpatialConvolution(3, 8, 3, 3, 1, 1, 1, 1),
        jnn.SpatialBatchNormalization(8), jnn.ReLU(True), jnn.Dropout(p1),
        jnn.SpatialConvolution(8, 8, 3, 3, 1, 1, 1, 1),
        jnn.SpatialMaxPooling(2, 2, 2, 2), jnn.Reshape([8 * 4 * 4]),
        jnn.Linear(8 * 4 * 4, 16), jnn.BatchNormalization(16),
        jnn.Dropout(p2), jnn.Linear(16, 5), jnn.LogSoftMax())


def _mlp_data(n=64):
    rs = np.random.RandomState(0)
    xs = rs.randn(n, 12).astype(np.float32)
    ys = np.asarray([float(i % 5 + 1) for i in range(n)])
    return xs, ys


def _jax_ds(xs, ys, batch=16):
    return JDataSet.array([JSample(x, np.asarray([y], np.float32))
                           for x, y in zip(xs, ys)]) >> JSampleToBatch(batch)


def _spec(**kw):
    xs, ys = _mlp_data()
    spec = dict(model="mlp_pp", init=_numpy(_jax_mlp().params()), xs=xs,
                ys=ys, batch=16, seed=5, iters=4, state=MOM)
    spec.update(kw)
    return spec


def _pp(stages=4, schedule="1f1b", micro=4, mesh=None, **kw):
    return _spec(mesh=mesh or {"pipe": stages},
                 kw={"pipeline_stages": stages, "pipeline_schedule": schedule,
                     "pipeline_microbatches": micro}, **kw)


def _jax_pipe(schedule="1f1b", iters=4, tmp=None, ckpt=None):
    """The JAX pipeline over four stages, four microbatches: (params, last
    loss); with ``ckpt`` a checkpoint under ``tmp`` every ``ckpt``
    iterations."""
    model = _jax_mlp()
    opt = JDistri(model, _jax_ds(*_mlp_data()), jnn.ClassNLLCriterion(),
                  mesh=jmake_mesh({"pipe": 4}, jax.devices()[:4]),
                  pipeline_stages=4, pipeline_schedule=schedule,
                  pipeline_microbatches=4)
    opt.set_state(JT(**MOM))
    opt.set_end_when(jmax_iteration(iters))
    if ckpt is not None:
        opt.set_checkpoint(str(tmp), jseveral_iteration(ckpt))
    set_seed(5)   # the epoch order
    opt.optimize()
    return _numpy(model.params()), float(opt.state["loss"])


def _jax_local(iters=4):
    model = _jax_mlp()
    opt = JLocalOptimizer(model, _jax_ds(*_mlp_data()),
                          jnn.ClassNLLCriterion())
    opt.set_state(JT(**MOM))
    opt.set_end_when(jmax_iteration(iters))
    set_seed(5)
    opt.optimize()
    return _numpy(model.params()), float(opt.state["loss"])


def assert_trees(got, want, **tol):
    a = jax.tree_util.tree_leaves_with_path(got)
    b = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), **tol,
                                   err_msg=jax.tree_util.keystr(path))


# -- the stage plan -----------------------------------------------------

def _jax_model_of(name):
    if name == "mlp":
        return _jax_mlp(), (4, 12)
    if name == "bn_conv":
        return _jax_bn_conv(), (2, 3, 8, 8)
    set_seed(1)
    if name == "vgg":
        return JVgg(10), (16, 3, 32, 32)
    return JInc(100), (1, 3, 224, 224)


def _port_model_of(name, jmodel):
    from bigdl_tpu_torch.nn.module import load_jax_params
    if name == "mlp":
        model = W.build("mlp_pp")
    elif name == "bn_conv":
        model = W.build("bn_conv")
    elif name == "vgg":
        model = VggForCifar10(10, device="cpu")
    else:
        model = Inception_v1_NoAuxClassifier(100, device="cpu")
    return load_jax_params(model, _numpy(jmodel.params()))


@pytest.mark.parametrize("name", ["mlp", "bn_conv", "vgg", "inception"])
def test_partition_ranges_equal_jax(name):
    """``partition_sequential``'s ranges, boundary shapes and stage sizes
    are the JAX plan's at P = 2 and 4 (the cost model and the linear
    partition copied)."""
    jmodel, micro = _jax_model_of(name)
    model = _port_model_of(name, jmodel)
    for stages in (2, 4):
        want = jpartition(jmodel, stages, micro)
        got = partition_sequential(model, stages, micro)
        assert got.ranges == want.ranges
        assert [tuple(s) for s in got.in_shapes] == \
            [tuple(s) for s in want.in_shapes]
        assert tuple(got.out_shape) == tuple(want.out_shape)
        assert got.p_sizes == want.p_sizes and got.max_p == want.max_p
        assert got.describe() == want.describe()


def test_partition_refusals_are_the_jax_words():
    with pytest.raises(ValueError, match="pipeline_stages requires a "
                                         "Sequential model, got Linear"):
        partition_sequential(nn.Linear(4, 4), 2, (2, 4))
    with pytest.raises(ValueError, match=re.escape(
            "model has 8 top-level modules, cannot make 9 stages")):
        partition_sequential(W.build("mlp_pp"), 9, (2, 12))
    split = nn.Sequential(nn.Linear(4, 4),
                          nn.ConcatTable(nn.Identity(), nn.Identity()),
                          nn.CAddTable())
    with pytest.raises(ValueError, match="stage boundary after ConcatTable "
                                         "is not a single array"):
        partition_sequential(split, 2, (2, 4))


@pytest.mark.parametrize("stages,micro", [(4, 8), (4, 4), (2, 5), (3, 2)])
def test_schedules_bound_the_microbatches_in_flight(stages, micro):
    """1F1B's stage r keeps at most P - r microbatches in flight, GPipe
    all M; every action is placed after what it depends on, each once."""
    for name, bound in (("1f1b", lambda r: min(stages - r, micro)),
                        ("gpipe", lambda r: micro)):
        ticks = P.timeline(name, stages, micro)
        seen = {}
        for t, row in enumerate(ticks):
            for s, act in row.items():
                seen[(act, s)] = t
        for s in range(stages):
            live = peak = 0
            for row in ticks:
                kind = row.get(s, (None,))[0]
                live += (kind == P.FWD) - (kind == P.BWD)
                peak = max(peak, live)
            assert peak == bound(s)
            for m in range(micro):
                f, b = seen[((P.FWD, m), s)], seen[((P.BWD, m), s)]
                assert f < b
                if s:
                    assert seen[((P.FWD, m), s - 1)] < f
                if s < stages - 1:
                    assert seen[((P.BWD, m), s + 1)] < b
        assert 0 < P.bubble(ticks) < 1


# -- four ranks ---------------------------------------------------------

D, N_MICRO, MB = 8, 8, 4
#: pipeline_microbatches that the batch of 16 at {"data": 2, "pipe": 2}
#: refuses, and the JAX words of each
BAD_MICRO = {
    5: "batch size 16 is not divisible by pipeline_microbatches=5",
    16: "microbatch size 1 is not divisible by the data axis (2) — "
        "hybrid dp x pp shards each microbatch across the data replicas"}


def _fn_inputs():
    rs = np.random.RandomState(3)
    stages = [{"w": (rs.randn(D, D) * 0.3).astype(np.float32),
               "b": (rs.randn(D) * 0.1).astype(np.float32)}
              for _ in range(4)]
    rs = np.random.RandomState(4)
    x = rs.randn(N_MICRO, MB, D).astype(np.float32)
    t = rs.randn(N_MICRO, MB, D).astype(np.float32)
    return stages, x, t


def _bn_inputs():
    rs = np.random.RandomState(1)
    x = rs.randn(8, 3, 8, 8).astype(np.float32)
    y = rs.randint(1, 6, (8,)).astype(np.float32)
    return x, y


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipe")
    xs, ys = _mlp_data()
    specs = {
        "local": _spec(optimizer="local"),
        "local6": _spec(optimizer="local", iters=6),
        "1f1b": _pp(schedule="1f1b"),
        "gpipe": _pp(schedule="gpipe"),
        "gpipe_remat": _pp(schedule="gpipe", remat=True),
        "hybrid_1f1b": _pp(2, "1f1b", mesh={"data": 2, "pipe": 2}),
        "hybrid_gpipe": _pp(2, "gpipe", mesh={"data": 2, "pipe": 2}),
        "default_mesh": _spec(kw={"pipeline_stages": 4,
                                  "pipeline_microbatches": 4}, iters=2),
        "n2": _pp(n_disp=2),
        "validate": _pp(iters=2, validate=(xs[:40], ys[:40], 16, 2)),
        "local_validate": _spec(optimizer="local", iters=2,
                                validate=(xs[:40], ys[:40], 16, 2)),
        "full6": _pp(iters=6),
        "ckpt": _pp(iters=4, checkpoint=(str(tmp / "a"), 5)),
        "resume": _pp(iters=6, resume=str(tmp / "a")),
    }
    names = list(specs)
    bn = _jax_bn_conv()
    bx, by = _bn_inputs()
    oracle = [(W.bn_oracle_case, (_numpy(bn.params()), _numpy(bn.state()),
                                  bx, by, 4, 2, arch))
              for arch in ({}, {"p1": 0.0, "p2": 0.0})]
    refusals = [(W.refusal_case, (_pp(2, micro=micro, iters=1,
                                      mesh={"data": 2, "pipe": 2}),))
                for micro in BAD_MICRO]
    per_rank = launch(W.calls, 4, "gloo", args=([
        (W.runs, ([specs[k] for k in names],)),
        (W.pipe_fn_case, _fn_inputs())] + oracle + refusals,))
    return {"runs": [dict(zip(names, r[0])) for r in per_rank],
            "fns": [r[1] for r in per_rank],
            "oracle": {None: [r[2] for r in per_rank],
                       0.0: [r[3] for r in per_rank]},
            "refused": {m: [r[4 + i] for r in per_rank]
                        for i, m in enumerate(BAD_MICRO)},
            "tmp": tmp}


@pytest.mark.parametrize("schedule", ["1f1b", "gpipe"])
def test_mlp_pipeline_matches_local(world4, schedule):
    """test_mlp_pipeline_matches_local: four stages, four microbatches,
    momentum SGD, four iterations: the loss and every parameter against
    the port's LocalOptimizer and the JAX pipeline run."""
    jparams, jloss = _jax_pipe(schedule)
    lparams, lloss = _jax_local()
    for r, rank in enumerate(world4["runs"]):
        run, local = rank[schedule], rank["local"]
        assert run["type"] == "DistriOptimizer"
        assert run["coords"] == {"pipe": r}
        assert abs(run["loss"][-1] - local["loss"][-1]) < LOSS_ATOL
        assert abs(run["loss"][-1] - jloss) < LOSS_ATOL
        assert abs(local["loss"][-1] - lloss) < LOSS_ATOL
        assert_trees(run["params"], local["params"], **PARAM_TOL)
        assert_trees(run["params"], jparams, **PARAM_TOL)
        assert [tuple(x) for x in run["ranges"]] == [
            tuple(x) for x in jpartition(_jax_mlp(), 4, (4, 12)).ranges]
        # stage r of 1F1B holds at most P - r microbatches, GPipe M
        assert run["peak_in_flight"] == (4 - r if schedule == "1f1b" else 4)


def test_gradient_checkpointing_is_gpipe_without_it(world4):
    """GPipe with ``set_gradient_checkpointing`` (each stage under
    ``torch.utils.checkpoint``) gives GPipe's trajectory."""
    for rank in world4["runs"]:
        assert_trees(rank["gpipe_remat"]["params"], rank["gpipe"]["params"],
                     rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(rank["gpipe_remat"]["loss"],
                                   rank["gpipe"]["loss"], rtol=1e-6)


@pytest.mark.parametrize("schedule", ["1f1b", "gpipe"])
def test_hybrid_dp_pp_matches_local(world4, schedule):
    """test_mlp_hybrid_dp_pp_matches_local at ``{"data": 2, "pipe": 2}``:
    each microbatch split over the data replicas, the gradients summed,
    the trajectory LocalOptimizer's."""
    for r, rank in enumerate(world4["runs"]):
        run, local = rank[f"hybrid_{schedule}"], rank["local"]
        assert run["coords"] == {"data": r // 2, "pipe": r % 2}
        assert abs(run["loss"][-1] - local["loss"][-1]) < LOSS_ATOL
        assert_trees(run["params"], local["params"], **PARAM_TOL)


def test_default_mesh_is_the_world_and_chunks_match(world4):
    """No mesh: the world is the pipe (the train_vgg.py --pipeline path);
    two steps a dispatch give the one-step trajectory."""
    for rank in world4["runs"]:
        run = rank["default_mesh"]
        assert run["loss"] == rank["1f1b"]["loss"][:2]
        assert_trees(rank["n2"]["params"], rank["1f1b"]["params"],
                     rtol=0, atol=0)


def test_validation_streams_through_the_stages(world4):
    """Validation every 2 iterations (40 records, batches of 16, the last
    of 8): Top1 and the loss of the pipeline equal LocalOptimizer's, on
    every rank."""
    for rank in world4["runs"]:
        got, want = rank["validate"]["validation"], \
            rank["local_validate"]["validation"]
        assert len(got) == len(want) == 1
        assert got[0]["Top1Accuracy"] == want[0]["Top1Accuracy"]
        np.testing.assert_allclose(got[0]["Loss"], want[0]["Loss"],
                                   rtol=1e-5)


def test_checkpoint_resume_matches_uninterrupted(world4, tmp_path):
    """test_pipeline_checkpoint_resume_matches_uninterrupted: a snapshot
    after four iterations (an epoch boundary) resumed for two more lands
    on the six-iteration run; the snapshot's arrays are the JAX run's
    (the whole model in the JAX tree, the velocity stage-stacked (P,
    max_p)), and each package reads the other's file."""
    for rank in world4["runs"]:
        assert rank["resume"]["neval"] == rank["full6"]["neval"] == 7
        assert abs(rank["resume"]["loss"][-1]
                   - rank["full6"]["loss"][-1]) < LOSS_ATOL
        assert_trees(rank["resume"]["params"], rank["full6"]["params"],
                     **PARAM_TOL)
        assert_trees(rank["full6"]["params"], rank["local6"]["params"],
                     **PARAM_TOL)
    _jax_pipe("1f1b", iters=4, tmp=tmp_path, ckpt=5)
    port_dir = world4["tmp"] / "a"
    port = File.load(str(port_dir / "state.5"))
    jax_ = JFile.load(str(tmp_path / "state.5"))
    want = np.asarray(jax_["opt_state"]["velocity"])
    assert port["opt_state"]["velocity"].shape == want.shape == (4, 1056)
    np.testing.assert_allclose(port["opt_state"]["velocity"], want,
                               **PARAM_TOL)
    from bigdl_tpu_torch.nn.module import export_params
    jm = JFile.load_module_into(_jax_mlp(), str(port_dir / "model.5"))
    pm = File.load_module_into(W.build("mlp_pp"), str(tmp_path / "model.5"))
    assert_trees(export_params(pm), _numpy(jm.params()), **PARAM_TOL)


# -- the schedule functions ------------------------------------------------

def _jax_fn(kind):
    stages, x, t = _fn_inputs()
    stacked = stack_stage_params([{k: jnp.asarray(v) for k, v in s.items()}
                                  for s in stages])
    mesh = jmake_mesh({"pipe": 4}, jax.devices()[:4])
    x, t = jnp.asarray(x), jnp.asarray(t)

    def stage_fn(p, h):
        return jnp.tanh(h @ p["w"] + p["b"])

    def mse(y, tt):
        return ((y - tt) ** 2).mean()

    if kind == "forward":
        return np.asarray(jpipeline_apply(stage_fn, stacked, x, mesh, "pipe"))
    if kind == "sq":
        def loss(p):
            return (jpipeline_apply(stage_fn, p, x, mesh, "pipe") ** 2).sum()
        return jax.value_and_grad(loss)(stacked)
    if kind == "gpipe":
        def loss(p):
            y = jpipeline_apply(stage_fn, p, x, mesh, "pipe")
            return jax.vmap(mse)(y, t).mean()
        return jax.value_and_grad(loss)(stacked)
    if kind == "1f1b":
        return j1f1b(stage_fn, mse, stacked, x, t, mesh, "pipe")

    def ref(ps):   # the single-device reference
        h = x
        for p in ps:
            h = jax.vmap(lambda m, p=p: stage_fn(p, m))(h)
        return jax.vmap(mse)(h, t).mean()
    return jax.value_and_grad(ref)([{k: jnp.asarray(v) for k, v in s.items()}
                                    for s in stages])


def _stage_grads(grads, r):
    return [np.asarray(grads["w"][r]), np.asarray(grads["b"][r])]


def test_pipeline_apply_matches_sequential_and_jax(world4):
    """TestPipeline: GPipe's forward over four stages equals the stages
    applied in sequence (and the JAX ``pipeline_apply``), and its
    gradients under ``sum(outputs**2)`` equal the JAX ones."""
    stages, x, _ = _fn_inputs()
    want = x
    for s in stages:
        want = np.tanh(want @ s["w"] + s["b"])
    np.testing.assert_allclose(world4["fns"][3]["forward"], want, atol=1e-5)
    np.testing.assert_allclose(world4["fns"][3]["forward"],
                               _jax_fn("forward"), atol=1e-5)
    loss, grads = _jax_fn("sq")
    for r, out in enumerate(world4["fns"]):
        assert out["forward"] is None or r == 3
        np.testing.assert_allclose(out["sq"][0], float(loss), rtol=1e-5)
        for a, b in zip(out["sq"][1], _stage_grads(grads, r)):
            np.testing.assert_allclose(a, b, **FN_TOL)


@pytest.mark.parametrize("kind", ["gpipe", "1f1b", "reference"])
def test_1f1b_matches_gpipe_and_the_reference(world4, kind):
    """Test1F1B: 1F1B's loss and gradients equal GPipe's autodiff (the
    JAX ``pipeline_apply`` under ``jax.grad``), the JAX 1F1B and the
    single-device reference; the port's GPipe, with and without
    checkpointing, equals them too; in flight at most P on stage 0 under
    1F1B, M under GPipe."""
    loss, grads = _jax_fn(kind)
    for r, out in enumerate(world4["fns"]):
        want = (_stage_grads(grads, r) if kind != "reference"
                else [np.asarray(grads[r]["w"]), np.asarray(grads[r]["b"])])
        for run in ("1f1b", "gpipe", "gpipe_remat"):
            np.testing.assert_allclose(out[run][0], float(loss), rtol=1e-5)
            for a, b in zip(out[run][1], want):
                np.testing.assert_allclose(a, b, **FN_TOL)
        assert out["1f1b"][2] == 4 - r <= 4
        assert out["gpipe"][2] == N_MICRO
        # 1F1B's bubble is GPipe's: (P-1) idle ticks of each kind a stage
        assert out["1f1b"][3] == pytest.approx(out["gpipe"][3])


def test_1f1b_oracle_with_bn_and_dropout(world4):
    """test_1f1b_exact_oracle_with_bn_and_dropout: 1F1B over four stages
    equals its own stages run one after another with the same seeds --
    the loss, each stage's gradients and its running statistics moved per
    microbatch -- with dropout active (the port's masks); the dropout
    fired; and at dropout 0 the loss, gradients and statistics equal the
    JAX 1F1B's."""
    live, off = world4["oracle"][None], world4["oracle"][0.0]
    for out in live + off:
        assert abs(out["loss"] - out["serial_loss"]) < 1e-6
        np.testing.assert_allclose(out["grads"], out["serial_grads"],
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(out["state"], out["serial_state"],
                                   rtol=1e-5, atol=1e-7)
    assert abs(live[0]["loss"] - off[0]["loss"]) > 1e-4
    model = _jax_bn_conv(0.0, 0.0)
    plan = jpartition(model, 4, (2, 3, 8, 8))
    assert [tuple(r) for r in plan.ranges] == \
        [tuple(r) for r in off[0]["ranges"]]
    x, y = _bn_inputs()
    xf = plan.pack_input(jnp.asarray(x).reshape(4, 2, 3, 8, 8))
    tm = jnp.asarray(y).reshape(4, 2)
    mesh = jmake_mesh({"pipe": 4}, jax.devices()[:4])
    loss, grads, new_s = jax.jit(lambda p, s: j1f1b(
        plan.make_stage_fn(jax.random.PRNGKey(5)),
        plan.make_loss_fn(jnn.ClassNLLCriterion()), p, xf, tm, mesh,
        "pipe", stage_state=s))(plan.pack_params(model.params()),
                                plan.pack_state(model.state()))
    for r, out in enumerate(off):
        assert abs(out["loss"] - float(loss)) < 1e-5
        np.testing.assert_allclose(out["grads"], np.asarray(
            grads[r, :plan.p_sizes[r]]), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(out["state"], np.asarray(
            new_s[r, :plan.s_sizes[r]]), rtol=1e-5, atol=1e-6)


# -- refusals -------------------------------------------------------------

def _ds(batch=16):
    xs, ys = _mlp_data()
    return DataSet.array(W.samples_of(xs, ys)) >> SampleToBatch(batch)


def test_invalid_combinations_are_the_jax_words():
    """test_pipeline_invalid_combos and the constructor's other pipeline
    validations (bigdl_tpu/optim/distri_optimizer.py:115-166)."""
    def make(**kw):
        return DistriOptimizer(W.build("mlp_pp"), kw.pop("ds", _ds()),
                               nn.ClassNLLCriterion(), device="cpu", **kw)

    for flag in ({"zero1": True}, {"tensor_parallel": True},
                 {"gradient_compression": "bf16"},
                 {"expert_parallel": True}, {"sequence_parallel": True}):
        with pytest.raises(ValueError, match=re.escape(
                "pipeline_stages owns the mesh; it does not combine with "
                "tensor_parallel/zero1/gradient_compression/"
                "expert_parallel/sequence_parallel")):
            make(pipeline_stages=4, **flag)
    with pytest.raises(ValueError, match="pipeline_schedule must be "
                                         "'1f1b' or 'gpipe'"):
        make(pipeline_stages=4, pipeline_schedule="interleaved")
    with pytest.raises(ValueError, match=re.escape(
            "multi-host pipeline_stages needs a replicated (non-distributed)"
            " dataset: every process feeds the identical global batch")):
        xs, ys = _mlp_data()
        make(pipeline_stages=1, ds=DataSet.array(
            W.samples_of(xs, ys), distributed=True) >> SampleToBatch(16))
    with pytest.raises(ValueError, match=re.escape(
            "mesh needs a 'pipe' axis of size 4, got {'data': 1}")):
        make(pipeline_stages=4, mesh=make_mesh({"data": 1}, "cpu"))
    with pytest.raises(ValueError, match=re.escape(
            "pipeline_stages=4 needs that many devices, have 1")):
        make(pipeline_stages=4)
    pipe = make_mesh({"pipe": 1}, "cpu")
    other = Mesh(pipe.group, {"pipe": 1, "seq": 1},
                 {"pipe": pipe.axis("pipe"), "seq": pipe.axis("pipe")})
    with pytest.raises(ValueError, match=re.escape(
            "pipeline meshes support 'pipe' plus an optional 'data' axis "
            "(hybrid dp x pp), got ('pipe', 'seq')")):
        make(pipeline_stages=1, mesh=other)
    with pytest.raises(ValueError, match="straggler drop masks "
                                         "per-DATA-replica gradients"):
        make(pipeline_stages=1, mesh=pipe, drop_percentage=0.1)
    opt = make(pipeline_stages=1, mesh=pipe)
    with pytest.raises(ValueError, match="straggler drop masks"):
        opt.set_drop_module_property(0.1, 0.1)


@pytest.mark.parametrize("micro", sorted(BAD_MICRO))
def test_batch_checks_are_the_jax_words(world4, micro):
    """The JAX ``_build_step_pipeline``'s batch checks, raised at the
    first step on every rank: B divisible by M; the microbatch by the
    data axis (the JAX test's mb 1 over d 2)."""
    for refused in world4["refused"][micro]:
        assert refused == ("ValueError", BAD_MICRO[micro])


def test_local_gradient_checkpointing_is_the_plain_step():
    """``LocalOptimizer.set_gradient_checkpointing``: the forward runs
    again in the backward, its dropout masks and running statistics as
    the first run left them; with BN and active dropout the trajectory
    is the plain one's, bit for bit."""
    from bigdl_tpu_torch.nn.module import export_state, load_jax_params
    from bigdl_tpu_torch.optim import LocalOptimizer, max_iteration
    from bigdl_tpu_torch.utils.random import RNG
    from bigdl_tpu_torch.utils.table import T

    init = _numpy(_jax_bn_conv().params())
    x, y = _bn_inputs()
    runs = []
    for remat in (False, True):
        RNG.set_seed(4)
        model = load_jax_params(W.build("bn_conv"), init)
        opt = LocalOptimizer(model, DataSet.array(W.samples_of(x, y), seed=2)
                             >> SampleToBatch(4), nn.ClassNLLCriterion(),
                             device="cpu")
        opt.set_state(T(**MOM)).set_end_when(max_iteration(3))
        opt.set_gradient_checkpointing(remat).optimize()
        runs.append(([l for _, l in opt.loss_log], W.export_params(model),
                     export_state(model)))
    (l0, p0, s0), (l1, p1, s1) = runs
    assert l0 == l1 and len(l0) == 3
    assert_trees(p1, p0, rtol=0, atol=0)
    assert_trees(s1, s0, rtol=0, atol=0)
