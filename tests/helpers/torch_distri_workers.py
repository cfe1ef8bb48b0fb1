"""What each rank of the port's data-parallel tests runs: build a small
model from a JAX parameter tree, train it through the port's
``DistriOptimizer`` (or ``LocalOptimizer``, or the ``Optimizer``
factory) on the CPU under gloo, and return the trajectory as numpy.

The ranks are processes started by ``bigdl_tpu_torch.parallel.launch``;
this module imports the port alone (no JAX), so they do too.  Every
function here is at module level: a spawned rank finds it by its import
path."""
from __future__ import annotations

import logging

import numpy as np
import torch
import torch.distributed as dist

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToBatch
from bigdl_tpu_torch.nn.module import export_params, export_state
from bigdl_tpu_torch.nn.module import load_jax_params, load_jax_state
from bigdl_tpu_torch.optim import (DistriOptimizer, LocalOptimizer,
                                   Optimizer, max_iteration)
from bigdl_tpu_torch.utils.engine import Engine
from bigdl_tpu_torch.utils.table import T


def build(name: str, arch: dict = None):
    """The tests' models (the JAX tests' shapes); ``arch`` the keyword
    arguments of the attention family's builders."""
    arch = arch or {}
    if name == "classifier":
        from bigdl_tpu_torch.models.transformer import TransformerClassifier
        return TransformerClassifier(device="cpu", **arch)
    if name == "lm":
        from bigdl_tpu_torch.models.transformer import TransformerLM
        return TransformerLM(device="cpu", **arch)
    if name == "attn":   # tests/test_attention_sp.py:_attn_model
        return nn.Sequential(
            nn.MultiHeadSelfAttention(16, 4, device="cpu"),
            nn.Mean(1, n_input_dims=2), nn.Linear(16, 4), nn.LogSoftMax())
    if name == "moe":    # tests/test_moe_layer.py:_moe_model
        return nn.Sequential(
            nn.Linear(10, 12), nn.ReLU(),
            nn.MoE(12, 24, 4, capacity_factor=arch.get("capacity_factor",
                                                       2.0), device="cpu"),
            nn.Linear(12, 4), nn.LogSoftMax())
    if name == "softmax":   # per-position classes over (N, C, W)
        return nn.Sequential(nn.Linear(8, 12), nn.Reshape([4, 3]))
    if name == "rnn":   # a time-mixing layer
        return nn.Sequential(nn.Recurrent().add(nn.RnnCell(16, 8, nn.Tanh())),
                             nn.Mean(1, n_input_dims=2), nn.Linear(8, 4),
                             nn.LogSoftMax())
    if name == "mlp":
        return nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 4),
                             nn.LogSoftMax())
    if name == "mlp17":   # 225 parameters: divides by neither 4 nor 8
        return nn.Sequential(nn.Linear(8, 17), nn.ReLU(), nn.Linear(17, 4),
                             nn.LogSoftMax())
    if name == "bn":
        return nn.Sequential(nn.Linear(8, 16),
                             nn.BatchNormalization(16, device="cpu"),
                             nn.ReLU(), nn.Linear(16, 4), nn.LogSoftMax())
    if name == "tanh":
        return nn.Sequential(nn.Linear(6, 8), nn.Tanh(), nn.Linear(8, 3),
                             nn.LogSoftMax())
    if name == "lenet":
        from bigdl_tpu_torch.models.lenet import LeNet5
        return LeNet5(10, device="cpu")
    if name == "mlp_pp":   # tests/test_pipeline_optimizer.py:_mlp
        return nn.Sequential(nn.Linear(12, 32), nn.ReLU(True),
                             nn.Linear(32, 32), nn.Tanh(),
                             nn.Linear(32, 16), nn.ReLU(True),
                             nn.Linear(16, 5), nn.LogSoftMax())
    if name == "bn_conv":   # tests/test_pipeline_optimizer.py:_bn_conv_net
        return nn.Sequential(
            nn.SpatialConvolution(3, 8, 3, 3, 1, 1, 1, 1),
            nn.SpatialBatchNormalization(8, device="cpu"), nn.ReLU(True),
            nn.Dropout(arch.get("p1", 0.3)),
            nn.SpatialConvolution(8, 8, 3, 3, 1, 1, 1, 1),
            nn.SpatialMaxPooling(2, 2, 2, 2), nn.Reshape([8 * 4 * 4]),
            nn.Linear(8 * 4 * 4, 16), nn.BatchNormalization(16, device="cpu"),
            nn.Dropout(arch.get("p2", 0.5)), nn.Linear(16, 5),
            nn.LogSoftMax())
    if name == "lstm":   # a module with no tensor-parallel form
        return nn.Sequential(nn.Recurrent().add(nn.LSTMCell(16, 8,
                                                            device="cpu")),
                             nn.Mean(1, n_input_dims=2), nn.Linear(8, 4),
                             nn.LogSoftMax())
    raise ValueError(name)


def criterion(spec):
    kind = spec.get("criterion", "nll")
    if kind == "nll":
        return nn.ClassNLLCriterion()
    if kind == "nll_sum":
        return nn.ClassNLLCriterion(size_average=False)
    if kind == "nll_weighted":
        return nn.ClassNLLCriterion(weights=spec["class_weights"])
    if kind == "tdc":
        return nn.TimeDistributedCriterion(nn.ClassNLLCriterion(),
                                           size_average=True)
    if kind == "tdc_sum":
        return nn.TimeDistributedCriterion(nn.ClassNLLCriterion())
    if kind == "softmax_ignore":
        return nn.SoftmaxWithCriterion(ignore_label=spec["ignore_label"])
    raise ValueError(kind)


class Schedule:
    """A per-task time schedule for straggler tests (``time_source``):
    ``slow`` tasks read ``value`` seconds at the iterations listed in
    ``calls`` (1-based; None: every iteration), the others 1 second."""

    def __init__(self, n_tasks, slow=(), value=9.0, calls=None,
                 every=None):
        self.n_tasks, self.slow, self.value = n_tasks, list(slow), value
        self.calls = None if calls is None else set(calls)
        self.every = every
        self.n = 0

    def __call__(self, wall):
        self.n += 1
        if self.every is not None and self.n in self.calls:
            return np.full(self.n_tasks, self.every)
        t = np.ones(self.n_tasks)
        if self.calls is None or self.n in self.calls:
            t[self.slow] = self.value
        return t


class _Count(logging.Handler):
    """Counts the log records that carry ``word``."""

    def __init__(self, word):
        super().__init__(logging.WARNING)
        self.word, self.n = word, 0

    def emit(self, record):
        self.n += self.word in record.getMessage()


def dataset(spec):
    """The records of ``spec`` (``xs`` / ``ys``, or ``mnist``: (n,
    seed) synthetic digits, normalised) in batches of ``batch``."""
    seed, distributed = spec.get("seed", 1), spec.get("distributed", False)
    if spec.get("mnist") is not None:
        from bigdl_tpu_torch.dataset import (ImgNormalizer, ImgToBatch,
                                             mnist)
        return (DataSet.array(mnist.synthetic(*spec["mnist"]), seed=seed,
                              distributed=distributed)
                >> ImgNormalizer(mnist.TRAIN_MEAN, mnist.TRAIN_STD)
                >> ImgToBatch(spec["batch"]))
    return (DataSet.array(samples_of(spec["xs"], spec["ys"]), seed=seed,
                          distributed=distributed)
            >> SampleToBatch(spec["batch"]))


def samples_of(xs, ys):
    """Records of features ``xs`` and labels ``ys``: a scalar label a
    one-element array, a label array (one a time step) as it is."""
    return [Sample(x, np.asarray(y) if np.ndim(y) else np.asarray([y]))
            for x, y in zip(xs, ys)]


def run(spec: dict) -> dict:
    """Train as ``spec`` says on this rank; the trajectory as numpy.

    ``spec``: ``model`` (a name of :func:`build`), ``init`` (the JAX
    parameter tree) and optionally ``init_state``, ``xs`` / ``ys`` (the
    records), ``batch``, ``seed`` (the dataset's stream), ``distributed``
    (a sharded dataset), ``optimizer`` ("distri", "local" or "factory"),
    ``kw`` (the DistriOptimizer's arguments), ``state`` (the Table),
    ``mnist`` (synthetic digits in place of the records), ``resume`` (a
    checkpoint directory to start from, the random payload restored),
    ``iters``, ``n_disp``, ``drop`` (straggler arguments with a
    ``Schedule``), ``poison`` ({rank: step}: that rank's input is NaN at
    that step), ``checkpoint`` ((path, every n)), ``opt_state`` (a tree
    to resume from), ``validate`` ((xs, ys, batch)), ``method``
    ("adagrad": the OptimMethod, default SGD).
    """
    model = build(spec["model"], spec.get("arch"))
    load_jax_params(model, spec["init"])
    if spec.get("init_state") is not None:
        load_jax_state(model, spec["init_state"])
    ds = dataset(spec)
    blob = None
    if spec.get("resume") is not None:
        from bigdl_tpu_torch.optim import load_latest_checkpoint
        model, blob, _ = load_latest_checkpoint(
            spec["resume"], restore_rng=True, device="cpu", dataset=ds)
    kind = spec.get("optimizer", "distri")
    kw = spec.get("kw", {})
    crit = criterion(spec)
    if kind == "local":
        opt = LocalOptimizer(model, ds, crit, device="cpu")
    elif kind == "factory":
        opt = Optimizer(model, ds, crit, device="cpu", **kw)
    else:
        if spec.get("mesh") is not None:
            from bigdl_tpu_torch.parallel.mesh import make_mesh
            kw = dict(kw, mesh=make_mesh(spec["mesh"], "cpu"))
        opt = DistriOptimizer(model, ds, crit, device="cpu", **kw)
    if blob is not None:
        opt.set_state(blob["state"]).set_optim_state(blob["opt_state"])
    else:
        opt.set_state(T(**spec.get("state", {"learningRate": 0.1})))
    opt.set_end_when(max_iteration(spec["iters"]))
    if spec.get("method") == "adagrad":
        from bigdl_tpu_torch.optim import Adagrad
        opt.set_optim_method(Adagrad())
    if spec.get("n_disp"):
        opt.set_iterations_per_dispatch(spec["n_disp"])
    if spec.get("drop") is not None:
        opt.set_drop_module_property(**spec["drop"])
    if spec.get("opt_state") is not None:
        opt.set_optim_state(spec["opt_state"])
    if spec.get("remat"):
        opt.set_gradient_checkpointing(True)
    if spec.get("checkpoint") is not None:
        from bigdl_tpu_torch.optim import several_iteration
        path, every = spec["checkpoint"]
        opt.set_checkpoint(path, several_iteration(every))
    if spec.get("validate") is not None:
        from bigdl_tpu_torch.optim import (Loss, Top1Accuracy, every_epoch,
                                           several_iteration)
        vx, vy, vb = spec["validate"][:3]
        val = DataSet.array(samples_of(vx, vy)) >> SampleToBatch(vb)
        if len(spec["validate"]) > 3:   # every n iterations, two methods
            opt.set_validation(several_iteration(spec["validate"][3]), val,
                               [Top1Accuracy(), Loss(nn.ClassNLLCriterion())])
        else:
            opt.set_validation(every_epoch(), val, [Top1Accuracy()])
    poison = spec.get("poison", {}).get(Engine.process_index())
    if poison is not None:
        step = opt._train_step

        def poisoned(params, opt_state, x, y, hyper):
            if int(opt.state["neval"]) == poison:
                x = torch.full_like(x, float("nan"))
            return step(params, opt_state, x, y, hyper)
        opt._train_step = poisoned
    rejected = _Count("REJECTED")
    logging.getLogger("bigdl_tpu_torch.optim").addHandler(rejected)
    try:
        opt.optimize()
    finally:
        logging.getLogger("bigdl_tpu_torch.optim").removeHandler(rejected)
    out = {"type": type(opt).__name__,
           "rejected": rejected.n,
           "params": export_params(model),
           "state": export_state(model),
           "loss": [l for _, l in opt.loss_log],
           "neval": int(opt.state["neval"]),
           "epoch": int(opt.state["epoch"]),
           "skips": int(opt.state.get("nonFiniteSkips", 0)),
           "opt_state": opt._export_opt_state(opt.opt_state),
           "validation": [v for _, _, v in opt.validation_log],
           "world": Engine.device_count(),
           "rank": Engine.process_index()}
    if isinstance(opt, DistriOptimizer):
        out["coords"] = opt.mesh.coords()
        out["specs"] = opt.expert_param_specs()
        if opt._part is not None:
            out["flat_length"] = opt._part.length
            out["wire_bytes"] = opt.wire_bytes
        out["tp_gathered"] = dict(opt.tp_gathered_leaves)
        if opt.pipe_result is not None:
            out["peak_in_flight"] = opt.pipe_result.peak_in_flight
            out["bubble"] = opt.pipe_result.bubble
            out["ranges"] = opt._pipe.plan.ranges
        out["velocity_numel"] = sum(
            v.numel() for v in opt.opt_state.get("velocity", []))
        out["per_node"] = opt.metrics.per_node("computing time average",
                                               opt.mesh)
        if opt._straggler is not None:
            out["straggler"] = (opt._straggler.iteration,
                                opt._straggler.threshold)
    if spec.get("predict") is not None:
        model.evaluate()
        with torch.no_grad():
            out["predict"] = model(torch.from_numpy(
                np.asarray(spec["predict"], np.float32))).numpy()
    return out


def validator_case(spec: dict) -> dict:
    """The validators on this rank over ``spec``'s model (``init``) and
    records (``xs`` / ``ys`` in batches of ``batch``): ``DistriValidator``
    over the whole set on every rank (each takes every N-th batch),
    the ``Validator`` factory over a sharded set (it routes to the
    distributed evaluation) and ``distri_validate`` over the same; each
    result as (value, count)."""
    from bigdl_tpu_torch.optim import (DistriValidator, Loss, Top1Accuracy,
                                       Top5Accuracy, Validator,
                                       distri_validate)

    model = build(spec["model"], spec.get("arch"))
    load_jax_params(model, spec["init"])
    methods = [Top1Accuracy(), Top5Accuracy(), Loss(nn.ClassNLLCriterion())]
    whole = DataSet.array(samples_of(spec["xs"], spec["ys"])) \
        >> SampleToBatch(spec["batch"])
    shard = DataSet.array(samples_of(spec["xs"], spec["ys"]),
                          distributed=True) >> SampleToBatch(spec["batch"])

    def values(results):
        return [r.result() for _, r in results]
    return {"distri": values(DistriValidator(model, whole, device="cpu")
                             .test(methods)),
            "factory": values(Validator(model, shard, device="cpu")
                              .test(methods)),
            "function": values(distri_validate(model, shard, methods,
                                               "cpu"))}


def global_batch_case(xs, ys, global_batch: int) -> list:
    """The row counts of ``SampleToBatch(global_batch_size=)``'s batches
    on this rank (the global batch over the live world)."""
    ds = DataSet.array(samples_of(xs, ys), distributed=True) \
        >> SampleToBatch(global_batch_size=global_batch)
    return [int(b.data.shape[0]) for b in ds.data(train=False)]


def runs(specs: list) -> list:
    """Several runs in one process group, one after another."""
    out = []
    for spec in specs:
        out.append(run(spec))
        dist.barrier()
    return out


def policy_case(name: str, specs: list) -> list:
    """:func:`runs` of ``specs`` under the port's dtype policy ``name``
    (process state: each rank sets it), FP32 restored after; each run
    also names the compute dtype it ran under."""
    from bigdl_tpu_torch import tensor

    tensor.set_policy(getattr(tensor, name))
    try:
        out = runs(specs)
        for o in out:
            o["compute_dtype"] = str(tensor.policy().compute_dtype)
        return out
    finally:
        tensor.set_policy(tensor.FP32)


def calls(jobs: list) -> list:
    """Several case functions in one process group, one after another:
    ``jobs`` a list of (function, arguments); their results."""
    out = []
    for fn, args in jobs:
        out.append(fn(*args))
        dist.barrier()
    return out


def sync_bn_case(params, x, g):
    """Rank r's half of the batch ``x`` through a batch norm that takes
    the global batch's statistics; ``g`` the output's cotangent."""
    r, n = Engine.process_index(), Engine.device_count()
    rows = slice(r * len(x) // n, (r + 1) * len(x) // n)
    bn = nn.SpatialBatchNormalization(x.shape[1], device="cpu")
    load_jax_params(bn, params)
    bn.process_group = dist.group.WORLD
    xt = torch.from_numpy(x[rows]).requires_grad_()
    y = bn(xt)
    (y * torch.from_numpy(g[rows])).sum().backward()
    return {"y": y.detach().numpy(), "dx": xt.grad.numpy(),
            "dw": bn.weight.grad.numpy(), "db": bn.bias.grad.numpy(),
            "state": export_state(bn)}


def collectives_case() -> dict:
    """The collectives, the mesh, the broadcasts and the per-rank metrics
    on this rank; what each gave, as numpy."""
    from bigdl_tpu_torch.models.lenet import LeNet5
    from bigdl_tpu_torch.optim.metrics import Metrics
    from bigdl_tpu_torch.parallel import collectives as coll
    from bigdl_tpu_torch.parallel.broadcast import (broadcast_from_host0,
                                                    model_broadcast)
    from bigdl_tpu_torch.parallel.mesh import (data_parallel_mesh,
                                               hybrid_mesh, make_mesh)
    from bigdl_tpu_torch.utils.random import generator

    r, n = Engine.process_index(), Engine.device_count()
    out = {"rank": r, "axis_index": coll.axis_index(),
           "axis_size": coll.axis_size()}
    mesh = data_parallel_mesh("cpu")
    out["mesh"] = (mesh.shape, mesh.axis_names, mesh.rank(),
                   make_mesh({"data": n}, "cpu").size,
                   coll.axis_index(mesh), coll.axis_size(mesh))
    refused = []
    for call in (lambda: make_mesh({"data": n + 1}, "cpu"),
                 lambda: make_mesh({"data": n, "model": 2}, "cpu"),
                 lambda: hybrid_mesh(n, 1, "cpu"),
                 lambda: make_mesh({"seq": n}, "cpu"),
                 lambda: coll.reduce_scatter(torch.zeros(n + 1), mesh)):
        try:
            call()
            refused.append(None)
        except (ValueError, NotImplementedError) as e:
            refused.append(type(e).__name__)
    out["refused"] = refused
    # reduce-scatter + all-gather == all-reduce (AllReduceParameter)
    v = torch.from_numpy(np.random.RandomState(r).randn(3 * n)
                         .astype(np.float32))
    part = coll.reduce_scatter(v, mesh)
    out["rs"] = part.numpy()
    out["rs_ag"] = coll.all_gather(part, mesh).numpy()
    out["ar"] = coll.all_reduce(v.clone(), mesh).numpy()
    out["mean"] = coll.all_reduce_mean(v.clone(), mesh).numpy()
    # the all-gather in place: this rank's slice of the output as input
    flat = torch.full((2 * n,), -1.0)
    flat[2 * r:2 * r + 2] = torch.tensor([10.0 * r, 10.0 * r + 1])
    coll.all_gather(flat[2 * r:2 * r + 2], mesh, out=flat)
    out["inplace"] = flat.numpy()
    out["bf16_sum"] = coll.all_reduce(
        torch.full((4,), 1.0 + r, dtype=torch.bfloat16), mesh).float().numpy()
    # rank 0's values everywhere: tensors of two dtypes, then a model
    ts = [torch.full((3,), float(r)), torch.arange(4) * (r + 1),
          torch.full((2, 2), 0.5 * r)]
    broadcast_from_host0(ts, mesh)
    out["broadcast"] = [t.numpy() for t in ts]
    model = LeNet5(10, device="cpu", generator=generator(r))
    out["model"] = export_params(model_broadcast(model, mesh))
    metrics = Metrics()
    metrics.add("computing time average", 1.0 + r, distributed=True)
    metrics.add("computing time average", 3.0 + r, distributed=True)
    metrics.add("local", 5.0)
    out["per_node_live"] = metrics.per_node("computing time average", mesh)
    metrics.collect_per_node(mesh)
    out["per_node"] = metrics.per_node("computing time average", mesh)
    out["summary"] = metrics.summary(per_node=True, group=mesh)
    return out


def fail_on(rank: int):
    """Raise on rank ``rank`` (the launcher re-raises it in the parent)."""
    if Engine.process_index() == rank:
        raise ValueError(f"raised by rank {rank}")
    return Engine.process_index()


# -- the attention family's collectives ---------------------------------

def mesh_case(shapes):
    """Each mesh of ``shapes`` on this rank: its shape, this rank's
    coordinates and each axis's members."""
    from bigdl_tpu_torch.parallel.mesh import make_mesh
    out = []
    for shape in shapes:
        mesh = make_mesh(shape, "cpu")
        out.append((mesh.shape, mesh.coords(),
                    {k: mesh.axis(k).ranks for k in mesh.axis_names}))
    return out


def ring_case(q, k, v, g, causal):
    """This rank's block of the (B, T, H, hd) q, k, v through
    ``ring_attention`` over a ``{"data": 1, "seq": world}`` mesh, the
    output's cotangent ``g``: (out, dq, dk, dv) of the block."""
    from bigdl_tpu_torch.parallel.mesh import make_mesh
    from bigdl_tpu_torch.parallel.ring_attention import ring_attention

    seq = make_mesh({"data": 1, "seq": -1}, "cpu").axis("seq")
    t = q.shape[1] // seq.size
    own = slice(seq.index * t, (seq.index + 1) * t)
    qt, kt, vt = (torch.from_numpy(a[:, own].copy()).requires_grad_()
                  for a in (q, k, v))
    out = ring_attention(qt, kt, vt, seq, causal=causal)
    dq, dk, dv = torch.autograd.grad(out, (qt, kt, vt),
                                     torch.from_numpy(g[:, own].copy()))
    return [a.detach().numpy() for a in (out, dq, dk, dv)]


def collectives_p2p_case(x):
    """ppermute, ring_shift, all_to_all (tiled and not) of rank r's
    ``x + r`` over the world, and the all-to-all's gradient."""
    from bigdl_tpu_torch.parallel import collectives as coll

    r, n = Engine.process_index(), Engine.device_count()
    mine = torch.from_numpy(x + r)
    out = {"ppermute": coll.ppermute(mine, None, [(0, n - 1)]).numpy(),
           "shift": coll.ring_shift(mine, None, 1).numpy(),
           "shift2": coll.ring_shift(mine, None, -1).numpy()}
    t = mine.clone().requires_grad_()
    y = coll.all_to_all(t, None, 0, 1, tiled=True)
    (y * torch.arange(y.numel(), dtype=y.dtype).view(y.shape)).sum() \
        .backward()
    out["a2a"], out["a2a_grad"] = y.detach().numpy(), t.grad.numpy()
    stacked = torch.from_numpy(np.stack([x + r] * n))
    out["a2a_untiled"] = coll.all_to_all(stacked, None, 0, 0,
                                         tiled=False).numpy()
    return out


def moe_apply_case(params, x, g, sharded):
    """This rank's expert shard of ``params`` (router, w1, b1, w2, b2)
    through ``moe_apply`` (``x`` (T, D) on every rank) or, with
    ``sharded``, ``moe_apply_sharded_tokens`` on this rank's own rows of
    ``x``; the output, and the gradients under cotangent ``g``."""
    from bigdl_tpu_torch.parallel.moe import (moe_apply,
                                              moe_apply_sharded_tokens)

    r, n = Engine.process_index(), Engine.device_count()
    e = params["w1"].shape[0] // n
    own = slice(r * e, (r + 1) * e)
    ts = {k: torch.from_numpy(np.array(v if k == "router" else v[own]))
          .requires_grad_() for k, v in params.items()}
    if sharded:
        rows = slice(r * len(x) // n, (r + 1) * len(x) // n)
        xt = torch.from_numpy(x[rows].copy()).requires_grad_()
        gt = torch.from_numpy(g[rows].copy())
        fn = moe_apply_sharded_tokens
    else:
        xt = torch.from_numpy(x.copy()).requires_grad_()
        gt = torch.from_numpy(g.copy())
        fn = moe_apply
    y = fn(ts["router"], ts["w1"], ts["b1"], ts["w2"], ts["b2"], xt,
           dist.group.WORLD, capacity_factor=1.0)
    (y * gt).sum().backward()
    return {"y": y.detach().numpy(), "dx": xt.grad.numpy(),
            **{k: t.grad.numpy() for k, t in ts.items()}}


def refusal_case(spec):
    """``run(spec)`` on this rank; the (type, text) of what it raised, or
    None when it trained."""
    try:
        run(spec)
    except Exception as e:   # the refusal under test, returned
        return type(e).__name__, str(e)
    return None


# -- tensor and pipeline parallelism ------------------------------------

def jax_order(module, kind="params") -> list:
    """``module``'s parameters (or, ``kind="state"``, its buffers) in the
    JAX package's ravel order (a tree's dict keys sorted)."""
    from bigdl_tpu_torch.parallel.pipeline_model import jax_leaves
    if kind == "params":
        return jax_leaves(module)
    out = []
    for key in sorted(["~"] + list(module._modules)):
        if key == "~":
            out += [module._buffers[k] for k in sorted(module._buffers)
                    if module._buffers[k] is not None]
        else:
            out += jax_order(module._modules[key], kind)
    return out


def _flat(tensors):
    return (torch.cat([t.detach().reshape(-1) for t in tensors]).numpy()
            if tensors else np.zeros(0, np.float32))


def pipe_fn_case(stages, x, t):
    """The pipeline functions on a ``{"pipe": world}`` mesh, this rank
    stage ``tanh(x @ w + b)`` of ``stages[rank]``: GPipe's forward
    (``pipeline_apply``); GPipe with the loss ``M * sum(y**2)`` a
    microbatch (the JAX test's ``sum(outputs**2)``); 1F1B and GPipe with
    the mean squared error against ``t``.  Each run's loss, this stage's
    gradients, peak microbatches in flight and the bubble."""
    from bigdl_tpu_torch.parallel.mesh import make_mesh
    from bigdl_tpu_torch.parallel.pipeline import (pipeline_apply,
                                                   pipeline_train_1f1b)

    axis = make_mesh({"pipe": -1}, "cpu").axis("pipe")
    r, n_micro = axis.index, len(x)
    w = torch.from_numpy(np.array(stages[r]["w"])).requires_grad_()
    b = torch.from_numpy(np.array(stages[r]["b"])).requires_grad_()

    def stage(h, m):
        return torch.tanh(h @ w + b)

    xs = [torch.from_numpy(np.array(v)) for v in x]
    ts = [torch.from_numpy(np.array(v)) for v in t]
    shapes = [tuple(xs[0].shape)] * axis.size
    out = {"rank": r}
    with torch.no_grad():
        res = pipeline_apply(stage, xs, axis, shapes)
    out["forward"] = (None if res.outputs is None
                      else np.stack([o.numpy() for o in res.outputs]))

    def grads():
        g = [w.grad.numpy().copy(), b.grad.numpy().copy()]
        w.grad, b.grad = None, None
        return g

    res = pipeline_apply(stage, xs, axis, shapes,
                         loss_fn=lambda y, _: n_micro * (y ** 2).sum(),
                         t_micro=ts)
    out["sq"] = (float(res.loss), grads(), res.peak_in_flight)

    def mse(y, tt):
        return ((y - tt) ** 2).mean()

    res = pipeline_train_1f1b(stage, mse, xs, ts, axis, shapes)
    out["1f1b"] = (float(res.loss), grads(), res.peak_in_flight, res.bubble)
    res = pipeline_apply(stage, xs, axis, shapes, loss_fn=mse, t_micro=ts)
    out["gpipe"] = (float(res.loss), grads(), res.peak_in_flight, res.bubble)
    res = pipeline_apply(stage, xs, axis, shapes, loss_fn=mse, t_micro=ts,
                         remat=True)
    out["gpipe_remat"] = (float(res.loss), grads(), res.peak_in_flight)
    return out


def bn_oracle_case(init, init_state, x, y, n_micro, mb, arch, step=1):
    """The BN and dropout conv net's plan on a ``{"pipe": world}`` mesh:
    one 1F1B step of this rank's stage (the optimizer's seeded stage
    function), and the same stages run one after another on this rank
    over the whole model (the serial program: each microbatch through
    stage 0, 1, ..., the same seeds, the running statistics moved per
    microbatch); the loss, this stage's gradients and running statistics
    (JAX order) of each, and the stage ranges."""
    from bigdl_tpu_torch.parallel.mesh import make_mesh
    from bigdl_tpu_torch.parallel.pipeline import (run_schedule,
                                                   stage_function)
    from bigdl_tpu_torch.parallel.pipeline_model import partition_sequential

    axis = make_mesh({"pipe": -1}, "cpu").axis("pipe")
    crit = nn.ClassNLLCriterion()
    xs = [torch.from_numpy(np.array(x[m * mb:(m + 1) * mb]))
          for m in range(n_micro)]
    ts = [torch.from_numpy(np.array(y[m * mb:(m + 1) * mb]))
          for m in range(n_micro)]

    def fresh():
        model = build("bn_conv", arch)
        load_jax_params(model, init)
        load_jax_state(model, init_state)
        return model.train()

    model = fresh()
    plan = partition_sequential(model, axis.size, (mb,) + xs[0].shape[1:])
    s = axis.index
    mods = plan.stage_modules(s)
    res = run_schedule("1f1b", stage_function(mods, s, step, "cpu"), axis,
                       xs, [plan.boundary(i, mb) for i in
                            range(plan.n_stages)],
                       plan.dtypes, loss_fn=crit, t_micro=ts)

    def stage_of(mdl):
        ms = partition_sequential(mdl, axis.size, (mb,) + xs[0].shape[1:]) \
            .stage_modules(s)
        return (_flat([p.grad if p.grad is not None else torch.zeros_like(p)
                       for m in ms for p in jax_order(m)]),
                _flat([b for m in ms for b in jax_order(m, "state")]))

    out = {"ranges": plan.ranges, "loss": float(res.loss),
           "peak": res.peak_in_flight}
    out["grads"], out["state"] = stage_of(model)
    serial = fresh()
    serial_plan = partition_sequential(serial, axis.size,
                                       (mb,) + xs[0].shape[1:])
    fns = [stage_function(serial_plan.stage_modules(i), i, step, "cpu")
           for i in range(axis.size)]
    total = 0.0
    for m in range(n_micro):
        h = xs[m]
        for fn in fns:
            h = fn(h, m)
        total = total + crit(h, ts[m]) / n_micro
    total.backward()
    out["serial_loss"] = float(total)
    out["serial_grads"], out["serial_state"] = stage_of(serial)
    return out


# -- serving's tensor parallelism ---------------------------------------

def _tp_numpy(handles) -> dict:
    """A decoder's weight handles as ``{path: array}``: ``emb/weight``,
    ``blocks/<li>/<ln1|attn|ln2|lin1|lin2>/<key>``, ``ln_f/..``,
    ``head/..``."""
    out = {}
    for part in ("emb", "ln_f", "head"):
        for k, t in getattr(handles, part).items():
            out[f"{part}/{k}"] = t.numpy().copy()
    for li, blk in enumerate(handles.blocks):
        for name, d in zip(("ln1", "attn", "ln2", "lin1", "lin2"), blk):
            for k, t in d.items():
                out[f"blocks/{li}/{name}/{k}"] = t.numpy().copy()
    return out


def _tp_decode(model, mesh, seeds, n_words, kw, sampling, waves, alter):
    """One decoder (``mesh`` None: one device) serving ``seeds`` ``waves``
    times over, every wave from the same decoder; the rows, stats and
    the attention calls and all-reduces the steps made."""
    from bigdl_tpu_torch.models import transformer as tt
    from bigdl_tpu_torch.serve.decode import ContinuousDecoder

    calls = {"attention": 0, "all_reduce": 0}
    attend, reduce = tt.paged_attention, tt.all_reduce

    def counted_attention(*a, **k):
        calls["attention"] += 1
        return attend(*a, **k)

    def counted_reduce(*a, **k):
        calls["all_reduce"] += 1
        return reduce(*a, **k)

    tt.paged_attention, tt.all_reduce = counted_attention, counted_reduce
    try:
        dec = ContinuousDecoder(model, device="cpu", mesh=mesh, **kw)
        rows, stats = [], []
        for _ in range(waves):
            sub = [list(s) for s in seeds]
            if alter:
                sub[1] = sub[1] + [1]
            futs = [dec.submit(s, n_words, sampling=sp)
                    for s, sp in zip(sub, sampling)]
            try:
                dec.run()
            except Exception as e:   # the mismatch under test, returned
                return {"raised": (type(e).__name__, str(e)),
                        "futures": [type(f.exception(timeout=5)).__name__
                                    for f in futs]}
            rows.append([f.result(timeout=30) for f in futs])
            stats.append(dec.stats())
        out = {"rows": rows, "stats": stats, "calls": dict(calls),
               "pools": [(tuple(c.shape), str(c.dtype), c.is_contiguous())
                         for c in dec._caches]}
        if mesh is not None:
            out["handles"] = _tp_numpy(dec._handles)
        dec.close()
        return out
    finally:
        tt.paged_attention, tt.all_reduce = attend, reduce


def tp_decode_case(arch, params, dp, mp, cases):
    """Serving's tensor parallelism on this rank: the LM of ``arch`` with
    the JAX parameters ``params``, ``hybrid_mesh(dp, mp)`` under gloo and
    each case of ``cases`` (dicts of ``seeds``, ``n_words``, the decoder's
    keyword arguments ``kw`` and optionally ``sampling`` (one a seed),
    ``waves`` (the seeds served that many times from one decoder) and
    ``alter`` (a rank whose index is it submits its second request one
    token longer)) served through ``ContinuousDecoder(mesh=)`` and, but
    for ``alter``, through the one-device decoder.  Each case's results,
    or the (type, text) of what the decoder's construction raised."""
    from bigdl_tpu_torch.parallel.mesh import hybrid_mesh

    model = load_jax_params(build("lm", arch), params).evaluate()
    mesh = hybrid_mesh(dp, mp, "cpu")
    out = []
    for case in cases:
        seeds = case["seeds"]
        sampling = case.get("sampling") or [None] * len(seeds)
        waves = case.get("waves", 1)
        alter = case.get("alter")
        res = {"rank": Engine.process_index(),
               "model_index": mesh.axis("model").index}
        try:
            res["tp"] = _tp_decode(
                model, mesh, seeds, case["n_words"], case["kw"], sampling,
                waves, alter is not None
                and mesh.axis("model").index == alter)
        except ValueError as e:   # the refusal under test, returned
            res["refused"] = (type(e).__name__, str(e))
        if alter is None and "refused" not in res:
            res["one"] = _tp_decode(model, None, seeds, case["n_words"],
                                    case["kw"], sampling, waves, False)
        out.append(res)
        dist.barrier()
    return out
