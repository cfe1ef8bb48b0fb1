"""DistriOptimizer — synchronous data-parallel SGD over ``torch.distributed``
(counterpart of bigdl_tpu/optim/distri_optimizer.py; ref
optim/DistriOptimizer.scala, call stack SURVEY.md §3.1).

One process a rank and one card a process, PyTorch's idiom: each device
of the JAX package's mesh is one rank here, NCCL on the card, gloo on the
CPU (``utils/engine.py``).  The reference's pieces map so:

- a model replica a node (initThreadModels :344-410) -> the model on
  every rank, rank 0's parameters and buffers broadcast when training
  starts (``parallel/broadcast.py``);
- ``getParameters``' compaction -> the parameters and their gradients
  are views into two flat fp32 buffers (``parallel/sharding.py``'s
  ``FlatPartition``, built before the first step);
- AllReduceParameter -> one ``all_reduce`` of the flat gradient buffer,
  the step's loss riding in its last element (plain DP), or, with
  ``zero1=True``, the owner-partition update: a ``reduce_scatter`` of the
  padded flat gradient, ``fused_sgd`` on this rank's slice alone with a
  velocity of L/N elements, and an ``all_gather`` of the updated slices
  into the flat parameters (DistriOptimizer.scala:232);
- FP16CompressedTensor -> ``gradient_compression="bf16"``: the local
  gradient cast to bf16, summed over the wire in bf16 (a reduce-scatter
  and an all-gather, or with ``zero1`` the reduce-scatter alone), the
  mean taken, cast back before the f32 update;
- straggler dropping (DistriOptimizer.scala:154-172, :245-278) -> a rank
  whose time exceeded the threshold on the previous iteration is masked
  out of this one's mean, ``sum(w·g) / sum(w)`` (``optim/straggler.py``;
  every rank holds the same policy state from the gathered times).

The global batch.  With a replicated dataset (``DataSet.array(x)``)
every rank draws the same stream and each batch of B is the global batch,
rank r taking rows ``[r·B/N, (r+1)·B/N)``; with a sharded one
(``distributed=True``) each rank's batch of B is its own and the global
batch is B·N.  The plain path differentiates the global batch's loss,
as the JAX step under ``jit`` does: each rank scales its loss before the
backward by its share (1/N for a criterion that averages over samples, 1
for one that sums, this rank's part of the normaliser for the weighted
``ClassNLLCriterion``; ``global_batch_rule``), the gradient all-reduce
sums, and batch normalisation takes the global batch's statistics (each
``BatchNormalization`` gets the group: ``nn/normalization.py``).  The
compressed and masked paths (the JAX ``shard_map`` builder) take the mean
of the ranks' local losses, per-shard statistics, and average the
running statistics after the step.  With one rank the plain and
``zero1`` paths give ``LocalOptimizer``'s trajectory bit for bit.

The update is skipped on every rank when any rank saw a non-finite loss
or gradient: on the plain path the flag is read after the all-reduce, so
it agrees; elsewhere each rank's count of non-finite values is summed
with the loss.  Dropout draws from each rank's stream, the rank folded
into the seed (``RNG.fold_rank``).  ``set_iterations_per_dispatch(n)``
runs the n steps as an eager loop on every device (no CUDA graph).
Validation shares the batches out over the ranks and sums their results;
checkpoints are ``LocalOptimizer``'s files, written by rank 0 after the
``zero1`` velocity slices are gathered, while the others wait.

Sequence parallelism (``sequence_parallel=True``, a ``{"data": d,
"seq": s}`` mesh): the ranks of one data slice take the same records and
each its block of the time dimension (x's dim 1, and the targets' where
they have one per step).  The layers that mix over time learn of the
``seq`` axis from their ``seq_axis`` for the run: the attention runs the
ring, the position table adds the block's global rows, a mean over time
sums over the axis; any other module that is not known to act on each
step alone raises.  Each rank's loss is scaled by its share of the
global one (its batch share times its time share: 1/s where the loss
averages over time or sits after a mean over it), and the gradients are
summed over the whole world.

Expert parallelism (``expert_parallel=True``, ``{"data": d, "expert":
e}``): the ranks of one data slice take the same records, as the JAX
batch ``P("data")`` is replicated over the expert axis, and each runs
its E/e experts of every ``nn.MoE`` (``moe_apply``'s form).  The
expert-stacked leaves (``w1 b1 w2 b2``, not ``router``) are updated by
their owner alone, on its rows; every gradient is reduced over ``data``
only (the expert ranks of a slice hold the same tokens, so a sum over
them would count each token e times).  The rows a rank does not own are
brought up to date from their owners when a validation, a checkpoint or
the run's end reads them.

``nn.MoE`` gates the global batch on the plain path and under
``expert_parallel`` (capacity from the global token count, places
offset by the ranks before: ``MoE.gate_axis``), as the JAX step under
``jit`` does; the compressed and masked paths gate each rank's tokens,
as the JAX ``shard_map`` builder does.

Tensor parallelism (``tensor_parallel=True``, ``{"data": d, "model":
m}``, ``hybrid_mesh``): each leaf ``sharding.shard_params_rule`` shards
is held as this rank's rows of dim 0, the replicated leaves whole, all of
them in the flat buffer, which is reduced over ``data`` alone (the model
ranks of a data slice take the same records, the loss scaled by the data
share).  ``Linear`` and ungrouped ``SpatialConvolution`` compute their
output columns and gather them, ``MultiHeadSelfAttention`` computes
row-parallel (its weights are stored (in, out)); any other module
holding a sharded leaf computes with the leaf all-gathered, its gradient
back to the slice (``tp_gathered_leaves``), the JAX step's GSPMD
function.  With ``zero1`` the flat buffer is partitioned over ``data``:
reduce-scatter, ``fused_sgd`` on the slice, all-gather.  The whole
leaves come back at a checkpoint and at the run's end.

Pipeline parallelism (``pipeline_stages=P``, ``{"pipe": P}`` or
``{"data": d, "pipe": P}``): the ``Sequential`` model is cut into P
stages (``parallel/pipeline_model.py``, the JAX ranges), each rank
holding its own on its card, and each batch streams through as
``pipeline_microbatches`` microbatches (default 2·P) under
``pipeline_schedule`` ``"1f1b"`` or ``"gpipe"``
(``parallel/pipeline.py``; GPipe checkpoints each stage under
``set_gradient_checkpointing``).  A stage's parameters are one flat
buffer, updated by one ``fused_sgd`` launch a step; with a ``data`` axis
each replica takes its rows of each microbatch, the gradients are summed
over it and the running statistics averaged after the step.  Batch
normalisation takes each microbatch's own statistics; a stage's dropout
draws from the package generator seeded by (seed, data coordinate, step,
microbatch, stage), so both schedules draw the same masks.  The skip of
a non-finite step agrees over the world, validation streams through the
stages, and checkpoints hold the whole model in the JAX layout with the
velocity stage-stacked ``(P, max_p)`` as the JAX package leaves it.

Not ported yet, each refused where it is asked for: elastic recovery
(``BIGDL_ELASTIC=1``; the resilience slice, with the sharded asynchronous
checkpoints), and the background prefetch under this optimizer.
"""
from __future__ import annotations

import functools
import logging
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from bigdl_tpu_torch.dataset import prefetch
from bigdl_tpu_torch.dataset.dataset import (get_batch_size,
                                             is_distributed_dataset)
from bigdl_tpu_torch.nn import activations as A
from bigdl_tpu_torch.nn import criterion as C
from bigdl_tpu_torch.nn.attention import (MultiHeadSelfAttention,
                                          SinusoidalPositionalEncoding)
from bigdl_tpu_torch.nn.containers import ConcatTable, Sequential
from bigdl_tpu_torch.nn.conv import SpatialConvolution
from bigdl_tpu_torch.nn.dropout import Dropout
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.module import leaves_of, tree_of
from bigdl_tpu_torch.nn.moe import EXPERT_STACKED, MoE
from bigdl_tpu_torch.nn.normalization import BatchNormalization, LayerNorm
from bigdl_tpu_torch.nn.recurrent import TimeDistributed
from bigdl_tpu_torch.nn.reductions import Mean
from bigdl_tpu_torch.nn.shape_ops import Identity
from bigdl_tpu_torch.nn.table_ops import (CAddTable, CDivTable, CMaxTable,
                                          CMinTable, CMulTable, CSubTable)
from bigdl_tpu_torch.obs import taps as obs_taps
from bigdl_tpu_torch.optim.local_optimizer import (LocalOptimizer,
                                                   _BufferSnapshot,
                                                   export_scalar,
                                                   resume_scalar, to_device,
                                                   validate)
from bigdl_tpu_torch.optim.straggler import StragglerPolicy
from bigdl_tpu_torch.parallel import collectives as coll
from bigdl_tpu_torch.parallel import pipeline as pipe_mod
from bigdl_tpu_torch.parallel.broadcast import model_broadcast
from bigdl_tpu_torch.parallel.mesh import data_parallel_mesh, make_mesh
from bigdl_tpu_torch.parallel.pipeline_model import partition_sequential
from bigdl_tpu_torch.parallel.sharding import (FlatPartition, leaf_align,
                                               model_slice,
                                               shard_params_rule)
from bigdl_tpu_torch.utils.engine import Engine, backend_for
from bigdl_tpu_torch.utils.random import RNG

logger = logging.getLogger("bigdl_tpu_torch.optim")


_STRAGGLER_MODES = (
    "straggler drop masks per-DATA-replica gradients; it "
    "composes with DP, zero1 and gradient_compression only "
    "(the reference's tasks are data-parallel model clones)")


def global_batch_rule(criterion) -> str:
    """How the ranks' losses make the global batch's loss: ``"mean"``
    (the criterion averages over samples or elements, which the equal
    shards split evenly), ``"sum"``, or ``"weighted"`` (a weighted
    ``ClassNLLCriterion`` / ``CrossEntropyCriterion`` averaging: the
    global loss is the sum of the numerators over the sum of the weights
    of the targets), or ``"kept"`` (a ``SoftmaxWithCriterion`` with an
    ignore label, normalised by the positions kept: the global loss is
    the sum of the numerators over the positions kept in the whole batch,
    at least 1).  A criterion whose normaliser depends on the whole batch
    in another way raises."""
    if isinstance(criterion, C.CrossEntropyCriterion):
        return global_batch_rule(criterion.nll)
    if isinstance(criterion, C.ClassNLLCriterion):
        if criterion.weights is not None and criterion.size_average:
            return "weighted"
        return "mean" if criterion.size_average else "sum"
    if isinstance(criterion, C.SoftmaxWithCriterion):
        if criterion.normalize_mode == "valid" and \
                criterion.ignore_label is not None:
            return "kept"
        return ("mean" if criterion.normalize_mode in
                ("valid", "batch_size", "full") else "sum")
    if isinstance(criterion, C.SmoothL1CriterionWithWeights):
        return "sum" if criterion.num > 0 else "mean"
    if isinstance(criterion, C.L1Cost):
        return "sum"
    if isinstance(criterion, C.TimeDistributedCriterion):
        return global_batch_rule(criterion.critrn)
    if isinstance(criterion, (C.MultiCriterion, C.ParallelCriterion)):
        rules = {global_batch_rule(c) for c in criterion.criterions}
        if len(rules) != 1 or rules & {"weighted", "kept"}:
            raise NotImplementedError(
                f"{type(criterion).__name__} of criteria whose global "
                f"batches combine differently ({sorted(rules)})")
        return rules.pop()
    if not isinstance(criterion, C.Criterion):
        raise NotImplementedError(
            f"{type(criterion).__name__} is not a Criterion: its "
            f"global-batch rule is unknown")
    return "mean" if criterion.size_average else "sum"


def _local_normaliser(criterion, y):
    """(this rank's divisor of its loss, what sums over the ranks to the
    global divisor) for the ``"weighted"`` and ``"kept"`` rules."""
    if isinstance(criterion, C.SoftmaxWithCriterion):
        kept = (y != criterion.ignore_label).sum().float()
        return torch.clamp_min(kept, 1.0), kept
    weights = (criterion.nll.weights
               if isinstance(criterion, C.CrossEntropyCriterion)
               else criterion.weights).to(y.device)
    den = weights[y.reshape(-1).long() - 1].sum()
    return den, den


#: modules that act on each time step alone: under ``sequence_parallel``
#: they compute on a rank's block of the time dimension as on the whole
#: sequence (element-wise activations, the last dimension's Linear and
#: LayerNorm, containers and element-wise table ops)
TIME_LOCAL = (Sequential, ConcatTable, Identity, Dropout, Linear, LayerNorm,
              TimeDistributed, CAddTable, CSubTable, CMulTable, CDivTable,
              CMaxTable, CMinTable) + tuple(
    c for c in vars(A).values()
    if isinstance(c, type) and issubclass(c, torch.nn.Module)
    and c.__module__ == A.__name__ and c is not A.PReLU)
#: modules with a sequence-parallel form (``seq_axis``)
SEQ_AWARE = (MultiHeadSelfAttention, SinusoidalPositionalEncoding, Mean)


class DistriOptimizer(LocalOptimizer):
    """Trains ``model`` on every rank of ``mesh`` (by default all ranks
    of the default group, formed from torchrun's variables or as a world
    of one when there is none) on this rank's device: ``cuda:{LOCAL_RANK}``
    unless the caller asks for the CPU."""

    def __init__(self, model, dataset, criterion, mesh=None,
                 drop_percentage: float = 0.0, tensor_parallel: bool = False,
                 zero1: bool = False, gradient_compression: str = None,
                 pipeline_stages: int = None,
                 pipeline_schedule: str = "1f1b",
                 pipeline_microbatches: int = None,
                 expert_parallel: bool = False,
                 sequence_parallel: bool = False, device="cuda"):
        if gradient_compression not in (None, "bf16"):
            raise ValueError("gradient_compression must be None or 'bf16'")
        # the JAX constructor's validations, word for word (bigdl_tpu/optim/
        # distri_optimizer.py:115-197)
        if pipeline_stages is not None:
            if tensor_parallel or zero1 or gradient_compression \
                    or expert_parallel or sequence_parallel:
                raise ValueError(
                    "pipeline_stages owns the mesh; it does not combine "
                    "with tensor_parallel/zero1/gradient_compression/"
                    "expert_parallel/sequence_parallel")
            if pipeline_schedule not in ("1f1b", "gpipe"):
                raise ValueError("pipeline_schedule must be '1f1b' or "
                                 "'gpipe'")
            # every rank is a process of its own, as the JAX multi-host case
            if dataset is not None and is_distributed_dataset(dataset):
                raise ValueError(
                    "multi-host pipeline_stages needs a replicated "
                    "(non-distributed) dataset: every process feeds "
                    "the identical global batch")
        elif expert_parallel:
            if tensor_parallel or zero1 or gradient_compression \
                    or sequence_parallel:
                raise ValueError(
                    "expert_parallel composes with data parallelism only "
                    "(mesh {'data': d, 'expert': e}); tensor_parallel/"
                    "zero1/gradient_compression/sequence_parallel assume "
                    "replicated or data-sharded params, not expert-"
                    "sharded ones")
            if mesh is None or "expert" not in mesh.axis_names:
                raise ValueError(
                    "expert_parallel needs a mesh with an 'expert' axis")
        elif sequence_parallel:
            if tensor_parallel or zero1 or gradient_compression:
                raise ValueError(
                    "sequence_parallel composes with data parallelism "
                    "only (mesh {'data': d, 'seq': s})")
            if mesh is None or "seq" not in mesh.axis_names \
                    or "data" not in mesh.axis_names:
                raise ValueError(
                    "sequence_parallel needs a mesh with 'data' and "
                    "'seq' axes (pure SP: use {'data': 1, 'seq': s})")
        elif gradient_compression and tensor_parallel:
            raise ValueError(
                "gradient_compression composes with DP and zero1, not "
                "tensor_parallel: TP grads are per-leaf sharded over the "
                "model axis, so there is no single flat gradient wire to "
                "compress (the reference has no TP at all)")
        if mesh is not None and pipeline_stages is None:
            extra = set(mesh.axis_names) - {"data"}
            wants = {"seq": sequence_parallel, "expert": expert_parallel,
                     "model": tensor_parallel}
            if any(not wants.get(a, False) for a in extra):
                raise ValueError(
                    f"a mesh with axes {mesh.axis_names} needs "
                    f"sequence_parallel=True (a 'seq' axis), "
                    f"expert_parallel=True (an 'expert' axis), "
                    f"tensor_parallel=True (a 'model' axis) or "
                    f"pipeline_stages=P (a 'pipe' axis)")
        if drop_percentage and (pipeline_stages is not None or tensor_parallel
                                or expert_parallel or sequence_parallel):
            raise ValueError(_STRAGGLER_MODES)
        if os.environ.get("BIGDL_ELASTIC") == "1":
            raise NotImplementedError(
                "BIGDL_ELASTIC=1: elastic recovery (re-forming the world "
                "after a rank is lost) comes with the resilience slice of "
                "the port (ROADMAP queue 1, item 5)")
        super().__init__(model, dataset, criterion, device=device)
        if pipeline_stages is not None:
            mesh = self._pipe_mesh(mesh, int(pipeline_stages))
        self.mesh = (mesh if mesh is not None
                     else data_parallel_mesh(self.device))
        have = dist.get_backend(self.mesh.group)
        if have != backend_for(self.device):
            raise ValueError(f"the mesh's group runs {have!r}, device "
                             f"{self.device} needs "
                             f"{backend_for(self.device)!r}")
        self.device = Engine.device(self.device)
        self.zero1 = bool(zero1)
        self.gradient_compression = gradient_compression
        self.expert_parallel = bool(expert_parallel)
        self.sequence_parallel = bool(sequence_parallel)
        self.tensor_parallel = bool(tensor_parallel)
        self.pipeline_stages = pipeline_stages
        self.pipeline_schedule = pipeline_schedule
        self.pipeline_microbatches = pipeline_microbatches
        # n steps a dispatch: the eager loop (no graph of collectives)
        self._cuda_graph = False
        self._straggler = None
        if drop_percentage:
            # drop and cap at the same fraction (the reference arms both
            # through setDropMoudleProperty, Optimizer.scala:116-124)
            self.set_drop_module_property(drop_percentage, drop_percentage)
        #: the flat layout and buffers, built at the first ``optimize``
        self._part = None
        self._flat_key = None
        #: each parameter's rows this rank owns under ``expert_parallel``
        #: (None: the whole leaf), and the views the update runs on
        self._own_rows = []
        self._upd_params = self._upd_grads = None
        #: the model axis of tensor parallelism (None: none, or one rank)
        #: and whether each parameter is held as its rows
        self._tp = None
        self._tp_sharded = []
        #: leaves that ran gathered under tensor parallelism, by module
        #: class: {name: count}
        self.tp_gathered_leaves = {}
        #: the pipeline's plan, its stage and flat buffers (built at the
        #: first step), whether the other stages are off the card, and
        #: the last step's schedule
        self._pipe, self._pipe_offloaded = None, False
        #: the taps' gradient sums come from each rank's local gradient
        #: (the compressed or masked ``zero1`` step; set a run)
        self._local_taps = False
        self.pipe_result = None
        for name in ("computing time average", "aggregate gradient time"):
            self.metrics.declare(name)

    def _pipe_mesh(self, mesh, stages):
        """The JAX constructor's pipeline mesh checks; with no mesh, the
        pure pipe axis over the world, which must hold ``stages`` ranks
        (the JAX default takes the first P devices: here each is a
        process, so the world must be exactly P, as the JAX multi-host
        rule has it)."""
        if mesh is None:
            n = dist.get_world_size(Engine.ensure_group(self.device))
            if n < stages:
                raise ValueError(
                    f"pipeline_stages={stages} needs that "
                    f"many devices, have {n}")
            if n != stages:
                raise ValueError(
                    f"multi-host pipeline with {n} global "
                    f"devices and pipeline_stages={stages}: "
                    "pass an explicit mesh (e.g. make_mesh({'data': "
                    f"{n // stages}, 'pipe': "
                    f"{stages}}})) so every process holds "
                    "mesh devices")
            mesh = make_mesh({"pipe": stages}, self.device)
        if "pipe" not in mesh.axis_names or \
                mesh.shape["pipe"] != stages:
            raise ValueError(
                f"mesh needs a 'pipe' axis of size {stages}, "
                f"got {dict(mesh.shape)}")
        if set(mesh.axis_names) - {"pipe", "data"}:
            raise ValueError(
                "pipeline meshes support 'pipe' plus an optional "
                f"'data' axis (hybrid dp x pp), got {mesh.axis_names}")
        return mesh

    def set_drop_module_property(self, drop_percentage: float,
                                 max_drop_percentage: float,
                                 batch_size: int = 100,
                                 warmup_iteration: int = 200,
                                 time_source=None):
        """Arm straggler dropping (ref Optimizer.setDropMoudleProperty,
        Optimizer.scala:116-124): each rank is one task; ranks whose time
        exceeded the threshold on the previous iteration are masked out
        of this one's mean.  ``time_source(local_wall) -> (n_tasks,)
        seconds`` replaces the measured times (tests inject schedules);
        every rank's view is gathered and the slowest reading kept."""
        if not drop_percentage:
            self._straggler = None
            return self
        if (self.pipeline_stages is not None or self.expert_parallel
                or self.sequence_parallel or self.tensor_parallel):
            raise ValueError(_STRAGGLER_MODES)
        self._straggler = StragglerPolicy(
            n_tasks=self.mesh.size, drop_percentage=drop_percentage,
            max_drop_percentage=max_drop_percentage,
            compute_threshold_batch_size=batch_size,
            warmup_iteration=warmup_iteration, time_source=time_source)
        return self

    @property
    def _shard_local(self) -> bool:
        """The JAX ``shard_map`` builder's semantics: local losses and
        per-shard statistics (compression or straggler masks)."""
        return bool(self.gradient_compression) or \
            self._straggler is not None

    # -- the run ------------------------------------------------------------
    def optimize(self):
        if prefetch.enabled():
            raise NotImplementedError(
                "the background prefetch (BIGDL_PREFETCH) is not ported for "
                "the DistriOptimizer yet")
        if self._straggler is not None and self.iters_per_dispatch > 1:
            raise ValueError(
                "straggler drop recomputes the mask every iteration (ref "
                "DistriOptimizer.scala:154: the timeout applies per "
                "invokeAndWait2 round); it does not combine with "
                "set_iterations_per_dispatch > 1")
        if self.zero1 and self.state.get("learningRates") is not None:
            raise ValueError(
                "state['learningRates'] (per-param lr scales) is not "
                "supported with zero1: the owner-partition update runs on "
                "a flat slice, not the param tree")
        if self.pipeline_stages is not None and \
                self.state.get("learningRates") is not None:
            raise ValueError("state['learningRates'] (per-param lr scales) "
                             "is not supported with pipeline_stages")
        self._rank, self._world = self.mesh.rank(), self.mesh.size
        data = (self.mesh.axis("data") if "data" in self.mesh.axis_names
                else None)
        self._n_data = data.size if data is not None else 1
        if self.pipeline_stages is not None:
            return self._optimize_pipeline(data)
        model_axis = (self.mesh.axis("model") if "model" in
                      self.mesh.axis_names else None)
        self._tp = (model_axis if model_axis is not None
                    and model_axis.size > 1 else None)
        # the ranks of one data slice hold the same tokens under expert
        # and tensor parallelism: the gradients are reduced over the data
        # axis alone (a sum over the others would count each token again),
        # else over every rank; zero1's partition likewise
        by_data = self.expert_parallel or model_axis is not None
        self._grad_group = data if by_data else self.mesh
        self._zidx, self._zsize, self._zgroup = (
            (data.index, data.size, data) if model_axis is not None
            else (self._rank, self._world, self.mesh))
        self._sharded = is_distributed_dataset(self.dataset)
        if self._sharded and data.size != self._world:
            # the ranks of one data slice take the same records
            root = self.dataset
            while not hasattr(root, "shard_by"):
                root = root.base
            if (root.n_shards, root.shard_index) != (data.size, data.index):
                root.shard_by(data.size, data.index)
        self._rule = (None if self._shard_local
                      else global_batch_rule(self.criterion))
        if self.sequence_parallel and self._rule not in ("mean", "sum"):
            raise NotImplementedError(
                f"sequence_parallel with a criterion whose global batch "
                f"rule is {self._rule!r}: its normaliser over the blocks "
                f"of the time dimension is not ported")
        self._w, self._msum, self._mask = 1.0, float(self._n_data), None
        # dropout: distinct masks on ranks holding distinct tokens; the
        # expert and model ranks of a data slice compute one replica, so
        # one mask
        RNG.fold_rank(data.index if by_data else self._rank)
        self.model.to(self.device).train()
        model_broadcast(self.model, self.mesh)
        self._flatten()
        sync = (None if self._shard_local or self._n_data == 1
                else self._grad_group.group)
        bns = [m for m in self.model.modules()
               if isinstance(m, BatchNormalization)]
        for m in bns:
            m.process_group = sync
        try:
            self._bind(True)
            self._bind_tp(True)
            model = super().optimize()
        finally:
            self._bind(False)
            self._bind_tp(False)
            for m in bns:
                m.process_group = None
        self._sync_experts()
        self._whole_leaves()
        self.metrics.collect_per_node(self.mesh)
        return model

    def _bind(self, on: bool):
        """Tell the layers of the model where the rest of their batch,
        sequence and experts are for the run (``on``), or that they hold
        it all (off: validation, and after the run)."""
        seq = self.mesh.axis("seq") if self.sequence_parallel else None
        experts = (self.mesh.axis("expert") if self.expert_parallel
                   else None)
        gate = (None if self._shard_local or self._n_data == 1
                else self.mesh.axis("data"))
        self._means = []

        def walk(mod):
            if isinstance(mod, MoE):
                if seq is not None and on:
                    raise NotImplementedError(
                        "MoE under sequence_parallel: the global batch's "
                        "gating over blocks of the time dimension is not "
                        "ported")
                mod.gate_axis = gate if on else None
                mod.expert_axis = experts if on else None
            elif isinstance(mod, SEQ_AWARE):
                mod.seq_axis = seq if on else None
                if isinstance(mod, Mean):
                    mod.reduced_time = False
                    self._means.append(mod)
            elif seq is not None and on and not isinstance(mod, TIME_LOCAL):
                raise NotImplementedError(
                    f"{type(mod).__name__} under sequence_parallel: each "
                    f"rank holds a block of the time dimension, and "
                    f"{type(mod).__name__} is not known to act on each time "
                    f"step alone (it would compute on the block as if it "
                    f"were the whole sequence)")
            if isinstance(mod, TimeDistributed):
                return   # its module sees one step at a time
            for ch in mod.children():
                walk(ch)

        walk(self.model)

    def _sync_experts(self):
        """Every rank's rows of every expert-stacked leaf from their owner
        (the rows a rank does not own are stale while it trains)."""
        if not self.expert_parallel or self.mesh.axis("expert").size == 1:
            return
        axis = self.mesh.axis("expert")
        with torch.no_grad():
            for p, own in zip(self.model.parameters(), self._own_rows):
                if own is not None:
                    coll.all_gather(p[own].reshape(-1), axis,
                                    out=p.view(-1))

    # -- pipeline parallelism -----------------------------------------------
    def _optimize_pipeline(self, data):
        """The run under ``pipeline_stages``: every rank starts from rank
        0's model, trains its stage, and ends with the whole trained model
        (each stage from its owner)."""
        self._data = data
        self._w, self._msum, self._mask = 1.0, 1.0, None
        # the replicas of a stage draw their own masks; the stages of a
        # replica theirs (the stage is one of the derived seed's keys)
        RNG.fold_rank(data.index if data is not None else 0)
        self.model.to(self.device).train()
        model_broadcast(self.model, self.mesh)
        self._pipe_tick, self._pipe_offloaded = (None, 0), False
        model = LocalOptimizer.optimize(self)
        self._pipe_gather(move=True)
        self.metrics.collect_per_node(self.mesh)
        return model

    def _pipe_ready(self, x, opt_state):
        """The plan, this rank's stage and its flat buffers for batches of
        ``x``'s shape (built once: again only when the shape changes or
        the stage's parameters moved), the other stages' modules off the
        card (once a run, or after a new plan), and the optimizer's state
        of this run."""
        P, pipe = self.pipeline_stages, self.mesh.axis("pipe")
        B = x.shape[0]
        M = self.pipeline_microbatches or 2 * P
        if B % M:
            raise ValueError(
                f"batch size {B} is not divisible by "
                f"pipeline_microbatches={M}")
        d = self._n_data
        if d > 1 and (B // M) % d:
            raise ValueError(
                f"microbatch size {B // M} is not divisible by the data "
                f"axis ({d}) — hybrid dp x pp "
                "shards each microbatch across the data replicas")
        key = (tuple(x.shape), x.dtype, M)
        st = self._pipe
        if st is None or st.key != key or not st.holds():
            plan = partition_sequential(self.model, P, (B // M,) +
                                        tuple(x.shape[1:]), dtype=x.dtype)
            logger.info("pipeline partition (schedule=%s, %d "
                        "microbatches):\n%s", self.pipeline_schedule, M,
                        plan.describe())
            st = self._pipe = _Stage(plan, pipe.index, key, M, d,
                                     self.device)
            self._pipe_offloaded = False
        if self.device.type == "cuda" and not self._pipe_offloaded:
            for i in range(P):
                if i != st.index:
                    for m in st.plan.stage_modules(i):
                        m.to("cpu")
        self._pipe_offloaded = True
        if not opt_state:
            opt_state.update(self.optim_method.init_state([st.pflat]))
            if self._resume_opt_state is not None:
                self._pipe_resume(opt_state)
        return st

    def _train_step(self, params, opt_state, x, y, hyper, taps=None):
        if self.pipeline_stages is None:
            return super()._train_step(params, opt_state, x, y, hyper,
                                       taps=taps)
        st = self._pipe_ready(x, opt_state)
        taps = obs_taps.new_sums(x.device) if self._taps_on else None
        pipe, data = self.mesh.axis("pipe"), self._data
        st.gflat.zero_()
        st.kept.save()
        # the step's index for the dropout seeds: neval, counted on
        # within a dispatch of n steps
        neval = int(self.state["neval"])
        last, k = self._pipe_tick
        k = k + 1 if last == neval else 0
        self._pipe_tick = (neval, k)
        stage_fn = pipe_mod.stage_function(st.mods, st.index, neval + k,
                                           self.device)
        rows = st.mb // st.d
        at = data.index * rows if data is not None else 0
        xs = [x[m * st.mb + at:m * st.mb + at + rows] for m in range(st.M)]
        ts = [y[m * st.mb + at:m * st.mb + at + rows] for m in range(st.M)]
        res = pipe_mod.run_schedule(
            self.pipeline_schedule, stage_fn, pipe, xs, st.shapes(rows),
            st.plan.dtypes, loss_fn=self.criterion, t_micro=ts,
            data_size=st.d,
            remat=self.remat and self.pipeline_schedule == "gpipe",
            state_buffers=st.buffers, device=self.device, reduce_loss=False)
        self.pipe_result = res
        with self.metrics.timer("aggregate gradient time", distributed=True):
            if data is not None and data.size > 1:
                coll.all_reduce(st.gflat, data)
            # the loss (the last stages' parts) and the skip, over the world
            meta = torch.stack([res.loss,
                                (~torch.isfinite(st.gflat)).sum().float()])
            coll.all_reduce(meta, self.mesh)
        loss = meta[0]
        finite = (meta[1] == 0) & torch.isfinite(loss)
        self.optim_method.update([st.gflat], opt_state, [st.pflat], hyper,
                                 finite=finite, taps=taps)
        pipe_mod.merge_state_over(st.buffers, data)
        st.kept.restore_unless(finite)
        return loss, finite, taps

    def _pipe_resume(self, opt_state):
        """This stage's row of a stage-stacked ``(P, max_p)`` optimizer
        state (the JAX layout) into its flat buffer; a scalar (Adagrad's
        step, the same on every stage) as it is."""
        st = self._pipe
        for key, stacked in self._resume_opt_state.items():
            if resume_scalar(opt_state[key], stacked):
                continue
            arr = np.asarray(stacked, np.float32)
            if arr.shape != (st.plan.n_stages, st.plan.max_p):
                raise ValueError(
                    f"a pipeline resumes from stage-stacked optimizer "
                    f"state ({st.plan.n_stages}, {st.plan.max_p}), got "
                    f"{key} {arr.shape}")
            row = torch.from_numpy(arr[st.index].copy())
            with torch.no_grad():
                for v, (lo, hi) in zip(st.jax_views(opt_state[key][0]),
                                       st.jax_spans()):
                    v.copy_(row[lo:hi].view(v.shape))

    def _pipe_export(self, opt_state):
        """The optimizer state stage-stacked ``(P, max_p)``: each stage's
        leaves in the JAX ravel order, padded with zeros (a collective
        over the pipe axis)."""
        st = self._pipe
        if st is None or not opt_state:
            return {}
        out = {}
        for key, leaves in opt_state.items():
            if isinstance(leaves, torch.Tensor):
                out[key] = export_scalar(leaves)
                continue
            (flat,) = leaves
            row = torch.zeros(st.plan.max_p, device=self.device)
            for v, (lo, hi) in zip(st.jax_views(flat), st.jax_spans()):
                row[lo:hi] = v.reshape(-1)
            every = coll.all_gather(row, self.mesh.axis("pipe"))
            out[key] = every.view(st.plan.n_stages, -1).cpu().numpy()
        return out

    def _pipe_gather(self, move: bool):
        """Every stage's parameters and buffers from its owner on every
        rank of its pipe line (the stages' modules back on the card first
        with ``move``)."""
        st = self._pipe
        if st is None:
            return
        pipe = self.mesh.axis("pipe")
        for i in range(st.plan.n_stages):
            mods = st.plan.stage_modules(i)
            if move and i != st.index:
                for m in mods:
                    m.to(self.device)
            tensors = ([p.data for m in mods for p in m.parameters()]
                       + [b for m in mods for b in m.buffers()])
            _broadcast_into(tensors, pipe.ranks[i], pipe, self.device)

    def _pipe_validation(self):
        """Each data replica takes every d-th batch whole and streams it
        through the stages; the last stages' results are summed in rank
        order on every rank."""
        st, pipe, data = self._pipe, self.mesh.axis("pipe"), self._data
        methods = self.validation_methods
        totals = [None] * len(methods)
        last = pipe.index == pipe.size - 1
        k, d = (data.index, data.size) if data is not None else (0, 1)
        run = pipe_mod.stage_function(st.mods, st.index,
                                      int(self.state["neval"]), self.device)
        for m in st.mods:
            m.eval()
        try:
            with torch.no_grad():
                for i, batch in enumerate(
                        self.validation_dataset.data(train=False)):
                    if i % d != k:
                        continue
                    rows = int(np.asarray(batch.labels).shape[0])
                    x = (to_device(batch.data, self.device)
                         if st.index == 0 else None)
                    res = pipe_mod.run_schedule(
                        "gpipe", run, pipe, [x], st.shapes(rows),
                        st.plan.dtypes, device=self.device)
                    if last:
                        for j, method in enumerate(methods):
                            r = method(res.outputs[0], batch.labels)
                            totals[j] = r if totals[j] is None \
                                else totals[j] + r
        finally:
            for m in st.mods:
                m.train()
        return _merged_results(list(zip(methods, totals)), last, self.mesh)

    # -- tensor parallelism -------------------------------------------------
    def _bind_tp(self, on: bool):
        """Under tensor parallelism, set ``model_axis`` on each layer with
        a tensor-parallel form whose weight this rank holds as its rows,
        and make the model's forward gather every other sharded leaf
        first (``on``); or clear both."""
        tp = self._tp
        if tp is None:
            return
        held = {id(p) for p, sh in zip(self.model.parameters(),
                                       self._tp_sharded) if sh}
        gathered, counts = [], {}
        for mod in self.model.modules():
            form = _tp_form(mod)
            if form is not None and id(getattr(mod, form)) in held:
                mod.model_axis = tp if on else None
                continue
            for name, p in mod._parameters.items():
                if p is not None and id(p) in held:
                    gathered.append((mod, name, p))
                    kind = type(mod).__name__
                    counts[kind] = counts.get(kind, 0) + 1
        if not on:
            self.model.__dict__.pop("forward", None)
            return
        self.tp_gathered_leaves = counts
        if gathered:
            model = self.model
            model.forward = functools.partial(_gathered_forward, model,
                                              gathered, tp)

    def _local_leaf(self, i, leaf):
        """Parameter ``i``'s part of a whole ``leaf``: its rows where this
        rank holds them (tensor parallelism), else all of it."""
        if not self._tp_sharded or not self._tp_sharded[i]:
            return leaf
        tp = self._tp
        return leaf[model_slice(leaf.shape[0], tp.index, tp.size)]

    def _whole_leaf(self, i, t):
        """The whole leaf of parameter ``i`` from this rank's part ``t``
        (an all-gather over the model axis where it holds rows)."""
        if not self._tp_sharded or not self._tp_sharded[i]:
            return t
        return coll.all_gather(t.reshape(-1).contiguous(), self._tp).view(
            (-1,) + tuple(t.shape[1:]))

    def _whole_leaves(self, keep=False):
        """Under tensor parallelism, every parameter held as rows becomes
        its whole leaf again (a collective); with ``keep`` the rows are
        returned, {index: rows}, for :meth:`_restore_rows`, and the
        gradients stay."""
        if self._tp is None:
            return {}
        kept = {}
        with torch.no_grad():
            for i, p in enumerate(self.model.parameters()):
                if self._tp_sharded[i] and p.grad is not None and \
                        tuple(p.shape) == tuple(p.grad.shape):
                    kept[i] = p.data
                    p.data = self._whole_leaf(i, p.data)
                    if not keep:
                        p.grad = None
        return kept

    def _restore_rows(self, kept):
        for i, p in enumerate(self.model.parameters()):
            if i in kept:
                p.data = kept[i]

    def expert_param_specs(self) -> dict:
        """The params' tree with ``"expert"`` at each leaf the expert axis
        splits (an ``nn.MoE``'s expert-stacked leaves) and None at every
        other (the JAX ``_expert_param_specs``)."""
        def walk(mod):
            tree = {"~": {k: ("expert" if isinstance(mod, MoE)
                              and k in EXPERT_STACKED else None)
                          for k in mod._parameters}}
            for name, ch in mod._modules.items():
                tree[name] = walk(ch)
            return tree
        return walk(self.model)

    def _flatten(self):
        """Make every parameter a view into one flat fp32 buffer and its
        gradient a view into another (one more element: the loss slot),
        the ``FlatPartition`` over zero1's ranks; kept while the
        parameters stay where they are.  Under tensor parallelism a leaf
        ``shard_params_rule`` shards is held as this rank's rows."""
        params = list(self.model.parameters())
        key = (self._world, tuple(p.data_ptr() for p in params),
               tuple(-1 if p.grad is None else p.grad.data_ptr()
                     for p in params))
        if key == self._flat_key:
            return
        for p in params:
            if p.dtype != torch.float32:
                raise TypeError(f"DistriOptimizer: float32 parameters only, "
                                f"got {p.dtype}")
        tp = self._tp
        rule = shard_params_rule({"model": tp.size if tp else 1})
        self._tp_sharded = [bool(rule(p)) for p in params]
        local = [self._local_leaf(i, p.detach())
                 for i, p in enumerate(params)]
        part = FlatPartition([t.shape for t in local], self._zsize,
                             leaf_align(self.device))
        dev = self.device
        pflat = torch.zeros(part.length, device=dev)
        gbuf = torch.zeros(part.length + 1, device=dev)
        with torch.no_grad():
            for p, t, v, g in zip(params, local, part.views(pflat),
                                  part.views(gbuf)):
                v.copy_(t)
                p.data = v
                p.grad = g
        self._part, self._pflat, self._gbuf = part, pflat, gbuf
        own = part.owned(self._zidx)
        self._psl = pflat[own]
        self._gsl = torch.empty(part.slice_len, device=dev)
        if self.gradient_compression:
            self._wire = torch.empty(part.length, dtype=torch.bfloat16,
                                     device=dev)
            self._wsl = torch.empty(part.slice_len, dtype=torch.bfloat16,
                                    device=dev)
        self._grads_held = False
        self._flat_key = (self._world, tuple(p.data_ptr() for p in params),
                          tuple(p.grad.data_ptr() for p in params))
        # the owner update: an expert-stacked leaf's owned rows alone
        rows = {}
        if self.expert_parallel:
            axis = self.mesh.axis("expert")
            for m in self.model.modules():
                if isinstance(m, MoE):
                    rows |= {id(getattr(m, k)): m.owned(axis)
                             for k in EXPERT_STACKED}
        self._own_rows = [rows.get(id(p)) for p in params]
        self._upd_params = [p if r is None else p.data[r]
                            for p, r in zip(params, self._own_rows)]
        self._upd_grads = [p.grad if r is None else p.grad[r]
                           for p, r in zip(params, self._own_rows)]

    # -- the loop's hooks -------------------------------------------------
    def _local_batch(self, xh, yh, chunked: bool):
        """This rank's rows of the host batch: its data slice's share
        (the whole batch of a sharded dataset), and under
        ``sequence_parallel`` its block of the time dimension, of the
        targets too where they hold one per step.  A pipeline's ranks
        take the whole batch: each cuts its microbatches' rows itself."""
        if self.pipeline_stages is not None:
            return xh, yh
        if not self._sharded:
            data = self.mesh.axis("data")
            rows = len(yh[0]) if chunked else len(yh)
            b = get_batch_size(rows, data.size)
            own = slice(data.index * b, (data.index + 1) * b)
            xh, yh = (xh[:, own], yh[:, own]) if chunked else (xh[own],
                                                               yh[own])
        if not self.sequence_parallel:
            return xh, yh
        seq = self.mesh.axis("seq")
        t_dim = 2 if chunked else 1
        xa = np.asarray(xh)
        if xa.ndim <= t_dim or xa.shape[t_dim] % seq.size:
            raise ValueError(
                f"sequence_parallel needs input dim {t_dim} (time) "
                f"divisible by the seq axis ({seq.size}); got shape "
                f"{xa.shape}")
        t = xa.shape[t_dim] // seq.size
        block = (slice(None),) * t_dim + (slice(seq.index * t,
                                                (seq.index + 1) * t),)
        ya = np.asarray(yh)
        if ya.ndim > t_dim and ya.shape[t_dim] == xa.shape[t_dim]:
            yh = ya[block]
        return xa[block], yh

    def _admit(self) -> bool:
        pol = self._straggler
        if pol is None:
            return True
        mask = pol.mask()
        if not pol.accepts(mask):
            # rejected: batch consumed, no update, no neval advance (ref
            # DistriOptimizer.scala:224 guard)
            pol.reject(mask)
            return False
        self._mask = mask
        self._w, self._msum = float(mask[self._rank]), float(mask.sum())
        return True

    def _after_step(self, fetch_time: float, train_start: float):
        pol = self._straggler
        if pol is not None:
            if self.device.type == "cuda":
                # the task's clock must see the step's device time
                torch.cuda.synchronize(self.device)
            pol.record(self._task_times(
                fetch_time, time.perf_counter() - train_start), self._mask)
            dropped = int(len(self._mask) - self._mask.sum())
            if dropped:
                logger.debug("Dropped modules: %d", dropped)
        self.metrics.add("computing time average",
                         time.perf_counter() - train_start, distributed=True)

    def _task_times(self, fetch_wall: float, step_wall: float):
        """Each task's (rank's) seconds this iteration, the same on every
        rank.  With a ``time_source`` every rank's view is gathered and
        the slowest reading of each task kept; else each rank's fetch
        wall: the collective ends every rank's step at one instant, so a
        rank whose host fell behind shows it in its fetch (the JAX
        multi-process rule)."""
        pol = self._straggler
        mine = (pol.task_times(fetch_wall + step_wall)
                if pol.time_source is not None
                else np.asarray([fetch_wall], np.float64))
        part = torch.as_tensor(mine, dtype=torch.float64, device=self.device)
        every = coll.all_gather(part, self.mesh).cpu().numpy()
        if pol.time_source is not None:
            return every.reshape(self._world, -1).max(axis=0)
        return every

    def _records(self, rows: int) -> int:
        # rows is this rank's share, the same on every rank of a data
        # slice; only the tasks that finished count (ref recordsNum +=
        # finishedThreads.size * stackSize, :236); a pipeline's ranks
        # hold the whole batch
        if self.pipeline_stages is not None:
            return int(rows)
        return int(rows * self._msum)

    def _sync_cadence(self) -> int:
        # straggler drop re-times and accepts or rejects every iteration
        return 1 if self._straggler is not None else super()._sync_cadence()

    # -- the step's hooks ---------------------------------------------------
    def _zero_grads(self, params):
        self._gbuf.zero_()

    def _backward(self, loss, y):
        s = self._w if self._shard_local else self._rule_scale(y)
        self._scale = s
        (loss if _is_one(s) else loss * s).backward()

    def _rule_scale(self, y):
        """This rank's share of the global loss (``global_batch_rule``):
        its batch share, times its time share under
        ``sequence_parallel``."""
        if self._rule in ("mean", "sum"):
            share = 1.0 / self._n_data if self._rule == "mean" else 1.0
            return share * self._time_share()
        local, total = _local_normaliser(self.criterion, y)
        total = coll.all_reduce(total.clone(), self._grad_group)
        if self._rule == "kept":
            total = torch.clamp_min(total, 1.0)
        return local / total

    def _time_share(self) -> float:
        """Under ``sequence_parallel``, 1/s where the loss is the same on
        every rank of the ``seq`` axis (it follows a mean over time) or
        averages over time, else 1 (it sums the blocks' steps); 1 without
        sequence parallelism."""
        if not self.sequence_parallel:
            return 1.0
        reduced = any(m.reduced_time for m in self._means)
        for m in self._means:
            m.reduced_time = False
        crit = self.criterion
        if reduced:
            averaged = True
        elif isinstance(crit, C.TimeDistributedCriterion):
            averaged = crit.size_average
        else:
            averaged = self._rule == "mean"
        return 1.0 / self.mesh.axis("seq").size if averaged else 1.0

    def _reduce(self, loss, grads):
        if not self._grads_held:
            base = self._gbuf.untyped_storage().data_ptr()
            if any(g.untyped_storage().data_ptr() != base for g in grads):
                raise RuntimeError("a gradient left the flat buffer")
            self._grads_held = True
        s, n = self._scale, self._part.length
        scaled = loss if _is_one(s) else loss * s
        with self.metrics.timer("aggregate gradient time",
                                distributed=True):
            plain = not (self._shard_local or self.zero1)
            if plain:
                # one collective: the gradients and, in the last element,
                # the loss; the finite flag follows the sum, so it agrees
                self._gbuf[n:].copy_(scaled.reshape(1))
            held = self.gradient_collectives()
            # each expert (model) rank reduced other experts' rows (other
            # rows of the sharded leaves): the skip must agree over it
            other = (self.mesh.axis("expert") if self.expert_parallel
                     else self._tp)
            if plain:
                finite = torch.isfinite(self._gbuf).all()
                if other is not None and other.size > 1:
                    flag = finite.float().reshape(1)
                    coll.all_reduce(flag, other, op=dist.ReduceOp.MIN)
                    finite = flag[0] > 0
                return self._gbuf[n].clone(), finite
            parts = [scaled.float(), (~torch.isfinite(held).all()).float()]
            if self._local_taps:
                # the JAX shard_map step's taps_merge: each rank's
                # local-gradient norm and non-finite count ride this
                # all-reduce, their replica mean read after it
                g = self._gbuf[:n]
                parts += [torch.linalg.vector_norm(g),
                          (~torch.isfinite(g)).sum().float()]
            meta = torch.stack(parts)
            coll.all_reduce(meta, self.mesh)
            if self._local_taps:
                self._taps_local = meta[2:] / self._world
            if self._tp is not None:
                # the model ranks of a data slice each added its loss
                meta[0] /= self._tp.size
        loss = meta[0] / self._msum if self._shard_local else meta[0]
        return loss, (meta[1] == 0) & torch.isfinite(loss)

    def gradient_collectives(self):
        """The step's gradient collectives over the flat gradient buffer,
        as the mode sets them; returns what this rank holds of the
        result (its slice under ``zero1``).  The step runs them through
        here, and a benchmark may time them alone after ``optimize()``
        (they overwrite the buffer)."""
        msum = self._msum
        if not (self._shard_local or self.zero1):
            return coll.all_reduce(self._gbuf, self._grad_group)
        g = self._gbuf[:self._part.length]
        if self.gradient_compression:
            self._wire.copy_(g)
            coll.reduce_scatter(self._wire, self.mesh, out=self._wsl)
            if self.zero1:
                # the f32 division after the cast, as the JAX owner update
                return self._gsl.copy_(self._wsl).div_(msum)
            coll.all_gather(self._wsl, self.mesh, out=self._wire)
            # lax.pmean's arithmetic: the mean in the wire's dtype
            return g.copy_(self._wire.div_(msum))
        if self.zero1:
            coll.reduce_scatter(g, self._zgroup, out=self._gsl)
            if self._shard_local:
                self._gsl.div_(msum)
            return self._gsl
        coll.all_reduce(g, self.mesh)
        return g.div_(msum)

    @property
    def wire_bytes(self) -> int:
        """Bytes of gradient this rank puts on the wire a step (the
        padded flat length at the wire's dtype)."""
        return self._part.length * (2 if self.gradient_compression else 4)

    def _update(self, grads, opt_state, params, hyper, finite, taps=None):
        if self.expert_parallel:
            # the owner update: an expert-stacked leaf's own rows alone
            return super()._update(self._upd_grads, opt_state,
                                   self._upd_params, hyper, finite)
        if not self.zero1:
            return super()._update(grads, opt_state, params, hyper, finite,
                                   taps)
        # the owner update on this rank's slice, then every slice back;
        # the slice's tap sums are summed over the ranks at the window's
        # read (``_taps_host``), never a step
        self.optim_method.update([self._gsl], opt_state, [self._psl], hyper,
                                 finite=finite, taps=taps)
        if taps is not None and self._local_taps:
            taps[0] = self._taps_local[0].double().square()
            taps[3] = self._taps_local[1].double()
        coll.all_gather(self._psl, self._zgroup, out=self._pflat)

    # -- the taps over the ranks (the JAX merge rule) -----------------------
    def _taps_supported(self) -> bool:
        """The taps need each leaf's sums once: tensor and expert
        parallelism hold some leaves as rows and the rest whole on every
        rank of an axis, so their runs have no taps."""
        if self._tp is not None or self.expert_parallel:
            logger.info("taps: off under tensor / expert parallelism")
            return False
        return True

    def _taps_plan(self):
        """(columns, axis) of the tap sums to sum over ranks at a window
        read: ``zero1``'s slices over its group (the gradient's two only
        where each rank's come from its local gradient: the compressed
        or masked ``zero1`` step, whose norms ride the step's metadata
        all-reduce already), a pipeline's stages over ``pipe``; else
        None (the step's sums are global)."""
        if self.pipeline_stages is not None:
            return [0, 1, 2, 3], self.mesh.axis("pipe")
        if self.zero1:
            return ([1, 2] if self._local_taps else [0, 1, 2, 3]), \
                self._zgroup
        return None

    def _start_obs_run(self):
        monitor = super()._start_obs_run()
        self._local_taps = (self._taps_on and self.zero1
                            and self._shard_local
                            and self.pipeline_stages is None)
        return monitor

    def _taps_host(self, t):
        plan = self._taps_plan()
        if plan is None:
            return t
        cols, axis = plan
        if axis.size <= 1:
            return t
        part = t[:, cols].contiguous()
        coll.all_reduce(part, axis)
        t = t.clone()
        t[:, cols] = part
        return t

    def _merge_state(self):
        """Per-shard statistics: the running statistics' (masked) mean
        across the ranks (the JAX ``state_merge``)."""
        if not self._shard_local:
            return
        bufs = [b for b in self.model.buffers() if b.is_floating_point()]
        if not bufs:
            return
        flat = torch.cat([b.reshape(-1) for b in bufs])
        if not _is_one(self._w):
            flat.mul_(self._w)
        coll.all_reduce(flat, self.mesh).div_(self._msum)
        parts = flat.split([b.numel() for b in bufs])
        torch._foreach_copy_(bufs, [p.view(b.shape)
                                    for p, b in zip(parts, bufs)])

    # -- optimizer state ----------------------------------------------------
    def _local_scale(self, i, scale):
        """This rank's rows of parameter ``i``'s rate under tensor
        parallelism."""
        return self._local_leaf(i, scale)

    def _scales_of(self, params):
        """The rates of the leaves this rank updates: under
        ``expert_parallel`` an expert-stacked leaf's owned rows."""
        scales = super()._scales_of(params)
        if scales is None or not self.expert_parallel:
            return scales
        return [s if own is None else s[own].contiguous()
                for s, own in zip(scales, self._own_rows)]

    def _initial_opt_state(self, params):
        if self.pipeline_stages is not None:
            # filled at the first step, when the stage is known
            return {}
        if self.expert_parallel:
            opt_state = self.optim_method.init_state(self._upd_params)
            resume = self._resume_opt_state
            with torch.no_grad():
                for key, tree in (resume or {}).items():
                    if resume_scalar(opt_state[key], tree):
                        continue
                    for t, v, own in zip(opt_state[key],
                                         leaves_of(self.model, tree),
                                         self._own_rows):
                        v = torch.from_numpy(np.array(v, np.float32))
                        t.copy_(v if own is None else v[own])
            return opt_state
        resume = self._resume_opt_state
        if not self.zero1:
            opt_state = self.optim_method.init_state(params)
            with torch.no_grad():
                for key, tree in (resume or {}).items():
                    if resume_scalar(opt_state[key], tree):
                        continue
                    for i, (t, v) in enumerate(zip(
                            opt_state[key], leaves_of(self.model, tree))):
                        t.copy_(torch.from_numpy(
                            np.array(self._local_leaf(i, np.asarray(v)))))
            return opt_state
        opt_state = self.optim_method.init_state([self._psl])
        if resume is not None:
            own = self._part.owned(self._zidx)
            for key, tree in resume.items():
                if resume_scalar(opt_state[key], tree):
                    continue
                full = np.zeros(self._part.length, np.float32)
                for i, (v, leaf) in enumerate(zip(
                        self._part.views(full), leaves_of(self.model, tree))):
                    leaf = self._local_leaf(i, np.asarray(leaf, np.float32))
                    v[...] = leaf.reshape(v.shape)
                with torch.no_grad():
                    opt_state[key][0].copy_(torch.from_numpy(full[own]))
        return opt_state

    def _export_opt_state(self, opt_state):
        """The optimizer state in the params' tree layout; under ``zero1``
        the slices are gathered first, and under ``expert_parallel`` the
        expert-stacked leaves' rows (collectives)."""
        if self.expert_parallel:
            axis = self.mesh.axis("expert")
            out = {}
            for key, leaves in opt_state.items():
                if isinstance(leaves, torch.Tensor):
                    out[key] = export_scalar(leaves)
                    continue
                full = []
                for t, own in zip(leaves, self._own_rows):
                    if own is not None and axis.size > 1:
                        t = coll.all_gather(t.reshape(-1), axis).view(
                            (-1,) + tuple(t.shape[1:]))
                    full.append(t.detach().cpu().numpy())
                out[key] = tree_of(self.model, full)
            return out
        if self.pipeline_stages is not None:
            return self._pipe_export(opt_state)
        out = {}
        for key, leaves in opt_state.items():
            if isinstance(leaves, torch.Tensor):
                out[key] = export_scalar(leaves)
                continue
            if self.zero1:
                (piece,) = leaves
                leaves = self._part.views(coll.all_gather(piece,
                                                          self._zgroup))
            out[key] = tree_of(self.model, [
                self._whole_leaf(i, t).detach().cpu().numpy().copy()
                for i, t in enumerate(leaves)])
        return out

    # -- validation and checkpoints -------------------------------------
    def _validation_results(self):
        """Each rank validates every N-th batch; the ranks' results are
        summed in rank order (the reference's ``ValidationResult +``).
        Each batch whole on one rank: the layers take their plain paths
        (every expert's rows brought up to date first).  Under tensor
        parallelism the model ranks of a data slice validate its batches
        together (their layers keep their sharded forms) and one of them
        counts; a pipeline streams each batch through its stages."""
        if self.pipeline_stages is not None:
            return self._pipe_validation()
        self._sync_experts()
        self._bind(False)
        if self._tp is not None:
            data = self.mesh.axis("data")
            shard, counts = (data.index, data.size), self._tp.index == 0
        else:
            shard, counts = (self._rank, self._world), True
        mine = validate(self.model, self.validation_dataset,
                        self.validation_methods, self.device, shard=shard)
        self._bind(True)
        return _merged_results(mine, counts, self.mesh)

    def _checkpoint(self, opt_state, state, neval):
        """Rank 0 writes ``LocalOptimizer``'s files, the whole model in
        them (the pipeline's stages and the tensor-parallel rows gathered
        first); the others wait."""
        with self.metrics.timer("checkpoint"):
            self._sync_experts()
            tree = self._export_opt_state(opt_state)
            if self.pipeline_stages is not None:
                self._pipe_gather(move=False)
            rows = self._whole_leaves(keep=True)
            if self._rank == 0:
                # the file pickles the architecture: no mesh axis in it
                bound = self.pipeline_stages is None
                if bound:
                    self._bind(False)
                    self._bind_tp(False)
                try:
                    self._save_checkpoint(tree, state, neval)
                finally:
                    if bound:
                        self._bind(True)
                        self._bind_tp(True)
            self._restore_rows(rows)
            dist.barrier(group=self.mesh.group)


class _Stage:
    """This rank's stage of a pipeline: the plan, its modules, their
    parameters as views into one flat buffer and their gradients into
    another (a ``FlatPartition`` of one rank), its buffers and their
    pre-step copy, and the microbatch layout of the batches it serves
    (``key``: their shape, dtype and M)."""

    def __init__(self, plan, index, key, n_micro, data_size, device):
        self.plan, self.index, self.key = plan, index, key
        self.M, self.d, self.mb = n_micro, data_size, plan.mb
        self.mods = plan.stage_modules(index)
        self.params = plan.leaves(index)
        self.part = FlatPartition([p.shape for p in self.params], 1,
                                  leaf_align(device))
        self.pflat = torch.zeros(self.part.length, device=device)
        self.gflat = torch.zeros(self.part.length, device=device)
        with torch.no_grad():
            for p, v, g in zip(self.params, self.part.views(self.pflat),
                               self.part.views(self.gflat)):
                v.copy_(p)
                p.data = v
                p.grad = g
        self.ptrs = self._ptrs()
        self.buffers = [b for m in self.mods for b in m.buffers()]
        self.kept = _BufferSnapshot(torch.nn.ModuleList(self.mods))
        order = {id(p): i for i, p in enumerate(self.params)}
        self._jax = [order[id(p)] for p in plan.jax_leaves(index)]

    def _ptrs(self):
        return tuple(p.data_ptr() for p in self.params)

    def holds(self) -> bool:
        """Whether the stage's parameters are still the flat views."""
        return self._ptrs() == self.ptrs

    def shapes(self, rows):
        """Every stage's input at ``rows`` samples."""
        return [self.plan.boundary(i, rows)
                for i in range(self.plan.n_stages)]

    def jax_views(self, flat):
        """``flat``'s views of the stage's leaves in the JAX ravel
        order."""
        views = self.part.views(flat)
        return [views[i] for i in self._jax]

    def jax_spans(self):
        """Each leaf's [lo, hi) in the stage's JAX row."""
        spans, lo = [], 0
        for i in self._jax:
            n = self.part.numels[i]
            spans.append((lo, lo + n))
            lo += n
        return spans


def _broadcast_into(tensors, src, group, device):
    """Global rank ``src``'s values of ``tensors`` into them on every rank
    of ``group``, one broadcast a dtype on ``device`` (the tensors may lie
    elsewhere: a stage's modules off the card)."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for ts in by_dtype.values():
            flat = torch.cat([t.reshape(-1).to(device) for t in ts])
            coll.broadcast(flat, src, group)
            for t, part in zip(ts, flat.split([t.numel() for t in ts])):
                t.copy_(part.view(t.shape))


def _merged_results(mine, counts: bool, mesh):
    """Every rank's ``[(method, result)]`` of a validation summed in rank
    order over the ranks whose ``counts`` is True."""
    every = [None] * mesh.size
    dist.all_gather_object(every, (counts, [r for _, r in mine]),
                           group=mesh.group)
    merged = []
    for i, (method, _) in enumerate(mine):
        total = None
        for counted, results in every:
            r = results[i]
            if counted and r is not None:
                total = r if total is None else total + r
        merged.append((method, total))
    return merged


def _tp_form(mod):
    """The name of the weight whose rows a module's tensor-parallel form
    computes with (``Linear``, ungrouped ``SpatialConvolution``,
    ``MultiHeadSelfAttention``, not a subclass that overrides the
    forward), or None."""
    kind = type(mod)
    if kind.forward is Linear.forward:
        return "weight"
    if kind.forward is SpatialConvolution.forward and mod.n_group == 1:
        return "weight"
    if kind.forward is MultiHeadSelfAttention.forward:
        return "wq"
    return None


def _gathered_forward(model, gathered, tp, *args, **kwargs):
    """``model``'s forward with each of ``gathered``'s ``(module, name,
    rows)`` leaves all-gathered whole over ``tp`` for the call; the
    gradient of a whole leaf goes back to this rank's rows."""
    try:
        for mod, name, p in gathered:
            mod._parameters[name] = coll.all_gather_own_grad(p, tp)
        return type(model).forward(model, *args, **kwargs)
    finally:
        for mod, name, p in gathered:
            mod._parameters[name] = p


def _is_one(s) -> bool:
    return isinstance(s, float) and s == 1.0
