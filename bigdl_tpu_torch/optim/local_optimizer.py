"""LocalOptimizer — single-host training (counterpart of
bigdl_tpu/optim/local_optimizer.py; ref optim/LocalOptimizer.scala:40).

Each dispatch takes a batch (or, with ``set_iterations_per_dispatch(n)``,
n distinct batches), runs forward, criterion and backward, then the
OptimMethod's update in place.  What the JAX loop keeps, this one keeps:

- epoch and ``neval`` accounting in a state ``Table`` under the
  reference's keys, and the scheduled lr, read once a dispatch;
- the background input pipeline (``dataset/prefetch.py``, on with
  ``BIGDL_PREFETCH=1``): the transformer chain on a producer thread that
  owns the dataset's random stream, the copy to the card on a side
  stream; the losses are those of the serial loop, bit for bit;
- n iterations a dispatch with the JAX chunk semantics: lr, triggers,
  validation and checkpoints act once a dispatch, and ``state['loss']``
  is the chunk's last step.  On the card the n steps are one CUDA graph,
  captured after one eager chunk (the warm-up, on the capture's side
  stream) and replayed once a dispatch, with lr read from a device
  scalar; the other hyper-parameters are constants of the capture, which
  is made again when one of them or a batch shape changes.  On the CPU
  the chunk is an eager loop of n steps;
- the module state (batch normalisation's running statistics): the
  forward updates the buffers in place at every step, a captured graph's
  replays too, ``validate`` reads them in ``eval()`` mode, and checkpoints
  carry them in the JAX ``state()`` layout;
- the non-finite skip: the step's finite flag (loss and every gradient)
  stays on the device, and the update leaves params, velocity and the
  module's buffers as they were when it is False;
- the host-sync window: loss and finite flag are read in one batch at
  the sync cadence, at an epoch rollover, when a trigger fires and at
  the run's end — the loop's only device-to-host reads;
- validation and checkpoints at their triggers (``model.N`` and
  ``state.N`` with the state, the optimizer state in the JAX tree layout,
  ``neval`` and the random payload as of the last consumed batch), and
  the end trigger.

- gradient checkpointing (``set_gradient_checkpointing``): the model's
  forward runs under ``torch.utils.checkpoint`` and again in the
  backward, its dropout masks and running statistics as the first run
  left them (the JAX step's ``jax.checkpoint``); such a run takes the
  eager n-step loop.
- per-parameter learning rates (``state['learningRates']``, a tree in
  the params' layout, SGD only as in JAX): each leaf is materialised on
  the device at the parameter's shape once a run, and the update takes
  ``fused_sgd``'s scaled form.

- observability (``bigdl_tpu_torch.obs``, the JAX loop's): the taps
  (on by default; ``set_taps``) come out of the step as four device sums
  (the ``fused_sgd`` kernel's taps form on the SGD path) and are read
  with the loss in the cadence window; phase spans (``data-load``,
  ``h2d``, ``dispatch``, ``host-wait``, ``validate``, ``checkpoint``)
  under ``torch.profiler`` ranges; ``run_start``, ``step``,
  ``validation``, ``checkpoint``, ``prefetch_stall`` and ``run_end``
  events; TensorBoard scalars (``set_train_summary``,
  ``set_val_summary``); the ``train_mfu`` gauge at each window from the
  step's flops (counted once a step shape on an eager step) over an
  NVIDIA card's data-sheet peak; and on a non-finite abort an ``abort``
  event and a crash bundle.

Not ported yet: fault drills.
"""
from __future__ import annotations

import logging
import time

import numpy as np
import torch

from bigdl_tpu_torch.dataset import prefetch
from bigdl_tpu_torch.nn.module import leaves_of, tree_of
from bigdl_tpu_torch.obs import events as obs_events
from bigdl_tpu_torch.obs import taps as obs_taps
from bigdl_tpu_torch.obs.spans import SpanTracker
from bigdl_tpu_torch.optim import trigger as triggers
from bigdl_tpu_torch.optim.metrics import Metrics
from bigdl_tpu_torch.optim.optim_method import SGD, Default, OptimMethod
from bigdl_tpu_torch.optim.validation import AccuracyResult, Loss, LossResult
from bigdl_tpu_torch.tensor import policy
from bigdl_tpu_torch.utils import file as File
from bigdl_tpu_torch.utils.device import pin_fp32, resolve_device
from bigdl_tpu_torch.utils.random import RNG
from bigdl_tpu_torch.utils.table import T, Table

logger = logging.getLogger("bigdl_tpu_torch.optim")


class NonFiniteGradError(RuntimeError):
    """Training aborted: non-finite gradients for more consecutive steps
    than the abort threshold (``set_nonfinite_policy``)."""


def _finite_all(loss, grads):
    """One bool on the device: the loss and every gradient finite."""
    flags = [torch.isfinite(loss).all()]
    flags += [torch.isfinite(g).all() for g in grads]
    return torch.stack(flags).all()


def to_device(a, device: torch.device) -> torch.Tensor:
    """A host batch array on ``device``; to the card through pinned
    memory without blocking the host."""
    t = torch.as_tensor(np.asarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class _BufferSnapshot:
    """The module's buffers as they were before a step, one flat copy a
    dtype, so that a step whose finite flag is False leaves them as it
    found them (the JAX step's ``_where_finite`` over its state), on the
    device and in place.  The flat copies and the views into them are
    made once, for one set of buffer addresses (``holds``), and refilled
    at every step: a multi-tensor copy to save; a multi-tensor copy, a
    ``where`` and a multi-tensor copy back to restore."""

    def __init__(self, model):
        self.ptrs = self._ptrs(model)
        groups = {}
        for b in model.buffers():
            groups.setdefault(b.dtype, []).append(b)
        self.groups = []
        for bufs in groups.values():
            n = [b.numel() for b in bufs]
            saved, now = bufs[0].new_empty(sum(n)), bufs[0].new_empty(sum(n))
            self.groups.append((bufs, saved, now, [
                [v.view(b.shape) for v, b in zip(flat.split(n), bufs)]
                for flat in (saved, now)]))

    @staticmethod
    def _ptrs(model):
        return tuple(b.data_ptr() for b in model.buffers())

    def holds(self, model) -> bool:
        return self.ptrs == self._ptrs(model)

    def save(self):
        for bufs, _, _, (saved, _) in self.groups:
            torch._foreach_copy_(saved, bufs)

    def restore_unless(self, finite):
        for bufs, saved, now, (_, now_parts) in self.groups:
            torch._foreach_copy_(now_parts, bufs)
            torch.where(finite, now, saved, out=now)
            torch._foreach_copy_(bufs, now_parts)


def remat(fn, x, buffers):
    """``fn(x)`` under ``torch.utils.checkpoint``: the backward runs the
    forward again instead of keeping its activations.  The second run
    draws the first run's dropout masks (the package generator on
    ``x``'s device set back to where it stood, then forward again) and
    leaves ``buffers`` (running statistics) as the first run left
    them."""
    from torch.utils.checkpoint import checkpoint

    gen = RNG.generator(x.device)
    start = gen.get_state()
    buffers = list(buffers)
    calls = [0]

    def run(xx):
        calls[0] += 1
        if calls[0] == 1:
            return fn(xx)
        now, kept = gen.get_state(), [b.clone() for b in buffers]
        gen.set_state(start)
        try:
            return fn(xx)
        finally:
            gen.set_state(now)
            if kept:
                torch._foreach_copy_(buffers, kept)

    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)


def _three(out):
    """A step's (loss, finite, taps): a ``_train_step`` replaced by one
    that returns (loss, finite) has no taps."""
    return out if len(out) == 3 else (*out, None)


class _PendingStep:
    """One dispatched but not yet read dispatch: its device scalars (one
    a step: (n,) at n steps a dispatch) and the host bookkeeping taken at
    dispatch."""

    __slots__ = ("neval0", "epoch", "count", "loss", "finite", "taps", "lr",
                 "records", "fetch_t", "train_t", "extra")

    def __init__(self, neval0, epoch, count, loss, finite, taps, lr,
                 records, fetch_t, train_t, extra=None):
        self.neval0 = neval0
        self.epoch = epoch
        self.count = count
        self.loss = loss
        self.finite = finite
        self.taps = taps         # the four tap sums ((n, 4) a chunk), or None
        self.lr = lr
        self.records = records
        self.fetch_t = fetch_t
        self.train_t = train_t
        self.extra = extra or {}


class _HostSyncWindow:
    """Cadence-gated device-to-host reads of the loop: each dispatch's
    losses and finite flags wait here and are read in one copy once
    ``cadence`` iterations have begun since the last read (or at a
    boundary)."""

    def __init__(self, cadence: int):
        self.cadence = max(1, int(cadence))
        self.pending: list[_PendingStep] = []
        self._last_flush = 0
        self._t0 = None

    def arm(self):
        """Start the window's wall clock at the first iteration it
        covers, so its throughput spans fetch, dispatch and read."""
        if self._t0 is None:
            self._t0 = time.perf_counter()

    def push(self, entry: _PendingStep):
        self.arm()
        self.pending.append(entry)

    def due(self) -> bool:
        return bool(self.pending) and \
            (self.pending[-1].neval0 - self._last_flush) >= self.cadence

    def flush(self, taps_fn=None):
        """Read every pending dispatch in one device-to-host copy: losses,
        finite flags and the tap sums (``taps_fn`` maps the pending taps,
        one (k, 4) tensor, before the copy: a data-parallel loop's sum over
        ranks).  Returns (entries, [losses of each], [finite flags of
        each], [taps of each: (n, 4) or None], window wall seconds)."""
        entries, self.pending = self.pending, []
        sizes = [e.loss.numel() for e in entries]
        parts = [torch.cat([e.loss.reshape(-1).double() for e in entries]),
                 torch.cat([e.finite.reshape(-1) for e in entries]).double()]
        tapped = [e for e in entries if e.taps is not None]
        if tapped:
            t = torch.cat([e.taps.reshape(-1, 4) for e in tapped])
            if taps_fn is not None:
                t = taps_fn(t)
            parts.append(t.reshape(-1).to(parts[0].device))
        host = torch.cat(parts).cpu().numpy()
        wall = (time.perf_counter() - self._t0) if self._t0 else 0.0
        self._t0 = None
        self._last_flush = entries[-1].neval0
        n = sum(sizes)
        bounds = np.cumsum([0] + sizes)
        taps = host[2 * n:].reshape(-1, 4)
        out_taps, k = [], 0
        for e, size in zip(entries, sizes):
            if e.taps is None:
                out_taps.append(None)
            else:
                out_taps.append(taps[k:k + size])
                k += size
        return (entries, [host[a:b] for a, b in zip(bounds, bounds[1:])],
                [host[n + a:n + b] != 0 for a, b in zip(bounds, bounds[1:])],
                out_taps, wall)


class _CapturedChunk:
    """n train steps captured as one CUDA graph.  Its inputs are static
    (n, B, ...) buffers and a device lr; its outputs static (n,) losses
    and finite flags, copied out after each replay.  The kernel wrappers
    count their launches where they make them, in the capture; a replay
    runs what the capture recorded without calling them."""

    def __init__(self, opt, params, opt_state, x, y, hyper, stream):
        dev = x.device
        n = x.shape[0]
        self.key = _capture_key(params, opt.model, opt_state, x, y, hyper,
                                opt._taps_on)
        self.x = torch.empty_like(x)
        self.y = torch.empty_like(y)
        self.lr = torch.zeros((), dtype=torch.float32, device=dev)
        self.losses = torch.empty(n, dtype=torch.float32, device=dev)
        self.finites = torch.empty(n, dtype=torch.bool, device=dev)
        # the tap sums of each step, written by the update in the capture
        self.taps = (torch.zeros(n, len(obs_taps.SUMS), dtype=torch.float64,
                                 device=dev) if opt._taps_on else None)
        self.graph = torch.cuda.CUDAGraph()
        # the dropout masks' generator advances at every replay
        self.graph.register_generator_state(RNG.generator(dev))
        # thread_local: the prefetch's transfer thread goes on copying
        # (pinned buffers, events) on its own stream while this thread
        # captures; only this thread's unsafe calls would break capture
        with torch.cuda.graph(self.graph, stream=stream,
                              capture_error_mode="thread_local"):
            for i in range(n):
                loss, finite, _ = opt._train_step(
                    params, opt_state, self.x[i], self.y[i],
                    dict(hyper, lr=self.lr),
                    taps=None if self.taps is None else self.taps[i])
                self.losses[i].copy_(loss)
                self.finites[i].copy_(finite)

    def run(self, x, y, lr):
        self.x.copy_(x)
        self.y.copy_(y)
        self.lr.fill_(lr)
        self.graph.replay()
        return (self.losses.clone(), self.finites.clone(),
                None if self.taps is None else self.taps.clone())


def _capture_key(params, model, opt_state, x, y, hyper, taps_on=False):
    """What a capture is a function of besides its inputs' values: the
    dtype policy its forward read (a step after ``set_policy`` captures
    anew, as the JAX serving cache keys its programs on it), the batch
    shapes and types, whether the taps are on, the address of every
    parameter, gradient, module buffer, optimizer-state tensor and
    per-parameter rate, and the other hyper-parameters but lr."""
    return (policy().key(), tuple(x.shape), x.dtype, tuple(y.shape),
            y.dtype, bool(taps_on),
            tuple((p.data_ptr(), p.grad.data_ptr()) for p in params),
            tuple(b.data_ptr() for b in model.buffers()),
            tuple(t.data_ptr() for t in _state_tensors(opt_state)),
            tuple(sorted((k, _hyper_key(v)) for k, v in hyper.items()
                         if k != "lr")))


def _state_tensors(opt_state) -> list:
    """Every tensor of an optimizer state: its per-leaf lists' and its
    scalars (Adagrad's step)."""
    return [t for v in opt_state.values()
            for t in ([v] if isinstance(v, torch.Tensor) else v)]


def _hyper_key(v):
    if isinstance(v, (list, tuple)):
        return tuple(t.data_ptr() for t in v)
    return repr(v)


class LocalOptimizer:
    """Trains ``model`` on ``dataset`` against ``criterion`` on one
    device: the card unless the caller asks for the CPU."""

    def __init__(self, model, dataset, criterion, device="cuda"):
        self.device = resolve_device(device)
        self.model = model
        self.dataset = dataset
        self.criterion = criterion
        self.optim_method: OptimMethod = SGD()
        self.state = T()
        self.end_when = triggers.max_epoch(10)
        self.validation_trigger = None
        self.validation_dataset = None
        self.validation_methods = None
        self.checkpoint_path = None
        self.checkpoint_trigger = None
        self.iters_per_dispatch = 1
        #: the forward under torch.utils.checkpoint
        #: (``set_gradient_checkpointing``)
        self.remat = False
        # n > 1 steps a dispatch on the card: one captured CUDA graph
        # (False: the eager loop, a reference to hold the graph to)
        self._cuda_graph = True
        self.metrics = Metrics()
        # skip a non-finite step (params and velocity keep their values),
        # count it, abort after this many in a row (0: never)
        self.nonfinite_abort = 10
        self._nonfinite_skips = 0
        self._nonfinite_streak = 0
        self._resume_opt_state = None
        #: the optimizer's own state of the last run, in place ({'velocity':
        #: one tensor a parameter}); each ``optimize()`` starts it anew
        self.opt_state = None
        #: this run's per-parameter learning rates on the device (one
        #: tensor a parameter, its shape), or None
        self._lr_scales = None
        self._window = None
        self._train_pipeline = None
        self._chunk = self._side = None
        #: the buffers' pre-step copy (``_BufferSnapshot``), kept while the
        #: buffers stay where they are
        self._kept = None
        #: device-to-host reads of the training loop (window flushes)
        self.host_syncs = 0
        #: graph captures and replays of the n-step dispatch
        self.captures = 0
        self.replays = 0
        #: (neval, loss) of every step, as flushed
        self.loss_log: list = []
        #: (neval, epoch, {method: value}) of every validation
        self.validation_log: list = []
        # observability: the taps (None: BIGDL_OBS_TAPS /
        # BIGDL_OBS_TAPS_CADENCE), the phase spans, the TensorBoard sinks
        self._taps_enabled = None
        self._taps_cadence = None
        self._taps_monitor = None
        self._taps_on = False
        self._train_summary = None
        self._val_summary = None
        self.spans = SpanTracker(self.metrics)
        #: the ledger's name for this loop's step program (its flops are
        #: counted once a step shape, ``_counted_step``)
        self._step_fn_key = ("train_step", type(self).__name__, id(self))
        #: the data-sheet peak ``train_mfu`` divides by (None: the device's,
        #: looked up at the first step; none on the CPU: no gauge, and no
        #: flop count)
        self._peak_flops = None

    # -- builder config (ref Optimizer.scala:66-124) ----------------------
    def set_state(self, state: Table):
        self.state.update(state)
        return self

    def set_optim_method(self, method: OptimMethod):
        self.optim_method = method
        return self

    def set_optim_state(self, opt_state):
        """Resume the optimizer's own state (the momentum velocity) from a
        ``state.N`` snapshot's ``opt_state``, of either package: each
        entry a tree in the params' layout.  Without it a momentum run
        resumes from zero velocity and leaves the uninterrupted
        trajectory."""
        self._resume_opt_state = opt_state
        return self

    def set_end_when(self, end_when):
        self.end_when = end_when
        return self

    def set_validation(self, trigger, dataset, methods):
        self.validation_trigger = trigger
        self.validation_dataset = dataset
        self.validation_methods = methods
        return self

    def set_checkpoint(self, path, trigger):
        """Write ``model.N`` and ``state.N`` under ``path`` whenever
        ``trigger`` fires (N the iteration it fired at)."""
        self.checkpoint_path = str(path)
        self.checkpoint_trigger = trigger
        return self

    def set_iterations_per_dispatch(self, n: int):
        """n train steps a dispatch, each on its own batch (the JAX
        ``lax.scan`` of n steps; one CUDA graph on the card).  lr,
        triggers, validation and checkpoints act once a dispatch, and
        ``state['loss']`` is the chunk's last step.  The batches of a
        chunk must share one shape."""
        self.iters_per_dispatch = max(1, int(n))
        return self

    def set_gradient_checkpointing(self, enabled: bool = True):
        """Run the forward again inside the backward (``torch.utils
        .checkpoint``) instead of keeping its activations: FLOPs for
        memory (the JAX ``jax.checkpoint``; the reference's shared-buffer
        tricks, SpatialShareConvolution and ResNet.shareGradInput, did the
        same job).  A pipeline's GPipe schedule checkpoints each stage."""
        self.remat = bool(enabled)
        return self

    def set_taps(self, enabled: bool | None = None,
                 cadence: int | None = None):
        """Override the taps' gating for the next ``optimize()`` (None
        defers to ``BIGDL_OBS_TAPS`` / ``BIGDL_OBS_TAPS_CADENCE``).  The
        cadence is also the loop's host-read cadence."""
        self._taps_enabled = enabled
        self._taps_cadence = cadence
        return self

    def set_train_summary(self, summary):
        """TensorBoard training-curve sink (``obs.TrainSummary``): Loss,
        LearningRate and Throughput a step, the taps at their cadence.
        Under data parallelism attach it on rank 0 only (the reference's
        TrainSummary lives on the job's master)."""
        self._train_summary = summary
        return self

    def set_val_summary(self, summary):
        """TensorBoard validation sink (``obs.ValidationSummary``): one
        scalar a validation method at each validation."""
        self._val_summary = summary
        return self

    def set_nonfinite_policy(self, abort_after: int | None = 10):
        """Abort (NonFiniteGradError) after ``abort_after`` consecutive
        skipped steps; 0/None keeps skipping."""
        self.nonfinite_abort = int(abort_after or 0)
        return self

    # -- hypers ------------------------------------------------------------
    def _hyper(self, lr):
        s = self.state
        return {
            "lr": lr,
            "weight_decay": float(s.get("weightDecay", 0.0)),
            "momentum": float(s.get("momentum", 0.0)),
            # Torch default, as the JAX loop has it: dampening = momentum
            "dampening": float(s.get("dampening", s.get("momentum", 0.0))),
            "nesterov": bool(s.get("nesterov", False)),
            "lr_decay": float(s.get("learningRateDecay", 0.0)),
            "lr_scales": self._lr_scales,
        }

    def _scales_of(self, params):
        """``state['learningRates']`` (a tree in the params' layout) as
        one float32 tensor a parameter, at its shape on its device, or
        None; a method other than SGD raises, as in JAX."""
        tree = self.state.get("learningRates", None)
        if tree is None:
            return None
        if not isinstance(self.optim_method, SGD):
            raise ValueError(
                "state['learningRates'] (per-param lr scales) is only "
                f"supported by SGD, not {type(self.optim_method).__name__}"
                " — it would be silently ignored")
        out = []
        for i, (leaf, p) in enumerate(zip(leaves_of(self.model, tree),
                                          params)):
            t = (leaf.detach().cpu() if isinstance(leaf, torch.Tensor)
                 else torch.from_numpy(np.array(leaf)))
            t = self._local_scale(i, t.to(torch.float32))
            out.append(t.to(p.device).expand(p.shape).contiguous())
        return out

    def _local_scale(self, i, scale):
        """This process's part of parameter ``i``'s rate (all of it)."""
        return scale

    def _current_lr(self):
        schedule = self.state.get("learningRateSchedule", Default())
        schedule.update_hyper_parameter(self.state, self.state)
        return -self.state.get("currentLearningRate",
                               -self.state.get("learningRate", 1e-3))

    # -- optimizer state in the JAX tree layout ----------------------------
    def _initial_opt_state(self, params):
        opt_state = self.optim_method.init_state(params)
        resume = self._resume_opt_state
        if resume is not None:
            with torch.no_grad():
                for key, tree in resume.items():
                    if resume_scalar(opt_state[key], tree):
                        continue
                    for t, v in zip(opt_state[key],
                                    leaves_of(self.model, tree)):
                        t.copy_(torch.from_numpy(np.array(v)))
        return opt_state

    def _export_opt_state(self, opt_state):
        return {key: (export_scalar(leaves)
                      if isinstance(leaves, torch.Tensor) else
                      tree_of(self.model, [t.detach().cpu().numpy()
                                           for t in leaves]))
                for key, leaves in opt_state.items()}

    # -- one step ------------------------------------------------------------
    def _train_step(self, params, opt_state, x, y, hyper, taps=None):
        """One step in place: (loss, finite flag, the four tap sums or
        None), all on the device.  ``taps`` is where the sums go (a
        captured chunk's row); with taps on and none given, a new one."""
        if self._taps_on:
            if taps is None:
                taps = obs_taps.new_sums(x.device)
            else:
                taps.zero_()
        else:
            taps = None
        self._zero_grads(params)
        kept = self._kept
        if kept is None or not kept.holds(self.model):
            kept = self._kept = _BufferSnapshot(self.model)
        kept.save()
        out = (remat(self.model, x, self.model.buffers()) if self.remat
               else self.model(x))
        loss = self.criterion(out, y)
        self._backward(loss, y)
        grads = [p.grad for p in params]
        loss, finite = self._reduce(loss.detach(), grads)
        self._update(grads, opt_state, params, hyper, finite, taps)
        self._merge_state()
        kept.restore_unless(finite)
        return loss, finite, taps

    def _counted_step(self, params, opt_state, x, y, hyper):
        """``_train_step`` that counts its flops into the ledger the first
        time a step of this shape runs (an eager step, never inside a
        capture), where ``train_mfu`` has a peak to divide by: the key is
        what a capture keys on that moves the count, the dtype policy,
        the batch's shapes and types and the taps."""
        from bigdl_tpu_torch.obs import ledger as obs_ledger

        step = lambda: self._train_step(  # noqa: E731
            params, opt_state, x, y, hyper)
        if self._peak() is None:
            return _three(step())
        key = (self._step_fn_key, policy().key(), tuple(x.shape), x.dtype,
               tuple(y.shape), y.dtype, self._taps_on)
        return _three(obs_ledger.get().counted(self._step_fn_key, key, step))

    def _peak(self):
        """The data-sheet peak ``train_mfu`` divides by: ``_peak_flops``
        where set, else the device's (None on the CPU)."""
        from bigdl_tpu_torch.obs import ledger as obs_ledger

        if self._peak_flops is None:
            self._peak_flops = obs_ledger.device_peak_flops(self.device)
        return self._peak_flops

    # -- the step's hooks: a data-parallel step overrides them -------------
    def _zero_grads(self, params):
        # the gradients persist across steps, zeroed in place and
        # accumulated into by autograd, so the SGD kernel's leaf table,
        # built at the first step, serves every later one (and a captured
        # graph's)
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        torch._foreach_zero_([p.grad for p in params])

    def _backward(self, loss, y):
        loss.backward()

    def _reduce(self, loss, grads):
        """The gradient transform after the backward: (the step's loss,
        its finite flag)."""
        return loss, _finite_all(loss, grads)

    def _update(self, grads, opt_state, params, hyper, finite, taps=None):
        self.optim_method.update(grads, opt_state, params, hyper,
                                 finite=finite, taps=taps)

    def _merge_state(self):
        """The module state's merge after the update (none here)."""

    def _eager_chunk(self, params, opt_state, xs, ys, hyper):
        out = [_three((self._counted_step if i == 0 else self._train_step)(
            params, opt_state, x, y, hyper))
            for i, (x, y) in enumerate(zip(xs, ys))]
        return (torch.stack([l for l, _, _ in out]),
                torch.stack([f for _, f, _ in out]),
                None if out[0][2] is None else
                torch.stack([t for _, _, t in out]))

    def _run_chunk(self, params, opt_state, xs, ys, lr):
        """n steps on the (n, B, ...) batches: (n losses, n flags, (n, 4)
        tap sums or None)."""
        hyper = self._hyper(lr)
        if self.device.type != "cuda" or not self._cuda_graph or self.remat:
            # the checkpoint's generator states are host reads: no capture
            return self._eager_chunk(params, opt_state, xs, ys, hyper)
        if self._side is None:
            # the optimizer's first chunk warms up on the capture's stream
            # (library handles, the SGD leaf table, kernel attributes,
            # first-call plans): a real chunk of the run, eager
            self._side = torch.cuda.Stream(self.device)
            cur = torch.cuda.current_stream(self.device)
            self._side.wait_stream(cur)
            with torch.cuda.stream(self._side):
                out = self._eager_chunk(params, opt_state, xs, ys, hyper)
            cur.wait_stream(self._side)
            for t in out:   # read later on this stream: no early reuse
                if t is not None:
                    t.record_stream(cur)
            return out
        chunk = self._chunk
        if chunk is None or chunk.key != _capture_key(
                params, self.model, opt_state, xs, ys, hyper, self._taps_on):
            chunk = self._chunk = _CapturedChunk(
                self, params, opt_state, xs, ys, hyper, self._side)
            self.captures += 1
        self.replays += 1
        return chunk.run(xs, ys, lr)

    # -- main loop (ref LocalOptimizer.optimize :77) ----------------------
    def optimize(self):
        state = self.state
        state.get_or_update("epoch", 1)
        state.get_or_update("neval", 1)
        pin_fp32(self.device)
        self.model.to(self.device).train()
        params = list(self.model.parameters())
        self._lr_scales = self._scales_of(params)
        opt_state = self.opt_state = self._initial_opt_state(params)
        n = self.iters_per_dispatch
        self._start_obs_run()

        count = 0
        epoch_size = self.dataset.size()
        pipeline = None
        if prefetch.enabled():
            pipeline = prefetch.PipelineRunner(
                self.dataset, train=True, chunk=n, epoch_size=epoch_size,
                device=self.device)
        self._train_pipeline = pipeline
        data_iter = None if pipeline is not None \
            else self.dataset.data(train=True)
        self._window = _HostSyncWindow(self._sync_cadence())
        wall_start = time.perf_counter()
        try:
            while not self.end_when(state):
                neval0 = int(state["neval"])
                epoch0 = int(state["epoch"])
                self._window.arm()
                fetch_start = time.perf_counter()
                extra = {}
                with self.spans.span("data-load"):
                    if pipeline is not None:
                        # the span is the consumer's wait; the producer's
                        # draws ride data-load/fetch
                        item, waited = pipeline.get()
                        self._drain_pipeline_obs(pipeline, item, waited,
                                                 neval0)
                        extra["queue_depth"] = int(item.queue_depth)
                    else:
                        if n <= 1:
                            batch = next(data_iter)
                            xh, yh = batch.data, batch.labels
                        else:
                            xh, yh = prefetch.stack_chunk(
                                [next(data_iter) for _ in range(n)])
                        xh, yh = self._local_batch(xh, yh, n > 1)
                if pipeline is not None and item.device is not None:
                    x, y = item.device
                else:
                    if pipeline is not None:
                        xh, yh = item.x, item.y
                    with self.spans.span("h2d"):
                        x = to_device(xh, self.device)
                        y = to_device(yh, self.device)
                fetch_time = time.perf_counter() - fetch_start
                if not self._admit():
                    continue   # the batch is consumed, neval stays

                train_start = time.perf_counter()
                with self.spans.span("dispatch"):
                    lr = self._current_lr()
                    if n <= 1:
                        loss, finite, taps = self._counted_step(
                            params, opt_state, x, y, self._hyper(lr))
                    else:
                        loss, finite, taps = self._run_chunk(
                            params, opt_state, x, y, lr)
                    self._after_step(fetch_time, train_start)
                train_time = time.perf_counter() - train_start

                b = self._records(x.shape[0] * x.shape[1] if n > 1
                                  else x.shape[0])
                count += b
                state["neval"] = neval0 + n
                state["evalCounter"] = state.get("evalCounter", 0) + n
                self.metrics.add("data fetch time", fetch_time)
                self.metrics.add("train time", train_time)
                # loss, flag and taps stay on the device until the window
                # reads them (no per-step device-to-host read)
                self._window.push(_PendingStep(
                    neval0, epoch0, count, loss, finite, taps, lr, b,
                    fetch_time, train_time, extra))

                rolled = count >= epoch_size
                count, data_iter = self._advance_epochs(
                    state, count, epoch_size, n, data_iter, pipeline)
                if self._window.due() or rolled:
                    self._flush_window(state, "epoch" if rolled
                                       else "cadence")
                ne_val = _fired_within(self.validation_trigger, state, n)
                ne_ck = _fired_within(self.checkpoint_trigger, state, n)
                if ne_val is not None or ne_ck is not None:
                    self._flush_window(state, "trigger")
                if ne_val is not None:
                    self._validate(state)
                if ne_ck is not None:
                    self._checkpoint(opt_state, state, ne_ck)
            self._flush_window(state, "run-end")
        finally:
            try:
                # an exception between flushes must not lose the steps
                # already run; a no-op after a clean run-end flush
                self._flush_window(state, "exception")
            except Exception as e:
                logger.warning("pending-step flush during unwind failed: "
                               "%s", e)
            if pipeline is not None:
                pipeline.close()
            self._train_pipeline = None
            self._chunk = None   # its graph holds this run's velocity
        self._end_obs_run(state, wall_start)
        logger.info("Training finished in %.1fs",
                    time.perf_counter() - wall_start)
        return self.model

    def _drain_pipeline_obs(self, pipeline, item, waited, neval0):
        """Book the pipeline threads' walls to the spans (the copies to
        ``h2d``, the producer's draws to ``data-load/fetch``) and emit a
        ``prefetch_stall`` where the queue failed to hide the fetch."""
        sec, k = pipeline.take_h2d()
        if k:
            self.spans.record("h2d", sec, count=k)
        sec, k = pipeline.take_fetch()
        if k:
            self.spans.record("data-load/fetch", sec, count=k)
        if waited > 0.01 and item.seq >= pipeline.depth:
            obs_events.emit("prefetch_stall", step=int(neval0),
                            seconds=round(waited, 6),
                            queue_depth=int(item.queue_depth))

    # -- the loop's hooks: a data-parallel loop overrides them -------------
    def _local_batch(self, xh, yh, chunked: bool):
        """This process's rows of a host batch (all of them here)."""
        return xh, yh

    def _admit(self) -> bool:
        """Whether this iteration's update runs (always here)."""
        return True

    def _after_step(self, fetch_time: float, train_start: float):
        """After the step's dispatch (nothing here)."""

    def _records(self, rows: int) -> int:
        """The records an iteration of ``rows`` local rows counts."""
        return rows

    def _sync_cadence(self) -> int:
        """Iterations between host reads of loss, flags and taps: the taps
        cadence (``BIGDL_OBS_TAPS_CADENCE`` / ``set_taps``, default 10)."""
        return obs_taps.cadence(self._taps_cadence)

    def _advance_epochs(self, state, count, epoch_size, n, data_iter,
                        pipeline):
        """The epoch rollover: at one step a dispatch the leftover count
        resets (it came from the iterator now discarded); a chunk may span
        epochs of a small dataset, so at n it rolls through.  With the
        pipeline its producer has already shuffled and rebuilt its
        iterator at this point of the stream; only the counters move."""
        if n <= 1:
            if count >= epoch_size:
                state["epoch"] = state["epoch"] + 1
                count = 0
                if pipeline is None:
                    self.dataset.shuffle()
                    data_iter = self.dataset.data(train=True)
                self.spans.emit_phase_events(obs_events.get(),
                                             int(state["neval"]))
            return count, data_iter
        rolled = count >= epoch_size
        while count >= epoch_size:
            state["epoch"] = state["epoch"] + 1
            count -= epoch_size
            if pipeline is None:
                self.dataset.shuffle()
                data_iter = self.dataset.data(train=True)
        if rolled:
            self.spans.emit_phase_events(obs_events.get(),
                                         int(state["neval"]))
        return count, data_iter

    def _flush_window(self, state, reason: str):
        """Read the pending window (one device-to-host copy: the
        ``host-wait`` span), then the per-step host work: the loss log,
        the non-finite count, step events, the taps at their cadence and
        TensorBoard scalars.  An abort is raised after every pending
        step's events are out."""
        w = self._window
        if w is None or not w.pending:
            return
        with self.spans.span("host-wait"):
            # an unwinding rank reads its own sums: the others may not
            # join a collective there
            entries, losses, finites, taps, wall = w.flush(
                None if reason == "exception" else self._taps_host)
        self.host_syncs += 1
        rate = sum(e.records for e in entries) / max(wall, 1e-9)
        self._note_window_utilization(entries, wall)
        epoch_size = self.dataset.size()
        monitor = self._taps_monitor
        abort = None
        for e, ls, oks, tp in zip(entries, losses, finites, taps):
            state["loss"] = float(ls[-1])
            self.loss_log += [(e.neval0 + i, float(v))
                              for i, v in enumerate(ls)]
            logger.info(
                "Epoch %d %d/%d loss %.6f lr %.5g throughput %.1f "
                "records/s (fetch %.4fs dispatch %.4fs, synced %s)",
                e.epoch, e.count, epoch_size, float(ls[-1]), e.lr, rate,
                e.fetch_t, e.train_t, reason)
            for ok in oks:
                if abort is None:
                    try:
                        self._note_finite(bool(ok), state)
                    except NonFiniteGradError as exc:
                        abort = exc  # log the remaining steps first
            tap_vals = (monitor.push(e.neval0, tp)
                        if monitor is not None and tp is not None else None)
            self._emit_step_event(e.neval0, float(ls[-1]), e.lr, rate,
                                  tap_vals, **e.extra)
        if abort is not None:
            raise abort

    def _taps_host(self, t):
        """The window's tap sums before their copy to the host (as they
        are here; a data-parallel loop sums what each rank holds of
        them)."""
        return t

    def _note_window_utilization(self, entries, wall):
        """``train_step_wall_seconds`` and ``train_mfu`` at each window
        read, never a step: the step's ledger flops times the window's
        iterations over (the window's wall times the card's data-sheet
        peak).  No peak (the CPU, a card the table lacks): no
        ``train_mfu``."""
        if wall <= 0 or not entries:
            return
        try:
            from bigdl_tpu_torch.obs import ledger as obs_ledger
            from bigdl_tpu_torch.obs import metrics as obs_metrics
            iters = len(entries) * max(1, int(self.iters_per_dispatch))
            label = ("distri" if type(self).__name__.startswith("Distri")
                     else "local")
            reg = obs_metrics.get()
            reg.gauge("train_step_wall_seconds",
                      "windowed mean train-step wall (fetch + dispatch "
                      "+ sync)", agg="max",
                      optimizer=label).set(wall / iters)
            flops = obs_ledger.get().flops_for(self._step_fn_key)
            peak = self._peak()
            if flops and peak:
                reg.gauge("train_mfu",
                          "windowed model flops utilization of the "
                          "training loop (ledger flops x step rate / "
                          "data-sheet peak)", agg="max",
                          optimizer=label).set(flops * iters / (wall * peak))
        except Exception as e:  # pragma: no cover - obs mid-teardown
            logger.warning("train utilization gauge failed: %s", e)

    def _note_finite(self, ok: bool, state):
        if ok:
            self._nonfinite_streak = 0
            return
        self._nonfinite_skips += 1
        self._nonfinite_streak += 1
        state["nonFiniteSkips"] = self._nonfinite_skips
        logger.warning(
            "non-finite gradients at iteration %d: update skipped, params "
            "and optimizer state kept (%d skipped, %d in a row)",
            int(state["neval"]), self._nonfinite_skips,
            self._nonfinite_streak)
        if self.nonfinite_abort and \
                self._nonfinite_streak >= self.nonfinite_abort:
            # the postmortem before the raise: the abort event and the
            # crash bundle explain this death from the run directory alone
            from bigdl_tpu_torch.obs import diagnostics
            obs_events.emit("abort", step=int(state["neval"]),
                            reason="nonfinite",
                            skips=int(self._nonfinite_skips),
                            streak=int(self._nonfinite_streak))
            diagnostics.dump_crash_bundle(
                "nonfinite-abort",
                extra={"neval": int(state["neval"]),
                       "streak": int(self._nonfinite_streak),
                       "skips": int(self._nonfinite_skips),
                       "threshold": int(self.nonfinite_abort)})
            raise NonFiniteGradError(
                f"{self._nonfinite_streak} consecutive non-finite-gradient "
                f"steps (threshold {self.nonfinite_abort}, iteration "
                f"{int(state['neval'])}): the loss has diverged")

    # -- validation (ref LocalOptimizer.scala:196-242) --------------------
    def _validate(self, state):
        pipeline = self._train_pipeline
        if pipeline is not None:
            # hold the producer before its next draw: validation may read
            # the records an epoch shuffle reorders
            pipeline.pause()
        try:
            with self.metrics.timer("validate"), self.spans.span("validate"):
                results = self._validation_results()
        finally:
            if pipeline is not None:
                pipeline.resume()
        values = {}
        for method, result in results:
            logger.info("%s is %s", method, result)
            val = values[str(method)] = state[str(method)] = \
                result.result()[0]
            obs_events.emit("validation", step=int(state["neval"]),
                            method=str(method), value=float(val))
            if self._val_summary is not None:
                self._val_summary.add_scalar(str(method), val,
                                             int(state["neval"]))
        self.validation_log.append((int(state["neval"]), int(state["epoch"]),
                                    values))

    def _validation_results(self):
        return validate(self.model, self.validation_dataset,
                        self.validation_methods, self.device)

    # -- checkpoints (the JAX _maybe_checkpoint :956-1008) ----------------
    def _checkpoint(self, opt_state, state, neval):
        with self.metrics.timer("checkpoint"), self.spans.span("checkpoint"):
            self._save_checkpoint(self._export_opt_state(opt_state), state,
                                  neval)
        obs_events.emit("checkpoint", step=int(neval),
                        path=f"{self.checkpoint_path}/model.{neval}")

    def _save_checkpoint(self, opt_tree, state, neval):
        """``model.N`` and ``state.N`` under the checkpoint path: the
        state, the optimizer state in the params' tree layout
        (``opt_tree``), the label and the random payload as of the last
        CONSUMED batch (with the pipeline, the stream has already drawn
        for batches only prefetched)."""
        from bigdl_tpu_torch.optim.optimizer import (keep_count,
                                                     prune_checkpoints)

        pipeline = self._train_pipeline
        rng = (pipeline.rng_snapshot() if pipeline is not None
               else prefetch.host_snapshot(self.dataset))
        path = self.checkpoint_path
        File.save_module(self.model, f"{path}/model.{neval}")
        File.save({"state": state, "opt_state": opt_tree,
                   "neval": neval, "rng": rng}, f"{path}/state.{neval}")
        keep = keep_count()
        if keep:
            prune_checkpoints(path, keep, just_written=neval)


    # -- observability plumbing (the JAX loop's :858-926) -----------------
    def _obs_flags(self) -> dict:
        """The run's configuration stamped into ``run_start``: enough to
        tell two runs apart in a pile of JSONL."""
        flags = {"optimizer": type(self).__name__,
                 "taps": obs_taps.enabled(self._taps_enabled),
                 "taps_cadence": obs_taps.cadence(self._taps_cadence),
                 "iters_per_dispatch": self.iters_per_dispatch,
                 "nonfinite_abort": self.nonfinite_abort,
                 "prefetch": prefetch.enabled(),
                 "prefetch_depth": prefetch.depth(),
                 "sync_cadence": self._sync_cadence(),
                 "optim_method": type(self.optim_method).__name__,
                 "device": str(self.device)}
        mesh = getattr(self, "mesh", None)
        if mesh is not None:
            flags["mesh"] = {k: int(v) for k, v in dict(mesh.shape).items()}
        return flags

    def _taps_supported(self) -> bool:
        """Whether this run's step can produce the taps (always here)."""
        return True

    def _start_obs_run(self):
        """A fresh taps monitor and the ``run_start`` event."""
        self._taps_monitor = obs_taps.TapsMonitor(self._taps_cadence,
                                                  self._taps_enabled)
        self._taps_on = self._taps_monitor.enabled and self._taps_supported()
        try:
            from bigdl_tpu_torch.obs import ledger as obs_ledger
            obs_ledger.maybe_start_sampler_from_env()
        except Exception:   # pragma: no cover - obs layer unavailable
            pass
        obs_events.emit("run_start", flags=self._obs_flags())
        return self._taps_monitor

    def _end_obs_run(self, state, wall_start):
        """The taps' tail (a short run still logs one sample), the phase
        breakdown and ``run_end``."""
        ev = obs_events.get()
        tail = self._taps_monitor.flush() if self._taps_monitor else None
        if ev is not None:
            self.spans.emit_phase_events(ev, int(state["neval"]))
            fields = {"steps": int(state["neval"]) - 1,
                      "wall": time.perf_counter() - wall_start}
            if tail:
                fields["taps"] = tail
            ev.emit("run_end", **fields)

    def _emit_step_event(self, neval, loss, lr, throughput, tap_vals,
                         **extra):
        """One ``step`` event and the TensorBoard scalars; ``tap_vals`` is
        the monitor's dict at a cadence boundary (None between)."""
        ev = obs_events.get()
        if ev is None and self._train_summary is None:
            return
        fields = dict(step=int(neval), loss=float(loss), lr=float(lr),
                      throughput=float(throughput))
        if tap_vals:
            fields["taps"] = tap_vals
        if self._nonfinite_skips:
            fields["skips"] = int(self._nonfinite_skips)
        fields.update(extra)
        if ev is not None:
            ev.emit("step", **fields)
        ts = self._train_summary
        if ts is not None:
            ts.add_scalar("Loss", loss, neval)
            ts.add_scalar("LearningRate", lr, neval)
            ts.add_scalar("Throughput", throughput, neval)
            if tap_vals:
                for k, v in tap_vals.items():
                    ts.add_scalar("Taps/" + k, v, neval)


def export_scalar(t: torch.Tensor) -> np.ndarray:
    """A scalar of an optimizer state (Adagrad's step) as the JAX state
    keeps it: a 0-d numpy array of its dtype."""
    return np.asarray(t.detach().cpu().numpy())


def resume_scalar(dst, value) -> bool:
    """Copy a checkpoint's scalar ``value`` into the state's 0-d tensor
    ``dst``; False where ``dst`` is a list of leaves."""
    if not isinstance(dst, torch.Tensor):
        return False
    with torch.no_grad():
        dst.copy_(torch.as_tensor(np.asarray(value)).to(dst.dtype))
    return True


def _fired_within(trig, state, n):
    """The first neval of this dispatch's (neval - n, neval] at which
    ``trig`` fires, or None: a periodic trigger is not skipped because
    neval moves n a dispatch.  Each probe is a copy of the state, and the
    trigger is probed once an iteration (a stateful one such as
    ``every_epoch`` too)."""
    if trig is None:
        return None
    neval = state["neval"]
    for ne in range(neval - n + 1, neval + 1):
        probe = T()
        probe.update(state)
        probe["neval"] = ne
        if trig(probe):
            return ne
    return None


def validate(model, dataset, methods, device, shard=None):
    """One pass over ``dataset`` in evaluation mode, without gradients
    (so a pool writes no argmax); returns ``[(method, merged result)]``
    (ref Validator.scala:24 / LocalValidator.scala:30); a method's
    result is None where no batch was evaluated.  ``shard=(r, n)``
    evaluates the batches i with i % n == r only (rank r's share of a
    data-parallel validation).  The batches ride a background prefetch
    thread with ``BIGDL_PREFETCH=1`` (else the calling thread; a chain
    that draws random numbers stays there too)."""
    device = torch.device(device)
    was_training = model.training
    model.eval()
    totals = [None] * len(methods)
    count, t0 = 0, time.perf_counter()
    batches = dataset.data(train=False)
    if prefetch.enabled() and not prefetch.has_stochastic_stage(dataset):
        batches = prefetch.background(batches, prefetch.depth())
    rank, n_shards = shard if shard is not None else (0, 1)
    try:
        with torch.no_grad():
            for i, batch in enumerate(batches):
                if i % n_shards != rank:
                    continue
                out = model(to_device(batch.data, device))
                count += int(np.asarray(batch.labels).shape[0])
                for i, m in enumerate(methods):
                    r = m(out, batch.labels)   # host-side compare: a sync
                    totals[i] = r if totals[i] is None else totals[i] + r
    finally:
        model.train(was_training)
    dt = time.perf_counter() - t0
    logger.info("validate model throughput is %.2f records / second "
                "(%d records in %.3fs)", count / max(dt, 1e-9), count, dt)
    return list(zip(methods, totals))


def distri_validate(model, dataset, methods, device="cuda", group=None):
    """Validation over the ranks of ``group`` (default: the world; ref
    DistriValidator.scala:32): each rank evaluates its share (its own
    records where ``dataset`` is a rank's shard, else every N-th batch,
    ``validate(..., shard=)``), then each method's (correct, count) or
    (loss, count) pair is summed over the group, in float64.  Without a
    process group, or in a world of one, ``validate`` itself."""
    import torch.distributed as dist

    from bigdl_tpu_torch.dataset.dataset import is_distributed_dataset

    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return validate(model, dataset, methods, device)
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    shard = None if is_distributed_dataset(dataset) else (rank, world)
    local = validate(model, dataset, methods, device, shard=shard)
    wire = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend(group) == "nccl" else torch.device("cpu")
    pairs = torch.tensor(
        [[0.0, 0.0] if r is None else
         [r.loss if isinstance(method, Loss) else r.correct, r.count]
         for method, r in local], dtype=torch.float64, device=wire)
    dist.all_reduce(pairs, group=group)
    merged = []
    for (method, r), (value, count) in zip(local, pairs.tolist()):
        if count == 0:
            merged.append((method, None))
        elif isinstance(method, Loss):
            merged.append((method, LossResult(value, int(count))))
        else:
            merged.append((method, AccuracyResult(int(round(value)),
                                                  int(count))))
    return merged
