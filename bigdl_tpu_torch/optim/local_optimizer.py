"""LocalOptimizer — single-host training (counterpart of
bigdl_tpu/optim/local_optimizer.py; ref optim/LocalOptimizer.scala:40).

Each iteration fetches a batch on the host, copies it to the device
(pinned, non-blocking), runs forward, criterion and backward, then the
OptimMethod's update in place, with the scheduled lr as a host float.
What the JAX loop keeps, this one keeps:

- epoch and ``neval`` accounting in a state ``Table`` under the
  reference's keys, and the scheduled lr;
- the non-finite skip: the step's finite flag (loss and every gradient)
  stays on the device, and the update leaves params and velocity as they
  were when it is False;
- the host-sync window: loss and finite flag are read in one batch at
  the sync cadence, at an epoch rollover, when a trigger fires and at
  the run's end — the loop's only device-to-host reads;
- validation at its trigger, and the end trigger.

Not ported yet: checkpoints, taps and summaries, fault drills, the
background prefetch threads, several iterations per dispatch (only
``set_iterations_per_dispatch(1)``) and gradient checkpointing.
"""
from __future__ import annotations

import logging
import time

import numpy as np
import torch

from bigdl_tpu_torch.optim import trigger as triggers
from bigdl_tpu_torch.optim.metrics import Metrics
from bigdl_tpu_torch.optim.optim_method import SGD, Default, OptimMethod
from bigdl_tpu_torch.utils.device import pin_fp32, resolve_device
from bigdl_tpu_torch.utils.table import T, Table

logger = logging.getLogger("bigdl_tpu_torch.optim")
#: iterations between host reads of loss and finite flag (the JAX
#: package's default taps cadence)
SYNC_CADENCE = 10


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


class _PendingStep:
    """One dispatched but not yet read iteration: its device scalars and
    the host bookkeeping taken at dispatch."""

    __slots__ = ("neval0", "epoch", "count", "loss", "finite", "lr",
                 "records", "fetch_t", "train_t")

    def __init__(self, neval0, epoch, count, loss, finite, lr, records,
                 fetch_t, train_t):
        self.neval0 = neval0
        self.epoch = epoch
        self.count = count
        self.loss = loss
        self.finite = finite
        self.lr = lr
        self.records = records
        self.fetch_t = fetch_t
        self.train_t = train_t


class _HostSyncWindow:
    """Cadence-gated device-to-host reads of the loop: each step's loss
    and finite flag wait here and are read in one copy once ``cadence``
    iterations have begun since the last read (or at a boundary)."""

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

    def flush(self):
        """Read every pending step in one device-to-host copy.  Returns
        (entries, losses, finites, window wall seconds)."""
        entries, self.pending = self.pending, []
        both = torch.stack([
            torch.stack([e.loss.float() for e in entries]),
            torch.stack([e.finite for e in entries]).float()]).cpu()
        wall = (time.perf_counter() - self._t0) if self._t0 else 0.0
        self._t0 = None
        self._last_flush = entries[-1].neval0
        return entries, both[0].numpy(), both[1].numpy() != 0, wall


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
        self.metrics = Metrics()
        # skip a non-finite step (params and velocity keep their values),
        # count it, abort after this many in a row (0: never)
        self.nonfinite_abort = 10
        self._nonfinite_skips = 0
        self._nonfinite_streak = 0
        self._window = None
        #: device-to-host reads of the training loop (window flushes)
        self.host_syncs = 0
        #: (neval, loss) of every step, as flushed
        self.loss_log: list = []
        #: (neval, epoch, {method: value}) of every validation
        self.validation_log: list = []

    # -- builder config (ref Optimizer.scala:66-124) ----------------------
    def set_state(self, state: Table):
        self.state.update(state)
        return self

    def set_optim_method(self, method: OptimMethod):
        self.optim_method = method
        return self

    def set_end_when(self, end_when):
        self.end_when = end_when
        return self

    def set_validation(self, trigger, dataset, methods):
        self.validation_trigger = trigger
        self.validation_dataset = dataset
        self.validation_methods = methods
        return self

    def set_iterations_per_dispatch(self, n: int):
        """One iteration a dispatch, as the JAX loop's default; several
        (the JAX ``lax.scan`` of n steps) are not ported yet: a CUDA graph
        of n steps comes with ROADMAP slice 2b."""
        if int(n) > 1:
            raise NotImplementedError(
                f"set_iterations_per_dispatch({n}): several iterations a "
                f"dispatch are not ported yet (a CUDA graph of the steps, "
                f"ROADMAP slice 2b); use 1")
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
            "lr_scales": s.get("learningRates", None),
        }

    def _current_lr(self):
        schedule = self.state.get("learningRateSchedule", Default())
        schedule.update_hyper_parameter(self.state, self.state)
        return -self.state.get("currentLearningRate",
                               -self.state.get("learningRate", 1e-3))

    # -- one step ------------------------------------------------------------
    def _train_step(self, params, opt_state, x, y, hyper):
        # the gradients persist across steps, zeroed in place and
        # accumulated into by autograd, so the SGD kernel's leaf table,
        # built at the first step, serves every later one
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        torch._foreach_zero_([p.grad for p in params])
        loss = self.criterion(self.model(x), y)
        loss.backward()
        grads = [p.grad for p in params]
        loss = loss.detach()
        finite = _finite_all(loss, grads)
        self.optim_method.update(grads, opt_state, params, hyper,
                                 finite=finite)
        return loss, finite

    # -- main loop (ref LocalOptimizer.optimize :77) ----------------------
    def optimize(self):
        state = self.state
        state.get_or_update("epoch", 1)
        state.get_or_update("neval", 1)
        pin_fp32(self.device)
        self.model.to(self.device).train()
        params = list(self.model.parameters())
        opt_state = self.optim_method.init_state(params)

        count = 0
        epoch_size = self.dataset.size()
        data_iter = self.dataset.data(train=True)
        self._window = _HostSyncWindow(SYNC_CADENCE)
        wall_start = time.perf_counter()
        try:
            while not self.end_when(state):
                neval0 = int(state["neval"])
                epoch0 = int(state["epoch"])
                self._window.arm()
                fetch_start = time.perf_counter()
                batch = next(data_iter)
                x = to_device(batch.data, self.device)
                y = to_device(batch.labels, self.device)
                fetch_time = time.perf_counter() - fetch_start

                train_start = time.perf_counter()
                lr = self._current_lr()
                loss, finite = self._train_step(params, opt_state, x, y,
                                                self._hyper(lr))
                train_time = time.perf_counter() - train_start

                b = x.shape[0]
                count += b
                state["neval"] = neval0 + 1
                state["evalCounter"] = state.get("evalCounter", 0) + 1
                self.metrics.add("data fetch time", fetch_time)
                self.metrics.add("train time", train_time)
                self._window.push(_PendingStep(
                    neval0, epoch0, count, loss, finite, lr, b, fetch_time,
                    train_time))

                rolled = count >= epoch_size
                if rolled:
                    state["epoch"] = state["epoch"] + 1
                    count = 0
                    self.dataset.shuffle()
                    data_iter = self.dataset.data(train=True)
                if self._window.due() or rolled:
                    self._flush_window(state, "epoch" if rolled
                                       else "cadence")
                if (self.validation_trigger is not None
                        and self.validation_trigger(state)):
                    self._flush_window(state, "trigger")
                    self._validate(state)
            self._flush_window(state, "run-end")
        finally:
            try:
                # an exception between flushes must not lose the steps
                # already run; a no-op after a clean run-end flush
                self._flush_window(state, "exception")
            except Exception as e:
                logger.warning("pending-step flush during unwind failed: "
                               "%s", e)
        logger.info("Training finished in %.1fs",
                    time.perf_counter() - wall_start)
        return self.model

    def _flush_window(self, state, reason: str):
        w = self._window
        if w is None or not w.pending:
            return
        entries, losses, finites, wall = w.flush()
        self.host_syncs += 1
        rate = sum(e.records for e in entries) / max(wall, 1e-9)
        epoch_size = self.dataset.size()
        abort = None
        for e, loss, ok in zip(entries, losses, finites):
            state["loss"] = float(loss)
            self.loss_log.append((e.neval0, float(loss)))
            logger.info(
                "Epoch %d %d/%d loss %.6f lr %.5g throughput %.1f "
                "records/s (fetch %.4fs dispatch %.4fs, synced %s)",
                e.epoch, e.count, epoch_size, float(loss), e.lr, rate,
                e.fetch_t, e.train_t, reason)
            if abort is None:
                try:
                    self._note_finite(bool(ok), state)
                except NonFiniteGradError as exc:
                    abort = exc  # log the remaining steps first
        if abort is not None:
            raise abort

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
            raise NonFiniteGradError(
                f"{self._nonfinite_streak} consecutive non-finite-gradient "
                f"steps (threshold {self.nonfinite_abort}, iteration "
                f"{int(state['neval'])}): the loss has diverged")

    # -- validation (ref LocalOptimizer.scala:196-242) --------------------
    def _validate(self, state):
        with self.metrics.timer("validate"):
            results = validate(self.model, self.validation_dataset,
                               self.validation_methods, self.device)
        values = {}
        for method, result in results:
            logger.info("%s is %s", method, result)
            values[str(method)] = state[str(method)] = result.result()[0]
        self.validation_log.append((int(state["neval"]), int(state["epoch"]),
                                    values))


def validate(model, dataset, methods, device):
    """One pass over ``dataset`` in evaluation mode, without gradients
    (so a pool writes no argmax); returns ``[(method, merged result)]``
    (ref Validator.scala:24 / LocalValidator.scala:30)."""
    device = torch.device(device)
    was_training = model.training
    model.eval()
    totals = [None] * len(methods)
    count, t0 = 0, time.perf_counter()
    try:
        with torch.no_grad():
            for batch in dataset.data(train=False):
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
