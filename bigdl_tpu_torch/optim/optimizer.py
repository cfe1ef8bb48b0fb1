"""Optimizer factory (counterpart of bigdl_tpu/optim/optimizer.py; ref
optim/Optimizer.scala:30,151-186) and the checkpoint helpers.  The
factory picks the optimizer from the dataset, as the reference dispatches
on LocalDataSet against DistributedDataSet: a sharded dataset
(``DataSet.array(x, distributed=True)``, or ``training_rdd=``) trains
with a ``DistriOptimizer`` over the ranks, anything else with a
``LocalOptimizer``."""
from __future__ import annotations

import logging
import os

from bigdl_tpu_torch.dataset import prefetch
from bigdl_tpu_torch.dataset.dataset import is_distributed_dataset
from bigdl_tpu_torch.optim.distri_optimizer import DistriOptimizer
from bigdl_tpu_torch.optim.local_optimizer import LocalOptimizer
from bigdl_tpu_torch.utils import file as File
from bigdl_tpu_torch.utils import fs
from bigdl_tpu_torch.utils.random import RNG

logger = logging.getLogger("bigdl_tpu_torch.optim")


def Optimizer(model, dataset=None, criterion=None, *, training_rdd=None,
              optim_method=None, state=None, end_trigger=None,
              batch_size=None, device="cuda", **kwargs):
    """(ref Optimizer.apply :151-186) — a ``DistriOptimizer`` for a
    sharded dataset (``kwargs`` go to it: ``mesh``, ``zero1``,
    ``gradient_compression``, ``drop_percentage``), else a
    ``LocalOptimizer``, on ``device`` (the card unless the caller asks
    for the CPU), with the optional method, state Table and end trigger
    already set.  The reference's Python-API keywords too:
    ``Optimizer(model=..., training_rdd=samples, criterion=...,
    batch_size=b)`` shards the samples and batches them."""
    if training_rdd is not None:
        from bigdl_tpu_torch.dataset.dataset import DataSet
        from bigdl_tpu_torch.dataset.transformer import SampleToBatch
        if batch_size is None:
            raise ValueError("batch_size is required with training_rdd")
        dataset = (DataSet.array(list(training_rdd), distributed=True)
                   >> SampleToBatch(batch_size, drop_last=True))
    if is_distributed_dataset(dataset):
        opt = DistriOptimizer(model, dataset, criterion, device=device,
                              **kwargs)
    elif kwargs:
        raise TypeError(f"Optimizer: {sorted(kwargs)} apply to a sharded "
                        f"dataset only")
    else:
        opt = LocalOptimizer(model, dataset, criterion, device=device)
    if optim_method is not None:
        opt.set_optim_method(optim_method)
    if state is not None:
        opt.set_state(state)
    if end_trigger is not None:
        opt.set_end_when(end_trigger)
    return opt


# ---------------------------------------------------------------------------
# checkpoints: ``model.N`` / ``state.N`` pairs under one directory, each
# file beside its CRC32 sidecar (utils/file.py)
# ---------------------------------------------------------------------------

ENV_KEEP = "BIGDL_CKPT_KEEP"


def keep_count() -> int:
    """``BIGDL_CKPT_KEEP``: keep the newest N snapshots (0, the default:
    all)."""
    try:
        return max(0, int(os.environ.get(ENV_KEEP, "0")))
    except ValueError:
        return 0


def list_checkpoints(path) -> list:
    """The labels N of the ``model.N`` / ``state.N`` pairs under
    ``path``, newest first; a ``model.N`` without its ``state.N`` (a crash
    between the two writes) is no snapshot."""
    try:
        names = fs.listdir(path)
    except OSError:
        return []

    def labels(prefix):
        return {int(f[len(prefix):]) for f in names
                if f.startswith(prefix) and f[len(prefix):].isdigit()}

    return sorted(labels("model.") & labels("state."), reverse=True)


def load_latest_checkpoint(path, restore_rng: bool = False, device="cuda",
                           dataset=None):
    """The newest valid snapshot under ``path``: ``(module on device,
    state blob, N)``, or None when there is none.

    The pairs are read newest first; a pair whose bytes fail their CRC
    sidecar or that does not load is logged and skipped for the next
    older one.  ``restore_rng=True`` also restores the random payload:
    the dropout generators and, given the ``dataset`` the run resumes
    on, its host stream (the shuffles, crops and flips) and the shuffled
    order of its records, so the resumed run draws what the
    uninterrupted one drew."""
    for neval in list_checkpoints(path):
        try:
            module = File.load_module(fs.join(path, f"model.{neval}"),
                                      device=device)
            blob = File.load(fs.join(path, f"state.{neval}"))
        except Exception as e:
            logger.warning("resume: snapshot %d under %s does not load "
                           "(%s): trying an older one", neval, path, e)
            continue
        if restore_rng and blob.get("rng") is not None:
            if dataset is None:
                RNG.restore(blob["rng"])
            else:
                prefetch.host_restore(blob["rng"], dataset)
        logger.info("resume: loaded snapshot %d from %s", neval, path)
        return module, blob, neval
    return None


def snapshot_files(path, neval) -> list:
    """The files of snapshot ``neval``: model, state and their
    sidecars."""
    try:
        names = fs.listdir(path)
    except OSError:
        return []
    stems = (f"model.{neval}", f"state.{neval}")
    return [f for f in names if f in stems
            or (f.endswith(File.CRC_SUFFIX)
                and f[:-len(File.CRC_SUFFIX)] in stems)]


def snapshot_valid(path, neval) -> bool:
    """Whether both files of snapshot ``neval`` pass their CRC check."""
    files = [f for f in snapshot_files(path, neval)
             if not f.endswith(File.CRC_SUFFIX)]
    return len(files) == 2 and all(File.verify(fs.join(path, f))
                                   for f in files)


def prune_checkpoints(path, keep: int, just_written=None) -> list:
    """Keep the newest ``keep`` snapshots and delete the older ones, but
    never the newest valid one (a corrupt newest snapshot must not leave
    nothing to resume from).  ``just_written``: the label the caller has
    just written and checked, which spares the CRC scan when it is the
    newest.  A failed delete is logged, not raised.  Returns the names
    removed."""
    keep = int(keep or 0)
    labels = list_checkpoints(path)
    if keep <= 0 or len(labels) <= keep:
        return []
    if just_written is not None and int(just_written) == labels[0]:
        newest_valid = labels[0]
    else:
        newest_valid = next((n for n in labels if snapshot_valid(path, n)),
                            None)
    removed = []
    for n in labels[keep:]:
        if n == newest_valid:
            continue
        for f in snapshot_files(path, n):
            try:
                os.remove(fs.join(path, f))
                removed.append(f)
            except OSError as e:
                logger.warning("checkpoint retention: could not remove "
                               "%s: %s", f, e)
    return removed


def save_model(model, path, overwrite: bool = False):
    """(ref Optimizer.saveModel; refuses to overwrite unless asked)"""
    File.save_module(model, path, overwrite=overwrite)
    return path


def save_state(state, path, overwrite: bool = False):
    """(ref Optimizer.saveState; refuses to overwrite unless asked)"""
    File.save(state, path, overwrite=overwrite)
    return path
