"""Start N ranks of one program on this host (the counterpart of how
tests/test_multiprocess.py starts its JAX processes).

``launch(fn, world_size, backend, args, store_dir)`` spawns
``world_size`` processes with the ``spawn`` start method (a fork after
CUDA's initialisation breaks), forms a process group in each over a
``FileStore`` in ``store_dir`` (no TCP port to race for when test
workers run side by side), runs ``fn(*args)`` and returns each rank's
result, rank 0 first.  On the CPU each child keeps one intra-op thread:
several workers of four ranks each would otherwise oversubscribe the
cores.  A child's exception is raised again in the parent, noted with
its rank and traceback.  ``fn`` and its arguments and results cross
process boundaries by pickling: ``fn`` is a module-level function.

torchrun is the other way to start ranks: ``torchrun --nproc_per_node G
script.py`` sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``
and ``MASTER_PORT``, which ``Engine.init_distributed`` reads.
"""
from __future__ import annotations

import os
import pickle
import queue as queue_mod
import tempfile
import time
import traceback

import torch
import torch.multiprocessing as mp


class RankError(RuntimeError):
    """A rank failed with an exception that does not pickle."""

    def __init__(self, rank: int, message: str):
        super().__init__(f"rank {rank}: {message}")
        self.rank = rank


def _child(rank, world_size, backend, store_path, fn, args, out):
    from bigdl_tpu_torch.utils.engine import Engine

    try:
        if backend == "gloo":
            torch.set_num_threads(1)
        import torch.distributed as dist

        store = dist.FileStore(store_path, world_size)
        Engine.init_distributed(
            device="cuda" if backend == "nccl" else "cpu", backend=backend,
            store=store, rank=rank, world_size=world_size, local_rank=rank)
        try:
            out.put((rank, True, pickle.dumps(fn(*args)), None))
        finally:
            Engine.reset()
    except BaseException as e:   # reported to the parent, which raises
        try:
            blob = pickle.dumps(e)
        except Exception:
            blob = None
        out.put((rank, False, blob, traceback.format_exc()))


#: seconds the parent waits for every rank's result
TIMEOUT_S = 1800.0


def launch(fn, world_size: int, backend: str, args=(),
           store_dir=None) -> list:
    """``fn(*args)`` on ``world_size`` ranks of one process group;
    returns their results by rank.  ``backend`` has no default: "nccl"
    (one card a rank, ``cuda:{rank}``) or "gloo" (the CPU)."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', got "
                         f"{backend!r}")
    if backend == "nccl" and torch.cuda.device_count() < world_size:
        raise ValueError(f"{world_size} NCCL ranks need as many cards, "
                         f"have {torch.cuda.device_count()}")
    ctx = mp.get_context("spawn")
    own_dir = store_dir is None
    store_dir = tempfile.mkdtemp() if own_dir else str(store_dir)
    os.makedirs(store_dir, exist_ok=True)
    store_path = os.path.join(store_dir, f"store-{os.getpid()}-"
                                         f"{time.monotonic_ns()}")
    out = ctx.Queue()
    procs = [ctx.Process(target=_child, args=(
        r, world_size, backend, store_path, fn, tuple(args), out),
        daemon=True) for r in range(world_size)]
    for p in procs:
        p.start()
    results, failure = {}, None
    deadline = time.monotonic() + TIMEOUT_S
    try:
        while len(results) < world_size and failure is None:
            try:
                rank, ok, blob, tb = out.get(timeout=1.0)
            except queue_mod.Empty:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"launch: {world_size - len(results)}"
                                       f" ranks still running after "
                                       f"{TIMEOUT_S} s")
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    raise RankError(dead[0], f"exited with code "
                                    f"{procs[dead[0]].exitcode}")
                continue
            if ok:
                results[rank] = pickle.loads(blob)
            else:
                failure = (rank, blob, tb)
    finally:
        for p in procs:
            p.join(timeout=10 if failure is None else 2)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        if own_dir:
            import shutil
            shutil.rmtree(store_dir, ignore_errors=True)
    if failure is not None:
        rank, blob, tb = failure
        try:
            exc = pickle.loads(blob) if blob is not None else None
        except Exception:
            exc = None
        if not isinstance(exc, BaseException):
            exc = RankError(rank, tb.strip().splitlines()[-1])
        exc.add_note(f"raised on rank {rank} of {world_size}:\n{tb}")
        raise exc
    return [results[r] for r in range(world_size)]
