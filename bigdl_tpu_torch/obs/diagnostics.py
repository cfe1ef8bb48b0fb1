"""Crash diagnostics: dump a postmortem bundle on the way down
(counterpart of bigdl_tpu/obs/diagnostics.py, the same file set).

The failure paths — the non-finite-gradient abort threshold here, and
a watchdog's peer-death exit or a SIGTERM preemption where they run —
end a run from code that knows WHY; ``dump_crash_bundle`` turns the last
moments into a directory an operator (or the next CI run) can read:

    crash-<reason>-p<proc>-<pid>/
      reason.txt     what tripped, free text
      events.jsonl   the event ring buffer's last N events (obs/events)
      memory.json    per-card allocator stats (utils/profiler)
      config.json    BIGDL_* / TORCH_* / CUDA_* env, torch and CUDA
                     versions, the card's name, the world size
      threads.txt    Python stack of every live thread (where was the
                     main thread blocked? usually: inside a dead
                     collective)
      extra.json     caller-provided context (straggler window, streak)

Every step is individually best-effort: a diagnostics bug must never
mask the real failure, so this function cannot raise.
"""
from __future__ import annotations

import json
import logging
import os
import sys
import tempfile
import time
import traceback

logger = logging.getLogger("bigdl_tpu_torch.obs")


def _resolve_dir(run_dir):
    if run_dir:
        return run_dir
    from bigdl_tpu_torch.obs import events as events_mod
    log = events_mod.get()
    if log is not None and log.run_dir:
        return log.run_dir
    env = os.environ.get(events_mod.ENV_DIR, "").strip()
    if env:
        return env
    return tempfile.mkdtemp(prefix="bigdl_obs_")


def thread_stacks() -> str:
    """Python stack of every live thread — the one artifact that tells a
    hung-collective death from a data-loader deadlock."""
    import threading
    names = {t.ident: t.name for t in threading.enumerate()}
    parts = []
    for ident, frame in sorted(sys._current_frames().items()):
        parts.append(f"--- thread {names.get(ident, '?')} ({ident}) ---")
        parts.append("".join(traceback.format_stack(frame)))
    return "\n".join(parts)


def config_snapshot() -> dict:
    """Env flags + versions + topology: enough to reproduce the run's
    configuration from the bundle alone."""
    snap = {"argv": list(sys.argv),
            "python": sys.version.split()[0],
            "cwd": os.getcwd(),
            "env": {k: v for k, v in sorted(os.environ.items())
                    if k.startswith(("BIGDL_", "TORCH_", "CUDA_"))}}
    try:
        import torch
        snap["torch"] = torch.__version__
        snap["cuda"] = torch.version.cuda
        snap["device"] = (torch.cuda.get_device_name(0)
                          if torch.cuda.is_available() else "cpu")
        import torch.distributed as dist
        up = dist.is_available() and dist.is_initialized()
        snap["rank"] = dist.get_rank() if up else 0
        snap["world_size"] = dist.get_world_size() if up else 1
    except Exception as e:
        snap["torch"] = f"unavailable: {e!r}"
    return snap


def _write(path, write_fn):
    try:
        with open(path, "w") as f:
            write_fn(f)
    except Exception as e:  # pragma: no cover - disk-full territory
        logger.warning("crash bundle: %s failed: %s", path, e)


def dump_crash_bundle(reason: str, run_dir: str | None = None,
                      extra: dict | None = None,
                      texts: dict | None = None) -> str | None:
    """Write the bundle; returns its path (None only if even the
    directory could not be created).  Safe from signal handlers and
    daemon threads; never raises.  ``texts`` maps extra filenames to
    raw text bodies (e.g. a dead replica's ``stderr.txt`` tail)."""
    try:
        from bigdl_tpu_torch.obs import events as events_mod
        if not events_mod.enabled():
            # BIGDL_OBS=0 is the documented hard-off switch: no stray
            # temp directories from abort/preemption/watchdog paths
            logger.info("crash bundle skipped: obs disabled (%s)", reason)
            return None
        base = _resolve_dir(run_dir)
        log = events_mod.get()
        proc = log.process_index() if log is not None else 0
        slug = "".join(c if c.isalnum() or c in "-_" else "-"
                       for c in reason)[:48]
        path = os.path.join(base, f"crash-{slug}-p{proc}-{os.getpid()}")
        os.makedirs(path, exist_ok=True)
    except Exception as e:
        logger.error("crash bundle: could not create directory: %s", e)
        return None

    # the bundle's own event first, so it rides the ring dump below and
    # the surviving JSONL stream points at the directory
    if log is not None:
        log.emit("crash_bundle", reason=reason, path=path)

    _write(os.path.join(path, "reason.txt"),
           lambda f: f.write(f"{reason}\nat {time.strftime('%Y-%m-%dT%H:%M:%S')}\n"))
    if log is not None:
        _write(os.path.join(path, "events.jsonl"), lambda f: f.writelines(
            json.dumps(e, default=events_mod._jsonable) + "\n"
            for e in log.ring_events()))
    _write(os.path.join(path, "threads.txt"),
           lambda f: f.write(thread_stacks()))
    _write(os.path.join(path, "config.json"),
           lambda f: json.dump(config_snapshot(), f, indent=1, default=repr))
    try:
        from bigdl_tpu_torch.utils.profiler import device_memory_stats
        stats = device_memory_stats()
    except Exception as e:
        stats = {"unavailable": repr(e)}
    _write(os.path.join(path, "memory.json"),
           lambda f: json.dump(stats, f, indent=1, default=repr))
    if extra:
        _write(os.path.join(path, "extra.json"),
               lambda f: json.dump(extra, f, indent=1, default=repr))
    for fname, body in (texts or {}).items():
        _write(os.path.join(path, os.path.basename(fname)),
               lambda f, b=body: f.write(b))
    logger.error("crash bundle written: %s (%s)", path, reason)
    return path
