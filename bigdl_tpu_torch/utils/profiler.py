"""Profiling utilities (counterpart of bigdl_tpu/utils/profiler.py; SURVEY.md
§5.1).

The reference stacks per-module wall-clock timers (AbstractModule
forwardTime / backwardTime), phase metrics (optim/Metrics.scala) and
throughput logs; those exist here too (``Module.forward_time``,
``optim.Metrics``).  This module adds the device layer: ``torch.profiler``
traces, and named host ranges that show up in every trace the profiler
takes (``record_function``) and, on the card, as NVTX ranges.
"""
from __future__ import annotations

from contextlib import contextmanager, nullcontext

import torch

_ACTIVE: list = []


def start_trace(log_dir: str):
    """Begin a device trace; ``stop_trace`` writes it under ``log_dir`` as
    a Chrome trace (``trace.json``) that TensorBoard's profile plugin and
    Perfetto open."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    _ACTIVE.append((prof, log_dir))
    return prof


def stop_trace():
    if not _ACTIVE:
        return None
    prof, log_dir = _ACTIVE.pop()
    prof.__exit__(None, None, None)
    import os
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    return prof


@contextmanager
def trace(log_dir: str):
    prof = start_trace(log_dir)
    try:
        yield prof
    finally:
        stop_trace()


def _nvtx(name: str):
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        return torch.cuda.nvtx.range(name)
    return nullcontext()


@contextmanager
def step_annotation(name: str):
    """Annotate a step's host range so that it is found in the trace."""
    with torch.profiler.record_function(f"step:{name}"), _nvtx(name):
        yield


@contextmanager
def annotation(name: str):
    """A named host range: the phase spans (``obs/spans.py``) run under it,
    so that data-load, dispatch and validate carry the event log's names
    in a device trace."""
    with torch.profiler.record_function(name), _nvtx(name):
        yield


def device_memory_stats():
    """Each visible card's allocator statistics (``torch.cuda
    .memory_stats``: ``bytes_in_use``, ``peak_bytes_in_use`` and
    ``bytes_limit`` added under the JAX names); on a host with no card one
    ``"cpu": None`` entry."""
    if not torch.cuda.is_available():
        return {"cpu": None}
    stats = {}
    for i in range(torch.cuda.device_count()):
        name = f"cuda:{i}"
        try:
            st = dict(torch.cuda.memory_stats(i))
            st["bytes_in_use"] = int(st.get("allocated_bytes.all.current", 0))
            st["peak_bytes_in_use"] = int(
                st.get("allocated_bytes.all.peak", 0))
            st["bytes_limit"] = int(
                torch.cuda.get_device_properties(i).total_memory)
            stats[name] = st
        except Exception:
            stats[name] = None
    return stats


def format_module_times(model, top_n: int = 20) -> str:
    """Per-module forward / backward table (ref Container.getTimes
    Container.scala:71-78)."""
    rows = sorted(model.get_times(), key=lambda r: -(r[1] + r[2]))[:top_n]
    lines = [f"{'module':<40} {'fwd_s':>10} {'bwd_s':>10}"]
    for mod, fwd, bwd in rows:
        name = (mod.get_name() if hasattr(mod, "get_name")
                else type(mod).__name__)
        lines.append(f"{name:<40} {fwd:>10.4f} {bwd:>10.4f}")
    return "\n".join(lines)
