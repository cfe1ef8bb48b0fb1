"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into its own shared library, loaded with ``ctypes`` (no PyTorch headers,
so a build takes seconds).  Builds run at first use, land in
``bigdl_tpu_torch/build/`` and are cached by a hash of the source, the
local headers it includes (``#include "..."``, followed through the
headers they include) and the flags; :func:`build` starts one ``nvcc``
per missing library, all at once.  :func:`start` starts them without
waiting, so that a program runs on the first libraries while the slower
ones compile: :func:`load` (and :func:`build`) of a library waits for its
own ``nvcc``.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
#: kernel name -> source file under csrc/
SOURCES = {"paged_attention": "paged_attention.cu",
           "fused_sgd": "fused_sgd.cu",
           "maxpool2d": "maxpool2d.cu",
           "maxpool2d_s1": "maxpool2d_s1.cu",
           "lrn": "lrn.cu",
           "bilstm": "bilstm.cu",
           "rnn": "rnn.cu",
           "rnn_bf16": "rnn_bf16.cu",
           "gru": "gru.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}
# name -> (nvcc process, temporary output, output, start time) of the
# builds start() began and no one has waited for yet
_PENDING: dict = {}


def build_dir() -> Path:
    return _PKG / "build"


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                       "kernels are built from source at first use")


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def sources(name: str) -> list:
    """The files a kernel's library is built from: its source, then every
    local header it includes, directly or through another header, in the
    order first met."""
    files, todo = [], [CSRC / SOURCES[name]]
    while todo:
        path = todo.pop(0)
        if path in files:
            continue
        files.append(path)
        todo += [path.parent / inc.decode()
                 for inc in _LOCAL_INCLUDE.findall(path.read_bytes())]
    return files


def target(name: str) -> Path:
    digest = hashlib.sha256()
    for path in sources(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{digest.hexdigest()[:16]}.so"


def start(names=None) -> None:
    """Start one ``nvcc`` for every missing library of ``names`` (default:
    all) that is not compiling yet, and return without waiting."""
    names = list(SOURCES) if names is None else list(names)
    build_dir().mkdir(parents=True, exist_ok=True)
    for name in names:
        out = target(name)
        if out.exists() or name in _PENDING:
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        _PENDING[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True),
                          tmp, out, time.perf_counter())


def build(names=None) -> dict:
    """Compile every missing library of ``names`` (default: all) in
    parallel, waiting for those :func:`start` began.  Returns ``{name:
    {"seconds": s, "log": nvcc output}}`` for the ones built now; raises
    with the compiler's output on failure."""
    names = list(SOURCES) if names is None else list(names)
    start(names)
    built, failed = {}, []
    for name in names:
        if name not in _PENDING:
            continue
        proc, tmp, out, t0 = _PENDING.pop(name)
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(log)
        built[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return built


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = _LIBS[name] = ctypes.CDLL(str(target(name)))
    return lib


def device_stream(dev: torch.device) -> tuple:
    """(device index, current stream handle) of a CUDA device, as every
    kernel's C entry point takes them."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return index, torch.cuda.current_stream(dev).cuda_stream


#: the forms of a kernel that has an f32 and a bf16 one, by dtype
FORMS = {torch.float32: "f32", torch.bfloat16: "bf16"}


def form_entry(kernel: str, which: str, dtype: torch.dtype) -> str:
    """The C entry ``bigdl_<kernel>_<which>_<form>`` of the form for
    ``dtype``; a ``TypeError`` where the kernel has none."""
    if dtype not in FORMS:
        raise TypeError(f"{kernel}: no kernel for {dtype}; the kernels "
                        f"take {', '.join(map(str, FORMS))}")
    return f"bigdl_{kernel}_{which}_{FORMS[dtype]}"


def count_launch(wrapper, dtype: torch.dtype) -> None:
    """One more launch of ``wrapper``'s kernel: its bf16 form's count
    (``launches_bf16``) for a bf16 launch, else ``launches``."""
    if dtype == torch.bfloat16:
        wrapper.launches_bf16 += 1
    else:
        wrapper.launches += 1
