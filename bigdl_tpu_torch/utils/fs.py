"""Filesystem helpers of the checkpoints (counterpart of
bigdl_tpu/utils/fs.py).

Local paths only: the port has no fsspec, so a URL (``gs://``, ``s3://``,
...) raises.  Writes are atomic: the bytes go to a temporary file beside
the target, which is then renamed over it, so a crashed writer never
leaves a torn file under the target's name.
"""
from __future__ import annotations

import logging
import os
import time

logger = logging.getLogger("bigdl_tpu_torch.utils")


def is_url(path) -> bool:
    return isinstance(path, str) and "://" in path


def _local(path) -> str:
    path = os.fspath(path)
    if is_url(path):
        raise ValueError(f"{path}: the port reads and writes local paths "
                         f"only (no fsspec)")
    return path


def exists(path) -> bool:
    return os.path.exists(_local(path))


def makedirs(path):
    if path:
        os.makedirs(_local(path), exist_ok=True)


def listdir(path) -> list:
    """The names in a directory, sorted."""
    return sorted(os.listdir(_local(path)))


def join(base, *parts) -> str:
    return os.path.join(_local(base), *parts)


def open_file(path, mode: str = "rb"):
    return open(_local(path), mode)


def read_bytes(path) -> bytes:
    with open(_local(path), "rb") as f:
        return f.read()


def write_bytes_atomic(path, data: bytes, attempts: int = 3,
                       backoff: float = 0.1):
    """Write ``data`` to ``path`` through a temporary file and a rename,
    retrying an OSError ``attempts`` times with doubling waits before it
    propagates."""
    path = _local(path)
    for attempt in range(max(int(attempts), 1)):
        try:
            makedirs(os.path.dirname(os.path.abspath(path)))
            tmp = f"{path}.{os.getpid()}.tmp"
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, path)
            return
        except OSError as e:
            if attempt == attempts - 1:
                raise
            delay = backoff * (2 ** attempt)
            logger.warning("write %s failed (%s); retry %d/%d in %.2fs",
                           path, e, attempt + 1, attempts - 1, delay)
            time.sleep(delay)
