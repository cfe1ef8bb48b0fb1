"""Model and state persistence (counterpart of bigdl_tpu/utils/file.py;
ref utils/File.scala:27).

A snapshot is a pickle of numpy-converted trees beside a CRC32 sidecar
(``path + ".crc32"``: the payload's crc32 in hex and its length), the
JAX package's format, readable in both directions:

- a module file (:func:`save_module`) holds ``params`` in the JAX tree
  layout (``nn.module.export_params``), so
  ``bigdl_tpu.utils.file.load_module_into`` reads a port file, and an
  ``architecture``: the port's own pickled module, its tensors left on
  the meta device (the values live once, in ``params``);
  :func:`load_module` rebuilds only a port architecture and points a
  JAX file to :func:`load_module_into`;
- :func:`load` maps the JAX package's ``Table`` and learning-rate
  schedules onto the port's classes by name (``_Unpickler.find_class``),
  without importing the JAX package; any other class of that package
  raises.
"""
from __future__ import annotations

import importlib
import io
import pickle
import zlib

import torch

from bigdl_tpu_torch.utils import fs

CRC_SUFFIX = ".crc32"
FORMAT = "bigdl_tpu.module.v2"
PACKAGE = "bigdl_tpu_torch"
#: classes of the JAX package read as the port's: (module, name) -> module
_FROM_JAX = {("bigdl_tpu.utils.table", "Table"): "bigdl_tpu_torch.utils.table"}
_FROM_JAX.update({
    ("bigdl_tpu.optim.optim_method", name): "bigdl_tpu_torch.optim.optim_method"
    for name in ("LearningRateSchedule", "Default", "Step", "Poly",
                 "EpochDecay", "EpochStep", "EpochSchedule",
                 "EpochSchedule.Regime")})


class ChecksumError(ValueError):
    """A snapshot's bytes do not match their CRC32 sidecar (bit rot, a
    partial write): the snapshot must not be trusted."""


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == "bigdl_tpu" or module.startswith("bigdl_tpu."):
            port = _FROM_JAX.get((module, name))
            if port is None:
                raise pickle.UnpicklingError(
                    f"{module}.{name}: a class of the JAX package with no "
                    f"counterpart the port reads (only its Table and "
                    f"learning-rate schedules map onto the port's)")
            obj = importlib.import_module(port)
            for part in name.split("."):
                obj = getattr(obj, part)
            return obj
        return super().find_class(module, name)


def _loads(data: bytes):
    return _Unpickler(io.BytesIO(data)).load()


def _crc_path(path) -> str:
    return str(path) + CRC_SUFFIX


def _verify_bytes(path, data: bytes):
    """Raise ChecksumError if ``path``'s sidecar disagrees with ``data``;
    a snapshot without a sidecar passes (unpickling is its only check)."""
    sc = _crc_path(path)
    if not fs.exists(sc):
        return
    try:
        want_crc_hex, want_len = fs.read_bytes(sc).split()
        want_crc, want_len = int(want_crc_hex, 16), int(want_len)
    except (ValueError, OSError) as e:
        raise ChecksumError(f"{path}: unreadable CRC sidecar {sc}: {e}")
    got_crc = zlib.crc32(data)
    if len(data) != want_len or got_crc != want_crc:
        raise ChecksumError(
            f"{path}: checksum mismatch: the sidecar says crc32 "
            f"{want_crc:08x} / {want_len} bytes, the payload is "
            f"{got_crc:08x} / {len(data)} bytes")


def verify(path) -> bool:
    """Whether ``path`` holds a loadable snapshot: its bytes match the
    sidecar where there is one, else the pickle parses."""
    try:
        data = fs.read_bytes(path)
        _verify_bytes(path, data)
        if not fs.exists(_crc_path(path)):
            _loads(data)
        return True
    except Exception:
        return False


def _to_numpy(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_numpy(v) for v in obj)
    return obj


def save(obj, path, overwrite: bool = True):
    """Pickle ``obj`` (tensors as numpy arrays) to ``path``, then its CRC
    sidecar: a crash between the two leaves either the old pair or a new
    payload whose stale sidecar :func:`load` rejects."""
    if fs.exists(path) and not overwrite:
        raise FileExistsError(path)
    data = pickle.dumps(_to_numpy(obj))
    fs.write_bytes_atomic(path, data)
    fs.write_bytes_atomic(_crc_path(path),
                          b"%08x %d\n" % (zlib.crc32(data), len(data)))


def load(path):
    """A snapshot, checked against its sidecar (ChecksumError)."""
    data = fs.read_bytes(path)
    _verify_bytes(path, data)
    return _loads(data)


def _pickle_architecture(module) -> bytes:
    """The module pickled with every parameter and buffer on the meta
    device (shapes and types only)."""
    stash = []
    for m in module.modules():
        for store in (m._parameters, m._buffers):
            for k, t in list(store.items()):
                if t is None:
                    continue
                stash.append((store, k, t))
                meta = torch.empty(t.shape, dtype=t.dtype, device="meta")
                store[k] = (torch.nn.Parameter(meta, t.requires_grad)
                            if isinstance(t, torch.nn.Parameter) else meta)
    try:
        return pickle.dumps(module)
    finally:
        for store, k, t in stash:
            store[k] = t


def save_module(module, path, overwrite: bool = True):
    """The whole module, architecture, weights and running state (ref
    AbstractModule.save), in the JAX package's v2 layout: ``params`` and
    ``state`` are the JAX ``params()`` and ``state()`` trees."""
    from bigdl_tpu_torch.nn.module import export_params, export_state

    save({"format": FORMAT, "package": PACKAGE,
          "cls": type(module).__name__,
          "architecture": _pickle_architecture(module),
          "params": export_params(module),
          "state": export_state(module)}, path, overwrite=overwrite)


def load_module(path, device="cuda"):
    """The module :func:`save_module` wrote, rebuilt on ``device`` (the
    card unless the caller asks for the CPU)."""
    from bigdl_tpu_torch.utils.device import resolve_device

    blob = load(path)
    if blob.get("package") != PACKAGE:
        raise ValueError(
            f"{path} was written by the JAX package ({blob.get('cls')}): "
            f"its architecture is not the port's; build the port's model "
            f"and use load_module_into")
    module = _loads(blob["architecture"])
    module.to_empty(device=resolve_device(device))
    return load_module_into(module, path, blob)


def load_module_into(module, path, blob=None):
    """The weights and running state (the buffers, copied in place) of a
    module file of either package into ``module``."""
    blob = load(path) if blob is None else blob
    module.load_params(blob["params"])
    module.load_state(blob.get("state", {}))
    return module
