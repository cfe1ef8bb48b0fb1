"""Native host ops of the port's input pipeline (counterpart of
bigdl_tpu/native/__init__.py).

``hostops.cpp`` here is the port's own copy of the C++; :func:`lib` builds
it with ``g++ -O3 -fopenmp`` at first use into ``bigdl_tpu_torch/build/``,
keyed by a hash of the source and the flags as ``ops/_build.py`` keys the
CUDA libraries, and loads it with ctypes.  Nothing is built at import.
Unlike the JAX loader, a build or load failure raises: there is no silent
numpy fallback.

Each function also has its plain numpy version, with the same bits (the
tests hold the two bit for bit), taken only with ``native=False``.

Every image function takes and returns float32 images, HWC or HW (grey,
as one channel), and writes into ``out`` when given (a C-contiguous
float32 array of the result's shape, such as one row of a batch buffer).
The decoders (:func:`u8_to_f32`, :func:`cifar_decode`) take bytes;
:func:`png_unfilter` undoes the scanline filters of a PNG's inflated
image data.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "hostops.cpp"
FLAGS = ("-O3", "-fopenmp", "-ffp-contract=off", "-shared", "-fPIC")
_lock = threading.Lock()
_lib = []

_I64 = ctypes.c_int64
_P = ctypes.c_void_p


def target() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes())
    digest.update(" ".join(FLAGS).encode())
    return (_SRC.parent.parent / "build"
            / f"libhostops-{digest.hexdigest()[:16]}.so")


def _build(out: Path):
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the port's host ops are built "
                           "from bigdl_tpu_torch/native/hostops.cpp at "
                           "first use")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *FLAGS, str(_SRC), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"host ops build failed (g++ exited "
                           f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)


def lib() -> ctypes.CDLL:
    """The loaded library, built first if needed; raises on failure."""
    if _lib:
        return _lib[0]
    with _lock:
        if not _lib:
            out = target()
            if not out.exists():
                _build(out)
            so = ctypes.CDLL(str(out))
            if so.hostops_version() != 1:
                raise RuntimeError(f"{out}: unexpected host ops version")
            so.hostops_normalize.argtypes = [_P, _P, _I64, _P, _P, _I64]
            so.hostops_u8_to_f32.argtypes = [_P, _P, _I64, ctypes.c_float,
                                             ctypes.c_float]
            so.hostops_crop.argtypes = [_P, _P] + [_I64] * 7
            so.hostops_hflip.argtypes = [_P, _P, _I64, _I64, _I64]
            so.hostops_hwc_to_chw.argtypes = [_P, _P, _I64, _I64, _I64]
            so.hostops_cifar_decode.argtypes = [_P, _P, _P, _I64]
            so.hostops_png_unfilter.argtypes = [_P, _P, _I64, _I64, _I64]
            so.hostops_png_unfilter.restype = _I64
            for fn in (so.hostops_normalize, so.hostops_u8_to_f32,
                       so.hostops_crop, so.hostops_hflip,
                       so.hostops_hwc_to_chw, so.hostops_cifar_decode):
                fn.restype = None
            _lib.append(so)
    return _lib[0]


def _fp(a) -> int:
    return a.ctypes.data


def _per_channel(v, c) -> np.ndarray:
    """One float32 value a channel, contiguous, from one or c values."""
    v = v.reshape(-1)
    if v.size == c:
        return np.ascontiguousarray(v)
    if v.size == 1:
        return np.full(c, v[0], np.float32)
    raise ValueError(f"{v.size} values for {c} channels")


def _f32(img) -> np.ndarray:
    return np.ascontiguousarray(img, np.float32)


def _hwc(img) -> tuple:
    """(h, w, c) of an HWC or HW (one channel) image."""
    if img.ndim == 2:
        return img.shape + (1,)
    if img.ndim == 3:
        return img.shape
    raise ValueError(f"an image is HWC or HW, got shape {img.shape}")


def _out(out, shape) -> np.ndarray:
    if out is None:
        return np.empty(shape, np.float32)
    if (out.shape != tuple(shape) or out.dtype != np.float32
            or not out.flags.c_contiguous):
        raise ValueError(f"out must be C-contiguous float32 of shape "
                         f"{tuple(shape)}, got {out.dtype} {out.shape}")
    return out


def _put(out, value):
    if out is None:
        return value
    _out(out, value.shape)[...] = value
    return out


def normalize(img, mean, std, native=True, out=None) -> np.ndarray:
    """``(img - mean) / std`` per channel (the last axis of an HWC image;
    a grey image takes one mean and one std)."""
    img = _f32(img)
    _, _, c = _hwc(img)
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    if not native:
        return _put(out, (img - mean) / std)
    mean_c, std_c = _per_channel(mean, c), _per_channel(std, c)
    res = _out(out, img.shape)
    lib().hostops_normalize(_fp(img), _fp(res), img.size, _fp(mean_c),
                            _fp(std_c), c)
    return res


def crop(img, y0: int, x0: int, ch: int, cw: int, native=True,
         out=None) -> np.ndarray:
    """Rows y0..y0+ch and columns x0..x0+cw of an image, copied."""
    img = _f32(img)
    h, w, c = _hwc(img)
    if not (0 <= y0 and y0 + ch <= h and 0 <= x0 and x0 + cw <= w):
        raise ValueError(f"crop ({y0}, {x0}, {ch}, {cw}) outside a "
                         f"{h}x{w} image")
    if not native:
        return _put(out, img[y0:y0 + ch, x0:x0 + cw].copy())
    res = _out(out, (ch, cw) + img.shape[2:])
    lib().hostops_crop(_fp(img), _fp(res), h, w, c, y0, x0, ch, cw)
    return res


def hflip(img, native=True, out=None) -> np.ndarray:
    """The image's columns mirrored, copied."""
    img = _f32(img)
    h, w, c = _hwc(img)
    if not native:
        return _put(out, img[:, ::-1].copy())
    res = _out(out, img.shape)
    lib().hostops_hflip(_fp(img), _fp(res), h, w, c)
    return res


def hwc_to_chw(img, native=True, out=None) -> np.ndarray:
    """An HWC image in CHW order (a grey HW image as (1, H, W))."""
    img = _f32(img)
    h, w, c = _hwc(img)
    if not native:
        chw = img[None] if img.ndim == 2 else img.transpose(2, 0, 1)
        return _put(out, np.ascontiguousarray(chw))
    res = _out(out, (c, h, w))
    lib().hostops_hwc_to_chw(_fp(img), _fp(res), h, w, c)
    return res


def u8_to_f32(raw, scale: float = 1.0, shift: float = 0.0,
              native=True) -> np.ndarray:
    """Bytes to float32 as ``raw * scale + shift``."""
    raw = np.ascontiguousarray(raw, np.uint8)
    if not native:
        return raw.astype(np.float32) * np.float32(scale) + np.float32(shift)
    res = np.empty(raw.shape, np.float32)
    lib().hostops_u8_to_f32(_fp(raw), _fp(res), raw.size, scale, shift)
    return res


CIFAR_RECORD = 3073   # 1 label byte + 3 x 32 x 32 pixel bytes, CHW


def cifar_decode(raw, native=True):
    """n CIFAR-10 binary records -> (labels (n,) float32, 1-based; images
    (n, 32, 32, 3) float32, HWC)."""
    raw = np.ascontiguousarray(raw, np.uint8).reshape(-1)
    if raw.size % CIFAR_RECORD:
        raise ValueError(f"{raw.size} bytes are not whole CIFAR records of "
                         f"{CIFAR_RECORD}")
    n = raw.size // CIFAR_RECORD
    if not native:
        rec = raw.reshape(n, CIFAR_RECORD)
        labels = rec[:, 0].astype(np.float32) + np.float32(1.0)
        images = rec[:, 1:].reshape(n, 3, 32, 32).transpose(0, 2, 3, 1)
        return labels, np.ascontiguousarray(images, np.float32)
    labels = np.empty(n, np.float32)
    images = np.empty((n, 32, 32, 3), np.float32)
    lib().hostops_cifar_decode(_fp(raw), _fp(labels), _fp(images), n)
    return labels, images


def png_unfilter(raw, h: int, stride: int, bpp: int,
                 native=True) -> np.ndarray:
    """A PNG's inflated image data (bytes), ``h`` rows of one filter-type
    byte and ``stride`` bytes, with the five scanline filters (None, Sub, Up,
    Average, Paeth; RFC 2083 section 6) undone: (h, stride) uint8.
    ``bpp`` is the bytes of a pixel (bit depth 8).  A filter type
    outside 0-4 raises."""
    raw = np.frombuffer(raw, np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"PNG image data holds {raw.size} bytes, "
                         f"{h} rows of 1 + {stride} need {h * (stride + 1)}")
    out = np.empty((h, stride), np.uint8)
    if not native:
        _png_unfilter_plain(raw.reshape(h, stride + 1), out, bpp)
        return out
    bad = lib().hostops_png_unfilter(_fp(raw), _fp(out), h, stride, bpp)
    if bad:
        kind = int(raw[(bad - 1) * (stride + 1)])
        raise ValueError(f"PNG row {bad - 1}: unknown filter type {kind}")
    return out


def _png_unfilter_plain(rows, out, bpp):
    prev = np.zeros(out.shape[1], np.int32)
    for y, row in enumerate(rows):
        kind, cur = int(row[0]), row[1:].astype(np.int32)
        if kind == 0:
            res = cur
        elif kind == 1:
            res = np.cumsum(cur.reshape(-1, bpp), axis=0).reshape(-1)
        elif kind == 2:
            res = cur + prev
        elif kind in (3, 4):
            res = cur.copy()
            for i in range(0, cur.size, bpp):
                b = prev[i:i + bpp]
                a = res[i - bpp:i] & 0xFF if i else np.zeros(bpp, np.int32)
                if kind == 3:
                    res[i:i + bpp] += (a + b) >> 1
                    continue
                c = prev[i - bpp:i] if i else np.zeros(bpp, np.int32)
                p = a + b - c
                pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
                res[i:i + bpp] += np.where((pa <= pb) & (pa <= pc), a,
                                           np.where(pb <= pc, b, c))
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {kind}")
        prev = res & 0xFF
        out[y] = prev
