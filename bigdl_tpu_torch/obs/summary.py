"""TensorBoard-compatible scalar export (counterpart of
bigdl_tpu/obs/summary.py) — the ``TrainSummary`` / ``ValidationSummary``
parity piece (later BigDL releases ship
visualization/TrainSummary.scala writing tfevents via an embedded
TensorFlow; SOTA BigDL docs show loss/throughput/lr curves in
TensorBoard).

The port takes no TensorFlow or TensorBoard dependency, so the
writer speaks the format directly: a tfevents file is a TFRecord stream
(length, masked-crc32c(length), payload, masked-crc32c(payload)) of
``Event`` protobuf messages, and a scalar point needs exactly four
proto fields (wall_time, step, summary.value.tag,
summary.value.simple_value).  Hand-encoding those ~40 bytes is smaller
than any dependency and byte-compatible with TensorBoard's reader; the
tests round-trip through :func:`read_scalars`.

Usage (the reference's optimizer.setTrainSummary shape)::

    train_summary = TrainSummary(log_dir, app_name="lenet")
    val_summary = ValidationSummary(log_dir, app_name="lenet")
    optimizer.set_train_summary(train_summary)
    optimizer.set_val_summary(val_summary)

Loss/LearningRate/Throughput land per iteration; tap scalars land at
the taps cadence; validation metrics at each validation trigger.
"""
from __future__ import annotations

import os
import socket
import struct
import time

# -- crc32c (Castagnoli, reflected 0x82F63B78) — TFRecord's checksum ------

_CRC_TABLE = []
for _n in range(256):
    _c = _n
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# -- minimal proto encoding ------------------------------------------------

def _varint(n: int) -> bytes:
    # protobuf wire: negative int64s ride as 10-byte two's-complement
    # varints (Python's arithmetic shift on a negative n would otherwise
    # never terminate)
    if n < 0:
        n &= 0xFFFFFFFFFFFFFFFF
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _len_field(key: int, payload: bytes) -> bytes:
    return bytes([key << 3 | 2]) + _varint(len(payload)) + payload


def _scalar_event(wall_time: float, step: int, tag: str,
                  value: float) -> bytes:
    # Summary.Value { tag = 1 (string); simple_value = 2 (float) }
    val = (_len_field(1, tag.encode("utf-8"))
           + b"\x15" + struct.pack("<f", value))
    summary = _len_field(1, val)          # Summary { value = 1 repeated }
    return (b"\x09" + struct.pack("<d", wall_time)   # Event.wall_time = 1
            + b"\x10" + _varint(step)                # Event.step = 2
            + _len_field(5, summary))                # Event.summary = 5


def _version_event(wall_time: float) -> bytes:
    # Event.file_version = 3: the "brain.Event:2" header TensorBoard
    # requires as the first record
    return (b"\x09" + struct.pack("<d", wall_time)
            + _len_field(3, b"brain.Event:2"))


class ScalarWriter:
    """One tfevents file of scalar records under ``log_dir``."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        host = socket.gethostname()
        self.path = os.path.join(
            log_dir, f"events.out.tfevents.{int(time.time())}.{host}."
                     f"{os.getpid()}")
        self._fh = open(self.path, "ab")
        self._record(_version_event(time.time()))

    def _record(self, payload: bytes):
        header = struct.pack("<Q", len(payload))
        self._fh.write(header)
        self._fh.write(struct.pack("<I", _masked_crc(header)))
        self._fh.write(payload)
        self._fh.write(struct.pack("<I", _masked_crc(payload)))
        self._fh.flush()

    def add_scalar(self, tag: str, value: float, step: int,
                   wall_time: float | None = None):
        self._record(_scalar_event(
            time.time() if wall_time is None else wall_time,
            int(step), tag, float(value)))

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class TrainSummary(ScalarWriter):
    """Training-curve sink (ref visualization/TrainSummary.scala):
    ``<log_dir>/<app_name>/train``.  Wire with
    ``optimizer.set_train_summary``."""

    def __init__(self, log_dir: str, app_name: str):
        self.log_dir = os.path.join(log_dir, app_name, "train")
        super().__init__(self.log_dir)


class ValidationSummary(ScalarWriter):
    """Validation-curve sink (ref ValidationSummary.scala):
    ``<log_dir>/<app_name>/validation``.  Wire with
    ``optimizer.set_val_summary``."""

    def __init__(self, log_dir: str, app_name: str):
        self.log_dir = os.path.join(log_dir, app_name, "validation")
        super().__init__(self.log_dir)


# -- reader (tests + obs_report) ------------------------------------------

def read_scalars(path: str):
    """Decode a tfevents file back to [(step, tag, value)] — validates
    both CRCs of every record, so the writer above is kept honest."""
    out = []
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        header = data[pos:pos + 8]
        (length,) = struct.unpack("<Q", header)
        (hcrc,) = struct.unpack("<I", data[pos + 8:pos + 12])
        if hcrc != _masked_crc(header):
            raise ValueError(f"bad length crc at byte {pos}")
        payload = data[pos + 12:pos + 12 + length]
        (pcrc,) = struct.unpack("<I",
                                data[pos + 12 + length:pos + 16 + length])
        if pcrc != _masked_crc(payload):
            raise ValueError(f"bad payload crc at byte {pos}")
        pos += 16 + length
        rec = _decode_event(payload)
        if rec is not None:
            out.append(rec)
    return out


def _read_varint(buf, i):
    n = shift = 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, i
        shift += 7


def _decode_event(buf: bytes):
    """(step, tag, value) from one Event payload, or None for
    non-scalar events (the file_version header)."""
    i, step, summary = 0, 0, None
    while i < len(buf):
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, i = _read_varint(buf, i)
            if field == 2:
                step = val - (1 << 64) if val >= 1 << 63 else val
        elif wire == 1:
            i += 8
        elif wire == 5:
            i += 4
        elif wire == 2:
            ln, i = _read_varint(buf, i)
            if field == 5:
                summary = buf[i:i + ln]
            i += ln
    if summary is None:
        return None
    # Summary -> Value -> (tag, simple_value)
    i = 0
    tag, value = None, None
    while i < len(summary):
        key, i = _read_varint(summary, i)
        if key >> 3 == 1 and key & 7 == 2:
            ln, i = _read_varint(summary, i)
            vbuf = summary[i:i + ln]
            i += ln
            j = 0
            while j < len(vbuf):
                vkey, j = _read_varint(vbuf, j)
                vfield, vwire = vkey >> 3, vkey & 7
                if vfield == 1 and vwire == 2:
                    ln2, j = _read_varint(vbuf, j)
                    tag = vbuf[j:j + ln2].decode("utf-8")
                    j += ln2
                elif vfield == 2 and vwire == 5:
                    (value,) = struct.unpack("<f", vbuf[j:j + 4])
                    j += 4
                elif vwire == 0:
                    _, j = _read_varint(vbuf, j)
                elif vwire == 1:
                    j += 8
                elif vwire == 5:
                    j += 4
                elif vwire == 2:
                    ln2, j = _read_varint(vbuf, j)
                    j += ln2
        else:
            break
    if tag is None or value is None:
        return None
    return (step, tag, value)
