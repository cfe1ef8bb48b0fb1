"""The port's PNG decoder: what ``BytesToImg`` decodes a PNG with,
whether Pillow is installed or not (the training hosts of the port need
not have it).

The chunks are parsed and their CRCs checked, the image data inflated
with the standard library's ``zlib``, and the five scanline filters undone
by the native host op ``hostops_png_unfilter`` (``native.png_unfilter``).
Bit depth 8, non-interlaced, in colour types 0 (grey), 2 (RGB), 3
(palette), 4 (grey and alpha) and 6 (RGBA).  The result is what Pillow's
``Image.open(...).convert("RGB")`` gives, as float32 HWC: grey replicated
into the three channels, alpha dropped, a palette index looked up
(an index past the palette's end reads black), ``tRNS`` ignored.

Anything else raises a ``ValueError`` that names the reason: 16-bit or
sub-byte samples, interlacing, a bad CRC, an unknown critical chunk, a
missing or malformed chunk.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

from bigdl_tpu_torch import native

SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: channels of each colour type's samples
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_KNOWN_CRITICAL = (b"IHDR", b"PLTE", b"IDAT", b"IEND")


def is_png(raw: bytes) -> bool:
    return raw[:8] == SIGNATURE


def _chunks(raw: bytes):
    pos = len(SIGNATURE)
    while True:
        if pos + 8 > len(raw):
            raise ValueError("PNG: truncated before IEND")
        (n,) = struct.unpack(">I", raw[pos:pos + 4])
        kind = raw[pos + 4:pos + 8]
        body = raw[pos + 8:pos + 8 + n]
        if len(body) != n or pos + 12 + n > len(raw):
            raise ValueError(f"PNG: truncated {kind!r} chunk")
        (crc,) = struct.unpack(">I", raw[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG: bad CRC in the {kind!r} chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n


def decode(raw: bytes, native_unfilter: bool = True) -> np.ndarray:
    """PNG bytes -> float32 (H, W, 3) in RGB order, the bits of Pillow's
    ``convert("RGB")``."""
    if not is_png(raw):
        raise ValueError("PNG: bad signature")
    header, palette, data = None, None, []
    for kind, body in _chunks(raw):
        if kind == b"IHDR":
            if len(body) != 13:
                raise ValueError("PNG: IHDR of the wrong length")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            if len(body) % 3 or not body:
                raise ValueError("PNG: PLTE length not a multiple of 3")
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            data.append(body)
        elif kind[0] & 0x20 == 0 and kind not in _KNOWN_CRITICAL:
            raise ValueError(f"PNG: unknown critical chunk {kind!r}")
    if header is None:
        raise ValueError("PNG: no IHDR chunk")
    w, h, depth, ctype, comp, filt, interlace = header
    if ctype not in CHANNELS:
        raise ValueError(f"PNG: unknown colour type {ctype}")
    if depth != 8:
        raise ValueError(f"PNG: bit depth {depth} (only 8 decodes)")
    if interlace:
        raise ValueError("PNG: interlaced (Adam7) images do not decode")
    if comp or filt:
        raise ValueError(f"PNG: compression method {comp} / filter "
                         f"method {filt}")
    if not data:
        raise ValueError("PNG: no IDAT chunk")
    if ctype == 3 and palette is None:
        raise ValueError("PNG: colour type 3 without a PLTE chunk")
    if w == 0 or h == 0:
        raise ValueError(f"PNG: empty image {w}x{h}")
    try:
        inflated = zlib.decompress(b"".join(data))
    except zlib.error as e:
        raise ValueError(f"PNG: image data does not inflate: {e}") from e
    c = CHANNELS[ctype]
    px = native.png_unfilter(inflated, h, w * c, c,
                             native=native_unfilter).reshape(h, w, c)
    if ctype == 3:
        table = np.zeros((256, 3), np.uint8)
        table[:len(palette)] = palette[:256]
        rgb = table[px[..., 0]]
    elif ctype in (0, 4):
        rgb = np.repeat(px[..., :1], 3, axis=2)
    else:
        rgb = px[..., :3]
    return rgb.astype(np.float32)
