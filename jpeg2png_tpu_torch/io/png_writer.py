"""PNG output (host side).

A PNG encoder on zlib alone, so no libpng is needed anywhere.  Semantics
match the reference writer (reference: png.c:20-78): 8- or 16-bit RGB
(or grayscale, an extension), no interlace, filter type 0, zlib level 6,
big-endian 16-bit samples.  Colour conversion happens on the device in
ops/color.py; this module only packs integer pixels into the container.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def encode_png(pixels: np.ndarray, bits: int = 8) -> bytes:
    """Encode [H, W, 3] RGB or [H, W] grayscale (uint8/uint16) to PNG."""
    if pixels.ndim == 2:
        color_type = 0
        pixels = pixels[:, :, None]
    elif pixels.ndim == 3 and pixels.shape[2] == 3:
        color_type = 2
    else:
        raise ValueError(f"unsupported pixel shape {pixels.shape}")

    h, w, _ = pixels.shape
    if bits == 8:
        raw = pixels.astype("u1", copy=False)
    elif bits == 16:
        raw = pixels.astype(">u2", copy=False)
    else:
        raise ValueError("bits must be 8 or 16")

    body = np.ascontiguousarray(raw).reshape(h, -1).view("u1")
    # prepend filter byte 0 to each row
    filtered = np.zeros((h, body.shape[1] + 1), dtype="u1")
    filtered[:, 1:] = body

    ihdr = struct.pack(">IIBBBBB", w, h, bits, color_type, 0, 0, 0)
    idat = zlib.compress(filtered.tobytes(), 6)
    return (
        _SIG
        + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", idat)
        + _chunk(b"IEND", b"")
    )


def write_png(path, pixels: np.ndarray, bits: int = 8) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(pixels, bits))
