"""Pixels of a PNG, read back with numpy.

The repository's tests/pngdec.py, frozen for the benchmark: non-interlaced
8- or 16-bit gray or RGB, the five row filters.  Where pngdec undoes the
filters byte by byte, this undoes them for every pixel of an
anti-diagonal at once: a pixel needs its left, upper and upper-left
neighbours, which all lie on the two diagonals before its own.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def read_png(data: bytes) -> np.ndarray:
    """[h, w, 3] or [h, w] uint8 / uint16 pixels of PNG bytes."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos, idat, ihdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", data[pos + 8:pos + 8 + n])
        elif tag == b"IDAT":
            idat.append(data[pos + 8:pos + 8 + n])
        elif tag == b"IEND":
            break
        pos += 12 + n
    w, h, depth, ctype, comp, filt, interlace = ihdr
    if interlace or comp or filt or ctype not in (0, 2) or depth not in (8, 16):
        raise ValueError(f"unsupported PNG header {ihdr}")
    bpp = (3 if ctype == 2 else 1) * depth // 8
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows.reshape(h, 1 + w * bpp)
    ftype = rows[:, 0].astype(np.int16)
    if int(ftype.max()) > 4:
        raise ValueError(f"PNG filter type {int(ftype.max())}")
    # skewed layout: diagonal d = r + x holds pixel (r, x) at [d, r]; one
    # row and one diagonal of zeros before the pixels stand for the
    # neighbours left of column 0 and above row 0
    r, x = np.divmod(np.arange(h * w), w)
    line = np.zeros((h + w - 1, h, bpp), np.int16)
    line[r + x, r] = rows[:, 1:].reshape(h * w, bpp)
    pix = np.zeros((h + w + 1, h + 1, bpp), np.int16)
    for d in range(h + w - 1):
        lo, hi = max(0, d - w + 1), min(h - 1, d) + 1
        a = pix[d, lo + 1:hi + 1]          # left
        b = pix[d, lo:hi]                  # up
        c = pix[d - 1, lo:hi]              # up-left
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        f = ftype[lo:hi, None]
        pred = np.where(f == 1, a, np.where(f == 2, b, np.where(
            f == 3, (a + b) >> 1, np.where(f == 4, paeth, 0))))
        pix[d + 1, lo + 1:hi + 1] = (line[d, lo:hi] + pred) & 0xFF
    out = pix[r + x + 1, r + 1].astype(np.uint8).reshape(h, w * bpp)
    if depth == 16:
        out = out.view(">u2").astype(np.uint16)
    return out.reshape(h, w, 3) if ctype == 2 else out.reshape(h, w)


def read_png_file(path) -> np.ndarray:
    with open(path, "rb") as f:
        return read_png(f.read())
