"""PNG output (host side).

The port's counterpart of the JAX package's native encoder
(jpeg2png_tpu/native/pngio.c), which runs libpng 1.6 with its defaults;
this module writes the same bytes without libpng.  Semantics match the
reference writer (reference: png.c:20-78): 8- or 16-bit RGB (or
grayscale, an extension), no interlace, big-endian 16-bit samples.
Colour conversion happens on the device in ops/color.py; this module only
packs integer pixels into the container.

libpng's defaults, reproduced step by step:
  - every row goes through its adaptive filter (png_write_find_filter):
    the C library csrc/png_filter.c, called through ctypes, which releases
    the interpreter lock for the call.  `filter_rows_plain` is the same
    heuristic in numpy, for the tests;
  - zlib level 6, memLevel 8, strategy Z_FILTERED (Z_DEFAULT_STRATEGY for
    a one-pixel image, whose only filter is None), window bits 15, cut for
    small images as png_deflate_claim cuts them; zlib's deflate runs
    without the interpreter lock too;
  - the first two bytes of the zlib stream rewritten as optimize_cmf
    rewrites them, for filtered data of 16 KiB or less;
  - the stream split into IDAT chunks of 8,192 bytes (PNG_ZBUF_SIZE).
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

from jpeg2png_tpu_torch.utils import profiling

_SIG = b"\x89PNG\r\n\x1a\n"
IDAT_BYTES = 8192       # libpng's PNG_ZBUF_SIZE: the size of a full IDAT
SMALL_IMAGE = 16384     # up to this many filtered bytes, the window shrinks


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def _filter_fn():
    """The C filter's entry point, built and loaded at first use."""
    from jpeg2png_tpu_torch.kernels import _build

    fn = _build.library("png_filter").j2p_png_filter
    if fn.argtypes is None:
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        fn.argtypes = [p, i64, i64, ctypes.c_int32, p]
        fn.restype = ctypes.c_int
    return fn


def filter_rows(rows: np.ndarray, bpp: int) -> np.ndarray:
    """libpng's filtered scanlines of `rows` ([h, row_bytes] uint8, `bpp`
    bytes a pixel): [h, 1 + row_bytes] uint8, each row's filter type
    first.  Runs csrc/png_filter.c."""
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    h, row_bytes = rows.shape
    out = np.empty((h, row_bytes + 1), np.uint8)
    rc = _filter_fn()(rows.ctypes.data, h, row_bytes, bpp, out.ctypes.data)
    if rc != 0:
        raise ValueError(f"png_filter: bad geometry {rows.shape}, bpp {bpp}")
    return out


def _tried_filters(h: int, row_bytes: int, bpp: int) -> list:
    """The filters libpng tries (png_write_start_row): all five, less those
    that need a row above for a one-row image, and those that need a pixel
    to the left for a one-pixel-wide one."""
    tries = [0, 1, 2, 3, 4]
    if h == 1:
        tries = [f for f in tries if f not in (2, 3, 4)]
    if row_bytes == bpp:
        tries = [f for f in tries if f not in (1, 3, 4)]
    return tries


def filter_rows_plain(rows: np.ndarray, bpp: int) -> np.ndarray:
    """`filter_rows` in numpy: every filter on every row at once, each
    row's first least score picked (the tests hold the C library to it)."""
    x = np.asarray(rows, np.uint8).astype(np.int32)
    h, row_bytes = x.shape
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    c = np.zeros_like(x)
    c[:, bpp:] = b[:, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    cands = np.stack([x, x - a, x - b, x - (a + b) // 2, x - paeth]) & 0xFF
    scores = np.minimum(cands, 256 - cands).sum(axis=2, dtype=np.int64)
    tries = _tried_filters(h, row_bytes, bpp)
    scores[[f for f in range(5) if f not in tries]] = np.iinfo(np.int64).max
    best = scores.argmin(axis=0)
    out = np.empty((h, row_bytes + 1), np.uint8)
    out[:, 0] = best
    out[:, 1:] = cands[best, np.arange(h)]
    return out


def _image_size(h: int, row_bytes: int) -> int:
    """libpng's png_image_size for a non-interlaced image."""
    if row_bytes < 32768 and h < 32768:
        return (row_bytes + 1) * h
    return 0xFFFFFFFF


def _window_bits(size: int) -> int:
    """png_deflate_claim's window: 15 bits, less while the data and zlib's
    262-byte lookahead fit in half the window, never below zlib's 9."""
    bits = 15
    if size <= SMALL_IMAGE:
        half = 1 << (bits - 1)
        while size + 262 <= half:
            half >>= 1
            bits -= 1
    return max(bits, 9)


def _optimize_cmf(stream: bytearray, size: int) -> None:
    """libpng's optimize_cmf: for a small image, the zlib header's window
    size (CINFO) lowered to the least that holds `size` bytes, and its
    check bits (FCHECK) set again."""
    if size > SMALL_IMAGE:
        return
    cmf = stream[0]
    if (cmf & 0x0F) != 8 or (cmf & 0xF0) > 0x70:
        return
    cinfo = cmf >> 4
    half = 1 << (cinfo + 7)
    if size > half:
        return
    while True:
        half >>= 1
        cinfo -= 1
        if not (cinfo > 0 and size <= half):
            break
    cmf = (cmf & 0x0F) | (cinfo << 4)
    stream[0] = cmf
    flg = stream[1] & 0xE0
    flg += 0x1F - ((cmf << 8) + flg) % 0x1F
    stream[1] = flg


def deflate_rows(filtered: np.ndarray, bpp: int) -> bytes:
    """The zlib stream of filtered scanlines ([h, 1 + row_bytes] uint8) as
    libpng writes it: png_deflate_claim's settings, optimize_cmf's header."""
    h, row_bytes = filtered.shape[0], filtered.shape[1] - 1
    size = _image_size(h, row_bytes)
    only_none = _tried_filters(h, row_bytes, bpp) == [0]
    comp = zlib.compressobj(
        6, zlib.DEFLATED, _window_bits(size), 8,
        zlib.Z_DEFAULT_STRATEGY if only_none else zlib.Z_FILTERED)
    stream = bytearray(comp.compress(np.ascontiguousarray(filtered).data))
    stream += comp.flush()
    _optimize_cmf(stream, size)
    return bytes(stream)


def encode_png(pixels: np.ndarray, bits: int = 8) -> bytes:
    """Encode [H, W, 3] RGB or [H, W] grayscale (uint8/uint16) to PNG,
    byte for byte as libpng 1.6 with its defaults encodes it."""
    if pixels.ndim == 2:
        color_type = 0
        pixels = pixels[:, :, None]
    elif pixels.ndim == 3 and pixels.shape[2] == 3:
        color_type = 2
    else:
        raise ValueError(f"unsupported pixel shape {pixels.shape}")

    h, w, ch = pixels.shape
    if bits == 8:
        raw = pixels.astype("u1", copy=False)
    elif bits == 16:
        raw = pixels.astype(">u2", copy=False)
    else:
        raise ValueError("bits must be 8 or 16")

    rows = np.ascontiguousarray(raw).reshape(h, -1).view("u1")
    bpp = ch * bits // 8
    stream = deflate_rows(filter_rows(rows, bpp), bpp)
    ihdr = struct.pack(">IIBBBBB", w, h, bits, color_type, 0, 0, 0)
    return b"".join(
        [_SIG, _chunk(b"IHDR", ihdr)]
        + [_chunk(b"IDAT", stream[i:i + IDAT_BYTES])
           for i in range(0, len(stream), IDAT_BYTES)]
        + [_chunk(b"IEND", b"")])


def write_png(path, pixels: np.ndarray, bits: int = 8) -> None:
    """Encode and write one PNG: a "png" span."""
    with profiling.span("png"), open(path, "wb") as f:
        f.write(encode_png(pixels, bits))
