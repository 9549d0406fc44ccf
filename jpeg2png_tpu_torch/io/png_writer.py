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

An image of more than STRIP_BYTES of filtered rows is written as pigz
writes a file: cut into row strips of at least STRIP_BYTES each (whole
rows, from the shape alone), each strip filtered (its row above taken from
the image) and deflated on one process-wide pool of threads, a worker for
each core the process may run on but one.  Each strip is a raw deflate with
libpng's settings, primed with the 32 KiB of filtered bytes before it and
ended by a sync flush (the last by a finish), so the strips join into one
zlib stream: zlib's header, the strips, the Adler-32 of all the filtered
bytes.  The same filters and deflate settings, only the block boundaries
move: about 0.03% more bytes than libpng's one stream, the same bytes on
any host and for any number of workers.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import os
import struct
import threading
import zlib

import numpy as np

from jpeg2png_tpu_torch.utils import profiling

_SIG = b"\x89PNG\r\n\x1a\n"
IDAT_BYTES = 8192       # libpng's PNG_ZBUF_SIZE: the size of a full IDAT
SMALL_IMAGE = 16384     # up to this many filtered bytes, the window shrinks
STRIP_BYTES = 131072    # filtered bytes a strip holds at least; up to this
                        # many, an image is one stream, libpng's bytes
WINDOW = 32768          # deflate's window: the dictionary a strip is primed with
# the header of compressobj(6, DEFLATED, 15, 8, Z_FILTERED)'s stream: a 32 KiB
# window, level 6's flags
ZLIB_HEADER = b"\x78\x9c"


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def _filter_fn():
    """The C filter's entry point, j2p_png_filter_rows, built and loaded at
    first use."""
    from jpeg2png_tpu_torch.kernels import _build

    fn = _build.library("png_filter").j2p_png_filter_rows
    if fn.argtypes is None:
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        fn.argtypes = [p, i64, i64, ctypes.c_int32, i64, i64, p]
        fn.restype = ctypes.c_int
    return fn


def filter_strip(rows: np.ndarray, bpp: int, y0: int, y1: int,
                 out: np.ndarray) -> None:
    """Rows [y0, y1) of `filter_rows(rows, bpp)` into `out` ([y1 - y0,
    1 + row_bytes] uint8, C-contiguous; `rows` C-contiguous uint8): the
    same bytes for any split of the rows.  Runs csrc/png_filter.c."""
    h, row_bytes = rows.shape
    for a in (rows, out):
        if a.dtype != np.uint8 or not a.flags.c_contiguous:
            raise ValueError("png_filter: arrays must be C-contiguous uint8")
    if out.shape != (y1 - y0, row_bytes + 1) or _filter_fn()(
            rows.ctypes.data, h, row_bytes, bpp, y0, y1,
            out.ctypes.data) != 0:
        raise ValueError(f"png_filter: bad geometry {rows.shape}, bpp {bpp}"
                         f", rows [{y0}, {y1})")


def filter_rows(rows: np.ndarray, bpp: int) -> np.ndarray:
    """libpng's filtered scanlines of `rows` ([h, row_bytes] uint8, `bpp`
    bytes a pixel): [h, 1 + row_bytes] uint8, each row's filter type
    first (`filter_strip` over every row)."""
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    h, row_bytes = rows.shape
    out = np.empty((h, row_bytes + 1), np.uint8)
    filter_strip(rows, bpp, 0, h, out)
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


def strip_rows(h: int, row_bytes: int) -> int:
    """Rows a strip holds (the last: what is left), whole rows of at least
    STRIP_BYTES filtered bytes; from the image's shape alone."""
    return max(1, -(-STRIP_BYTES // (row_bytes + 1)))


_pool = None                    # (pid, the strips' ThreadPoolExecutor)
_pool_lock = threading.Lock()


def _strip_pool() -> concurrent.futures.ThreadPoolExecutor:
    """The process-wide pool that filters and deflates strips, a worker for
    each core this process may run on but one: with every core deflating,
    the thread that launches a solve's kernels (Python, under the
    interpreter lock the workers take between zlib calls) waits longer,
    and an -i 1000 batch on an H100's 8-core host ran slower than with a
    core left over (PERF.md section 6).  Made at first use
    (and again in a forked child, which has none of the parent's
    threads).  Every caller shares it, and its tasks submit nothing to it,
    so a caller that waits on it cannot deadlock."""
    global _pool
    with _pool_lock:
        if _pool is None or _pool[0] != os.getpid():
            _pool = (os.getpid(), concurrent.futures.ThreadPoolExecutor(
                max(1, len(os.sched_getaffinity(0)) - 1),
                thread_name_prefix="png-strip"))
        return _pool[1]


def adler32_combine(adler1: int, adler2: int, len2: int) -> int:
    """The Adler-32 of A + B from A's (`adler1`), B's (`adler2`) and B's
    length (zlib's adler32_combine)."""
    base = 65521
    rem = len2 % base
    lo1 = adler1 & 0xFFFF
    lo = (lo1 + (adler2 & 0xFFFF) + base - 1) % base
    hi = (rem * lo1 + (adler1 >> 16) + (adler2 >> 16) + base - rem) % base
    return lo | (hi << 16)


def strip_stream(rows: np.ndarray, bpp: int):
    """The zlib stream of `rows` ([h, row_bytes] uint8, C-contiguous)
    filtered and deflated in strips of `strip_rows` rows on the pool:
    (stream, strips).  All strips are filtered first, since a strip's
    dictionary is the end of the strip before it."""
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    h, row_bytes = rows.shape
    n = strip_rows(h, row_bytes)
    bounds = [(y, min(y + n, h)) for y in range(0, h, n)]
    filtered = np.empty((h, row_bytes + 1), np.uint8)
    pool = _strip_pool()
    list(pool.map(lambda b: filter_strip(rows, bpp, b[0], b[1],
                                         filtered[b[0]:b[1]]), bounds))
    flat = memoryview(filtered.reshape(-1))
    stride = row_bytes + 1

    def deflate(i):
        start, end = bounds[i][0] * stride, bounds[i][1] * stride
        prime = ({"zdict": flat[max(0, start - WINDOW):start]} if start
                 else {})
        comp = zlib.compressobj(6, zlib.DEFLATED, -15, 8, zlib.Z_FILTERED,
                                **prime)
        piece = comp.compress(flat[start:end]) + comp.flush(
            zlib.Z_FINISH if i == len(bounds) - 1 else zlib.Z_SYNC_FLUSH)
        return piece, zlib.adler32(flat[start:end]), end - start

    pieces = list(pool.map(deflate, range(len(bounds))))
    adler = 1                       # the Adler-32 of no bytes
    for _, a, size in pieces:
        adler = adler32_combine(adler, a, size)
    stream = b"".join([ZLIB_HEADER] + [p for p, _, _ in pieces]
                      + [struct.pack(">I", adler)])
    return stream, len(bounds)


def _encode(pixels: np.ndarray, bits: int):
    """`encode_png`'s bytes and the strips its stream took."""
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
    if h * (rows.shape[1] + 1) <= STRIP_BYTES:
        stream, strips = deflate_rows(filter_rows(rows, bpp), bpp), 1
    else:
        stream, strips = strip_stream(rows, bpp)
    ihdr = struct.pack(">IIBBBBB", w, h, bits, color_type, 0, 0, 0)
    data = b"".join(
        [_SIG, _chunk(b"IHDR", ihdr)]
        + [_chunk(b"IDAT", stream[i:i + IDAT_BYTES])
           for i in range(0, len(stream), IDAT_BYTES)]
        + [_chunk(b"IEND", b"")])
    return data, strips


def encode_png(pixels: np.ndarray, bits: int = 8) -> bytes:
    """Encode [H, W, 3] RGB or [H, W] grayscale (uint8/uint16) to PNG: byte
    for byte as libpng 1.6 with its defaults encodes it up to STRIP_BYTES
    of filtered rows, in strips on the pool above that."""
    return _encode(pixels, bits)[0]


def write_png(path, pixels: np.ndarray, bits: int = 8) -> None:
    """Encode and write one PNG: a "png" span, which counts its stream's
    `strips` and the file's `bytes`."""
    with profiling.span("png") as sp, open(path, "wb") as f:
        data, strips = _encode(pixels, bits)
        profiling.count(sp, "strips", strips)
        profiling.count(sp, "bytes", len(data))
        f.write(data)
