"""JPEG DCT-coefficient reading (host side), in Python and numpy.

The port needs no libjpeg: this module parses the JPEG markers and
Huffman-decodes the quantized DCT coefficients itself, never computing
pixels — the solver wants the exact integer lattice (reference:
jpeg.c:22-80).  It reads sequential Huffman JPEGs (SOF0 baseline and
SOF1 extended, 8-bit samples), interleaved or not, with or without
restart intervals.  Progressive (SOF2), arithmetic-coded (SOF9-11),
lossless and hierarchical streams raise ValueError.

The dataclasses keep the JAX package's reader interface: per component
an int16 tensor [nby, nbx, 8, 8] in natural order, its uint16 quant
table [8, 8] and its replication factors.  Truncated entropy data
decodes like libjpeg does (the MCU that runs out is completed with zero
bits, the rest of its restart interval stays zero) and leaves libjpeg's
warning texts on JpegImage.warnings.

Decoding speed: Huffman codes are looked up 16 bits at a time in tables
of 2^16 entries, reading from a list of 32-bit big-endian windows (one
per byte), so the Python loop does a handful of integer operations per
coded symbol; coefficients are gathered as (index, value) pairs and
scattered into numpy once per component.
"""

from __future__ import annotations

import dataclasses
import pathlib
import sys
from typing import List, Union

import numpy as np

MAX_WARNINGS = 8  # texts kept; n_warnings counts all (libjpeg reader's cap)

# zigzag position k -> natural (row-major) index (jpeg_natural_order)
_NATURAL = (
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
)

_W_EOF = "Premature end of JPEG file"
_W_HIT_MARKER = "Corrupt JPEG data: premature end of data segment"
_W_BAD_CODE = "Corrupt JPEG data: bad Huffman code"
_W_NOT_SEQUENTIAL = "Invalid SOS parameters for sequential JPEG"


@dataclasses.dataclass
class CoefPlane:
    """One component's quantized DCT coefficients.

    Mirrors `struct coef` (reference: jpeg2png.h:7-20): `data` is the
    quantized integer lattice, `quant` the quantization table, and
    h_samp/w_samp how many full-res rows/columns one pixel of this
    plane covers (2 for the chroma of a 4:2:0 file).
    """
    data: np.ndarray    # int16 [nby, nbx, 8, 8]
    quant: np.ndarray   # uint16 [8, 8]
    h_samp: int
    w_samp: int

    @property
    def nby(self) -> int:
        return self.data.shape[0]

    @property
    def nbx(self) -> int:
        return self.data.shape[1]

    @property
    def ph(self) -> int:
        return self.nby * 8

    @property
    def pw(self) -> int:
        return self.nbx * 8


@dataclasses.dataclass
class JpegImage:
    height: int          # true image height (pre block-rounding)
    width: int
    progressive: bool
    planes: List[CoefPlane]
    # corrupt-data warnings emitted during decode, with libjpeg's texts
    # ("Premature end of JPEG file", ...).  The file still decoded; the
    # reference prints these to stderr and keeps going (jpeg.c:14-19).
    # Capped at MAX_WARNINGS texts; n_warnings counts all of them.
    warnings: tuple = ()
    n_warnings: int = 0

    @property
    def nchannel(self) -> int:
        return len(self.planes)


class _Warnings:
    def __init__(self):
        self.texts = []
        self.count = 0

    def add(self, text: str) -> None:
        if self.count < MAX_WARNINGS:
            self.texts.append(text)
        self.count += 1


def _fail(msg: str):
    raise ValueError(f"jpeg error: {msg}")


def _huff_tables(counts, symbols):
    """(symbol, code length) lookup lists indexed by the next 16 bits;
    length 0 marks a bit pattern that starts no code."""
    sym = np.zeros(1 << 16, np.int32)
    length = np.zeros(1 << 16, np.int32)
    code = 0
    k = 0
    for n_bits in range(1, 17):
        for _ in range(counts[n_bits - 1]):
            lo = code << (16 - n_bits)
            hi = (code + 1) << (16 - n_bits)
            if hi > (1 << 16):
                _fail("Bogus Huffman table definition")
            sym[lo:hi] = symbols[k]
            length[lo:hi] = n_bits
            code += 1
            k += 1
        code <<= 1
    return sym.tolist(), length.tolist()


def _windows(seg: bytes, pad: int) -> list:
    """Big-endian 32-bit window starting at every byte of `seg`, with
    `pad` zero bytes past its end (libjpeg feeds zeros past a marker)."""
    b = np.frombuffer(seg + bytes(pad), np.uint8).astype(np.uint32)
    return ((b[:-3] << 24) | (b[1:-2] << 16) | (b[2:-1] << 8)
            | b[3:]).tolist()


def _split_entropy(data: bytes, start: int, restarts: bool):
    """Entropy-coded segments of one scan with byte stuffing removed.

    Returns (segments split at RSTn markers, offset of the marker that
    ends the scan (len(data) at end of file), whether the file ended
    inside the scan)."""
    segs = []
    cur = bytearray()
    i = start
    n = len(data)
    while True:
        j = data.find(b"\xff", i)
        if j < 0:
            cur += data[i:]
            segs.append(bytes(cur))
            return segs, n, True
        cur += data[i:j]
        k = j + 1
        while k < n and data[k] == 0xFF:   # fill bytes
            k += 1
        if k >= n:
            segs.append(bytes(cur))
            return segs, n, True
        c = data[k]
        if c == 0:                          # stuffed zero: a data 0xFF
            cur.append(0xFF)
            i = k + 1
        elif restarts and 0xD0 <= c <= 0xD7:
            segs.append(bytes(cur))
            cur = bytearray()
            i = k + 1
        else:
            segs.append(bytes(cur))
            return segs, j, False


def _decode_segment(seg, units, dc_luts, ac_luts, idx_out, val_out, warn):
    """Huffman-decode the MCUs of one restart interval.

    units: per MCU a list of (scan component slot, flat base index of
    the block in that component's coefficient storage).  Appends the
    nonzero coefficients' flat indices and values per component slot.
    """
    marks = [len(i) for i in idx_out]
    warn_mark = (len(warn.texts), warn.count)
    try:
        _decode_windows(_windows(seg, 8), len(seg) * 8, units, dc_luts,
                        ac_luts, idx_out, val_out, warn)
    except IndexError:
        # the data ran out inside an MCU that needs more zero bits than
        # the short pad holds: decode the interval again with room for
        # the largest MCU (10 blocks of 64 symbols of <= 32 bits)
        for i, v, n in zip(idx_out, val_out, marks):
            del i[n:], v[n:]
        del warn.texts[warn_mark[0]:]
        warn.count = warn_mark[1]
        _decode_windows(_windows(seg, 2600), len(seg) * 8, units, dc_luts,
                        ac_luts, idx_out, val_out, warn)


def _decode_windows(win, nbits, units, dc_luts, ac_luts, idx_out, val_out,
                    warn):
    natural = _NATURAL
    pos = 0
    pred = [0] * len(dc_luts)
    for mcu in units:
        for slot, base in mcu:
            dsym, dlen = dc_luts[slot]
            asym, alen = ac_luts[slot]
            idx = idx_out[slot]
            val = val_out[slot]
            # --- DC difference ---
            look = (win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF
            n = dlen[look]
            if n == 0:
                warn.add(_W_BAD_CODE)
                pos += 17
                s = 0
            else:
                s = dsym[look]
                pos += n
            if s:
                v = (win[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
                pos += s
                if v < (1 << (s - 1)):
                    v -= (1 << s) - 1
                pred[slot] += v
            if pred[slot]:
                idx.append(base)
                val.append(pred[slot])
            # --- AC run/size symbols until EOB ---
            k = 1
            while k < 64:
                look = (win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF
                n = alen[look]
                if n == 0:
                    warn.add(_W_BAD_CODE)
                    pos += 17
                    break
                rs = asym[look]
                pos += n
                s = rs & 15
                if s:
                    k += rs >> 4
                    v = ((win[pos >> 3] >> (32 - (pos & 7) - s))
                         & ((1 << s) - 1))
                    pos += s
                    if v < (1 << (s - 1)):
                        v -= (1 << s) - 1
                    if k < 64:
                        idx.append(base + natural[k])
                        val.append(v)
                    k += 1
                elif rs == 0xF0:
                    k += 16
                else:
                    break
        if pos > nbits:
            # the rest of the interval stays zero, as libjpeg leaves it
            warn.add(_W_HIT_MARKER)
            return


def _scan_units(scan_comps, comps, mcus_x, mcus_y):
    """Per-MCU block lists of one scan (see _decode_segment)."""
    if len(scan_comps) == 1:
        # non-interleaved: one block per MCU over the component's own
        # (unpadded) block grid
        ci = scan_comps[0]
        cp = comps[ci]
        stride = cp["nbx_alloc"]
        return [[(0, (by * stride + bx) * 64)]
                for by in range(cp["nby"]) for bx in range(cp["nbx"])]
    units = []
    for my in range(mcus_y):
        for mx in range(mcus_x):
            mcu = []
            for slot, ci in enumerate(scan_comps):
                cp = comps[ci]
                stride = cp["nbx_alloc"]
                for v in range(cp["v"]):
                    for h in range(cp["h"]):
                        by = my * cp["v"] + v
                        bx = mx * cp["h"] + h
                        mcu.append((slot, (by * stride + bx) * 64))
            units.append(mcu)
    return units


def _u16(data, i):
    return (data[i] << 8) | data[i + 1]


def _parse(data: bytes):
    n = len(data)
    if n < 2 or data[0] != 0xFF or data[1] != 0xD8:
        _fail("Not a JPEG file")
    warn = _Warnings()
    qtabs = {}
    dc_tabs, ac_tabs = {}, {}
    restart = 0
    frame = None        # (height, width, comps)
    quants = None       # per component, latched at the first scan
    coef = None         # per component: (idx list, val list)
    mcus_x = mcus_y = 0
    pos = 2
    seen_scan = False
    eof_warned = False
    while True:
        # next marker (libjpeg's next_marker; fill bytes are skipped)
        while pos < n and data[pos] != 0xFF:
            pos += 1
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            if not seen_scan:
                _fail("Invalid JPEG file structure: missing SOS marker")
            if not eof_warned:
                warn.add(_W_EOF)
            break
        m = data[pos]
        pos += 1
        if m == 0xD9:                               # EOI
            if not seen_scan:
                _fail("Invalid JPEG file structure: missing SOS marker")
            break
        if m in (0x01, 0xD8) or 0xD0 <= m <= 0xD7:  # no payload
            continue
        if pos + 2 > n:
            _fail("Premature end of JPEG file in a marker segment")
        seg_len = _u16(data, pos)
        if seg_len < 2 or pos + seg_len > n:
            _fail(f"Bogus marker length in marker 0x{m:02x}")
        body = data[pos + 2:pos + seg_len]
        pos += seg_len

        if m == 0xDB:                               # DQT
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                width = 2 if pq else 1
                if tq > 3 or i + 1 + 64 * width > len(body):
                    _fail("Bogus DQT definition")
                raw = np.frombuffer(body, ">u2" if pq else "u1", 64, i + 1)
                table = np.zeros(64, np.uint16)
                table[list(_NATURAL)] = raw
                qtabs[tq] = table.reshape(8, 8)
                i += 1 + 64 * width
        elif m == 0xC4:                             # DHT
            i = 0
            while i < len(body):
                if i + 17 > len(body):
                    _fail("Bogus Huffman table definition")
                tc, th = body[i] >> 4, body[i] & 15
                counts = list(body[i + 1:i + 17])
                total = sum(counts)
                if tc > 1 or th > 3 or total > 256 or (
                        i + 17 + total > len(body)):
                    _fail("Bogus Huffman table definition")
                luts = _huff_tables(counts, body[i + 17:i + 17 + total])
                (ac_tabs if tc else dc_tabs)[th] = luts
                i += 17 + total
        elif m == 0xDD:                             # DRI
            if len(body) < 2:
                _fail("Bogus DRI marker")
            restart = _u16(body, 0)
        elif m in (0xC0, 0xC1):                     # sequential Huffman
            if frame is not None:
                _fail("Invalid JPEG file structure: two SOF markers")
            if len(body) < 6:
                _fail("Bogus SOF marker length")
            precision = body[0]
            height, width, ncomp = _u16(body, 1), _u16(body, 3), body[5]
            if precision != 8:
                _fail(f"Unsupported JPEG data precision {precision}")
            if ncomp < 1 or ncomp > 4:
                raise ValueError(
                    f"unsupported number of components: {ncomp}")
            if height == 0 or width == 0 or len(body) < 6 + 3 * ncomp:
                _fail("Empty JPEG image (DNL not supported)")
            comps = []
            for c in range(ncomp):
                cid, hv, tq = body[6 + 3 * c:9 + 3 * c]
                h, v = hv >> 4, hv & 15
                if not (1 <= h <= 4 and 1 <= v <= 4):
                    _fail("Bogus sampling factors")
                comps.append(dict(id=cid, h=h, v=v, tq=tq))
            max_h = max(cp["h"] for cp in comps)
            max_v = max(cp["v"] for cp in comps)
            mcus_x = -(-width // (8 * max_h))
            mcus_y = -(-height // (8 * max_v))
            for c, cp in enumerate(comps):
                cp["w_samp"] = max_h // cp["h"]
                cp["h_samp"] = max_v // cp["v"]
                cp["nby"] = -(-height * cp["v"] // (8 * max_v))
                cp["nbx"] = -(-width * cp["h"] // (8 * max_h))
                # dimension consistency (jpeg.c:59-64)
                if (cp["nby"] != (height // cp["h_samp"] + 7) // 8 or
                        cp["nbx"] != (width // cp["w_samp"] + 7) // 8):
                    raise ValueError(
                        f"jpeg invalid coef size for component {c}")
                cp["nby_alloc"] = mcus_y * cp["v"]
                cp["nbx_alloc"] = mcus_x * cp["h"]
            frame = (height, width, comps)
        elif m == 0xC2 or m == 0xC6 or m == 0xCA or m == 0xCE:
            raise ValueError(
                "progressive JPEG is not supported by this reader "
                "(baseline and extended sequential Huffman only)")
        elif m in (0xC3, 0xC5, 0xC7, 0xC9, 0xCB, 0xCD, 0xCF):
            kind = "arithmetic-coded" if m >= 0xC9 else "lossless or hierarchical"
            raise ValueError(
                f"{kind} JPEG (SOF 0x{m:02x}) is not supported by this "
                "reader (baseline and extended sequential Huffman only)")
        elif m == 0xDA:                             # SOS
            if frame is None:
                _fail("Invalid JPEG file structure: SOS before SOF")
            height, width, comps = frame
            if quants is None:
                # tables as defined before the first scan, with the
                # reference's validation (jpeg.c:36-47)
                quants = []
                for cp in comps:
                    if cp["tq"] > 3:
                        raise ValueError("weird jpeg: invalid quant_tbl_no")
                    if cp["tq"] not in qtabs:
                        raise ValueError(
                            "weird jpeg: no quant table pointer")
                    if (qtabs[cp["tq"]] == 0).any():
                        raise ValueError("invalid quantization table")
                    quants.append(qtabs[cp["tq"]].copy())
                coef = [([], []) for _ in comps]
            ns = body[0] if body else 0
            if ns < 1 or ns > 4 or len(body) < 4 + 2 * ns:
                _fail("Bogus SOS marker length")
            ids = [cp["id"] for cp in comps]
            scan_comps, dc_luts, ac_luts = [], [], []
            for s in range(ns):
                cid, tables = body[1 + 2 * s], body[2 + 2 * s]
                if cid not in ids:
                    _fail(f"Invalid component ID {cid} in SOS")
                td, ta = tables >> 4, tables & 15
                if td not in dc_tabs or ta not in ac_tabs:
                    _fail("Huffman table 0x%02x was not defined"
                          % (td if td not in dc_tabs else ta))
                scan_comps.append(ids.index(cid))
                dc_luts.append(dc_tabs[td])
                ac_luts.append(ac_tabs[ta])
            ss, se, ahl = body[1 + 2 * ns], body[2 + 2 * ns], body[3 + 2 * ns]
            if ss != 0 or se != 63 or ahl != 0:
                warn.add(_W_NOT_SEQUENTIAL)
            seen_scan = True
            units = _scan_units(scan_comps, comps, mcus_x, mcus_y)
            segs, pos, hit_eof = _split_entropy(data, pos, restart > 0)
            if hit_eof:
                warn.add(_W_EOF)
                eof_warned = True
            per = restart if restart > 0 else len(units)
            idx_out = [coef[ci][0] for ci in scan_comps]
            val_out = [coef[ci][1] for ci in scan_comps]
            for r in range(0, len(units), per):
                seg_i = r // per
                seg = segs[seg_i] if seg_i < len(segs) else b""
                _decode_segment(seg, units[r:r + per], dc_luts, ac_luts,
                                idx_out, val_out, warn)
            if hit_eof:
                break
        # APPn, COM, DNL and other segments carry nothing the solver needs

    height, width, comps = frame
    planes = []
    for c, cp in enumerate(comps):
        flat = np.zeros(cp["nby_alloc"] * cp["nbx_alloc"] * 64, np.int16)
        idx, val = coef[c]
        if idx:
            flat[np.asarray(idx, np.int64)] = np.asarray(val, np.int64)
        data4 = flat.reshape(cp["nby_alloc"], cp["nbx_alloc"], 8, 8)
        planes.append(CoefPlane(
            data=np.ascontiguousarray(data4[:cp["nby"], :cp["nbx"]]),
            quant=quants[c],
            h_samp=cp["h_samp"],
            w_samp=cp["w_samp"],
        ))
    return height, width, planes, warn


def read_jpeg(src: Union[str, pathlib.Path, bytes],
              print_warnings: bool = True) -> JpegImage:
    """Read DCT coefficients + quant tables from a JPEG file or buffer.

    Raises ValueError on malformed or unsupported input.  Corrupt but
    decodable input decodes with warnings collected on
    JpegImage.warnings and (like the reference's die_output_message,
    jpeg.c:14-19) printed to stderr unless print_warnings=False.
    """
    if isinstance(src, (str, pathlib.Path)):
        with open(src, "rb") as f:
            raw = f.read()
    else:
        raw = bytes(src)
    height, width, planes, warn = _parse(raw)
    if print_warnings:
        for w in warn.texts:
            print(f"jpeg warning: {w}", file=sys.stderr)
    return JpegImage(
        height=height,
        width=width,
        progressive=False,
        planes=planes,
        warnings=tuple(warn.texts),
        n_warnings=warn.count,
    )


def require_supported(img: JpegImage, strict_reference_compat: bool = False):
    """Component-count policy.

    The reference supports exactly 3-component JPEGs (jpeg.c:34); this
    framework additionally handles grayscale.  With
    strict_reference_compat, mirror the reference's error instead.
    """
    if strict_reference_compat and img.nchannel != 3:
        raise ValueError("only 3 component jpegs are supported")
    if img.nchannel not in (1, 3):
        raise ValueError(
            f"unsupported number of components: {img.nchannel} "
            "(grayscale and YCbCr are supported)"
        )
