"""JPEG DCT-coefficient reading (host side): Python marker parsing in
front of a compiled entropy decoder.

The port needs no libjpeg.  This module parses the JPEG markers itself
and hands each scan to the C decoder in csrc/jpeg_entropy.c (built with
the C compiler at first use, loaded with ctypes, which releases the
interpreter lock for the call), never computing pixels: the solver wants
the exact integer lattice (reference: jpeg.c:22-80).  It reads every DCT
JPEG with 8-bit samples that libjpeg-turbo reads: Huffman-coded baseline
and extended sequential (SOF0, SOF1) and progressive (SOF2), and
arithmetic-coded sequential (SOF9) and progressive (SOF10), interleaved or
not, with or without restart intervals.  Lossless (SOF3, SOF11) and
hierarchical (SOF5-7, SOF13-15) streams raise ValueError, as libjpeg-turbo
refuses them.

The dataclasses keep the JAX package's reader interface: per component
an int16 tensor [nby, nbx, 8, 8] in natural order, its uint16 quant
table [8, 8] and its replication factors.  Markers and scans are handled
as libjpeg-turbo handles them (jdmarker.c, jdinput.c, jdphuff.c,
jdarith.c): each component's quantization table is latched at the first
scan that holds it, progressive scan parameters are validated with
libjpeg's texts, DAC segments set the arithmetic conditioning (libjpeg's
defaults where none is given), and corrupt or truncated data decodes to
libjpeg's coefficients with its warning texts on JpegImage.warnings.
"""

from __future__ import annotations

import ctypes
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

# libjpeg's warning texts (jerror.h); the C decoder reports them by code
_W_EOF = "Premature end of JPEG file"
_W_HIT_MARKER = "Corrupt JPEG data: premature end of data segment"
_W_BAD_CODE = "Corrupt JPEG data: bad Huffman code"
_W_ARITH_BAD_CODE = "Corrupt JPEG data: bad arithmetic code"
_W_MUST_RESYNC = "Corrupt JPEG data: found marker 0x{:02x} instead of RST{}"
_W_EXTRANEOUS = ("Corrupt JPEG data: {} extraneous bytes before marker "
                 "0x{:02x}")
_W_NOT_SEQUENTIAL = "Invalid SOS parameters for sequential JPEG"
_W_BOGUS_PROGRESSION = ("Inconsistent progression sequence for component {} "
                        "coefficient {}")
_W_JFIF_MAJOR = "Warning: unknown JFIF revision number {}.{:02d}"
_C_WARNINGS = {1: _W_EOF, 2: _W_HIT_MARKER, 3: _W_BAD_CODE,
               4: _W_MUST_RESYNC, 5: _W_EXTRANEOUS, 6: _W_ARITH_BAD_CODE}
_C_ERRORS = {-1: "Bogus Huffman table definition",
             -2: "DCT coefficient out of range"}
_WARN_CAP = 16           # warnings the C decoder records per scan
_MAX_BLOCKS_IN_MCU = 10  # D_MAX_BLOCKS_IN_MCU
_N_ARITH_TABLES = 16     # NUM_ARITH_TBLS: conditioning tables 0-15
# the frame types libjpeg-turbo refuses, by SOF marker
_UNSUPPORTED_SOF = {
    0xC3: "lossless (Huffman, SOF3)",
    0xC5: "differential sequential (Huffman, SOF5)",
    0xC6: "differential progressive (Huffman, SOF6)",
    0xC7: "differential lossless (Huffman, SOF7)",
    0xC8: "reserved JPG extension (SOF8)",
    0xCB: "lossless (arithmetic, SOF11)",
    0xCD: "differential sequential (arithmetic, SOF13)",
    0xCE: "differential progressive (arithmetic, SOF14)",
    0xCF: "differential lossless (arithmetic, SOF15)",
}


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


def _decode_scan_fn():
    """The C decoder's entry point, built and loaded at first use."""
    from jpeg2png_tpu_torch.kernels import _build

    fn = _build.library("jpeg_entropy").j2p_decode_scan
    if fn.argtypes is None:
        p = ctypes.c_void_p
        i32, i64 = ctypes.c_int32, ctypes.c_int64
        fn.argtypes = [ctypes.c_char_p, i64, p, i32, p, p, p, p, i32, i32,
                       i32, i32, i32, i32, i32, i32, p, p, i32, p]
        fn.restype = ctypes.c_int
    return fn


def _u16(data, i):
    return (data[i] << 8) | data[i + 1]


class _Source:
    """The byte stream outside the scans, read as libjpeg reads it
    (jdmarker.c, jdatasrc.c): bytes skipped before a marker are counted
    (a warning names them when the marker is found; restarts inside scans
    add to the same count), and past the end the source warns and yields
    a fake EOI (FF D9), as libjpeg's memory source does, also inside a
    marker segment."""

    def __init__(self, data: bytes, warn: _Warnings):
        self.data = data
        self.warn = warn
        self.discarded = 0
        self.fake_left = 0      # bytes left of the current fake EOI

    def _fake(self) -> int:
        if self.fake_left == 0:
            self.warn.add(_W_EOF)
            self.fake_left = 2
        self.fake_left -= 1
        return 0xFF if self.fake_left == 1 else 0xD9

    def _byte(self, pos: int):
        if pos < len(self.data):
            return self.data[pos], pos + 1
        return self._fake(), pos

    def read(self, pos: int, k: int):
        """`k` bytes from `pos` (fake ones past the end), and the offset
        after them."""
        out = self.data[pos:pos + k]
        pos += len(out)
        if len(out) < k:
            out += bytes(self._fake() for _ in range(k - len(out)))
        return out, pos

    def next_marker(self, pos: int):
        """(marker code, offset past it) of the next marker at or after
        `pos`; FF 00 pairs and other bytes before it are discarded."""
        data, n = self.data, len(self.data)
        while True:
            if pos < n:
                j = data.find(b"\xff", pos)
                j = n if j < 0 else j
                self.discarded += j - pos
                pos = j
            c, pos = self._byte(pos)
            while c != 0xFF:
                self.discarded += 1
                c, pos = self._byte(pos)
            c, pos = self._byte(pos)
            while c == 0xFF:                    # fill bytes
                c, pos = self._byte(pos)
            if c != 0:
                break
            self.discarded += 2
        if self.discarded:
            self.warn.add(_W_EXTRANEOUS.format(self.discarded, c))
            self.discarded = 0
        return c, pos


def _latch_quant(cp, qtabs):
    """A component's table as it stands at its first scan (libjpeg's
    latch_quant_tables), with the reference's validation (jpeg.c:36-47)."""
    if cp["tq"] > 3:
        raise ValueError("weird jpeg: invalid quant_tbl_no")
    if cp["tq"] not in qtabs:
        raise ValueError("weird jpeg: no quant table pointer")
    if (qtabs[cp["tq"]] == 0).any():
        raise ValueError("invalid quantization table")
    cp["quant"] = qtabs[cp["tq"]].copy()


def _parse_sof(body, progressive, arith):
    if len(body) < 6:
        _fail("Bogus SOF marker length")
    precision = body[0]
    height, width, ncomp = _u16(body, 1), _u16(body, 3), body[5]
    if precision != 8:
        _fail(f"Unsupported JPEG data precision {precision}")
    if ncomp < 1 or ncomp > 4:
        raise ValueError(f"unsupported number of components: {ncomp}")
    if len(body) != 6 + 3 * ncomp:
        _fail("Bogus marker length")
    if height == 0 or width == 0:
        _fail("Empty JPEG image (DNL not supported)")
    comps = []
    for c in range(ncomp):
        cid, hv, tq = body[6 + 3 * c:9 + 3 * c]
        h, v = hv >> 4, hv & 15
        if not (1 <= h <= 4 and 1 <= v <= 4):
            _fail("Bogus sampling factors")
        comps.append(dict(id=cid, h=h, v=v, tq=tq, quant=None,
                          coef_bits=[-1] * 64))
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
            raise ValueError(f"jpeg invalid coef size for component {c}")
        cp["nby_alloc"] = mcus_y * cp["v"]
        cp["nbx_alloc"] = mcus_x * cp["h"]
    return dict(height=height, width=width, comps=comps, mcus_x=mcus_x,
                mcus_y=mcus_y, progressive=progressive, arith=arith,
                planes=None, scans=0, multiple_scans=True)


def _progression(comps, scan_comps, ss, se, ah, al, warn):
    """jdphuff.c start_pass_phuff_decoder: validate a progressive scan's
    parameters and track each coefficient's successive-approximation
    bits per component, warning where libjpeg does."""
    bad = (se != 0 if ss == 0 else ss > se or se > 63
           or len(scan_comps) != 1)
    if (ah != 0 and al != ah - 1) or al > 13:
        bad = True
    if bad:
        _fail(f"Invalid progressive parameters Ss={ss} Se={se} Ah={ah} "
              f"Al={al}")
    for ci in scan_comps:
        bits = comps[ci]["coef_bits"]
        if ss != 0 and bits[0] < 0:     # AC without a prior DC scan
            warn.add(_W_BOGUS_PROGRESSION.format(ci, 0))
        for k in range(ss, se + 1):
            if ah != max(bits[k], 0):
                warn.add(_W_BOGUS_PROGRESSION.format(ci, k))
            bits[k] = al


# ITU T.81 Annex K.3 tables, (class, slot) -> code counts, symbols (hex):
# libjpeg-turbo's sequential decoder supplies them for slots 0 and 1 that
# were never defined (jstdhuff.c; Motion-JPEG frames carry no DHT)
_STD_TABLES = {
    (0, 0): ("00010501010101010100000000000000", "000102030405060708090a0b"),
    (0, 1): ("00030101010101010101010000000000", "000102030405060708090a0b"),
    (1, 0): ("0002010303020403050504040000017d",
             "01020300041105122131410613516107227114328191a1082342b1c11552d1"
             "f02433627282090a161718191a25262728292a3435363738393a434445464"
             "748494a535455565758595a636465666768696a737475767778797a838485"
             "868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b"
             "9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1"
             "f2f3f4f5f6f7f8f9fa"),
    (1, 1): ("00020102040403040705040400010277",
             "000102031104052131061241510761711322328108144291a1b1c10923335"
             "2f0156272d10a162434e125f11718191a262728292a35363738393a434445"
             "464748494a535455565758595a636465666768696a737475767778797a828"
             "38485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6"
             "b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9e"
             "af2f3f4f5f6f7f8f9fa"),
}


def _table_spec(tables, tc, index, progressive):
    """The table a scan uses from slot `index` of class `tc` (0 DC, 1 AC);
    in a sequential file, the standard one where slot 0 or 1 was never
    defined."""
    if index not in tables:
        if progressive or (tc, index) not in _STD_TABLES:
            _fail(f"Huffman table 0x{index:02x} was not defined")
        counts, symbols = _STD_TABLES[tc, index]
        tables[index] = _huff_spec(bytes.fromhex(counts),
                                   bytes.fromhex(symbols))
    return tables[index]


def _decode_scan(data, pos, body, frame, tabs, restart, src, warn):
    """One SOS: validate it as libjpeg does, latch the quant tables of
    its components, and entropy-decode its data in C.  Returns (offset
    of the next unread byte, the marker that ended the scan or 0)."""
    qtabs, dc_tabs, ac_tabs, cond = tabs
    comps = frame["comps"]
    ns = body[0] if body else 0
    if ns < 1 or ns > 4 or len(body) != 4 + 2 * ns:
        _fail("Bogus marker length")
    scan_comps, table_ids = [], []
    for s in range(ns):
        cid, tables = body[1 + 2 * s], body[2 + 2 * s]
        for ci, cp in enumerate(comps):
            if cp["id"] == cid and ci not in scan_comps:
                break
        else:
            _fail(f"Invalid component ID {cid} in SOS")
        scan_comps.append(ci)
        table_ids.append((tables >> 4, tables & 15))
    ss, se, ahl = body[1 + 2 * ns], body[2 + 2 * ns], body[3 + 2 * ns]
    ah, al = ahl >> 4, ahl & 15
    progressive = frame["progressive"]

    # jdinput.c: the first scan sets up the frame; a single-scan sequential
    # file may not have a second
    if frame["scans"] == 0:
        frame["multiple_scans"] = progressive or ns < len(comps)
        frame["planes"] = [
            np.zeros((cp["nby_alloc"], cp["nbx_alloc"], 8, 8), np.int16)
            for cp in comps]
    elif not frame["multiple_scans"]:
        _fail("Didn't expect more than one scan")
    frame["scans"] += 1
    if ns > 1 and sum(comps[ci]["h"] * comps[ci]["v"]
                      for ci in scan_comps) > _MAX_BLOCKS_IN_MCU:
        _fail("Sampling factors too large for interleaved scan")
    for ci in scan_comps:
        if comps[ci]["quant"] is None:
            _latch_quant(comps[ci], qtabs)

    dc_needed = ac_needed = True
    if progressive:
        _progression(comps, scan_comps, ss, se, ah, al, warn)
        dc_needed = ss == 0 and ah == 0
        ac_needed = ss != 0
    elif ss != 0 or se != 63 or ahl != 0:
        warn.add(_W_NOT_SEQUENTIAL)
    arith = None
    if frame["arith"]:
        # no Huffman tables: the selectors name conditioning tables 0-15
        # (all valid), whose DAC values the C decoder gets per component
        dc_specs = ac_specs = [None] * ns
        arith = (ctypes.c_int32 * (5 * ns))(*[
            x for td, ta in table_ids
            for x in (td, ta, cond["L"][td], cond["U"][td], cond["K"][ta])])
    else:
        dc_specs = [_table_spec(dc_tabs, 0, td, progressive) if dc_needed
                    else None for td, _ in table_ids]
        ac_specs = [_table_spec(ac_tabs, 1, ta, progressive) if ac_needed
                    else None for _, ta in table_ids]

    planes = [frame["planes"][ci] for ci in scan_comps]
    geom = (ctypes.c_int32 * (6 * ns))(*[
        x for ci in scan_comps for x in (
            comps[ci]["h"], comps[ci]["v"], comps[ci]["nbx"],
            comps[ci]["nby"], comps[ci]["nbx_alloc"], comps[ci]["nby_alloc"])])
    coefs = (ctypes.c_void_p * ns)(*[p.ctypes.data for p in planes])
    dcs = (ctypes.c_char_p * ns)(*dc_specs)
    acs = (ctypes.c_char_p * ns)(*ac_specs)
    state = (ctypes.c_int64 * 4)(pos, 0, src.discarded, src.fake_left)
    warns = (ctypes.c_int32 * (3 * _WARN_CAP))()
    n_warn = ctypes.c_int32(0)
    rc = _decode_scan_fn()(
        data, len(data), state, ns, geom, coefs, dcs, acs,
        frame["mcus_x"], frame["mcus_y"], int(progressive), ss, se, ah, al,
        restart, arith, warns, _WARN_CAP, ctypes.byref(n_warn))
    if rc:
        _fail(_C_ERRORS.get(rc, f"entropy decoder error {rc}"))
    for i in range(min(n_warn.value, _WARN_CAP)):
        code, a, b = warns[3 * i:3 * i + 3]
        warn.add(_C_WARNINGS[code].format(a, b))
    warn.count += max(n_warn.value - _WARN_CAP, 0)
    src.discarded, src.fake_left = state[2], state[3]
    return state[0], state[1]


def _huff_spec(counts, symbols) -> bytes:
    """16 code counts + 256 symbols, zero-padded: the C decoder's table
    input (it builds and validates the lookup tables itself)."""
    return bytes(counts) + bytes(symbols) + bytes(256 - len(symbols))


def _parse(data: bytes):
    n = len(data)
    if n < 2 or data[0] != 0xFF or data[1] != 0xD8:
        _fail("Not a JPEG file")
    warn = _Warnings()
    src = _Source(data, warn)
    qtabs, dc_tabs, ac_tabs = {}, {}, {}
    # arithmetic conditioning per table (DAC), libjpeg's defaults at SOI
    cond = {"L": [0] * _N_ARITH_TABLES, "U": [1] * _N_ARITH_TABLES,
            "K": [5] * _N_ARITH_TABLES}
    restart = 0
    frame = None
    pos = 2
    marker = 0          # a marker the entropy decoder already read
    while True:
        if marker:
            m = marker
            marker = 0
        else:
            m, pos = src.next_marker(pos)
        if m == 0xD9:                               # EOI
            if frame is None or frame["scans"] == 0:
                _fail("Invalid JPEG file structure: missing SOS marker")
            break
        if m == 0x01 or 0xD0 <= m <= 0xD7:          # no payload
            continue
        if m == 0xD8:
            _fail("Invalid JPEG file structure: two SOI markers")
        if not (0xC0 <= m <= 0xDD or 0xE0 <= m <= 0xEF or m == 0xFE):
            _fail(f"Unsupported marker type 0x{m:02x}")
        length, pos = src.read(pos, 2)
        seg_len = _u16(length, 0)
        if seg_len < 2:
            if not (0xE0 <= m <= 0xEF or m in (0xDC, 0xFE)):
                _fail(f"Bogus marker length in marker 0x{m:02x}")
            seg_len = 2     # APPn, DNL and COM: skip_variable skips nothing
        body, pos = src.read(pos, seg_len - 2)

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
                counts = body[i + 1:i + 17]
                total = sum(counts)
                if tc > 1 or th > 3 or total > 256 or (
                        i + 17 + total > len(body)):
                    _fail("Bogus Huffman table definition")
                spec = _huff_spec(counts, body[i + 17:i + 17 + total])
                (ac_tabs if tc else dc_tabs)[th] = spec
                i += 17 + total
        elif m == 0xDD:                             # DRI
            if len(body) != 2:
                _fail("Bogus marker length")
            restart = _u16(body, 0)
        elif m in (0xC0, 0xC1, 0xC2, 0xC9, 0xCA):   # DCT SOF
            if frame is not None:
                _fail("Invalid JPEG file structure: two SOF markers")
            frame = _parse_sof(body, progressive=m in (0xC2, 0xCA),
                               arith=m >= 0xC9)
        elif m in _UNSUPPORTED_SOF:
            raise ValueError(
                f"{_UNSUPPORTED_SOF[m]} JPEG is not supported by this "
                "reader, nor by libjpeg-turbo (sequential and progressive "
                "DCT only)")
        elif m == 0xDA:                             # SOS
            if frame is None:
                _fail("Invalid JPEG file structure: SOS before SOF")
            pos, marker = _decode_scan(data, pos, body, frame,
                                       (qtabs, dc_tabs, ac_tabs, cond),
                                       restart, src, warn)
        elif m == 0xCC:                             # DAC (get_dac)
            for i in range(0, len(body) - 1, 2):
                index, val = body[i], body[i + 1]
                if index >= 2 * _N_ARITH_TABLES:
                    _fail(f"Bogus DAC index {index}")
                if index >= _N_ARITH_TABLES:
                    cond["K"][index - _N_ARITH_TABLES] = val
                else:
                    cond["L"][index], cond["U"][index] = val & 15, val >> 4
                    if (val & 15) > (val >> 4):
                        _fail(f"Bogus DAC value 0x{val:x}")
            if len(body) % 2:
                _fail("Bogus marker length")
        elif m == 0xE0 and len(body) >= 14 and body[:5] == b"JFIF\0":
            if body[5] != 1:                        # examine_app0
                warn.add(_W_JFIF_MAJOR.format(body[5], body[6]))
        # other APPn, COM, DNL: nothing the solver needs

    planes = []
    for cp, plane in zip(frame["comps"], frame["planes"]):
        if cp["quant"] is None:     # no scan reached this component
            _latch_quant(cp, qtabs)
        planes.append(CoefPlane(
            data=np.ascontiguousarray(plane[:cp["nby"], :cp["nbx"]]),
            quant=cp["quant"],
            h_samp=cp["h_samp"],
            w_samp=cp["w_samp"],
        ))
    return frame, planes, warn


def read_jpeg(src: Union[str, pathlib.Path, bytes],
              print_warnings: bool = True) -> JpegImage:
    """Read DCT coefficients + quant tables from a JPEG file or buffer.

    Raises ValueError on malformed or unsupported input, and
    RuntimeError (with the compiler's output) if the entropy decoder
    cannot be built.  Corrupt but decodable input decodes with warnings
    collected on JpegImage.warnings and (like the reference's
    die_output_message, jpeg.c:14-19) printed to stderr unless
    print_warnings=False.
    """
    if isinstance(src, (str, pathlib.Path)):
        with open(src, "rb") as f:
            raw = f.read()
    else:
        raw = bytes(src)
    frame, planes, warn = _parse(raw)
    if print_warnings:
        for w in warn.texts:
            print(f"jpeg warning: {w}", file=sys.stderr)
    return JpegImage(
        height=frame["height"],
        width=frame["width"],
        progressive=frame["progressive"],
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
