"""A baseline JFIF writer in numpy that records the coefficients it wrote.

The arithmetic of the repository's tools/tiny_jpeg.py, frozen here for
the benchmark: libjpeg's quality curve on the Annex K tables, JFIF
RGB -> YCbCr, box-mean chroma downsampling with edge padding, an
orthonormal 8x8 DCT, rounding to the quantisation step, the Annex K
Huffman tables and interleaved MCUs.  Everything that tiny_jpeg does
block by block and bit by bit is done here over whole arrays: the
symbols of all blocks are built at once, sorted into scan order, and
packed into bytes with one expansion to bits and np.packbits.

encode() returns the JPEG bytes and, per component, the quantised
coefficients as a JPEG reader returns them (int16 [nby, nbx, 8, 8] in
natural order, the blocks that cover the component's own samples), its
quantisation table and its sampling.
"""

from __future__ import annotations

import struct

import numpy as np

_QL = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
    np.int32).reshape(8, 8)
_QC = np.full((8, 8), 99, np.int32)
_QC[:4, :4] = np.array([17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 99,
                        47, 66, 99, 99]).reshape(4, 4)

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

_DC_L = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
_DC_C = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
_AC_L = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d], bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa"))
_AC_C = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa"))

# sampling factors (H, V) of Y, Cb, Cr for each chroma layout
SAMPLING = {"4:2:0": ((2, 2), (1, 1), (1, 1)),
            "4:2:2": ((2, 1), (1, 1), (1, 1)),
            "4:4:4": ((1, 1), (1, 1), (1, 1))}


def scale_table(base, quality: int) -> np.ndarray:
    """libjpeg's quality scaling (jcparam.c)."""
    quality = max(1, min(100, quality))
    s = 5000 // quality if quality < 50 else 200 - quality * 2
    return np.clip((base * s + 50) // 100, 1, 255).astype(np.int32)


def _huff_lookup(spec):
    """Symbol -> (code, length) as two arrays of 256."""
    bits, values = spec
    codes = np.zeros(256, np.int64)
    lens = np.zeros(256, np.int64)
    code, k = 0, 0
    for ln in range(1, 17):
        for _ in range(bits[ln - 1]):
            codes[values[k]] = code
            lens[values[k]] = ln
            code += 1
            k += 1
        code <<= 1
    return codes, lens


def _dct_matrix() -> np.ndarray:
    n = np.arange(8)
    c = np.cos((2 * n[:, None] + 1) * n[None, :] * np.pi / 16)
    d = c.T / 2.0
    d[0, :] /= np.sqrt(2.0)
    return d


def _category(v):
    """Bits needed for |v| (JPEG's magnitude category), and v's extra
    bits (one's complement for negatives)."""
    a = np.abs(v)
    size = np.zeros(v.shape, np.int64)
    while np.any(a >> size):
        size += (a >> size) > 0
    extra = np.where(v < 0, v + (1 << size) - 1, v) & ((1 << size) - 1)
    return size, extra


def _pack(codes, lens) -> bytes:
    """Concatenate (code, length) pairs MSB first, pad the last byte with
    1-bits, and stuff a 0x00 after every 0xFF."""
    keep = lens > 0
    codes, lens = codes[keep], lens[keep]
    total = int(lens.sum())
    starts = np.cumsum(lens) - lens
    rep_len = np.repeat(lens, lens)
    pos = np.arange(total, dtype=np.int64) - np.repeat(starts, lens)
    bits = ((np.repeat(codes, lens) >> (rep_len - 1 - pos)) & 1).astype(
        np.uint8)
    pad = (-total) % 8
    if pad:
        bits = np.concatenate([bits, np.ones(pad, np.uint8)])
    out = np.packbits(bits)
    ff = np.nonzero(out == 0xFF)[0]
    return np.insert(out, ff + 1, 0).tobytes()


def encode(rgb: np.ndarray, quality: int, layout: str = "4:2:0"):
    """[H, W, 3] uint8 -> (JPEG bytes, components), components a list of
    (coefs int16 [nby, nbx, 8, 8], quant uint16 [8, 8], (sy, sx)) with
    (sy, sx) the canvas rows and columns one sample covers."""
    sampling = SAMPLING[layout]
    H, W = rgb.shape[:2]
    r, g, b = (rgb[..., i].astype(np.float64) for i in range(3))
    planes = [0.299 * r + 0.587 * g + 0.114 * b - 128.0,
              -0.168736 * r - 0.331264 * g + 0.5 * b,
              0.5 * r - 0.418688 * g - 0.081312 * b]
    hmax = max(s[0] for s in sampling)
    vmax = max(s[1] for s in sampling)
    qt = [scale_table(_QL, quality), scale_table(_QC, quality)]
    mcux, mcuy = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    D = _dct_matrix()
    tabs = [(_huff_lookup(_DC_L), _huff_lookup(_AC_L)),
            (_huff_lookup(_DC_C), _huff_lookup(_AC_C))]

    comps, scan = [], []
    for ci, (hs, vs) in enumerate(sampling):
        p = planes[ci]
        fy, fx = vmax // vs, hmax // hs
        if fy > 1 or fx > 1:
            ph, pw = -(-p.shape[0] // fy) * fy, -(-p.shape[1] // fx) * fx
            p = np.pad(p, ((0, ph - p.shape[0]), (0, pw - p.shape[1])),
                       mode="edge")
            p = p.reshape(ph // fy, fy, pw // fx, fx).mean(axis=(1, 3))
        nyb, nxb = mcuy * vs, mcux * hs
        p = np.pad(p, ((0, nyb * 8 - p.shape[0]), (0, nxb * 8 - p.shape[1])),
                   mode="edge")
        blocks = p.reshape(nyb, 8, nxb, 8).transpose(0, 2, 1, 3)
        q = qt[0 if ci == 0 else 1]
        coef = np.round((D @ blocks @ D.T) / q).astype(np.int32)
        # the blocks a reader returns: those covering the component's
        # own samples, ceil(H * V / Vmax / 8) x ceil(W * H / Hmax / 8)
        nby, nbx = -(-H * vs // (8 * vmax)), -(-W * hs // (8 * hmax))
        comps.append((coef[:nby, :nbx].astype(np.int16),
                      q.astype(np.uint16), (fy, fx)))
        # this component's blocks in scan order: MCU by MCU, vs x hs each
        zz = coef.reshape(nyb, nxb, 64)[:, :, ZIGZAG]
        order = zz.reshape(mcuy, vs, mcux, hs, 64).transpose(0, 2, 1, 3, 4)
        scan.append(order.reshape(mcuy * mcux, vs * hs, 64))

    # blocks of all components in scan order, with the component of each
    per_mcu = [s.shape[1] for s in scan]
    zz = np.concatenate(scan, axis=1).reshape(-1, 64)
    comp = np.tile(np.repeat(np.arange(3), per_mcu), mcux * mcuy)
    seq = np.arange(zz.shape[0])
    codes, lens, keys = [], [], []

    def emit(code, length, key):
        codes.append(code)
        lens.append(length)
        keys.append(key)

    dc = zz[:, 0].astype(np.int64)
    diff = np.empty_like(dc)
    for ci in range(3):
        m = comp == ci
        d = dc[m]
        diff[m] = d - np.concatenate([[0], d[:-1]])
    size, extra = _category(diff)
    chroma = (comp > 0).astype(np.int64)
    dcc = np.stack([tabs[0][0][0], tabs[1][0][0]])
    dcl = np.stack([tabs[0][0][1], tabs[1][0][1]])
    acc = np.stack([tabs[0][1][0], tabs[1][1][0]])
    acl = np.stack([tabs[0][1][1], tabs[1][1][1]])
    emit(dcc[chroma, size], dcl[chroma, size], seq * 1000)
    emit(extra, size, seq * 1000 + 1)

    ac = zz[:, 1:].astype(np.int64)
    bi, kk = np.nonzero(ac)
    k = kk + 1                                   # zigzag position 1..63
    prev = np.zeros_like(k)
    prev[1:] = np.where(bi[1:] == bi[:-1], k[:-1], 0)
    run = k - prev - 1
    for z in range(3):                           # a run of 16 zeros: ZRL
        m = run // 16 > z
        emit(acc[chroma[bi[m]], 0xF0], acl[chroma[bi[m]], 0xF0],
             bi[m] * 1000 + k[m] * 10 + z)
    size, extra = _category(ac[bi, kk])
    sym = ((run % 16) << 4) | size
    emit(acc[chroma[bi], sym], acl[chroma[bi], sym], bi * 1000 + k * 10 + 5)
    emit(extra, size, bi * 1000 + k * 10 + 6)
    last = np.zeros(zz.shape[0], np.int64)
    last[bi] = k                                 # bi is sorted: the last wins
    eob = last < 63
    emit(acc[chroma[eob], 0x00], acl[chroma[eob], 0x00], seq[eob] * 1000 + 999)

    keys = np.concatenate(keys)
    order = np.argsort(keys, kind="stable")
    data = _pack(np.concatenate(codes)[order], np.concatenate(lens)[order])

    out = bytearray(b"\xff\xd8")
    out += b"\xff\xe0" + struct.pack(">H", 16) + (
        b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    for ti, t in enumerate(qt):
        out += b"\xff\xdb" + struct.pack(">HB", 67, ti)
        out += bytes(int(v) for v in t.flatten()[ZIGZAG])
    out += b"\xff\xc0" + struct.pack(">HBHHB", 17, 8, H, W, 3)
    for ci, (hs, vs) in enumerate(sampling):
        out += struct.pack("BBB", ci + 1, (hs << 4) | vs, 0 if ci == 0 else 1)
    for tc, ti, (bits, values) in ((0, 0, _DC_L), (0, 1, _DC_C),
                                   (1, 0, _AC_L), (1, 1, _AC_C)):
        out += b"\xff\xc4" + struct.pack(">HB", 19 + len(values),
                                         (tc << 4) | ti)
        out += bytes(bits) + bytes(values)
    out += b"\xff\xda" + struct.pack(">HB", 12, 3)
    for ci in range(3):
        t = 0 if ci == 0 else 1
        out += struct.pack("BB", ci + 1, (t << 4) | t)
    out += bytes([0, 63, 0]) + data + b"\xff\xd9"
    return bytes(out), comps
