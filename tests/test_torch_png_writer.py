"""The port's PNG writer (jpeg2png_tpu_torch/io/png_writer.py on
csrc/png_filter.c) against the JAX package's native libpng encoder
(jpeg2png_tpu/native/pngio.c): the same bytes for 8- and 16-bit RGB and
gray, the C filter equal to its numpy version, and the pixels read back by
tests/pngdec.py, Pillow and chip_smoke.py's reader."""

import io
import pathlib
import struct
import sys
import zlib

import numpy as np
import pytest

pytest.importorskip("torch")

from jpeg2png_tpu.io import png_writer as jax_png  # noqa: E402
from jpeg2png_tpu_torch.io import encode_png  # noqa: E402
from jpeg2png_tpu_torch.io import png_writer  # noqa: E402

from pngdec import decode_png  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = sorted((REPO / "tests" / "fixtures" / "golden").glob("*.png"))

SHAPES = [(1, 1), (1, 7), (7, 1), (3, 5), (8, 8), (61, 97), (200, 1000)]


def _pixels(shape, bits, content, seed=0):
    """Random, or smooth (sines and a ramp per channel), samples."""
    dtype = np.uint8 if bits == 8 else np.uint16
    top = (1 << bits) - 1
    if content == "random":
        rng = np.random.default_rng(seed)
        return rng.integers(0, top + 1, shape).astype(dtype)
    y, x = np.meshgrid(np.arange(shape[0]), np.arange(shape[1]),
                       indexing="ij")
    v = (np.sin(y / 7.0) * np.cos(x / 5.0) + 1) * top / 2
    if len(shape) == 3:
        v = np.stack([v, v * 0.5 + x % 3, top - v], axis=-1)
    return np.clip(v, 0, top).astype(dtype)


def _rows(pix, bits):
    raw = pix.astype("u1" if bits == 8 else ">u2")
    bpp = (pix.shape[2] if pix.ndim == 3 else 1) * bits // 8
    return np.ascontiguousarray(raw).reshape(pix.shape[0], -1).view("u1"), bpp


def _chunks(data):
    pos, out = 8, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        out.append((data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]))
        pos += 12 + n
    return out


def _filter0_png(pix, bits):
    """The port's writer before libpng's filters (filter type 0 on every
    row, zlib.compress level 6), for the size comparison."""
    rows, _ = _rows(pix, bits)
    h, w = pix.shape[:2]
    filtered = np.zeros((h, rows.shape[1] + 1), np.uint8)
    filtered[:, 1:] = rows
    ihdr = struct.pack(">IIBBBBB", w, h, bits, 2 if pix.ndim == 3 else 0,
                       0, 0, 0)
    return (png_writer._SIG + png_writer._chunk(b"IHDR", ihdr)
            + png_writer._chunk(b"IDAT", zlib.compress(filtered, 6))
            + png_writer._chunk(b"IEND", b""))


def test_torch_png_reference_is_libpng():
    """The comparisons below are against libpng, not the JAX package's
    zlib fallback."""
    assert jax_png._pngio is not None


@pytest.mark.parametrize("content", ["random", "smooth"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("channels", [3, 1], ids=["rgb", "gray"])
@pytest.mark.parametrize("bits", [8, 16])
def test_torch_png_equals_libpng(bits, channels, shape, content):
    assert jax_png._pngio is not None
    pix = _pixels(shape + ((3,) if channels == 3 else ()), bits, content)
    assert encode_png(pix, bits) == jax_png.encode_png(pix, bits)


# (shape, bits, what the case sits on); random gray at seed 7 where the
# zlib stream's length is named
BOUNDARIES = [
    ((128, 127), 8, "filtered data 16,384 bytes: the header rewritten"),
    ((129, 127), 8, "filtered data 16,512 bytes: no rewrite"),
    ((1024, 5, 3), 8, "RGB, filtered data 16,384 bytes"),
    ((1025, 5, 3), 8, "RGB, filtered data 16,400 bytes"),
    ((64, 127), 16, "gray16, filtered data 16,320 bytes"),
    ((130, 60), 8, "filtered data 7,930 bytes: 13-bit window"),
    ((131, 60), 8, "filtered data 7,991 bytes: 14-bit window"),
    ((1, 8180), 8, "stream 8,192 bytes: one full IDAT"),
    ((3, 2726), 8, "stream 8,192 bytes, three rows"),
    ((1, 8100), 8, "stream under 8,192 bytes"),
    ((1, 8300), 8, "stream over 8,192 bytes: two IDATs"),
    ((1, 16372), 8, "stream 16,384 bytes: two full IDATs"),
]
STREAM_BYTES = {(1, 8180): 8192, (3, 2726): 8192, (1, 16372): 16384}


@pytest.mark.parametrize("shape,bits,what", BOUNDARIES,
                         ids=[b[2] for b in BOUNDARIES])
def test_torch_png_equals_libpng_at_boundaries(shape, bits, what):
    assert jax_png._pngio is not None
    for content, seed in (("random", 7), ("smooth", 0)):
        pix = _pixels(shape, bits, content, seed)
        got = encode_png(pix, bits)
        assert got == jax_png.encode_png(pix, bits), content
        idat = [p for tag, p in _chunks(got) if tag == b"IDAT"]
        assert all(len(p) == png_writer.IDAT_BYTES for p in idat[:-1])
        assert 0 < len(idat[-1]) <= png_writer.IDAT_BYTES
        if content == "random" and shape in STREAM_BYTES:
            assert sum(map(len, idat)) == STREAM_BYTES[shape]


@pytest.mark.parametrize("path", GOLDEN, ids=[p.stem for p in GOLDEN])
def test_torch_png_golden_pixels_equal_libpng(path):
    """Every golden's pixels encode to libpng's bytes, in a smaller file
    than the filter-0 writer's, and read back."""
    assert jax_png._pngio is not None
    pix = decode_png(path.read_bytes())
    bits = 16 if pix.dtype == np.uint16 else 8
    got = encode_png(pix, bits)
    assert got == jax_png.encode_png(pix, bits)
    assert len(got) < len(_filter0_png(pix, bits))


@pytest.mark.parametrize("content", ["random", "smooth"])
@pytest.mark.parametrize("shape", SHAPES + [(2, 3), (33, 20)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("bpp", [1, 2, 3, 6])
def test_torch_png_filter_equals_plain(bpp, shape, content):
    h, w = shape
    pix = _pixels((h, w * bpp), 8, content, seed=bpp)
    got = png_writer.filter_rows(pix, bpp)
    ref = png_writer.filter_rows_plain(pix, bpp)
    np.testing.assert_array_equal(got, ref)


def _predict(f, left, up, upleft):
    p = left + up - upleft
    pa, pb, pc = abs(p - left), abs(p - up), abs(p - upleft)
    paeth = left if pa <= pb and pa <= pc else up if pb <= pc else upleft
    return [0, left, up, (left + up) // 2, paeth][f]


def test_torch_png_filter_picks_each_of_five():
    """Rows that filter f's predictor makes, plus noise of 0 or 1, after a
    random row: f is picked for each (None for a row of zeros, where Sub
    ties and the first filter wins).  Paeth's own: random columns to the
    left, as in the row above, and a flat run to the right, unlike the row
    above: Paeth predicts both halves, Sub only the right, Up only the
    left.  And the narrowed sets of a one-row, a one-pixel-wide and a
    one-pixel image."""
    rng = np.random.default_rng(3)
    rows, want = [], {}
    for f in (1, 2, 3, 0):
        rows.append(rng.integers(0, 256, 64))
        prev, row = rows[-1], []
        for i in range(64):
            left = row[i - 1] if i else 0
            upleft = prev[i - 1] if i else 0
            noise = 0 if f == 0 else int(rng.integers(0, 2))
            row.append((_predict(f, left, prev[i], upleft) + noise) % 256)
        want[len(rows)] = f
        rows.append(np.asarray(row))
    columns = rng.integers(0, 256, 32)
    rows.append(np.concatenate([columns, np.full(32, 10)]))
    want[len(rows)] = 4
    rows.append(np.concatenate([columns, np.full(32, 200)]))
    pix = np.asarray(rows, np.uint8)
    for filt in (png_writer.filter_rows, png_writer.filter_rows_plain):
        picked = filt(pix, 1)[:, 0]
        assert {i: int(picked[i]) for i in want} == want
    one_row = png_writer.filter_rows(_pixels((1, 40), 8, "smooth"), 1)
    assert one_row[0, 0] in (0, 1)
    one_col = png_writer.filter_rows(_pixels((40, 1), 8, "smooth"), 1)
    assert set(one_col[:, 0].tolist()) <= {0, 2}
    one_px = png_writer.filter_rows(np.full((1, 3), 200, np.uint8), 3)
    assert one_px[0, 0] == 0


def test_torch_png_filter_rejects_partial_pixels():
    with pytest.raises(ValueError, match="bad geometry"):
        png_writer.filter_rows(np.zeros((2, 7), np.uint8), 3)


@pytest.mark.parametrize("shape,bits", [
    ((21, 33, 3), 8), ((9, 5, 3), 16), ((7, 11), 8), ((6, 4), 16),
    ((61, 97, 3), 8), ((40, 30), 16), ((1, 1, 3), 8), ((1, 9), 8),
    ((9, 1, 3), 16),
])
def test_torch_png_reads_back(shape, bits, tmp_path):
    """tests/pngdec.py, Pillow (where it keeps the samples: not 16-bit
    RGB) and chip_smoke.py's reader (which tools/torch_serving_cards.py
    uses too) give the pixels back."""
    from PIL import Image

    sys.path.insert(0, str(REPO))
    import chip_smoke

    for content in ("random", "smooth"):
        pix = _pixels(shape, bits, content)
        data = encode_png(pix, bits)
        back = decode_png(data)
        assert back.dtype == pix.dtype
        np.testing.assert_array_equal(back, pix)
        np.testing.assert_array_equal(chip_smoke.unfilter_png(data), pix)
        if not (bits == 16 and len(shape) == 3):
            np.testing.assert_array_equal(
                np.asarray(Image.open(io.BytesIO(data))), pix)
    path = tmp_path / "out.png"
    path.write_bytes(data)
    np.testing.assert_array_equal(chip_smoke.read_own_png(path), pix)


def test_torch_png_reader_refuses_unknown_filter():
    sys.path.insert(0, str(REPO))
    import chip_smoke

    pix = _pixels((4, 5), 8, "smooth")
    rows, _ = _rows(pix, 8)
    filtered = np.concatenate([np.full((4, 1), 5, np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", 5, 4, 8, 0, 0, 0, 0)
    data = (png_writer._SIG + png_writer._chunk(b"IHDR", ihdr)
            + png_writer._chunk(b"IDAT", zlib.compress(filtered))
            + png_writer._chunk(b"IEND", b""))
    with pytest.raises(chip_smoke.SmokeFailure, match="filter type 5"):
        chip_smoke.unfilter_png(data)


def test_torch_png_writer_without_compiler_raises(tmp_path, monkeypatch):
    """No filter-0 writer is left to fall back to: a failed build of the
    filter raises with the compiler's complaint."""
    from jpeg2png_tpu_torch.kernels import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "fresh")
    monkeypatch.setattr(_build, "_handles", {})
    monkeypatch.setenv("CC", str(tmp_path / "no-such-cc"))
    with pytest.raises(RuntimeError, match="no-such-cc"):
        encode_png(_pixels((8, 8, 3), 8, "smooth"))
    assert not list((tmp_path / "fresh").glob("*.so"))
