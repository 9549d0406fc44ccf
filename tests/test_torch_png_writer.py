"""The port's PNG writer (jpeg2png_tpu_torch/io/png_writer.py on
csrc/png_filter.c) against the JAX package's native libpng encoder
(jpeg2png_tpu/native/pngio.c): the same bytes for 8- and 16-bit RGB and
gray up to STRIP_BYTES of filtered rows, and above that, where the writer
filters and deflates row strips in parallel, the pixels back in at most
1.005x libpng's bytes, the same bytes for any pool size; the C filter
equal to its numpy version over any split of the rows, and the pixels read
back by tests/pngdec.py, Pillow and chip_smoke.py's reader."""

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


def _multi_strip(pix, bits):
    """Whether the writer cuts `pix` into strips."""
    rows, _ = _rows(pix, bits)
    return rows.shape[0] * (rows.shape[1] + 1) > png_writer.STRIP_BYTES


def _strip_png_ok(got, libpng, pix):
    """A strip-written PNG: the pixels back, at most 1.005x libpng's
    bytes."""
    back = decode_png(got)
    assert back.dtype == pix.dtype
    np.testing.assert_array_equal(back, pix)
    assert len(got) <= 1.005 * len(libpng)


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
    got, libpng = encode_png(pix, bits), jax_png.encode_png(pix, bits)
    # every (200, 1000) case is over STRIP_BYTES, every other one under
    assert _multi_strip(pix, bits) == (shape == (200, 1000))
    if _multi_strip(pix, bits):
        _strip_png_ok(got, libpng, pix)
    else:
        assert got == libpng


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
    """Every golden's pixels encode to libpng's bytes (in strips above
    STRIP_BYTES: the pixels back in at most 1.005x its bytes), in a
    smaller file than the filter-0 writer's."""
    assert jax_png._pngio is not None
    pix = decode_png(path.read_bytes())
    bits = 16 if pix.dtype == np.uint16 else 8
    got, libpng = encode_png(pix, bits), jax_png.encode_png(pix, bits)
    if _multi_strip(pix, bits):
        _strip_png_ok(got, libpng, pix)
    else:
        assert got == libpng
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


# ------------------------------------------------------------------ strips

def _split_filter(rows, bpp, cuts):
    """filter_strip over the strips [cuts[i], cuts[i + 1])."""
    h, row_bytes = rows.shape
    out = np.empty((h, row_bytes + 1), np.uint8)
    for y0, y1 in zip(cuts[:-1], cuts[1:]):
        png_writer.filter_strip(rows, bpp, y0, y1, out[y0:y1])
    return out


@pytest.mark.parametrize("shape,bpp", [
    ((1, 40), 1), ((1, 18), 6), ((40, 1), 1), ((57, 3), 3), ((33, 20), 2),
    ((61, 97), 3), ((200, 60), 6), ((25, 8), 1)],
    ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_torch_png_filter_rows_any_split_equals_whole(shape, bpp):
    """j2p_png_filter_rows over any split of the rows gives the whole
    image's filter (the row above from the image, the filters tried from
    its whole h and width): one-row and one-pixel-wide images too, and a
    strip a row."""
    h, w = shape
    rng = np.random.default_rng(h * 1000 + w)
    for content in ("random", "smooth"):
        rows = np.ascontiguousarray(_pixels((h, w * bpp), 8, content, bpp))
        whole = png_writer.filter_rows(rows, bpp)
        np.testing.assert_array_equal(whole,
                                      png_writer.filter_rows_plain(rows, bpp))
        splits = [[0, h], list(range(h + 1))]
        for _ in range(4):
            inner = sorted(rng.choice(np.arange(1, h), min(h - 1, 5),
                                      replace=False).tolist()) if h > 1 else []
            splits.append([0] + inner + [h])
        for cuts in splits:
            np.testing.assert_array_equal(_split_filter(rows, bpp, cuts),
                                          whole, err_msg=str(cuts))


def test_torch_png_filter_rows_refuses_rows_outside():
    """Rows outside [0, h), an empty or reversed range, and an output of
    the wrong size are refused before the C filter writes anything."""
    rows = np.zeros((4, 6), np.uint8)
    for y0, y1, out_rows in ((0, 5, 5), (-1, 2, 3), (2, 2, 0), (3, 1, 0),
                             (0, 2, 3)):
        out = np.empty((out_rows, 7), np.uint8)
        with pytest.raises(ValueError, match="bad geometry"):
            png_writer.filter_strip(rows, 3, y0, y1, out)
    with pytest.raises(ValueError, match="C-contiguous uint8"):
        png_writer.filter_strip(rows, 3, 0, 2, np.empty((7, 2), np.uint8).T)


def _edge_cases():
    """(shape, bits, what): images at the strip edges, 8- and 16-bit RGB
    and gray.  8-bit rows of 128 or 256 filtered bytes make STRIP_BYTES
    exactly; 16-bit rows have an odd filtered length, so their edge is the
    largest h at or under STRIP_BYTES."""
    out = []
    for shape_w, bits, ch in ((127, 8, 1), (85, 8, 3), (150, 16, 1),
                              (70, 16, 3)):
        row = shape_w * ch * bits // 8 + 1
        n = png_writer.strip_rows(1, row - 1)
        at = png_writer.STRIP_BYTES // row
        tail = (shape_w, 3) if ch == 3 else (shape_w,)
        name = f"{'rgb' if ch == 3 else 'gray'}{bits}"
        out += [((at,) + tail, bits, f"{name} at STRIP_BYTES"),
                ((at + 1,) + tail, bits, f"{name} one row over"),
                ((3 * n + 1,) + tail, bits, f"{name} last strip one row")]
    return out


EDGES = _edge_cases()


@pytest.mark.parametrize("shape,bits,what", EDGES,
                         ids=[e[2] for e in EDGES])
def test_torch_png_strip_edges_read_back(shape, bits, what):
    """At STRIP_BYTES the writer is libpng's one stream; a row over, the
    strip path begins; the last strip may hold one row.  tests/pngdec.py,
    Pillow (not 16-bit RGB) and chip_smoke.py's reader give the pixels
    back."""
    from PIL import Image

    sys.path.insert(0, str(REPO))
    import chip_smoke

    h = shape[0]
    for content in ("random", "smooth"):
        pix = _pixels(shape, bits, content)
        data, strips = png_writer._encode(pix, bits)
        rows, _ = _rows(pix, bits)
        size = h * (rows.shape[1] + 1)
        n = png_writer.strip_rows(h, rows.shape[1])
        # one strip, on either path, is libpng's one stream
        assert strips == (1 if size <= png_writer.STRIP_BYTES
                          else -(-h // n))
        assert (data == jax_png.encode_png(pix, bits)) == (strips == 1)
        if what.endswith("at STRIP_BYTES") and bits == 8:
            assert size == png_writer.STRIP_BYTES
        if what.endswith("one row over"):
            # 8 bits: a strip of STRIP_BYTES and one of a row; 16 bits:
            # the one strip of ceil(STRIP_BYTES / row) rows
            assert strips == (2 if bits == 8 else 1)
        if what.endswith("last strip one row"):
            assert h % n == 1 and strips == 4
        np.testing.assert_array_equal(decode_png(data), pix)
        np.testing.assert_array_equal(chip_smoke.unfilter_png(data), pix)
        if not (bits == 16 and len(shape) == 3):
            np.testing.assert_array_equal(
                np.asarray(Image.open(io.BytesIO(data))), pix)


@pytest.mark.parametrize("bits", [8, 16])
def test_torch_png_strip_stream_is_the_filtered_rows(bits):
    """The joined IDATs inflate to the filtered rows, with zlib's header
    and the Adler-32 of all of them; each strip's piece ends on a byte."""
    pix = _pixels((500, 200, 3), bits, "smooth")
    rows, bpp = _rows(pix, bits)
    data, strips = png_writer._encode(pix, bits)
    assert strips > 2
    stream = b"".join(p for tag, p in _chunks(data) if tag == b"IDAT")
    filtered = png_writer.filter_rows(rows, bpp)
    assert zlib.decompress(stream) == filtered.tobytes()
    assert stream[:2] == png_writer.ZLIB_HEADER
    assert struct.unpack(">I", stream[-4:])[0] == zlib.adler32(filtered)
    # the header is the one libpng's settings write for a 32 KiB window
    comp = zlib.compressobj(6, zlib.DEFLATED, 15, 8, zlib.Z_FILTERED)
    assert (comp.compress(b"x") + comp.flush())[:2] == png_writer.ZLIB_HEADER


def test_torch_png_adler32_combine():
    rng = np.random.default_rng(5)
    for n1, n2 in ((0, 0), (0, 7), (9, 0), (1, 65521), (70000, 131073),
                   (65520, 65522)):
        a = rng.integers(0, 256, n1, dtype=np.uint8).tobytes()
        b = rng.integers(0, 256, n2, dtype=np.uint8).tobytes()
        assert png_writer.adler32_combine(
            zlib.adler32(a), zlib.adler32(b), n2) == zlib.adler32(a + b)
    b = b"\xff" * 200000
    assert png_writer.adler32_combine(zlib.adler32(b), zlib.adler32(b),
                                      len(b)) == zlib.adler32(b + b)


@pytest.mark.parametrize("workers", [1, 3])
def test_torch_png_strips_same_bytes_on_any_pool(workers, monkeypatch):
    """The strips follow the image's shape alone: a pool of 1 or 3
    workers writes the bytes of the process-wide pool."""
    import concurrent.futures

    cases = [(_pixels((400, 300, 3), 8, "random"), 8),
             (_pixels((1100, 129), 16, "smooth"), 16),
             (_pixels((140000, 1), 8, "random"), 8),
             (_pixels((40000, 1, 3), 16, "smooth"), 16)]
    want = [encode_png(p, b) for p, b in cases]
    # every case in strips, the one-pixel-wide ones too
    assert all(png_writer._encode(p, b)[1] >= 3 for p, b in cases)
    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        monkeypatch.setattr(png_writer, "_strip_pool", lambda: pool)
        got = [encode_png(p, b) for p, b in cases]
    assert got == want


def test_torch_png_strips_from_many_threads_at_once():
    """More callers than cores encode on the one shared pool at once (as
    the runner's PNG threads do), the interpreter switching threads often:
    every file is its serial bytes, and every caller finishes."""
    import concurrent.futures
    import os

    cases = [(_pixels((300 + 7 * i, 150 + i, 3), 8, "random", i), 8)
             for i in range(4)]
    want = [encode_png(p, b) for p, b in cases]
    callers = 2 * len(os.sched_getaffinity(0)) + 1
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with concurrent.futures.ThreadPoolExecutor(callers) as pool:
            jobs = [pool.submit(encode_png, *cases[k % len(cases)])
                    for k in range(3 * callers)]
            done, pending = concurrent.futures.wait(jobs, timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not pending
    for k, job in enumerate(jobs):
        assert job.result() == want[k % len(cases)]


@pytest.mark.parametrize("size", [(1536, 1024), (3264, 2448)],
                         ids=["1536x1024", "3264x2448"])
def test_torch_png_strips_cost_at_most_half_a_percent(size):
    """Photo-class content (utils/corpus.synth_image) in strips: at most
    1.005x the bytes of libpng's one stream on the same filtered rows."""
    from jpeg2png_tpu_torch.utils.corpus import synth_image

    w, h = size
    pix = synth_image(w, h, 7)
    rows, bpp = _rows(pix, 8)
    single = png_writer.deflate_rows(png_writer.filter_rows(rows, bpp), bpp)
    stream, strips = png_writer.strip_stream(rows, bpp)
    assert strips == -(-h // png_writer.strip_rows(h, rows.shape[1]))
    assert zlib.decompress(stream) == zlib.decompress(single)
    assert len(single) < len(stream) <= 1.005 * len(single)


def test_torch_png_span_counts_strips_and_bytes(tmp_path):
    """write_png's "png" span counts its stream's strips (1 on libpng's one
    stream) and the file's bytes."""
    from jpeg2png_tpu_torch.utils import profiling

    for shape, strips in (((40, 30, 3), 1), ((300, 200, 3), None)):
        pix = _pixels(shape, 8, "smooth")
        path = tmp_path / "out.png"
        with profiling.recording() as spans:
            png_writer.write_png(path, pix)
        (sp,) = spans
        want = png_writer._encode(pix, 8)[1]
        assert want == (strips or want) and (strips or want > 1)
        assert sp.name == "png"
        assert sp.attrs == {"strips": want, "bytes": path.stat().st_size}
