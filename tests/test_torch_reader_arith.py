"""The port's JPEG reader on arithmetic-coded input (SOF9, SOF10), against
the JAX package's libjpeg reader and against the Huffman originals: the
twins minted by tools/torch_make_arith.c, truncated and corrupted
streams, hand-edited scan headers and DAC segments.  Every comparison is
bit-exact on coefficients, quantization tables, `progressive`, warning
texts and counts."""

import pathlib

import numpy as np
import pytest

from jpeg2png_tpu.io import read_jpeg as read_jpeg_ref
from jpeg2png_tpu_torch.io import read_jpeg

from conftest import FIXTURES
from test_torch_io import assert_same_image
from test_torch_reader_progressive import _edit, both, scan_of, scans

TWINS = FIXTURES / "torch_arith"
ALL_TWINS = sorted(p.name for p in TWINS.glob("*.jpg"))


def twin_original(name: str) -> pathlib.Path:
    return FIXTURES / (name.split("_arith")[0] + ".jpg")


def segments(raw: bytes, marker: int):
    """(offset, length field) of every marker segment of one type before
    the first scan's data, and after each scan."""
    out = []
    for s in [dict(end=2)] + scans(raw):
        pos = s["end"]
        while raw[pos] == 0xFF and raw[pos + 1] not in (0xD9, 0xDA):
            seg = (raw[pos + 2] << 8) | raw[pos + 3]
            if raw[pos + 1] == marker:
                out.append((pos, seg))
            pos += 2 + seg
    return out


def test_torch_arith_twins_cover_every_geometry():
    """Sequential and progressive twins of each sampling, gray and an odd
    size; restarts; non-default DAC values; the smoke JPEG."""
    stems = {n.split("_arith")[0] for n in ALL_TWINS}
    for stem in stems:
        assert {f"{stem}_arith.jpg", f"{stem}_arith_prog.jpg"} <= set(ALL_TWINS)
    geoms = set()
    for stem in stems:
        img = read_jpeg(twin_original(f"{stem}_arith.jpg"))
        geoms.add("odd" if img.width % 8 or img.height % 8 else
                  tuple((p.h_samp, p.w_samp) for p in img.planes))
    assert {((1, 1), (2, 2), (2, 2)), ((1, 1), (1, 2), (1, 2)),
            ((1, 1),) * 3, ((1, 1), (1, 4), (1, 4)),
            ((1, 1), (2, 1), (2, 1)), ((1, 1),), "odd"} <= geoms, geoms
    for name in ("art440x320_q30_422_arith_rst5.jpg",
                 "art440x320_q30_422_arith_prog_rst5.jpg"):
        raw = (TWINS / name).read_bytes()
        assert raw[segments(raw, 0xDD)[0][0] + 4:][:2] == b"\x00\x05"
    raw = (TWINS / "photo512_q10_420_arith_dac.jpg").read_bytes()
    pos, _ = segments(raw, 0xCC)[0]
    # table 0: L 1, U 3, K 2; table 1: L 2, U 5, K 12
    assert raw[pos + 4:pos + 12] == bytes.fromhex("003110020152110c")
    assert (TWINS / "torch_smoke_art3072x2048_q30_420_arith.jpg").exists()


@pytest.mark.parametrize("name", ALL_TWINS + ["../lineart64_q20_420_arith.jpg"])
def test_torch_arith_twin_equals_its_original(name):
    twin = read_jpeg(TWINS / name)
    orig = read_jpeg(twin_original(pathlib.Path(name).name))
    assert twin.progressive == ("_prog" in name) and not orig.progressive
    assert (twin.height, twin.width) == (orig.height, orig.width)
    assert twin.warnings == () and twin.n_warnings == 0
    for pt, po in zip(twin.planes, orig.planes):
        assert (pt.h_samp, pt.w_samp) == (po.h_samp, po.w_samp)
        np.testing.assert_array_equal(pt.data, po.data)
        np.testing.assert_array_equal(pt.quant, po.quant)


@pytest.mark.parametrize("name", [
    "art440x320_q30_422_arith.jpg", "art440x320_q30_422_arith_prog.jpg",
    "art440x320_q30_422_arith_rst5.jpg",
    "art440x320_q30_422_arith_prog_rst5.jpg",
    "photo512_q10_420_arith_prog_dac.jpg", "art128x96_q35_411_arith.jpg",
    "odd100x52_q25_420_arith_prog.jpg"])
def test_torch_reader_truncated_arith_matches_libjpeg(name):
    """About 250 cuts of each twin, headers included: the same
    coefficients and warnings, or both readers refuse."""
    raw = (TWINS / name).read_bytes()
    decoded = 0
    for cut in range(2, len(raw), max(3, len(raw) // 250)):
        try:
            ref = read_jpeg_ref(raw[:cut], print_warnings=False)
        except ValueError:
            with pytest.raises(ValueError):
                read_jpeg(raw[:cut], print_warnings=False)
            continue
        got = read_jpeg(raw[:cut], print_warnings=False)
        assert got.warnings[0] == "Premature end of JPEG file"
        assert_same_image(got, ref)
        decoded += 1
    assert decoded > 150, decoded


@pytest.mark.parametrize("name,kind,warning", [
    # the byte source past a corrupt stretch: no code is out of range
    ("art440x320_q30_422_arith.jpg", None, "extraneous bytes"),
    # a run past Se in an AC first scan
    ("art440x320_q30_422_arith_prog.jpg", "ac_first", "bad arithmetic"),
    # a refinement scan reads on to its end: no code is out of range
    ("art440x320_q30_422_arith_prog.jpg", "ac_refine", "extraneous bytes"),
    # the restart markers resynchronise the decoder
    ("art440x320_q30_422_arith_rst5.jpg", None, "instead of RST"),
    ("art440x320_q30_422_arith_prog_rst5.jpg", "dc_first", "instead of RST"),
])
@pytest.mark.parametrize("fill", [0x00, 0x55, 0xFE])
def test_torch_reader_corrupt_arith_matches_libjpeg(name, kind, warning,
                                                    fill):
    """32 bytes in the middle of a scan's data overwritten."""
    raw = (TWINS / name).read_bytes()
    s = scan_of(raw, kind) if kind else scans(raw)[0]
    mid = (s["start"] + s["end"]) // 2
    got, ref = both(raw[:mid] + bytes([fill]) * 32 + raw[mid + 32:])
    assert any(warning in w for w in got.warnings), got.warnings
    assert_same_image(got, ref)


@pytest.mark.parametrize("kind,fields", [
    ("dc_first", dict(se=5)),            # a DC scan has Se = 0
    ("dc_first", dict(ss=1, se=5)),      # an AC scan with 3 components
    ("ac_first", dict(ss=10, se=5)),     # Ss > Se
    ("ac_first", dict(se=64)),           # Se past 63
    ("ac_first", dict(al=14)),           # Al > 13
    ("ac_refine", dict(ah=3)),           # Ah != Al + 1
])
def test_torch_reader_invalid_arith_progression_raises(kind, fields):
    raw = (TWINS / "art440x320_q30_422_arith_prog.jpg").read_bytes()
    s = scan_of(raw, kind)
    bad = _edit(raw, s, **fields)
    p = {k: fields.get(k, s[k]) for k in ("ss", "se", "ah", "al")}
    text = ("Invalid progressive parameters Ss={ss} Se={se} Ah={ah} "
            "Al={al}".format(**p))
    with pytest.raises(ValueError, match=text):
        read_jpeg(bad)
    with pytest.raises(ValueError, match=text):
        read_jpeg_ref(bad)


def test_torch_reader_inconsistent_arith_progression_warns_as_libjpeg():
    raw = (TWINS / "art440x320_q30_422_arith_prog.jpg").read_bytes()
    first = scan_of(raw, "ac_first")
    got, ref = both(_edit(raw, first, al=1))
    assert got.warnings[0].startswith("Inconsistent progression sequence")
    assert_same_image(got, ref)


def test_torch_reader_arith_sequential_scan_parameters_warn_as_libjpeg():
    raw = (TWINS / "art440x320_q30_422_arith.jpg").read_bytes()
    got, ref = both(_edit(raw, scans(raw)[0], se=40))
    assert got.warnings == ("Invalid SOS parameters for sequential JPEG",)
    assert_same_image(got, ref)


@pytest.mark.parametrize("name", ["photo512_q10_420_arith.jpg",
                                  "photo512_q10_420_arith_prog.jpg"])
def test_torch_reader_arith_without_dac_uses_the_defaults(name):
    """The twins' DAC segments carry libjpeg's defaults (L 0, U 1, K 5):
    without them the stream reads the same."""
    raw = (TWINS / name).read_bytes()
    dacs = segments(raw, 0xCC)
    assert dacs
    for pos, seg in reversed(dacs):
        raw = raw[:pos] + raw[pos + 2 + seg:]
    got, ref = both(raw)
    assert got.warnings == ()
    assert_same_image(got, ref)
    assert_same_image(got, read_jpeg(TWINS / name))


@pytest.mark.parametrize("name", ["photo512_q10_420_arith_dac.jpg",
                                  "photo512_q10_420_arith_prog_dac.jpg"])
def test_torch_reader_arith_dac_conditions_the_decode(name):
    """The non-default DAC values are what decode the twin: replaced by
    the defaults, the same bytes read to other coefficients (as libjpeg
    reads them)."""
    raw = bytearray((TWINS / name).read_bytes())
    for pos, seg in segments(bytes(raw), 0xCC):
        for i in range(pos + 4, pos + 2 + seg, 2):
            raw[i + 1] = 5 if raw[i] >= 16 else 0x10
    got, ref = both(bytes(raw))
    assert_same_image(got, ref)
    orig = read_jpeg(twin_original(name))
    assert not all(np.array_equal(a.data, b.data)
                   for a, b in zip(got.planes, orig.planes))


@pytest.mark.parametrize("tables", [0x77, 0xC3, 0xFF])
def test_torch_reader_arith_shared_conditioning_tables(tables):
    """SOS selectors name any of the 16 conditioning tables, with or
    without a DAC for it; components that name the same table share its
    statistics bins."""
    raw = bytearray((TWINS / "art440x320_q30_422_arith.jpg").read_bytes())
    s = scans(bytes(raw))[0]
    for c in range(s["ns"]):
        raw[s["sos"] + 6 + 2 * c] = tables
    got, ref = both(bytes(raw))
    assert_same_image(got, ref)


@pytest.mark.parametrize("body,text", [
    (b"\x20\x05", "Bogus DAC index 32"),       # index past the 32 tables
    (b"\x01\x13", "Bogus DAC value 0x13"),     # L 3 > U 1
    (b"\x10\x05\x00", "Bogus marker length"),  # an odd length
])
def test_torch_reader_bad_dac_raises(body, text):
    raw = (TWINS / "photo512_q10_420_arith.jpg").read_bytes()
    pos, seg = segments(raw, 0xCC)[0]
    dac = b"\xff\xcc" + (len(body) + 2).to_bytes(2, "big") + body
    bad = raw[:pos] + dac + raw[pos + 2 + seg:]
    with pytest.raises(ValueError, match=text):
        read_jpeg(bad)
    with pytest.raises(ValueError):
        read_jpeg_ref(bad)


@pytest.mark.parametrize("marker", [0xE0, 0xED, 0xFE])
def test_torch_reader_short_appn_and_com_lengths_read_as_libjpeg(marker):
    """An APPn or COM segment whose length field is below 2 skips nothing
    (libjpeg's skip_variable): the stream still reads."""
    raw = (TWINS / "gray64_q30_arith.jpg").read_bytes()
    for length in (b"\x00\x00", b"\x00\x01"):
        bad = raw[:2] + bytes([0xFF, marker]) + length + raw[2:]
        got, ref = both(bad)
        assert_same_image(got, ref)
