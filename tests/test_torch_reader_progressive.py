"""The port's JPEG reader on progressive (SOF2) input, against the JAX
package's libjpeg reader: streams minted here by Pillow, truncated
streams, hand-edited scan headers, and byte-mutation fuzz runs of the
sequential fixtures and the progressive twins, and of the arithmetic
twins.  Every comparison is bit-exact on coefficients, quantization
tables, `progressive`, warning texts and counts."""

import io
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from jpeg2png_tpu.io import read_jpeg as read_jpeg_ref
from jpeg2png_tpu_torch.io import read_jpeg

from conftest import FIXTURES
from test_torch_io import assert_same_image

REPO = pathlib.Path(__file__).resolve().parents[1]
TWINS = FIXTURES / "torch_progressive"
ARITH_TWINS = FIXTURES / "torch_arith"


def both(raw):
    return (read_jpeg(raw, print_warnings=False),
            read_jpeg_ref(raw, print_warnings=False))


def scans(raw: bytes):
    """Each scan of a well-formed stream: offsets of its SOS marker, of
    its Ss byte and of its entropy-coded data's start and end (the next
    marker), and (ns, Ss, Se, Ah, Al)."""
    out, pos = [], 2
    while pos < len(raw):
        assert raw[pos] == 0xFF
        m = raw[pos + 1]
        if m == 0xD9:
            break
        seg = (raw[pos + 2] << 8) | raw[pos + 3]
        end = pos + 2 + seg
        if m != 0xDA:
            pos = end
            continue
        ns = raw[pos + 4]
        par = pos + 5 + 2 * ns
        data_end = end
        while not (raw[data_end] == 0xFF and raw[data_end + 1] not in
                   (0x00, *range(0xD0, 0xD8))):
            data_end += 1
        out.append(dict(sos=pos, par=par, start=end, end=data_end, ns=ns,
                        ss=raw[par], se=raw[par + 1], ah=raw[par + 2] >> 4,
                        al=raw[par + 2] & 15))
        pos = data_end
    return out


def scan_of(raw, kind):
    """The first scan of a kind: DC first/refine, AC first/refine."""
    for s in scans(raw):
        if kind == ("dc" if s["ss"] == 0 else "ac") + (
                "_refine" if s["ah"] else "_first"):
            return s
    raise LookupError(kind)


def test_torch_scans_helper_sees_the_standard_script():
    # jpeg_simple_progression for YCbCr: 10 scans, 5 of them refinements
    # (luma AC twice, DC once, each chroma AC once)
    raw = (TWINS / "art440x320_q30_422_prog.jpg").read_bytes()
    got = [(s["ns"], s["ss"], s["se"], s["ah"], s["al"]) for s in scans(raw)]
    assert got[0] == (3, 0, 0, 0, 1) and len(got) == 10
    assert sum(1 for g in got if g[3]) == 5


def _image(rng, h, w, mode):
    """Smooth gradients, hard-edged blocks and noise: every kind of
    coefficient band has work."""
    y, x = np.mgrid[0:h, 0:w]
    base = 128 + 60 * np.sin(x / 9.0) * np.cos(y / 13.0)
    img = np.stack([base, base[::-1], base[:, ::-1]], -1)
    for _ in range(6):
        y0, x0 = rng.integers(0, h), rng.integers(0, w)
        img[y0:y0 + h // 4, x0:x0 + w // 5] = rng.integers(0, 256, 3)
    img = np.clip(img + rng.normal(0, 12, img.shape), 0, 255).astype(np.uint8)
    from PIL import Image

    pic = Image.fromarray(img)
    return pic.convert("L") if mode == "L" else pic


@pytest.mark.parametrize("mode,h,w,subsampling,restart", [
    ("RGB", 88, 120, 2, 0),       # 4:2:0
    ("RGB", 88, 120, 1, 0),       # 4:2:2
    ("RGB", 88, 120, 0, 0),       # 4:4:4
    ("L", 48, 64, 0, 0),          # grayscale
    ("RGB", 53, 101, 2, 0),       # odd sizes: padded MCUs in the DC scans
    ("L", 45, 77, 0, 3),          # grayscale, odd, restart every 3 blocks
    ("RGB", 53, 101, 2, 1),       # restart every MCU
    ("RGB", 88, 120, 1, 3),       # 4:2:2, restart every 3 MCUs
])
def test_torch_reader_pil_progressive_matches_libjpeg(mode, h, w, subsampling,
                                                      restart):
    pytest.importorskip("PIL.Image")
    pic = _image(np.random.default_rng(h * w + restart), h, w, mode)
    kw = dict(quality=40, subsampling=subsampling)
    if restart:
        kw["restart_marker_blocks"] = restart
    prog, seq = io.BytesIO(), io.BytesIO()
    pic.save(prog, "JPEG", progressive=True, **kw)
    pic.save(seq, "JPEG", **kw)
    raw = prog.getvalue()
    assert b"\xff\xc2" in raw and (b"\xff\xdd" in raw) == bool(restart)
    got, ref = both(raw)
    assert got.progressive and got.warnings == ()
    assert_same_image(got, ref)
    # the same pixels coded sequentially quantize to the same coefficients
    plain = read_jpeg(seq.getvalue())
    for pa, pb in zip(got.planes, plain.planes):
        np.testing.assert_array_equal(pa.data, pb.data)


@pytest.mark.parametrize("name", ["art440x320_q30_422_prog.jpg",
                                  "art440x320_q30_422_prog_rst5.jpg",
                                  "odd100x52_q25_420_prog.jpg"])
@pytest.mark.parametrize("where", ["dc_first", "ac_first", "ac_refine",
                                   "scan_boundary", "eoi_missing"])
def test_torch_reader_truncated_progressive_matches_libjpeg(name, where):
    raw = (TWINS / name).read_bytes()
    if where == "eoi_missing":
        cut = len(raw) - 2
    elif where == "scan_boundary":
        cut = scans(raw)[3]["end"]
    else:
        s = scan_of(raw, where)
        cut = (s["start"] + s["end"]) // 2
    got, ref = both(raw[:cut])
    assert got.warnings and got.warnings[0] == "Premature end of JPEG file"
    assert_same_image(got, ref)


def test_torch_reader_truncated_everywhere_matches_libjpeg():
    """Every 7th cut of a small 4:1:1 twin, headers included: the same
    coefficients and warnings, or both readers refuse."""
    raw = (TWINS / "art128x96_q35_411_prog.jpg").read_bytes()
    for cut in range(2, len(raw), 7):
        try:
            ref = read_jpeg_ref(raw[:cut], print_warnings=False)
        except ValueError:
            with pytest.raises(ValueError):
                read_jpeg(raw[:cut], print_warnings=False)
            continue
        assert_same_image(read_jpeg(raw[:cut], print_warnings=False), ref)


def _edit(raw, scan, **fields):
    """`raw` with one scan's Ss, Se, Ah or Al replaced."""
    out = bytearray(raw)
    p = scan["par"]
    ss, se = fields.get("ss", scan["ss"]), fields.get("se", scan["se"])
    ah, al = fields.get("ah", scan["ah"]), fields.get("al", scan["al"])
    out[p], out[p + 1], out[p + 2] = ss, se, (ah << 4) | al
    return bytes(out)


@pytest.mark.parametrize("kind,fields", [
    ("dc_first", dict(se=5)),            # a DC scan has Se = 0
    ("dc_first", dict(ss=1, se=5)),      # an AC scan with 3 components
    ("ac_first", dict(ss=10, se=5)),     # Ss > Se
    ("ac_first", dict(se=64)),           # Se past 63
    ("ac_first", dict(al=14)),           # Al > 13
    ("ac_refine", dict(ah=3)),           # Ah != Al + 1
])
def test_torch_reader_invalid_progressive_parameters_raise(kind, fields):
    raw = (TWINS / "art440x320_q30_422_prog.jpg").read_bytes()
    s = scan_of(raw, kind)
    bad = _edit(raw, s, **fields)
    p = {k: fields.get(k, s[k]) for k in ("ss", "se", "ah", "al")}
    text = ("Invalid progressive parameters Ss={ss} Se={se} Ah={ah} "
            "Al={al}".format(**p))
    with pytest.raises(ValueError, match=text):
        read_jpeg(bad)
    with pytest.raises(ValueError, match=text):
        read_jpeg_ref(bad)


def test_torch_reader_inconsistent_progression_warns_as_libjpeg():
    raw = (TWINS / "art440x320_q30_422_prog.jpg").read_bytes()
    # luma's first AC scan (1-5, Al=2) sent as Al=1: the refinement that
    # expects Ah=2 there then finds each coefficient at 1
    first = scan_of(raw, "ac_first")
    assert (first["ss"], first["se"], first["al"]) == (1, 5, 2)
    got, ref = both(_edit(raw, first, al=1))
    assert got.warnings[0] == ("Inconsistent progression sequence for "
                               "component 0 coefficient 1")
    assert_same_image(got, ref)
    # no DC scan at all: every AC scan warns for coefficient 0
    dc = scans(raw)[0]
    got, ref = both(raw[:dc["sos"]] + raw[dc["end"]:])
    assert got.n_warnings > 3
    assert_same_image(got, ref)


def fuzz(n: int, seed: int, coding: str = "huffman") -> dict:
    """Seeded byte mutations and truncations (tools/fuzz_reader.py's
    mutate) of the small Huffman fixtures (the sequential ones and the
    progressive twins) or of the small arithmetic ones (the twins and
    lineart64's): each mutant decodes to planes of libjpeg's shapes
    (libjpeg must decode it too), or raises ValueError.  Returns the
    tally, with the mutants whose decode equals libjpeg's in every
    respect and those that warned of a bad arithmetic code."""
    sys.path.insert(0, str(REPO / "tools"))
    from fuzz_reader import mutate

    if coding == "huffman":
        corpus = [p for p in sorted(FIXTURES.glob("*.jpg"))
                  if "arith" not in p.name and "smoke" not in p.name]
        twins = TWINS
    else:
        corpus = sorted(FIXTURES.glob("*_arith.jpg"))
        twins = ARITH_TWINS
    corpus += [p for p in sorted(twins.glob("*.jpg"))
               if p.stat().st_size < 100_000]
    datas = [p.read_bytes() for p in corpus]
    rng = np.random.default_rng(seed)
    tally = {"decoded": 0, "refused": 0, "equal to libjpeg": 0,
             "bad arithmetic code": 0}
    for _ in range(n):
        mut = mutate(datas[int(rng.integers(0, len(datas)))], rng)
        try:
            img = read_jpeg(mut, print_warnings=False)
        except ValueError:
            tally["refused"] += 1
            continue
        ref = read_jpeg_ref(mut, print_warnings=False)
        assert ([p.data.shape for p in img.planes]
                == [p.data.shape for p in ref.planes])
        tally["decoded"] += 1
        tally["bad arithmetic code"] += any(
            "arithmetic" in w for w in img.warnings)
        try:
            assert_same_image(img, ref)
            tally["equal to libjpeg"] += 1
        except AssertionError:
            pass
    return tally


def _fuzz_in_child(n: int, seed: int, coding: str) -> dict:
    """fuzz() in a child process with its own time limit, so that a crash
    in the C decoder fails the test instead of its worker."""
    code = ("import sys; sys.path[:0] = [%r, %r]; "
            "from test_torch_reader_progressive import fuzz; "
            "import json; print(json.dumps(fuzz(%d, %d, %r)))"
            % (str(REPO / "tests"), str(REPO), n, seed, coding))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    tally = json.loads(out.stdout.strip().splitlines()[-1])
    assert tally["decoded"] + tally["refused"] == n
    return tally


def test_torch_reader_fuzz_smoke():
    """400 mutants of the Huffman corpus: the port decodes as libjpeg."""
    tally = _fuzz_in_child(400, 1234, "huffman")
    assert tally["decoded"] > 100, tally
    assert tally["equal to libjpeg"] == tally["decoded"], tally
    assert tally["bad arithmetic code"] == 0, tally


def test_torch_reader_arith_fuzz():
    """600 mutants of the arithmetic corpus: every one that decodes
    equals libjpeg's decode.  Floors: more than half decode (about two
    thirds did when this test was written) and at least 10 run into a
    bad arithmetic code, so the decoder's error path is exercised."""
    tally = _fuzz_in_child(600, 4321, "arith")
    assert tally["decoded"] > 300, tally
    assert tally["bad arithmetic code"] >= 10, tally
    assert tally["equal to libjpeg"] == tally["decoded"], tally
