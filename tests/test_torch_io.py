"""PyTorch port IO: the JPEG reader (Python markers, the C entropy
decoder in csrc/jpeg_entropy.c) against the JAX package's libjpeg reader,
the zlib PNG writer, and CLI parsing."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jpeg2png_tpu.io import read_jpeg as read_jpeg_ref  # noqa: E402
from jpeg2png_tpu_torch.cli import (  # noqa: E402
    build_parser, config_from_args, derive_output_name)
from jpeg2png_tpu_torch.io import (  # noqa: E402
    encode_png, read_jpeg, require_supported)

from conftest import FIXTURES  # noqa: E402

torch.set_num_threads(2)

# every fixture: Huffman and arithmetic coding, sequential and progressive
ALL_JPEGS = sorted(p.relative_to(FIXTURES).as_posix()
                   for p in FIXTURES.rglob("*.jpg"))
# progressive twins (tools/torch_make_progressive.c): the coefficients of
# their sequential originals, in fixtures/ or fixtures/torch_serving/
TWINS = sorted(p.name for p in (FIXTURES / "torch_progressive").glob("*.jpg"))


def assert_same_image(a, b):
    assert (a.height, a.width) == (b.height, b.width)
    assert a.progressive == b.progressive
    assert a.warnings == b.warnings and a.n_warnings == b.n_warnings
    assert len(a.planes) == len(b.planes)
    for pa, pb in zip(a.planes, b.planes):
        assert pa.data.dtype == pb.data.dtype == np.int16
        assert pa.quant.dtype == pb.quant.dtype == np.uint16
        assert (pa.h_samp, pa.w_samp) == (pb.h_samp, pb.w_samp)
        np.testing.assert_array_equal(pa.data, pb.data)
        np.testing.assert_array_equal(pa.quant, pb.quant)


@pytest.mark.parametrize("name", ALL_JPEGS)
def test_torch_reader_matches_libjpeg_reader(name):
    path = FIXTURES / name
    assert_same_image(read_jpeg(path), read_jpeg_ref(path))


# the SOF types libjpeg-turbo refuses: lossless, hierarchical, reserved
@pytest.mark.parametrize("sof", [0xC3, 0xC5, 0xC6, 0xC7, 0xC8, 0xCB, 0xCD,
                                 0xCE, 0xCF])
def test_torch_reader_refuses_what_libjpeg_refuses(sof):
    raw = (FIXTURES / "lineart64_q20_420.jpg").read_bytes()
    i = raw.index(b"\xff\xc0")
    patched = raw[:i + 1] + bytes([sof]) + raw[i + 2:]
    with pytest.raises(ValueError, match=f"SOF{sof - 0xC0}.* not supported"):
        read_jpeg(patched)
    with pytest.raises(ValueError):
        read_jpeg_ref(patched)


def twin_original(name):
    stem = name.split("_prog")[0] + ".jpg"
    for d in (FIXTURES, FIXTURES / "torch_serving"):
        if (d / stem).exists():
            return d / stem
    raise FileNotFoundError(stem)


@pytest.mark.parametrize("name", TWINS)
def test_torch_progressive_twin_equals_its_original(name):
    twin = read_jpeg(FIXTURES / "torch_progressive" / name)
    orig = read_jpeg(twin_original(name))
    assert twin.progressive and not orig.progressive
    assert (twin.height, twin.width) == (orig.height, orig.width)
    assert twin.warnings == () and twin.n_warnings == 0
    for pt, po in zip(twin.planes, orig.planes):
        assert (pt.h_samp, pt.w_samp) == (po.h_samp, po.w_samp)
        np.testing.assert_array_equal(pt.data, po.data)
        np.testing.assert_array_equal(pt.quant, po.quant)


def test_torch_reader_without_compiler_raises(tmp_path, monkeypatch):
    """No Python decoder is left to fall back to: a failed build of the
    entropy decoder raises with the compiler's complaint."""
    from jpeg2png_tpu_torch.kernels import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "fresh")
    monkeypatch.setattr(_build, "_handles", {})
    monkeypatch.setenv("CC", str(tmp_path / "no-such-cc"))
    with pytest.raises(RuntimeError, match="no-such-cc"):
        read_jpeg(FIXTURES / "lineart64_q20_420.jpg")
    assert not list((tmp_path / "fresh").glob("*.so"))


@pytest.mark.parametrize("name,cut", [
    ("photo512_q10_420.jpg", 0.5),     # inside the entropy-coded data
    ("photo512_q10_420.jpg", -2),      # EOI missing
    ("photo512_q10_420.jpg", -10),     # last MCUs missing
    ("odd100x52_q25_420.jpg", 0.7),
    ("lineart64_q50_444.jpg", 0.8),
])
def test_torch_reader_truncated_matches_libjpeg(name, cut):
    raw = (FIXTURES / name).read_bytes()
    n = int(len(raw) * cut) if isinstance(cut, float) else len(raw) + cut
    got = read_jpeg(raw[:n], print_warnings=False)
    ref = read_jpeg_ref(raw[:n], print_warnings=False)
    assert got.warnings  # decodes, with libjpeg's warning texts
    assert_same_image(got, ref)


@pytest.mark.parametrize("junk", [
    b"",
    b"not a jpeg at all",
    b"\xff\xd8\xff\xe0" + b"\x00" * 16,          # truncated header
])
def test_torch_reader_malformed(junk):
    with pytest.raises(ValueError):
        read_jpeg(junk)


def test_torch_reader_header_cut_raises():
    raw = (FIXTURES / "lineart64_q20_420.jpg").read_bytes()
    for n in (400, 580):
        with pytest.raises(ValueError):
            read_jpeg(raw[:n])


def test_torch_reader_restart_intervals(tmp_path):
    """DRI streams: the same coefficients with and without restarts."""
    PIL = pytest.importorskip("PIL.Image")
    src = PIL.open(FIXTURES / "golden" / "photo80_q30_422_i5.png")
    plain, rst = tmp_path / "a.jpg", tmp_path / "b.jpg"
    src.save(plain, "JPEG", quality=40, subsampling=2)
    src.save(rst, "JPEG", quality=40, subsampling=2, restart_marker_blocks=3)
    assert b"\xff\xdd" in rst.read_bytes()
    a, b = read_jpeg(plain), read_jpeg(rst)
    assert_same_image(b, read_jpeg_ref(rst))
    for pa, pb in zip(a.planes, b.planes):
        np.testing.assert_array_equal(pa.data, pb.data)


def test_torch_reader_grayscale_and_policy():
    img = read_jpeg(FIXTURES / "gray64_q30.jpg")
    assert img.nchannel == 1
    require_supported(img)
    with pytest.raises(ValueError, match="only 3 component"):
        require_supported(img, strict_reference_compat=True)


@pytest.mark.parametrize("bits,shape", [
    (8, (21, 33, 3)), (16, (9, 5, 3)), (8, (7, 11)), (16, (6, 4)),
])
def test_torch_png_roundtrip(bits, shape):
    from pngdec import decode_png

    rng = np.random.default_rng(bits)
    dtype = np.uint8 if bits == 8 else np.uint16
    pix = rng.integers(0, 1 << bits, shape).astype(dtype)
    back = decode_png(encode_png(pix, bits))
    assert back.dtype == dtype
    np.testing.assert_array_equal(back, pix)


def _cfg(argv):
    return config_from_args(build_parser().parse_args(argv))


def test_torch_cli_defaults_and_device():
    args = build_parser().parse_args(["a.jpg"])
    assert args.device == "cuda"
    cfg = _cfg(["a.jpg"])
    assert cfg.weights == (0.3, 0.0, 0.0)
    assert cfg.pweights == (0.001,) * 3
    assert cfg.iterations == (50,) * 3
    assert not cfg.separate_components
    assert build_parser().parse_args(["a.jpg", "--device", "cpu"]).device == "cpu"
    with pytest.raises(SystemExit):
        build_parser().parse_args(["a.jpg", "--device", "tpu"])


def test_torch_cli_triples_and_validation():
    with pytest.raises(SystemExit):
        _cfg(["a.jpg", "-w", "0.1,0.2,0.3"])
    with pytest.raises(SystemExit):
        _cfg(["a.jpg", "-i", "1,2,3"])
    cfg = _cfg(["a.jpg", "-s", "-w", "0.1,0.2,0.3", "-i", "1,2,3"])
    assert cfg.weights == (0.1, 0.2, 0.3)
    assert cfg.iterations == (1, 2, 3)
    assert _cfg(["a.jpg", "-p", "0.5"]).pweights == (0.5,) * 3
    for bad in (["-w", "x"], ["-p", "1,2"], ["-i", "1.5"]):
        with pytest.raises(SystemExit):
            _cfg(["a.jpg", *bad])
    assert derive_output_name("x/Pic.JPEG") == "x/Pic.png"
    assert derive_output_name("pic.jpg") == "pic.png"
    assert derive_output_name("pic.bin") == "pic.bin.png"
