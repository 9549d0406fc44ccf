"""The benchmark's JPEG writer and corpus: the port's reader reads back
exactly the coefficients, quant tables and sampling the writer recorded,
and a seed gives the same files whether minted or loaded."""

import numpy as np
import pytest

from benchmark.inputs import corpus as corpus_mod
from benchmark.inputs.corpus import corpus, plan, synth_image
from benchmark.inputs.jpeg_writer import encode
from jpeg2png_tpu_torch.io import read_jpeg


@pytest.mark.parametrize("w,h,layout,quality", [
    (160, 120, "4:2:0", 20), (101, 67, "4:2:0", 90), (37, 19, "4:2:0", 75),
    (101, 67, "4:2:2", 50), (45, 33, "4:2:2", 30), (99, 77, "4:4:4", 90),
    (17, 9, "4:4:4", 40), (320, 248, "4:2:0", 60)])
def test_reader_reads_back_what_the_writer_recorded(w, h, layout, quality):
    data, comps = encode(synth_image(w, h, 5), quality, layout)
    img = read_jpeg(data)
    assert (img.width, img.height) == (w, h)
    assert len(img.planes) == len(comps) == 3
    for plane, (coefs, quant, samp) in zip(img.planes, comps):
        assert np.array_equal(plane.data, coefs)
        assert np.array_equal(plane.quant, quant)
        assert (plane.h_samp, plane.w_samp) == samp


def test_plan_cycles_sizes_and_qualities():
    traffic = {"sizes": [[10, 8, "4:2:0"], [12, 9, "4:4:4"], [7, 7, "4:2:2"]],
               "qualities": [20, 30], "repeat": 2}
    files = plan(traffic)
    assert [f[0] for f in files] == list(range(6))
    assert [f[1:4] for f in files[:3]] == [f[1:4] for f in files[3:]]
    assert [f[4] for f in files] == [20, 30, 20, 30, 20, 30]


def test_a_seed_mints_and_loads_the_same_files(tmp_path, monkeypatch):
    monkeypatch.setattr(corpus_mod, "CACHE", tmp_path)
    traffic = {"sizes": [[40, 24, "4:2:0"], [33, 17, "4:4:4"]],
               "qualities": [50], "repeat": 1}
    minted = corpus(2 ** 31 + 7, traffic, workers=2, log=lambda s: None)
    loaded = corpus(2 ** 31 + 7, traffic, workers=2, log=lambda s: None)
    other = corpus(2 ** 31 + 8, traffic, workers=2, log=lambda s: None)
    for a, b, c in zip(minted, loaded, other):
        assert a.path == b.path
        assert open(a.path, "rb").read() != open(c.path, "rb").read()
        for (ca, qa, sa), (cb, qb, sb) in zip(a.components, b.components):
            assert np.array_equal(ca, cb) and np.array_equal(qa, qb)
            assert sa == sb
        img = read_jpeg(a.path)
        assert np.array_equal(img.planes[0].data, a.components[0][0])
