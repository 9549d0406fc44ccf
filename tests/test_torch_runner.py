"""The port's bucketed serving (runner.py, cli --tpu-batch) on the CPU:
solve_bucket against per-image solves of the port and of the JAX
package, bucketing of the serving corpus, error isolation, and the
port's corpus module against the JAX package's."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jpeg2png_tpu.models import solver as jsolver  # noqa: E402
from jpeg2png_tpu.utils import corpus as jcorpus  # noqa: E402
from jpeg2png_tpu_torch import runner  # noqa: E402
from jpeg2png_tpu_torch.io import read_jpeg  # noqa: E402
from jpeg2png_tpu_torch.kernels.project_step import FREE_Q  # noqa: E402
from jpeg2png_tpu_torch.models import solver  # noqa: E402
from jpeg2png_tpu_torch.pipeline import smooth_decode  # noqa: E402
from jpeg2png_tpu_torch.utils import corpus  # noqa: E402
from jpeg2png_tpu_torch.utils.config import SolverConfig  # noqa: E402

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
SERVING = REPO / "tests" / "fixtures" / "torch_serving"


def _args(img):
    return ([p.data for p in img.planes], [p.quant for p in img.planes],
            [(p.h_samp, p.w_samp) for p in img.planes])


@pytest.mark.parametrize("reference", ["port", "jax"])
def test_torch_solve_bucket_matches_per_image(fixtures_dir, reference):
    """Mixed-size images through one dynamic-extent bucket == per-image
    solves (as tests/test_runner.py:57-98): state after 1 iteration
    within atol 5e-3, bucket padding exactly 0, metric rows 0-1 of a
    2-iteration run within rtol 1e-4."""
    imgs = [read_jpeg(fixtures_dir / "lineart128_q10_420.jpg"),
            read_jpeg(fixtures_dir / "lineart64_q20_420.jpg")]
    bucket = (256, 256)
    res1 = runner.solve_bucket(imgs, bucket, 0.3, [0.001] * 3, 1,
                               device="cpu")
    res2 = runner.solve_bucket(imgs, bucket, 0.3, [0.001] * 3, 2,
                               device="cpu")
    assert res1.fdata.shape == (2, 3, 256, 256)
    for bi, img in enumerate(imgs):
        if reference == "port":
            fx, _ = solver.solve_joint(*_args(img), 0.3, [0.001] * 3, 1,
                                       device="cpu")
            _, mx2 = solver.solve_joint(*_args(img), 0.3, [0.001] * 3, 2,
                                        device="cpu")
            fx = fx.numpy()
        else:
            fx, _ = jsolver.solve_joint(*_args(img), 0.3, [0.001] * 3, 1,
                                        use_pallas=False)
            _, mx2 = jsolver.solve_joint(*_args(img), 0.3, [0.001] * 3, 2,
                                         use_pallas=False)
            fx = np.asarray(fx)
        H, W = fx.shape[1:]
        got = res1.fdata[bi].numpy()
        np.testing.assert_allclose(got[:, :H, :W], fx, atol=5e-3)
        assert not got[:, H:, :].any() and not got[:, :, W:].any()
        np.testing.assert_allclose(res2.metrics[bi][:2],
                                   np.asarray(mx2)[:2], rtol=1e-4)


def test_torch_solve_bucket_chunks_and_finish(fixtures_dir):
    """Iteration chunks with on_chunk are bit-identical to one shot, and
    finish() receives the device canvases instead of fdata."""
    imgs = [read_jpeg(fixtures_dir / "lineart64_q20_420.jpg"),
            read_jpeg(fixtures_dir / "odd100x52_q25_420.jpg")]
    one = runner.solve_bucket(imgs, (128, 128), 0.3, [0.001] * 3, 5,
                              device="cpu")
    seen, got = [], {}
    res = runner.solve_bucket(
        imgs, (128, 128), 0.3, [0.001] * 3, 5, device="cpu", iter_chunk=2,
        on_chunk=lambda mbs, done, m: seen.append((tuple(mbs), done,
                                                  m.shape)),
        finish=lambda mbs, f: got.update({m: f[i] for i, m in
                                          enumerate(mbs)}))
    assert res.fdata is None
    assert seen == [((0, 1), 2, (2, 2, 4)), ((0, 1), 4, (2, 2, 4)),
                    ((0, 1), 5, (2, 1, 4))]
    np.testing.assert_array_equal(res.metrics, one.metrics)
    for m in range(2):
        np.testing.assert_array_equal(got[m].numpy(), one.fdata[m].numpy())
    assert runner.bucket_dispatches(2, 5, False) == 1
    assert runner.bucket_dispatches(9, 50, True) == 2 * 7


@pytest.mark.parametrize("name,gap", [
    ("lineart64_q20_420", False), ("photo80_q30_422", False),
    ("photo72_q85_444", False), ("gray64_q30", False),
    ("odd100x52_q25_420", True)])
def test_torch_bucket_setup_equals_single_image_setup(fixtures_dir, name,
                                                      gap):
    """A bucket of one image on its own canvas builds exactly the single
    image's K3 inputs and f0 (int16 rasters, quant rasters with FREE_Q over
    a region gap, the upsampled initial decode), its extent the canvas and
    its step size the single solve's in f32; on a larger bucket canvas the
    same values sit at the top left, with 0 beyond the image."""
    img = read_jpeg(fixtures_dir / f"{name}.jpg")
    prob = solver._build_problem(*_args(img), 0.3, [0.001] * 3, 50, True,
                                 torch.device("cpu"))
    own = (prob.H, prob.W)
    assert any(bool((q == FREE_Q).any()) for q in prob.qs_c) == gap
    f0, dats, qs, ext, step = runner.prepare_chunk([img], own, 50, "cpu")
    assert torch.equal(f0[0], prob.f0)
    for c in range(img.nchannel):
        assert torch.equal(dats[c][0], prob.dats_c[c])
        assert torch.equal(qs[c][0], prob.qs_c[c])
    assert ext.tolist() == [list(own)]
    assert step.dtype == torch.float32
    assert step.tolist() == [float(np.float32(prob.step_size))]
    big = (own[0] + 32, own[1] + 64)
    f0, dats, qs, _, _ = runner.prepare_chunk([img], big, 50, "cpu")
    assert torch.equal(f0[0, :, :own[0], :own[1]], prob.f0)
    f0[0, :, :own[0], :own[1]] = 0
    assert not f0.any()
    for c, (sy, sx) in enumerate(prob.samps):
        hc, wc = own[0] // sy, own[1] // sx
        for got, want in ((dats[c][0], prob.dats_c[c]),
                          (qs[c][0], prob.qs_c[c])):
            assert torch.equal(got[:hc, :wc], want)
            got[:hc, :wc] = 0
            assert not got.any()


def test_torch_corpus_buckets():
    """Every serving-corpus size lands in a bucket that holds its canvas
    (at most 1.8x the natural bucket's area), and the 24 sizes collapse
    to a handful of shared buckets."""
    files = sorted(SERVING.glob("*.jpg"))
    assert len(files) == 48
    keys = set()
    for f in files[:len(corpus.SIZES)]:
        img = read_jpeg(f)
        hb, wb = runner.quantized_bucket_for(img)
        nh, nw = runner.bucket_shape_for(img)
        H = max(p.nby * 8 * p.h_samp for p in img.planes)
        W = max(p.nbx * 8 * p.w_samp for p in img.planes)
        assert (nh, nw) == (H, W)
        assert H <= hb and W <= wb and hb * wb <= 1.8 * nh * nw
        for p in img.planes:
            assert hb % (8 * p.h_samp) == 0 and wb % (8 * p.w_samp) == 0
        keys.add((hb, wb, tuple((p.h_samp, p.w_samp) for p in img.planes)))
    assert len(keys) <= 16, sorted(keys)


def test_torch_buckets_follow_the_mega_gate(fixtures_dir, monkeypatch):
    """Serving sends a bucket to K3 by the single-image tier's rule
    (solver.tier_rule on the bucket canvas, the lite tiers' gates closed
    here): buckets above MEGA_MAX_PIXELS go to the two-kernel (exact)
    class, and moving the threshold moves them; the exact class decodes
    like the per-file path and launches no K3."""
    monkeypatch.setattr(solver, "MEGA_LITE_MAX_PIXELS", 0)
    monkeypatch.setattr(solver, "TWO_LITE_MAX_PIXELS", 0)
    names = ["lineart64_q20_420", "photo80_q30_422", "odd100x52_q25_420"]
    files = [str(fixtures_dir / f"{n}.jpg") for n in names]
    imgs = [read_jpeg(f) for f in files]
    areas = [int(np.prod(runner.quantized_bucket_for(im))) for im in imgs]
    assert len(set(areas)) == 3, areas
    for limit in (0, *sorted(areas), 1 << 40):
        monkeypatch.setattr(solver, "MEGA_MAX_PIXELS", limit)
        plan = runner.plan_buckets(imgs, [0.001] * 3)
        dyn = sorted(i for k, v in plan.items() if k[0] == "dyn" for i in v)
        assert dyn == [i for i, a in enumerate(areas) if a <= limit]
        for i, img in enumerate(imgs):
            # an image whose bucket is its own canvas takes the tier the
            # single-image path gives it
            if runner.quantized_bucket_for(img) == runner.bucket_shape_for(
                    img):
                geoms = solver._geometry(*_args(img)[::2])
                assert (i in dyn) == (solver.active_tier(geoms) == "mega")

    monkeypatch.setattr(solver, "MEGA_MAX_PIXELS", sorted(areas)[1])
    cfg = SolverConfig(iterations=(2,) * 3)
    stats = {}
    out = runner.decode_files_batched(files, cfg, stats=stats, device="cpu")
    assert stats["bucket_classes"] == {"dyn": 2, "dyn2": 0, "exact": 1}
    assert stats["k3_dispatches"] == 2
    for f, img in zip(files, imgs):
        ref = smooth_decode(img, cfg, device="cpu").pixels
        assert np.abs(out[f].astype(int) - ref.astype(int)).max() <= 1


def test_torch_batched_error_isolation(fixtures_dir, tmp_path):
    """A corrupt member drops out with an error; the rest still solve
    (as tests/test_runner.py:101-113)."""
    junk = tmp_path / "junk.jpg"
    junk.write_bytes(b"\xff\xd8\xff\xe0 this is not a real jpeg")
    files = [str(fixtures_dir / "lineart64_q20_420.jpg"), str(junk),
             str(fixtures_dir / "photo80_q30_422.jpg")]
    errors, stats = [], {}
    out = runner.decode_files_batched(files, SolverConfig(iterations=(2,) * 3),
                                      errors=errors, stats=stats,
                                      device="cpu")
    assert set(out) == {files[0], files[2]}
    assert len(errors) == 1 and str(junk) in errors[0]
    assert out[files[0]].shape == (64, 64, 3)
    assert stats["n_files"] == 2 and stats["k3_dispatches"] == 2


def test_torch_batched_error_raises_without_list(tmp_path):
    junk = tmp_path / "junk.jpg"
    junk.write_bytes(b"not a jpeg at all")
    with pytest.raises((ValueError, OSError)):
        runner.decode_files_batched([str(junk), str(junk)],
                                    SolverConfig(iterations=(2,) * 3),
                                    device="cpu")


def test_torch_cli_tpu_batch_matches_per_file(fixtures_dir, tmp_path):
    """cli --tpu-batch writes the PNGs the per-file decodes give (within
    1 LSB), in a process that never imports JAX."""
    names = ["lineart64_q20_420", "photo80_q30_422", "gray64_q30",
             "odd100x52_q25_420", "art120x88_q40_440"]
    ins = [str(fixtures_dir / f"{n}.jpg") for n in names]
    outs = [str(tmp_path / f"{n}.png") for n in names]
    argv = ins + [a for o in outs for a in ("-o", o)] + [
        "--tpu-batch", "--device", "cpu", "-i", "2", "-q"]
    code = ("import sys\n"
            "from jpeg2png_tpu_torch.cli import main\n"
            f"rc = main({argv!r})\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'jpeg2png_tpu')]\n"
            "print(rc, len(bad))\n")
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    assert run.stdout.split() == ["0", "0"]
    from pngdec import decode_png

    cfg = SolverConfig(iterations=(2,) * 3)
    for i, o in zip(ins, outs):
        ref = smooth_decode(read_jpeg(i), cfg, device="cpu").pixels
        got = decode_png(pathlib.Path(o).read_bytes())
        assert got.shape == ref.shape
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


@pytest.mark.parametrize("w,h,seed", [(160, 120, 0), (200, 144, 7),
                                      (97, 61, 100003)])
def test_torch_synth_image_matches_jax(w, h, seed):
    np.testing.assert_array_equal(corpus.synth_image(w, h, seed),
                                  jcorpus.synth_image(w, h, seed))
    assert corpus.SIZES == jcorpus.SIZES
    assert corpus.QUALITIES == jcorpus.QUALITIES
