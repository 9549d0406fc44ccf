"""The port's lite tiers on the CPU: "two-lite" (K4 + K5 per iteration)
and "mega-lite" (K3's lite mode) against the JAX package's two-lite tier
and XLA solver, the reference goldens through two-lite, resuming a JAX
two-lite carry, the one tier rule (solver.tier_rule) behind active_tier
and runner.plan_buckets, and the dyn2 serving class (solve_bucket_two)
and lite dyn buckets against per-image decodes."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from PIL import Image  # noqa: E402

from jpeg2png_tpu.models import solver as jsolver  # noqa: E402
from jpeg2png_tpu_torch import runner  # noqa: E402
from jpeg2png_tpu_torch.io import read_jpeg  # noqa: E402
from jpeg2png_tpu_torch.models import solver  # noqa: E402
from jpeg2png_tpu_torch.pipeline import smooth_decode  # noqa: E402
from jpeg2png_tpu_torch.utils.config import SolverConfig  # noqa: E402
from test_e2e import assert_metrics_close, load_golden_csv, psnr  # noqa: E402

torch.set_num_threads(2)

S420 = [(1, 1), (2, 2), (2, 2)]


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(pl, "pallas_call", patched)


@pytest.fixture
def force_two_tier(monkeypatch):
    """Push the JAX solver past its whole-solve gates so that small
    geometries take its two-kernel tiers (tests/test_two_lite.py:36)."""
    from jpeg2png_tpu.kernels import iter_step

    monkeypatch.setattr(iter_step, "supports", lambda *a, **k: False)
    monkeypatch.setattr(iter_step, "supports_lite", lambda *a, **k: False)


def _layout(rng, luma_blocks, chroma_blocks):
    datas, quants = [], []
    for (sy, sx) in S420:
        nby, nbx = luma_blocks if sy == 1 else chroma_blocks
        datas.append(rng.integers(-25, 25, (nby, nbx, 8, 8))
                     .astype(np.int16))
        quants.append(rng.integers(1, 60, (8, 8)).astype(np.uint16))
    return datas, quants


def _psnr(a, b):
    mse = ((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2).mean()
    return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))


@pytest.mark.parametrize("luma_blocks,chroma_blocks", [
    ((16, 16), (8, 8)),      # exact 128x128
    ((77, 77), (39, 39)),    # ragged: a luma region gap in the canvas
])
def test_torch_lite_tiers_match_jax_two_lite_and_xla(
        interpret_pallas, force_two_tier, luma_blocks, chroma_blocks):
    """8 iterations of the port's forced two-lite and mega-lite tiers
    against the JAX package's two-lite tier (Pallas in interpret mode)
    and its f32 XLA solver (tests/test_two_lite.py:180-213): metric rows
    0-1 within rtol 1e-4, iterates > 60 dB.  Row 1's prob distance (of
    the first projection) is a difference of near-equal coefficients:
    the port's bf16 gradient moves it by up to 1.6e-4 from the XLA
    solver's (rtol 5e-4 there), and the JAX two-lite tier's own sits
    0.3-0.6% from XLA's here (its bf16 correction and bf16x3 forward
    transform; its kernel test holds the distance to 5e-3), so against it
    rtol 1e-2.  The port's two lite tiers run the same arithmetic, so
    they agree with each other to 1e-4 (rows rtol 1e-5)."""
    rng = np.random.default_rng(3)
    datas, quants = _layout(rng, luma_blocks, chroma_blocks)
    geoms = tuple(jsolver.ChannelGeometry(d.shape[0], d.shape[1], sy, sx)
                  for d, (sy, sx) in zip(datas, S420))
    assert jsolver.active_tier(geoms, True, (0.001,) * 3) == "two-lite"
    args = (datas, quants, S420, 0.3, [0.001] * 3, 8)
    f_lite, m_lite = jsolver.solve_joint(*args, use_pallas=True)
    f_xla, m_xla = jsolver.solve_joint(*args, use_pallas=False)
    ours = {t: solver.solve_joint(*args, device="cpu", tier=t)
            for t in ("two-lite", "mega-lite")}
    for tier, (fd, m) in ours.items():
        for ref_f, ref_m, dist_rtol in ((f_lite, m_lite, 1e-2),
                                        (f_xla, m_xla, 5e-4)):
            ref_m = np.asarray(ref_m)
            for col in (0, 2, 3):
                np.testing.assert_allclose(m[:2, col], ref_m[:2, col],
                                           rtol=1e-4)
            assert m[0, 1] == ref_m[0, 1] == 0.0
            np.testing.assert_allclose(m[1, 1], ref_m[1, 1], rtol=dist_rtol)
            assert _psnr(fd.numpy(), np.asarray(ref_f)) > 60.0, tier
    np.testing.assert_allclose(ours["two-lite"][1], ours["mega-lite"][1],
                               rtol=1e-5)
    np.testing.assert_allclose(ours["two-lite"][0].numpy(),
                               ours["mega-lite"][0].numpy(), atol=1e-4)


@pytest.mark.parametrize("name,trace_iters", [
    ("lineart64_q20_420", 5),
    ("lineart64_q50_444", 5),
    ("photo80_q30_422", 5),
    ("odd100x52_q25_420", 5),
    ("photo512_q10_420", 2),     # flat photo regions: chaos from iteration 2
    ("art120x88_q40_440", 5),
    ("art128x96_q35_411", 5),
])
def test_torch_goldens_through_two_lite(name, trace_iters, fixtures_dir):
    """The reference goldens of tests/test_torch_e2e.py through the forced
    two-lite tier at -i 5: the same gates (CSV rows before the chaos
    point within rtol 6e-3, PNG > 45 dB)."""
    img = read_jpeg(fixtures_dir / f"{name}.jpg")
    result = smooth_decode(img, SolverConfig(iterations=(5,) * 3),
                           device="cpu", tier="two-lite")
    golden = load_golden_csv(fixtures_dir / "golden" / f"{name}_i5.csv")
    assert_metrics_close(result.metrics_per_channel[3][:trace_iters],
                         golden[3][:trace_iters])
    gold_png = np.asarray(
        Image.open(fixtures_dir / "golden" / f"{name}_i5.png"))
    assert psnr(result.pixels, gold_png) > 45.0


def test_torch_carry_from_jax_two_lite_carry(interpret_pallas,
                                             force_two_tier):
    """The JAX package's two-lite tier runs 3 of 5 iterations on its
    padded canvas (128x128 padded to 128x256 columns); the port crops
    its carry (bf16 arrays through numpy as ml_dtypes.bfloat16) and
    resumes the last 2 on each tier.  Rows 0-1 agree with the JAX run's
    rows 3-4 (rtol 1e-4, the distance column 2e-3, as the mega carry's
    test in tests/test_torch_iter_step.py), also from the carry cast to
    float32 with source= given."""
    rng = np.random.default_rng(8)
    datas, quants = _layout(rng, (16, 16), (8, 8))
    weight, pweights = 0.3, [0.001] * 3
    geoms = tuple(jsolver.ChannelGeometry(d.shape[0], d.shape[1], sy, sx)
                  for d, (sy, sx) in zip(datas, S420))
    impl = jsolver._build_solver_impl(geoms, weight, tuple(pweights), 5,
                                      True, "float32", True)
    dj = [jnp.asarray(d) for d in datas]
    qj = [jnp.asarray(q) for q in quants]
    _, _, c3 = impl(dj, qj, None, 3)
    _, m5, _ = impl(dj, qj, None, 5)
    jcarry = (tuple(np.asarray(x) for x in c3[0]),
              tuple(np.asarray(x) for x in c3[1]),
              tuple(np.asarray(x) for x in c3[2]), float(c3[3]), float(c3[4]))
    assert jcarry[1][0].dtype.name == "bfloat16"
    assert jcarry[0][0].shape == (128, 256)
    cast = (jcarry[0], tuple(x.astype(np.float32) for x in jcarry[1]),
            tuple(x.astype(np.float32) for x in jcarry[2])) + jcarry[3:]
    m_j = np.asarray(m5)[3:5]
    for tier, carry_in, source in (("two-lite", jcarry, None),
                                   ("mega-lite", jcarry, None),
                                   ("two", jcarry, None),
                                   ("two-lite", cast, "two-lite")):
        carry = solver.carry_from_numpy(carry_in, datas, quants, S420,
                                        weight, pweights, device="cpu",
                                        tier=tier, source=source)
        assert carry[0].shape == (3, 128, 128)
        _, m_t, _ = solver.solve_steps(datas, quants, S420, weight,
                                       pweights, 5, carry=carry, nsteps=2,
                                       device="cpu", tier=tier)
        for col in (0, 2, 3):
            np.testing.assert_allclose(m_t[:2, col], m_j[:, col], rtol=1e-4)
        np.testing.assert_allclose(m_t[:2, 1], m_j[:, 1], rtol=2e-3)


def _set_gates(monkeypatch, mega, mega_lite, two_lite):
    monkeypatch.setattr(solver, "MEGA_MAX_PIXELS", mega)
    monkeypatch.setattr(solver, "MEGA_LITE_MAX_PIXELS", mega_lite)
    monkeypatch.setattr(solver, "TWO_LITE_MAX_PIXELS", two_lite)


@pytest.mark.parametrize("gates,want", [
    # (mega, mega-lite, two-lite) largest canvases -> tiers of 16x16 ..
    # 1024x1024
    ((64 * 64, 256 * 256, 1 << 62),
     ["mega", "mega-lite", "two-lite", "two-lite"]),
    ((0, 0, 0), ["two", "two", "two", "two"]),
    ((1 << 62, 0, 0), ["mega", "mega", "mega", "mega"]),
    ((0, 256 * 256, 512 * 512), ["mega-lite", "mega-lite", "two-lite",
                                 "two"]),
])
def test_torch_tier_rule_orders_the_tiers(monkeypatch, gates, want):
    """tier_rule takes the first of mega -> mega-lite -> two-lite whose
    size gate holds, else two, and active_tier is tier_rule on the
    canvas; a geometry the whole-solve kernel refuses (4 channels with 4
    prob terms overflow its partials row) skips both mega tiers."""
    _set_gates(monkeypatch, *gates)
    for n, tier in zip((16, 256, 512, 1024), want):
        geoms = (solver.ChannelGeometry(n // 8, n // 8, 1, 1),)
        assert solver.tier_rule(1, n, n, [(1, 1)], 1) == tier
        assert solver.active_tier(geoms) == tier
        four = geoms * 4
        assert solver.active_tier(four) == (
            tier if not tier.startswith("mega")
            else "two-lite" if n * n <= gates[2] else "two")


def test_torch_plan_buckets_follow_the_tier_rule(fixtures_dir, monkeypatch):
    """Serving sorts images by the same rule on the canvas each class
    runs: dyn for a bucket whose tier is mega or mega-lite, dyn2 for a
    two-lite bucket, exact for the rest; bucket_tier names the tier each
    key runs, and the stats count each class and tier."""
    names = ["lineart64_q20_420", "photo80_q30_422", "odd100x52_q25_420",
             "lineart128_q10_420"]
    imgs = [read_jpeg(fixtures_dir / f"{n}.jpg") for n in names]
    areas = [int(np.prod(runner.quantized_bucket_for(im))) for im in imgs]
    a = sorted(set(areas))
    assert len(a) >= 3, areas
    pw = [0.001] * 3
    for gates in ((a[0], a[1], a[2]), (0, a[1], 1 << 62), (a[0], 0, 0),
                  (0, 0, a[1])):
        _set_gates(monkeypatch, *gates)
        plan = runner.plan_buckets(imgs, pw)
        for key, members in plan.items():
            for i in members:
                img = imgs[i]
                b = runner.quantized_bucket_for(img)
                tier = solver.tier_rule(img.nchannel, *b,
                                        [(p.h_samp, p.w_samp)
                                         for p in img.planes], 3)
                cls = {"mega": "dyn", "mega-lite": "dyn",
                       "two-lite": "dyn2", "two": "exact"}[tier]
                assert key[0] == cls, (gates, i, tier, key)
                assert runner.bucket_tier(key, pw) == tier
    _set_gates(monkeypatch, a[0], a[1], a[2])
    stats = {}
    files = [str(fixtures_dir / f"{n}.jpg") for n in names]
    runner.decode_files_batched(files, SolverConfig(iterations=(1,) * 3),
                                stats=stats, device="cpu")
    plan = runner.plan_buckets(imgs, pw)
    assert stats["bucket_classes"] == {
        c: sum(1 for k in plan if k[0] == c) for c in ("dyn", "dyn2",
                                                       "exact")}
    assert sum(stats["bucket_tiers"].values()) == len(imgs)
    assert stats["bucket_tiers"]["two-lite"] == sum(
        len(v) for k, v in plan.items() if k[0] == "dyn2")


def test_torch_two_lite_bucket_for(fixtures_dir):
    """The dyn2 bucket: the ladder shape within 1.8x the natural area,
    else the natural bucket; whole 8x8 blocks of every channel."""
    for f in sorted((fixtures_dir / "torch_serving").glob("*.jpg"))[:16]:
        img = read_jpeg(f)
        b = runner.two_lite_bucket_for(img)
        assert b == runner.quantized_bucket_for(img)
        nh, nw = runner.bucket_shape_for(img)
        assert b[0] * b[1] <= 1.8 * nh * nw
        for p in img.planes:
            assert b[0] % (8 * p.h_samp) == 0 and b[1] % (8 * p.w_samp) == 0


@pytest.mark.parametrize("cls", ["dyn2", "dyn-lite"])
def test_torch_lite_buckets_match_per_image(fixtures_dir, monkeypatch, cls):
    """Mixed-size images through a dyn2 bucket (solve_bucket_two: K4 + K5
    in dynamic-extent mode) or a lite dyn bucket (solve_bucket on K3's
    lite mode) == each image's own solve on the same tier: the state
    after 1 iteration within atol 5e-3 (as the f32 bucket test), bucket
    padding exactly 0, metric rows 0-1 of a 2-iteration run within rtol
    1e-4; iteration chunks with on_chunk and finish() are bit-identical
    to one shot."""
    imgs = [read_jpeg(fixtures_dir / "lineart128_q10_420.jpg"),
            read_jpeg(fixtures_dir / "lineart64_q20_420.jpg")]
    bucket = (256, 256)
    # the rule sends the bucket canvas to mega-lite
    _set_gates(monkeypatch, 0, 1 << 62, 0)

    def run(iters, **kw):
        if cls == "dyn2":
            return runner.solve_bucket_two(imgs, bucket, 0.3, [0.001] * 3,
                                           iters, device="cpu", **kw)
        return runner.solve_bucket(imgs, bucket, 0.3, [0.001] * 3, iters,
                                   device="cpu", **kw)

    tier = "two-lite" if cls == "dyn2" else "mega-lite"
    res1, res3 = run(1), run(3)
    assert res1.fdata.shape == (2, 3, 256, 256)
    for bi, img in enumerate(imgs):
        args = ([p.data for p in img.planes], [p.quant for p in img.planes],
                [(p.h_samp, p.w_samp) for p in img.planes], 0.3,
                [0.001] * 3)
        fx, _ = solver.solve_joint(*args, 1, device="cpu", tier=tier)
        _, mx3 = solver.solve_joint(*args, 3, device="cpu", tier=tier)
        H, W = fx.shape[1:]
        got = res1.fdata[bi].numpy()
        np.testing.assert_allclose(got[:, :H, :W], fx.numpy(), atol=5e-3)
        assert not got[:, H:, :].any() and not got[:, :, W:].any()
        np.testing.assert_allclose(res3.metrics[bi][:2], mx3[:2], rtol=1e-4)
    seen, got = [], {}
    res = run(3, iter_chunk=2,
              on_chunk=lambda mbs, done, m: seen.append((tuple(mbs), done)),
              finish=lambda mbs, f: got.update({m: f[i] for i, m in
                                                enumerate(mbs)}))
    assert res.fdata is None
    assert seen == ([((0,), 2), ((0,), 3), ((1,), 2), ((1,), 3)]
                    if cls == "dyn2" else [((0, 1), 2), ((0, 1), 3)])
    np.testing.assert_array_equal(res.metrics, res3.metrics)
    for m in range(2):
        np.testing.assert_array_equal(got[m].numpy(), res3.fdata[m].numpy())


def test_torch_dyn2_serving_matches_per_file(fixtures_dir, monkeypatch):
    """decode_files_batched with two-lite open for every bucket: all
    images in dyn2 buckets, each PNG within 1 LSB of the file's own
    decode on the two-lite tier."""
    _set_gates(monkeypatch, 0, 0, 1 << 62)
    names = ["lineart64_q20_420", "photo80_q30_422", "odd100x52_q25_420"]
    files = [str(fixtures_dir / f"{n}.jpg") for n in names]
    cfg = SolverConfig(iterations=(2,) * 3)
    stats = {}
    out = runner.decode_files_batched(files, cfg, stats=stats, device="cpu")
    assert stats["bucket_classes"]["dyn2"] >= 2
    assert stats["bucket_classes"]["dyn"] == stats["bucket_classes"][
        "exact"] == 0
    assert stats["k3_dispatches"] == stats["k3_lite_dispatches"] == 0
    for f in files:
        ref = smooth_decode(read_jpeg(f), cfg, device="cpu",
                            tier="two-lite").pixels
        assert np.abs(out[f].astype(int) - ref.astype(int)).max() <= 1
