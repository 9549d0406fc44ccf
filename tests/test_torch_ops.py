"""PyTorch port ops against tests/oracle.py (float64) and the JAX
package's ops, on the CPU."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import oracle  # noqa: E402
from jpeg2png_tpu.ops import color as jcolor  # noqa: E402
from jpeg2png_tpu.ops import dct_raster as jdr  # noqa: E402
from jpeg2png_tpu.ops import prob as jprob  # noqa: E402
from jpeg2png_tpu.ops import projection as jproj  # noqa: E402
from jpeg2png_tpu.ops import resample as jres  # noqa: E402
from jpeg2png_tpu.ops import tv as jtv  # noqa: E402
from jpeg2png_tpu_torch.ops import blocks, color, dct, dct_raster  # noqa: E402
from jpeg2png_tpu_torch.ops import prob, projection, resample, tv  # noqa: E402

torch.set_num_threads(2)


def t(x):
    return torch.as_tensor(np.array(x, np.float32))


def test_torch_dct_matrix_and_block_layout():
    np.testing.assert_allclose(dct.dct_matrix_f64(), oracle.dct_matrix(),
                               atol=1e-15)
    rng = np.random.default_rng(0)
    img = rng.normal(0, 1, (16, 24))
    np.testing.assert_array_equal(
        blocks.deblockify(blocks.blockify(t(img))).numpy(), t(img).numpy())
    np.testing.assert_array_equal(blocks.blockify(t(img)).numpy(),
                                  oracle.raster_to_blocks(img).astype(np.float32))


@pytest.mark.parametrize("sy,sx", [(1, 1), (2, 2), (1, 2), (2, 1), (1, 4),
                                   (4, 1), (4, 4)])
def test_torch_sampled_transforms_match_jax(sy, sx):
    rng = np.random.default_rng(1)
    x = rng.normal(0, 100, (64 * sy // 2 + 32 * sy, 32 * sx)).astype(np.float32)
    x = x[: (x.shape[0] // (8 * sy)) * 8 * sy]
    got = dct_raster.sampled_dct(t(x), sy, sx).numpy()
    ref = np.asarray(jdr.sampled_dct(jnp.asarray(x), sy, sx))
    np.testing.assert_allclose(got, ref, atol=2e-3)
    y = rng.normal(0, 10, got.shape).astype(np.float32)
    got_up = dct_raster.sampled_idct_up(t(y), sy, sx).numpy()
    ref_up = np.asarray(jdr.sampled_idct_up(jnp.asarray(y), sy, sx))
    np.testing.assert_allclose(got_up, ref_up, atol=2e-4)
    np.testing.assert_allclose(
        dct_raster._blockdiag_sampled(16, sx),
        jdr._blockdiag_sampled(16, sx), atol=0)


def test_torch_raster_dct_matches_oracle():
    rng = np.random.default_rng(2)
    x = rng.normal(0, 100, (48, 72))
    ref = oracle.blocks_to_raster(np.stack(
        [[oracle.dct2(b) for b in row] for row in oracle.raster_to_blocks(x)]))
    got = dct_raster.dct_raster(t(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-3)
    np.testing.assert_allclose(dct_raster.idct_raster(t(got)).numpy(), x,
                               atol=2e-3)


@pytest.mark.parametrize("sy,sx", [(1, 1), (2, 2), (2, 1), (1, 4)])
def test_torch_upsample_helpers_match_jax(sy, sx):
    rng = np.random.default_rng(3)
    sub = rng.normal(0, 1, (5, 7)).astype(np.float32)
    np.testing.assert_array_equal(
        resample.upsample_replicate(t(sub), sy, sx).numpy(),
        np.asarray(jres.upsample_replicate(jnp.asarray(sub), sy, sx)))
    np.testing.assert_array_equal(
        resample.upsample_nearest_clamped(t(sub), sy, sx, 13, 31).numpy(),
        np.asarray(jres.upsample_nearest_clamped(jnp.asarray(sub), sy, sx,
                                                 13, 31)))
    full = rng.normal(0, 1, (4 * sy, 6 * sx)).astype(np.float32)
    np.testing.assert_allclose(
        resample.footprint_mean(t(full), sy, sx).numpy(),
        np.asarray(jres.footprint_mean(jnp.asarray(full), sy, sx)),
        atol=1e-6)


@pytest.mark.parametrize("bits", [8, 16])
def test_torch_color_matches_jax(bits):
    rng = np.random.default_rng(bits)
    y, cb, cr = (rng.uniform(-40, 300, (9, 13)).astype(np.float32)
                 for _ in range(3))
    got = color.ycbcr_to_rgb_packed(t(y), t(cb), t(cr), bits)
    ref = np.asarray(jcolor.ycbcr_to_rgb_packed(
        jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr), bits))
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)
    g = color.gray_packed(t(y), bits)
    np.testing.assert_array_equal(
        g, np.asarray(jcolor.gray_packed(jnp.asarray(y), bits)))
    # 16-bit white is 65280 (png.c:44-47), not 65535
    white = color.gray_packed(torch.full((2, 2), 300.0), bits)
    assert white.max() == (255 if bits == 8 else 65280)


def test_torch_tv_terms_match_jax_and_oracle():
    rng = np.random.default_rng(4)
    f = rng.normal(0, 30, (3, 12, 17)).astype(np.float32)
    tv_t, g_t, gx_t, gy_t = tv.tv_term(t(f))
    tv_j, g_j, gx_j, gy_j = jtv.tv_term(jnp.asarray(f))
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=1e-4)
    np.testing.assert_allclose(float(tv_t), float(tv_j), rtol=1e-5)
    tv_o, g_o, _, _ = oracle.tv_scatter(f.astype(np.float64))
    np.testing.assert_allclose(g_t.numpy(), g_o, atol=1e-4)
    np.testing.assert_allclose(float(tv_t), tv_o, rtol=1e-5)
    tv2_t, g2_t = tv.tv2_term(gx_t, gy_t, 0.3 / np.sqrt(2))
    tv2_j, g2_j = jtv.tv2_term(gx_j, gy_j, 0.3 / np.sqrt(2))
    np.testing.assert_allclose(g2_t.numpy(), np.asarray(g2_j), atol=1e-4)
    np.testing.assert_allclose(float(tv2_t), float(tv2_j), rtol=1e-5)


def test_torch_tv_constant_image_zero_subgradient():
    f = torch.full((3, 8, 8), 7.0)
    tv_v, g, gx, gy = tv.tv_term(f)
    tv2_v, g2 = tv.tv2_term(gx, gy, 0.2)
    assert float(tv_v) == 0.0 and float(tv2_v) == 0.0
    assert not g.any() and not g2.any()


@pytest.mark.parametrize("sy,sx,include_alpha", [(1, 1, False), (2, 2, True),
                                                 (1, 4, False)])
def test_torch_prob_and_projection_match_jax(sy, sx, include_alpha):
    rng = np.random.default_rng(5)
    hc, wc = 16, 24
    region = rng.normal(0, 50, (hc * sy, wc * sx)).astype(np.float32)
    q = np.tile(rng.integers(1, 40, (8, 8)), (2, 3)).astype(np.float32)
    dq = (np.round(rng.normal(0, 4, (hc, wc))) * q).astype(np.float32)
    lo, hi = dq - 0.5 * q, dq + 0.5 * q
    out_t, cl_t = projection.project_channel_raster(t(region), t(lo), t(hi),
                                                    sy, sx)
    out_j, cl_j = jproj.project_channel_raster(
        jnp.asarray(region), jnp.asarray(lo), jnp.asarray(hi), sy, sx)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-4)
    np.testing.assert_allclose(cl_t.numpy(), np.asarray(cl_j), atol=1e-3)
    # idempotence: projecting a projected image changes nothing
    again, _ = projection.project_channel_raster(out_t, t(lo), t(hi), sy, sx)
    np.testing.assert_allclose(again.numpy(), out_t.numpy(), atol=1e-3)

    cos = cl_j
    d_t, g_t = prob.prob_term_raster(t(cos), t(dq), t(1.0 / q), 0.36, sy, sx,
                                     include_alpha)
    d_j, g_j = jprob.prob_term_raster(
        cos, jnp.asarray(dq), jnp.asarray(1.0 / q), jnp.float32(0.36), sy, sx,
        include_alpha)
    np.testing.assert_allclose(float(d_t), float(d_j), rtol=1e-5)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=1e-4)
