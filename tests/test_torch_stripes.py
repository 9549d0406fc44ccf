"""The port's row-striped solve on the CPU: ops/tv_halo.py, K7
(kernels/stripe_grad.py::fused_grad_striped) and K6
(kernels/project_step.py::fused_project) plain versions against the JAX
package (Pallas kernels in interpret mode), parallel/stripes.py over CPU
bands against the port's solve_joint and the JAX striped solve on the
8-device CPU mesh, the collective count, chunking, the lite body, the
mesh and pipeline rules, the CLI against the reference goldens, and the
CUDA kernels against their plain versions on a card (skipped without
one)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from PIL import Image  # noqa: E402

from jpeg2png_tpu.kernels import project_step as jproj  # noqa: E402
from jpeg2png_tpu.kernels import stripe_grad as jstripe  # noqa: E402
from jpeg2png_tpu.ops import tv_halo as jtv_halo  # noqa: E402
from jpeg2png_tpu.parallel.mesh import stripe_mesh as jstripe_mesh  # noqa: E402
from jpeg2png_tpu.parallel.stripes import (  # noqa: E402
    solve_striped as jsolve_striped)
from jpeg2png_tpu_torch import pipeline  # noqa: E402
from jpeg2png_tpu_torch.io import read_jpeg  # noqa: E402
from jpeg2png_tpu_torch.kernels import (  # noqa: E402
    grad_step, project_step, stripe_grad)
from jpeg2png_tpu_torch.models import solver  # noqa: E402
from jpeg2png_tpu_torch.ops import tv_halo  # noqa: E402
from jpeg2png_tpu_torch.ops.dct import dct_matrix_f64  # noqa: E402
from jpeg2png_tpu_torch.ops.dct_raster import sampled_dct  # noqa: E402
from jpeg2png_tpu_torch.ops.tv import shift2d  # noqa: E402
from jpeg2png_tpu_torch.parallel import stripes  # noqa: E402
from jpeg2png_tpu_torch.parallel.mesh import (  # noqa: E402
    available_devices, stripe_mesh)
from jpeg2png_tpu_torch.utils.config import SolverConfig  # noqa: E402
from test_e2e import assert_metrics_close, load_golden_csv, psnr  # noqa: E402
from test_torch_solver import assert_rows_close, synth_channels  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(pl, "pallas_call", patched)


def cpu_mesh(n):
    return stripe_mesh(n, ["cpu"] * n)


def _band_window(canvas, row0, L, halo):
    """Rows [row0 - halo, row0 + L + halo) of a [C, H, W] canvas, zeros
    outside it."""
    C, H, W = canvas.shape
    out = np.zeros((C, L + 2 * halo, W), np.float32)
    for i in range(L + 2 * halo):
        r = row0 - halo + i
        if 0 <= r < H:
            out[:, i] = canvas[:, r]
    return out


# ------------------------------------------------------------ ops/tv_halo

@pytest.mark.parametrize("C,weight,row0,h_true,w_true", [
    (3, 0.3, 0, 80, 120),      # first band
    (3, 0.3, 32, 80, 120),     # middle band
    (3, 0.3, 64, 80, 120),     # last band, true extent inside it
    (1, 0.0, 32, 96, 128),     # TV only, no padding
    (2, 0.5, 64, 70, 128),     # true extent 6 rows into the last band
])
def test_torch_tv_halo_matches_jax(C, weight, row0, h_true, w_true):
    """grad_gather_halo of the port and of the JAX package, each in f32, on
    a band of a 96x128 canvas (frozen zero padding past the true extent),
    each held against the port's band stencil evaluated in float64 on the
    same inputs: the gradient within _f32_stencil_bound per pixel, tv and
    tv2 rtol 1e-5 (f32 sums of 4096 positive terms in blocked order, a few
    ulps of log2(4096) * 2^-24 ~ 7e-7).  A miss names the side that
    moved."""
    rng = np.random.default_rng(31)
    L = 32
    canvas = rng.normal(0, 50, (C, 96, 128)).astype(np.float32)
    canvas[:, h_true:] = 0.0
    canvas[:, :, w_true:] = 0.0
    ext = _band_window(canvas, row0, L, 2)
    got = tv_halo.grad_gather_halo(torch.as_tensor(ext), row0, h_true,
                                   weight, w_true=w_true)
    ref = jtv_halo.grad_gather_halo(jnp.asarray(ext), row0, h_true, weight,
                                    w_true=w_true)
    e64 = torch.as_tensor(ext).double()
    exact = tv_halo.grad_gather_halo(e64, row0, h_true, weight,
                                     w_true=w_true)
    tol = _f32_stencil_bound(e64, row0, h_true, w_true, weight).numpy()
    g64 = exact[0].numpy()
    for side, g in (("port", got[0].numpy()), ("JAX", np.asarray(ref[0]))):
        err = np.abs(g.astype(np.float64) - g64)
        bad = err > tol
        assert not bad.any(), (
            f"{side} side: {int(bad.sum())} of {bad.size} gradient elements "
            f"beyond the f32 bound (worst {float((err / tol).max()):.3g}x, "
            f"max abs err {float(err.max()):.3g})")
        for k, what in ((1, "tv"), (2, "tv2")):
            val = float((got if side == "port" else ref)[k])
            np.testing.assert_allclose(val, float(exact[k]), rtol=1e-5,
                                       err_msg=f"{side} side {what}")
    # nothing outside the true canvas
    g = got[0].numpy()
    assert not g[:, max(0, h_true - row0):].any() and not g[:, :, w_true:].any()


def _f32_stencil_bound(e64, row0, h_true, w_true, weight):
    """Per-pixel bound [L, W] on the error of an f32 evaluation of the band
    stencil against float64, u = 2^-24, from the float64 norms.

    The inputs are exact in both.  A TV term a = gx / |g| rounds once in
    the difference, then in the squares and the C-channel sum, the sqrt,
    the reciprocal and the product: relative error <= (C + 5) u, and |a|
    <= 1, so each of the 4 TV terms of a pixel is off by at most (C + 5) u,
    plus the gather's own additions: alpha * 4 (C + 6) u.  A TGV2 term p =
    (g_xx + sym) / |G| differences two rounded first differences, so its
    numerator is off by up to ~3 u F, F the first-order norm of the pixels
    feeding it (the pixel, its left and upper neighbours), and 1 / |G|
    carries that to p as 3 u F / |G|; with the norm's own rounding and the
    sign-free bound |p| <= 2, each of the 7 terms a pixel gathers is off
    by at most 8 (C + 5) u (1 + F / |G|) (0 where |G| = 0: both sides
    compute exact zeros there), times alpha2."""
    C, T, W = e64.shape
    rows = (int(row0) - stripe_grad.HALO_ROWS + torch.arange(T))[:, None]
    cols = torch.arange(W)[None, :]
    _, g_norm, n2 = grad_step.stencil(e64, rows, cols, h_true, w_true, weight)
    u = 2.0 ** -24
    tol = torch.full((T, W), 4 * (C + 6) * u / np.sqrt(C), dtype=torch.float64)
    if n2 is not None:
        def at(a, dy, dx):                 # a[y + dy, x + dx], zero outside
            return shift2d(a, -dy, -dx)
        feed = torch.maximum(g_norm, torch.maximum(at(g_norm, 0, -1),
                                                   at(g_norm, -1, 0)))
        term = torch.where(n2 > 0, 1.0 + feed / n2.clamp_min(1e-300), 0.0)
        gathered = sum(at(term, dy, dx) for dy, dx in (
            (0, 0), (0, 1), (0, -1), (1, 0), (-1, 0), (1, -1), (-1, 1)))
        tol = tol + 8 * (C + 5) * u * grad_step.tgv_alpha(C, weight) * gathered
    return tol[stripe_grad.HALO_ROWS:T - stripe_grad.HALO_ROWS]


# ------------------------------------------------------------ K7

K7_CASES = [
    # C, prob, weight, L, W, row0, h_true, w_true, halo_top, halo_bot
    (3, [True, True, False], 0.3, 32, 128, 0, 96, 128, False, True),
    (3, [True, True, True], 0.3, 32, 128, 32, 96, 120, True, True),
    (3, [False] * 3, 0.0, 32, 128, 64, 80, 128, True, False),
    (1, [True], 0.3, 32, 128, 96, 80, 100, True, False),
    (2, [False, True], 0.5, 64, 256, 64, 200, 256, True, True),
]


@pytest.mark.parametrize(
    "C,prob,weight,L,W,row0,h_true,w_true,halo_top,halo_bot", K7_CASES)
def test_torch_plain_k7_matches_pallas(interpret_pallas, C, prob, weight, L,
                                       W, row0, h_true, w_true, halo_top,
                                       halo_bot):
    """K7's plain version against the JAX package's fused_grad_striped:
    the first, a middle and the last band, a true extent ending inside a
    band and a band wholly in the padding, zero and random halos, prob on
    and off, C = 1, 2, 3.  The JAX halos are 8 rows deep (its DMA tiling);
    the port reads the 2 rows the stencil reaches.  Gradient and extrap
    within 1e-5 of their magnitude, the sums rtol 1e-5 (other summation
    orders); the gradient outside the true extent is the prob term alone."""
    rng = np.random.default_rng(32)
    f = rng.normal(0, 50, (C, L, W)).astype(np.float32)
    fi = (f + rng.normal(0, 2, f.shape)).astype(np.float32)
    P = sum(prob)
    pg = rng.normal(0, 1, (P, L, W)).astype(np.float32)
    halos = []
    for on in (halo_top, halo_top, halo_bot, halo_bot):
        halos.append(rng.normal(0, 50, (C, 8, W)).astype(np.float32) if on
                     else np.zeros((C, 8, W), np.float32))
    f_top, fi_top, f_bot, fi_bot = halos
    factor = 0.37
    it = iter(pg)
    pgs = [next(it) if p else None for p in prob]
    got = stripe_grad.fused_grad_striped(
        torch.as_tensor(f), torch.as_tensor(fi),
        [None if p is None else torch.as_tensor(p) for p in pgs],
        (torch.as_tensor(f_top[:, -2:]), torch.as_tensor(f_bot[:, :2]),
         torch.as_tensor(fi_top[:, -2:]), torch.as_tensor(fi_bot[:, :2])),
        factor, row0, weight, h_true, w_true)
    ref = jstripe.fused_grad_striped(
        [jnp.asarray(x) for x in f], [jnp.asarray(x) for x in fi],
        [None if p is None else jnp.asarray(p) for p in pgs],
        ([jnp.asarray(x) for x in f_top], [jnp.asarray(x) for x in f_bot],
         [jnp.asarray(x) for x in fi_top], [jnp.asarray(x) for x in fi_bot]),
        jnp.float32(factor), jnp.int32(row0), weight, h_true, w_true)
    assert got[0].shape == got[1].shape == (C, L, W)
    for c in range(C):
        for k in (0, 1):
            r = np.asarray(ref[k][c])
            np.testing.assert_allclose(
                got[k][c].numpy(), r,
                atol=1e-5 * max(1.0, float(np.abs(r).max())))
        if not prob[c]:
            g = got[0][c].numpy()
            assert not g[max(0, h_true - row0):].any()
            assert not g[:, w_true:].any()
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), rtol=1e-5)
    np.testing.assert_allclose(float(got[3]), float(ref[3]), rtol=1e-5)
    if weight:
        np.testing.assert_allclose(float(got[4]), float(ref[4]), rtol=1e-5)
    else:
        assert float(got[4]) == 0.0


def test_torch_plain_k7_band_split_equals_whole_canvas():
    """Bands with their neighbours' rows as halos give K1's whole-canvas
    gradient and extrapolation bit for bit; the band sums add up to the
    canvas sums."""
    from jpeg2png_tpu_torch.kernels import grad_step

    rng = np.random.default_rng(33)
    C, H, W = 3, 96, 64
    f = torch.as_tensor(rng.normal(0, 50, (C, H, W)).astype(np.float32))
    fi = f + torch.as_tensor(rng.normal(0, 2, (C, H, W)).astype(np.float32))
    pg = torch.as_tensor(rng.normal(0, 1, (2, H, W)).astype(np.float32))
    whole = grad_step.fused_grad(f, fi, [pg[0], None, pg[1]], 0.3, 0.3,
                                 h_true=90, w_true=60)
    hr, L = stripe_grad.HALO_ROWS, 32
    z = torch.zeros((C, hr, W))
    parts = []
    for r0 in range(0, H, L):
        top = (z, z) if r0 == 0 else (f[:, r0 - hr:r0], fi[:, r0 - hr:r0])
        bot = ((z, z) if r0 + L == H
               else (f[:, r0 + L:r0 + L + hr], fi[:, r0 + L:r0 + L + hr]))
        parts.append(stripe_grad.fused_grad_striped(
            f[:, r0:r0 + L], fi[:, r0:r0 + L],
            [pg[0, r0:r0 + L], None, pg[1, r0:r0 + L]],
            (top[0], bot[0], top[1], bot[1]), 0.3, r0, 0.3, 90, 60))
    for k in (0, 1):
        torch.testing.assert_close(torch.cat([p[k] for p in parts], 1),
                                   whole[k], rtol=0, atol=0)
    for k in (2, 3, 4):
        torch.testing.assert_close(sum(p[k] for p in parts), whole[k],
                                   rtol=1e-5, atol=0)


# ------------------------------------------------------------ K6

def _k6_problem(rng, H, W, sy, sx, prob, gap_rows=0, pad=None):
    """K6's inputs: extrap ~ N(0, 50), grad ~ N(0, 1), boxes centred on
    fmid's own coefficients with a +-2-step jitter (some bind); `gap_rows`
    coefficient rows a region gap (+-2^39 boxes, dq = iq = 0); `pad`
    coefficient rows of frozen padding (zero state, lo = hi = 0)."""
    e = rng.normal(0, 50, (H, W)).astype(np.float32)
    g = rng.normal(0, 1, (H, W)).astype(np.float32)
    scale = np.float32(0.03)
    hc, wc = H // sy, W // sx
    q = np.tile(rng.integers(1, 60, (8, 8)).astype(np.float32),
                (hc // 8, wc // 8))
    if pad:
        e[-pad * sy:] = 0.0
        g[-pad * sy:] = 0.0
    coefs = sampled_dct(torch.as_tensor(e - scale * g), sy, sx).numpy()
    dq = ((np.round(coefs / q) + rng.integers(-2, 3, (hc, wc))) * q
          ).astype(np.float32)
    lo, hi, iq = dq - 0.5 * q, dq + 0.5 * q, 1.0 / q
    if gap_rows:
        lo[-gap_rows:] = -project_step.GAP_BOX
        hi[-gap_rows:] = project_step.GAP_BOX
        dq[-gap_rows:] = 0.0
        iq[-gap_rows:] = 0.0
    if pad:
        for a in (lo, hi, dq, iq):
            a[-pad:] = 0.0
    pa_ss = 0.36 * sy * sx if prob else 0.0
    return e, g, scale, lo, hi, dq, iq, pa_ss


def _bf16_back_bound(x_max, scale=1.0):
    """Bound on the error of the JAX kernel's single-pass bf16 backward
    transform D^T x D of values up to x_max (project_step.py:90-105,
    123-133 of the JAX package): four roundings to bf16, each within 2^-9
    relative (x, the two transform factors, the intermediate), times the
    largest column sum of |D| squared; the port transforms in f32."""
    dcol = float(np.abs(dct_matrix_f64()).sum(axis=0).max())
    return 4 * 2.0 ** -9 * x_max * dcol ** 2 * scale


@pytest.mark.parametrize("sy,sx,prob,gap_rows,pad", [
    (1, 1, True, 0, 0),
    (2, 2, True, 8, 0),
    (2, 1, False, 0, 8),
    (1, 2, True, 0, 0),
    (2, 2, False, 0, 0),
])
def test_torch_plain_k6_matches_pallas(interpret_pallas, sy, sx, prob,
                                       gap_rows, pad):
    """K6's plain version against the JAX package's fused_project at W =
    256 ((W/sx) % 128 == 0, the JAX gate), samplings (1,1), (2,2), (2,1)
    and (1,2), prob on and off, a region gap and frozen padding.  fnew
    within the JAX test's atol 1e-3 widened by the bound of the JAX
    kernel's bf16 correction (its correction form against the port's
    reconstruction); pgrad within 1e-3 of its magnitude plus the same
    bound on devp * iq times p_alpha; the distance rtol 5e-3 (the JAX
    kernel's bf16x3 forward transform).  Frozen padding stays 0 in both."""
    rng = np.random.default_rng(34)
    H, W = 64, 256
    e, g, scale, lo, hi, dq, iq, pa_ss = _k6_problem(rng, H, W, sy, sx, prob,
                                                     gap_rows, pad)
    t = torch.as_tensor
    got = project_step.fused_project(
        t(e), t(g), t(scale), t(lo), t(hi), t(dq) if prob else None,
        t(iq) if prob else None, pa_ss, sy, sx)
    ref = jproj.fused_project(
        jnp.asarray(e), jnp.asarray(g), jnp.float32(scale), jnp.asarray(lo),
        jnp.asarray(hi), jnp.asarray(dq) if prob else None,
        jnp.asarray(iq) if prob else None, pa_ss, sy, sx)
    coefs = sampled_dct(t(e - scale * g), sy, sx)
    clamped = torch.minimum(torch.maximum(coefs, t(lo)), t(hi))
    x_max = float((clamped - coefs).abs().max())
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                               atol=1e-3 + _bf16_back_bound(x_max))
    if not prob:
        assert got[1] is None and ref[1] is None and float(got[2]) == 0.0
    else:
        devq = ((clamped - t(dq)) * t(iq) * t(iq)).abs().max()
        p_ref = np.asarray(ref[1])
        np.testing.assert_allclose(
            got[1].numpy(), p_ref,
            atol=1e-3 * float(np.abs(p_ref).max())
            + _bf16_back_bound(float(devq), pa_ss / (sy * sx)))
        np.testing.assert_allclose(float(got[2]), float(ref[2]), rtol=5e-3)
    if pad:
        assert not got[0][-pad * sy:].any()
        assert not np.asarray(ref[0])[-pad * sy:].any()


def test_torch_plain_k6_equals_k2_on_one_channel():
    """K6 is K2's arithmetic for one channel: the plain versions agree bit
    for bit on a one-channel band."""
    rng = np.random.default_rng(35)
    e, g, scale, lo, hi, dq, iq, pa_ss = _k6_problem(rng, 32, 48, 2, 2, True)
    t = torch.as_tensor
    one = project_step.fused_project(t(e), t(g), t([scale]), t(lo), t(hi),
                                     t(dq), t(iq), pa_ss, 2, 2)
    multi = project_step.fused_project_multi(
        t(e)[None], t(g)[None], t([scale]), [t(lo)], [t(hi)], [t(dq)],
        [t(iq)], [pa_ss], [(2, 2)])
    torch.testing.assert_close(one[0], multi[0][0], rtol=0, atol=0)
    torch.testing.assert_close(one[1], multi[1][0], rtol=0, atol=0)
    torch.testing.assert_close(one[2], multi[2][0], rtol=0, atol=0)


# ------------------------------------------------------------ solve_striped

LAYOUTS = [
    # n, layout (nby, nbx, sy, sx per channel), weight, pweight
    (4, [(16, 16, 1, 1), (8, 8, 2, 2), (8, 8, 2, 2)], 0.3, 0.001),
    # unaligned height: 208 rows over 4 bands of 64, the last 16 rows real
    (4, [(26, 16, 1, 1), (13, 8, 2, 2), (13, 8, 2, 2)], 0.3, 0.001),
    # region gap: the luma region 96x48 of a 112x64 canvas
    (4, [(12, 6, 1, 1), (7, 4, 2, 2), (7, 4, 2, 2)], 0.3, 0.001),
    # one channel, TV only: K6 bands
    (8, [(16, 8, 1, 1)], 0.0, 0.001),
    # prob off
    (2, [(16, 16, 1, 1)] * 3, 0.3, 0.0),
    # 4:2:2 over 8 bands of 16 rows, the last band all padding
    (8, [(14, 8, 1, 1), (14, 4, 1, 2), (14, 4, 1, 2)], 0.3, 0.001),
]


@pytest.mark.parametrize("n,layout,weight,pweight", LAYOUTS)
def test_torch_striped_matches_solve_joint_and_jax(n, layout, weight,
                                                   pweight):
    """The f32 body over n CPU bands against the port's solve_joint (rows
    0-1 to the solver test's rtol 1e-4: the band sums add in another
    order; fdata atol 0.5, the JAX striped test's gate) and against the
    JAX package's solve_striped(use_pallas=False) on the 8-device CPU mesh
    (test_stripes.py:64's rtol 5e-3 / atol 1e-2 on every row, fdata atol
    0.5)."""
    rng = np.random.default_rng(36)
    datas, quants, samps = synth_channels(rng, layout)
    C = len(datas)
    args = (datas, quants, samps, weight, [pweight] * C, 4)
    fd_s, m_s = stripes.solve_striped(*args, cpu_mesh(n))
    fd_1, m_1 = solver.solve_joint(*args, device="cpu")
    assert fd_s.shape == fd_1.shape
    assert_rows_close(m_s[:2], m_1[:2])
    np.testing.assert_allclose(fd_s.numpy(), fd_1.numpy(), atol=0.5)
    fd_j, m_j = jsolve_striped(*args, jstripe_mesh(n), use_pallas=False)
    np.testing.assert_allclose(m_s, np.asarray(m_j), rtol=5e-3, atol=1e-2)
    np.testing.assert_allclose(fd_s.numpy(), np.asarray(fd_j), atol=0.5)


def test_torch_striped_photo_matches_solve_joint(fixtures_dir):
    """photo600x400 (unaligned: 400 rows over 4 bands of 112) against the
    single-canvas solve after 3 iterations: > 55 dB, the JAX test's gate
    (test_stripes.py:107)."""
    img = read_jpeg(fixtures_dir / "photo600x400_q20_420.jpg")
    args = ([p.data for p in img.planes], [p.quant for p in img.planes],
            [(p.h_samp, p.w_samp) for p in img.planes], 0.3, [0.001] * 3, 3)
    fd_s, m_s = stripes.solve_striped(*args, cpu_mesh(4))
    fd_1, m_1 = solver.solve_joint(*args, device="cpu")
    assert_rows_close(m_s[:2], m_1[:2])
    assert psnr(fd_s.numpy(), fd_1.numpy()) > 55.0


@pytest.mark.parametrize("body", stripes.BODIES)
def test_torch_striped_collectives_and_chunks(body):
    """Exactly three collectives per iteration (two halo exchanges, one
    all-reduce), and a chunked solve equals the one-shot solve bit for bit
    (the carry, local distances included, resumes exactly)."""
    rng = np.random.default_rng(37)
    datas, quants, samps = synth_channels(
        rng, [(12, 8, 1, 1), (6, 4, 2, 2), (6, 4, 2, 2)])
    args = (datas, quants, samps, 0.3, [0.001] * 3, 10)
    mesh = cpu_mesh(3)
    fd_1, m_1 = stripes.solve_striped(*args, mesh, body=body)
    assert mesh.comm.counts == {"halo": 20, "all_reduce": 10}
    seen = []
    fd_c, m_c = stripes.solve_striped(
        *args, cpu_mesh(3), body=body, chunk=4,
        on_chunk=lambda done, m: seen.append((done, m.shape[0])))
    assert seen == [(4, 4), (8, 4), (10, 2)]
    np.testing.assert_array_equal(m_c, m_1)
    np.testing.assert_array_equal(fd_c.numpy(), fd_1.numpy())


@pytest.mark.parametrize("n,layout", [
    (4, [(16, 16, 1, 1), (8, 8, 2, 2), (8, 8, 2, 2)]),
    (4, [(26, 16, 1, 1), (13, 8, 2, 2), (13, 8, 2, 2)]),
])
def test_torch_striped_lite_matches_two_lite_tier(n, layout):
    """The lite body forced (K4 + K5 per band) against the port's two-lite
    tier on the whole canvas: rows 0-1 rtol 1e-4 (band sums in another
    order), fdata atol 0.5; the carry is the lite format (bf16 d)."""
    rng = np.random.default_rng(38)
    datas, quants, samps = synth_channels(rng, layout)
    args = (datas, quants, samps, 0.3, [0.001] * 3, 4)
    fd_s, m_s = stripes.solve_striped(*args, cpu_mesh(n), body="lite")
    fd_1, m_1 = solver.solve_joint(*args, device="cpu", tier="two-lite")
    assert_rows_close(m_s[:2], m_1[:2])
    np.testing.assert_allclose(fd_s.numpy(), fd_1.numpy(), atol=0.5)


def test_torch_striped_body_rule():
    """The f32 body under the committed gates (the two-lite gate is
    closed); the lite one where that gate takes the canvas."""
    g = (solver.ChannelGeometry(16, 16, 1, 1),) * 3
    assert stripes.striped_carry_kind(g, 4) == "f32"
    assert stripes.padded_striped_shape(
        (solver.ChannelGeometry(50, 75, 1, 1),
         solver.ChannelGeometry(25, 38, 2, 2),
         solver.ChannelGeometry(25, 38, 2, 2)), 4) == (400, 608, 448, 608, 112)
    saved = solver.TWO_LITE_MAX_PIXELS
    solver.TWO_LITE_MAX_PIXELS = 1 << 40
    try:
        assert stripes.striped_carry_kind(g, 4) == "lite"
    finally:
        solver.TWO_LITE_MAX_PIXELS = saved
    with pytest.raises(ValueError, match="unknown striped body"):
        stripes.solve_striped([np.zeros((2, 2, 8, 8), np.int16)],
                              [np.ones((8, 8))], [(1, 1)], 0.3, [0.001], 1,
                              cpu_mesh(2), body="f16")


def test_torch_mesh_refuses_silent_truncation():
    """More bands than devices raise (never a smaller mesh); an explicit
    device list may repeat a device."""
    have = available_devices("cuda")
    with pytest.raises(ValueError, match="have"):
        stripe_mesh(have + 1)
    with pytest.raises(ValueError, match="bands asked for"):
        stripe_mesh(3, ["cpu"] * 2)
    mesh = stripe_mesh(4, ["cpu"] * 4)
    assert mesh.n == 4 and mesh.first == 0 and len(mesh.devices) == 4


def test_torch_pipeline_clamps_stripes_with_a_warning(fixtures_dir, capsys,
                                                     monkeypatch):
    """--tpu-stripes beyond the devices clamps to them with a warning on
    stderr (to the single-device solver when one is left) and gives the
    pixels of the clamped run."""
    img = read_jpeg(fixtures_dir / "lineart64_q20_420.jpg")
    cfg = SolverConfig(iterations=(3,) * 3)
    ref2 = pipeline.smooth_decode(img, cfg, device="cpu", stripes=2)
    ref1 = pipeline.smooth_decode(img, cfg, device="cpu")
    capsys.readouterr()
    for avail, ref, what in ((2, ref2, "striping over 2"),
                             (1, ref1, "single-device solver")):
        monkeypatch.setattr(pipeline, "available_devices",
                            lambda device, n=avail: n)
        res = pipeline.smooth_decode(img, cfg, device="cpu", stripes=7)
        err = capsys.readouterr().err
        assert f"--tpu-stripes 7 exceeds the {avail} available" in err
        assert what in err
        np.testing.assert_array_equal(res.pixels, ref.pixels)


def test_torch_cli_stripes_golden(fixtures_dir, tmp_path):
    """`--tpu-stripes 4 --device cpu` (four CPU bands) on the unaligned
    photo600x400 at default flags: > 45 dB against the reference binary's
    PNG."""
    from jpeg2png_tpu_torch.cli import main

    out = tmp_path / "striped.png"
    assert main([str(fixtures_dir / "photo600x400_q20_420.jpg"), "-o",
                 str(out), "-q", "--tpu-stripes", "4", "--device", "cpu"]) == 0
    gold = np.asarray(Image.open(fixtures_dir / "golden"
                                 / "photo600x400_q20_420_i50.png"))
    assert psnr(np.asarray(Image.open(out)), gold) > 45.0


def test_torch_cli_separate_stripes_golden(fixtures_dir, tmp_path):
    """`-s --tpu-stripes 4`: each channel a one-channel striped solve (K6
    bands); the CSV of every channel against the reference's -s log
    (test_e2e.py's gate) and the PNG > 45 dB."""
    from jpeg2png_tpu_torch.cli import main

    out, log = tmp_path / "sep.png", tmp_path / "sep.csv"
    assert main([str(fixtures_dir / "lineart64_q20_420.jpg"), "-o", str(out),
                 "-q", "-s", "-i", "5", "-c", str(log), "--tpu-stripes", "4",
                 "--device", "cpu"]) == 0
    ours = load_golden_csv(log)
    golden = load_golden_csv(fixtures_dir / "golden"
                             / "lineart64_q20_420_s_i5.csv")
    for c in range(3):
        assert_metrics_close(ours[c], golden[c])
    gold = np.asarray(Image.open(fixtures_dir / "golden"
                                 / "lineart64_q20_420_s_i5.png"))
    assert psnr(np.asarray(Image.open(out)), gold) > 45.0


# ------------------------------------------------------------ on a card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def test_torch_cuda_k7_matches_plain(cuda_device):
    """K7 on the card against its plain version (chip_smoke.py holds the
    full set): a middle band with random halos and a true extent inside
    it; K1's gates (gradient 1e-5 of its magnitude, extrap 1e-6, sums rtol
    1e-5)."""
    rng = np.random.default_rng(39)
    C, L, W = 3, 64, 96
    t = lambda x: torch.as_tensor(x.astype(np.float32), device=cuda_device)  # noqa: E731
    f = t(rng.normal(0, 50, (C, L, W)))
    fi = f + t(rng.normal(0, 2, (C, L, W)))
    halos = tuple(t(rng.normal(0, 50, (C, 2, W))) for _ in range(4))
    pg = t(rng.normal(0, 1, (2, L, W)))
    args = (f, fi, [pg[0], None, pg[1]], halos, 0.37, 64, 0.3, 100, 90)
    got = stripe_grad.fused_grad_striped(*args)
    ref = stripe_grad.fused_grad_striped_plain(*args)
    assert stripe_grad.fused_grad_striped.launches > 0
    assert float((got[0] - ref[0]).abs().max()) <= 1e-5 * float(
        ref[0].abs().max())
    assert float((got[1] - ref[1]).abs().max()) <= 1e-6 * float(
        ref[1].abs().max())
    for k in (2, 3, 4):
        torch.testing.assert_close(got[k], ref[k], rtol=1e-5, atol=0)


def test_torch_cuda_k6_matches_plain(cuda_device):
    """K6 on the card against its plain version at (2, 2) with a region
    gap and at (1, 1): chip_smoke.py's K2 gates (fnew 1e-5 of its
    magnitude; pgrad 1e-5 of its magnitude plus p_alpha * 2^-21 of the
    coefficients' magnitude, their rounding in another summation order
    reaching it through (clamp - dq) * iq^2; distance rtol 1e-5)."""
    rng = np.random.default_rng(40)
    for sy, sx, gap in ((2, 2, 8), (1, 1, 0)):
        e, g, scale, lo, hi, dq, iq, pa_ss = _k6_problem(rng, 64, 96, sy, sx,
                                                         True, gap)
        t = lambda x: torch.as_tensor(np.asarray(x, np.float32),  # noqa: E731
                                      device=cuda_device)
        args = (t(e), t(g), t([scale]), t(lo), t(hi), t(dq), t(iq), pa_ss,
                sy, sx)
        got = project_step.fused_project(*args)
        ref = project_step.fused_project_plain(*args)
        assert float((got[0] - ref[0]).abs().max()) <= 1e-5 * float(
            ref[0].abs().max())
        p_tol = (1e-5 * float(ref[1].abs().max())
                 + pa_ss / (sy * sx) * 2.0 ** -21 * float(np.abs(dq).max()))
        assert float((got[1] - ref[1]).abs().max()) <= p_tol
        torch.testing.assert_close(got[2], ref[2], rtol=1e-5, atol=0)


# edges of the row-marching grid for K7 (chip_smoke.py's k7_edge_cases):
# C, prob, weight, L, W, row0, h_true, w_true; "seg" / "seg+1" put
# h_true - 1 on the last / first row of a segment of the band
K7_EDGE_CASES = [
    (3, [True] * 3, 0.3, 8, 64, 8, 64, 64),             # 8-row band
    (3, [True, False, True], 0.3, 16, 128, 16, 40, 124),  # 16-row band
    (2, [True, True], 0.5, 40, 96, 40, 200, 96),        # 40 rows: 16+16+8
    (3, [True] * 3, 0.3, 64, 8, 64, 256, 8),            # 8 columns
    (3, [True] * 3, 0.3, 64, 328, 128, 180, 325),       # 328 columns
    (4, [True] * 4, 0.3, 96, 264, 96, 400, 260),        # C = 4
    (3, [True] * 3, 0.3, 64, 96, 64, "seg", 96),
    (3, [False] * 3, 0.3, 64, 96, 64, "seg+1", 96),
    (3, [True] * 3, 0.3, 64, 96, 64, 70, 90),           # extent in segment 1
]


@pytest.mark.parametrize("C,prob,weight,L,W,row0,h_true,w_true",
                         K7_EDGE_CASES)
def test_torch_cuda_k7_grid_edges(cuda_device, C, prob, weight, L, W, row0,
                                  h_true, w_true):
    """K7 against its plain version where the row-marching grid has edges,
    random halo rows: K1's gates (gradient 1e-5 of its magnitude, extrap
    1e-6, sums rtol 1e-5), and outside the true extent the prob term
    alone."""
    if isinstance(h_true, str):
        seg = grad_step.segment_rows(C, weight != 0.0, L, W)
        assert seg < L
        h_true = row0 + seg + (1 if h_true == "seg+1" else 0)
    rng = np.random.default_rng(41)
    t = lambda x: torch.as_tensor(x.astype(np.float32), device=cuda_device)  # noqa: E731
    f = t(rng.normal(0, 50, (C, L, W)))
    fi = f + t(rng.normal(0, 2, (C, L, W)))
    halos = tuple(t(rng.normal(0, 50, (C, 2, W))) for _ in range(4))
    pg = t(rng.normal(0, 1, (C, L, W)))
    pgs = [pg[c] if on else None for c, on in enumerate(prob)]
    args = (f, fi, pgs, halos, 0.37, row0, weight, h_true, w_true)
    got = stripe_grad.fused_grad_striped(*args)
    ref = stripe_grad.fused_grad_striped_plain(*args)
    assert float((got[0] - ref[0]).abs().max()) <= 1e-5 * max(
        1.0, float(ref[0].abs().max()))
    assert float((got[1] - ref[1]).abs().max()) <= 1e-6 * float(
        ref[1].abs().max())
    for k in (2, 3, 4):
        torch.testing.assert_close(got[k], ref[k], rtol=1e-5, atol=0)
    h_out = max(0, min(L, h_true - row0))
    for c, p in enumerate(pgs):
        want = torch.zeros_like(f[c]) if p is None else p
        assert torch.equal(got[0][c, h_out:], want[h_out:])
        assert torch.equal(got[0][c, :, w_true:], want[:, w_true:])
