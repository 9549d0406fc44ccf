"""The port's lite kernels on the CPU: K4 (kernels/stripe_grad.py), K5
(kernels/project_step.py::fused_project_multi_lite) and K3's lite mode
(kernels/iter_step.py), each plain version against the JAX package's
Pallas kernel in interpret mode, and the CUDA kernels against the plain
versions on a card (skipped without one)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from jpeg2png_tpu.kernels import iter_step as jiter  # noqa: E402
from jpeg2png_tpu.kernels import project_step as jproj  # noqa: E402
from jpeg2png_tpu.kernels import stripe_grad as jstripe  # noqa: E402
from jpeg2png_tpu_torch.kernels import iter_step, project_step, stripe_grad  # noqa: E402
from jpeg2png_tpu_torch.ops.dct import dct_matrix_f64  # noqa: E402
from jpeg2png_tpu_torch.ops.dct_raster import sampled_dct  # noqa: E402

torch.set_num_threads(2)

S420 = [(1, 1), (2, 2), (2, 2)]
S422 = [(1, 1), (1, 2), (1, 2)]
S411 = [(1, 1), (1, 4), (1, 4)]
S440 = [(1, 1), (2, 1), (2, 1)]


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(pl, "pallas_call", patched)


def _bf16(x):
    """Round float32 values to bfloat16 and back (numpy float32)."""
    return torch.as_tensor(np.asarray(x, np.float32)).to(
        torch.bfloat16).to(torch.float32).numpy()


def _state(rng, C, H, W):
    """bf16-exact iterates and FISTA differences, as test_two_lite.py:68
    makes them."""
    f = _bf16(rng.normal(0, 50, (C, H, W)))
    d = _bf16(rng.normal(0, 2, (C, H, W)))
    return f, d


def _devqs(rng, H, W, samps, prob):
    return [_bf16(rng.normal(0, 0.1, (H // sy, W // sx)))
            for (sy, sx), p in zip(samps, prob) if p]


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.asarray(x, np.float32)).to(dtype)


def _bf16_gate(got, ref, extra=0.0):
    """The lite kernels' bf16-output gate of tests/test_two_lite.py:100:
    |err| <= max|ref| / 128 (one bf16 step at the largest magnitude)
    + 1e-4, plus `extra` where the two sides' f32 values differ."""
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    err = np.abs(got - ref).max()
    tol = np.abs(ref).max() / 128 + 1e-4 + extra
    assert err <= tol, (err, tol)


K4_CASES = [
    # samps, prob, weight, L, row0, h_pad, h_true, w_true, halo, dynamic
    (S420, [True, True, False], 0.3, 128, 0, 128, 128, 256, False, False),
    (S420, [True, True, True], 0.3, 128, 64, 320, 300, 250, True, False),
    (S420, [True, True, True], 0.3, 128, 128, 256, 200, 200, True, True),
    (S422, [False, False, False], 0.5, 128, 32, 192, 192, 256, True, False),
    ([(1, 1)], [True], 0.0, 128, 16, 160, 150, 256, True, True),
]


# the same at W = 512 (3 of the CUDA kernel's 254-column strips, the last
# ragged; the JAX kernel takes W % 128 == 0): 4:2:0, and 4:1:1, whose
# 32-column blocks the strip edges cut
K4_WIDE_CASES = [
    # samps, prob, weight, L, row0, h_pad, h_true, w_true, halo, dynamic
    (S420, [True, True, True], 0.3, 64, 64, 192, 180, 500, True, False),
    (S411, [True, False, True], 0.3, 64, 0, 64, 64, 512, False, True),
]


@pytest.mark.parametrize(
    "samps,prob,weight,L,row0,h_pad,h_true,w_true,halo,dynamic", K4_CASES)
def test_torch_plain_k4_matches_pallas(interpret_pallas, samps, prob, weight,
                                       L, row0, h_pad, h_true, w_true, halo,
                                       dynamic):
    """K4's plain version against the JAX package's
    fused_grad_striped_lite: zero and nonzero halos, row0 > 0, static and
    dynamic extents, prob on and off, 4:2:0, 4:2:2 and C = 1.  The JAX
    halos are 16 rows deep (its DMA tiling); the port reads the 2 rows the
    stencil reaches.  Gates of tests/test_two_lite.py:96-104: the bf16
    gradient within max|ref|/128 + 1e-4 (the JAX kernel expands devq with
    single-pass bf16 transforms, the port in f32), sums rtol 1e-5."""
    _k4_vs_pallas(samps, prob, weight, L, 256, row0, h_pad, h_true, w_true,
                  halo, dynamic)


@pytest.mark.parametrize(
    "samps,prob,weight,L,row0,h_pad,h_true,w_true,halo,dynamic",
    K4_WIDE_CASES)
def test_torch_plain_k4_wide_matches_pallas(interpret_pallas, samps, prob,
                                            weight, L, row0, h_pad, h_true,
                                            w_true, halo, dynamic):
    """K4's plain version against the JAX package's kernel at W = 512,
    4:2:0 and 4:1:1, with the gates of test_torch_plain_k4_matches_pallas."""
    _k4_vs_pallas(samps, prob, weight, L, 512, row0, h_pad, h_true, w_true,
                  halo, dynamic)


def _k4_vs_pallas(samps, prob, weight, L, W, row0, h_pad, h_true, w_true,
                  halo, dynamic):
    rng = np.random.default_rng(11)
    C = len(samps)
    pa_ss = [0.36 * sy * sx if p else 0.0 for (sy, sx), p in zip(samps, prob)]
    f, d = _state(rng, C, L, W)
    devqs = _devqs(rng, L, W, samps, prob)
    if halo:
        tops = [_state(rng, C, 16, W) for _ in range(2)]
    else:
        tops = [(np.zeros((C, 16, W), np.float32),) * 2] * 2
    (f_top, d_top), (f_bot, d_bot) = tops
    factor = 0.37
    ext = (h_true, w_true)
    got = stripe_grad.fused_grad_striped_lite(
        _t(f), _t(d, torch.bfloat16), [_t(x, torch.bfloat16) for x in devqs],
        (_t(f_top[:, -2:]), _t(f_bot[:, :2]),
         _t(d_top[:, -2:], torch.bfloat16), _t(d_bot[:, :2], torch.bfloat16)),
        factor, row0, weight, samps, pa_ss, h_pad, h_true, w_true,
        extents=torch.tensor(ext, dtype=torch.int32) if dynamic else None)
    ref = jstripe.fused_grad_striped_lite(
        [jnp.asarray(x) for x in f],
        [jnp.asarray(x, jnp.bfloat16) for x in d],
        [jnp.asarray(x, jnp.bfloat16) for x in devqs],
        ([jnp.asarray(x) for x in f_top], [jnp.asarray(x) for x in f_bot],
         [jnp.asarray(x, jnp.bfloat16) for x in d_top],
         [jnp.asarray(x, jnp.bfloat16) for x in d_bot]),
        jnp.float32(factor), jnp.int32(row0), weight, samps, pa_ss,
        h_pad=h_pad, h_true=h_true, w_true=w_true,
        extents=jnp.asarray(ext, jnp.int32) if dynamic else None)
    assert got[0].dtype == torch.bfloat16 and got[0].shape == (C, L, W)
    for c in range(C):
        _bf16_gate(got[0][c].float().numpy(),
                   np.asarray(ref[0][c]).astype(np.float32))
        # outside the true extent the gradient is the prob term alone
        if not prob[c]:
            g = got[0][c].float().numpy()
            assert not g[max(0, h_true - row0):].any()
            assert not g[:, w_true:].any()
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=1e-5)
    np.testing.assert_allclose(float(got[2]), float(ref[2]), rtol=1e-5)
    if weight:
        np.testing.assert_allclose(float(got[3]), float(ref[3]), rtol=1e-5)
    else:
        assert float(got[3]) == 0.0


def test_torch_plain_k4_band_split_equals_whole_canvas():
    """Two bands with each other's rows as halos give the whole-canvas
    gradient (the halos carry everything the stencil reads across a band
    edge), bit for bit; the band sums add up to the canvas sums."""
    rng = np.random.default_rng(12)
    samps, C, H, W = S420, 3, 128, 96
    f, d = _state(rng, C, H, W)
    prob = [True] * 3
    devqs = _devqs(rng, H, W, samps, prob)
    pa_ss = [0.36 * sy * sx for sy, sx in samps]
    ft, dt = _t(f), _t(d, torch.bfloat16)
    dq = [_t(x, torch.bfloat16) for x in devqs]
    whole = stripe_grad.fused_grad_striped_lite(
        ft, dt, dq, None, 0.3, 0, 0.3, samps, pa_ss, H, 120, 90)
    cut, hr = 64, stripe_grad.HALO_ROWS
    zf = torch.zeros((C, hr, W))
    zd = zf.to(torch.bfloat16)
    top = stripe_grad.fused_grad_striped_lite(
        ft[:, :cut], dt[:, :cut], [x[:cut // sy] for x, (sy, _) in
                                   zip(dq, samps)],
        (zf, ft[:, cut:cut + hr], zd, dt[:, cut:cut + hr]), 0.3, 0, 0.3,
        samps, pa_ss, H, 120, 90)
    bot = stripe_grad.fused_grad_striped_lite(
        ft[:, cut:], dt[:, cut:], [x[cut // sy:] for x, (sy, _) in
                                   zip(dq, samps)],
        (ft[:, cut - hr:cut], zf, dt[:, cut - hr:cut], zd), 0.3, cut, 0.3,
        samps, pa_ss, H, 120, 90)
    torch.testing.assert_close(torch.cat([top[0], bot[0]], 1), whole[0],
                               rtol=0, atol=0)
    for k in (1, 2, 3):
        torch.testing.assert_close(top[k] + bot[k], whole[k], rtol=1e-5,
                                   atol=0)


def _k5_problem(rng, C, H, W, samps, prob, gap_rows=0):
    """K5's inputs as test_two_lite.py:119-140 makes them, plus an
    optional region gap (FREE quant, data 0) in channel 0."""
    f, d = _state(rng, C, H, W)
    g = _bf16(rng.normal(0, 1, (C, H, W)))
    datas, qs = [], []
    for c, (sy, sx) in enumerate(samps):
        hc, wc = H // sy, W // sx
        q = np.tile(rng.integers(1, 60, (8, 8)).astype(np.float32),
                    (hc // 8, wc // 8))
        data = np.round(rng.normal(0, 5, (hc, wc))).astype(np.int16)
        if c == 0 and gap_rows:
            q[-gap_rows:] = project_step.FREE_Q
            data[-gap_rows:] = 0
        datas.append(data)
        qs.append(q)
    pa_ss = [0.36 * sy * sx if p else 0.0 for (sy, sx), p in zip(samps, prob)]
    return f, d, g, datas, qs, pa_ss


def _correction_bound(f, d, g, factor, scales, datas, qs, samps):
    """Per channel: the bound on the JAX lite projection's error from its
    single-pass bf16 backward transform of the correction x = clamp -
    coefs (project_step.py:686-719 of the JAX package).  Four roundings
    to bf16, each within 2^-9 relative (x, the two DCT factors, the
    intermediate), so each output of D^T x D is off by at most 4 * 2^-9 *
    max|x| * (max column sum of |D|)^2; the reconstruction the port uses
    has no such term."""
    dcol = float(np.abs(dct_matrix_f64()).sum(axis=0).max())
    out = []
    for c, (sy, sx) in enumerate(samps):
        fmid = torch.as_tensor(f[c] + factor * d[c] - scales[c] * g[c])
        coefs = sampled_dct(fmid, sy, sx)
        lo, hi, _, _ = project_step.boxes(torch.as_tensor(datas[c]),
                                          torch.as_tensor(qs[c]))
        x = (torch.minimum(torch.maximum(coefs, lo), hi) - coefs).abs().max()
        out.append(4 * 2.0 ** -9 * float(x) * dcol ** 2)
    return out


@pytest.mark.parametrize("samps,prob,gap_rows", [
    (S420, [True, True, False], 0),
    (S420, [True, True, True], 16),
    (S422, [True, False, True], 0),
    ([(1, 1)], [True], 0),
])
def test_torch_plain_k5_matches_pallas(interpret_pallas, samps, prob,
                                       gap_rows):
    """K5's plain version against the JAX package's
    fused_project_multi_lite (gates of tests/test_two_lite.py:153-173):
    fnew within the JAX test's atol 1e-3 widened by the bound of the JAX
    kernel's bf16 correction (_correction_bound); dnew and devq within
    max|ref|/128 + 1e-4, the dnew gate widened by the fnew gate (dnew =
    fnew - f) and the devq gate by the JAX kernel's bf16x3 forward DCT
    (2^-16 of the coefficients' magnitude, q >= 1); distances rtol 5e-3."""
    rng = np.random.default_rng(13)
    C, H, W = len(samps), 128, 256
    f, d, g, datas, qs, pa_ss = _k5_problem(rng, C, H, W, samps, prob,
                                            gap_rows)
    factor = 0.41
    scales = np.float32([1.3, 0.7, 2.1][:C])
    got = project_step.fused_project_multi_lite(
        _t(f), _t(d, torch.bfloat16), _t(g, torch.bfloat16), factor,
        torch.as_tensor(scales), [torch.as_tensor(x) for x in datas],
        [torch.as_tensor(q) for q in qs], pa_ss, samps)
    ref = jproj.fused_project_multi_lite(
        [jnp.asarray(x) for x in f],
        [jnp.asarray(x, jnp.bfloat16) for x in d],
        [jnp.asarray(x, jnp.bfloat16) for x in g], jnp.float32(factor),
        jnp.asarray(scales), [jnp.asarray(x) for x in datas],
        [jnp.asarray(q) for q in qs], pa_ss, samps)
    bound = _correction_bound(f, d, g, factor, scales, datas, qs, samps)
    for c in range(C):
        f_tol = 1e-3 + bound[c]
        np.testing.assert_allclose(got[0][c].numpy(), np.asarray(ref[0][c]),
                                   atol=f_tol)
        _bf16_gate(got[1][c].float().numpy(),
                   np.asarray(ref[1][c]).astype(np.float32), extra=f_tol)
        if not prob[c]:
            assert got[2][c] is None and ref[2][c] is None
            assert float(got[3][c]) == 0.0
            continue
        mag = float(np.abs(datas[c].astype(np.float32) * np.where(
            qs[c] < project_step.FREE_Q_MIN, qs[c], 0)).max())
        _bf16_gate(got[2][c].float().numpy(),
                   np.asarray(ref[2][c]).astype(np.float32),
                   extra=mag * 2.0 ** -16)
        np.testing.assert_allclose(float(got[3][c]), float(ref[3][c]),
                                   rtol=5e-3)
    if gap_rows:
        # the region gap is unconstrained and carries no prob term
        assert not got[2][0][-gap_rows:].float().any()


def test_torch_plain_k5_keeps_padding_at_zero():
    """Frozen padding (q == 0) with a zero state stays exactly 0 in fnew,
    dnew and devq."""
    rng = np.random.default_rng(14)
    samps, C, H, W = S420, 3, 64, 96
    f, d, g, datas, qs, pa_ss = _k5_problem(rng, C, H, W, samps,
                                            [True] * 3)
    for a in (f, d, g):
        a[:, 48:] = 0.0
        a[:, :, 64:] = 0.0
    for c, (sy, sx) in enumerate(samps):
        for a in (datas[c], qs[c]):
            a[48 // sy:] = 0
            a[:, 64 // sx:] = 0
    fnew, dnew, devqs, _ = project_step.fused_project_multi_lite(
        _t(f), _t(d, torch.bfloat16), _t(g, torch.bfloat16), 0.3,
        torch.tensor([1.0, 2.0, 3.0]), [torch.as_tensor(x) for x in datas],
        [torch.as_tensor(q) for q in qs], pa_ss, samps)
    for t in (fnew, dnew.float()):
        assert not t[:, 48:].any() and not t[:, :, 64:].any()
    for dq, (sy, sx) in zip(devqs, samps):
        assert not dq[48 // sy:].float().any()
        assert not dq[:, 64 // sx:].float().any()


@pytest.mark.parametrize("samps,prob,weight", [
    (S420, [True, True, True], 0.3),
    (S420, [True, False, True], 0.0),
    ([(1, 1)], [True], 0.3),
])
def test_torch_plain_k3_lite_matches_pallas(interpret_pallas, samps, prob,
                                            weight):
    """One iteration of K3's lite mode: the port's plain
    fused_solve(lite=True) against the JAX package's
    fused_solve(lite=True).  fnew within atol 1e-3 plus the bound of the
    JAX kernel's bf16 correction; fista = f - d and devq (both from bf16)
    within max|ref|/128 + 1e-4, widened as in the K5 test; tv, tv2 and
    sumsq rtol 1e-5 (as K4's), distances rtol 5e-3 (as K5's)."""
    from test_torch_iter_step import _problem

    rng = np.random.default_rng(15)
    C, H, W = len(samps), 128, 256
    f, fi, devqs, datas, qs, pa_ss = _problem(rng, H, W, samps, prob)
    f, fi = _bf16(f), _bf16(fi)
    devqs = [_bf16(x) for x in devqs]
    factor, step = 0.41, 3.7
    got = iter_step.fused_solve(
        torch.as_tensor(f), torch.as_tensor(fi),
        [torch.as_tensor(x) for x in devqs], np.float32([factor]), step,
        [torch.as_tensor(x) for x in datas], [torch.as_tensor(q) for q in qs],
        pa_ss, samps, weight, lite=True)
    ref = jiter.fused_solve(
        [jnp.asarray(x) for x in f], [jnp.asarray(x) for x in fi],
        [jnp.asarray(x) for x in devqs], jnp.float32([factor]),
        jnp.float32(step), [jnp.asarray(x) for x in datas],
        [jnp.asarray(q) for q in qs], pa_ss, samps, weight, lite=True)
    # the iteration's own gradient and scale, for the correction bound
    d = _bf16(f - fi)
    grads, sumsq, _, _ = stripe_grad.fused_grad_striped_lite(
        _t(f), _t(d, torch.bfloat16), [_t(x, torch.bfloat16) for x in devqs],
        None, factor, 0, weight, samps, pa_ss, H, H, W)
    scales = (np.float32(step) / torch.sqrt(sumsq)).numpy()
    bound = _correction_bound(f, d, grads.float().numpy(), factor, scales,
                              datas, qs, samps)
    for c in range(C):
        f_tol = 1e-3 + bound[c]
        np.testing.assert_allclose(got[0][c].numpy(), np.asarray(ref[0][c]),
                                   atol=f_tol)
        _bf16_gate((got[0][c] - got[1][c]).numpy(),
                   np.asarray(ref[0][c]) - np.asarray(ref[1][c]),
                   extra=2 * f_tol)
    prob_cs = [c for c in range(C) if prob[c]]
    for k, c in enumerate(prob_cs):
        mag = float(np.abs(datas[c].astype(np.float32) * qs[c]).max())
        _bf16_gate(got[2][k].numpy(), np.asarray(ref[2][k]),
                   extra=mag * 2.0 ** -16)
    row, jrow = got[3][0].numpy(), np.asarray(ref[3][0])
    np.testing.assert_allclose(row[:C + 2], jrow[:C + 2], rtol=1e-5)
    np.testing.assert_allclose(row[C + 2:C + 2 + len(prob_cs)],
                               jrow[C + 2:C + 2 + len(prob_cs)], rtol=5e-3)


def test_torch_plain_k3_lite_is_k4_then_k5():
    """Two iterations of the plain lite K3 equal two iterations of the
    plain K4 + K5 body on the same state, bit for bit, in a
    dynamic-extent bucket with padding that stays exactly 0."""
    from test_torch_iter_step import _problem

    rng = np.random.default_rng(16)
    samps, H, W = S420, 64, 96
    exts = [(48, 80), (64, 64)]
    probs = [_problem(rng, H, W, samps, [True] * 3, e) for e in exts]
    pa_ss = probs[0][5]
    f = torch.as_tensor(np.stack([p[0] for p in probs]))
    d = (f - torch.as_tensor(np.stack([p[1] for p in probs]))).to(
        torch.bfloat16)
    devqs = [torch.as_tensor(np.stack([p[2][k] for p in probs])).to(
        torch.bfloat16) for k in range(3)]
    datas = [torch.as_tensor(np.stack([p[3][c] for p in probs]))
             for c in range(3)]
    qs = [torch.as_tensor(np.stack([p[4][c] for p in probs]))
          for c in range(3)]
    factors = np.float32([0.0, 0.3])
    steps = torch.tensor([3.0, 4.0])
    got = iter_step.fused_solve_lite(
        f, d, devqs, factors, steps, datas, qs, pa_ss, samps, 0.3,
        extents=torch.tensor(exts, dtype=torch.int32))
    for b, (h, w) in enumerate(exts):
        fb, db, dqb = f[b], d[b], [x[b] for x in devqs]
        for factor in factors:
            g, sumsq, _, _ = stripe_grad.fused_grad_striped_lite(
                fb, db, dqb, None, float(factor), 0, 0.3, samps, pa_ss, H,
                h, w)
            scale = torch.where(sumsq == 0, 0.0, float(steps[b]) /
                                torch.sqrt(sumsq))
            fb, db, dqb, _ = project_step.fused_project_multi_lite(
                fb, db, g, float(factor), scale, [x[b] for x in datas],
                [q[b] for q in qs], pa_ss, samps)
        torch.testing.assert_close(got[0][b], fb, rtol=0, atol=0)
        torch.testing.assert_close(got[1][b], db, rtol=0, atol=0)
        for a, r in zip(got[2], dqb):
            torch.testing.assert_close(a[b], r, rtol=0, atol=0)
        assert not got[0][b, :, h:].any() and not got[0][b, :, :, w:].any()
        assert not got[1][b, :, h:].float().any()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _within_bf16_step(got, ref, extra):
    """|got - ref| <= one bf16 step at each reference element + extra."""
    ref = ref.float()
    step = ref.abs().clamp_min(2.0 ** -126) * 2.0 ** -7
    return bool(((got.float() - ref).abs() <= step + extra).all())


# K4 on the card: samps, prob, weight, L, W, row0, h_pad, (h_true,
# w_true) or None, halo, dynamic.  The row-marching grid's edges: 3 strips
# with a ragged last one (W = 512; W = 520 at 4:4:0), 4:1:1 at W = 1024
# (strip edges inside 32-column blocks), many segments, dynamic extents
# ending on and past a strip boundary, prob on and off
K4_CUDA_CASES = [
    (S420, [True] * 3, 0.3, 128, 256, 0, 128, None, False, False),
    (S420, [True] * 3, 0.3, 64, 512, 64, 192, (180, 500), True, False),
    (S440, [True, False, True], 0.3, 64, 520, 0, 64, (60, 515), False,
     False),
    (S440, [False] * 3, 0.3, 64, 520, 64, 192, None, True, False),
    (S411, [True] * 3, 0.3, 64, 1024, 64, 256, None, True, False),
    (S411, [False] * 3, 0.5, 64, 1024, 0, 64, None, False, False),
    (S420, [True] * 3, 0.3, 1504, 512, 0, 1504, None, False, False),
    (S420, [False] * 3, 0.3, 1504, 512, 0, 1504, (1500, 510), False, False),
    (S420, [True] * 3, 0.3, 128, 512, 0, 128, (120, 254), False, True),
    (S420, [True, False, True], 0.3, 128, 512, 0, 128, (128, 300), False,
     True),
]


def _k4_cuda_case(rng, samps, prob, weight, L, W, row0, h_pad, ext, halo,
                  dynamic):
    """K4 against its plain version on the card: the bf16 gradient within
    one bf16 step of each element plus K1's f32 gate (1e-5 of the
    gradient's magnitude: the prob expansion sums in another order),
    bit-equal without a prob term (the stencil rounds op for op,
    -fmad=false); sums rtol 1e-5."""
    C = len(samps)
    h_true, w_true = ext or (h_pad, W)
    f, d = _state(rng, C, L, W)
    devqs = _devqs(rng, L, W, samps, prob)
    halos = None
    if halo:
        (ft, dt), (fb, db) = (_state(rng, C, 2, W) for _ in range(2))
        halos = (_t(ft).cuda(), _t(fb).cuda(), _t(dt, torch.bfloat16).cuda(),
                 _t(db, torch.bfloat16).cuda())
    pa_ss = [0.36 * sy * sx if p else 0.0 for (sy, sx), p in zip(samps, prob)]
    extents = (torch.tensor([h_true, w_true], dtype=torch.int32).cuda()
               if dynamic else None)
    args = (_t(f).cuda(), _t(d, torch.bfloat16).cuda(),
            [_t(x, torch.bfloat16).cuda() for x in devqs], halos, 0.37, row0,
            weight, samps, pa_ss, h_pad, h_true, w_true, extents)
    got = stripe_grad.fused_grad_striped_lite(*args)
    ref = stripe_grad.fused_grad_striped_lite_plain(*args)
    floor = 1e-5 * max(1.0, float(ref[0].float().abs().max()))
    assert _within_bf16_step(got[0], ref[0], floor)
    if not any(prob):
        assert torch.equal(got[0], ref[0])
    for a, b in zip(got[1:], ref[1:]):
        torch.testing.assert_close(a, b.to(a.device), rtol=1e-5, atol=0)


def test_torch_cuda_k4_k5_match_plain(cuda_device):
    """K4 and K5 on the card against their plain versions (chip_smoke.py
    holds the full set of geometries): K4 over K4_CUDA_CASES with the gates
    of _k4_cuda_case; K5's bf16 outputs within one bf16 step of the element
    plus the f32 gate of the value before rounding (K2's 1e-5 of fnew's
    for dnew, and of the coefficients' for devq), fnew within K2's gate,
    distances rtol 1e-5."""
    rng = np.random.default_rng(17)
    for case in K4_CUDA_CASES:
        _k4_cuda_case(rng, *case)

    samps, C, H, W = S420, 3, 128, 256
    f, d, g, datas, qs, pa_ss = _k5_problem(rng, C, H, W, samps, [True] * 3)
    args = (_t(f).cuda(), _t(d, torch.bfloat16).cuda(),
            _t(g, torch.bfloat16).cuda(), 0.41,
            torch.tensor([1.3, 0.7, 2.1], device=cuda_device),
            [torch.as_tensor(x).cuda() for x in datas],
            [torch.as_tensor(q).cuda() for q in qs], pa_ss, samps)
    got = project_step.fused_project_multi_lite(*args)
    ref = project_step.fused_project_multi_lite_plain(*args)
    f_tol = 1e-5 * float(ref[0].abs().max())
    assert float((got[0] - ref[0]).abs().max()) <= f_tol
    assert _within_bf16_step(got[1], ref[1], f_tol)
    coef = max(float(np.abs(x.astype(np.float32) * q).max())
               for x, q in zip(datas, qs))
    for a, b in zip(got[2], ref[2]):
        assert _within_bf16_step(a, b, 1e-5 * coef)
    torch.testing.assert_close(got[3], ref[3], rtol=1e-5, atol=0)


def test_torch_cuda_k4_after_k1_keeps_its_own_scratch(cuda_device,
                                                      monkeypatch):
    """K4 sizes its partial-sum scratch from its own library's
    j2p_grad_lite_partial_rows for the band, not from K1's grid or query:
    K1 then K4 on one band, the scratch K4's wrapper allocates has the
    rows the stripe_grad library reports, and K4 agrees with its plain
    version with the gates of _k4_cuda_case."""
    from jpeg2png_tpu_torch.kernels import grad_step

    rng = np.random.default_rng(18)
    samps, C, H, W = S420, 3, 256, 512
    f, d = _state(rng, C, H, W)
    ft = _t(f).cuda()
    grad_step.fused_grad(ft, ft - _t(d).cuda(), [None] * C, 0.37, 0.3)
    lib, _ = stripe_grad._launcher()
    want = lib.j2p_grad_lite_partial_rows(C, 1, H, W)
    sizes = []
    scratch = stripe_grad.lite_scratch

    def spy(*a, **k):
        part = scratch(*a, **k)
        sizes.append(part.shape[0])
        return part

    monkeypatch.setattr(stripe_grad, "lite_scratch", spy)
    devqs = _devqs(rng, H, W, samps, [True] * 3)
    pa_ss = [0.36 * sy * sx for sy, sx in samps]
    args = (ft, _t(d, torch.bfloat16).cuda(),
            [_t(x, torch.bfloat16).cuda() for x in devqs], None, 0.37, 0,
            0.3, samps, pa_ss, H, H, W)
    got = stripe_grad.fused_grad_striped_lite(*args)
    ref = stripe_grad.fused_grad_striped_lite_plain(*args)
    assert sizes == [want]
    floor = 1e-5 * max(1.0, float(ref[0].float().abs().max()))
    assert _within_bf16_step(got[0], ref[0], floor)
    torch.testing.assert_close(got[1], ref[1], rtol=1e-5, atol=0)


# ------------------------------------------------- K4's grid and scratch

@pytest.mark.parametrize("L,W,slots,rows", [
    # 3072 / 254 -> 13 strips (12 x 254 + 24); 264 // 13 = 20 segments
    # wanted: ceil(2048 / 20) = 103 rows each, 20 segments (19 x 103 + 91)
    (2048, 3072, 264, 13 * 20),
    # the striped lite band: 49 strips (48 x 254 + 96); 264 // 49 = 5:
    # 410 rows each, 5 segments
    (2048, 12288, 264, 49 * 5),
    # 3 strips (254 + 254 + 4); 88 segments wanted: ceil(1504 / 88) = 18
    # rows, 84 segments (83 x 18 + 10)
    (1504, 512, 264, 3 * 84),
    # 3 strips (254 + 254 + 12); 16-row segments: 4
    (64, 520, 264, 3 * 4),
    (8, 8, 264, 1),             # one strip, one segment shorter than 16 rows
    (64, 96, 1, 1),             # one resident block: the band in one segment
])
def test_torch_k4_partial_rows_mirror(L, W, slots, rows):
    """kernels/stripe_grad.py::lite_partial_rows, the CPU mirror of
    csrc/stripe_grad.cu make_grid, against grids counted by hand: strips
    of 254 columns, segments of at least 16 rows sized so that the grid
    is about one wave of `slots` resident blocks."""
    assert stripe_grad.lite_partial_rows(L, W, slots) == rows


def test_torch_cuda_k4_partial_rows_mirror_matches_library(cuda_device):
    """The mirror against the library on the card: one strip of 2^24 rows
    splits into as many segments as blocks are resident (slots), and every
    grid of the hand-counted cases then has the library's rows."""
    lib, _ = stripe_grad._launcher()
    for C, tgv in ((3, 1), (1, 0), (4, 1)):
        slots = lib.j2p_grad_lite_partial_rows(C, tgv, 1 << 24, 8)
        for L, W in ((2048, 3072), (2048, 12288), (1504, 512), (64, 520),
                     (8, 8)):
            assert lib.j2p_grad_lite_partial_rows(C, tgv, L, W) == \
                stripe_grad.lite_partial_rows(L, W, slots)


class _FakeLiteLib:
    """K4's row-count entry point answering `rows` (or a negative CUDA
    error), and its error string."""

    def __init__(self, rows):
        self.asked = []

        def count(C, tgv, L, W):
            self.asked.append((C, tgv, L, W))
            return rows
        self.j2p_grad_lite_partial_rows = count

        def error_string(err):
            return b"invalid argument"
        self.j2p_error_string = error_string


def test_torch_k4_scratch_is_what_the_library_reports():
    """K4's wrapper sizes its partial-sum scratch from the library's
    j2p_grad_lite_partial_rows for the band (no tile constants in
    Python), and raises on the library's error."""
    lib = _FakeLiteLib(41)
    part = stripe_grad.lite_scratch(lib, 3, True, 2048, 3072, "cpu")
    assert part.shape == (41, 5) and part.dtype == torch.float32
    assert lib.asked == [(3, 1, 2048, 3072)]
    assert stripe_grad.lite_scratch(_FakeLiteLib(1), 1, False, 8, 8,
                                    "cpu").shape == (1, 3)
    with pytest.raises(RuntimeError, match="invalid argument"):
        stripe_grad.lite_scratch(_FakeLiteLib(-1), 3, True, 8, 8, "cpu")
