"""The port's whole-solve kernel K3 (kernels/iter_step.py): its plain
version against the JAX package's Pallas fused_solve (interpret mode, on
the CPU) and against the port's two-kernel body, the mega tier of the
port's solver, and the CUDA kernel against the plain version on a card
(skipped without one)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from jpeg2png_tpu.kernels import iter_step as jiter  # noqa: E402
from jpeg2png_tpu.models import solver as jsolver  # noqa: E402
from jpeg2png_tpu_torch.kernels import iter_step  # noqa: E402
from jpeg2png_tpu_torch.kernels.grad_step import fused_grad_plain  # noqa: E402
from jpeg2png_tpu_torch.kernels.project_step import FREE_Q  # noqa: E402
from jpeg2png_tpu_torch.models import solver  # noqa: E402
from jpeg2png_tpu_torch.ops.dct_raster import (  # noqa: E402
    idct_raster, sampled_dct)
from jpeg2png_tpu_torch.ops.resample import upsample_replicate  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(pl, "pallas_call", patched)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _problem(rng, H, W, samps, prob, extents=None):
    """One image's K3 inputs, as in tests/test_pallas_kernel.py:240:
    boxes centred on the state's own coefficients plus a +-2-step jitter
    so that some bind; the FISTA shadow close to the iterate.  With
    `extents` (h, w) the canvas beyond it is bucket padding: f = 0 and
    quant 0 there."""
    C = len(samps)
    f = rng.normal(0, 50, (C, H, W)).astype(np.float32)
    if extents is not None:
        f[:, extents[0]:, :] = 0.0
        f[:, :, extents[1]:] = 0.0
    fi = f + rng.normal(0, 2, (C, H, W)).astype(np.float32)
    if extents is not None:
        fi[:, extents[0]:, :] = 0.0
        fi[:, :, extents[1]:] = 0.0
    datas, qs, devqs = [], [], []
    for c, (sy, sx) in enumerate(samps):
        hc, wc = H // sy, W // sx
        q = np.tile(rng.integers(1, 60, (8, 8)).astype(np.float32),
                    (hc // 8, wc // 8))
        coefs = sampled_dct(torch.as_tensor(f[c]), sy, sx).numpy()
        data = np.clip(np.round(coefs / q) + rng.integers(-2, 3, (hc, wc)),
                       -2000, 2000).astype(np.int16)
        devq = rng.normal(0, 0.1, (hc, wc)).astype(np.float32)
        if extents is not None:
            eh, ew = extents[0] // sy, extents[1] // sx
            q[eh:, :] = 0.0
            q[:, ew:] = 0.0
            data[eh:, :] = 0
            data[:, ew:] = 0
            devq[eh:, :] = 0.0
            devq[:, ew:] = 0.0
        datas.append(data)
        qs.append(q)
        if prob[c]:
            devqs.append(devq)
    pa_ss = [0.36 * sy * sx if p else 0.0 for (sy, sx), p in zip(samps, prob)]
    return f, fi, devqs, datas, qs, pa_ss


def _corrections(f, fi, devqs, datas, qs, pa_ss, samps, weight, factor,
                 step, extents=None):
    """Per channel max |clip(coefs) - coefs| of one iteration: the JAX
    kernel's single-pass bf16 backward transform has an error relative
    to it (iter_step.col_bwd), so the fnew gate scales with it."""
    it = iter(devqs)
    pgs = []
    for c, (sy, sx) in enumerate(samps):
        if pa_ss[c] == 0.0:
            pgs.append(None)
            continue
        pgs.append(pa_ss[c] / (sy * sx) * upsample_replicate(
            idct_raster(torch.as_tensor(next(it))), sy, sx))
    h, w = extents if extents is not None else (None, None)
    grad, e, sumsq, _, _ = fused_grad_plain(
        torch.as_tensor(f), torch.as_tensor(fi), pgs, factor, weight, h, w)
    scale = torch.where(sumsq == 0, 0.0, step / torch.sqrt(sumsq))
    out = []
    for c, (sy, sx) in enumerate(samps):
        coefs = sampled_dct(e[c] - scale[c] * grad[c], sy, sx)
        dq = torch.as_tensor(datas[c].astype(np.float32) * qs[c])
        q = torch.as_tensor(qs[c])
        cl = torch.minimum(torch.maximum(coefs, dq - 0.5 * q), dq + 0.5 * q)
        out.append(float((cl - coefs).abs().max()))
    return out


ITERATION_CASES = [
    ([(1, 1), (2, 2), (2, 2)], [True, True, True], 0.3, 256, 256),  # 4:2:0
    ([(1, 1)], [True], 0.3, 256, 256),                   # single channel
    ([(1, 1), (2, 2), (2, 2)], [True, False, True], 0.0, 256, 256),
    ([(1, 1), (2, 2), (2, 2)], [True, True, True], 0.3, 208, 272),
    ([(1, 1), (2, 2), (2, 2)], [True, True, True], 0.3, 128, 128),
]


@pytest.mark.parametrize("samps,prob,weight,H,W", ITERATION_CASES)
def test_torch_plain_fused_iteration_matches_pallas(
        interpret_pallas, samps, prob, weight, H, W):
    """One iteration: the port's plain fused_iteration against the JAX
    package's Pallas fused_iteration, with the tolerances of
    tests/test_pallas_kernel.py:240 (they absorb the JAX kernel's
    correction form and single-pass bf16 backward transform)."""
    rng = np.random.default_rng(7)
    f, fi, devqs, datas, qs, pa_ss = _problem(rng, H, W, samps, prob)
    factor, step = 0.41, 3.7
    got = iter_step.fused_iteration(
        torch.as_tensor(f), torch.as_tensor(fi),
        [torch.as_tensor(d) for d in devqs], factor, step,
        [torch.as_tensor(d) for d in datas], [torch.as_tensor(q) for q in qs],
        pa_ss, samps, weight)
    ref = jiter.fused_iteration(
        [jnp.asarray(x) for x in f], [jnp.asarray(x) for x in fi],
        [jnp.asarray(d) for d in devqs], jnp.float32(factor),
        jnp.float32(step), [jnp.asarray(d) for d in datas],
        [jnp.asarray(q) for q in qs], pa_ss, samps, weight)
    corr = _corrections(f, fi, devqs, datas, qs, pa_ss, samps, weight,
                        factor, step)
    for c in range(len(samps)):
        np.testing.assert_allclose(got[0][c].numpy(), np.asarray(ref[0][c]),
                                   atol=3e-2 + corr[c] * 2.0 ** -7)
    for a, b in zip(got[1], ref[1]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-3)
    for a, b in zip(got[4], ref[4]):
        np.testing.assert_allclose(float(a), float(b), rtol=2e-3)
    assert abs(float(got[2]) - float(ref[2])) / float(ref[2]) < 1e-4
    if weight != 0.0:
        assert abs(float(got[3]) - float(ref[3])) / float(ref[3]) < 1e-4
    np.testing.assert_allclose(got[5].numpy(), np.asarray(ref[5]), rtol=1e-3)


def test_torch_plain_dynamic_extents_match_pallas(interpret_pallas):
    """Two true sizes in one 256x256 bucket: the port's batched plain
    fused_solve(extents=...) against the JAX kernel in dynamic-extent
    mode, image by image (same tolerances as the one-iteration test),
    and the bucket padding stays exactly 0 on both sides."""
    rng = np.random.default_rng(3)
    samps = [(1, 1), (2, 2), (2, 2)]
    prob = [True, True, True]
    H = W = 256
    exts = [(176, 208), (96, 256)]
    probs = [_problem(rng, H, W, samps, prob, e) for e in exts]
    pa_ss = probs[0][5]
    factor, steps = 0.3, [4.1, 2.9]
    got = iter_step.fused_solve(
        torch.as_tensor(np.stack([p[0] for p in probs])),
        torch.as_tensor(np.stack([p[1] for p in probs])),
        [torch.as_tensor(np.stack([p[2][k] for p in probs]))
         for k in range(3)],
        np.float32([factor]), torch.tensor(steps, dtype=torch.float32),
        [torch.as_tensor(np.stack([p[3][c] for p in probs]))
         for c in range(3)],
        [torch.as_tensor(np.stack([p[4][c] for p in probs]))
         for c in range(3)],
        pa_ss, samps, 0.3,
        extents=torch.tensor(exts, dtype=torch.int32))
    for b, (p, e) in enumerate(zip(probs, exts)):
        f, fi, devqs, datas, qs, _ = p
        ref = jiter.fused_solve(
            [jnp.asarray(x) for x in f], [jnp.asarray(x) for x in fi],
            [jnp.asarray(d) for d in devqs], jnp.float32([factor]),
            jnp.float32(steps[b]), [jnp.asarray(d) for d in datas],
            [jnp.asarray(q) for q in qs], pa_ss, samps, 0.3,
            extents=jnp.asarray(e, jnp.int32))
        corr = _corrections(f, fi, devqs, datas, qs, pa_ss, samps, 0.3,
                            factor, np.float32(steps[b]), e)
        for c in range(3):
            np.testing.assert_allclose(got[0][b, c].numpy(),
                                       np.asarray(ref[0][c]),
                                       atol=3e-2 + corr[c] * 2.0 ** -7)
            for side in (got[0][b, c].numpy(), np.asarray(ref[0][c])):
                assert not side[e[0]:, :].any() and not side[:, e[1]:].any()
        # devq = (clamp - dq) / q^2: the JAX kernel's bf16x3 forward DCT
        # carries ~16 significant bits, so beside the one-iteration test's
        # 1e-3 the gate allows 2^-16 of the coefficients' magnitude
        # (q >= 1, so 1/q^2 <= 1)
        for k in range(3):
            mag = float(np.abs(datas[k].astype(np.float32) * qs[k]).max())
            np.testing.assert_allclose(got[2][k][b].numpy(),
                                       np.asarray(ref[2][k]),
                                       atol=1e-3 + mag * 2.0 ** -16)
        row, jrow = got[3][b, 0].numpy(), np.asarray(ref[3][0])
        np.testing.assert_allclose(row[:3], jrow[:3], rtol=1e-3)
        np.testing.assert_allclose(row[3:5], jrow[3:5], rtol=1e-4)
        np.testing.assert_allclose(row[5:8], jrow[5:8], rtol=2e-3)


def _synth(rng, layout):
    datas, quants, samps = [], [], []
    for nby, nbx, sy, sx in layout:
        datas.append(rng.integers(-25, 25, (nby, nbx, 8, 8)).astype(np.int16))
        quants.append(rng.integers(1, 80, (8, 8)).astype(np.uint16))
        samps.append((sy, sx))
    return datas, quants, samps


LAYOUTS = [
    ([(4, 4, 1, 1), (2, 2, 2, 2), (2, 2, 2, 2)], 0.3, [0.001] * 3),
    # region gap: luma region smaller than the chroma canvas
    ([(3, 5, 1, 1), (2, 3, 2, 2), (2, 3, 2, 2)], 0.3, [0.001] * 3),
    ([(4, 8, 1, 1), (4, 2, 1, 4), (4, 2, 1, 4)], 0.3, [0.001, 0.0, 0.002]),
    ([(2, 3, 1, 1)], 0.0, [0.001]),
]


@pytest.mark.parametrize("layout,weight,pweights", LAYOUTS)
def test_torch_mega_tier_matches_two_kernel_body(layout, weight, pweights):
    """fused_solve_plain, 3 steps, against the port's two-kernel body on
    the same problem: the same f32 arithmetic, so metric rows agree to
    rtol 1e-5 and the iterates to 1e-4."""
    rng = np.random.default_rng(21)
    datas, quants, samps = _synth(rng, layout)
    args = (datas, quants, samps, weight, pweights, 3)
    f_m, m_m = solver.solve_joint(*args, device="cpu", tier="mega")
    f_t, m_t = solver.solve_joint(*args, device="cpu", tier="two")
    np.testing.assert_allclose(m_m, m_t, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(f_m.numpy(), f_t.numpy(), atol=1e-4)


def test_torch_fused_solve_padding_stays_zero():
    """Bucket padding (quant 0) stays exactly 0 in f, fista and devq over
    several iterations, for every image of a batch."""
    rng = np.random.default_rng(4)
    samps = [(1, 1), (2, 2), (2, 2)]
    exts = [(80, 112), (128, 64), (48, 48)]
    probs = [_problem(rng, 128, 128, samps, [True] * 3, e) for e in exts]
    out = iter_step.fused_solve_plain(
        torch.as_tensor(np.stack([p[0] for p in probs])),
        torch.as_tensor(np.stack([p[1] for p in probs])),
        [torch.as_tensor(np.stack([p[2][k] for p in probs]))
         for k in range(3)],
        np.float32([0.0, 0.2, 0.35, 0.45]),
        torch.tensor([3.0, 5.0, 2.0]),
        [torch.as_tensor(np.stack([p[3][c] for p in probs]))
         for c in range(3)],
        [torch.as_tensor(np.stack([p[4][c] for p in probs]))
         for c in range(3)],
        probs[0][5], samps, 0.3, extents=torch.tensor(exts, dtype=torch.int32))
    for b, (h, w) in enumerate(exts):
        for t in (out[0][b], out[1][b]):
            assert not t[:, h:, :].any() and not t[:, :, w:].any()
        for c, (sy, sx) in enumerate(samps):
            d = out[2][c][b]
            assert not d[h // sy:, :].any() and not d[:, w // sx:].any()
        assert np.isfinite(out[3][b].numpy()).all()


def test_torch_mega_chunked_equals_one_shot():
    rng = np.random.default_rng(5)
    datas, quants, samps = _synth(
        rng, [(4, 4, 1, 1), (2, 2, 2, 2), (2, 2, 2, 2)])
    seen = []
    fd_c, m_c = solver.solve_joint_chunked(
        datas, quants, samps, 0.3, [0.001] * 3, 10, chunk=4,
        on_chunk=lambda done, m: seen.append((done, m.shape[0])),
        device="cpu", tier="mega")
    fd_1, m_1 = solver.solve_joint(datas, quants, samps, 0.3, [0.001] * 3,
                                   10, device="cpu", tier="mega")
    assert seen == [(4, 4), (8, 4), (10, 2)]
    np.testing.assert_array_equal(m_c, m_1)
    np.testing.assert_array_equal(fd_c.numpy(), fd_1.numpy())


def test_torch_active_tier_and_tier_carries(monkeypatch):
    # the mega gate alone, the lite tiers closed: the mega and two tiers
    monkeypatch.setattr(solver, "MEGA_MAX_PIXELS", 1280 * 1024)
    monkeypatch.setattr(solver, "MEGA_LITE_MAX_PIXELS", 0)
    monkeypatch.setattr(solver, "TWO_LITE_MAX_PIXELS", 0)
    geoms = (solver.ChannelGeometry(4, 4, 1, 1),
             solver.ChannelGeometry(2, 2, 2, 2),
             solver.ChannelGeometry(2, 2, 2, 2))
    assert solver.active_tier(geoms) == "mega"
    # 4 channels with 4 prob terms overflow the 8-column partials row
    assert solver.active_tier(geoms + (geoms[0],)) == "two"
    assert solver.active_tier(geoms + (geoms[0],), [0.0] * 4) == "mega"
    big = (solver.ChannelGeometry(512, 512, 1, 1),)
    assert solver.active_tier(big) == "two"
    rng = np.random.default_rng(6)
    datas, quants, samps = _synth(rng, [(2, 2, 1, 1)])
    _, _, carry = solver.solve_steps(datas, quants, samps, 0.3, [0.001], 4,
                                     nsteps=2, device="cpu", tier="mega")
    assert isinstance(carry[2], tuple)
    with pytest.raises(ValueError, match="cannot resume"):
        solver.solve_steps(datas, quants, samps, 0.3, [0.001], 4,
                           carry=carry, nsteps=2, device="cpu", tier="two")


def test_torch_carry_from_jax_mega_carry(interpret_pallas):
    """The JAX package's mega tier runs 3 of 5 iterations (Pallas in
    interpret mode); the port resumes its carry for the last 2.  The
    resumed rows 0-1 agree with the JAX run's rows 3-4 (rtol 1e-4; the
    distance column rtol 2e-3), and
    the same carry converted for the two-kernel tier gives the same rows
    there."""
    rng = np.random.default_rng(8)
    datas, quants, samps = _synth(
        rng, [(16, 16, 1, 1), (8, 8, 2, 2), (8, 8, 2, 2)])
    weight, pweights = 0.3, [0.001] * 3
    geoms = tuple(jsolver.ChannelGeometry(d.shape[0], d.shape[1], sy, sx)
                  for d, (sy, sx) in zip(datas, samps))
    assert jsolver.active_tier(geoms, True) == "mega"
    impl = jsolver._build_solver_impl(geoms, weight, tuple(pweights), 5,
                                      True, "float32", True)
    dj = [jnp.asarray(d) for d in datas]
    qj = [jnp.asarray(q) for q in quants]
    _, _, c3 = impl(dj, qj, None, 3)
    _, m5, _ = impl(dj, qj, None, 5)
    jcarry = (tuple(np.asarray(x) for x in c3[0]),
              tuple(np.asarray(x) for x in c3[1]),
              tuple(np.asarray(x) for x in c3[2]), float(c3[3]), float(c3[4]))
    for tier in ("mega", "two"):
        carry = solver.carry_from_numpy(jcarry, datas, quants, samps, weight,
                                        pweights, device="cpu", tier=tier)
        _, m_t, _ = solver.solve_steps(datas, quants, samps, weight,
                                       pweights, 5, carry=carry, nsteps=2,
                                       device="cpu", tier=tier)
        m_j = np.asarray(m5)[3:5]
        for col in (0, 2, 3):
            np.testing.assert_allclose(m_t[:2, col], m_j[:, col], rtol=1e-4)
        # row 1's distance comes from one projection in each package: the
        # JAX kernel's distance tolerance (tests/test_pallas_kernel.py:240)
        np.testing.assert_allclose(m_t[:2, 1], m_j[:, 1], rtol=2e-3)


def test_torch_mega_tier_region_gap_boxes_are_free():
    """A region-gap channel's canvas coefficients carry the FREE quant
    sentinel and zero data in the mega tier's inputs."""
    rng = np.random.default_rng(9)
    datas, quants, samps = _synth(
        rng, [(3, 5, 1, 1), (2, 3, 2, 2), (2, 3, 2, 2)])
    prob = solver._build_problem(datas, quants, samps, 0.3, [0.001] * 3, 5,
                                 True, torch.device("cpu"))
    q, d = prob.qs_c[0], prob.dats_c[0]
    assert q.shape == (32, 48) and d.dtype == torch.int16
    assert (q[24:] == FREE_Q).all() and (d[24:] == 0).all()
    assert (q[:, 40:] == FREE_Q).all() and (d[:, 40:] == 0).all()
    assert (q[:24, :40] < FREE_Q).all()


class _CudaLooking(torch.Tensor):
    @property
    def device(self):
        return torch.device("cuda", 0)


class _PlainCalled(Exception):
    pass


def test_torch_fused_solve_never_runs_plain_on_cuda_tensors(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")

    def plain_called(*a, **k):
        raise _PlainCalled("plain version called for a CUDA tensor")

    monkeypatch.setattr(iter_step, "fused_solve_plain", plain_called)
    f = torch.Tensor._make_subclass(_CudaLooking, torch.zeros((1, 16, 32)))
    q = torch.Tensor._make_subclass(_CudaLooking, torch.zeros((16, 32)))
    before = iter_step.fused_solve.launches
    with pytest.raises(Exception) as e:
        iter_step.fused_solve(f, f, [q], np.float32([0.0]), 1.0,
                              [q.to(torch.int16)], [q], [0.36], [(1, 1)],
                              0.3)
    assert not isinstance(e.value, _PlainCalled)
    assert iter_step.fused_solve.launches == before


S420 = [(1, 1), (2, 2), (2, 2)]


@pytest.mark.parametrize("B,samps,prob,weight,H,W,exts,nsteps", [
    (1, S420, [True] * 3, 0.3, 64, 96, None, 1),
    (1, [(1, 1), (1, 4), (1, 4)], [True, False, True], 0.5, 48, 128, None, 2),
    (2, S420, [True] * 3, 0.3, 128, 128, [(96, 112), (128, 80)], 3),
    (1, [(1, 1)], [True], 0.0, 40, 56, None, 2),
    # where the kernel's cells have edges: narrower than a cell, a ragged
    # last strip, W = 512, extents on and past cell boundaries, 8 images,
    # C = 4, 4:4:0, 4:1:1 with the luma prob term off
    (1, S420, [True] * 3, 0.3, 80, 48, None, 3),
    (1, S420, [True] * 3, 0.3, 48, 336, None, 3),
    (1, S420, [True] * 3, 0.3, 64, 512, None, 3),
    (2, S420, [True] * 3, 0.3, 192, 256, [(32, 256), (48, 224)], 3),
    (8, S420, [True] * 3, 0.3, 64, 128,
     [(16 + 16 * (b % 2), 32 + 16 * (b % 6)) for b in range(8)], 3),
    (1, [(1, 1)] * 4, [True, False, True, False], 0.3, 64, 136, None, 3),
    (1, [(1, 1), (2, 1), (2, 1)], [True] * 3, 0.3, 96, 160, None, 3),
    (1, [(1, 1), (1, 4), (1, 4)], [False, True, True], 0.0, 48, 256, None, 3),
])
def test_torch_cuda_fused_solve_matches_plain(cuda_device, B, samps, prob,
                                              weight, H, W, exts, nsteps):
    """K3 on the card against its plain version, per iteration run:
    f and fista within 1e-5 of their magnitude (the transforms sum in
    another order), devq within 2e-6 of the coefficients' magnitude,
    every row's sumsq/tv/tv2 rtol 1e-5 and distances rtol 1e-4, bucket
    padding exactly 0, also where the kernel's cells have edges."""
    rng = np.random.default_rng(10)
    probs = [_problem(rng, H, W, samps, prob, None if exts is None
                      else exts[b]) for b in range(B)]
    P = sum(prob)

    def dev(x):
        return torch.as_tensor(x, device=cuda_device)
    args = (dev(np.stack([p[0] for p in probs])),
            dev(np.stack([p[1] for p in probs])),
            [dev(np.stack([p[2][k] for p in probs])) for k in range(P)],
            np.linspace(0, 0.5, nsteps).astype(np.float32),
            dev(np.float32([3.0 + b for b in range(B)])),
            [dev(np.stack([p[3][c] for p in probs])) for c in range(len(samps))],
            [dev(np.stack([p[4][c] for p in probs])) for c in range(len(samps))],
            probs[0][5], samps, weight)
    ext = dev(np.int32(exts if exts else [(H, W)] * B))
    before = iter_step.fused_solve.launches
    got = iter_step.fused_solve(*args, extents=ext)
    ref = iter_step.fused_solve_plain(*args, extents=ext)
    assert iter_step.fused_solve.launches == before + 1
    tol = 1e-5 * nsteps * float(ref[0].abs().max())
    torch.testing.assert_close(got[0], ref[0], rtol=0, atol=tol)
    torch.testing.assert_close(got[1], ref[1], rtol=0, atol=tol)
    coef_mag = max(float(np.abs(p[3][c].astype(np.float32) * p[4][c]).max()
                         + p[4][c].max()) for p in probs
                   for c in range(len(samps)))
    for a, b in zip(got[2], ref[2]):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=2e-6 * nsteps * coef_mag)
    C = len(samps)
    torch.testing.assert_close(got[3][..., :C + 2], ref[3][..., :C + 2],
                               rtol=1e-5 * nsteps, atol=0)
    # the distances: clamp - dq cancels values up to |data| * q
    torch.testing.assert_close(got[3][..., C + 2:], ref[3][..., C + 2:],
                               rtol=1e-4 * nsteps, atol=0)
    if exts:
        for b, (h, w) in enumerate(exts):
            for t in (got[0][b], got[1][b]):
                assert not t[:, h:].any() and not t[:, :, w:].any()


# ------------------------------------------------- K3's cells and scratch

def _occupancy(nbytes):
    """Blocks per SM with `nbytes` of dynamic shared memory, at most 3 (the
    kernel's register cap), 227 KB an SM and 1 KB each for the runtime."""
    return min(3, 232448 // (nbytes + 1024))


PLAN_CASES = [
    # photo512: the projection's band (tiles of 12 bytes a pixel, 3 x 16 x
    # 128 pixels: 73728 bytes) outgrows the rings; 4 strips, 396
    # slots -> 99 segments wanted, so 16-row cells (128 of them); a cell's
    # scratch 24576 + 12288 bytes lets 2 blocks an SM, 264 >= 128: resident
    ((1, 3, 512, 512, S420, [True] * 3, False, 42336, 132),
     dict(G=128, k=1, rows=16, resident=True, scratch_bytes=0, cells=128,
          phase_bytes=73728, cell_bytes=36864)),
    # the 1.23 MP sweep image: 10 strips, 39 segments wanted -> ceil(960 /
    # 39) = 25 -> 32 rows, 300 cells of 73728 bytes: one block an SM then,
    # so the scratch is global
    ((1, 3, 960, 1280, S420, [True] * 3, False, 42336, 132),
     dict(G=300, k=1, rows=32, resident=False, scratch_bytes=300 * 73728,
          cells=300, phase_bytes=73728, cell_bytes=73728)),
    # the dyn 1024x1280 chunk in lite mode: 9 segments wanted -> 114 -> 128
    # rows; 196608-byte cells exceed a block's shared memory with the band
    ((4, 3, 1024, 1280, S420, [True] * 3, True, 38000, 132),
     dict(G=320, k=1, rows=128, resident=False, scratch_bytes=320 * 196608,
          cells=320, phase_bytes=73728, cell_bytes=196608)),
    # more cells than slots (one SM): 4 cells of 64 rows over 3 slots, two
    # a block
    ((1, 3, 64, 512, S420, [True] * 3, False, 42336, 1),
     dict(G=2, k=2, rows=64, resident=False, scratch_bytes=2 * 2 * 147456,
          cells=4, phase_bytes=73728, cell_bytes=147456)),
    # one channel, 8-row blocks: cells of at least 16 rows (16, 16, 8); the
    # rings outgrow the 8-row band (12288 bytes)
    ((1, 1, 40, 56, [(1, 1)], [True], False, 15000, 132),
     dict(G=3, k=1, rows=16, resident=True, scratch_bytes=0, cells=3,
          phase_bytes=15000, cell_bytes=16384)),
    # 4:1:1 with one prob channel off: the rings outgrow the 8-row band
    # (36864 bytes); windows of the two prob channels only (2048 + 512
    # floats)
    ((1, 3, 48, 256, [(1, 1), (1, 4), (1, 4)], [True, False, True], False,
      42336, 132),
     dict(G=6, k=1, rows=16, resident=True, scratch_bytes=0, cells=6,
          phase_bytes=42336, cell_bytes=34816)),
]


@pytest.mark.parametrize("args,want", PLAN_CASES)
def test_torch_k3_plan_mirror(args, want):
    """kernels/iter_step.py::plan, the CPU mirror of csrc/iter_step.cu
    make_plan, against decompositions counted by hand: cells of 128
    columns, rows a multiple of 8 * max(sy) and at least 16 sized so that
    the cells are about one wave of co-resident blocks, the scratch in
    shared memory when every cell's block still fits co-resident with it."""
    B, C, H, W, samps, prob, lite, ring, sms = args
    assert iter_step.plan(B, C, H, W, samps, prob, lite, ring, _occupancy,
                          sms) == want


class _FakeSolveLib:
    """The plan entry point of the K3 library, answering `vals` (PLAN_KEYS
    order) or the CUDA error `err`, and its error string."""

    def __init__(self, vals, err=0):
        self.asked = []

        def plan(B, C, H, W, ints, tgv, lite, out):
            self.asked.append((B, C, H, W, list(ints[:3 * C]), tgv, lite))
            for i, v in enumerate(vals):
                out[i] = v
            return err
        self.j2p_fused_solve_plan = plan

        def error_string(err):
            return b"invalid argument"
        self.j2p_error_string = error_string


def test_torch_k3_scratch_is_what_the_library_plans():
    """K3's wrapper takes the grid and the scratch from the library's plan
    (j2p_fused_solve_plan, which knows the card's occupancy): the blocks'
    global scratch of the planned bytes (none when resident), the gradient
    sums [B, G, C + 2] and the two iterations' distance sums [2, B, G,
    max(P, 1)]; the library's error raises."""
    lib = _FakeSolveLib([5, 2, 32, 0, 1000, 9, 42336, 100])
    pl = iter_step.launch_plan(2, 3, 96, 256, S420, [True, False, True],
                               0.3, True, lib)
    assert pl == dict(G=5, k=2, rows=32, resident=False, scratch_bytes=1000,
                      cells=9, phase_bytes=42336, cell_bytes=100)
    assert lib.asked == [(2, 3, 96, 256, [1, 1, 0, 2, 2, -1, 2, 2, 1], 1, 1)]
    scratch, gpart, dpart = iter_step.launch_buffers(pl, 2, 3, 2, "cpu")
    assert scratch.shape == (1000,) and scratch.dtype == torch.uint8
    assert gpart.shape == (2, 5, 5) and dpart.shape == (2, 2, 5, 2)
    res = iter_step.launch_plan(1, 1, 40, 56, [(1, 1)], [False], 0.0, False,
                                _FakeSolveLib([3, 1, 16, 1, 0, 3, 15000, 8]))
    assert res["resident"] is True
    scratch, gpart, dpart = iter_step.launch_buffers(res, 1, 1, 0, "cpu")
    assert scratch is None and gpart.shape == (1, 3, 3)
    assert dpart.shape == (2, 1, 3, 1)
    with pytest.raises(RuntimeError, match="invalid argument"):
        iter_step.launch_plan(1, 3, 64, 64, S420, [True] * 3, 0.3, False,
                              _FakeSolveLib([0] * 8, err=1))


def test_torch_cuda_k3_plan_mirror_matches_library(cuda_device):
    """The mirror against the library on the card, with the library's ring
    bytes and occupancy: the same decomposition for photo512, the sweep
    image, the serving chunk, 3072x2048, an 8-image bucket, C = 4."""
    for B, C, H, W, samps, prob, lite in (
            (1, 3, 512, 512, S420, [True] * 3, False),
            (1, 3, 960, 1280, S420, [True] * 3, True),
            (4, 3, 1024, 1280, S420, [True] * 3, False),
            (1, 3, 2048, 3072, S420, [True] * 3, True),
            (8, 3, 192, 256, S420, [True] * 3, False),
            (1, 4, 64, 136, [(1, 1)] * 4, [True, False, True, False],
             False)):
        want = iter_step.plan(B, C, H, W, samps, prob, lite,
                              *iter_step.library_plan_inputs(C, 0.3, lite))
        assert iter_step.launch_plan(B, C, H, W, samps, prob, 0.3,
                                     lite) == want
