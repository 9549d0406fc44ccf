"""The port's kernels: their plain PyTorch versions against the JAX
package's Pallas kernels (interpret mode, on the CPU), and the CUDA
kernels against the plain versions on a card (skipped without one)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from jpeg2png_tpu.kernels import grad_step as jgrad  # noqa: E402
from jpeg2png_tpu.kernels import project_step as jproj  # noqa: E402
from jpeg2png_tpu_torch.kernels import grad_step, project_step  # noqa: E402

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


def _k1_inputs(rng, C, H, W, with_prob):
    fs = rng.normal(0, 50, (C, H, W)).astype(np.float32)
    fis = rng.normal(0, 50, (C, H, W)).astype(np.float32)
    pgs = [rng.normal(0, 1, (H, W)).astype(np.float32) if p else None
           for p in with_prob]
    return fs, fis, pgs


def _torch_pgs(pgs, device="cpu"):
    return [None if p is None else torch.as_tensor(p, device=device)
            for p in pgs]


@pytest.mark.parametrize("C,H,W,weight,with_prob,h_true,w_true", [
    (3, 96, 128, 0.3, [True] * 3, None, None),      # all terms
    (3, 96, 128, 0.0, [False] * 3, None, None),     # TV only, no prob
    (1, 104, 256, 0.3, [True], None, None),         # single channel
    (3, 96, 128, 0.3, [True, False, True], 90, 121),  # padded canvas masks
])
def test_torch_plain_fused_grad_matches_pallas(interpret_pallas, C, H, W,
                                               weight, with_prob, h_true,
                                               w_true):
    rng = np.random.default_rng(0)
    fs, fis, pgs = _k1_inputs(rng, C, H, W, with_prob)
    ref = jgrad.fused_grad(
        [jnp.asarray(f) for f in fs], [jnp.asarray(f) for f in fis],
        [None if p is None else jnp.asarray(p) for p in pgs],
        jnp.float32(0.37), weight, h_true=h_true, w_true=w_true)
    got = grad_step.fused_grad(torch.as_tensor(fs), torch.as_tensor(fis),
                               _torch_pgs(pgs), 0.37, weight, h_true, w_true)
    # tolerances of tests/test_pallas_kernel.py:60-68
    np.testing.assert_allclose(got[0].numpy(),
                               np.stack([np.asarray(g) for g in ref[0]]),
                               atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(),
                               np.stack([np.asarray(e) for e in ref[1]]),
                               atol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), rtol=1e-5)
    assert abs(float(got[3]) - float(ref[3])) / float(ref[3]) < 1e-5
    if weight != 0.0:
        assert abs(float(got[4]) - float(ref[4])) / float(ref[4]) < 1e-5
    else:
        assert float(got[4]) == 0.0


def _k2_inputs(rng, H, W, samps, prob):
    es, gs, los, his, dqs, iqs, pa_ss = [], [], [], [], [], [], []
    for c, (sy, sx) in enumerate(samps):
        hc, wc = H // sy, W // sx
        es.append(rng.normal(0, 50, (H, W)).astype(np.float32))
        gs.append(rng.normal(0, 1, (H, W)).astype(np.float32))
        q = np.tile(rng.integers(1, 60, (8, 8)).astype(np.float32),
                    (hc // 8, wc // 8))
        dq = np.round(rng.normal(0, 5, (hc, wc))).astype(np.float32) * q
        los.append(dq - 0.5 * q)
        his.append(dq + 0.5 * q)
        dqs.append(dq if prob[c] else None)
        iqs.append(1.0 / q if prob[c] else None)
        pa_ss.append(0.36 * sy * sx if prob[c] else 0.0)
    scales = rng.uniform(0.01, 0.05, (len(samps),)).astype(np.float32)
    return es, gs, scales, los, his, dqs, iqs, pa_ss


def _to(xs, conv):
    return [None if x is None else conv(x) for x in xs]


@pytest.mark.parametrize("samps,prob", [
    ([(1, 1), (2, 2), (2, 2)], [True, True, True]),      # 4:2:0
    ([(1, 1)] * 3, [True, False, True]),                 # mixed prob
    ([(1, 1), (2, 2), (2, 2)], [False, False, False]),   # prob off
    ([(1, 1), (1, 2), (1, 2)], [True, True, True]),      # 4:2:2
])
def test_torch_plain_fused_project_multi_matches_pallas(interpret_pallas,
                                                        samps, prob):
    from jpeg2png_tpu.ops.dct_raster import sampled_dct, sampled_idct_up

    rng = np.random.default_rng(5)
    H, W = 64, 256
    es, gs, scales, los, his, dqs, iqs, pa_ss = _k2_inputs(
        rng, H, W, samps, prob)
    ref = jproj.fused_project_multi(
        _to(es, jnp.asarray), _to(gs, jnp.asarray), jnp.asarray(scales),
        _to(los, jnp.asarray), _to(his, jnp.asarray), _to(dqs, jnp.asarray),
        _to(iqs, jnp.asarray), pa_ss, samps)
    got = project_step.fused_project_multi(
        torch.as_tensor(np.stack(es)), torch.as_tensor(np.stack(gs)),
        torch.as_tensor(scales), _to(los, torch.as_tensor),
        _to(his, torch.as_tensor), _to(dqs, torch.as_tensor),
        _to(iqs, torch.as_tensor), pa_ss, samps)
    for c, (sy, sx) in enumerate(samps):
        # tolerances of tests/test_pallas_kernel.py:149-167: the Pallas
        # kernel's forward DCT is bf16x3 and its backward transform of
        # the clamp correction single-pass bf16, so the gate scales with
        # the correction magnitude
        fmid = jnp.asarray(es[c]) - scales[c] * jnp.asarray(gs[c])
        coefs = sampled_dct(fmid, sy, sx)
        cl = jnp.clip(coefs, los[c], his[c])
        corr = float(jnp.max(jnp.abs(cl - coefs)))
        np.testing.assert_allclose(got[0][c].numpy(), np.asarray(ref[0][c]),
                                   atol=2e-2 + corr * 2.0 ** -7)
        if not prob[c]:
            assert got[1][c] is None and float(got[2][c]) == 0.0
            continue
        np.testing.assert_allclose(float(got[2][c]), float(ref[2][c]),
                                   rtol=1e-4)
        devp = (cl - dqs[c]) * iqs[c]
        corr_pg = float(jnp.max(jnp.abs(devp * iqs[c])))
        np.testing.assert_allclose(
            got[1][c].numpy(), np.asarray(ref[1][c]),
            atol=1e-4 + pa_ss[c] * corr_pg * 2.0 ** -6)
        # and the f32 ops algebra the Pallas kernel approximates
        pgref = pa_ss[c] * sampled_idct_up(devp * iqs[c], sy, sx)
        np.testing.assert_allclose(got[1][c].numpy(), np.asarray(pgref),
                                   atol=1e-5)


def test_torch_plain_project_region_gap_is_unconstrained():
    """A region gap (lo = -2^39, hi = +2^39, dq = iq = 0) leaves the step
    result in place and adds no prob gradient or distance."""
    rng = np.random.default_rng(6)
    H, W = 32, 48
    e = torch.as_tensor(rng.normal(0, 50, (1, H, W)).astype(np.float32))
    g = torch.zeros_like(e)
    lo = torch.full((H, W), -project_step.GAP_BOX)
    hi = torch.full((H, W), project_step.GAP_BOX)
    z = torch.zeros((H, W))
    fnew, pgs, dists = project_step.fused_project_multi(
        e, g, torch.ones(1), [lo], [hi], [z], [z], [0.36], [(1, 1)])
    np.testing.assert_allclose(fnew.numpy(), e.numpy(), atol=1e-3)
    assert not pgs[0].any() and float(dists[0]) == 0.0


@pytest.mark.parametrize("C,H,W,weight,prob,h_true", [
    (3, 2048, 3072, 0.3, [True] * 3, None),
    (3, 72, 104, 0.3, [True, False, True], 67),
    (1, 40, 56, 0.0, [False], None),
])
def test_torch_cuda_fused_grad_matches_plain(cuda_device, C, H, W, weight,
                                             prob, h_true):
    rng = np.random.default_rng(1)
    fs, fis, pgs = _k1_inputs(rng, C, H, W, prob)
    args = (torch.as_tensor(fs, device=cuda_device),
            torch.as_tensor(fis, device=cuda_device),
            _torch_pgs(pgs, cuda_device), 0.37, weight, h_true, None)
    before = grad_step.fused_grad.launches
    got = grad_step.fused_grad(*args)
    ref = grad_step.fused_grad_plain(*args)
    assert grad_step.fused_grad.launches == before + 1
    torch.testing.assert_close(got[0], ref[0], rtol=0, atol=1e-5 * max(
        1.0, float(ref[0].abs().max())))
    torch.testing.assert_close(got[1], ref[1], rtol=0, atol=0)
    for a, b in zip(got[2:], ref[2:]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=0)


@pytest.mark.parametrize("samps,prob", [
    ([(1, 1), (2, 2), (2, 2)], [True] * 3),
    ([(1, 1), (2, 1), (2, 1)], [True, False, True]),
    ([(1, 1), (1, 4), (1, 4)], [False] * 3),
])
def test_torch_cuda_fused_project_multi_matches_plain(cuda_device, samps,
                                                      prob):
    rng = np.random.default_rng(2)
    H, W = 64, 256
    es, gs, scales, los, his, dqs, iqs, pa_ss = _k2_inputs(
        rng, H, W, samps, prob)

    def dev(x):
        return torch.as_tensor(x, device=cuda_device)
    args = (dev(np.stack(es)), dev(np.stack(gs)), dev(scales),
            _to(los, dev), _to(his, dev), _to(dqs, dev), _to(iqs, dev),
            pa_ss, samps)
    got = project_step.fused_project_multi(*args)
    ref = project_step.fused_project_multi_plain(*args)
    torch.testing.assert_close(got[0], ref[0], rtol=0,
                               atol=1e-5 * float(ref[0].abs().max()))
    torch.testing.assert_close(got[2], ref[2], rtol=1e-5, atol=0)
    for a, b in zip(got[1], ref[1]):
        assert (a is None) == (b is None)
        if a is not None:
            torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * max(
                1e-3, float(b.abs().max())))


# ------------------------------------------------- K1's grid and scratch

@pytest.mark.parametrize("L,W,slots,rows", [
    # 3072 / 254 -> 13 strips (12 x 254 + 24); 264 // 13 = 20 segments
    # wanted, so ceil(2048 / 20) = 103 rows each: 20 segments (19 x 103 +
    # 91)
    (2048, 3072, 264, 13 * 20),
    # 12288 / 254 -> 49 strips (48 x 254 + 96); 264 // 49 = 5: 410 rows
    # each, 5 segments (4 x 410 + 408)
    (2048, 12288, 264, 49 * 5),
    # 2 strips (254 + 46); 16-row segments: 7 (6 x 16 + 4)
    (100, 300, 264, 2 * 7),
    # 2 strips of exactly 254; 4 // 2 = 2 segments of 20 rows
    (40, 508, 4, 2 * 2),
    (8, 8, 264, 1),             # one strip, one segment shorter than 16 rows
    (8, 3072, 264, 13),         # one segment per strip
    (64, 96, 1, 1),             # one resident block: the band in one segment
])
def test_torch_grad_partial_rows_mirror(L, W, slots, rows):
    """kernels/grad_step.py::partial_rows, the CPU mirror of
    csrc/grad_step.cu make_grid, against grids counted by hand: strips of
    254 columns, segments of at least 16 rows sized so that the grid is
    about one wave of `slots` resident blocks."""
    assert grad_step.partial_rows(L, W, slots) == rows


def test_torch_cuda_grad_partial_rows_mirror_matches_library(cuda_device):
    """The mirror against the library on the card: one strip of 2^24 rows
    splits into as many segments as blocks are resident (slots), and
    every grid of the hand-counted cases then has the library's rows."""
    lib, _ = grad_step._launcher()
    slots = lib.j2p_grad_partial_rows(3, 1, 1 << 24, 8)
    for L, W in ((2048, 3072), (2048, 12288), (100, 300), (8, 8)):
        assert lib.j2p_grad_partial_rows(3, 1, L, W) == \
            grad_step.partial_rows(L, W, slots)


class _FakeGradLib:
    """The two row-count entry points of the gradient library, answering
    `rows` (or a negative CUDA error), and its error string."""

    def __init__(self, rows):
        self.asked = []

        def count(C, tgv, L, W):
            self.asked.append((C, tgv, L, W))
            return rows
        self.j2p_grad_partial_rows = count

        def error_string(err):
            return b"invalid argument"
        self.j2p_error_string = error_string


def test_torch_grad_scratch_is_what_the_library_reports():
    """K1's wrapper sizes its partial-sum scratch from the library's
    j2p_grad_partial_rows for the band (no tile constants in Python), and
    raises on the library's error."""
    lib = _FakeGradLib(37)
    part = grad_step.scratch(lib, 3, True, 2048, 3072, "cpu")
    assert part.shape == (37, 5) and part.dtype == torch.float32
    assert lib.asked == [(3, 1, 2048, 3072)]
    assert grad_step.scratch(_FakeGradLib(1), 1, False, 8, 8, "cpu").shape \
        == (1, 3)
    with pytest.raises(RuntimeError, match="invalid argument"):
        grad_step.scratch(_FakeGradLib(-1), 3, True, 8, 8, "cpu")


# edges of the row-marching grid: C, H, W, weight, prob, h_true, w_true;
# "seg" / "seg+1" put h_true - 1 on the last / first row of a segment
K1_EDGE_CASES = [
    (3, 8, 64, 0.3, [True] * 3, None, None),        # shorter than a segment
    (3, 16, 128, 0.3, [True, False, True], None, None),   # one segment
    (2, 40, 8, 0.3, [True, False], None, None),     # 8 columns
    (3, 104, 328, 0.3, [True] * 3, 99, 325),        # L, W off the grid
    (4, 72, 264, 0.3, [True] * 4, 70, None),        # C = 4, 2 strips
    (3, 64, 96, 0.3, [True] * 3, 5, None),          # extent in segment 1
    (3, 64, 96, 0.3, [True] * 3, "seg", None),
    (3, 64, 96, 0.3, [False] * 3, "seg+1", None),
]


@pytest.mark.parametrize("C,H,W,weight,prob,h_true,w_true", K1_EDGE_CASES)
def test_torch_cuda_fused_grad_grid_edges(cuda_device, C, H, W, weight, prob,
                                          h_true, w_true):
    """K1 against its plain version where the row-marching grid has edges
    (chip_smoke.py's k1_edge_cases): K1's gates, the gradient within 1e-5
    of its magnitude, extrap exact, the sums rtol 1e-5."""
    if isinstance(h_true, str):
        seg = grad_step.segment_rows(C, weight != 0.0, H, W)
        assert seg < H
        h_true = seg + (1 if h_true == "seg+1" else 0)
    rng = np.random.default_rng(3)
    fs, fis, pgs = _k1_inputs(rng, C, H, W, prob)
    args = (torch.as_tensor(fs, device=cuda_device),
            torch.as_tensor(fis, device=cuda_device),
            _torch_pgs(pgs, cuda_device), 0.37, weight, h_true, w_true)
    got = grad_step.fused_grad(*args)
    ref = grad_step.fused_grad_plain(*args)
    torch.testing.assert_close(got[0], ref[0], rtol=0, atol=1e-5 * max(
        1.0, float(ref[0].abs().max())))
    torch.testing.assert_close(got[1], ref[1], rtol=0, atol=0)
    for a, b in zip(got[2:], ref[2:]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=0)
