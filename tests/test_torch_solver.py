"""The port's solver on the CPU against the JAX package's XLA solver and
the float64 scatter oracle, the carry handover from JAX, and chunked
solves."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import oracle  # noqa: E402
from jpeg2png_tpu.models import solver as jsolver  # noqa: E402
from jpeg2png_tpu_torch.kernels import iter_step  # noqa: E402
from jpeg2png_tpu_torch.models import solver  # noqa: E402

torch.set_num_threads(2)

LAYOUTS = [
    # single channel, no subsampling, all terms
    ([(2, 3, 1, 1)], 0.3, [0.001]),
    # TV only
    ([(2, 2, 1, 1)], 0.0, [0.0]),
    # 3 channels 4:2:0-style
    ([(4, 4, 1, 1), (2, 2, 2, 2), (2, 2, 2, 2)], 0.3, [0.001] * 3),
    # ragged canvas: luma region smaller than chroma region
    ([(2, 3, 1, 1), (1, 2, 2, 2), (1, 2, 2, 2)], 0.3, [0.001] * 3),
    # 4:1:1 and 4:4:0 footprints, mixed prob
    ([(4, 8, 1, 1), (4, 2, 1, 4), (4, 2, 1, 4)], 0.3, [0.001, 0.0, 0.002]),
    ([(4, 3, 1, 1), (2, 3, 2, 1), (2, 3, 2, 1)], 0.5, [0.001] * 3),
]


def synth_channels(rng, layout):
    """layout: list of (nby, nbx, sy, sx)."""
    datas, quants, samps = [], [], []
    for nby, nbx, sy, sx in layout:
        datas.append(rng.integers(-25, 25, (nby, nbx, 8, 8)).astype(np.int16))
        quants.append(rng.integers(1, 80, (8, 8)).astype(np.uint16))
        samps.append((sy, sx))
    return datas, quants, samps


def assert_rows_close(ours, ref):
    """Metric rows: rtol 1e-4.  The prob distance column also gets atol
    1e-4: it sums ((clamp - dq) / q)^2 where clamp and dq are f32 values
    up to |data| * q ~ 2e3, so a DCT rounded in another order moves each
    term by ~1e-4 / q even where the sum itself is small."""
    ours, ref = np.asarray(ours), np.asarray(ref)
    for col in (0, 2, 3):
        np.testing.assert_allclose(ours[:, col], ref[:, col], rtol=1e-4)
    np.testing.assert_allclose(ours[:, 1], ref[:, 1], rtol=1e-4, atol=1e-4)


def psnr(a, b):
    mse = ((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2).mean()
    return np.inf if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


@pytest.mark.parametrize("layout,weight,pweights", LAYOUTS)
def test_torch_solver_matches_jax(layout, weight, pweights):
    rng = np.random.default_rng(11)
    datas, quants, samps = synth_channels(rng, layout)
    f_t, m_t = solver.solve_joint(datas, quants, samps, weight, pweights, 5,
                                  device="cpu")
    f_j, m_j = jsolver.solve_joint(datas, quants, samps, weight, pweights, 5,
                                   use_pallas=False)
    assert_rows_close(m_t[:2], np.asarray(m_j)[:2])
    assert psnr(f_t.numpy(), np.asarray(f_j)) > 45.0


@pytest.mark.parametrize("layout,weight,pweights", LAYOUTS[:4])
def test_torch_solver_matches_oracle(layout, weight, pweights):
    rng = np.random.default_rng(11)
    datas, quants, samps = synth_channels(rng, layout)
    fdata, metrics = solver.solve_joint(datas, quants, samps, weight,
                                        pweights, 4, device="cpu")
    fdata_o, metrics_o = oracle.solve(
        [d.astype(np.float64) for d in datas],
        [q.astype(np.float64) for q in quants],
        samps, weight, pweights, 4,
    )
    np.testing.assert_allclose(fdata.numpy(), fdata_o, atol=2e-2)
    np.testing.assert_allclose(metrics, metrics_o, rtol=2e-4, atol=1e-3)


def test_torch_solver_matches_jax_on_fixture(fixtures_dir):
    from jpeg2png_tpu_torch.io import read_jpeg

    img = read_jpeg(fixtures_dir / "photo80_q30_422.jpg")
    args = ([p.data for p in img.planes], [p.quant for p in img.planes],
            [(p.h_samp, p.w_samp) for p in img.planes], 0.3, [0.001] * 3, 5)
    f_t, m_t = solver.solve_joint(*args, device="cpu")
    f_j, m_j = jsolver.solve_joint(*args, use_pallas=False)
    assert_rows_close(m_t[:2], np.asarray(m_j)[:2])
    assert psnr(f_t.numpy(), np.asarray(f_j)) > 45.0


@pytest.mark.parametrize("layout,weight,pweights", [LAYOUTS[2], LAYOUTS[3]])
def test_torch_carry_handover_from_jax(layout, weight, pweights):
    """JAX runs 3 of 5 iterations, the port runs the last 2 from the
    converted carry: compared with JAX running all 5."""
    rng = np.random.default_rng(12)
    datas, quants, samps = synth_channels(rng, layout)
    geoms = tuple(jsolver.ChannelGeometry(d.shape[0], d.shape[1], sy, sx)
                  for d, (sy, sx) in zip(datas, samps))
    impl = jsolver._build_solver_impl(geoms, weight, tuple(pweights), 5,
                                      True, "float32", False)
    dj = [jnp.asarray(d) for d in datas]
    qj = [jnp.asarray(q) for q in quants]
    _, m3, c3 = impl(dj, qj, None, 3)
    f5, m5, _ = impl(dj, qj, None, 5)
    carry = solver.carry_from_numpy(
        (np.asarray(c3[0]), np.asarray(c3[1]),
         tuple(np.asarray(c) for c in c3[2]), float(c3[3])),
        datas, quants, samps, weight, pweights, device="cpu")
    f_t, m_t, _ = solver.solve_steps(datas, quants, samps, weight, pweights,
                                     5, carry=carry, nsteps=2, device="cpu")
    assert_rows_close(m_t[:1], np.asarray(m5)[3:4])
    assert psnr(f_t.numpy(), np.asarray(f5)) > 45.0


def test_torch_chunked_equals_one_shot():
    rng = np.random.default_rng(5)
    datas, quants, samps = synth_channels(
        rng, [(4, 4, 1, 1), (2, 2, 2, 2), (2, 2, 2, 2)])
    seen = []
    fd_c, m_c = solver.solve_joint_chunked(
        datas, quants, samps, 0.3, [0.001] * 3, 10, chunk=4,
        on_chunk=lambda done, m: seen.append((done, m.shape[0])),
        device="cpu")
    fd_1, m_1 = solver.solve_joint(datas, quants, samps, 0.3, [0.001] * 3,
                                   10, device="cpu")
    assert seen == [(4, 4), (8, 4), (10, 2)]
    np.testing.assert_array_equal(m_c, m_1)
    np.testing.assert_array_equal(fd_c.numpy(), fd_1.numpy())
    # and resuming by hand through solve_steps gives the same run
    f_a, m_a, carry = solver.solve_steps(datas, quants, samps, 0.3,
                                         [0.001] * 3, 10, nsteps=6,
                                         device="cpu")
    f_b, m_b, _ = solver.solve_steps(datas, quants, samps, 0.3, [0.001] * 3,
                                     10, carry=carry, nsteps=4, device="cpu")
    np.testing.assert_array_equal(np.concatenate([m_a, m_b]), m_1)
    np.testing.assert_array_equal(f_b.numpy(), fd_1.numpy())


def test_torch_iteration0_prob_dist_is_zero_and_simd_logging():
    rng = np.random.default_rng(12)
    datas, quants, samps = synth_channels(rng, [(2, 2, 1, 1)])
    _, m = solver.solve_joint(datas, quants, samps, 0.3, [0.001], 3,
                              device="cpu")
    assert m[0, 1] == 0.0 and m[1, 1] > 0.0
    # scalar-C logging multiplies the distance by p_alpha (compute.c:69)
    _, m_s = solver.solve_joint(datas, quants, samps, 0.3, [0.001], 3,
                                simd_compat_logging=False, device="cpu")
    p_alpha = 0.001 * 2.0 * 255.0 * np.sqrt(2.0)
    np.testing.assert_allclose(m_s[1:, 1], p_alpha * m[1:, 1], rtol=1e-5)


def test_torch_separate_mode_matches_per_channel_joint():
    rng = np.random.default_rng(13)
    datas, quants, samps = synth_channels(
        rng, [(2, 2, 1, 1), (1, 1, 2, 2), (1, 1, 2, 2)])
    res = solver.solve_separate(datas, quants, samps, [0.3, 0.0, 0.0],
                                [0.001] * 3, [3, 2, 2], device="cpu")
    for c in range(3):
        fd, met = res[c]
        fd_j, met_j = solver.solve_joint(
            [datas[c]], [quants[c]], [samps[c]], [0.3, 0.0, 0.0][c],
            [0.001], [3, 2, 2][c], device="cpu")
        np.testing.assert_array_equal(fd.numpy(), fd_j.numpy())
        np.testing.assert_array_equal(met, met_j)


def test_torch_result_stays_feasible():
    from jpeg2png_tpu_torch.ops.dct_raster import dct_raster

    rng = np.random.default_rng(14)
    datas, quants, samps = synth_channels(rng, [(3, 3, 1, 1)])
    fdata, _ = solver.solve_joint(datas, quants, samps, 0.3, [0.001], 5,
                                  device="cpu")
    coefs = dct_raster(fdata[0]).numpy()
    q = np.tile(quants[0].astype(np.float32), (3, 3))
    data = oracle.blocks_to_raster(datas[0])
    lo = (data - 0.5) * q
    hi = (data + 0.5) * q
    viol = np.maximum(lo - coefs, coefs - hi) / q
    assert viol.max() < 1e-4, viol.max()


def test_torch_fista_factors_and_alphas_match_jax():
    f_t, t_t = iter_step.fista_factors(1.0, 7)
    f_j, t_j = jsolver._fista_factors_np(7)
    np.testing.assert_array_equal(f_t, f_j)
    assert t_t == t_j
    assert solver.objective_alphas(0.3, [0.001, 0.0, 0.002], 3) == \
        jsolver.objective_alphas(0.3, [0.001, 0.0, 0.002], 3)
    parts = np.random.default_rng(0).normal(0, 1, (4, 7)).astype(np.float32)
    for simd in (True, False):
        got = solver.mega_metrics(parts, 0.25, [0.5, 0.0, 0.7], 9.0, simd)
        ref = jsolver.mega_metrics(parts, 0.25, [0.5, 0.0, 0.7], 9.0, simd,
                                   xp=np)
        np.testing.assert_allclose(got[0], ref[0], rtol=1e-6)
        np.testing.assert_allclose(got[1], ref[1], rtol=1e-6)
