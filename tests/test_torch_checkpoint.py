"""The port's checkpoint/resume on the CPU (the kernels' plain versions):
the counterparts of tests/test_checkpoint.py over the four solver tiers
and both striped bodies, bit-exact bf16 snapshots, JAX snapshots refused,
and the port's checkpointed solve against the JAX package's."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from jpeg2png_tpu.models import checkpoint as jcheckpoint  # noqa: E402
from jpeg2png_tpu.models import solver as jsolver  # noqa: E402
from jpeg2png_tpu_torch.models import checkpoint as C  # noqa: E402
from jpeg2png_tpu_torch.models import solver  # noqa: E402
from jpeg2png_tpu_torch.parallel import stripes  # noqa: E402
from jpeg2png_tpu_torch.parallel.mesh import stripe_mesh  # noqa: E402
from test_torch_solver import assert_rows_close, psnr  # noqa: E402

torch.set_num_threads(2)

ARGS = (0.3, [0.001] * 3)


def synth(rng, luma=(4, 4), chroma=(2, 2)):
    """tests/test_checkpoint.py's inputs: 4:2:0, 32 x 32 by default."""
    datas = [rng.integers(-25, 25, luma + (8, 8)).astype(np.int16),
             rng.integers(-12, 12, chroma + (8, 8)).astype(np.int16),
             rng.integers(-12, 12, chroma + (8, 8)).astype(np.int16)]
    quants = [rng.integers(1, 60, (8, 8)).astype(np.uint16)
              for _ in range(3)]
    return datas, quants, [(1, 1), (2, 2), (2, 2)]


def tier_fingerprint(datas, samps, tier, iterations, weight=0.3,
                     pweights=(0.001,) * 3):
    return C.fingerprint(solver._geometry(datas, samps), tier, weight,
                         pweights, iterations, True)


@pytest.mark.parametrize("tier", solver.TIERS)
def test_torch_checkpoint_chunked_equals_uninterrupted(tmp_path, tier):
    datas, quants, samps = synth(np.random.default_rng(41))
    ckpt = str(tmp_path / "state.npz")
    res = C.solve_checkpointed(datas, quants, samps, *ARGS, 6, ckpt,
                               checkpoint_every=2, device="cpu", tier=tier)
    fd, m = solver.solve_joint(datas, quants, samps, *ARGS, 6, device="cpu",
                               tier=tier)
    assert res.fdata.device.type == "cpu"
    np.testing.assert_array_equal(res.fdata.numpy(), fd.numpy())
    np.testing.assert_array_equal(res.metrics, m)
    assert res.resumed_from == 0
    # completed runs clean up their snapshot
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("tier", solver.TIERS)
def test_torch_checkpoint_resume_after_partial_run(tmp_path, tier):
    """A 'crash' after 4 of 6 iterations leaves its snapshot; the resumed
    run does the last 2 and ends where the uninterrupted one does."""
    datas, quants, samps = synth(np.random.default_rng(42))
    ckpt = str(tmp_path / "state.npz")
    _, m_first, carry = solver.solve_steps(datas, quants, samps, *ARGS, 6,
                                           nsteps=4, device="cpu", tier=tier)
    C.save_state(ckpt, carry, 4, tier_fingerprint(datas, samps, tier, 6))
    res = C.solve_checkpointed(datas, quants, samps, *ARGS, 6, ckpt,
                               checkpoint_every=100, device="cpu", tier=tier)
    assert res.resumed_from == 4
    assert res.metrics.shape == (2, 4)   # only the remaining iterations
    fd, m = solver.solve_joint(datas, quants, samps, *ARGS, 6, device="cpu",
                               tier=tier)
    np.testing.assert_array_equal(res.fdata.numpy(), fd.numpy())
    np.testing.assert_array_equal(np.concatenate([m_first, res.metrics]), m)
    assert not os.path.exists(ckpt)


def test_torch_save_state_extension_exact_and_atomic(tmp_path):
    """The open-handle + os.replace write keeps the exact path (no '.npz'
    appended) and leaves no temp file; the structure (tuples, lists,
    floats, tensors of every dtype) comes back as it was."""
    ckpt = str(tmp_path / "state.ckpt")
    carry = (torch.arange(5.0), [torch.ones(2, 3), (torch.zeros(0, 4),)],
             0.125, 1.0, torch.tensor([3, -4], dtype=torch.int16))
    C.save_state(ckpt, carry, 3, "0123456789abcdef")
    assert os.path.exists(ckpt) and not os.path.exists(ckpt + ".npz")
    got, it = C.load_state(ckpt, "0123456789abcdef")
    assert it == 3
    assert isinstance(got, tuple) and isinstance(got[1], list)
    assert isinstance(got[1][1], tuple)
    assert got[2] == 0.125 and got[3] == 1.0
    for a, b in ((got[0], carry[0]), (got[1][0], carry[1][0]),
                 (got[1][1][0], carry[1][1][0]), (got[4], carry[4])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["state.ckpt"]


def test_torch_save_state_failure_leaves_no_file(tmp_path):
    """A write that fails (a leaf the format does not take) removes its
    temp file and leaves no snapshot."""
    ckpt = str(tmp_path / "state.npz")
    with pytest.raises(TypeError, match="cannot snapshot"):
        C.save_state(ckpt, (torch.zeros(2), "text"), 1, "0123456789abcdef")
    assert list(tmp_path.iterdir()) == []


def test_torch_bf16_round_trip_is_bit_exact(tmp_path):
    """bfloat16 leaves (the lite carries' d and devq) go through uint16
    bit patterns: every pattern, NaN payloads, infinities, subnormals and
    -0 included, comes back unchanged."""
    bits = torch.arange(-(1 << 15), 1 << 15, dtype=torch.int32)
    x = bits.to(torch.int16).view(torch.bfloat16).reshape(256, 256)
    ckpt = str(tmp_path / "bf16.npz")
    C.save_state(ckpt, (x, (x[:3],)), 7, "0123456789abcdef")
    (y, (z,)), it = C.load_state(ckpt, "0123456789abcdef")
    assert it == 7 and y.dtype == z.dtype == torch.bfloat16
    assert torch.equal(y.view(torch.int16), x.view(torch.int16))
    assert torch.equal(z.view(torch.int16), x[:3].view(torch.int16))


@pytest.mark.parametrize("tier", solver.TIERS)
def test_torch_foreign_checkpoint_not_deleted(tmp_path, tier):
    """resume=False with a mismatched snapshot in place: the run neither
    reads nor deletes a file it did not write or validate."""
    datas, quants, samps = synth(np.random.default_rng(45))
    ckpt = str(tmp_path / "state.npz")
    C.save_state(ckpt, (torch.zeros(3),), 1, "deadbeefdeadbeef")
    res = C.solve_checkpointed(datas, quants, samps, *ARGS, 3, ckpt,
                               checkpoint_every=100, resume=False,
                               device="cpu", tier=tier)
    assert res.resumed_from == 0
    assert os.path.exists(ckpt)   # foreign file untouched


@pytest.mark.parametrize("tier", solver.TIERS)
def test_torch_checkpoint_iterations_zero(tmp_path, tier):
    """iterations=0: solve_joint_chunked and solve_checkpointed return the
    initial decode like solve_joint, no metric rows and no snapshot."""
    datas, quants, samps = synth(np.random.default_rng(46))
    fd1, m1 = solver.solve_joint(datas, quants, samps, *ARGS, 0,
                                 device="cpu", tier=tier)
    fd, m = solver.solve_joint_chunked(datas, quants, samps, *ARGS, 0,
                                       device="cpu", tier=tier)
    res = C.solve_checkpointed(datas, quants, samps, *ARGS, 0,
                               str(tmp_path / "state.npz"), device="cpu",
                               tier=tier)
    assert m.shape == m1.shape == res.metrics.shape == (0, 4)
    np.testing.assert_array_equal(fd.numpy(), fd1.numpy())
    np.testing.assert_array_equal(res.fdata.numpy(), fd1.numpy())
    assert list(tmp_path.iterdir()) == []


def test_torch_fingerprint_mismatch_refused(tmp_path):
    ckpt = str(tmp_path / "state.npz")
    C.save_state(ckpt, (torch.zeros(3),), 1, "deadbeefdeadbeef")
    with pytest.raises(ValueError, match="different solve configuration"):
        C.load_state(ckpt, "0123456789abcdef")


@pytest.mark.parametrize("tier", solver.TIERS)
def test_torch_snapshot_of_another_tier_refused(tmp_path, tier):
    """A snapshot resumes only its own tier, iteration count and logging
    mode: every other tier, another total and the other
    simd_compat_logging are refused with the mismatch error."""
    datas, quants, samps = synth(np.random.default_rng(43))
    ckpt = str(tmp_path / "state.npz")
    _, _, carry = solver.solve_steps(datas, quants, samps, *ARGS, 6,
                                     nsteps=2, device="cpu", tier=tier)
    C.save_state(ckpt, carry, 2, tier_fingerprint(datas, samps, tier, 6))
    others = [dict(tier=t) for t in solver.TIERS if t != tier]
    others += [dict(tier=tier, iterations=7),
               dict(tier=tier, simd_compat_logging=False)]
    for kw in others:
        kw = {"iterations": 6, **kw}
        with pytest.raises(ValueError, match="different solve configuration"):
            C.solve_checkpointed(datas, quants, samps, *ARGS,
                                 checkpoint_path=ckpt, device="cpu", **kw)
    assert os.path.exists(ckpt)


def striped_synth(seed):
    return synth(np.random.default_rng(seed), luma=(16, 16), chroma=(8, 8))


def cpu_mesh(n=4):
    return stripe_mesh(n, ["cpu"] * n)


@pytest.mark.parametrize("body", stripes.BODIES)
def test_torch_striped_checkpoint_chunked_and_resume(tmp_path, body):
    """Over 4 CPU bands: chunked == one-shot solve_striped, and a snapshot
    left by a partial run (4 of 6) resumes to the identical final state,
    bit for bit; a snapshot of the other body or band count is refused."""
    datas, quants, samps = striped_synth(44)
    ckpt = str(tmp_path / "striped.npz")
    res = C.solve_striped_checkpointed(datas, quants, samps, *ARGS, 6,
                                       cpu_mesh(), ckpt, checkpoint_every=2,
                                       body=body)
    fd, m = stripes.solve_striped(datas, quants, samps, *ARGS, 6, cpu_mesh(),
                                  body=body)
    np.testing.assert_array_equal(res.fdata.numpy(), fd.numpy())
    np.testing.assert_array_equal(res.metrics, m)
    assert res.resumed_from == 0
    assert list(tmp_path.iterdir()) == []

    mesh = cpu_mesh()
    _, m_first, carry = stripes.striped_steps(datas, quants, samps, *ARGS, 6,
                                              mesh, nsteps=4, body=body)
    fp = C.striped_fingerprint(solver._geometry(datas, samps), 4, body,
                               *ARGS, 6, True)
    C.save_state(ckpt, C.gather_striped_carry(carry), 4, fp)
    other = "lite" if body == "f32" else "f32"
    for kw in (dict(mesh=mesh, body=other), dict(mesh=cpu_mesh(2), body=body)):
        with pytest.raises(ValueError, match="different solve configuration"):
            C.solve_striped_checkpointed(datas, quants, samps, *ARGS, 6,
                                         checkpoint_path=ckpt, **kw)
    res2 = C.solve_striped_checkpointed(datas, quants, samps, *ARGS, 6,
                                        mesh, ckpt, body=body)
    assert res2.resumed_from == 4
    np.testing.assert_array_equal(res2.fdata.numpy(), fd.numpy())
    np.testing.assert_array_equal(np.concatenate([m_first, res2.metrics]), m)
    assert not os.path.exists(ckpt)


@pytest.mark.parametrize("body", stripes.BODIES)
def test_torch_striped_steps_resume_by_hand(body):
    """striped_steps from its own carry: 4 + 2 iterations == 6 at once,
    and a carry of the other body is refused."""
    datas, quants, samps = striped_synth(47)
    mesh = cpu_mesh()
    _, m_a, carry = stripes.striped_steps(datas, quants, samps, *ARGS, 6,
                                          mesh, nsteps=4, body=body)
    fd_b, m_b, _ = stripes.striped_steps(datas, quants, samps, *ARGS, 6,
                                         mesh, carry=carry, nsteps=2,
                                         body=body)
    fd, m = stripes.solve_striped(datas, quants, samps, *ARGS, 6, cpu_mesh(),
                                  body=body)
    np.testing.assert_array_equal(fd_b.numpy(), fd.numpy())
    np.testing.assert_array_equal(np.concatenate([m_a, m_b]), m)
    other = "lite" if body == "f32" else "f32"
    with pytest.raises(ValueError, match="body's"):
        stripes.striped_steps(datas, quants, samps, *ARGS, 6, mesh,
                              carry=carry, nsteps=1, body=other)


def _jax_partial(datas, quants, samps, weight, pweights, total, nsteps):
    """The JAX package's XLA solver: nsteps of `total` iterations ->
    (its carry, the one-shot (fdata, metrics))."""
    geoms = tuple(jsolver.ChannelGeometry(d.shape[0], d.shape[1], sy, sx)
                  for d, (sy, sx) in zip(datas, samps))
    impl = jsolver._build_solver_impl(geoms, weight, tuple(pweights), total,
                                      True, "float32", False)
    dj = [jnp.asarray(d) for d in datas]
    qj = [jnp.asarray(q) for q in quants]
    _, _, carry = impl(dj, qj, None, nsteps)
    fd, m, _ = impl(dj, qj, None, total)
    return geoms, carry, (np.asarray(fd), np.asarray(m))


def test_torch_jax_snapshot_refused(tmp_path):
    """A snapshot the JAX package's save_state wrote (its pickled treedef
    is never read) is refused by the port with the mismatch error, and the
    port's checkpointed solve leaves it in place."""
    datas, quants, samps = synth(np.random.default_rng(48))
    geoms, carry, _ = _jax_partial(datas, quants, samps, *ARGS, 6, 4)
    ckpt = str(tmp_path / "jax.npz")
    jcheckpoint.save_state(ckpt, carry, 4, jcheckpoint._fingerprint(
        geoms, 0.3, [0.001] * 3, 6, False))
    with pytest.raises(ValueError, match="different solve configuration"):
        C.load_state(ckpt, tier_fingerprint(datas, samps, "two", 6))
    with pytest.raises(ValueError, match="different solve configuration"):
        C.solve_checkpointed(datas, quants, samps, *ARGS, 6, ckpt,
                             device="cpu", tier="two")
    assert os.path.exists(ckpt)


LAYOUTS = [
    # (nby, nbx, sy, sx) per channel, weight, pweights
    ([(4, 4, 1, 1), (2, 2, 2, 2), (2, 2, 2, 2)], 0.3, [0.001] * 3),
    ([(2, 3, 1, 1), (1, 2, 2, 2), (1, 2, 2, 2)], 0.3, [0.001] * 3),
    ([(4, 8, 1, 1), (4, 2, 1, 4), (4, 2, 1, 4)], 0.3, [0.001, 0.0, 0.002]),
]


@pytest.mark.parametrize("layout,weight,pweights", LAYOUTS)
def test_torch_checkpointed_matches_jax_checkpointed(tmp_path, layout,
                                                     weight, pweights):
    """The port's solve_checkpointed (two tier) against the JAX package's
    solve_checkpointed(use_pallas=False), both chunked by 2 over 5
    iterations: test_torch_solver_matches_jax's gates (rows 0-1 by
    assert_rows_close, PSNR > 45 dB)."""
    from test_torch_solver import synth_channels

    datas, quants, samps = synth_channels(np.random.default_rng(11), layout)
    ours = C.solve_checkpointed(datas, quants, samps, weight, pweights, 5,
                                str(tmp_path / "torch.npz"),
                                checkpoint_every=2, device="cpu", tier="two")
    ref = jcheckpoint.solve_checkpointed(
        datas, quants, samps, weight, pweights, 5, str(tmp_path / "jax.npz"),
        checkpoint_every=2, use_pallas=False)
    assert_rows_close(ours.metrics[:2], ref.metrics[:2])
    assert psnr(ours.fdata.numpy(), ref.fdata) > 45.0
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("tier", solver.TIERS)
def test_torch_resume_from_jax_snapshot_carry(tmp_path, tier):
    """The JAX package snapshots its XLA solver after 4 of 6 iterations;
    its load_state reads the carry, solver.carry_from_numpy carries it
    across to `tier`, the port snapshots it and its solve_checkpointed
    resumes: rows 0-1 of the resumed run against the JAX one-shot's rows
    4-5 (assert_rows_close; the lite tiers' prob distance to 2e-3, as
    tests/test_torch_two_lite.py resumes a JAX carry: bf16 devq), PSNR
    > 45 dB."""
    datas, quants, samps = synth(np.random.default_rng(49))
    geoms, carry, (fd_j, m_j) = _jax_partial(datas, quants, samps, *ARGS,
                                             6, 4)
    jpath = str(tmp_path / "jax.npz")
    jcheckpoint.save_state(jpath, carry, 4, jcheckpoint._fingerprint(
        geoms, 0.3, [0.001] * 3, 6, False))
    jcarry, it = jcheckpoint.load_state(jpath, jcheckpoint._fingerprint(
        geoms, 0.3, [0.001] * 3, 6, False))
    assert it == 4
    ours = solver.carry_from_numpy(jcarry, datas, quants, samps, *ARGS,
                                   device="cpu", tier=tier, source="xla")
    ckpt = str(tmp_path / "torch.npz")
    C.save_state(ckpt, ours, 4, tier_fingerprint(datas, samps, tier, 6))
    res = C.solve_checkpointed(datas, quants, samps, *ARGS, 6, ckpt,
                               device="cpu", tier=tier)
    assert res.resumed_from == 4 and res.metrics.shape == (2, 4)
    if tier.endswith("lite"):
        for col in (0, 2, 3):
            np.testing.assert_allclose(res.metrics[:, col], m_j[4:, col],
                                       rtol=1e-4)
        np.testing.assert_allclose(res.metrics[:, 1], m_j[4:, 1], rtol=2e-3)
    else:
        assert_rows_close(res.metrics, m_j[4:])
    assert psnr(res.fdata.numpy(), fd_j) > 45.0
    assert not os.path.exists(ckpt)


def test_torch_checkpointed_solve_needs_a_card_by_default(tmp_path,
                                                           monkeypatch):
    """On the card by default: without one, solve_checkpointed raises
    (no quiet fall back to the CPU) and writes nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    datas, quants, samps = synth(np.random.default_rng(50))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        C.solve_checkpointed(datas, quants, samps, *ARGS, 4,
                             str(tmp_path / "state.npz"), checkpoint_every=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        C.solve_striped_checkpointed(*striped_synth(50), *ARGS, 4,
                                     stripe_mesh(2, ["cuda:0"] * 2),
                                     str(tmp_path / "state.npz"))
    assert list(tmp_path.iterdir()) == []
