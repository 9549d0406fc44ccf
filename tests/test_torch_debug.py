"""utils/debug.py: the port's FP traps (fp_exceptions,
enable_fp_exceptions) against non-finite kernel outputs and solver
carries.

A flat image (all coefficients zero) has zero gradient norms everywhere:
the solver's step scale there is torch.where(norm == 0, 0, step / norm),
whose discarded branch is Inf.  The traps check kernel outputs and
carries, not that temporary, so such an image solves without a trap in
every tier and both striped bodies, and its result is the subgradient's
0.  A NaN planted in an input raises FloatingPointError from the first
kernel wrapper that passes it on (here, on the CPU, after the plain
version); with the traps off nothing raises.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jpeg2png_tpu_torch.kernels import (  # noqa: E402
    _build, grad_step, project_step)
from jpeg2png_tpu_torch.models import solver  # noqa: E402
from jpeg2png_tpu_torch.parallel.mesh import stripe_mesh  # noqa: E402
from jpeg2png_tpu_torch.parallel.stripes import solve_striped  # noqa: E402
from jpeg2png_tpu_torch.utils.debug import (  # noqa: E402
    enable_fp_exceptions, fp_exceptions)

torch.set_num_threads(2)

SAMPS = [(1, 1), (2, 2), (2, 2)]
# (tier, striped body): every solver tier, then the striped solve over 2
# CPU bands with each body
SOLVES = [(t, None) for t in solver.TIERS] + [(None, "f32"), (None, "lite")]


def _flat(nby=4, nbx=4):
    datas = [np.zeros((nby, nbx, 8, 8), np.int16),
             np.zeros((nby // 2, nbx // 2, 8, 8), np.int16),
             np.zeros((nby // 2, nbx // 2, 8, 8), np.int16)]
    quants = [np.full((8, 8), 7.0, np.float32) for _ in range(3)]
    return datas, quants


def _solve(datas, quants, tier, body, iterations=3):
    if body is None:
        return solver.solve_joint(datas, quants, SAMPS, 0.3, [0.001] * 3,
                                  iterations, device="cpu", tier=tier)
    return solve_striped(datas, quants, SAMPS, 0.3, [0.001] * 3, iterations,
                         stripe_mesh(2, ["cpu"] * 2), body=body)


@pytest.mark.parametrize("tier,body", SOLVES)
def test_torch_flat_image_solves_under_fp_exceptions(tier, body):
    datas, quants = _flat()
    with fp_exceptions():
        assert _build.fp_traps
        fd, metrics = _solve(datas, quants, tier, body)
    assert not _build.fp_traps
    assert torch.equal(fd, torch.zeros_like(fd))
    assert np.array_equal(metrics, np.zeros_like(metrics))


@pytest.mark.parametrize("tier,body", SOLVES)
def test_torch_planted_nan_raises(tier, body):
    datas, quants = _flat()
    quants[1][0, 0] = np.nan               # a NaN box: the decode is NaN
    with fp_exceptions(), pytest.raises(FloatingPointError,
                                        match="non-finite"):
        _solve(datas, quants, tier, body)
    fd, _ = _solve(datas, quants, tier, body)     # traps off: no raise
    assert not bool(torch.isfinite(fd).all())


def _k1_inputs(nan: bool):
    rng = np.random.default_rng(0)
    f = torch.as_tensor(rng.normal(size=(3, 16, 16)).astype(np.float32))
    if nan:
        f[1, 3, 5] = float("nan")
    return f, f * 0.5, [torch.zeros(16, 16)] * 3


def test_torch_nan_in_plain_version_input_raises_at_the_wrapper():
    f, fista, pg = _k1_inputs(nan=True)
    with fp_exceptions():
        with pytest.raises(FloatingPointError, match="fused_grad"):
            grad_step.fused_grad(f, fista, pg, 0.5, 0.3)
        # K2 given K1's non-finite step
        grads, extraps, _, _, _ = grad_step.fused_grad_plain(
            f, fista, pg, 0.5, 0.3)
        box = [torch.full((16, 16), -1e3), torch.full((8, 8), -1e3),
               torch.full((8, 8), -1e3)]
        with pytest.raises(FloatingPointError, match="fused_project_multi"):
            project_step.fused_project_multi(
                extraps, grads, torch.ones(3), box, [-b for b in box],
                [None] * 3, [None] * 3, [0.0] * 3, SAMPS)


def test_torch_fp_exceptions_disabled_and_state_restored(monkeypatch):
    f, fista, pg = _k1_inputs(nan=True)
    with fp_exceptions(enable=False):
        assert not _build.fp_traps
        grad_step.fused_grad(f, fista, pg, 0.5, 0.3)         # no raise
    grad_step.fused_grad(f, fista, pg, 0.5, 0.3)
    # restored after an exception, and nested blocks restore their own
    with pytest.raises(FloatingPointError):
        with fp_exceptions():
            grad_step.fused_grad(f, fista, pg, 0.5, 0.3)
    assert not _build.fp_traps
    monkeypatch.setattr(_build, "fp_traps", False)
    enable_fp_exceptions()
    assert _build.fp_traps
    with fp_exceptions(enable=False):
        assert _build.fp_traps          # disabled: leaves the state alone
    with fp_exceptions():
        pass
    assert _build.fp_traps              # the process-wide enable stays
    f_ok, fista_ok, _ = _k1_inputs(nan=False)
    grad_step.fused_grad(f_ok, fista_ok, pg, 0.5, 0.3)       # finite: quiet


def test_torch_striped_carry_check_traps_a_collective(monkeypatch):
    """A NaN that no kernel passes on (the all-reduced tv sum, which only
    the metrics read) is caught by the striped body's check of its carry
    after the iteration."""
    from jpeg2png_tpu_torch.parallel.mesh import LocalComm

    real = LocalComm.all_reduce

    def poisoned(self, xs):
        out = real(self, xs)
        for x in out:
            x[3] = float("nan")       # [sumsq C=3, tv, tv2, distance]
        return out

    monkeypatch.setattr(LocalComm, "all_reduce", poisoned)
    datas, quants = _flat()
    with fp_exceptions(), pytest.raises(FloatingPointError,
                                        match="striped solve, iteration 0"):
        _solve(datas, quants, None, "f32")
