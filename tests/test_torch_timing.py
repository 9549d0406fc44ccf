"""utils/timing.py against the JAX package's (jpeg2png_tpu/utils/timing.py).

marginal_rate is the method of every port benchmark: it must give the
JAX estimator's number on tests/test_timing.py's fake timers (median of
attempts, the 2x-wall cap, the wall-rate fallback) and on a jittery one;
synth_coefs must make the JAX package's arrays; the timers must run the
port's solvers (here on the CPU, plain versions); the build counter
counts library builds (a warm pass builds nothing); mixed_batch_bench
keeps the JAX harness's keys.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jpeg2png_tpu.utils import timing as jax_timing  # noqa: E402
from jpeg2png_tpu_torch.kernels import _build  # noqa: E402
from jpeg2png_tpu_torch.utils import timing  # noqa: E402

torch.set_num_threads(2)


def make_timed(times):
    seq = list(times)
    return lambda n: seq.pop(0)


# (successive t(n1), t(n2) pairs, expected rate at mp 0.1, n 30 -> 130)
FAKE_TIMERS = {
    # tests/test_timing.py: one lucky pair among three
    "median": ([0.5, 1.5, 0.8, 1.1, 0.5, 1.5], 10.0),
    # every delta tiny: capped at 2x the longer run's wall rate
    "cap": ([1.0, 1.1] * 3, 2.0 * 0.1 * 130 / 1.1),
    # no valid delta: the wall rate
    "fallback": ([1.0, 1.0] * 3, 0.1 * 130 / 1.0),
    # jitter: one t2 below 1.02 t1, two valid deltas (median of two: the
    # lower) of 1.0 s and 0.8 s
    "jitter": ([0.9, 0.91, 0.4, 1.4, 0.6, 1.4], 0.1 * 100 / 1.0),
}


@pytest.mark.parametrize("case", sorted(FAKE_TIMERS))
def test_torch_marginal_rate_matches_jax(case):
    times, want = FAKE_TIMERS[case]
    ours = timing.marginal_rate(make_timed(times), 0.1, 30, 130, attempts=3)
    theirs = jax_timing.marginal_rate(make_timed(times), 0.1, 30, 130,
                                      attempts=3)
    assert ours == theirs
    assert abs(ours - want) < 1e-9


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_torch_synth_coefs_matches_jax(seed):
    ours = timing.synth_coefs(6, 10, seed)
    theirs = jax_timing.synth_coefs(6, 10, seed)
    for a, b in zip(ours[0] + ours[1], theirs[0] + theirs[1]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert ours[2] == theirs[2]


def test_torch_joint_and_striped_timers_on_cpu():
    datas, quants, samps = timing.synth_coefs(8, 16)
    for timed in (timing.joint_timer(datas, quants, samps, 1, device="cpu"),
                  timing.joint_timer(datas, quants, samps, 1, device="cpu",
                                     tier="two"),
                  timing.striped_timer(datas, quants, samps, 1, n_stripes=2,
                                       device="cpu", body="lite")):
        t = timed(2)
        assert math.isfinite(t) and t > 0
        rate = timing.marginal_rate(timed, 8 * 8 * 16 * 8 / 1e6, 1, 3,
                                    attempts=1)
        assert math.isfinite(rate) and rate > 0


def test_torch_build_counter_counts_library_builds(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with timing.BuildCounter() as bc:
        _build.build(["jpeg_entropy"])       # cc, into an empty directory
        assert bc.count == 1
    assert bc.count == 1
    with timing.BuildCounter() as warm:
        _build.build(["jpeg_entropy"])       # built: nothing to do
    assert warm.count == 0


# jpeg2png_tpu/utils/timing.py::mixed_batch_bench's keys
JAX_BATCH_KEYS = {
    "n_files", "iterations", "mp_total", "files_per_s", "mp_iter_per_s",
    "n_buckets", "bucket_classes", "compiles_cold", "compiles_warm",
    "cold_s", "warm_s", "warm_read_s", "warm_solve_s", "upload_mb",
    "fetch_mb"}


def test_torch_mixed_batch_bench_on_cpu(tmp_path):
    res = timing.mixed_batch_bench(4, 2, workdir=tmp_path / "corpus",
                                   device="cpu")
    assert JAX_BATCH_KEYS <= set(res)
    assert res["n_files"] == 4 and res["iterations"] == 2
    assert res["compiles_warm"] == 0
    assert res["files_per_s"] > 0 and res["mp_iter_per_s"] > 0
    assert res["n_buckets"] >= 1 and res["upload_mb"] > 0
    # minted once: both passes read the same files
    files = sorted(p.name for p in (tmp_path / "corpus").iterdir())
    assert len(files) == 4
