"""The port's serving over several devices on the CPU: the bucket solves
and decode_files_batched dealt over device lists (["cpu"] * k, one host
thread each), dp_degree's rule, the JAX package's data-parallel runner on
its 8-device CPU mesh, --tpu-batch --tpu-distributed over two gloo
processes, batch_stripe_mesh / solve_striped_batched against per-image
striped solves and the JAX batched striped solve, and the launch-count
lock under many threads.  Every device list's result must equal the one
device's bit for bit: work items (a dyn bucket's chunks of up to 8
images, a dyn2 or exact image) are formed as on one device and dealt
whole."""

import os
import shutil
import sys
import textwrap
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.experimental.pallas as pl  # noqa: E402
from jax.sharding import Mesh  # noqa: E402
from PIL import Image  # noqa: E402

from jpeg2png_tpu import runner as jrunner  # noqa: E402
from jpeg2png_tpu.io import read_jpeg as jread_jpeg  # noqa: E402
from jpeg2png_tpu.parallel import stripes as jstripes  # noqa: E402
from jpeg2png_tpu_torch import runner  # noqa: E402
from jpeg2png_tpu_torch.io import read_jpeg  # noqa: E402
from jpeg2png_tpu_torch.kernels import _build  # noqa: E402
from jpeg2png_tpu_torch.models import solver  # noqa: E402
from jpeg2png_tpu_torch.parallel import distributed, mesh, stripes  # noqa: E402
from jpeg2png_tpu_torch.pipeline import smooth_decode  # noqa: E402
from jpeg2png_tpu_torch.utils.config import SolverConfig  # noqa: E402
from test_e2e import psnr  # noqa: E402
from test_torch_distributed import _finish, _start_pair  # noqa: E402
from test_torch_solver import assert_rows_close, synth_channels  # noqa: E402

torch.set_num_threads(2)

CPUS = {k: ["cpu"] * k for k in (1, 2, 4)}


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(pl, "pallas_call", patched)


def _set_gates(monkeypatch, mega, mega_lite, two_lite):
    monkeypatch.setattr(solver, "MEGA_MAX_PIXELS", mega)
    monkeypatch.setattr(solver, "MEGA_LITE_MAX_PIXELS", mega_lite)
    monkeypatch.setattr(solver, "TWO_LITE_MAX_PIXELS", two_lite)


def _random_batch(B, seed=11):
    """tests/test_runner.py:128's B same-geometry random images."""
    rng = np.random.default_rng(seed)
    datas, quants = [], []
    for _ in range(B):
        datas.append([
            rng.integers(-25, 25, (4, 4, 8, 8)).astype(np.int16),
            rng.integers(-12, 12, (2, 2, 8, 8)).astype(np.int16),
            rng.integers(-12, 12, (2, 2, 8, 8)).astype(np.int16)])
        quants.append([rng.integers(1, 60, (8, 8)).astype(np.uint16)
                       for _ in range(3)])
    return datas, quants, [(1, 1), (2, 2), (2, 2)]


# ------------------------------------------------------------ dp_degree

def test_torch_dp_degree(monkeypatch):
    """The devices a bucket's work items fan out over: the list as given
    (repeats allowed), at most `requested` and at most the items, at
    least one; a CUDA device that is not there raises; in a multi-process
    run only this process's own device."""
    cpu = torch.device("cpu")
    assert runner.dp_degree(5, devices=CPUS[4]) == [cpu] * 4
    assert runner.dp_degree(2, devices=CPUS[4]) == [cpu] * 2
    assert runner.dp_degree(5, 2, devices=CPUS[4]) == [cpu] * 2
    assert runner.dp_degree(5, 0, devices=CPUS[4]) == [cpu]
    assert runner.dp_degree(0, devices=CPUS[4]) == [cpu]
    assert runner.dp_degree(8, device="cpu") == [cpu]
    with pytest.raises(ValueError, match="empty"):
        runner.dp_degree(2, devices=[])
    missing = f"cuda:{torch.cuda.device_count() + 7}"
    with pytest.raises(RuntimeError):
        runner.dp_degree(2, devices=["cpu", missing])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            runner.dp_degree(2)                 # device="cuda", no card
    monkeypatch.setattr(distributed, "is_multi_process", lambda: True)
    monkeypatch.setattr(distributed, "local_devices", lambda: [cpu])
    assert runner.dp_degree(8, devices=CPUS[4]) == [cpu]
    assert runner.dp_degree(8, 4, device="cpu") == [cpu]


def test_torch_run_on_cards():
    """One host thread per device, all at once, each in its device's
    context: k items that each wait for all k to start finish only if k
    workers run them concurrently; the stats count each worker's items.
    A worker's exception reaches the caller, and the other workers stop
    taking items."""
    k = 4
    barrier = threading.Barrier(k)
    seen = []

    def item(dev):
        seen.append((threading.current_thread().name, dev))
        barrier.wait(timeout=60)

    stats = {}
    runner._run_on_cards([item] * k, [torch.device("cpu")] * k, stats)
    assert sorted(t for t, _ in seen) == [f"j2p-card_{i}" for i in range(k)]
    assert stats["cards"] == ["cpu"] * k and stats["card_items"] == [1] * k
    assert len(stats["card_busy_s"]) == k

    ran = []

    def boom(dev):
        raise RuntimeError("card fault")

    def slow(dev):
        ran.append(dev)
        threading.Event().wait(0.05)

    with pytest.raises(RuntimeError, match="card fault"):
        runner._run_on_cards([boom] + [slow] * 50,
                             [torch.device("cpu")] * 2)
    assert len(ran) < 50


# ------------------------------------------------------- bucket solves

def _tiles(fixtures_dir, n):
    """n 4:2:0 images of two sizes for one 128x128 dyn bucket: n > 8
    gives two K3 chunks."""
    names = ["lineart64_q20_420", "odd100x52_q25_420"]
    return [read_jpeg(fixtures_dir / f"{names[i % 2]}.jpg") for i in range(n)]


def _thread_names(log):
    def finish(mbs, f):
        log.append((threading.current_thread().name, tuple(mbs), f.clone()))
    return finish


@pytest.mark.parametrize("k", [2, 4])
def test_torch_solve_bucket_over_devices(fixtures_dir, k):
    """A 10-image dyn bucket (chunks of 8 and 2) over k CPU workers ==
    one worker, bit for bit, fdata and metrics; finish() receives whole
    chunks on the workers' threads; data_parallel=1 keeps one worker."""
    imgs = _tiles(fixtures_dir, 10)
    args = (imgs, (128, 128), 0.3, [0.001] * 3, 2)
    one = runner.solve_bucket(*args, device="cpu", devices=CPUS[1])
    got = runner.solve_bucket(*args, device="cpu", devices=CPUS[k])
    assert torch.equal(got.fdata, one.fdata)
    np.testing.assert_array_equal(got.metrics, one.metrics)
    log = []
    res = runner.solve_bucket(*args, device="cpu", devices=CPUS[k],
                              finish=_thread_names(log))
    assert res.fdata is None
    # whole chunks, each on one of the workers (which one takes which is
    # the queue's timing)
    assert sorted(m for _, m, _ in log) == [tuple(range(8)), (8, 9)]
    assert {t for t, _, _ in log} <= {f"j2p-card_{i}" for i in range(k)}
    for _, mbs, f in log:
        assert torch.equal(f, one.fdata[list(mbs)])
    log.clear()
    runner.solve_bucket(*args, device="cpu", devices=CPUS[k],
                        data_parallel=1, finish=_thread_names(log))
    assert {t for t, _, _ in log} == {"j2p-card_0"}


@pytest.mark.parametrize("k", [2, 4])
def test_torch_solve_bucket_two_over_devices(fixtures_dir, monkeypatch, k):
    """A 5-image dyn2 bucket (one image per item; 5 over 4 is uneven) over
    k CPU workers == one worker, bit for bit."""
    _set_gates(monkeypatch, 0, 0, 1 << 62)
    imgs = _tiles(fixtures_dir, 5)
    args = (imgs, (128, 128), 0.3, [0.001] * 3, 2)
    one = runner.solve_bucket_two(*args, device="cpu", devices=CPUS[1])
    got = runner.solve_bucket_two(*args, device="cpu", devices=CPUS[k])
    assert got.fdata.shape == (5, 3, 128, 128)
    assert torch.equal(got.fdata, one.fdata)
    np.testing.assert_array_equal(got.metrics, one.metrics)
    log = []
    runner.solve_bucket_two(*args, device="cpu", devices=CPUS[k],
                            data_parallel=2, finish=_thread_names(log))
    assert sorted(m for _, m, _ in log) == [(i,) for i in range(5)]
    assert {t for t, _, _ in log} <= {"j2p-card_0", "j2p-card_1"}


@pytest.mark.parametrize("k", [2, 4])
def test_torch_solve_batched_over_devices(k):
    """The exact class, B = 8 and an uneven B = 5, over k CPU workers ==
    one worker, bit for bit."""
    datas, quants, samps = _random_batch(8)
    args = (samps, 0.3, [0.001] * 3, 3)
    one = runner.solve_batched(datas, quants, *args, device="cpu",
                               devices=CPUS[1])
    got = runner.solve_batched(datas, quants, *args, device="cpu",
                               devices=CPUS[k])
    assert torch.equal(got.fdata, one.fdata)
    np.testing.assert_array_equal(got.metrics, one.metrics)
    five = runner.solve_batched(datas[:5], quants[:5], *args, device="cpu",
                                devices=CPUS[k], data_parallel=k - 1)
    assert five.fdata.shape[0] == 5
    assert torch.equal(five.fdata, one.fdata[:5])
    np.testing.assert_array_equal(five.metrics, one.metrics[:5])


def test_torch_solve_batched_matches_jax_data_parallel():
    """The port's exact class over 4 CPU workers against the JAX
    package's solve_batched sharded over its 8 CPU devices
    (tests/test_runner.py:128): the state after 1 iteration within atol
    5e-3 and metric rows 0-1 of a 2-iteration run within rtol 1e-4, the
    gates test_torch_runner.py holds the bucket solve to."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh")
    datas, quants, samps = _random_batch(8)
    for iters in (1, 2):
        ours = runner.solve_batched(datas, quants, samps, 0.3, [0.001] * 3,
                                    iters, device="cpu", devices=CPUS[4])
        ref = jrunner.solve_batched(datas, quants, samps, 0.3, [0.001] * 3,
                                    iters, data_parallel=8)
        if iters == 1:
            np.testing.assert_allclose(ours.fdata.numpy(),
                                       np.asarray(ref.fdata), atol=5e-3)
        np.testing.assert_allclose(ours.metrics[:, :2],
                                   np.asarray(ref.metrics)[:, :2],
                                   rtol=1e-4)


def test_torch_solve_bucket_matches_jax_data_parallel(fixtures_dir,
                                                      interpret_pallas):
    """The port's dyn bucket over 2 CPU workers against the JAX package's
    solve_bucket(data_parallel=2) (tests/test_runner.py:166, Pallas in
    interpret mode): state after 1 iteration within atol 5e-3, bucket
    padding exactly 0, metric rows 0-1 of a 2-iteration run within rtol
    1e-4, the prob distance also within atol 1e-4 (assert_rows_close:
    the JAX whole-solve kernel takes its forward DCT in bf16x3, which
    moves row 1's distance by ~1e-5 absolute)."""
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 devices")
    names = ["lineart128_q10_420", "lineart64_q20_420"]
    imgs = [read_jpeg(fixtures_dir / f"{n}.jpg") for n in names]
    jimgs = [jread_jpeg(fixtures_dir / f"{n}.jpg") for n in names]
    for iters in (1, 2):
        ours = runner.solve_bucket(imgs, (256, 256), 0.3, [0.001] * 3,
                                   iters, device="cpu", devices=CPUS[2])
        ref = jrunner.solve_bucket(jimgs, (256, 256), 0.3, [0.001] * 3,
                                   iters, data_parallel=2)
        if iters == 1:
            np.testing.assert_allclose(ours.fdata.numpy(),
                                       np.asarray(ref.fdata), atol=5e-3)
            for bi, img in enumerate(imgs):
                H = max(p.nby * 8 * p.h_samp for p in img.planes)
                W = max(p.nbx * 8 * p.w_samp for p in img.planes)
                got = ours.fdata[bi]
                assert not got[:, H:].any() and not got[:, :, W:].any()
        for bi in range(2):
            assert_rows_close(ours.metrics[bi, :2],
                              np.asarray(ref.metrics)[bi, :2])


# -------------------------------------------------- decode_files_batched

def _serving_files(fixtures_dir, tmp_path):
    """15 files of every class under gates mega 80x80, two-lite 64x112:
    nine 64x64 4:2:0 copies (one dyn bucket, two chunks), gray and 4:2:2
    dyn buckets, two 64x112 dyn2 images and two 128x128 exact ones."""
    copies = ([("lineart64_q20_420", i) for i in range(9)]
              + [("gray64_q30", 0), ("photo80_q30_422", 0)]
              + [("odd100x52_q25_420", i) for i in range(2)]
              + [("art120x88_q40_440", 0), ("lineart128_q10_420", 0)])
    files = []
    for name, i in copies:
        dst = tmp_path / f"{name}_{i}.jpg"
        shutil.copy(fixtures_dir / f"{name}.jpg", dst)
        files.append(str(dst))
    return files


def test_torch_decode_files_batched_over_devices(fixtures_dir, tmp_path,
                                                 monkeypatch):
    """Every class's work items over 1, 2 and 4 CPU workers: the same
    16-bit pixels, the same CSV rows and bar total; stats name the
    workers, their items (8 in all) and busy seconds; -t's cap
    (data_parallel=2) keeps two workers."""
    from jpeg2png_tpu_torch.utils.logger import ConvergenceLogger
    from jpeg2png_tpu_torch.utils.progress import ProgressBar

    _set_gates(monkeypatch, 80 * 80, 0, 64 * 112)
    files = _serving_files(fixtures_dir, tmp_path)
    cfg = SolverConfig(iterations=(3,) * 3)
    runs = {}
    for k, cap in ((1, None), (2, None), (4, None), (4, 2)):
        stats, rows = {}, []

        class Sink:
            def write(self, line):
                rows.append(line)

            def flush(self):
                pass

        bar = ProgressBar(len(files) * 3, stream=Sink())
        out = runner.decode_files_batched(
            files, cfg, bits=16, stats=stats, device="cpu", devices=CPUS[k],
            data_parallel=cap, logger=ConvergenceLogger(Sink()),
            progress=bar)
        assert stats["bucket_classes"] == {"dyn": 3, "dyn2": 1, "exact": 2}
        n = k if cap is None else cap
        assert stats["cards"] == ["cpu"] * n
        assert sum(stats["card_items"]) == 8
        assert len(stats["card_busy_s"]) == n
        assert bar.current == len(files) * 3
        runs[(k, cap)] = out, sorted(r for r in rows if r.count(",") == 6)
    one, one_rows = runs[(1, None)]
    assert set(one) == set(files) and len(one_rows) == 1 + len(files) * 3
    for (k, cap), (out, rows) in runs.items():
        assert rows == one_rows, (k, cap)
        for f in files:
            np.testing.assert_array_equal(out[f], one[f])


def test_torch_decode_files_batched_errors_over_devices(fixtures_dir,
                                                        tmp_path,
                                                        monkeypatch):
    """A bucket that fails on a worker drops out whole (one error line per
    member) while the other buckets decode; without an error list the
    worker's exception reaches the caller, and an exception that is not
    an input error always does."""
    _set_gates(monkeypatch, 80 * 80, 0, 64 * 112)
    files = _serving_files(fixtures_dir, tmp_path)
    cfg = SolverConfig(iterations=(2,) * 3)

    def broken(self, members, device):
        raise ValueError("dyn2 worker failed")

    monkeypatch.setattr(runner._Dyn2Solve, "solve", broken)
    errors = []
    out = runner.decode_files_batched(files, cfg, errors=errors,
                                      device="cpu", devices=CPUS[4])
    dyn2 = [f for f in files if "odd100x52" in f]
    assert sorted(errors) == sorted(f"{f}: dyn2 worker failed" for f in dyn2)
    assert set(out) == set(files) - set(dyn2)
    with pytest.raises(ValueError, match="dyn2 worker failed"):
        runner.decode_files_batched(files, cfg, device="cpu",
                                    devices=CPUS[4])

    def crashed(self, members, device):
        raise RuntimeError("exact worker crashed")

    monkeypatch.setattr(runner._ExactSolve, "solve", crashed)
    with pytest.raises(RuntimeError, match="exact worker crashed"):
        runner.decode_files_batched(files, cfg, errors=[], device="cpu",
                                    devices=CPUS[4])


# ------------------------------------------------- two gloo processes

NAMES = ["lineart64_q20_420", "photo80_q30_422", "gray64_q30",
         "odd100x52_q25_420", "art120x88_q40_440", "lineart128_q10_420"]

_BATCH_WORKER = textwrap.dedent("""
    import os
    import torch
    torch.set_num_threads(1)
    from jpeg2png_tpu_torch.cli import main
    from jpeg2png_tpu_torch.parallel import distributed

    out = os.environ["JPEG2PNG_TEST_TMP"]
    rank = int(os.environ["JPEG2PNG_PROCESS_ID"])
    names = %(names)r
    ins = [os.path.join("tests", "fixtures", n + ".jpg") for n in names]
    outs = [os.path.join(out, f"r{rank}", n + ".png") for n in names]
    os.makedirs(os.path.join(out, f"r{rank}"))
    argv = ins + [a for o in outs for a in ("-o", o)] + [
        "-i", "2", "-q", "-c", os.path.join(out, f"log{rank}.csv"),
        "--tpu-batch", "--tpu-distributed", "--device", "cpu"]
    rc = main(argv)
    assert rc == 0, rc
    assert not distributed.is_joined()      # main left the group it joined
    print(f"rank {rank}: ok", flush=True)
""") % {"names": NAMES}


def test_torch_cli_tpu_batch_distributed(tmp_path, fixtures_dir):
    """cli --tpu-batch --tpu-distributed over two gloo processes: rank r
    decodes and writes files i % 2 == r, each PNG > 45 dB against the
    file decoded by one process; rank 0 alone writes the CSV, holding
    its own files' rows; both return 0 and leave the group."""
    worker = tmp_path / "worker.py"
    worker.write_text(_BATCH_WORKER)
    _finish([_start_pair(worker, tmp_path)])
    for rank in (0, 1):
        want = {f"{n}.png" for n in NAMES[rank::2]}
        assert set(os.listdir(tmp_path / f"r{rank}")) == want
    assert (tmp_path / "log0.csv").exists()
    assert not (tmp_path / "log1.csv").exists()
    rows = (tmp_path / "log0.csv").read_text().splitlines()[1:]
    assert {r.split(",")[0] for r in rows} == {
        os.path.join("tests", "fixtures", f"{n}.jpg") for n in NAMES[0::2]}
    assert len(rows) == 3 * 2
    cfg = SolverConfig(iterations=(2,) * 3)
    for i, n in enumerate(NAMES):
        ref = smooth_decode(read_jpeg(fixtures_dir / f"{n}.jpg"), cfg,
                            device="cpu").pixels
        got = np.asarray(Image.open(tmp_path / f"r{i % 2}" / f"{n}.png"))
        assert got.shape == ref.shape
        assert psnr(got, ref) > 45.0, n


# --------------------------------------------- solve_striped_batched

LAYOUT = [(16, 16, 1, 1), (8, 8, 2, 2), (8, 8, 2, 2)]


def _two_images(seed):
    rng = np.random.default_rng(seed)
    d0, q0, samps = synth_channels(rng, LAYOUT)
    d1, q1, _ = synth_channels(rng, LAYOUT)
    return [d0, d1], [q0, q1], samps


@pytest.mark.parametrize("body", stripes.BODIES)
def test_torch_solve_striped_batched(body, interpret_pallas):
    """B = 2 images x 4 bands on ["cpu"] * 8: each image equals its own
    solve_striped over 4 bands bit for bit, 3 collectives per iteration
    on each group; against the JAX solve_striped_batched on the 8-device
    mesh (tests/test_stripes.py:208 and test_stripes_lite.py:126): metric
    rows within rtol 5e-3 / atol 1e-2, fdata within atol 0.5."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh")
    datas, quants, samps = _two_images(31 if body == "f32" else 5)
    iters = 4
    m2 = mesh.batch_stripe_mesh(2, 4, ["cpu"] * 8)
    assert [g.n for g in m2] == [4, 4]
    fd_b, m_b = stripes.solve_striped_batched(
        datas, quants, samps, 0.3, [0.001] * 3, iters, m2, body=body)
    assert fd_b.shape == (2, 3, 128, 128) and m_b.shape == (2, iters, 4)
    for g in m2:
        assert g.comm.counts == {"halo": 2 * iters, "all_reduce": iters}
    for b in range(2):
        fd_1, m_1 = stripes.solve_striped(
            datas[b], quants[b], samps, 0.3, [0.001] * 3, iters,
            mesh.stripe_mesh(4, ["cpu"] * 4), body=body)
        assert torch.equal(fd_b[b], fd_1)
        np.testing.assert_array_equal(m_b[b], m_1)
    jmesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("batch", "y"))
    fd_j, m_j = jstripes.solve_striped_batched(
        datas, quants, samps, 0.3, [0.001] * 3, iters, jmesh,
        use_pallas=body == "lite")
    np.testing.assert_allclose(m_b, np.asarray(m_j), rtol=5e-3, atol=1e-2)
    np.testing.assert_allclose(fd_b.numpy(), np.asarray(fd_j), atol=0.5)


def test_torch_solve_striped_batched_refusals():
    """A batch that is not the mesh's size and too few devices (never a
    smaller mesh) raise."""
    datas, quants, samps = _two_images(3)
    m2 = mesh.batch_stripe_mesh(2, 2, ["cpu"] * 4)
    with pytest.raises(ValueError, match="batch size 1 != mesh batch size 2"):
        stripes.solve_striped_batched(datas[:1], quants[:1], samps, 0.3,
                                      [0.001] * 3, 1, m2)
    with pytest.raises(ValueError, match="need 8 devices .* have 7"):
        mesh.batch_stripe_mesh(2, 4, ["cpu"] * 7)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="have 0"):
            mesh.batch_stripe_mesh(2, 1)


# ---------------------------------------------------- the launch counts

def test_torch_launch_count_lock():
    """Sixteen threads add to one wrapper's count through
    _build.count_launch, the helper every kernel wrapper calls, with the
    interpreter switching threads every microsecond: no update is lost."""
    def wrapper():
        pass

    wrapper.launches = 0
    per_thread = 20000
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [_build.count_launch(wrapper)
                            for _ in range(per_thread)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(saved)
    assert wrapper.launches == 16 * per_thread
