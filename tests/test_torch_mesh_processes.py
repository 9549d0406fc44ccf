"""The port's meshes across processes: gloo processes on localhost holding
several bands each, uneven layouts, processes that hold no band, and the
batch x stripe mesh with a sub-group per image.

Two runs of a worker script (two processes, then four) each hold a list
of cases: striped solves of both bodies over n bands, batched striping
2 x 2, a checkpointed solve cut and resumed, the CLI, and the gathers
with unequal shares.  The processes join through
jpeg2png_tpu_torch.parallel.distributed.initialize (the JPEG2PNG_*
variables, `--device cpu`: any number of bands per process, an even
share of each mesh) and write what they got; the tests hold it against
the same solves in this process (stripe_mesh(n, ["cpu"] * n)), bit for
bit: the all-reduce adds every band's vector in band order wherever the
bands live.  The batch is also held against JAX's solve_striped_batched
on the 8-device CPU mesh.  Each process has a time limit of its own, so
a hung collective fails the run.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.experimental.pallas as pl  # noqa: E402
from jax.sharding import Mesh  # noqa: E402
from PIL import Image  # noqa: E402

from jpeg2png_tpu.parallel import stripes as jstripes  # noqa: E402
from jpeg2png_tpu_torch.parallel import distributed, mesh, stripes  # noqa: E402
from test_torch_distributed import _free_port  # noqa: E402
from test_torch_solver import synth_channels  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYOUT = [(13, 16, 1, 1), (7, 8, 2, 2), (7, 8, 2, 2)]   # 112 x 128, 4:2:0
BATCH_LAYOUT = [(16, 16, 1, 1), (8, 8, 2, 2), (8, 8, 2, 2)]
ITERS = 3

torch.set_num_threads(2)

_WORKER = textwrap.dedent("""
    import os, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from jpeg2png_tpu_torch.models import checkpoint as C
    from jpeg2png_tpu_torch.models.solver import _geometry
    from jpeg2png_tpu_torch.parallel import distributed, mesh as M, stripes

    def synth(rng, layout):        # tests/test_torch_solver.py::synth_channels
        datas, quants, samps = [], [], []
        for nby, nbx, sy, sx in layout:
            datas.append(rng.integers(-25, 25, (nby, nbx, 8, 8))
                         .astype(np.int16))
            quants.append(rng.integers(1, 80, (8, 8)).astype(np.uint16))
            samps.append((sy, sx))
        return datas, quants, samps

    rank, world = distributed.initialize(device="cpu")
    out = os.environ["JPEG2PNG_TEST_TMP"]
    cases = os.environ["J2P_CASES"].split()
    datas, quants, samps = synth(np.random.default_rng(3), %(layout)r)
    args = (datas, quants, samps, 0.3, [0.001] * 3)
    saved = {}

    for case in cases:
        kind, *rest = case.split(":")
        if kind == "stripe":                      # stripe:n:body
            n, body = int(rest[0]), rest[1]
            m = M.stripe_mesh(n)
            fd, metrics = stripes.solve_striped(*args, %(iters)d, m, body=body)
            assert m.comm.counts == {"halo": 2 * %(iters)d,
                                     "all_reduce": %(iters)d}, m.comm.counts
            saved[case + ":fd"] = distributed.gather_output(fd).numpy()
            saved[case + ":m"] = metrics
            saved[case + ":own"] = np.array([m.first, len(m.devices)])
        elif kind == "batch":                     # batch:body
            body = rest[0]
            rng = np.random.default_rng(31 if body == "f32" else 5)
            d0, q0, ss = synth(rng, %(batch)r)
            d1, q1, _ = synth(rng, %(batch)r)
            m2 = M.batch_stripe_mesh(2, 2)
            groups = len(distributed._state["groups"])
            assert M.batch_stripe_mesh(2, 2)[0].ranks == m2[0].ranks
            assert len(distributed._state["groups"]) == groups   # cached
            fd, metrics = stripes.solve_striped_batched(
                [d0, d1], [q0, q1], ss, 0.3, [0.001] * 3, %(iters)d, m2,
                body=body)
            for g in m2:
                if g.devices:
                    assert g.comm.counts == {"halo": 2 * %(iters)d,
                                             "all_reduce": %(iters)d}
            saved[case + ":fd"] = fd.numpy()
            saved[case + ":m"] = metrics
            saved[case + ":ranks"] = np.array([g.ranks for g in m2])
            saved[case + ":kinds"] = np.array(
                [type(g.comm).__name__ for g in m2])
        elif kind == "ckpt":                      # ckpt:n:body
            n, body = int(rest[0]), rest[1]
            m = M.stripe_mesh(n)
            path = os.path.join(out, f"state-{body}.npz")
            a = args + (6, m)
            res = C.solve_striped_checkpointed(*a, path, checkpoint_every=2,
                                               body=body)
            assert res.resumed_from == 0 and not os.path.exists(path)
            _, head, carry = stripes.striped_steps(*a, nsteps=4, body=body)
            C.save_state(path, C.gather_striped_carry(carry), 4,
                         C.striped_fingerprint(_geometry(datas, samps), n,
                                               body, 0.3, [0.001] * 3, 6,
                                               True))
            res2 = C.solve_striped_checkpointed(*a, path,
                                                checkpoint_every=100,
                                                body=body)
            assert res2.resumed_from == 4, res2.resumed_from
            distributed.barrier()
            assert not os.path.exists(path)
            saved[case + ":fd"] = res.fdata.numpy()
            saved[case + ":m"] = res.metrics
            saved[case + ":fd2"] = res2.fdata.numpy()
            saved[case + ":m2"] = np.concatenate([head, res2.metrics])
        elif kind == "cli":                       # cli:n
            from jpeg2png_tpu_torch.cli import main
            src = os.path.join("tests", "fixtures", "lineart64_q20_420.jpg")
            rc = main([src, "-o", os.path.join(out, f"cli{rank}.png"), "-i",
                       "2", "-q", "--tpu-stripes", rest[0],
                       "--tpu-distributed", "--device", "cpu"])
            assert rc == 0, rc
        elif kind == "gather":
            # unequal lists, shapes and dtypes per rank; over every rank,
            # then over the sub-group of the last two ranks
            mine = [torch.full((rank + 1, 3), float(rank)),
                    torch.arange(rank + 2, dtype=torch.int16)][:1 + rank %% 2]
            got = distributed.gather_to_primary(mine)
            if rank == 0:
                saved["gather:all"] = np.array(
                    [[t.float().sum().item() for t in ts] for ts in got],
                    dtype=object)
            else:
                assert got is None
            pair = distributed.sub_group((world - 2, world - 1))
            if rank >= world - 2:
                got = distributed.gather_to_primary(mine, pair)
                assert (got is None) == (rank != world - 2)
                if got is not None:
                    saved["gather:pair"] = np.array(
                        [[tuple(t.shape) for t in ts] for ts in got],
                        dtype=object)
                rows = distributed.gather_output(
                    torch.full((1, rank, 2), float(rank)), pair)
                saved["gather:rows"] = rows.numpy()
    np.savez(os.path.join(out, f"rank{rank}.npz"), **saved)
    distributed.barrier()
    print(f"rank {rank}: ok", flush=True)
""") % {"layout": LAYOUT, "batch": BATCH_LAYOUT, "iters": ITERS}


def run_processes(n, script, out_dir, env_extra=None, timeout=300):
    """`script` as n processes joined through the JPEG2PNG_* variables on
    a free localhost port; fails unless every one exits with 0 after
    printing 'rank i: ok'.  Returns their outputs."""
    port = _free_port()
    worker = out_dir / "worker.py"
    worker.write_text(script)
    procs = []
    for i in range(n):
        env = dict(os.environ, JPEG2PNG_COORDINATOR=f"localhost:{port}",
                   JPEG2PNG_NUM_PROCESSES=str(n), JPEG2PNG_PROCESS_ID=str(i),
                   JPEG2PNG_TEST_TMP=str(out_dir),
                   PYTHONPATH=REPO + os.pathsep + os.environ.get(
                       "PYTHONPATH", ""), **(env_extra or {}))
        procs.append(subprocess.Popen(
            [sys.executable, str(worker)], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("a multi-process run hung:\n" + "\n".join(outs))
    for i, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {i} failed:\n{o}"
        assert f"rank {i}: ok" in o
    return outs


CASES = {
    2: ["stripe:4:f32", "stripe:4:lite", "stripe:3:f32", "stripe:3:lite",
        "batch:f32", "batch:lite", "ckpt:4:f32", "ckpt:4:lite", "cli:4",
        "gather"],
    4: ["stripe:4:f32", "stripe:4:lite", "stripe:3:f32", "batch:f32",
        "batch:lite", "gather"],
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """runs(n): the worker's cases in n processes, run once per module:
    (n, the output directory, every rank's saved arrays)."""
    done = {}

    def get(n):
        if n not in done:
            out = tmp_path_factory.mktemp(f"procs{n}")
            run_processes(n, _WORKER, out, {"J2P_CASES": " ".join(CASES[n])})
            done[n] = (n, out, [dict(np.load(out / f"rank{r}.npz",
                                             allow_pickle=True))
                                for r in range(n)])
        return done[n]
    return get


def _args():
    datas, quants, samps = synth_channels(np.random.default_rng(3), LAYOUT)
    return datas, quants, samps, 0.3, [0.001] * 3


def _one_process(n, body, iters=ITERS):
    fd, m = stripes.solve_striped(*_args(), iters,
                                  mesh.stripe_mesh(n, ["cpu"] * n), body=body)
    return fd.numpy(), m


def _assert_stripe_case(run, n, body, own):
    procs, _, saved = run
    fd_1, m_1 = _one_process(n, body)
    for r in range(procs):
        got = saved[r]
        np.testing.assert_array_equal(got[f"stripe:{n}:{body}:fd"], fd_1)
        np.testing.assert_array_equal(got[f"stripe:{n}:{body}:m"], m_1)
        assert list(got[f"stripe:{n}:{body}:own"]) == own[r]


@pytest.mark.parametrize("procs", [2, 4])
@pytest.mark.parametrize("body", stripes.BODIES)
def test_torch_bands_over_processes(runs, procs, body):
    """4 bands as 2 processes x 2 bands, or 4 x 1: every rank's gathered
    canvas and metrics equal the one-process 4-band solve bit for bit, 3
    collectives per iteration (the worker checks the counts)."""
    own = ([[0, 2], [2, 2]] if procs == 2
           else [[r, 1] for r in range(4)])
    _assert_stripe_case(runs(procs), 4, body, own)


@pytest.mark.parametrize("procs", [2, 4])
def test_torch_uneven_bands_over_processes(runs, procs):
    """3 bands: 2 + 1 on two processes; 1 + 1 + 1 + none on four, where
    the last process holds no band but takes part in every all-reduce and
    the gathers, and gets the whole result too."""
    run = runs(procs)
    own = [[0, 2], [2, 1]] if procs == 2 else [[0, 1], [1, 1], [2, 1], [3, 0]]
    _assert_stripe_case(run, 3, "f32", own)
    if procs == 2:
        _assert_stripe_case(run, 3, "lite", own)


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(pl, "pallas_call", patched)


@pytest.mark.parametrize("procs", [2, 4])
@pytest.mark.parametrize("body", stripes.BODIES)
def test_torch_batch_stripe_mesh_over_processes(runs, procs, body,
                                                interpret_pallas):
    """batch_stripe_mesh(2, 2): over four processes each image's group is
    a sub-group of two; over two each group lies inside one process (a
    LocalComm).  Every rank gets [2, C, H, W] and [2, iterations, 4], each
    image equal to its own one-process solve_striped over 2 bands bit for
    bit, and the batch within test_torch_solve_striped_batched's
    tolerances of JAX's solve_striped_batched on the 8-device mesh."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh")
    _, _, saved = runs(procs)
    rng = np.random.default_rng(31 if body == "f32" else 5)
    d0, q0, samps = synth_channels(rng, BATCH_LAYOUT)
    d1, q1, _ = synth_channels(rng, BATCH_LAYOUT)
    datas, quants = [d0, d1], [q0, q1]
    refs = [stripes.solve_striped(datas[b], quants[b], samps, 0.3,
                                  [0.001] * 3, ITERS,
                                  mesh.stripe_mesh(2, ["cpu"] * 2), body=body)
            for b in range(2)]
    want_ranks = [[0, 1], [2, 3]] if procs == 4 else [[0], [1]]
    want_kind = "DistributedComm" if procs == 4 else "LocalComm"
    for r in range(procs):
        got = saved[r]
        fd, m = got[f"batch:{body}:fd"], got[f"batch:{body}:m"]
        assert fd.shape == (2, 3, 128, 128) and m.shape == (2, ITERS, 4)
        for b, (fd_1, m_1) in enumerate(refs):
            np.testing.assert_array_equal(fd[b], fd_1.numpy())
            np.testing.assert_array_equal(m[b], m_1)
        assert got[f"batch:{body}:ranks"].tolist() == want_ranks
        held = [b for b in range(2) if r in want_ranks[b]]
        assert [got[f"batch:{body}:kinds"][b] for b in held] == [want_kind]
        assert [got[f"batch:{body}:kinds"][b] for b in range(2)
                if b not in held] == ["NoneType"]
    jmesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("batch", "y"))
    fd_j, m_j = jstripes.solve_striped_batched(
        datas, quants, samps, 0.3, [0.001] * 3, ITERS, jmesh,
        use_pallas=body == "lite")
    np.testing.assert_allclose(saved[0][f"batch:{body}:m"], np.asarray(m_j),
                               rtol=5e-3, atol=1e-2)
    np.testing.assert_allclose(saved[0][f"batch:{body}:fd"], np.asarray(fd_j),
                               atol=0.5)


@pytest.mark.parametrize("body", stripes.BODIES)
def test_torch_checkpoint_two_bands_per_process(runs, body):
    """solve_striped_checkpointed over 2 processes x 2 bands (rank 0
    gathers both processes' two band carries), and a run cut after 4 of 6
    iterations and resumed from its snapshot: both equal the one-process
    4-band solve bit for bit on every rank."""
    _, _, saved = runs(2)
    fd_1, m_1 = _one_process(4, body, iters=6)
    for r in range(2):
        got = saved[r]
        for fd, m in (("fd", "m"), ("fd2", "m2")):
            np.testing.assert_array_equal(got[f"ckpt:4:{body}:{fd}"], fd_1)
            np.testing.assert_array_equal(got[f"ckpt:4:{body}:{m}"], m_1)


def test_torch_cli_four_stripes_on_two_processes(runs, fixtures_dir,
                                                 tmp_path):
    """cli --tpu-distributed --tpu-stripes 4 --device cpu on two processes
    stripes over 4 bands (no clamp to 2): rank 0 alone writes the PNG,
    equal to the one-process --tpu-stripes 4 decode."""
    from jpeg2png_tpu_torch.cli import main

    _, out, _ = runs(2)
    assert (out / "cli0.png").exists() and not (out / "cli1.png").exists()
    ref = tmp_path / "ref.png"
    assert main([str(fixtures_dir / "lineart64_q20_420.jpg"), "-o", str(ref),
                 "-i", "2", "-q", "--tpu-stripes", "4", "--device",
                 "cpu"]) == 0
    np.testing.assert_array_equal(np.asarray(Image.open(out / "cli0.png")),
                                  np.asarray(Image.open(ref)))


@pytest.mark.parametrize("procs", [2, 4])
def test_torch_gathers_with_unequal_shares(runs, procs):
    """gather_to_primary with lists of different lengths, shapes and
    dtypes per rank, over every process and over a sub-group of the last
    two (its first member receives); gather_output over that sub-group
    with a different row count per member."""
    _, _, saved = runs(procs)
    want = [[float(r) * (r + 1) * 3, float(sum(range(r + 2)))][:1 + r % 2]
            for r in range(procs)]
    assert saved[0]["gather:all"].tolist() == want
    lo = procs - 2
    assert saved[lo]["gather:pair"].tolist() == [
        [(lo + 1, 3), (lo + 2,)][:1 + lo % 2],
        [(lo + 2, 3), (lo + 3,)][:1 + (lo + 1) % 2]]
    for r in (lo, lo + 1):
        rows = saved[r]["gather:rows"]
        assert rows.shape == (1, lo + lo + 1, 2)
        np.testing.assert_array_equal(
            rows[0, :, 0], [lo] * lo + [lo + 1] * (lo + 1))


def test_torch_split_cards():
    """The card rule: processes that see the same cards split them in
    rank order; processes with cards of their own (per-process
    CUDA_VISIBLE_DEVICES, or two hosts) hold them; more processes than
    cards share one (NCCL refuses that); overlapping sets raise."""
    four = ["A", "B", "C", "D"]
    assert distributed.split_cards([four] * 4) == [[0], [1], [2], [3]]
    assert distributed.split_cards([four] * 2) == [[0, 1], [2, 3]]
    assert distributed.split_cards([four] * 3) == [[0], [1], [2, 3]]
    assert distributed.split_cards([four]) == [[0, 1, 2, 3]]
    assert distributed.split_cards([["A"], ["B"], ["C"]]) == [[0], [0], [0]]
    # two hosts of two cards, two processes each, ranks interleaved
    h1, h2 = ["A", "B"], ["C", "D"]
    assert distributed.split_cards([h1, h2, h1, h2]) == [[0], [0], [1], [1]]
    assert distributed.split_cards([["A"]] * 2) == [[0], [0]]
    with pytest.raises(ValueError, match="overlapping"):
        distributed.split_cards([["A", "B"], ["B", "C"]])


def test_torch_band_layout():
    """The first n global devices, process-major (jax.devices()[:n]):
    uneven layouts, processes with none, the CPU's even share, and more
    bands than devices refused."""
    assert distributed.band_layout(4, [2, 2]) == [(0, 2), (2, 2)]
    assert distributed.band_layout(3, [2, 2]) == [(0, 2), (2, 1)]
    assert distributed.band_layout(2, [2, 2]) == [(0, 2), (2, 0)]
    assert distributed.band_layout(4, [1, 1, 1, 1]) == [
        (0, 1), (1, 1), (2, 1), (3, 1)]
    assert distributed.band_layout(4, [None, None]) == [(0, 2), (2, 2)]
    assert distributed.band_layout(3, [None] * 4) == [
        (0, 1), (1, 1), (2, 1), (3, 0)]
    assert distributed.band_layout(5, [None] * 4) == [
        (0, 2), (2, 2), (4, 1), (5, 0)]
    with pytest.raises(ValueError, match="need 5 devices .* have 4"):
        distributed.band_layout(5, [2, 2])
