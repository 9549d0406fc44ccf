"""The port's multi-process striped solve: two gloo processes on localhost.

Each process joins the group through
jpeg2png_tpu_torch.parallel.distributed.initialize (the JPEG2PNG_*
environment variables), holds one band, and runs solve_striped, whose halo
exchanges and all-reduce cross the process boundary, then gather_output
and a `--tpu-stripes 2 --tpu-distributed` CLI decode.  The test holds the
gathered result against the same solve with both bands in this process,
and checks that only rank 0 writes the PNG and the CSV.  Each process has
a time limit of its own, so a hung collective fails the test.
"""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from PIL import Image  # noqa: E402

from test_torch_solver import synth_channels  # noqa: E402

LAYOUT = [(13, 16, 1, 1), (7, 8, 2, 2), (7, 8, 2, 2)]   # 112 x 128, 4:2:0

_WORKER = textwrap.dedent("""
    import os, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, "tests")
    from test_torch_solver import synth_channels
    from jpeg2png_tpu_torch.parallel import distributed
    from jpeg2png_tpu_torch.parallel.mesh import stripe_mesh
    from jpeg2png_tpu_torch.parallel.stripes import solve_striped

    rank, world = distributed.initialize(device="cpu")
    assert world == 2 and distributed.is_multi_process()
    assert distributed.is_primary() == (rank == 0)
    assert distributed.initialize(device="cpu") == (rank, 2)   # idempotent
    mesh = stripe_mesh()
    assert mesh.n == 2 and mesh.first == rank, mesh
    datas, quants, samps = synth_channels(np.random.default_rng(3),
                                          %(layout)r)
    fd, m = solve_striped(datas, quants, samps, 0.3, [0.001] * 3, 3, mesh)
    assert mesh.comm.counts == {"halo": 6, "all_reduce": 3}, mesh.comm.counts
    # this rank's rows of the 112-row canvas: bands of 64 rows
    assert fd.shape == (3, 64 if rank == 0 else 48, 128), fd.shape
    full = distributed.gather_output(fd)
    assert distributed.gather_output(m) is m      # numpy passes through
    out = os.environ["JPEG2PNG_TEST_TMP"]
    np.savez(os.path.join(out, f"solve{rank}.npz"), fd=full.numpy(), m=m)

    from jpeg2png_tpu_torch.cli import main
    src = os.path.join("tests", "fixtures", "lineart64_q20_420.jpg")
    rc = main([src, "-o", os.path.join(out, f"cli{rank}.png"), "-i", "2",
               "-q", "-c", os.path.join(out, f"cli{rank}.csv"),
               "--tpu-stripes", "2", "--tpu-distributed", "--device", "cpu"])
    assert rc == 0, rc
    distributed.barrier()
    print(f"rank {rank}: ok", flush=True)
""") % {"layout": LAYOUT}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start_pair(worker, out_dir):
    """Two processes of `worker` joined through the JPEG2PNG_* variables
    on a free localhost port."""
    port = _free_port()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = []
    for i in range(2):
        env = dict(os.environ)
        env.update({
            "JPEG2PNG_COORDINATOR": f"localhost:{port}",
            "JPEG2PNG_NUM_PROCESSES": "2",
            "JPEG2PNG_PROCESS_ID": str(i),
            "JPEG2PNG_TEST_TMP": str(out_dir),
            "PYTHONPATH": repo + os.pathsep + env.get("PYTHONPATH", ""),
        })
        procs.append(subprocess.Popen(
            [sys.executable, str(worker)], env=env, cwd=repo,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def _finish(pairs):
    """Wait for every pair; fails unless every process exits with 0 after
    printing 'rank i: ok'."""
    procs = [p for pair in pairs for p in pair]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("a multi-process run hung:\n" + "\n".join(outs))
    for k, p in enumerate(procs):
        i = k % 2
        assert p.returncode == 0, f"rank {i} failed:\n{outs[k]}"
        assert f"rank {i}: ok" in outs[k]


def _run_two_processes(tmp_path, script):
    """`script` in two processes joined through the JPEG2PNG_* variables
    on a free localhost port; fails unless both print 'rank i: ok'."""
    worker = tmp_path / "worker.py"
    worker.write_text(script)
    _finish([_start_pair(worker, tmp_path)])


def test_torch_two_process_striped_solve(tmp_path, fixtures_dir):
    from jpeg2png_tpu_torch.cli import main
    from jpeg2png_tpu_torch.parallel.mesh import stripe_mesh
    from jpeg2png_tpu_torch.parallel.stripes import solve_striped

    _run_two_processes(tmp_path, _WORKER)

    # the same solve with both bands in this process: the halo rows and
    # the two-term all-reduce are the same numbers, so the results agree
    # to rounding (rtol 1e-6)
    datas, quants, samps = synth_channels(np.random.default_rng(3), LAYOUT)
    fd_1, m_1 = solve_striped(datas, quants, samps, 0.3, [0.001] * 3, 3,
                              stripe_mesh(2, ["cpu"] * 2))
    for r in range(2):
        got = np.load(tmp_path / f"solve{r}.npz")
        assert got["fd"].shape == (3, 112, 128)
        np.testing.assert_allclose(got["fd"], fd_1.numpy(), rtol=1e-6,
                                   atol=1e-4)
        np.testing.assert_allclose(got["m"], m_1, rtol=1e-6)

    # rank 0 alone wrote the PNG and the CSV; the pixels are the
    # one-process two-band decode's
    assert (tmp_path / "cli0.png").exists() and (tmp_path / "cli0.csv").exists()
    assert not (tmp_path / "cli1.png").exists()
    assert not (tmp_path / "cli1.csv").exists()
    ref = tmp_path / "ref.png"
    assert main([str(fixtures_dir / "lineart64_q20_420.jpg"), "-o", str(ref),
                 "-i", "2", "-q", "--tpu-stripes", "2", "--device",
                 "cpu"]) == 0
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "cli0.png")),
                                  np.asarray(Image.open(ref)))


_CKPT_WORKER = textwrap.dedent("""
    import os, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, "tests")
    from test_torch_solver import synth_channels
    from jpeg2png_tpu_torch.models import checkpoint as C
    from jpeg2png_tpu_torch.models.solver import _geometry
    from jpeg2png_tpu_torch.parallel import distributed
    from jpeg2png_tpu_torch.parallel.mesh import stripe_mesh
    from jpeg2png_tpu_torch.parallel.stripes import striped_steps

    rank, world = distributed.initialize(device="cpu")
    mesh = stripe_mesh()
    datas, quants, samps = synth_channels(np.random.default_rng(3),
                                          %(layout)r)
    out = os.environ["JPEG2PNG_TEST_TMP"]
    ckpt = os.path.join(out, "state.npz")
    # every snapshot this process writes ends in the os.replace
    writes = []
    replace = os.replace
    os.replace = lambda a, b: (writes.append(b), replace(a, b))[1]

    body = os.environ["JPEG2PNG_TEST_BODY"]
    args = (datas, quants, samps, 0.3, [0.001] * 3, 6, mesh)
    res = C.solve_striped_checkpointed(*args, ckpt, checkpoint_every=2,
                                       body=body)
    assert res.resumed_from == 0 and not os.path.exists(ckpt)
    # a crash after 4 of 6 iterations: the snapshot of the gathered bands
    _, m_first, carry = striped_steps(*args, nsteps=4, body=body)
    C.save_state(ckpt, C.gather_striped_carry(carry), 4,
                 C.striped_fingerprint(_geometry(datas, samps), 2, body,
                                       0.3, [0.001] * 3, 6, True))
    assert os.path.exists(ckpt)
    res2 = C.solve_striped_checkpointed(*args, ckpt, checkpoint_every=100,
                                        body=body)
    assert res2.resumed_from == 4, res2.resumed_from
    distributed.barrier()
    assert not os.path.exists(ckpt)
    np.savez(os.path.join(out, f"ckpt{rank}.npz"), fd=res.fdata.numpy(),
             m=res.metrics, fd2=res2.fdata.numpy(),
             m2=np.concatenate([m_first, res2.metrics]),
             writes=np.array(writes, dtype=str))
    print(f"rank {rank}: ok", flush=True)
""") % {"layout": LAYOUT}


@pytest.mark.parametrize("body", ["f32", "lite"])
def test_torch_two_process_striped_checkpoint(tmp_path, monkeypatch, body):
    """solve_striped_checkpointed over two gloo processes, one band each,
    either body (the lite carry's bf16 state crosses the gather as bytes):
    only rank 0 writes the snapshots (two in a 6-iteration run chunked by
    2, then the simulated crash's), both ranks resume from the one file,
    the gathered results equal the single-process striped solve bit for
    bit, and the file is gone at the end."""
    from jpeg2png_tpu_torch.parallel.mesh import stripe_mesh
    from jpeg2png_tpu_torch.parallel.stripes import solve_striped

    monkeypatch.setenv("JPEG2PNG_TEST_BODY", body)
    _run_two_processes(tmp_path, _CKPT_WORKER)
    datas, quants, samps = synth_channels(np.random.default_rng(3), LAYOUT)
    fd_1, m_1 = solve_striped(datas, quants, samps, 0.3, [0.001] * 3, 6,
                              stripe_mesh(2, ["cpu"] * 2), body=body)
    ckpt = str(tmp_path / "state.npz")
    for r in range(2):
        got = np.load(tmp_path / f"ckpt{r}.npz")
        assert list(got["writes"]) == ([ckpt] * 3 if r == 0 else [])
        for fd, m in ((got["fd"], got["m"]), (got["fd2"], got["m2"])):
            np.testing.assert_array_equal(fd, fd_1.numpy())
            np.testing.assert_array_equal(m, m_1)
    assert not (tmp_path / "state.npz").exists()


_EXIT_WORKER = textwrap.dedent("""
    import torch
    torch.set_num_threads(1)
    from jpeg2png_tpu_torch.parallel import distributed

    rank, world = distributed.initialize(device="cpu")
    comm = distributed.DistributedComm()
    x = torch.full((3, 8, 64), float(rank + 1))
    for _ in range(3):
        got = comm.shift_down([x])[0]
        assert float(got.sum()) == (1.0 * 3 * 8 * 64 if rank == 1 else 0.0)
        comm.shift_up([x])
    assert float(comm.all_reduce([x])[0][0, 0, 0]) == 3.0
    assert comm.counts == {"halo": 6, "all_reduce": 1}
    print(f"rank {rank}: ok", flush=True)
    # and out at once: the exit hook leaves the group
""")


def test_torch_gloo_pairs_leave_the_group_at_exit(tmp_path):
    """Eight gloo pairs at once, each doing a few halo exchanges and an
    all-reduce and then exiting at once: every process exits with 0.
    Without shutdown() at exit, a process under this load could abort
    after its work ("terminate called without an active exception",
    returncode -6) while the backend's threads were still running."""
    worker = tmp_path / "worker.py"
    worker.write_text(_EXIT_WORKER)
    _finish([_start_pair(worker, tmp_path) for _ in range(8)])


_CLI_WORKER = textwrap.dedent("""
    import os
    import torch
    torch.set_num_threads(1)
    from jpeg2png_tpu_torch.cli import main
    from jpeg2png_tpu_torch.parallel import distributed

    out = os.environ["JPEG2PNG_TEST_TMP"]
    rank = int(os.environ["JPEG2PNG_PROCESS_ID"])
    assert not distributed.is_joined()
    src = os.path.join("tests", "fixtures", "lineart64_q20_420_arith.jpg")
    rc = main([src, "-o", os.path.join(out, f"cli{rank}.png"), "-i", "2",
               "-q", "--tpu-stripes", "2", "--tpu-distributed", "--device",
               "cpu"])
    assert rc == 0, rc
    # main joined the group itself, so it left it before returning
    assert not distributed.is_joined()
    distributed.shutdown()                  # idempotent outside a group
    distributed.barrier()                   # a single process: a no-op
    print(f"rank {rank}: ok", flush=True)
""")


def test_torch_cli_leaves_the_group_it_joined(tmp_path):
    """cli.main --tpu-distributed, called outside a group, joins one and
    leaves it before returning; rank 0 alone writes the PNG."""
    worker = tmp_path / "worker.py"
    worker.write_text(_CLI_WORKER)
    _finish([_start_pair(worker, tmp_path)])
    assert (tmp_path / "cli0.png").exists()
    assert not (tmp_path / "cli1.png").exists()
