"""The two tier's iteration on fixed buffers (models/solver.py _TwoLoop):
on the CPU the eager body against the loop it replaced (host-float
factors, fresh tensors each iteration), bit for bit; on a card the CUDA
graph replay against the same body run eagerly, bit for bit (skipped
without a card).  The file imports no JAX: on a card's machine run it
with `python -m pytest --noconftest tests/test_torch_two_graph.py`."""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jpeg2png_tpu_torch.kernels import grad_step, iter_step  # noqa: E402
from jpeg2png_tpu_torch.kernels.grad_step import stack_channels  # noqa: E402
from jpeg2png_tpu_torch.kernels.project_step import (  # noqa: E402
    fused_project_multi)
from jpeg2png_tpu_torch.models import solver  # noqa: E402
from jpeg2png_tpu_torch.utils import profiling  # noqa: E402

torch.set_num_threads(2)

# (nby, nbx, sy, sx) per channel, weight, pweights
LAYOUTS = {
    "420": ([(4, 6, 1, 1), (2, 3, 2, 2), (2, 3, 2, 2)], 0.3, [0.001] * 3),
    "444": ([(3, 4, 1, 1)] * 3, 0.3, [0.001] * 3),
    # luma region smaller than the chroma region: a region gap
    "gap": ([(3, 5, 1, 1), (2, 3, 2, 2), (2, 3, 2, 2)], 0.3, [0.001] * 3),
    # one prob term off, TV only
    "mixed": ([(4, 4, 1, 1), (2, 2, 2, 2), (2, 2, 2, 2)], 0.0,
              [0.001, 0.0, 0.002]),
    "gray": ([(3, 3, 1, 1)], 0.3, [0.001]),
}


def problem(layout, seed=0, scale=1):
    """Random coefficients and quant tables; `scale` multiplies the block
    counts."""
    geoms, weight, pweights = layout
    rng = np.random.default_rng(seed)
    datas, quants, samps = [], [], []
    for nby, nbx, sy, sx in geoms:
        datas.append(rng.integers(-25, 25, (nby * scale, nbx * scale, 8, 8))
                     .astype(np.int16))
        quants.append(rng.integers(1, 80, (8, 8)).astype(np.uint16))
        samps.append((sy, sx))
    return datas, quants, samps, weight, pweights


def host_float_run(prob, carry, nsteps):
    """The two tier's loop as it was before the fixed buffers: the FISTA
    factor a host float, new tensors every iteration."""
    fdatas, fistas, pgrads, prob_dist, t = carry
    factors, t_final = iter_step.fista_factors(t, nsteps)
    prob_mask = [pa != 0.0 for pa in prob.p_alphas]
    dqs = [d if m else None for d, m in zip(prob.dqs_c, prob_mask)]
    iqs = [q if m else None for q, m in zip(prob.iqs_c, prob_mask)]
    rows = []
    for i in range(nsteps):
        it = iter(pgrads)
        pg_in = [next(it) if m else None for m in prob_mask]
        grads, extraps, sumsq, tv, tv2 = grad_step.fused_grad(
            fdatas, fistas, pg_in, float(factors[i]), prob.weight,
            h_true=prob.H, w_true=prob.W)
        norms = torch.sqrt(sumsq)
        scale = torch.where(norms == 0.0, 0.0, prob.step_size / norms)
        fnews, pgs, dists = fused_project_multi(
            extraps, grads, scale, prob.los, prob.his, dqs, iqs,
            prob.pa_sss, prob.samps)
        rows.append(torch.cat([sumsq, tv.reshape(1), tv2.reshape(1), dists]))
        pg_list = [p for p in pgs if p is not None]
        fistas, fdatas = fdatas, fnews
        pgrads = stack_channels(pg_list) if pg_list else pgrads
    metrics, dist_final = solver._metrics(prob, torch.stack(rows), prob_dist)
    return (fdatas, fistas, pgrads, dist_final, t_final), metrics


def assert_carries_equal(a, b):
    for x, y in zip(a[:3], b[:3]):
        assert torch.equal(x, y)
    assert a[3] == b[3] and a[4] == b[4]


@pytest.mark.parametrize("name", sorted(LAYOUTS))
@pytest.mark.parametrize("nsteps", [1, 6])
def test_torch_two_body_matches_host_float_loop(name, nsteps):
    """The eager body (factor table + device index, fixed buffers) equals
    the host-float loop bit for bit, in two chunks of one solve."""
    args = problem(LAYOUTS[name])
    prob = solver._build_problem(*args, 20, True, torch.device("cpu"))
    ref_prob = solver._build_problem(*args, 20, True, torch.device("cpu"))
    carry = solver._initial_carry(prob, "two")
    ref = solver._initial_carry(ref_prob, "two")
    for _ in range(2):
        carry, metrics = solver._run(prob, carry, nsteps, "two")
        ref, ref_metrics = host_float_run(ref_prob, ref, nsteps)
        assert_carries_equal(carry, ref)
        np.testing.assert_array_equal(metrics, ref_metrics)


@pytest.mark.parametrize("factor", [0.0, 0.2817542, 0.9613791])
def test_torch_plain_k1_factor_table_matches_host_float(factor):
    """K1's plain version reading factors[it] equals it with the host
    float, and writes the same values into given buffers."""
    rng = np.random.default_rng(3)
    C, H, W = 3, 16, 24
    f = torch.as_tensor(rng.normal(0, 50, (C, H, W)).astype(np.float32))
    fi = torch.as_tensor(rng.normal(0, 50, (C, H, W)).astype(np.float32))
    pg = torch.as_tensor(rng.normal(0, 1, (2, H, W)).astype(np.float32))
    pgs = [pg[0], None, pg[1]]
    table = torch.tensor([0.5, factor, 0.25], dtype=torch.float32)
    it = torch.tensor([1])
    want = grad_step.fused_grad(f, fi, pgs, float(table[1]), 0.3, 15, 20)
    bufs = (torch.empty_like(f), torch.empty_like(f), torch.empty(C + 2),
            None)
    got = grad_step.fused_grad(f, fi, pgs, (table, it), 0.3, 15, 20,
                               out=bufs)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got[0] is bufs[0] and got[1] is bufs[1]
    assert torch.equal(bufs[2], torch.cat([want[2], want[3].reshape(1),
                                           want[4].reshape(1)]))


def test_torch_two_loop_span_counts_eager_iterations_on_cpu():
    """The "solve.loop" span counts the two tier's iterations: none inside
    replays on the CPU, every one eager; chunks add up."""
    args = problem(LAYOUTS["420"])
    with profiling.collected("solve.loop") as loops:
        solver.solve_steps(*args, 7, device="cpu", tier="two")
        solver.solve_joint_chunked(*args, 11, chunk=4, device="cpu",
                                   tier="two")
        solver.solve_steps(*args, 3, device="cpu", tier="mega")
    counts = [(sp.attrs.get("graph_iters"), sp.attrs.get("eager_iters"))
              for sp in loops]
    assert counts == [(0, 7), (0, 11), (None, None)]


def test_torch_two_loop_refuses_a_carry_it_overwrote():
    """A carry handed out before the solve's last chunk holds a later
    iterate now: resuming from it raises instead of going on from the
    wrong state; the carry handed out last resumes."""
    args = problem(LAYOUTS["444"])
    prob = solver._build_problem(*args, 10, True, torch.device("cpu"))
    first, _ = solver._run(prob, solver._initial_carry(prob, "two"), 2, "two")
    second, _ = solver._run(prob, first, 2, "two")
    with pytest.raises(ValueError, match="overwrote"):
        solver._run(prob, first, 2, "two")
    solver._run(prob, second, 2, "two")


# ------------------------------------------------------------------ card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graph replays only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def two_solve(args, iterations, device, replays, monkeypatch, **kw):
    """solve_steps in the two tier with replays on or off -> (carry,
    metrics, graph_iters)."""
    with monkeypatch.context() as m:
        if not replays:
            m.setattr(solver, "_replays", lambda dev: False)
        with profiling.collected("solve.loop") as loops:
            _, metrics, carry = solver.solve_steps(
                *args, iterations, device=device, tier="two", **kw)
    return carry, metrics, sum(sp.attrs["graph_iters"] for sp in loops)


# 1536x1024 4:2:0, 4:4:4, a region gap
CARD_CASES = {
    "420_1536x1024": (LAYOUTS["420"], 32),
    "444": (LAYOUTS["444"], 24),
    "gap": (LAYOUTS["gap"], 24),
}


@pytest.mark.parametrize("case", sorted(CARD_CASES))
@pytest.mark.parametrize("nsteps", [1, 3, 37, 1000])
def test_torch_cuda_two_graph_replay_matches_eager(cuda_device, monkeypatch,
                                                   case, nsteps):
    """Replayed and eager iterations give the same carry and metric rows
    bit for bit (n = 1, n < GRAPH_ITERS, n odd, n = 1000), and the launch
    counters count every kernel run, replayed ones included."""
    layout, scale = CARD_CASES[case]
    args = problem(layout, seed=nsteps, scale=scale)
    want, want_m, _ = two_solve(args, nsteps, cuda_device, False,
                                monkeypatch)
    k1, k2 = grad_step.fused_grad.launches, fused_project_multi.launches
    got, got_m, graph_iters = two_solve(args, nsteps, cuda_device, True,
                                        monkeypatch)
    torch.cuda.synchronize()
    assert_carries_equal(got, want)
    np.testing.assert_array_equal(got_m, want_m)
    assert grad_step.fused_grad.launches - k1 == nsteps
    assert fused_project_multi.launches - k2 == nsteps
    if nsteps >= solver.GRAPH_ITERS + 1:
        assert graph_iters >= nsteps - solver.GRAPH_ITERS


def test_torch_cuda_two_graph_chunked_and_resumed(cuda_device, monkeypatch):
    """solve_joint_chunked (on_chunk after each chunk of 13) and a solve
    resumed from a returned carry, replayed, equal the eager one-shot."""
    args = problem(LAYOUTS["420"], seed=5, scale=32)
    want, want_m, _ = two_solve(args, 60, cuda_device, False, monkeypatch)
    seen = []
    fd, metrics = solver.solve_joint_chunked(
        *args, 60, on_chunk=lambda done, m: seen.append((done, m.shape[0])),
        chunk=13, device=cuda_device, tier="two")
    assert seen == [(13, 13), (26, 13), (39, 13), (52, 13), (60, 8)]
    assert torch.equal(fd, want[0])
    np.testing.assert_array_equal(metrics, want_m)
    _, m1, carry = solver.solve_steps(*args, 60, nsteps=25,
                                      device=cuda_device, tier="two")
    _, m2, carry = solver.solve_steps(*args, 60, carry=carry, nsteps=35,
                                      device=cuda_device, tier="two")
    assert_carries_equal(carry, want)
    np.testing.assert_array_equal(np.concatenate([m1, m2]), want_m)


def test_torch_cuda_two_graph_threads_capture_at_once(cuda_device,
                                                      monkeypatch):
    """Two threads solve at once, on two cards where there are two, else
    on one: each captures (thread-local) while the other launches, and
    each result equals its eager solve."""
    n = torch.cuda.device_count()
    devices = [torch.device("cuda", k % n) for k in range(2)]
    problems = [problem(LAYOUTS["420"], seed=10 + k, scale=24)
                for k in range(2)]
    wants = [two_solve(p, 50, d, False, monkeypatch)
             for p, d in zip(problems, devices)]
    got = [None, None]

    def solve(k):
        with torch.cuda.device(devices[k]):
            _, m, c = solver.solve_steps(*problems[k], 50, device=devices[k],
                                         tier="two")
            torch.cuda.synchronize()
            got[k] = (c, m)

    threads = [threading.Thread(target=solve, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for (c, m), (wc, wm, _) in zip(got, wants):
        assert_carries_equal(c, wc)
        np.testing.assert_array_equal(m, wm)
