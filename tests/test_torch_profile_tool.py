"""tools/torch_profile_solve.py and utils/profiling.py's trace and cost
tables.

On the CPU the tool's timings are the plain versions' host ops (no card,
no device activity): the gate is that it runs the two tier and the
striped solve and prints its "us/iter" lines.  trace_breakdown's
arithmetic is held on a hand-made trace; kernel_cost_table against a
count by hand.
"""

import json
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from jpeg2png_tpu_torch.utils import profiling  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
TOOL = REPO / "tools" / "torch_profile_solve.py"


@pytest.mark.parametrize("extra", [["--tier", "two"], ["--striped", "2"]],
                         ids=["two", "striped2"])
def test_torch_profile_solve_smoke(tmp_path, extra):
    keep = tmp_path / "trace" / "keep.txt"   # not the tool's: left alone
    keep.parent.mkdir()
    keep.write_text("x")
    out = subprocess.run(
        [sys.executable, str(TOOL), "--nby", "8", "--nbx", "16", "--iters",
         "2", "--device", "cpu", "--trace-dir", str(tmp_path / "trace"),
         *extra],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
             "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    assert sum("us/iter" in line for line in lines) >= 3, out.stdout
    res = json.loads(lines[-1])
    assert res["device"].startswith("cpu") and res["breakdown"] is None
    assert res["host_ops_us_per_iter"]
    assert (tmp_path / "trace" / "trace.json").exists()
    assert keep.read_text() == "x"


def test_torch_profile_solve_refuses_without_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
    out = subprocess.run(
        [sys.executable, str(TOOL), "--nby", "8", "--nbx", "16"],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert out.returncode != 0 and "RuntimeError" in out.stderr


def test_torch_kernel_cost_table_by_hand():
    # a 16 x 32 4:2:0 canvas, every prob term on: 512 luma pixels a plane,
    # 512 luma and 2 x 128 chroma coefficients
    t = profiling.kernel_cost_table(3, 16, 32, [(1, 1), (2, 2), (2, 2)])
    # K1: f, fista (3 planes each) and the prob gradients (3) in, grad and
    # extrap (3 each) out, 5 sums out; 60 operations a pixel and channel
    k1_bytes = 4 * 512 * (3 + 3 + 3) + 4 * 512 * 6 + 4 * 5
    assert t["K1"]["bytes"] == k1_bytes == 30740
    assert t["K1"]["ops"] == 60 * 3 * 512
    # K2: extrap and grad in (6 planes), f and the prob gradients out (6
    # planes); lo, hi, dq, 1/q (16 bytes) per coefficient; 104 operations a
    # coefficient
    k2_bytes = 4 * 512 * 6 + 4 * 512 * 6 + 16 * (512 + 128 + 128)
    assert t["K2"]["bytes"] == k2_bytes == 36864
    assert t["K2"]["ops"] == 104 * (512 + 128 + 128)
    for k in ("K1", "K2"):
        ms = max(t[k]["bytes"] / 3.35e12, t[k]["ops"] / 67e12) * 1e3
        assert t[k]["bound_ms"] == pytest.approx(ms, rel=1e-12)
    assert t["K1"]["bound_by"] == "bytes"
    # K7 on bands of 8 rows: K1's count on 8 x 32 plus the four [3, 2, 32]
    # halo arrays
    t8 = profiling.kernel_cost_table(3, 16, 32, [(1, 1), (2, 2), (2, 2)],
                                     band_rows=8)
    assert t8["K7"]["bytes"] == (4 * 256 * 9 + 4 * 256 * 6 + 4 * 5
                                 + 4 * 4 * 3 * 2 * 32)


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "pid": 1, "args": args}


def test_torch_trace_breakdown_on_a_hand_made_trace():
    events = [
        _x(profiling.WINDOW, "user_annotation", 0, 1000),
        # K1 launched through ctypes (no aten op around it), then a sqrt
        _x("cudaLaunchKernel", "cuda_runtime", 10, 5, correlation=1),
        _x("void (anonymous namespace)::grad_kernel<3, true>(Params)",
           "kernel", 20, 200, tid=7, stream=7, correlation=1),
        _x("aten::sqrt", "cpu_op", 290, 30),
        _x("cudaLaunchKernel", "cuda_runtime", 300, 5, correlation=2),
        _x("void at::native::vectorized_elementwise_kernel<4, at::native::"
           "sqrt_kernel_cuda(at::TensorIteratorBase&)>(int)",
           "kernel", 330, 10, tid=7, stream=7, correlation=2),
        _x("cudaStreamSynchronize", "cuda_runtime", 400, 590),
    ]
    bd = profiling.trace_breakdown(events, 2, {"fused_grad": 2})
    assert bd["wall_us"] == 500
    assert bd["kernels"] == {"K1": {"us": 100.0, "launches": 0.5,
                                    "by_name": {"grad_kernel": 100.0}}}
    assert bd["small_ops"] == {"sqrt": {"us": 5.0, "launches": 0.5}}
    assert bd["device_busy_us"] == 105 and bd["idle_us"] == 395
    # gaps [0, 20], [220, 330], [340, 1000]: sync 590, launches 5 + 5, the
    # sqrt op's host time 30 - 5, the rest Python
    assert bd["host_in_idle_us"] == {
        "sync": 295.0, "memcpy/alloc": 0.0, "launch": 5.0,
        "other CUDA API": 0.0, "torch ops": 12.5, "python": 82.5}
    assert bd["launch_to_start_us"] == {"median": 30, "max": 30}
    assert bd["cuda_calls"] == {"cudaLaunchKernel": 1.0,
                                "cudaStreamSynchronize": 0.5}
    # the whole window around the one hand-written kernel [20, 220]
    assert bd["timeline_us"] == {
        "before_first_kernel": 20, "device_busy_before": 0,
        "first_to_last_kernel": 200, "device_idle_within": 0,
        "after_last_kernel": 780}
    # the same kernel launched by K7's wrapper, or by either
    assert "K7" in profiling.trace_breakdown(
        events, 2, {"fused_grad_striped": 2})["kernels"]
    assert "K1/K7" in profiling.trace_breakdown(events, 2)["kernels"]
    assert any("us/iter" in line
               for line in profiling.format_breakdown(bd))


def test_torch_trace_breakdown_splits_the_loop_window():
    """The loop window (first hand-written kernel's start to the last
    one's end) splits into its kernels, the small ops and the gaps inside
    it, and nothing of the set-up before it or the fetch after it."""
    events = [
        _x(profiling.WINDOW, "user_annotation", 0, 1000),
        _x("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 5, 40),
        _x("void (anonymous namespace)::grad_kernel<3, true>(Params)",
           "kernel", 100, 200, tid=7, stream=7),
        _x("void at::native::vectorized_elementwise_kernel<4, at::native::"
           "sqrt_kernel_cuda(at::TensorIteratorBase&)>(int)",
           "kernel", 310, 10, tid=7, stream=7),
        _x("void (anonymous namespace)::project_kernel<3>(Params)",
           "kernel", 340, 300, tid=7, stream=7),
        _x("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 700, 20),
    ]
    bd = profiling.trace_breakdown(events, 2)
    # [100, 640]: K1 200 + sqrt 10 + K2 300 + gaps 10 and 20, over 2
    assert bd["loop_us"] == {"kernels": {"K1/K7": 100.0, "K2": 150.0},
                             "small_ops": 5.0, "idle": 15.0, "sum": 270.0,
                             "wall": 270.0}
    assert bd["timeline_us"]["before_first_kernel"] == 100
    assert bd["timeline_us"]["after_last_kernel"] == 360
    assert profiling.trace_breakdown(
        [_x(profiling.WINDOW, "user_annotation", 0, 10)], 1)["loop_us"] is None
    assert any("loop (first to last" in line
               for line in profiling.format_breakdown(bd))


def test_torch_device_trace_on_cpu(tmp_path):
    x = torch.ones(64)
    with profiling.device_trace(tmp_path, "cpu") as prof:
        torch.sqrt(x) + 1
    assert (tmp_path / "trace.json").exists()
    bd = profiling.trace_breakdown(prof, 1)
    assert bd["launches"] == 0 and bd["wall_us"] > 0
    assert "aten::sqrt" in profiling.host_op_totals(prof, 1)
