"""The trace arithmetic on a synthetic event list, and the work count on
the port's known kernel shapes."""

import math

import pytest

from benchmark.trace import capture, intervals as iv
from benchmark.trace.work import canvas, least_seconds, work
from jpeg2png_tpu_torch.utils import profiling


def test_union_intersect_subtract():
    assert iv.union([[5, 6], [1, 3], [2, 4]]) == [[1, 4], [5, 6]]
    assert iv.intersect([[0, 4], [6, 9]], [[3, 7]]) == [[3, 4], [6, 7]]
    assert iv.subtract([[0, 10]], [[2, 3], [5, 7]]) == [[0, 2], [3, 5],
                                                        [7, 10]]
    assert iv.length([[0, 2], [3, 5]]) == 4


def test_names():
    assert iv.device_op_name(
        "void (anonymous namespace)::solve_kernel<3, false>(Params)") == (
        "K3/K3 lite solve_kernel")
    assert iv.device_op_name("void at::native::vectorized_elementwise_"
                             "kernel<4, at::native::sqrt_kernel_cuda>") == (
        "sqrt")
    assert iv.device_op_name("Memcpy DtoH (Device -> Pageable)") == (
        "copy device to host")
    assert iv.host_class("cudaStreamSynchronize") == "sync"
    assert iv.host_class("cudaMemcpyAsync") == "memcpy/alloc"
    assert iv.host_class("cudaLaunchKernel") == "launch"
    assert iv.host_class("cudaGetDevice") == "other CUDA API"


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


def test_summarize_a_synthetic_trace():
    """Two cards, a window marked by two synchronises at each end, from
    100 to 1100 us: card 0 busy 300 us (two overlapping kernels and a
    copy), card 1 busy 100 us; a launch and a synchronise on the host in
    the idle stretches."""
    mark = "cudaDeviceSynchronize"
    ev = [_x("cuda_runtime", mark, 90, 5), _x("cuda_runtime", mark, 95, 5),
          _x("kernel", "void anonymous::grad_kernel<3>(P)", 200, 100,
             device=0),
          _x("kernel", "void anonymous::project_kernel<3>(P)", 250, 100,
             device=0),
          _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 600, 50,
             device=0),
          _x("kernel", "void at::sqrt_kernel_cuda()", 400, 100, device=1),
          _x("cuda_runtime", "cudaLaunchKernel", 120, 70),
          _x("cuda_runtime", "cudaStreamSynchronize", 700, 300),
          _x("kernel", "before the window", 10, 20, device=0),
          _x("cuda_runtime", mark, 1090, 5),
          _x("cuda_runtime", mark, 1095, 5)]
    s = capture.summarize(ev, cards=2)
    assert s["window_s"] == pytest.approx(1000e-6)
    assert s["busy_s"] == pytest.approx([200e-6, 100e-6])
    assert s["kernel_s"] == pytest.approx(300e-6)
    names = dict(s["device_ops"])
    assert names["K1/K7 grad_kernel"] == pytest.approx(100e-6)
    assert names["copy device to host"] == pytest.approx(50e-6)
    # idle when no card is busy: 100-200, 350-400, 500-600, 650-1100
    gaps = s["idle_gaps"]
    assert [round(g[1] * 1e6) for g in gaps] == [450, 100, 100, 50]
    assert [g[0] for g in gaps] == ["sync", "launch", "python", "python"]
    # a card with no activity at all counts as idle
    three = ev + [_x("cuda_runtime", mark, 85, 5),
                  _x("cuda_runtime", mark, 1100, 5)]
    s3 = capture.summarize(three, cards=3)
    assert s3["window_s"] == pytest.approx(1005e-6)
    assert s3["busy_s"][2] == 0.0


@pytest.mark.parametrize("C,H,W,samps", [
    (3, 2048, 3072, [(1, 1), (2, 2), (2, 2)]),
    (3, 512, 512, [(1, 1), (2, 2), (2, 2)]),
    (3, 480, 720, [(1, 1), (1, 1), (1, 1)]),
    (3, 720, 960, [(1, 1), (1, 2), (1, 2)])])
@pytest.mark.parametrize("iterations", [50, 1000])
def test_work_is_the_port_kernels_count(C, H, W, samps, iterations):
    """Operations: K1 + K2 of one iteration times the iterations, as
    kernel_cost_table counts them; bytes: K3's whole solve."""
    table = profiling.kernel_cost_table(C, H, W, samps, nsteps=iterations)
    ops, nbytes = work(H, W, samps, iterations)
    assert ops == iterations * (table["K1"]["ops"] + table["K2"]["ops"])
    assert ops == table["K3"]["ops"]
    assert nbytes == table["K3"]["bytes"]
    t = max(ops / profiling.PEAK_F32, nbytes / profiling.PEAK_BYTES)
    assert least_seconds(H, W, samps, iterations) == pytest.approx(t)


def test_canvas_is_the_image_own():
    """A 4:2:0 image 160 x 120: luma 15 x 20 blocks, chroma 8 x 10 over
    2 x 2 samples: the canvas is 128 x 160, whatever bucket it lands in."""
    import numpy as np

    comps = [(np.zeros((15, 20, 8, 8)), None, (1, 1)),
             (np.zeros((8, 10, 8, 8)), None, (2, 2)),
             (np.zeros((8, 10, 8, 8)), None, (2, 2))]
    H, W, samps = canvas(comps)
    assert (H, W) == (128, 160)
    ops, _ = work(H, W, samps, 50)
    assert ops == 50 * (60 * 3 * 128 * 160 + 104 * (128 * 160 + 2 * 64 * 80))
    assert math.isclose(least_seconds(H, W, samps, 50), ops / 67e12)
