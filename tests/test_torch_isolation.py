"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, its entry points never fall back from the card to the CPU, and
its kernel wrappers never run the plain version on a CUDA tensor."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "jpeg2png_tpu_torch").rglob("*.py")) + sorted(
    (REPO / "tools").glob("torch_*.py")) + [REPO / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "jpeg2png_tpu")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_torch_port_source_imports_no_jax(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, names)


def test_torch_port_import_loads_no_jax():
    code = (
        "import sys\n"
        "import chip_smoke, jpeg2png_tpu_torch.cli, jpeg2png_tpu_torch.pipeline\n"
        "import jpeg2png_tpu_torch.models.solver, jpeg2png_tpu_torch.runner\n"
        "import jpeg2png_tpu_torch.kernels.iter_step\n"
        "import jpeg2png_tpu_torch.utils.corpus\n"
        "import jpeg2png_tpu_torch.parallel.stripes\n"
        "import jpeg2png_tpu_torch.parallel.distributed\n"
        "import jpeg2png_tpu_torch.parallel.mesh\n"
        "import jpeg2png_tpu_torch.utils.profiling\n"
        "import jpeg2png_tpu_torch.utils.timing\n"
        "import jpeg2png_tpu_torch.utils.debug\n"
        "import jpeg2png_tpu_torch.utils.compile_cache\n"
        "sys.path.insert(0, 'tools')\n"
        "import torch_bench, torch_bench_batch, torch_bench_tiers\n"
        "import torch_fuzz_reader, torch_measure_halo_rt\n"
        "import torch_profile_solve, torch_quality_eval\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'jpeg2png_tpu'))\n"
        "print(','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", out.stdout


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")


def test_torch_entry_points_refuse_without_card(no_card, fixtures_dir,
                                                tmp_path):
    from jpeg2png_tpu_torch.cli import main
    from jpeg2png_tpu_torch.io import read_jpeg
    from jpeg2png_tpu_torch.models.solver import (
        solve_joint, solve_joint_chunked)
    from jpeg2png_tpu_torch.pipeline import (
        decode_file, plain_decode, smooth_decode)
    from jpeg2png_tpu_torch.utils.config import SolverConfig

    src = fixtures_dir / "lineart64_q20_420.jpg"
    img = read_jpeg(src)
    args = ([p.data for p in img.planes], [p.quant for p in img.planes],
            [(p.h_samp, p.w_samp) for p in img.planes], 0.3, [0.001] * 3, 2)
    cfg = SolverConfig(iterations=(2,) * 3)
    calls = [
        lambda: solve_joint(*args),
        lambda: solve_joint_chunked(*args),
        lambda: smooth_decode(img, cfg),
        lambda: plain_decode(img),
        lambda: decode_file(str(src), str(tmp_path / "o.png"), cfg),
        lambda: main([str(src), "-o", str(tmp_path / "c.png"), "-q"]),
        lambda: smooth_decode(img, cfg, stripes=4),
        lambda: main([str(src), "-o", str(tmp_path / "c.png"), "-q",
                      "--tpu-stripes", "4"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no.*CUDA|CUDA.*none"):
            call()
    assert not (tmp_path / "o.png").exists()
    assert not (tmp_path / "c.png").exists()


class _CudaLooking(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to show which branch a
    wrapper takes for a CUDA tensor on a machine without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _cuda_looking(shape, dtype=torch.float32):
    return torch.Tensor._make_subclass(_CudaLooking,
                                       torch.zeros(shape, dtype=dtype))


def test_torch_wrappers_never_run_plain_on_cuda_tensors(monkeypatch, no_card):
    """Every kernel wrapper launches its kernel or raises for a CUDA
    tensor: K1, K2, K3 (f32 and lite), K4, K5, K6 and K7; their plain
    versions run only for CPU tensors."""
    from jpeg2png_tpu_torch.kernels import (grad_step, iter_step,
                                            project_step, stripe_grad)

    class PlainCalled(Exception):
        pass

    def plain_called(*a, **k):
        raise PlainCalled("plain version called for a CUDA tensor")

    for mod, name in ((grad_step, "fused_grad_plain"),
                      (project_step, "fused_project_multi_plain"),
                      (project_step, "fused_project_multi_lite_plain"),
                      (stripe_grad, "fused_grad_striped_lite_plain"),
                      (stripe_grad, "fused_grad_striped_plain"),
                      (project_step, "fused_project_plain"),
                      (iter_step, "fused_solve_plain"),
                      (iter_step, "fused_solve_lite_plain")):
        monkeypatch.setattr(mod, name, plain_called)
    f = _cuda_looking((3, 16, 32))
    d = _cuda_looking((1, 16, 32), torch.bfloat16)
    f1 = _cuda_looking((1, 16, 32))
    q = _cuda_looking((16, 32))
    los = [q, _cuda_looking((8, 16)), _cuda_looking((8, 16))]
    calls = [
        lambda: grad_step.fused_grad(f, f, [None] * 3, 0.5, 0.3),
        lambda: project_step.fused_project_multi(
            f, f, _cuda_looking((3,)), los, los, [None] * 3, [None] * 3,
            [0.0] * 3, [(1, 1), (2, 2), (2, 2)]),
        lambda: stripe_grad.fused_grad_striped_lite(
            f1, d, [], None, 0.5, 0, 0.3, [(1, 1)], [0.0], 16, 16, 32),
        lambda: stripe_grad.fused_grad_striped(
            f, f, [None] * 3, (_cuda_looking((3, 2, 32)),) * 4, 0.5, 16, 0.3,
            40, 32),
        lambda: project_step.fused_project(
            q, q, _cuda_looking((1,)), q, q, None, None, 0.0, 1, 1),
        lambda: project_step.fused_project_multi_lite(
            f1, d, d, 0.5, _cuda_looking((1,)), [q.to(torch.int16)], [q],
            [0.0], [(1, 1)]),
        lambda: iter_step.fused_solve(
            f1, f1, [], np.float32([0.0]), 1.0, [q.to(torch.int16)], [q],
            [0.0], [(1, 1)], 0.3),
        lambda: iter_step.fused_solve_lite(
            f1, d, [], np.float32([0.0]), 1.0, [q.to(torch.int16)], [q],
            [0.0], [(1, 1)], 0.3),
        lambda: iter_step.fused_solve(
            f1, f1, [], np.float32([0.0]), 1.0, [q.to(torch.int16)], [q],
            [0.0], [(1, 1)], 0.3, lite=True),
    ]
    for call in calls:
        with pytest.raises(Exception) as e:
            call()
        assert not isinstance(e.value, PlainCalled)
    for fn in (grad_step.fused_grad, project_step.fused_project_multi,
               project_step.fused_project_multi_lite,
               stripe_grad.fused_grad_striped_lite,
               stripe_grad.fused_grad_striped, project_step.fused_project,
               iter_step.fused_solve, iter_step.fused_solve_lite):
        assert fn.launches == 0


def test_torch_cpu_tensors_take_the_plain_version():
    from jpeg2png_tpu_torch.kernels import grad_step

    rng = np.random.default_rng(0)
    f = torch.as_tensor(rng.normal(0, 1, (2, 16, 24)).astype(np.float32))
    got = grad_step.fused_grad(f, f, [None, None], 0.0, 0.3)
    ref = grad_step.fused_grad_plain(f, f, [None, None], 0.0, 0.3)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert grad_step.fused_grad.launches == 0


def test_torch_host_decoder_is_plain_c():
    """The entropy decoder builds with a plain C compiler: standard
    headers only, no Python, PyTorch or CUDA."""
    import re

    src = (REPO / "jpeg2png_tpu_torch" / "csrc" / "jpeg_entropy.c").read_text()
    includes = set(re.findall(r'#include\s*[<"]([^>"]+)[>"]', src))
    assert includes <= {"stddef.h", "stdint.h", "string.h"}, includes
