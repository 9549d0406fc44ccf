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
PORT_FILES = sorted((REPO / "jpeg2png_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


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


def _cuda_looking(shape):
    return torch.Tensor._make_subclass(_CudaLooking, torch.zeros(shape))


def test_torch_wrappers_never_run_plain_on_cuda_tensors(monkeypatch, no_card):
    from jpeg2png_tpu_torch.kernels import grad_step, project_step

    class PlainCalled(Exception):
        pass

    def plain_called(*a, **k):
        raise PlainCalled("plain version called for a CUDA tensor")

    monkeypatch.setattr(grad_step, "fused_grad_plain", plain_called)
    monkeypatch.setattr(project_step, "fused_project_multi_plain",
                        plain_called)
    f = _cuda_looking((3, 16, 32))
    with pytest.raises(Exception) as e:
        grad_step.fused_grad(f, f, [None] * 3, 0.5, 0.3)
    assert not isinstance(e.value, PlainCalled)
    los = [_cuda_looking((16, 32)), _cuda_looking((8, 16)),
           _cuda_looking((8, 16))]
    with pytest.raises(Exception) as e:
        project_step.fused_project_multi(
            f, f, _cuda_looking((3,)), los, los, [None] * 3, [None] * 3,
            [0.0] * 3, [(1, 1), (2, 2), (2, 2)])
    assert not isinstance(e.value, PlainCalled)
    assert grad_step.fused_grad.launches == 0
    assert project_step.fused_project_multi.launches == 0


def test_torch_cpu_tensors_take_the_plain_version():
    from jpeg2png_tpu_torch.kernels import grad_step

    rng = np.random.default_rng(0)
    f = torch.as_tensor(rng.normal(0, 1, (2, 16, 24)).astype(np.float32))
    got = grad_step.fused_grad(f, f, [None, None], 0.0, 0.3)
    ref = grad_step.fused_grad_plain(f, f, [None, None], 0.0, 0.3)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert grad_step.fused_grad.launches == 0
