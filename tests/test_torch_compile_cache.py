"""utils/compile_cache.py: where the port's native libraries build (the
counterparts of tests/test_compile_cache.py's cases).

The port's "compilation cache" is its build directory: the libraries
kernels/_build.py compiles at first use, kept in the package's _build/
for the next process.  JPEG2PNG_TPU_NO_COMPILE_CACHE=1 keeps nothing
across processes: a temporary directory of this process, removed at exit.
JAX's own cache variables move nothing here.
"""

import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from jpeg2png_tpu_torch.kernels import _build  # noqa: E402
from jpeg2png_tpu_torch.utils import compile_cache  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_torch_default_location(monkeypatch, tmp_path):
    monkeypatch.delenv("JPEG2PNG_TPU_NO_COMPILE_CACHE", raising=False)
    # the JAX package's knobs name an XLA cache, not the port's builds
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "xla"))
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    path = compile_cache.enable_persistent_cache()
    assert path == REPO / "jpeg2png_tpu_torch" / "_build"
    assert path == compile_cache.PERSISTENT_DIR
    assert _build.library_path("jpeg_entropy").parent == _build.BUILD_DIR


def test_torch_kill_switch(monkeypatch):
    monkeypatch.setenv("JPEG2PNG_TPU_NO_COMPILE_CACHE", "1")
    path = compile_cache.enable_persistent_cache()
    assert path != compile_cache.PERSISTENT_DIR
    assert str(os.getpid()) in path.name
    assert compile_cache.cache_dir() == path       # one per process


def test_torch_kill_switch_keeps_nothing_across_processes(tmp_path):
    """A process with the switch builds into its own directory, which is
    gone when it exits."""
    code = ("import sys; sys.path.insert(0, '.')\n"
            "from jpeg2png_tpu_torch.kernels import _build\n"
            "_build.build(['jpeg_entropy'])\n"
            "assert _build.library_path('jpeg_entropy').exists()\n"
            "print(_build.library_path('jpeg_entropy'))\n")
    env = dict(os.environ, JPEG2PNG_TPU_NO_COMPILE_CACHE="1",
               TMPDIR=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lib = pathlib.Path(out.stdout.strip())
    assert lib.parent.parent == tmp_path
    assert lib.parent != compile_cache.PERSISTENT_DIR
    assert not lib.parent.exists()                 # removed at exit


def test_torch_cli_calls_enable_persistent_cache(monkeypatch, tmp_path):
    """cli.main calls enable_persistent_cache first, as the JAX CLI does."""
    from jpeg2png_tpu_torch import cli

    calls = []
    monkeypatch.setattr(compile_cache, "enable_persistent_cache",
                        lambda: calls.append(1) or compile_cache.cache_dir())
    out = tmp_path / "out.png"
    rc = cli.main([str(REPO / "tests" / "fixtures" / "lineart64_q20_420.jpg"),
                   "-o", str(out), "-i", "1", "-q", "--device", "cpu"])
    assert rc == 0 and out.exists()
    assert calls == [1]
