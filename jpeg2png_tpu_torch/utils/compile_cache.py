"""Where the port's native libraries build, and the switch that keeps
nothing across processes.

The counterpart of jpeg2png_tpu/utils/compile_cache.py.  The JAX package
points XLA at an on-disk cache of compiled executables so that a one-shot
CLI process does not pay tens of seconds of Pallas compiles each time.
The port compiles its CUDA kernels and its host entropy decoder with
`nvcc` / `cc` at first use (kernels/_build.py); the built libraries,
named by a hash of source and flags, are that cache: a second process
loads them instead of compiling.  They live in the package's own
`_build/` directory (gitignored), beside the sources they come from.

`JPEG2PNG_TPU_NO_COMPILE_CACHE=1` keeps the JAX meaning, nothing persists
across processes: this process builds into a fresh temporary directory
of its own, removed when it exits.

The JAX package's other knobs have no counterpart here:
`JAX_COMPILATION_CACHE_DIR` and the `$XDG_CACHE_HOME/jpeg2png_tpu/xla`
default name a cache of XLA executables, which the port does not make;
neither moves the port's build directory.
"""

from __future__ import annotations

import atexit
import os
import pathlib
import shutil
import tempfile

PERSISTENT_DIR = pathlib.Path(__file__).resolve().parents[1] / "_build"
NO_CACHE_ENV = "JPEG2PNG_TPU_NO_COMPILE_CACHE"

_temporary: dict = {}     # pid -> this process's temporary build directory


def cache_dir() -> pathlib.Path:
    """The build directory for this process: PERSISTENT_DIR, or with
    JPEG2PNG_TPU_NO_COMPILE_CACHE set a temporary directory of this
    process (made on first use by kernels/_build.py, removed at exit)."""
    if not os.environ.get(NO_CACHE_ENV):
        return PERSISTENT_DIR
    pid = os.getpid()
    if pid not in _temporary:
        path = pathlib.Path(tempfile.gettempdir()) / (
            f"jpeg2png_tpu_torch_build-{pid}")
        _temporary[pid] = path
        atexit.register(shutil.rmtree, path, True)
    return _temporary[pid]


def enable_persistent_cache() -> pathlib.Path:
    """The directory the kernels build into, cache_dir() (the CLI calls
    this first, as the JAX CLI does; kernels/_build.py reads cache_dir()
    itself when imported, so the call moves nothing).  Never None: the
    port has no other way to its kernels than building them, so there is
    nothing to turn off, only where they persist."""
    return cache_dir()
