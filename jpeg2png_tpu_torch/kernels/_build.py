"""Builds the port's native libraries at first use and loads them with
ctypes.

Each source under jpeg2png_tpu_torch/csrc/ exports a plain C interface
(no PyTorch or Python headers).  The CUDA kernels (*.cu) compile with
`nvcc` in seconds each; the host JPEG entropy decoder (jpeg_entropy.c)
compiles with the C compiler ($CC, else `cc`) and needs no CUDA, so the
CPU tests build and run it too.  Libraries land in
jpeg2png_tpu_torch/_build/ (listed in .gitignore), named by a hash of
the source and the flags: an unchanged tree never rebuilds, and a
changed source never loads a stale library.  `build()` starts one
compiler per library, all at once, and waits for them; each writes a
temporary file that `os.replace` moves into place, so processes that
build the same library at once are harmless.  `builds` counts the
libraries compiled in this process (utils/timing.py's BuildCounter: a
warm pass must build nothing).  With JPEG2PNG_TPU_NO_COMPILE_CACHE set,
the libraries build into a temporary directory of this process instead
(utils/compile_cache.py).

The CUDA toolkit is found through $CUDA_HOME, then /usr/local/cuda, then
$PATH.  Nothing here runs when the package is imported: the CPU tests
import every module on a machine without `nvcc`.  A failed build raises
RuntimeError with the compiler's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

from jpeg2png_tpu_torch.utils.compile_cache import cache_dir

PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = cache_dir()

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMMON_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                "-Xptxas", "-v"]

# library name -> (source file under csrc/, extra nvcc flags)
LIBRARIES = {
    # K1 and K7.  -fmad=false: the stencil then rounds op for op like the
    # plain PyTorch version (no fused multiply-adds), so the two agree to a
    # few ulps and zero norms stay zero in both (the subgradient's 0/0 rule)
    "grad_step": ("grad_step.cu", ["-fmad=false"]),
    # K2 and K6
    "project_step": ("project_step.cu", []),
    # the whole solve (K3): its gradient tile is K1's, so the same rule
    "iter_step": ("iter_step.cu", ["-fmad=false"]),
    # the lite band gradient (K4): K1's march, the same rule
    "stripe_grad": ("stripe_grad.cu", ["-fmad=false"]),
    # the lite projection (K5): K2's transforms, fused multiply-adds on
    "project_lite": ("project_lite.cu", []),
}

# host libraries: name -> source file under csrc/, built with the C
# compiler ($CC, else cc)
HOST_LIBRARIES = {
    # the JPEG entropy decoder (io/jpeg_reader.py)
    "jpeg_entropy": "jpeg_entropy.c",
}
HOST_FLAGS = ["-std=c11", "-O2", "-shared", "-fPIC"]

_lock = threading.Lock()
_count_lock = threading.Lock()
_handles: dict = {}
# name -> compiler output of the last build in this process (ptxas prints
# each kernel's registers, shared memory and spills)
build_log: dict = {}
# libraries compiled in this process (under _count_lock)
builds = 0
# set by utils/debug.py: check_finite then checks every kernel wrapper's
# outputs and each solver iteration's carry
fp_traps = False


def nvcc_path() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built at first use and "
            "need the CUDA toolkit ($CUDA_HOME or /usr/local/cuda)")
    return found


def _source_flags(name: str):
    if name in HOST_LIBRARIES:
        return HOST_LIBRARIES[name], HOST_FLAGS
    src, extra = LIBRARIES[name]
    return src, ARCH_FLAGS + COMMON_FLAGS + extra


def _command(name: str, out: pathlib.Path) -> list:
    src, flags = _source_flags(name)
    if name in HOST_LIBRARIES:
        compiler = os.environ.get("CC") or "cc"
    else:
        compiler = nvcc_path()
    return [compiler, *flags, "-o", str(out), str(CSRC / src)]


def library_path(name: str) -> pathlib.Path:
    src, flags = _source_flags(name)
    h = hashlib.sha256((CSRC / src).read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> float:
    """Compile every library in `names` (default: all, CUDA and host)
    that is not built yet, one compiler process each, all started
    together.  Returns the seconds spent; raises RuntimeError with the
    compiler output if any build fails."""
    global builds
    names = ([*LIBRARIES, *HOST_LIBRARIES] if names is None
             else list(names))
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    failed = []
    for name in names:
        path = library_path(name)
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = _command(name, tmp)
        try:
            procs[name] = (path, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        except OSError as e:
            failed.append(f"--- {name} ({' '.join(cmd)}) ---\n{e}")
    for name, (path, tmp, proc) in procs.items():
        out, _ = proc.communicate()
        build_log[name] = out
        if proc.returncode != 0:
            failed.append(
                f"--- {name} ({proc.args[0]} exit {proc.returncode}) ---\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, path)   # atomic: a concurrent build is harmless
            with _count_lock:
                builds += 1
    if failed:
        raise RuntimeError("native library build failed:\n"
                           + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed."""
    with _lock:
        lib = _handles.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _handles[name] = lib
        return lib


def count_launch(wrapper, n: int = 1) -> None:
    """Add `n` to a kernel wrapper's `launches` count.  Wrappers launch
    from several host threads at once (one per card in the serving
    runner, one per image group in the batched striped solve), and
    `+=` on an attribute is not atomic: one lock guards every count."""
    with _count_lock:
        wrapper.launches += int(n)


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a cudaError_t returned by a launch (cudaGetLastError)."""
    if err != 0:
        fn = lib.j2p_error_string
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(
            f"{what}: CUDA launch failed: {fn(err).decode()} ({err})")


def check_finite(what: str, outputs, iteration=None):
    """Return `outputs`; first, while utils/debug.py's fp_exceptions is on,
    raise FloatingPointError if any tensor in them (nested lists and
    tuples; None and host numbers are skipped) holds a NaN or an Inf,
    naming `what` and the solver `iteration` (0-based) if given.  Off, it
    reads one flag.  Kernel wrappers pass their results through it
    (after a launch, or after the plain version on the CPU) and the solver
    loops their carry, so a trap names the first kernel or iteration that
    produced a non-finite value, not a temporary that torch.where discards
    (a zero norm's step / 0).  On a card the check synchronises."""
    if not fp_traps:
        return outputs
    import torch

    stack = [outputs]
    while stack:
        x = stack.pop()
        if isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, torch.Tensor) and not bool(torch.isfinite(x).all()):
            at = "" if iteration is None else f", iteration {iteration}"
            raise FloatingPointError(
                f"{what}{at}: non-finite value in a {tuple(x.shape)} "
                f"{x.dtype} output (fp_exceptions)")
    return outputs
