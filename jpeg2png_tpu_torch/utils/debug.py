"""Numeric debugging: the port's counterpart of the reference's FP traps.

The reference's DEBUG builds trap FE_DIVBYZERO/OVERFLOW/INVALID with
glibc feenableexcept (fp_exceptions.c:9-14) to catch norm-zero division
bugs; the JAX package turns on jax_debug_nans/jax_debug_infs
(jpeg2png_tpu/utils/debug.py), which check the outputs of each jitted
computation.  The port checks the same places: the outputs of every
kernel wrapper (kernels/_build.py::check_finite, after a launch or after
the plain version on the CPU) and the carry after each iteration of the
four solver tiers and both striped bodies (after each launch of K3, whose
iterations run inside one launch).  It does not trap every PyTorch op:
the loops compute torch.where(norms == 0, 0, step / norms), whose
discarded branch is Inf on a flat channel, and the solver is written so
that zero norms take the subgradient's 0 and nothing non-finite reaches
an output (compute.c:97, :158, :211).  The first non-finite value raises
FloatingPointError.  On a card each check synchronises: a debug mode.
"""

from __future__ import annotations

import contextlib

from jpeg2png_tpu_torch.kernels import _build


@contextlib.contextmanager
def fp_exceptions(enable: bool = True):
    """Context manager: raise FloatingPointError on the first NaN or Inf
    a kernel or a solver iteration produces; the previous state returns
    on exit."""
    if not enable:
        yield
        return
    old = _build.fp_traps
    _build.fp_traps = True
    try:
        yield
    finally:
        _build.fp_traps = old


def enable_fp_exceptions() -> None:
    """Process-wide enable (mirrors enable_fp_exceptions, jpeg2png.c:178)."""
    _build.fp_traps = True
