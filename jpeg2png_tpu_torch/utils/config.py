"""Solver configuration.

Mirrors the reference CLI semantics flag-for-flag (jpeg2png.c:177-357):
defaults w=0.3, p=0.001, i=50 (jpeg2png.c:22-24); per-channel triples
for w/p/i are only meaningful with separate-component solves; chroma
second-order weights default to 0 (jpeg2png.c:206).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

DEFAULT_WEIGHT = 0.3
DEFAULT_PWEIGHT = 0.001
DEFAULT_ITERATIONS = 50


@dataclasses.dataclass(frozen=True)
class ChannelSettings:
    """Per-channel solve settings (used in separate-components mode)."""
    weight: float = DEFAULT_WEIGHT
    pweight: float = DEFAULT_PWEIGHT
    iterations: int = DEFAULT_ITERATIONS


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    weights: Tuple[float, ...] = (DEFAULT_WEIGHT, 0.0, 0.0)
    pweights: Tuple[float, ...] = (DEFAULT_PWEIGHT,) * 3
    iterations: Tuple[int, ...] = (DEFAULT_ITERATIONS,) * 3
    separate_components: bool = False
    # Log prob_dist without its alpha factor, like the reference's SIMD
    # build (compute_simd_step.c:61); False logs the scalar-C semantics.
    simd_compat_logging: bool = True
    dtype: str = "float32"

    def channel(self, c: int) -> ChannelSettings:
        return ChannelSettings(
            weight=self.weights[min(c, len(self.weights) - 1)],
            pweight=self.pweights[min(c, len(self.pweights) - 1)],
            iterations=self.iterations[min(c, len(self.iterations) - 1)],
        )
