"""Color conversion for output.

canvas_pixels turns a solved canvas into output pixels.  It matches
write_png's YCbCr -> RGB with centered chroma and its exact
clamp-then-scale order (reference: png.c:37-62): luma has +128 re-added
by the decode loop first (jpeg2png.c:156-159), chroma stays centered at 0,
each RGB value is clamped to [0, 255] and only then scaled by
bitfactor = (1 << bits) / 256, so 16-bit white is 65280, not 65535.
The float -> unsigned C cast truncates toward zero; the values are
non-negative, so a cast to int32 on the device does the same, and the
host packs to uint8/uint16 (PyTorch's uint16 has few operations).
The casts and the copy between are the "fetch" span, which counts the
bytes copied.
"""

from __future__ import annotations

import numpy as np
import torch

from jpeg2png_tpu_torch.utils import profiling


def _pack(x: torch.Tensor, bits: int) -> np.ndarray:
    with profiling.span("fetch") as sp:
        out = x.to(torch.int32)
        profiling.count(sp, "bytes", out.nbytes)
        return out.cpu().numpy().astype(np.uint8 if bits == 8
                                        else np.uint16)


def ycbcr_to_rgb_packed(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
                        bits: int = 8) -> np.ndarray:
    """[H, W] channels (luma already +128) -> [H, W, 3] uint8/uint16."""
    r = y + 1.402 * cr
    g = y - 0.34414 * cb - 0.71414 * cr
    b = y + 1.772 * cb
    rgb = torch.stack([r, g, b], dim=-1).clamp(0.0, 255.0)
    return _pack(rgb * ((1 << bits) / 256.0), bits)


def gray_packed(y: torch.Tensor, bits: int = 8) -> np.ndarray:
    """Grayscale output (capability beyond the 3-component-only reference)."""
    return _pack(y.clamp(0.0, 255.0) * ((1 << bits) / 256.0), bits)


def canvas_pixels(channels, img, bits: int = 8) -> np.ndarray:
    """A solved canvas -> output pixels, one fetch: `channels` ([C, H, W],
    or C [H, W] planes; luma without its +128) cropped to the image's
    height x width (`img`: a JpegImage), luma's +128 re-added
    (jpeg2png.c:156-159), then gray, or YCbCr -> RGB for three channels."""
    h, w = img.height, img.width
    y = channels[0][:h, :w] + 128.0
    if len(channels) == 1:
        return gray_packed(y, bits)
    return ycbcr_to_rgb_packed(y, channels[1][:h, :w], channels[2][:h, :w],
                               bits)
