"""jpeg2png_tpu_torch — the JPEG smart decoder on PyTorch and CUDA.

Given a JPEG, find the smoothest image that re-encodes to exactly the
same JPEG, by minimizing

    TV(u) + w * TGV2(u) + p * ||(DCT(u - u0)) / quant||^2

over the feasible set Q = { u : DCT(u) in [(k-0.5)q, (k+0.5)q] } with a
FISTA-accelerated projected subgradient method (reference:
compute.c:406-465, README.md:99-116).  The hot loop runs on CUDA
kernels written for Hopper (NVIDIA H100): two per iteration for large
canvases, or one launch for every iteration of a chunk for small ones
and for batches of mixed-size images (runner.py, dealt over the cards);
giant images solve in row bands over several devices or processes, and
several at once over groups of devices (parallel/).

Layout (each module has its counterpart in the JAX package
jpeg2png_tpu/, which stays the reference; this package imports none of
it):
    io/        JPEG DCT-coefficient reader (markers in Python, the entropy
               decoder in C: csrc/jpeg_entropy.c) and PNG writer
    ops/       block DCT, TV/TGV2 gather-form gradients, quantization-box
               projection, prob term, color conversion (plain PyTorch)
    kernels/   the CUDA kernels' wrappers and plain versions; the sources
               are in csrc/ and build at first use (kernels/_build.py,
               which also builds the host entropy decoder with cc)
    models/    the FISTA projected-subgradient solver (four tiers) and
               checkpoint/resume of long solves (models/checkpoint.py)
    parallel/  the row-striped solve: band meshes, torch.distributed
               processes, the striped solver (cli --tpu-stripes)
    runner.py  bucketed batch serving (cli --tpu-batch), over every card
    utils/     config, CSV convergence logger, progress reporting
"""

__version__ = "0.1.0"

from jpeg2png_tpu_torch.utils.config import SolverConfig, ChannelSettings  # noqa: F401,E402


def resolve_device(device="cuda"):
    """torch.device for `device`; raises RuntimeError for a CUDA device
    when no card is present (no silent fall back to the CPU)."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "jpeg2png_tpu_torch runs on a CUDA device by default and none "
            "is available; pass device='cpu' (--device cpu) to run the "
            "plain PyTorch path on the CPU")
    return dev


def on_device(device):
    """A context that makes `device` the calling thread's current CUDA
    device (a no-op for the CPU).  The kernels launch on the current
    device (the CUDA runtime's rule), on the stream of their tensors'
    device, so every thread that launches on a card enters it."""
    import contextlib

    import torch

    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()
