"""Band meshes for the row-striped solve, and the in-process communicator.

The counterpart of jpeg2png_tpu/parallel/mesh.py::stripe_mesh.  A mesh
here is the list of devices that hold an image's row bands, band 0 on
top, plus the communicator that moves the halo rows between neighbouring
bands and all-reduces the per-band partial sums (parallel/stripes.py):

  * bands in one process (LocalComm): every band's tensors live in this
    process, on one device each (a device may hold several bands); a halo
    exchange is a copy between band tensors, the all-reduce a sum in band
    order on the device;
  * one band per process (distributed.DistributedComm, torch.distributed),
    once distributed.initialize() has joined the processes.

Asking for more bands than there are devices raises: a "striped over 8"
solve that quietly ran on fewer devices would hide both its speed and
whether the striping is right (the JAX package's rule, mesh.py:20-33).

batch_stripe_mesh gives several such meshes side by side, one image each
(stripes.solve_striped_batched): the JAX package's 2-D ("batch", "y")
mesh, in one process.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from jpeg2png_tpu_torch.parallel import distributed


class LocalComm:
    """The collectives of bands held in one process, in band order.

    Each method takes one tensor per band and returns one per band; each
    call counts once in `counts` ("halo" per exchange, "all_reduce")."""

    def __init__(self, devices):
        self.devices = list(devices)
        self.counts = {"halo": 0, "all_reduce": 0}

    def shift_down(self, xs):
        """out[i] = xs[i - 1] on band i's device (zeros for band 0): each
        band receives the rows its upper neighbour sent."""
        self.counts["halo"] += 1
        return [torch.zeros_like(xs[0])] + [
            x.to(d) for x, d in zip(xs[:-1], self.devices[1:])]

    def shift_up(self, xs):
        """out[i] = xs[i + 1] on band i's device (zeros for the last)."""
        self.counts["halo"] += 1
        return [x.to(d) for x, d in zip(xs[1:], self.devices[:-1])] + [
            torch.zeros_like(xs[-1])]

    def all_reduce(self, xs):
        """The sum of every band's vector, added in band order, on each
        band's device."""
        self.counts["all_reduce"] += 1
        total = xs[0]
        for x in xs[1:]:
            total = total + x.to(total.device)
        return [total.to(d) for d in self.devices]


@dataclasses.dataclass(frozen=True)
class StripeMesh:
    """n bands in all; this process holds bands first .. first +
    len(devices) - 1, band i on devices[i - first]."""
    n: int
    devices: tuple
    first: int
    comm: object


def available_devices(device) -> int:
    """How many bands `stripe_mesh` can place on `device`'s kind: one per
    process in a multi-process run, else one per visible CUDA device, and
    any number on the CPU."""
    if distributed.is_multi_process():
        return distributed.world_size()
    if torch.device(device).type == "cpu":
        return 1 << 30
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def stripe_mesh(n_devices: Optional[int] = None,
                devices: Optional[Sequence] = None) -> StripeMesh:
    """A mesh of `n_devices` bands.

    With no device list the bands map onto the visible CUDA devices, one
    each (default: all of them), and asking for more bands than devices
    raises.  An explicit device list of n entries may repeat a device,
    e.g. [cuda:0] * 4 puts four bands on one card, or ["cpu"] * 8 eight on
    the CPU.  In a multi-process run (distributed.initialize) every
    process holds one band on its own device, and n must be the number of
    processes.
    """
    if distributed.is_multi_process():
        world = distributed.world_size()
        if devices is not None or (n_devices is not None
                                   and n_devices != world):
            raise ValueError(
                f"a multi-process stripe mesh holds one band per process: "
                f"need {n_devices} processes, have {world}")
        return StripeMesh(world, (distributed.band_device(),),
                          distributed.rank(), distributed.DistributedComm())
    if devices is None:
        have = available_devices("cuda")
        n = have if n_devices is None else int(n_devices)
        if n > have:
            raise ValueError(f"need {n} devices for a {n}-way stripe mesh, "
                             f"have {have}")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = tuple(torch.device(d) for d in devices)
    if n_devices is not None and n_devices != len(devices):
        raise ValueError(f"{n_devices} bands asked for on {len(devices)} "
                         "devices")
    if not devices:
        raise ValueError("a stripe mesh needs at least one band")
    return StripeMesh(len(devices), devices, 0, LocalComm(devices))


def batch_stripe_mesh(n_batch: int, n_stripes: int,
                      devices: Optional[Sequence] = None) -> tuple:
    """`n_batch` stripe meshes of `n_stripes` bands each, over consecutive
    devices (mesh b holds devices[b * n_stripes:(b + 1) * n_stripes]),
    each with its own LocalComm: B images of one geometry, each striped
    over its own group (jpeg2png_tpu/parallel/mesh.py:52-70).  `devices`
    defaults to the visible CUDA cards and may repeat a device (["cuda:0"]
    * 4: two groups of two bands on one card).  Fewer devices than
    n_batch * n_stripes raise (never a smaller mesh).  One process only:
    a batch of stripe groups across processes would need sub-groups of
    the process group, which this package does not build."""
    if distributed.is_multi_process():
        raise ValueError("batch_stripe_mesh runs in one process; a "
                         "multi-process batch x stripe mesh is not supported")
    if n_batch < 1 or n_stripes < 1:
        raise ValueError(f"a {n_batch}x{n_stripes} mesh")
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(available_devices("cuda"))]
    need = n_batch * n_stripes
    if len(devices) < need:
        raise ValueError(f"need {need} devices for a {n_batch}x{n_stripes} "
                         f"mesh, have {len(devices)}")
    return tuple(stripe_mesh(n_stripes,
                             devices[b * n_stripes:(b + 1) * n_stripes])
                 for b in range(n_batch))
