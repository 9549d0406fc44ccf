"""Band meshes for the row-striped solve, and the in-process communicator.

The counterpart of jpeg2png_tpu/parallel/mesh.py.  A mesh here is the
list of devices that hold an image's row bands, band 0 on top, plus the
communicator that moves the halo rows between neighbouring bands and
all-reduces the per-band partial sums (parallel/stripes.py):

  * bands in one process (LocalComm): every band's tensors live in this
    process, on one device each (a device may hold several bands); a halo
    exchange is a copy between band tensors, the all-reduce a sum in band
    order on the device;
  * bands over processes (distributed.DistributedComm), once
    distributed.initialize() has joined them: the meshes take the GLOBAL
    devices, every process's in rank order (jax.devices()'s order), so a
    process holds as many consecutive bands as it has devices in the
    mesh, possibly none; the all-reduce adds in band order too, so every
    layout gives the bits of one process.

Asking for more bands than there are devices raises: a "striped over 8"
solve that quietly ran on fewer devices would hide both its speed and
whether the striping is right (the JAX package's rule, mesh.py:20-33).

batch_stripe_mesh gives several such meshes side by side, one image each
(stripes.solve_striped_batched): the JAX package's 2-D ("batch", "y")
mesh, group b on global devices b * n_stripes .. (b + 1) * n_stripes - 1.
A group inside one process has a LocalComm; a group whose bands span
processes its own torch.distributed sub-group.
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
    len(devices) - 1, band i on devices[i - first] (in a multi-process
    mesh possibly none); `ranks` are the processes that hold its bands,
    in band order (empty: this process alone, outside a process group)."""
    n: int
    devices: tuple
    first: int
    comm: object
    ranks: tuple = ()


def available_devices(device) -> int:
    """How many bands `stripe_mesh` can place on `device`'s kind: the
    global device count once distributed.initialize() has joined a group
    (every process's devices; any number where a CPU process holds any),
    else one per visible CUDA device, and any number on the CPU."""
    if distributed.is_joined():
        return distributed.global_device_count()
    if torch.device(device).type == "cpu":
        return 1 << 30
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def _local_share(first: int, k: int) -> tuple:
    """This process's devices for its k bands of a layout: the first k of
    its devices, or k CPU bands where it holds any number."""
    devs = distributed.local_devices()
    if distributed.device_counts()[distributed.rank()] is None:
        devs = devs[:1] * k
    return tuple(devs[:k])


def stripe_mesh(n_devices: Optional[int] = None,
                devices: Optional[Sequence] = None) -> StripeMesh:
    """A mesh of `n_devices` bands.

    With no device list the bands map onto the visible CUDA devices, one
    each (default: all of them), and asking for more bands than devices
    raises.  An explicit device list of n entries may repeat a device,
    e.g. [cuda:0] * 4 puts four bands on one card, or ["cpu"] * 8 eight on
    the CPU.  Once distributed.initialize() has joined a group the bands
    take the first n global devices instead (default: all of them, or
    one per process where CPU processes hold any number), and a process
    holds its devices' bands (possibly none); the communicator spans
    every process, so each gets the all-reduced sums and the metrics.
    """
    if distributed.is_joined():
        if devices is not None:
            raise ValueError("a multi-process stripe mesh takes the global "
                             "devices; an explicit device list is for one "
                             "process")
        counts = distributed.device_counts()
        n = (int(n_devices) if n_devices is not None
             else len(counts) if None in counts else sum(counts))
        layout = distributed.band_layout(n, counts)
        first, k = layout[distributed.rank()]
        devs = _local_share(first, k)
        comm = distributed.DistributedComm(devs, first,
                                           [k for _, k in layout])
        return StripeMesh(n, devs, first, comm,
                          tuple(r for r, (_, k) in enumerate(layout) if k))
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
    devices (mesh b holds devices[b * n_stripes:(b + 1) * n_stripes]): B
    images of one geometry, each striped over its own group
    (jpeg2png_tpu/parallel/mesh.py:52-70).  `devices` defaults to the
    visible CUDA cards and may repeat a device (["cuda:0"] * 4: two groups
    of two bands on one card); each group has its own LocalComm.  Fewer
    devices than n_batch * n_stripes raise (never a smaller mesh).

    Once distributed.initialize() has joined a group the groups take the
    global devices, process-major: a group inside one process has a
    LocalComm there, and one whose bands span processes a sub-group of
    its own (distributed.sub_group: every process makes every such group,
    in group order, once per layout).  A process's mesh of a group it
    holds no band of has no devices and no communicator."""
    if n_batch < 1 or n_stripes < 1:
        raise ValueError(f"a {n_batch}x{n_stripes} mesh")
    if distributed.is_joined():
        if devices is not None:
            raise ValueError("a multi-process batch x stripe mesh takes the "
                             "global devices")
        return _global_batch_mesh(n_batch, n_stripes)
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


def _global_batch_mesh(n_batch: int, n_stripes: int) -> tuple:
    """batch_stripe_mesh over the global devices of a joined group."""
    need = n_batch * n_stripes
    try:
        layout = distributed.band_layout(need, distributed.device_counts())
    except ValueError:
        raise ValueError(
            f"need {need} devices for a {n_batch}x{n_stripes} mesh, have "
            f"{distributed.global_device_count()}") from None
    me = distributed.rank()
    meshes = []
    for b in range(n_batch):
        lo, hi = b * n_stripes, (b + 1) * n_stripes
        # every rank's bands of group b, as (rank, first band in the
        # group, band count)
        held = [(r, max(f, lo) - lo, min(f + k, hi) - max(f, lo))
                for r, (f, k) in enumerate(layout)
                if max(f, lo) < min(f + k, hi)]
        ranks = tuple(r for r, _, _ in held)
        group = distributed.sub_group(ranks) if len(ranks) > 1 else None
        mine = [(first, k) for r, first, k in held if r == me]
        if not mine:
            meshes.append(StripeMesh(n_stripes, (), 0, None, ranks))
            continue
        (first, k), = mine
        # this process's devices for the group: its share of the layout,
        # from the group's first band on
        f_me = layout[me][0]
        devs = _local_share(f_me, layout[me][1])
        devs = devs[lo + first - f_me:lo + first - f_me + k]
        comm = (LocalComm(devs) if group is None else
                distributed.DistributedComm(devs, first,
                                            [k for _, _, k in held], group))
        meshes.append(StripeMesh(n_stripes, devs, first, comm, ranks))
    return tuple(meshes)
