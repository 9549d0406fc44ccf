"""Multi-process runs on torch.distributed: several row bands per process.

The counterpart of jpeg2png_tpu/parallel/distributed.py.  Every process
runs the same program; initialize() joins them into one process group and
settles which devices each process holds.  The meshes of parallel/mesh.py
then lay bands over the GLOBAL device list, every process's devices in
rank order (process-major, the order of jax.devices()), and the striped
solve's collectives (two halo exchanges and one all-reduce per iteration)
cross the processes through DistributedComm.

Nothing on a machine tells a process about the others, so the group's
address, size and this process's rank come from the arguments or from
the environment:
    JPEG2PNG_COORDINATOR=host:port
    JPEG2PNG_NUM_PROCESSES=N
    JPEG2PNG_PROCESS_ID=i

The devices of a process (local_devices):
  * CUDA: processes that see the same physical cards (a card is known by
    its uuid, exchanged through the rendezvous store before the first
    NCCL collective) split them in rank order (split_cards): 4 processes
    on 4 cards hold one each, 2 processes on 4 cards two each, and a
    process launched with its own CUDA_VISIBLE_DEVICES holds what it
    sees.  More processes than cards put two ranks on one card, which
    NCCL refuses;
  * the CPU (gloo, `--device cpu`): any number of bands, an even share
    of each mesh (band_layout);
  * `devices=` names them explicitly (and may repeat one: ["cuda:0"] * 2
    holds two bands on one card).
The backend follows the devices: NCCL for CUDA, gloo for the CPU; a CUDA
run never falls back to gloo.  A process's NCCL traffic goes through its
first device (home_device, the current device), so one communicator per
group serves every band it holds.  Host-side effects that must happen
once (PNG files, the CSV, the progress bar) are rank 0's (is_primary),
the reference's single writer (jpeg2png.c:162-165).

CLI: `--tpu-distributed` calls initialize() before any solve and
shutdown() before it returns.  A process leaves the group through
shutdown() (a barrier, then every sub-group and the group destroyed);
initialize() registers it at exit, because a process that exits while
its backend's threads still run aborts ("terminate called without an
active exception") after its work is done.
"""

from __future__ import annotations

import atexit
import datetime
import json
import os
import sys
from typing import List, Optional, Sequence

import torch

from jpeg2png_tpu_torch import on_device

_TIMEOUT = datetime.timedelta(minutes=10)

# while joined: "devices" (this process's devices; None on the CPU when
# none were named: any number), "home" (the device its collectives use),
# "counts" (every rank's device count, None for "any"), "groups" (the
# sub-groups made, by their ranks)
_state: dict = {}


def split_cards(card_ids: Sequence[Sequence[str]]) -> List[List[int]]:
    """Which of its visible cards each rank holds, from every rank's
    visible card ids (uuids, in its CUDA ordinals' order): the ranks that
    see the same cards split them in rank order, c cards over m ranks as
    contiguous runs (rank j of them: ordinals j*c//m .. (j+1)*c//m - 1),
    or card j % c each when m > c.  Ranks that see overlapping but
    different card sets raise ValueError."""
    sets: dict = {}
    for r, ids in enumerate(card_ids):
        sets.setdefault(tuple(ids), []).append(r)
    seen: dict = {}
    for ids in sets:
        for i in ids:
            if seen.setdefault(i, ids) != ids:
                raise ValueError(
                    f"processes see overlapping card sets {list(seen[i])} "
                    f"and {list(ids)}: give each process the same cards as "
                    "the others on its host, or cards of its own")
    out: List[List[int]] = [[] for _ in card_ids]
    for ids, ranks in sets.items():
        c, m = len(ids), len(ranks)
        for j, r in enumerate(ranks):
            if c == 0:
                raise ValueError(f"rank {r} sees no CUDA card")
            out[r] = (list(range(j * c // m, (j + 1) * c // m)) if m <= c
                      else [j % c])
    return out


def band_layout(n: int, counts: Sequence[Optional[int]]) -> List[tuple]:
    """(first, k) per rank: n bands over the global devices, the first n of
    them process-major (rank r holds bands first .. first + k - 1).  A
    count of None (the CPU: any number) holds an even share, ceil(n /
    ranks).  More bands than devices raise ValueError."""
    share = -(-n // max(1, len(counts)))
    out, first = [], 0
    for c in counts:
        k = min(share if c is None else c, n - first)
        out.append((first, k))
        first += k
    if first < n:
        raise ValueError(f"need {n} devices for a {n}-way stripe mesh, "
                         f"have {first}")
    return out


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device="cuda", devices: Optional[Sequence] = None) -> tuple:
    """Join the process group; returns (rank, world size).  Arguments
    default to the JPEG2PNG_* environment variables.  `devices` names
    this process's devices (default: its share of the cards it sees, or
    any number on the CPU).  Idempotent: a second call returns the group
    already joined."""
    import torch.distributed as dist

    from jpeg2png_tpu_torch import resolve_device

    if is_joined():
        return dist.get_rank(), dist.get_world_size()
    env = os.environ
    coordinator_address = coordinator_address or env.get(
        "JPEG2PNG_COORDINATOR")
    if num_processes is None and env.get("JPEG2PNG_NUM_PROCESSES"):
        num_processes = int(env["JPEG2PNG_NUM_PROCESSES"])
    if process_id is None and env.get("JPEG2PNG_PROCESS_ID"):
        process_id = int(env["JPEG2PNG_PROCESS_ID"])
    if not coordinator_address or num_processes is None or process_id is None:
        raise ValueError(
            "distributed.initialize needs the coordinator address, the "
            "number of processes and this process's id (arguments, or "
            "JPEG2PNG_COORDINATOR, JPEG2PNG_NUM_PROCESSES, "
            "JPEG2PNG_PROCESS_ID)")
    dev = resolve_device(device)          # no card: RuntimeError
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"no process-group backend for device {dev}")
    mine = None
    if devices is not None:
        mine = [resolve_device(d) for d in devices]
        if not mine or any(d.type != dev.type for d in mine):
            raise ValueError(f"devices {devices} for a {dev.type} run")
    cards = ([str(torch.cuda.get_device_properties(i).uuid)
              for i in range(torch.cuda.device_count())]
             if dev.type == "cuda" else [])
    host, port = coordinator_address.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), num_processes,
                          is_master=process_id == 0, timeout=_TIMEOUT)
    # every rank's cards and named device count, before any collective:
    # NCCL binds a communicator to the device current at its first use
    store.set(f"jpeg2png/devices/{process_id}", json.dumps(
        {"cards": cards, "count": None if mine is None else len(mine)}))
    posts = [json.loads(store.get(f"jpeg2png/devices/{r}"))
             for r in range(num_processes)]
    if dev.type == "cuda":
        split = split_cards([p["cards"] for p in posts])
        if mine is None:
            mine = [torch.device("cuda", i) for i in split[process_id]]
        counts = [len(s) if p["count"] is None else p["count"]
                  for p, s in zip(posts, split)]
        torch.cuda.set_device(mine[0])
        backend = "nccl"
    else:
        counts = [p["count"] for p in posts]
        backend = "gloo"
    dist.init_process_group(backend, store=store, world_size=num_processes,
                            rank=process_id, timeout=_TIMEOUT)
    _state.update(devices=mine, home=mine[0] if mine else dev,
                  counts=counts, groups={})
    atexit.register(_shutdown_at_exit)      # shutdown is idempotent
    barrier()
    return process_id, num_processes


def is_joined() -> bool:
    """Whether this process is in a process group."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def shutdown(sync: bool = True) -> None:
    """Leave the process group: a barrier (unless `sync` is false), so
    that no process takes its backend down while another still talks to
    it, then every sub-group (in the reverse of the order all processes
    made them) and the group destroyed.  Idempotent, and a no-op in a
    process that joined no group."""
    import torch.distributed as dist

    if not is_joined():
        return
    if sync:
        barrier()
    for group in reversed(list(_state.get("groups", {}).values())):
        dist.destroy_process_group(group)
    dist.destroy_process_group()
    _state.clear()


def _shutdown_at_exit() -> None:
    # after an unhandled exception the other processes may never reach a
    # barrier: leave without one
    shutdown(sync=getattr(sys, "last_exc", None) is None)


def is_multi_process() -> bool:
    import torch.distributed as dist

    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if is_multi_process() else 1


def rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if is_multi_process() else 0


def is_primary() -> bool:
    """Whether this process is the designated writer (rank 0)."""
    return rank() == 0


def local_devices() -> List[torch.device]:
    """This process's devices (set by initialize; the CPU: [cpu])."""
    return list(_state["devices"] or [_state["home"]])


def home_device() -> torch.device:
    """The device this process's collectives run on: its first."""
    return _state["home"]


def device_counts() -> List[Optional[int]]:
    """Every rank's device count, gathered at initialize (None: any
    number, a CPU process that named none)."""
    return list(_state["counts"])


def global_device_count() -> int:
    """The devices of every process: the counterpart of
    len(jax.devices()); 1 << 30 where a CPU process holds any number."""
    counts = device_counts()
    return 1 << 30 if None in counts else sum(counts)


def sub_group(ranks: Sequence[int]):
    """The process group of `ranks`, made once per rank set.  Every
    process must call it with the same rank sets in the same order (even
    the sets it is not in: torch.distributed.new_group is a collective of
    the whole group); a member's first collective on it includes every
    member (NCCL's rule for batched sends)."""
    import torch.distributed as dist

    ranks = tuple(ranks)
    groups = _state["groups"]
    if ranks not in groups:
        group = dist.new_group(list(ranks))
        groups[ranks] = group
        if rank() in ranks:
            barrier(group)
    return groups[ranks]


def _group_ranks(group) -> List[int]:
    import torch.distributed as dist

    return (list(range(world_size())) if group is None
            else dist.get_process_group_ranks(group))


def barrier(group=None) -> None:
    """Cross-process sync point of the group (default: every process; a
    no-op in a single process)."""
    import torch.distributed as dist

    if not is_multi_process():
        return
    if _state["home"].type == "cuda":
        dist.barrier(group, device_ids=[_state["home"].index])
    else:
        dist.barrier(group)


def gather_output(fdata, group=None):
    """The rows of a striped result that every process of the group
    (default: all) holds, on each of them, once at the end.  A single
    process, and numpy arrays (the metrics, which every process holds
    whole), pass through.  Otherwise `fdata` is this process's [C, rows,
    W] share of the canvas (the rows of its bands that lie inside the
    image, possibly none); returns the rows of every member, in rank
    order: the [C, H, W] canvas when the group holds every band."""
    import numpy as np
    import torch.distributed as dist

    if not is_multi_process() or isinstance(fdata, np.ndarray):
        return fdata
    members = _group_ranks(group)
    with on_device(fdata.device):
        n = torch.tensor([fdata.shape[1]], device=fdata.device)
        counts = [torch.zeros_like(n) for _ in members]
        dist.all_gather(counts, n, group)
        rows = [int(c) for c in counts]
        pad = torch.zeros((fdata.shape[0], max(rows), fdata.shape[2]),
                          dtype=fdata.dtype, device=fdata.device)
        pad[:, :fdata.shape[1]] = fdata
        parts = [torch.empty_like(pad) for _ in rows]
        dist.all_gather(parts, pad, group)
    return torch.cat([p[:, :r] for p, r in zip(parts, rows)], dim=1)


def gather_to_primary(tensors, group=None):
    """Every process's `tensors` (a list per process, of any count, shapes
    and dtypes: the carries of its bands) on the group's first rank
    (default: rank 0), as host tensors: a list per member in rank order,
    None on the other members.  A collective: every member calls it.  A
    single process gets [its tensors on the host].  The shapes and dtypes
    travel first (one object gather); then each tensor index travels as
    its bytes, padded to the longest (uint8: NCCL and gloo both take it,
    where neither takes every dtype, and torch.distributed.gather needs
    equal sizes)."""
    import torch.distributed as dist

    if not is_multi_process():
        return [[t.detach().cpu() for t in tensors]]
    members = _group_ranks(group)
    primary = rank() == members[0]
    home = home_device()
    metas = [None] * len(members)
    with on_device(home):
        dist.all_gather_object(
            metas, [(str(t.dtype), tuple(t.shape)) for t in tensors], group)
    out = [[] for _ in members] if primary else None
    for i in range(max(len(m) for m in metas)):
        sizes = [_nbytes(m[i]) if i < len(m) else 0 for m in metas]
        x = torch.zeros(max(sizes), dtype=torch.uint8, device=home)
        if i < len(tensors):
            x[:sizes[members.index(rank())]] = (
                tensors[i].detach().contiguous().reshape(-1)
                .view(torch.uint8).to(home))
        parts = [torch.empty_like(x) for _ in members] if primary else None
        with on_device(home):
            dist.gather(x, parts, dst=members[0], group=group)
        if primary:
            for r, (p, m) in enumerate(zip(parts, metas)):
                if i < len(m):
                    dtype, shape = _dtype(m[i][0]), m[i][1]
                    out[r].append(p[:sizes[r]].cpu().view(dtype)
                                  .reshape(shape))
    return out


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name.removeprefix("torch."))


def _nbytes(meta) -> int:
    dtype, shape = meta
    n = _dtype(dtype).itemsize
    for s in shape:
        n *= s
    return n


class DistributedComm:
    """The striped solve's collectives over processes: the LocalComm
    interface (mesh.py), one tensor per band this process holds, with the
    same counts (each call counts once, whatever the layout).

    The group (default: every process) holds n bands, `bands[j]` on its
    j-th member in rank order; this process holds bands first .. first +
    len(devices) - 1, band first + i on devices[i] (none at all is
    allowed: such a process still takes part in the all-reduce, and gets
    its total).  Halo rows move by device copies between this process's
    own bands, and by one batch of sends and receives at its edge bands,
    to the members holding the neighbouring bands; the all-reduce gathers
    every band's vector and adds them in band order, as LocalComm does, so
    any spread of the bands over processes gives the same bits as one
    process.  The wire traffic goes through home_device().  The defaults:
    one band per process, on its first device."""

    def __init__(self, devices: Optional[Sequence] = None,
                 first: Optional[int] = None,
                 bands: Optional[Sequence[int]] = None, group=None):
        self.group = group
        self.ranks = _group_ranks(group)
        self.devices = ([home_device()] if devices is None
                        else [torch.device(d) for d in devices])
        self.bands = [1] * len(self.ranks) if bands is None else list(bands)
        self.first = (self.ranks.index(rank()) if first is None else first)
        self.home = home_device()
        self.counts = {"halo": 0, "all_reduce": 0}

    def _owner(self, band: int) -> Optional[int]:
        """The global rank holding `band` of the group, None off its ends."""
        start = 0
        for r, k in zip(self.ranks, self.bands):
            if start <= band < start + k:
                return r
            start += k
        return None

    def _shift(self, xs, down: bool):
        import torch.distributed as dist

        self.counts["halo"] += 1
        if not xs:
            return []
        k = len(xs)
        # the band whose rows the edge band receives, and the band the
        # other edge band sends to
        frm = self._owner(self.first - 1 if down else self.first + k)
        to = self._owner(self.first + k if down else self.first - 1)
        edge_in, edge_out = (0, k - 1) if down else (k - 1, 0)
        with on_device(self.home):
            recv = torch.zeros(xs[0].shape, dtype=xs[0].dtype,
                               device=self.home)
            ops = []
            if to is not None:
                ops.append(dist.P2POp(dist.isend,
                                      xs[edge_out].to(self.home).contiguous(),
                                      to, self.group))
            if frm is not None:
                ops.append(dist.P2POp(dist.irecv, recv, frm, self.group))
            if ops:
                for req in dist.batch_isend_irecv(ops):
                    req.wait()
        inner = ([x.to(d) for x, d in zip(xs[:-1], self.devices[1:])] if down
                 else [x.to(d) for x, d in zip(xs[1:], self.devices[:-1])])
        outer = recv.to(self.devices[edge_in])
        return [outer] + inner if down else inner + [outer]

    def shift_down(self, xs):
        """out[i] = the rows band first + i - 1 sent (zeros for band 0)."""
        return self._shift(xs, down=True)

    def shift_up(self, xs):
        """out[i] = the rows band first + i + 1 sent (zeros for the last)."""
        return self._shift(xs, down=False)

    def all_reduce(self, xs, shape=None):
        """The sum of every band's tensor, added in band order, on each of
        this process's bands' devices; a process that holds no band passes
        the tensors' `shape` and gets [the sum] on home_device()."""
        import torch.distributed as dist

        self.counts["all_reduce"] += 1
        shape = tuple(xs[0].shape) if xs else tuple(shape)
        dtype = xs[0].dtype if xs else torch.float32
        with on_device(self.home):
            slots = torch.zeros((max(self.bands),) + shape, dtype=dtype,
                                device=self.home)
            for i, x in enumerate(xs):
                slots[i] = x.to(self.home)
            parts = [torch.empty_like(slots) for _ in self.ranks]
            dist.all_gather(parts, slots, self.group)
            vecs = [p[j] for p, k in zip(parts, self.bands) for j in range(k)]
            total = vecs[0]
            for v in vecs[1:]:
                total = total + v
        return [total.to(d) for d in self.devices] or [total]
