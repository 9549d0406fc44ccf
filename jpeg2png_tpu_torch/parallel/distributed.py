"""Multi-process runs on torch.distributed: one row band per process.

The counterpart of jpeg2png_tpu/parallel/distributed.py.  Every process
runs the same program; initialize() joins them into one process group,
after which stripe_mesh() gives each process one band of the image and the
striped solve's collectives (two halo exchanges and one all-reduce per
iteration) cross the processes through DistributedComm.

Nothing on a machine tells a process about the others, so the group's
address, size and this process's rank come from the arguments or from
the environment:
    JPEG2PNG_COORDINATOR=host:port
    JPEG2PNG_NUM_PROCESSES=N
    JPEG2PNG_PROCESS_ID=i

The backend follows the bands' device: NCCL for CUDA bands (process i on
card i % device_count), gloo for CPU bands (`--device cpu`); a CUDA run
never falls back to gloo.  Host-side effects that must happen once (PNG
files, the CSV, the progress bar) are rank 0's (is_primary), the
reference's single writer (jpeg2png.c:162-165).

CLI: `--tpu-distributed` calls initialize() before any solve and
shutdown() before it returns.  A process leaves the group through
shutdown() (a barrier, then destroy_process_group); initialize()
registers it at exit, because a process that exits while its backend's
threads still run aborts ("terminate called without an active
exception") after its work is done.
"""

from __future__ import annotations

import atexit
import datetime
import os
import sys
from typing import Optional

import torch

_state: dict = {}      # "device": this process's band device


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device="cuda") -> tuple:
    """Join the process group; returns (rank, world size).  Arguments
    default to the JPEG2PNG_* environment variables.  Idempotent: a
    second call returns the group already joined."""
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
    if dev.type == "cuda":
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for device {dev}")
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(minutes=10))
    _state["device"] = dev
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
    it, then destroy_process_group.  Idempotent, and a no-op in a
    process that joined no group."""
    import torch.distributed as dist

    if not is_joined():
        return
    if sync:
        barrier()
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


def band_device() -> torch.device:
    """The device of this process's band (set by initialize)."""
    return _state["device"]


def barrier() -> None:
    """Cross-process sync point (no-op in a single process)."""
    import torch.distributed as dist

    if not is_multi_process():
        return
    if _state["device"].type == "cuda":
        dist.barrier(device_ids=[_state["device"].index])
    else:
        dist.barrier()


def gather_output(fdata):
    """Every process's rows of a striped result, on every process, once at
    the end.  A single process, and numpy arrays (the metrics, which every
    process holds whole), pass through.  Otherwise `fdata` is this
    process's [C, rows, W] share of the canvas (the rows of its band that
    lie inside the image, possibly none); returns the [C, H, W] canvas."""
    import numpy as np
    import torch.distributed as dist

    if not is_multi_process() or isinstance(fdata, np.ndarray):
        return fdata
    n = torch.tensor([fdata.shape[1]], device=fdata.device)
    counts = [torch.zeros_like(n) for _ in range(world_size())]
    dist.all_gather(counts, n)
    rows = [int(c) for c in counts]
    pad = torch.zeros((fdata.shape[0], max(rows), fdata.shape[2]),
                      dtype=fdata.dtype, device=fdata.device)
    pad[:, :rows[rank()]] = fdata
    parts = [torch.empty_like(pad) for _ in rows]
    dist.all_gather(parts, pad)
    return torch.cat([p[:, :r] for p, r in zip(parts, rows)], dim=1)


def gather_to_primary(tensors):
    """Every process's `tensors` (a list of the same shapes and dtypes on
    every process: one band's carry each) on rank 0, as host tensors: a
    list per process in rank order, None on the other ranks.  A
    collective: every process calls it.  A single process gets [its
    tensors on the host].  Every tensor travels as its bytes (uint8: NCCL
    and gloo both take it, where neither takes every dtype)."""
    import torch.distributed as dist

    if not is_multi_process():
        return [[t.detach().cpu() for t in tensors]]
    primary = is_primary()
    out = [[] for _ in range(world_size())] if primary else None
    for t in tensors:
        x = t.detach().contiguous().reshape(-1).view(torch.uint8)
        parts = ([torch.empty_like(x) for _ in range(world_size())]
                 if primary else None)
        dist.gather(x, parts, dst=0)
        if primary:
            for r, p in enumerate(parts):
                out[r].append(p.cpu().view(t.dtype).reshape(t.shape))
    return out


class DistributedComm:
    """The striped solve's collectives across processes, one band each:
    the LocalComm interface (mesh.py) on lists of one tensor, with the
    same counts."""

    def __init__(self):
        self.counts = {"halo": 0, "all_reduce": 0}

    def _shift(self, x, to: int, frm: int):
        import torch.distributed as dist

        self.counts["halo"] += 1
        recv = torch.zeros_like(x)
        ops = []
        if 0 <= to < world_size():
            ops.append(dist.P2POp(dist.isend, x.contiguous(), to))
        if 0 <= frm < world_size():
            ops.append(dist.P2POp(dist.irecv, recv, frm))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return [recv]

    def shift_down(self, xs):
        """Send to the band below, receive from the band above."""
        r = rank()
        return self._shift(xs[0], r + 1, r - 1)

    def shift_up(self, xs):
        """Send to the band above, receive from the band below."""
        r = rank()
        return self._shift(xs[0], r - 1, r + 1)

    def all_reduce(self, xs):
        import torch.distributed as dist

        self.counts["all_reduce"] += 1
        x = xs[0].clone()
        dist.all_reduce(x)
        return [x]
