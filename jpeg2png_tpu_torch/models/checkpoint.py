"""Checkpoint / resume for long solves.

The counterpart of jpeg2png_tpu/models/checkpoint.py.  The reference
never needed it (its runs take seconds), but a 100-megapixel image at
thousands of iterations does: the whole solver state is one small carry
(models/solver.py::_initial_carry for the four tiers,
parallel/stripes.py::_Striped.initial_carry for the two striped bodies),
so a solve snapshots it every `checkpoint_every` iterations and a killed
run resumes exactly where it stopped.  The step size keys on the TOTAL
planned iteration count and the FISTA momentum rides in the carry, so a
chunked or resumed run is the uninterrupted run, bit for bit.

Format: one .npz, read with allow_pickle=False (a snapshot is data, never
code), holding
  * leaf_0 .. leaf_k: the carry's tensors in depth-first order, bfloat16
    ones (the lite tiers' d and devq) as their uint16 bit patterns, with
    _bf16_mask marking them;
  * _structure: the carry's nesting as JSON text (tuples, lists, tensor
    leaves by index, Python floats by value);
  * _iteration: the iterations done; _fingerprint: the solve configuration
    (a snapshot of another configuration, tier, body, band count or
    package is refused).
Only rank 0 writes, to a temporary file in the target directory that then
replaces the snapshot, so a kill mid-write never leaves a truncated file;
every rank reaches the barrier after the write, on success and on failure.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from jpeg2png_tpu_torch import resolve_device
from jpeg2png_tpu_torch.models import solver
from jpeg2png_tpu_torch.parallel import distributed, stripes

# the carry format of this package: the JAX package's snapshots (its own
# "carry-v3" / "striped-carry-v2") are refused as another configuration
CARRY_FORMAT = "torch-carry-v1"


def fingerprint(geoms, tier: str, weight: float, pweights, iterations: int,
                simd_compat_logging: bool) -> str:
    """Config fingerprint of a single-image solve.  The tier fixes the
    carry's format (the two lite tiers share one, but a snapshot still
    resumes only its own tier, as in the JAX package).  Unlike the JAX
    fingerprint it holds simd_compat_logging: the prob distance the carry
    hands to the next chunk is the raw distance or p_alpha times it."""
    blob = repr((CARRY_FORMAT, tier, tuple(geoms), float(weight),
                 tuple(float(p) for p in pweights), int(iterations),
                 bool(simd_compat_logging))).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def striped_fingerprint(geoms, n: int, body: str, weight: float, pweights,
                        iterations: int, simd_compat_logging: bool) -> str:
    """Config fingerprint of a striped solve: also the band count (another
    count pads the canvas to other bands) and the body, whose carries
    differ ("f32": pixel prob gradients; "lite": bf16 d and devq)."""
    blob = repr(("striped-" + CARRY_FORMAT, int(n), body, tuple(geoms),
                 float(weight), tuple(float(p) for p in pweights),
                 int(iterations), bool(simd_compat_logging))).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def _flatten(carry, leaves):
    """carry -> JSON-able structure; its tensors appended to `leaves`."""
    if isinstance(carry, torch.Tensor):
        leaves.append(carry)
        return {"leaf": len(leaves) - 1}
    if isinstance(carry, (tuple, list)):
        return {type(carry).__name__: [_flatten(x, leaves) for x in carry]}
    if isinstance(carry, float):
        return {"float": carry}
    raise TypeError(f"cannot snapshot a {type(carry).__name__} carry leaf")


def _unflatten(spec, leaves):
    if "leaf" in spec:
        return leaves[spec["leaf"]]
    if "float" in spec:
        return spec["float"]
    if "tuple" in spec:
        return tuple(_unflatten(x, leaves) for x in spec["tuple"])
    return [_unflatten(x, leaves) for x in spec["list"]]


def _host_array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def save_state(path, carry, iteration: int, fingerprint: str) -> None:
    """Snapshot a carry (tensors on any device) to `path` atomically.

    The write goes to an open temp file in the target directory, which
    then os.replace()s `path`: np.savez on a file object never appends
    '.npz', and a kill mid-write never leaves a truncated snapshot.  Only
    rank 0 writes (the shared-filesystem model; `carry` may be None on the
    other ranks); every rank reaches the barrier."""
    if not distributed.is_primary():
        distributed.barrier()
        return
    try:
        leaves = []
        spec = _flatten(carry, leaves)
        arrays = {f"leaf_{i}": _host_array(t) for i, t in enumerate(leaves)}
        mask = np.array([t.dtype == torch.bfloat16 for t in leaves], bool)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(path)),
                                   suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(
                    f, _structure=np.frombuffer(json.dumps(spec).encode(),
                                                np.uint8),
                    _iteration=np.int64(iteration),
                    _fingerprint=np.frombuffer(fingerprint.encode(),
                                               np.uint8),
                    _bf16_mask=mask, **arrays)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
    finally:
        # also after a failed write: the other ranks wait at theirs
        distributed.barrier()


def load_state(path, fingerprint: str):
    """-> (carry with CPU tensors, iteration).  Raises ValueError when the
    snapshot belongs to another solve configuration."""
    with np.load(path, allow_pickle=False) as z:
        saved = bytes(z["_fingerprint"]).decode()
        if saved != fingerprint:
            raise ValueError(
                "checkpoint was written by a different solve configuration "
                f"(saved {saved}, current {fingerprint})")
        spec = json.loads(bytes(z["_structure"]).decode())
        mask = z["_bf16_mask"]
        leaves = []
        for i in range(len(mask)):
            a = np.ascontiguousarray(z[f"leaf_{i}"])
            leaves.append(torch.from_numpy(a.view(np.int16))
                          .view(torch.bfloat16) if mask[i]
                          else torch.from_numpy(a))
        iteration = int(z["_iteration"])
    return _unflatten(spec, leaves), iteration


def _to(carry, device):
    """The carry's tensors moved to `device`."""
    if isinstance(carry, torch.Tensor):
        return carry.to(device)
    if isinstance(carry, (tuple, list)):
        return type(carry)(_to(x, device) for x in carry)
    return carry


@dataclasses.dataclass
class CheckpointedResult:
    fdata: torch.Tensor        # [C, H, W] on the solve's device
    metrics: np.ndarray        # [iterations run by this call, 4]
    resumed_from: int          # iterations the snapshot had done (0: none)


def _run_checkpointed(path, fp, resume, every, iterations, initial, place,
                      step, gather):
    """The loop of both checkpointed solves: resume from a snapshot at
    `path` that matches `fp` (`place` puts its carry on the devices) or
    start from `initial()`; run `step(carry, n)` in chunks of `every` up
    to `iterations`, snapshotting `gather(carry)` after every chunk but
    the last; at the end remove the snapshot, but only one this run wrote
    or validated (resume=False must not delete a file of another
    configuration).  -> (carry, metrics, the snapshot's iteration)."""
    start, own = 0, False
    if resume and os.path.exists(path):
        carry, start = load_state(path, fp)
        carry, own = place(carry), True
    else:
        carry = initial()
    chunks, done = [np.zeros((0, 4), np.float32)], start
    while done < iterations:
        n = min(every, iterations - done)
        carry, metrics = step(carry, n)
        chunks.append(metrics)
        done += n
        if done < iterations:
            save_state(path, gather(carry), done, fp)
            own = True
    if own:
        try:
            if distributed.is_primary() and os.path.exists(path):
                os.remove(path)
        finally:
            # also when rank 0's remove raises
            distributed.barrier()
    return carry, np.concatenate(chunks), start


def solve_checkpointed(
    datas: Sequence[np.ndarray],
    quants: Sequence[np.ndarray],
    samps: Sequence[Tuple[int, int]],
    weight: float,
    pweights: Sequence[float],
    iterations: int,
    checkpoint_path: str,
    checkpoint_every: int = 100,
    simd_compat_logging: bool = True,
    device="cuda",
    tier: Optional[str] = None,
    resume: bool = True,
) -> CheckpointedResult:
    """solver.solve_joint in chunks of `checkpoint_every` iterations, with a
    snapshot after every chunk but the last and a resume from a matching
    snapshot at `checkpoint_path`.  `tier` as for solve_joint (None:
    active_tier).  The result equals solve_joint's bit for bit."""
    device = resolve_device(device)
    prob = solver._build_problem(datas, quants, samps, weight, pweights,
                                 iterations, simd_compat_logging, device)
    tier = solver._resolve_tier(prob, tier, pweights)
    fp = fingerprint(prob.geoms, tier, weight, pweights, iterations,
                     simd_compat_logging)
    carry, metrics, start = _run_checkpointed(
        checkpoint_path, fp, resume, checkpoint_every, iterations,
        lambda: solver._initial_carry(prob, tier),
        lambda carry: _to(carry, device),
        lambda carry, n: solver._run(prob, carry, n, tier),
        lambda carry: carry)
    return CheckpointedResult(carry[0], metrics, start)


def gather_striped_carry(carry):
    """This process's band carries -> the whole striped carry (every band
    in global band order: per-band f, side, prob state and local distance
    lists, then t) on rank 0, host tensors; None on the other ranks.  A
    collective in a multi-process run: every process calls it, whatever
    number of bands it holds (none included).  Every band's carry has one
    structure, so each process's leaves split into its bands by their
    count."""
    fs, sides, probs, pds, t = carry
    leaves, specs = [], []
    for band in zip(fs, sides, probs, pds):
        specs.append(_flatten(list(band), leaves))
    per_rank = distributed.gather_to_primary(leaves)
    if per_rank is None:
        return None
    if not specs:
        raise ValueError("rank 0 holds no band of the striped carry")
    n = len(leaves) // len(specs)         # leaves per band
    bands = [_unflatten(specs[0], rank_leaves[i:i + n])
             for rank_leaves in per_rank
             for i in range(0, len(rank_leaves), n)]
    fs, sides, probs, pds = (list(x) for x in zip(*bands))
    return (fs, sides, probs, pds, t)


def _own_bands(carry, mesh):
    """A whole striped carry -> this process's bands on their devices."""
    fs, sides, probs, pds, t = carry
    mine = range(mesh.first, mesh.first + len(mesh.devices))
    return tuple([_to(x[b], d) for b, d in zip(mine, mesh.devices)]
                 for x in (fs, sides, probs, pds)) + (t,)


def solve_striped_checkpointed(
    datas,
    quants,
    samps,
    weight: float,
    pweights,
    iterations: int,
    mesh,
    checkpoint_path: str,
    checkpoint_every: int = 100,
    simd_compat_logging: bool = True,
    body: Optional[str] = None,
    resume: bool = True,
) -> CheckpointedResult:
    """parallel/stripes.py::solve_striped over `mesh` in chunks of
    `checkpoint_every` iterations, snapshotting the carry of every band
    (gathered to rank 0 in global band order) after every chunk but the
    last.  On resume each process takes its own bands (mesh.first, one
    per entry of mesh.devices) to their devices.  Every process must
    call it.  The result equals solve_striped's bit for bit; its fdata
    is the whole [C, H, W] canvas on every process (gathered)."""
    problem = stripes._Striped(datas, quants, samps, weight, pweights,
                               iterations, simd_compat_logging, mesh, body)
    fp = striped_fingerprint(solver._geometry(datas, samps), mesh.n,
                             problem.body, weight, pweights, iterations,
                             simd_compat_logging)
    carry, metrics, start = _run_checkpointed(
        checkpoint_path, fp, resume, checkpoint_every, iterations,
        problem.initial_carry, lambda carry: _own_bands(carry, mesh),
        problem.run, gather_striped_carry)
    return CheckpointedResult(
        distributed.gather_output(problem.output(carry[0])), metrics, start)
