#!/usr/bin/env python3
"""The K1/K7 gradient kernel (jpeg2png_tpu_torch/csrc/grad_step.cu) against
an earlier version of the same source, on one CUDA card.

    git show <commit>:jpeg2png_tpu_torch/csrc/grad_step.cu \
        > jpeg2png_tpu_torch/_build/parent/grad_step.cu
    python3 tools/torch_grad_compare.py \
        --parent jpeg2png_tpu_torch/_build/parent/grad_step.cu

Builds the checkout's source (as the package does) and the earlier one
under another library name, with the same nvcc flags, and prints both
ptxas reports.  Then, at K1's shape ([3, 2048, 3072], the 3072x2048
default decode) and K7's ([3, 2048, 12288] with random halo rows, one band
of the 100.7 MP striped problem):
  - both kernels against the plain PyTorch version (K1's gates) and
    against each other (the gradient and extrapolation bit for bit: both
    round op for op, -fmad=false);
  - their times in turns (earlier, new, new, earlier), each the median of
    back-to-back launches between CUDA events, beside the bytes bound
    (inputs read once, outputs written once, over 3.35 TB/s), with
    chip_smoke.py's helpers and bound;
  - the split between the gradient kernel and the reduction of its
    partial sums, from torch.profiler's device times per kernel.
--state real takes the real solver states chip_smoke.py times the two on
instead of random data.  Without --parent only the checkout's kernel is
measured.  Prints one JSON line last and writes it to
jpeg2png_tpu_torch/_build/grad_compare_<state>.json.  Needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import math
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import PEAK_BYTES, _bytes_k1, _grad_split, cuda_ms  # noqa: E402


def build_parent(src: pathlib.Path, name: str) -> tuple[ctypes.CDLL, str]:
    """nvcc another source with the package's flags into _build/."""
    from jpeg2png_tpu_torch.kernels import _build

    extra = _build.LIBRARIES["grad_step"][1]
    flags = _build.ARCH_FLAGS + _build.COMMON_FLAGS + extra
    h = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    out = _build.BUILD_DIR / f"grad_step_{name}-{h.hexdigest()[:16]}.so"
    log = ""
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run([_build.nvcc_path(), *flags, "-o", str(out),
                               str(src)], capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"{name} build failed:\n{log}")
    return ctypes.CDLL(str(out)), log


class Kernel:
    """One build of the gradient library, called as the wrapper calls it."""

    def __init__(self, name, lib):
        from jpeg2png_tpu_torch.kernels import grad_step

        self.name, self.lib = name, lib
        fn = lib.j2p_fused_grad_striped
        fn.argtypes = grad_step._ARGTYPES
        fn.restype = ctypes.c_int
        self.fn = fn
        self.rows = getattr(lib, "j2p_grad_partial_rows", None)
        if self.rows is not None:
            self.rows.argtypes = [ctypes.c_int] * 4
            self.rows.restype = ctypes.c_int

    def partial_rows(self, C, tgv, L, W) -> int:
        if self.rows is None:           # the 16 x 32 tile of earlier sources
            return -(-L // 16) * -(-W // 32)
        return self.rows(C, int(tgv), L, W)

    def __call__(self, f, fi, pgs, halos, factor, weight, row0, ht, wt):
        import torch

        from jpeg2png_tpu_torch.kernels import _build, grad_step

        C, L, W = f.shape
        pg = [p for p in pgs if p is not None]
        pg = grad_step.stack_channels(pg) if pg else None
        pidx, k = [-1] * grad_step.MAX_CHANNELS, 0
        for c, p in enumerate(pgs):
            if p is not None:
                pidx[c], k = k, k + 1
        hl = [None] * 4 if halos is None else list(halos)
        grad, extrap = torch.empty_like(f), torch.empty_like(f)
        part = torch.empty((self.partial_rows(C, weight != 0.0, L, W), C + 2),
                           device=f.device)
        out = torch.empty((C + 2,), device=f.device)
        err = self.fn(f.data_ptr(), fi.data_ptr(),
                      *(None if h is None else h.data_ptr() for h in hl),
                      None if pg is None else pg.data_ptr(), grad.data_ptr(),
                      extrap.data_ptr(), part.data_ptr(), out.data_ptr(), C, L,
                      W, row0, ht, wt, factor, 1.0 / math.sqrt(C),
                      grad_step.tgv_alpha(C, weight), int(weight != 0.0),
                      *pidx, torch.cuda.current_stream().cuda_stream)
        _build.check(self.lib, err, self.name)
        return grad, extrap, out


def problem(rng, C, L, W, halo, prob=True):
    import numpy as np
    import torch

    def t(shape, sd):
        return torch.as_tensor(rng.normal(0, sd, shape).astype(np.float32),
                               device="cuda")
    f = t((C, L, W), 50)
    fi = f + t((C, L, W), 2)
    pg = t((C, L, W), 1)
    pgs = [pg[c] if prob else None for c in range(C)]
    halos = tuple(t((C, 2, W), 50) for _ in range(4)) if halo else None
    return f, fi, pgs, halos


def real_problems():
    """K1's and K7's inputs on a real solver state (in Kernel's argument
    order), as chip_smoke.py times them: the 3072x2048 smoke JPEG after 3 two-tier iterations, and band
    1 of its blocks tiled 4 x 4 (100.7 MP, 4 bands on the card) after 3
    striped iterations."""
    import numpy as np
    import torch

    from jpeg2png_tpu_torch.io import read_jpeg
    from jpeg2png_tpu_torch.models import solver
    from jpeg2png_tpu_torch.parallel import stripes
    from jpeg2png_tpu_torch.parallel.mesh import stripe_mesh

    img = read_jpeg(ROOT / "tests" / "fixtures"
                    / "torch_smoke_art3072x2048_q30_420.jpg")
    datas = [p.data for p in img.planes]
    quants = [p.quant for p in img.planes]
    samps = [(p.h_samp, p.w_samp) for p in img.planes]
    _, _, carry = solver.solve_steps(datas, quants, samps, 0.3, [0.001] * 3,
                                     50, nsteps=3, device="cuda", tier="two")
    fd, fi, pgs = carry[0], carry[1], list(carry[2])
    k1 = (fd, fi, pgs, None, 0.5, 0.3, 0, fd.shape[1], fd.shape[2])
    dev = torch.device("cuda", torch.cuda.current_device())
    tiled = ([np.tile(d, (4, 4, 1, 1)) for d in datas], quants, samps, 0.3,
             [0.001] * 3, 50)
    problem = stripes._Striped(*tiled, True, stripe_mesh(4, [dev] * 4),
                               "f32")
    carry, _ = problem.run(problem.initial_carry(), 3)
    fs, fis, pgb = carry[:3]
    above, below = problem._exchange(fs, fis)
    C = 3
    k7 = (fs[1], fis[1], list(pgb[1]),
          (above[1][:C], below[1][:C], above[1][C:], below[1][C:]), 0.5,
          0.3, problem.row0s[1], problem.H, problem.W)
    return k1, k7


def check(label, got, ref):
    """K1's gates: gradient within 1e-5 of its magnitude, extrap 1e-6 of
    its magnitude, the sums rtol 1e-5; returns the max abs errors."""
    g_err = float((got[0] - ref[0]).abs().max())
    e_err = float((got[1] - ref[1]).abs().max())
    s_rel = float(((got[2] - ref[2]).abs()
                   / ref[2].abs().clamp_min(1e-30)).max())
    g_tol = 1e-5 * max(1.0, float(ref[0].abs().max()))
    e_tol = 1e-6 * float(ref[1].abs().max())
    ok = g_err <= g_tol and e_err <= e_tol and s_rel <= 1e-5
    print(f"  {label}: grad err {g_err:.3g} (tol {g_tol:.3g}), extrap err "
          f"{e_err:.3g}, sums rel {s_rel:.3g} {'ok' if ok else 'FAILED'}",
          flush=True)
    return ok, g_err


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=pathlib.Path,
                    help="an earlier grad_step.cu to compare against")
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=PATH", help="another grad_step.cu to time "
                    "beside the checkout's (repeatable)")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--state", choices=("random", "real"), default="random",
                    help="random data, or the real solver states "
                    "chip_smoke.py times K1 and K7 on")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_grad_compare: needs a CUDA card", file=sys.stderr)
        return 2
    from jpeg2png_tpu_torch.kernels import _build, grad_step, stripe_grad

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    _build.build(["grad_step"])
    kernels = {"new": Kernel("new", _build.library("grad_step"))}
    reports = {"new": _build.build_log.get("grad_step", "")}
    others = [("parent", args.parent)] if args.parent is not None else []
    others += [tuple(v.split("=", 1)) for v in args.variant]
    for name, path in others:
        lib, reports[name] = build_parent(pathlib.Path(path), name)
        kernels[name] = Kernel(name, lib)
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  ptxas {name}: {line.strip()}", flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(5)
    result = {"card": card, "state": args.state, "shapes": {}}
    ok = True
    real = real_problems() if args.state == "real" else None
    for i, (label, C, L, W, halo, row0, ht) in enumerate((
            ("K1", 3, 2048, 3072, False, 0, 2048),
            ("K7", 3, 2048, 12288, True, 2048, 8192))):
        if real is None:
            f, fi, pgs, halos = problem(rng, C, L, W, halo)
            a = (f, fi, pgs, halos, 0.5, 0.3, row0, ht, W)
        else:
            a = real[i]
            f, fi, pgs, halos = a[:4]
            row0, ht, W = a[6], a[7], a[8]
        ref = stripe_grad.fused_grad_striped_plain(
            f, fi, pgs, halos, 0.5, row0, 0.3, ht, W)
        outs = {}
        row = {"shape": [C, L, W], "bound_ms":
               _bytes_k1(C, C, L, W, halo) / PEAK_BYTES * 1e3}
        for name, k in kernels.items():
            outs[name] = k(*a)
            torch.cuda.synchronize()
            good, err = check(f"{label} {name} vs plain", outs[name],
                              (ref[0], ref[1], torch.cat(
                                  [ref[2], ref[3][None], ref[4][None]])))
            ok &= good
            row[f"{name}_max_abs_err"] = err
            row[f"{name}_partial_rows"] = k.partial_rows(C, True, L, W)
        for name in outs:
            if name != "new":
                same = (torch.equal(outs["new"][0], outs[name][0])
                        and torch.equal(outs["new"][1], outs[name][1]))
                row[f"bit_equal_to_{name}"] = same
                print(f"  {label}: grad and extrap bit-equal to {name}'s: "
                      f"{same}", flush=True)
        # in turns: the others, new, then the same in reverse
        names = [n for n in kernels if n != "new"] + ["new"]
        order = names + names[::-1]
        runs = {n: [] for n in kernels}
        for name in order:
            runs[name].append(cuda_ms(lambda k=kernels[name]: k(*a),
                                      args.reps))
        for name in kernels:
            row[f"{name}_ms"] = runs[name]
            row[f"{name}_split_ms"] = _grad_split(kernels[name], a)
        best = {n: min(v) for n, v in runs.items()}
        for name in kernels:
            print(f"  {label} [{C}, {L}, {W}] {name}: ms in turns "
                  f"{runs[name]}, split {row[f'{name}_split_ms']}; bound "
                  f"{row['bound_ms']:.4f} ms  [{card}]", flush=True)
        for name in best:
            if name != "new":
                row[f"new_over_{name}"] = best["new"] / best[name]
        row["new_share_of_bound"] = row["bound_ms"] / best["new"]
        result["shapes"][label] = row
        del f, fi, pgs, halos, a, ref, outs
        torch.cuda.empty_cache()
    result["ok"] = ok
    line = json.dumps(result)
    out = ROOT / "jpeg2png_tpu_torch" / "_build"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"grad_compare_{args.state}.json").write_text(line + "\n")
    print(line)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
