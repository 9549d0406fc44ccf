#!/usr/bin/env python3
"""The whole-solve kernel K3 (jpeg2png_tpu_torch/csrc/iter_step.cu, f32 and
lite mode) against an earlier version of the same source, on one CUDA card.

    git show <commit>:jpeg2png_tpu_torch/csrc/iter_step.cu \\
        > jpeg2png_tpu_torch/_build/parent/iter_step.cu
    python3 tools/torch_solve_compare.py \\
        --parent jpeg2png_tpu_torch/_build/parent/iter_step.cu

Builds the checkout's source (as the package does) and the earlier one under
another library name, with the same nvcc flags, and prints both ptxas
reports.  `--variant NAME=PATH` adds sources built from the checkout's
interface (the barrier-cost and residency experiments).  Then at the four
points where K3 runs -- photo512 (B = 1, 512x512), the 1.23 MP sweep image
(1280x960), the serving corpus's dyn 1024x1280 chunk (dynamic extents) and
the 3072x2048 smoke JPEG (static) -- in both modes:
  - every kernel against the plain PyTorch version with chip_smoke.py's
    gates (f32: 3 iterations elementwise on random data, 1 on a real
    state; lite: every iteration of a 3-iteration launch from the kernel's
    own state), bucket padding exactly 0;
  - the times of a 50-iteration launch in turns (earlier, new, new, earlier,
    each the median of back-to-back launches between CUDA events), beside
    the design-independent bound (chip_smoke._bound_k3: inputs read once,
    outputs written once, and the operations) and the per-iteration
    streaming figure (the state through device memory every iteration).
--state real takes real solver states (the mega tier after 3 iterations; the
serving chunk after 3 iterations of the checkout's kernel) instead of random
data.  Prints one JSON line last and writes it to
jpeg2png_tpu_torch/_build/solve_compare_<state>.json.  Needs a card.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import hashlib
import json
import math
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

POINTS = cs.K3_POINTS


def _edit(src: str, old: str, new: str) -> str:
    if old not in src:
        raise RuntimeError(f"experiment: the source has no {old!r}")
    return src.replace(old, new)


def _phase_clock(src: str) -> str:
    """clock64() around each phase of block 0, summed over the launch and
    printed at its end (cycles per iteration)."""
    src = _edit(src, "#include <stdint.h>\n", "#include <stdint.h>\n"
                "#include <cstdio>\n__device__ long long j2p_clk[8];\n")
    one = "if (blockIdx.x == 0 && threadIdx.x == 0) "
    src = _edit(src, "    // ---- A: the band into the tiles\n",
                "    const long long ta_ = clock64();\n"
                "    // ---- A: the band into the tiles\n")
    src = _edit(src, "    __syncthreads();\n\n    // ---- B: the coefficient",
                "    __syncthreads();\n    const long long tb_ = clock64();\n"
                f"    {one}j2p_clk[5] += tb_ - ta_;\n\n    // ---- B: the coefficient")
    src = _edit(src, "    __syncthreads();   // the tiles are free for the next band\n",
                "    __syncthreads();   // the tiles are free for the next band\n"
                f"    {one}j2p_clk[6] += clock64() - tb_;\n")
    src = _edit(src, "    const float factor = p.factors[it];\n\n    // ---- gradient",
                "    const float factor = p.factors[it];\n"
                "    const long long t0_ = clock64();\n\n    // ---- gradient")
    src = _edit(src, "    grid.sync();\n\n    // ---- norms",
                "    const long long t1_ = clock64();\n    grid.sync();\n"
                "    const long long t2_ = clock64();\n\n    // ---- norms")
    src = _edit(src, "    __syncthreads();\n\n    // ---- projection phase",
                "    __syncthreads();\n    const long long t3_ = clock64();\n\n"
                "    // ---- projection phase")
    src = _edit(src, "    grid.sync();\n  }\n\n  // the last iteration's distances\n",
                "    const long long t4_ = clock64();\n    grid.sync();\n"
                f"    {one}{{\n      j2p_clk[0] += t1_ - t0_;\n"
                "      j2p_clk[1] += t2_ - t1_;\n      j2p_clk[2] += t3_ - t2_;\n"
                "      j2p_clk[3] += t4_ - t3_;\n      j2p_clk[4] += clock64() - t4_;\n"
                "    }\n  }\n"
                f"  {one}{{\n    const double n = p.nsteps > 0 ? p.nsteps : 1;\n"
                '    printf("K3 phase clocks, block 0, cycles per iteration: '
                'gradient %.0f barrier1 %.0f norms %.0f projection %.0f '
                '(band copy %.0f, coefficients %.0f) barrier2 %.0f\\n", '
                "j2p_clk[0] / n, j2p_clk[1] / n, j2p_clk[2] / n, j2p_clk[3] / n, "
                "j2p_clk[5] / n, j2p_clk[6] / n, j2p_clk[4] / n);\n"
                "    for (int i = 0; i < 8; ++i) j2p_clk[i] = 0;\n  }\n\n"
                "  // the last iteration's distances\n")
    return src


# name -> edit of the checkout's iter_step.cu (--experiments)
EXPERIMENTS = {
    "no-projection": lambda s: _edit(
        s, "if (cell.live) project<C, LITE>",
        "if (cell.live && p.nsteps < 0) project<C, LITE>"),
    "no-gradient": lambda s: _edit(
        s, "if (cell.live) march<C, TGV, LITE>",
        "if (cell.live && p.nsteps < 0) march<C, TGV, LITE>"),
    # a third grid barrier each iteration, between the norms and the
    # projection: what one barrier costs
    "extra-barrier": lambda s: _edit(
        s, "    __syncthreads();\n\n    // ---- projection phase",
        "    grid.sync();\n\n    // ---- projection phase"),
    "two-blocks": lambda s: _edit(s, "constexpr int MIN_BLOCKS = 3;",
                                  "constexpr int MIN_BLOCKS = 2;"),
    "no-residency": lambda s: _edit(
        s, "constexpr bool ALLOW_RESIDENT = true;",
        "constexpr bool ALLOW_RESIDENT = false;"),
    "phase-clock": _phase_clock,
}


def build_others(sources):
    """nvcc other iter_step.cu sources ({name: path}) with the package's
    flags into _build/, all at once.  Returns {name: (library, ptxas log)}."""
    from jpeg2png_tpu_torch.kernels import _build

    extra = _build.LIBRARIES["iter_step"][1]
    flags = _build.ARCH_FLAGS + _build.COMMON_FLAGS + extra
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        src = pathlib.Path(src)
        h = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
        out = _build.BUILD_DIR / f"iter_step_{name}-{h.hexdigest()[:16]}.so"
        proc = None if out.exists() else subprocess.Popen(
            [_build.nvcc_path(), *flags, "-o", str(out), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        procs[name] = (out, proc)
    built = {}
    for name, (out, proc) in procs.items():
        log = ""
        if proc is not None:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"{name} build failed:\n{log}")
        built[name] = (ctypes.CDLL(str(out)), log)
    return built


def ptxas_summary(log: str):
    """One line per kernel instantiation of a ptxas -v report: (C, tgv,
    lite), registers, spill stores / loads."""
    lines, cur, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"solve_kernelILi(\d)ELb(\d)ELb(\d)E", line)
        if "Compiling entry" in line and m:
            cur = f"C={m[1]} tgv={m[2]} lite={m[3]}"
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line and cur is not None:
            regs = re.search(r"Used (\d+) registers", line)
            lines.append(f"{cur}: {regs[1] if regs else '?'} registers, "
                         f"{spill}")
            cur = None
    return lines


class Kernel:
    """One build of the K3 library, called with fused_solve's and
    fused_solve_lite's arguments.  The checkout's interface (a plan export,
    per-block scratch) or the earlier one (a grid export and a canvas-sized
    gradient buffer)."""

    def __init__(self, name, lib):
        from jpeg2png_tpu_torch.kernels import iter_step

        self.name, self.lib = name, lib
        self.old = not hasattr(lib, "j2p_fused_solve_plan")
        fn = lib.j2p_fused_solve
        fn.argtypes = iter_step._ARGTYPES
        fn.restype = ctypes.c_int
        self.fn = fn
        if self.old:
            grid = lib.j2p_fused_solve_grid
            grid.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
            grid.restype = ctypes.c_int
        else:
            pl = lib.j2p_fused_solve_plan
            pl.argtypes = iter_step._launcher()[0].j2p_fused_solve_plan.argtypes
            pl.restype = ctypes.c_int

    def plan(self, B, C, H, W, samps, prob, weight, lite):
        from jpeg2png_tpu_torch.kernels import _build, iter_step

        if self.old:
            n = ctypes.c_int(0)
            _build.check(self.lib, self.lib.j2p_fused_solve_grid(
                C, int(weight != 0.0), int(lite), ctypes.byref(n)), self.name)
            return {"G": n.value, "scratch_bytes": B * C * H * W
                    * (2 if lite else 4), "resident": False}
        return iter_step.launch_plan(B, C, H, W, samps, prob, weight, lite,
                                     self.lib)

    def solve(self, lite, f0s, side0s, devq0s, factors, step_size, datas, qs,
              pa_ss, samps, weight, extents=None):
        """fused_solve (lite=False) or fused_solve_lite (lite=True) on this
        library: the package wrapper's marshalling, this library's grid."""
        import numpy as np
        import torch

        from jpeg2png_tpu_torch.kernels import _build, iter_step

        f, side, devqs, dats, qrs = iter_step._as_batch(
            f0s, side0s, devq0s, datas, qs, extents)
        B, C, H, W = f.shape
        dev = f.device
        prob = [p != 0.0 for p in pa_ss]
        P = sum(prob)
        factors = torch.as_tensor(np.asarray(torch.as_tensor(factors).cpu(),
                                             np.float32), device=dev)
        nsteps = int(factors.shape[0])
        if extents is None:
            ext = torch.tensor([[H, W]], dtype=torch.int32, device=dev)
            steps = torch.tensor([float(step_size)], device=dev)
        else:
            ext, steps = extents, step_size
        f_out, side_out = f.clone(), side.clone()
        ptrs = (ctypes.c_uint64 * (3 * C))()
        pas = (ctypes.c_float * C)()
        dq_out, k = [], 0
        for c, (sy, sx) in enumerate(samps):
            ptrs[3 * c] = dats[c].data_ptr()
            ptrs[3 * c + 1] = qrs[c].data_ptr()
            if prob[c]:
                d = devqs[k].clone()
                dq_out.append(d)
                ptrs[3 * c + 2] = d.data_ptr()
                k += 1
            pas[c] = pa_ss[c] / (sy * sx)
        partials = torch.zeros((B, nsteps, iter_step.PARTIAL_COLS),
                               device=dev)
        pl = self.plan(B, C, H, W, samps, prob, weight, lite)
        G = pl["G"]
        if self.old:       # a canvas-sized gradient, [G, B, .] sums
            scratch = torch.empty((pl["scratch_bytes"],), dtype=torch.uint8,
                                  device=dev)
            gpart = torch.empty((G, B, C + 2), device=dev)
            dpart = torch.empty((G, B, max(P, 1)), device=dev)
        else:
            scratch, gpart, dpart = iter_step.launch_buffers(pl, B, C, P, dev)
        err = self.fn(f_out.data_ptr(), side_out.data_ptr(),
                      None if scratch is None else scratch.data_ptr(),
                      factors.data_ptr(), ext.data_ptr(), steps.data_ptr(),
                      partials.data_ptr(), gpart.data_ptr(), dpart.data_ptr(),
                      ptrs, iter_step._channel_ints(samps, prob), pas, B, C,
                      H, W, nsteps, G, 1.0 / math.sqrt(C),
                      (weight / math.sqrt(2.0)) / math.sqrt(C),
                      int(weight != 0.0), int(lite),
                      torch.cuda.current_stream().cuda_stream)
        _build.check(self.lib, err, self.name)
        if extents is None:
            return f_out[0], side_out[0], [d[0] for d in dq_out], partials[0]
        return f_out, side_out, dq_out, partials


@contextlib.contextmanager
def kernel_as_package(k: Kernel):
    """Point iter_step.fused_solve / fused_solve_lite at kernel k, so that
    chip_smoke.py's gates hold it."""
    from jpeg2png_tpu_torch.kernels import iter_step

    from jpeg2png_tpu_torch.models import solver

    saved = iter_step.fused_solve, iter_step.fused_solve_lite

    def solve(*a, extents=None, lite=False):
        if lite:
            fo, do, qo, po = k.solve(True, *iter_step._to_lite(*a[:3]),
                                     *a[3:], extents=extents)
            return iter_step._from_lite((fo, do, qo, po))
        return k.solve(False, *a, extents=extents)

    def solve_lite(*a, extents=None):
        return k.solve(True, *a, extents=extents)
    solve.launches = solve_lite.launches = 0
    iter_step.fused_solve, iter_step.fused_solve_lite = solve, solve_lite
    solver.fused_solve, solver.fused_solve_lite = solve, solve_lite
    try:
        yield
    finally:
        iter_step.fused_solve, iter_step.fused_solve_lite = saved
        solver.fused_solve, solver.fused_solve_lite = saved


def random_args(rng, point, chunk):
    """(f32 args, extents) of random data at `point`'s shape (50
    factors)."""
    s420 = cs.S420
    if point == "dyn1024x1280":
        from jpeg2png_tpu_torch import runner

        imgs, bucket = chunk
        exts = [runner.bucket_shape_for(im) for im in imgs]
        args, ext, _ = cs._k3_random_args(rng, len(exts), *bucket, s420,
                                          [True] * 3, 0.3, 50, exts=exts)
        return args, ext
    H, W = {"photo512": (512, 512), "1.23MP": (960, 1280),
            "3072x2048": (2048, 3072)}[point]
    args, ext, _ = cs._k3_random_args(rng, 1, H, W, s420, [True] * 3, 0.3, 50)
    return args, ext


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=pathlib.Path,
                    help="an earlier iter_step.cu to compare against")
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=PATH", help="another iter_step.cu with the "
                    "checkout's interface to time beside it (repeatable)")
    ap.add_argument("--experiments", default="",
                    help="comma-separated variants made from the checkout's "
                    "source: " + ", ".join(EXPERIMENTS))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--state", choices=("random", "real"), default="random")
    ap.add_argument("--points", default=",".join(POINTS),
                    help="comma-separated subset of " + ",".join(POINTS))
    ap.add_argument("--check", default="new,parent",
                    help="comma-separated kernels to hold against the plain "
                    "version (empty: time only)")
    ap.add_argument("--golden", action="store_true",
                    help="also photo512 at -i 1000 through the mega and "
                    "mega-lite tiers on each kernel, PSNR against the "
                    "reference's converged golden")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_solve_compare: needs a CUDA card", file=sys.stderr)
        return 2
    from jpeg2png_tpu_torch.kernels import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"SM clock, max SM clock: {clocks}", flush=True)
    _build.build(["iter_step"])
    kernels = {"new": Kernel("new", _build.library("iter_step"))}
    reports = {"new": _build.build_log.get("iter_step", "")}
    others = [("parent", args.parent)] if args.parent is not None else []
    others += [tuple(v.split("=", 1)) for v in args.variant]
    exp_dir = _build.BUILD_DIR / "experiments"
    exp_dir.mkdir(parents=True, exist_ok=True)
    source = (_build.CSRC / "iter_step.cu").read_text()
    for name in filter(None, args.experiments.split(",")):
        path = exp_dir / f"{name}.cu"
        path.write_text(EXPERIMENTS[name](source))
        others.append((name, path))
    for name, (lib, log) in build_others(dict(others)).items():
        kernels[name], reports[name] = Kernel(name, lib), log
    for name, text in reports.items():
        for line in ptxas_summary(text):
            print(f"  ptxas {name}: {line}", flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(6)
    from jpeg2png_tpu_torch.io import read_jpeg

    chunk = cs.bucket_chunk([read_jpeg(f)
                             for f in sorted(cs.SERVING.glob("*.jpg"))])
    result = {"card": card, "state": args.state, "points": {}}
    ok = True
    names = [n for n in kernels if n != "new"] + ["new"]
    order = names + names[::-1]
    if args.golden:
        result["golden_i1000_psnr"] = {}
        for name, k in kernels.items():
            with kernel_as_package(k):
                for tier in ("mega", "mega-lite"):
                    p = cs.golden_i1000(tier)
                    result["golden_i1000_psnr"][f"{name} {tier}"] = p
                    print(f"  golden photo512 i1000 {tier} tier, {name} "
                          f"kernel: PSNR {p:.2f} dB  [{card}]", flush=True)
    for point in args.points.split(","):
        a32, ext = (cs.k3_point_args(point, chunk) if args.state == "real"
                    else random_args(rng, point, chunk))
        f = a32[0]
        B = f.shape[0] if ext is not None else 1
        H, W = f.shape[-2:]
        samps = a32[8]
        prob = [p != 0.0 for p in a32[7]]
        kw = {} if ext is None else {"extents": ext}
        for lite in (False, True):
            mode = "lite" if lite else "f32"
            label = f"{point} {mode}"
            a = cs.lite_state(a32) if lite else a32
            row = {"B": B, "H": H, "W": W, "nsteps": len(a[3])}
            row["bound_ms"], row["stream_ms_per_iter"] = cs.k3_bounds(
                a, ext, lite)
            row["plan"] = kernels["new"].plan(B, 3, H, W, samps, prob, 0.3,
                                              lite)
            for name, k in kernels.items():
                if name not in args.check.split(","):
                    continue
                try:
                    with kernel_as_package(k):
                        n = 1 if args.state == "real" else 3
                        chk = a[:3] + (a[3][:n],) + a[4:]
                        if lite:
                            err = cs._k3_lite_compare(f"{label} {name}", chk,
                                                      **kw)
                        else:
                            err = cs._k3_compare(f"{label} {name}", chk, n,
                                                 **kw)
                    row[f"{name}_max_abs_err"] = err
                except (cs.SmokeFailure, RuntimeError) as e:
                    print(f"  {label} {name}: FAILED {e}", flush=True)
                    row[f"{name}_failed"] = str(e)
                    ok = False
            runs = {n: [] for n in kernels}
            for name in order:
                k = kernels[name]
                try:
                    runs[name].append(cs.cuda_ms(
                        lambda k=k: k.solve(lite, *a, **kw), args.reps))
                except RuntimeError as e:
                    print(f"  {label} {name}: not timed: {e}", flush=True)
                    runs[name].append(math.nan)
            for name in kernels:
                row[f"{name}_ms"] = runs[name]
                row[f"{name}_ms_per_iter"] = min(runs[name]) / len(a[3])
            for name in kernels:
                print(f"  {label} [B={B}, {H}x{W}] {name}: ms per 50-iteration "
                      f"launch in turns {runs[name]} -> "
                      f"{row[f'{name}_ms_per_iter']:.4f} ms per iteration; "
                      f"bound {row['bound_ms']:.4f} ms per launch, streaming "
                      f"{row['stream_ms_per_iter']:.4f} ms per iteration"
                      f"  [{card}]", flush=True)
            for name in kernels:
                if name != "new":
                    row[f"new_over_{name}"] = (row["new_ms_per_iter"]
                                               / row[f"{name}_ms_per_iter"])
            result["points"][label] = row
            del a
        del a32, f
        torch.cuda.empty_cache()
    result["ok"] = ok
    line = json.dumps(result)
    out = ROOT / "jpeg2png_tpu_torch" / "_build"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"solve_compare_{args.state}.json").write_text(line + "\n")
    print(line)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
