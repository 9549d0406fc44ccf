#!/usr/bin/env python3
"""The lite band gradient K4 (jpeg2png_tpu_torch/csrc/stripe_grad.cu)
against an earlier version of the same source, on one CUDA card.

    git show <commit>:jpeg2png_tpu_torch/csrc/stripe_grad.cu \\
        > jpeg2png_tpu_torch/_build/parent/stripe_grad.cu
    python3 tools/torch_lite_grad_compare.py \\
        --parent jpeg2png_tpu_torch/_build/parent/stripe_grad.cu

Builds the checkout's source (as the package does), the earlier one and the
experiments (variants made from the checkout's source: `no-prob` skips the
prob phase, its copies, transforms and window reads) under other library
names, all at once with the package's nvcc flags, and prints each ptxas
report.  Then at three shapes -- the two-lite tier's [3, 2048, 3072] 4:2:0
canvas, the striped lite body's band [3, 2048, 12288] with halo rows at
row0 = 2048 (a middle band of the 100.7 MP problem), and the largest dyn2
bucket of chip_smoke.py's every-class serving run (dynamic extents):
  - every kernel but the experiments against the plain PyTorch version
    with chip_smoke.py's K4 gates, and, with the prob term off, against
    each other bit for bit (bf16 gradient) and against the plain version;
  - the times in turns (earlier, experiments, new, new, experiments,
    earlier; each the median of back-to-back launches between CUDA events)
    beside chip_smoke._bound_k4 (inputs read once, outputs written once,
    over 3.35 TB/s, or the operations over 67 TFLOP/s).
--state real takes real solver states (3 iterations of the two-lite tier
on the smoke JPEG; of the striped lite body on the 100.7 MP problem, 4
bands on the card; of the two-lite tier on the dyn2 bucket's largest image,
zero-padded into the bucket) instead of random data.  Prints one JSON line
last and writes it to jpeg2png_tpu_torch/_build/lite_grad_compare_<state>
.json.  Needs a card.
"""

from __future__ import annotations

import argparse
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

S420 = [(1, 1), (2, 2), (2, 2)]


def _edit(src: str, old: str, new: str) -> str:
    if old not in src:
        raise RuntimeError(f"experiment: the source has no {old!r}")
    return src.replace(old, new)


# name -> edit of the checkout's stripe_grad.cu (--experiments)
EXPERIMENTS = {
    "no-prob": lambda s: _edit(s, "const bool prob = pm != 0;",
                               "const bool prob = false;"),
    # the in-march devq copies skipped (the windows then read stale rows)
    "no-copies": lambda s: _edit(
        s, "            if ((nb << (3 + p.lsy[c])) < s1) load_dq(c, nb);",
        "            if (p.L < 0) load_dq(c, nb);"),
    # the in-march transforms skipped (copies, barrier and reads kept)
    "no-transform": lambda s: _edit(s, "if (now) {\n        transform(now);",
                                    "if (now) {\n        if (p.L < 0) "
                                    "transform(now);"),
    # the gather's window reads skipped
    "no-window": lambda s: _edit(
        s, "        if (prob && ((pm >> c) & 1)) g = g + pt[c];",
        "        if (prob && p.L < 0) g = g + pt[c];"),
    # the barrier after an in-march transform dropped (a race: timing only)
    "no-barrier": lambda s: _edit(
        s, "        transform(now);\n        __syncthreads();\n",
        "        transform(now);\n"),
}


def build_others(sources):
    """nvcc other stripe_grad.cu sources ({name: path}) with the package's
    flags into _build/, all at once.  Returns {name: (library, log)}."""
    from jpeg2png_tpu_torch.kernels import _build

    flags = (_build.ARCH_FLAGS + _build.COMMON_FLAGS
             + _build.LIBRARIES["stripe_grad"][1])
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        src = pathlib.Path(src)
        h = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
        out = _build.BUILD_DIR / f"stripe_grad_{name}-{h.hexdigest()[:16]}.so"
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
    """One line per kernel instantiation of a ptxas -v report: (C, tgv),
    registers, spill stores / loads."""
    lines, cur, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"grad_lite_kernelILi(\d)ELb(\d)E", line)
        if "Compiling entry" in line and m:
            cur = f"C={m[1]} tgv={m[2]}"
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line and cur is not None:
            regs = re.search(r"Used (\d+) registers", line)
            smem = re.search(r"(\d+) bytes smem", line)
            lines.append(f"{cur}: {regs[1] if regs else '?'} registers, "
                         f"{smem[1] if smem else '?'} bytes static smem, "
                         f"{spill}")
            cur = None
    return lines


class Kernel:
    """One build of the K4 library, called with fused_grad_striped_lite's
    arguments as the wrapper calls it."""

    def __init__(self, name, lib):
        from jpeg2png_tpu_torch.kernels import stripe_grad

        self.name, self.lib = name, lib
        self.fn = lib.j2p_fused_grad_lite
        self.fn.argtypes = stripe_grad._ARGTYPES
        self.fn.restype = ctypes.c_int
        self.rows = getattr(lib, "j2p_grad_lite_partial_rows", None)
        if self.rows is not None:
            self.rows.argtypes = [ctypes.c_int] * 4
            self.rows.restype = ctypes.c_int

    def partial_rows(self, C, tgv, L, W) -> int:
        if self.rows is None:           # the 16 x 32 tile of earlier sources
            return -(-L // 16) * -(-W // 32)
        return self.rows(C, int(tgv), L, W)

    def __call__(self, f, d, devqs, halos, factor, row0, weight, samps,
                 pa_ss, h_pad, h_true, w_true, extents=None):
        import torch

        from jpeg2png_tpu_torch.kernels import _build, grad_step

        C, L, W = f.shape
        ptrs = (ctypes.c_uint64 * C)()
        ints = (ctypes.c_int * (2 * C))()
        pas = (ctypes.c_float * C)()
        it = iter(devqs)
        for c, (sy, sx) in enumerate(samps):
            ints[2 * c:2 * c + 2] = [sy, sx]
            if pa_ss[c] != 0.0:
                ptrs[c] = next(it).data_ptr()
                pas[c] = pa_ss[c] / (sy * sx)
        grad = torch.empty((C, L, W), device=f.device, dtype=torch.bfloat16)
        part = torch.empty((self.partial_rows(C, weight != 0.0, L, W), C + 2),
                           device=f.device)
        out = torch.empty((C + 2,), device=f.device)
        hp = [None] * 4 if halos is None else [h.data_ptr() for h in halos]
        ext = None if extents is None else extents.data_ptr()
        err = self.fn(f.data_ptr(), d.data_ptr(), *hp, grad.data_ptr(),
                      part.data_ptr(), out.data_ptr(), ext, ptrs, ints, pas,
                      C, L, W, row0, h_true, w_true, factor,
                      1.0 / math.sqrt(C), grad_step.tgv_alpha(C, weight),
                      int(weight != 0.0),
                      torch.cuda.current_stream().cuda_stream)
        _build.check(self.lib, err, self.name)
        return grad, out[:C], out[C], out[C + 1]


def dyn2_bucket(images):
    """(bucket (HB, WB), its samps, the index of its largest member) of
    the largest dyn2 bucket of the every-class serving run."""
    from jpeg2png_tpu_torch import runner

    with cs.gates(1280 * 1024, 1536 * 2048, 1 << 62):
        plan = runner.plan_buckets(images, [0.001] * 3)
    key, members = max(((k, v) for k, v in plan.items() if k[0] == "dyn2"),
                       key=lambda kv: kv[0][1] * kv[0][2])
    big = max(members, key=lambda i: images[i].height * images[i].width)
    return key[1:3], [tuple(s) for s in key[3]], big


def random_args(rng, C, L, W, row0, h_pad, halo, samps=S420, ext=None):
    """chip_smoke._k4_case's random state, every prob channel on; `ext`
    (h, w): dynamic extents."""
    import numpy as np
    import torch

    f, d = cs._rand_state(rng, (C, L, W))
    devqs = [torch.as_tensor(rng.normal(0, 0.1, (L // sy, W // sx)).astype(
        np.float32), device="cuda").to(torch.bfloat16) for sy, sx in samps]
    halos = None
    if halo:
        (ft, dt), (fb, db) = (cs._rand_state(rng, (C, 2, W)) for _ in range(2))
        halos = (ft, fb, dt, db)
    pa_ss = [10.0 * sy * sx for sy, sx in samps]
    extents = (None if ext is None else
               torch.tensor(ext, dtype=torch.int32, device="cuda"))
    h_true, w_true = ext or (h_pad, W)
    return (f, d, devqs, halos, 0.5, row0, 0.3, samps, pa_ss, h_pad, h_true,
            w_true, extents)


def real_args(bucket, big_img):
    """The three shapes' inputs on real solver states (see the module
    docstring), in Kernel's argument order."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from jpeg2png_tpu_torch.io import read_jpeg
    from jpeg2png_tpu_torch.models import solver
    from jpeg2png_tpu_torch.parallel import stripes
    from jpeg2png_tpu_torch.parallel.mesh import stripe_mesh

    img = read_jpeg(cs.SMOKE_JPEG)
    datas, quants, samps = cs._args(img)
    pw = [0.001] * 3
    pa, _ = solver.objective_alphas(0.3, pw, 3)
    pa_ss = [a * sy * sx for a, (sy, sx) in zip(pa, samps)]
    _, _, carry = solver.solve_steps(datas, quants, samps, 0.3, pw, 50,
                                     nsteps=3, device="cuda", tier="two-lite")
    H, W = carry[0].shape[1:]
    canvas = (carry[0], carry[1], list(carry[2]), None, 0.5, 0, 0.3, samps,
              pa_ss, H, H, W, None)

    dev = torch.device("cuda", torch.cuda.current_device())
    tiled = ([np.tile(x, (4, 4, 1, 1)) for x in datas], quants, samps, 0.3,
             pw, 50)
    problem = stripes._Striped(*tiled, True, stripe_mesh(4, [dev] * 4),
                               "lite")
    bc, _ = problem.run(problem.initial_carry(), 3)
    above, below = problem._exchange(bc[0], bc[1])
    C = 3
    halos = (above[1][:C].contiguous(), below[1][:C].contiguous(),
             above[1][C:].to(torch.bfloat16), below[1][C:].to(torch.bfloat16))
    band = (bc[0][1], bc[1][1], list(bc[2][1]), halos, 0.5,
            problem.row0s[1], 0.3, samps, pa_ss, problem.H2, problem.H,
            problem.W, None)
    del problem, bc, above, below

    HB, WB = bucket
    datas, quants, samps = cs._args(big_img)
    _, _, carry = solver.solve_steps(datas, quants, samps, 0.3, pw, 50,
                                     nsteps=3, device="cuda", tier="two-lite")

    def pad(x, sy=1, sx=1):
        return F.pad(x, (0, WB // sx - x.shape[-1],
                         0, HB // sy - x.shape[-2])).contiguous()

    ext = torch.tensor([big_img.height, big_img.width], dtype=torch.int32,
                       device="cuda")
    dyn2 = (pad(carry[0]), pad(carry[1]),
            [pad(q, sy, sx) for q, (sy, sx) in zip(carry[2], samps)], None,
            0.5, 0, 0.3, samps, pa_ss, HB, HB, WB, ext)
    return canvas, band, dyn2


def check(label, got, ref):
    """chip_smoke._k4_case's gates: the bf16 gradient within one bf16 step
    plus 1e-5 of its magnitude, the sums rtol 1e-5."""
    try:
        floor = 1e-5 * max(1.0, float(ref[0].float().abs().max()))
        err = cs.bf16_gate(label, "grad", got[0], ref[0], floor)
        for name, a, b in (("sumsq", got[1], ref[1]), ("tv", got[2], ref[2]),
                           ("tv2", got[3], ref[3])):
            cs._rel_gate(label, name, a, b, 1e-5)
    except cs.SmokeFailure as e:
        print(f"  {label}: FAILED {e}", flush=True)
        return False, None
    print(f"  {label}: grad err {err:.3g}, sums ok", flush=True)
    return True, err


def no_prob(a):
    """The same call with every prob term off."""
    samps = a[7]
    return a[:2] + ([],) + a[3:8] + ([0.0] * len(samps),) + a[9:]


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=pathlib.Path,
                    help="an earlier stripe_grad.cu to compare against")
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=PATH", help="another stripe_grad.cu to time "
                    "beside the checkout's (repeatable)")
    ap.add_argument("--experiments", default="no-prob",
                    help="comma-separated variants made from the checkout's "
                    "source: " + ", ".join(EXPERIMENTS))
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--state", choices=("random", "real"), default="random")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_lite_grad_compare: needs a CUDA card", file=sys.stderr)
        return 2
    from jpeg2png_tpu_torch.io import read_jpeg
    from jpeg2png_tpu_torch.kernels import _build, stripe_grad

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    others = [("parent", args.parent)] if args.parent is not None else []
    others += [tuple(v.split("=", 1)) for v in args.variant]
    exp_dir = _build.BUILD_DIR / "experiments"
    exp_dir.mkdir(parents=True, exist_ok=True)
    source = (_build.CSRC / "stripe_grad.cu").read_text()
    experiments = [n for n in args.experiments.split(",") if n]
    for name in experiments:
        path = exp_dir / f"stripe_grad_{name}.cu"
        path.write_text(EXPERIMENTS[name](source))
        others.append((name, path))
    _build.build(["stripe_grad"])
    kernels = {"new": Kernel("new", _build.library("stripe_grad"))}
    reports = {"new": _build.build_log.get("stripe_grad", "")}
    for name, (lib, log) in build_others(dict(others)).items():
        kernels[name], reports[name] = Kernel(name, lib), log
    for name, text in reports.items():
        for line in ptxas_summary(text):
            print(f"  ptxas {name}: {line}", flush=True)

    images = [read_jpeg(f) for f in sorted(cs.SERVING.glob("*.jpg"))]
    bucket, samps, big = dyn2_bucket(images)
    print(f"  the largest dyn2 bucket: {bucket[0]}x{bucket[1]}, its largest "
          f"image {images[big].height}x{images[big].width}", flush=True)
    rng = np.random.default_rng(7)
    if args.state == "real":
        shapes = dict(zip(("3072x2048", "band", "dyn2"),
                          real_args(bucket, images[big])))
    else:
        shapes = {
            "3072x2048": random_args(rng, 3, 2048, 3072, 0, 2048, False),
            "band": random_args(rng, 3, 2048, 12288, 2048, 8192, True),
            "dyn2": random_args(rng, 3, *bucket, 0, bucket[0], False, samps,
                                (images[big].height, images[big].width)),
        }
    result = {"card": card, "state": args.state, "shapes": {}}
    ok = True
    checked = [n for n in kernels if n not in experiments]
    names = [n for n in kernels if n != "new"] + ["new"]
    order = names + names[::-1]
    for label, a in shapes.items():
        f = a[0]
        C, L, W = f.shape
        prob = [p != 0.0 for p in a[8]]
        nbytes, ops = cs._bound_k4(C, L, W, a[7], prob)
        t_b, t_o = nbytes / cs.PEAK_BYTES * 1e3, ops / cs.PEAK_F32 * 1e3
        row = {"shape": [C, L, W], "row0": a[5], "bound_ms": max(t_b, t_o),
               "bound_by": "bytes" if t_b >= t_o else "operations"}
        for name in kernels:
            row[f"{name}_partial_rows"] = kernels[name].partial_rows(
                C, True, L, W)
        ref = stripe_grad.fused_grad_striped_lite_plain(*a)
        for name in checked:
            good, err = check(f"{label} {name} vs plain", kernels[name](*a),
                              ref)
            ok &= good
            row[f"{name}_max_abs_err"] = err
        # without a prob term: bit-equal to the plain version and each other
        a0 = no_prob(a)
        ref0 = stripe_grad.fused_grad_striped_lite_plain(*a0)
        outs = {n: kernels[n](*a0)[0] for n in checked}
        for name, g in outs.items():
            same = bool(torch.equal(g, ref0[0]))
            row[f"{name}_no_prob_bit_equal_to_plain"] = same
            ok &= same
            if name != "new":
                same = bool(torch.equal(outs["new"], g))
                row[f"no_prob_bit_equal_to_{name}"] = same
                ok &= same
            print(f"  {label} {name} without a prob term: bit-equal to the "
                  f"plain version {row[f'{name}_no_prob_bit_equal_to_plain']}"
                  + ("" if name == "new" else
                     f", new bit-equal to {name} {same}"), flush=True)
        del ref, ref0, outs
        runs = {n: [] for n in kernels}
        for name in order:
            runs[name].append(cs.cuda_ms(lambda k=kernels[name]: k(*a),
                                         args.reps))
        best = {n: min(v) for n, v in runs.items()}
        for name in kernels:
            row[f"{name}_ms"] = runs[name]
            print(f"  {label} [{C}, {L}, {W}] {name}: ms in turns "
                  f"{runs[name]}; bound {row['bound_ms']:.4f} ms "
                  f"({row['bound_by']})  [{card}]", flush=True)
        for name in best:
            if name != "new":
                row[f"new_over_{name}"] = best["new"] / best[name]
        row["new_share_of_bound"] = row["bound_ms"] / best["new"]
        result["shapes"][label] = row
        torch.cuda.empty_cache()
    result["ok"] = ok
    line = json.dumps(result)
    out = _build.BUILD_DIR
    out.mkdir(parents=True, exist_ok=True)
    (out / f"lite_grad_compare_{args.state}.json").write_text(line + "\n")
    print(line)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
