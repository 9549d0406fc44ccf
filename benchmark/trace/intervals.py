"""Interval arithmetic over a profiler trace, and the names the benchmark
gives to what it finds there.

Copied from the port's utils/profiling.py (trace_breakdown's helpers),
frozen with the benchmark: the union, intersection and difference of
sorted interval lists, the K-numbers of the port's hand-written CUDA
kernels by kernel name, short names for PyTorch's device ops, and the
classes of what the host was doing while the device idled.
"""

from __future__ import annotations


def union(ivs):
    out = []
    for a, b in sorted(ivs):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def intersect(xs, ys):
    """Intersection of two sorted disjoint interval lists."""
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if a < b:
            out.append([a, b])
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(xs, ys):
    """xs minus ys, both sorted disjoint interval lists."""
    out, j = [], 0
    for a, b in xs:
        while j < len(ys) and ys[j][1] <= a:
            j += 1
        k = j
        while k < len(ys) and ys[k][0] < b:
            if ys[k][0] > a:
                out.append([a, ys[k][0]])
            a = max(a, ys[k][1])
            k += 1
        if a < b:
            out.append([a, b])
    return out


def length(ivs) -> float:
    return sum(b - a for a, b in ivs)


# CUDA kernel name (the port's csrc/*.cu) -> the K-numbers whose wrapper
# launches it
KERNELS = {
    "grad_kernel": ("K1", "K7"),
    "reduce_columns": ("K1", "K7", "K4"),
    "project_kernel": ("K2",),
    "project_one_kernel": ("K6",),
    "reduce_dists": ("K2", "K6", "K5"),
    "solve_kernel": ("K3", "K3 lite"),
    "grad_lite_kernel": ("K4",),
    "project_lite_kernel": ("K5",),
}

# PyTorch's device ops, named by what they compute: (a piece of the CUDA
# kernel's or copy's name, the name given)
SMALL_OPS = (("CatArrayBatchedCopy", "cat"), ("where_kernel", "where"),
             ("CompareEqFunctor", "eq"), ("sqrt_kernel", "sqrt"),
             ("reciprocal_kernel", "reciprocal"), ("FillFunctor", "fill"),
             ("direct_copy_kernel", "copy"), ("MulFunctor", "mul"),
             ("_add", "add"), ("DivFunctor", "div"), ("div_", "div"),
             ("sum_functor", "sum"), ("gemm", "gemm"),
             ("scatter_gather", "scatter/gather"), ("gather", "gather"),
             ("Memcpy HtoD", "copy host to device"),
             ("Memcpy DtoH", "copy device to host"),
             ("Memcpy DtoD", "copy device to device"), ("Memset", "memset"))

# host activity during device idle, in the order a moment is claimed
HOST_CLASSES = ("sync", "memcpy/alloc", "launch", "other CUDA API", "python")


def kernel_base(name: str) -> str:
    """`void (anonymous namespace)::grad_kernel<3, true>(Params)` ->
    `grad_kernel`."""
    head = name[5:] if name.startswith("void ") else name
    head = head.replace("(anonymous namespace)", "anonymous")
    head = head.split("(", 1)[0].split("<", 1)[0]
    return head.rsplit("::", 1)[-1].strip()


def device_op_name(name: str) -> str:
    """A device op's name in a breakdown: the K-numbers of a hand-written
    kernel ("K1/K7 grad_kernel"), else what a PyTorch op computes."""
    base = kernel_base(name)
    if base in KERNELS:
        return "/".join(KERNELS[base]) + " " + base
    for piece, short in SMALL_OPS:
        if piece in name:
            return short
    return base[:60]


def host_class(name: str) -> str:
    """The class of a CUDA runtime or driver call."""
    if "Synchronize" in name or name in ("cudaStreamWaitEvent",
                                         "cudaEventQuery", "cudaStreamQuery"):
        return "sync"
    if name.startswith(("cudaMemcpy", "cuMemcpy", "cudaMalloc", "cuMemAlloc",
                        "cudaFree", "cuMemFree", "cudaMemset", "cuMemset",
                        "cudaHostAlloc", "cudaHostRegister")):
        return "memcpy/alloc"
    if "Launch" in name:
        return "launch"
    return "other CUDA API"
