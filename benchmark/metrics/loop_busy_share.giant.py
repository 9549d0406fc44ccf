"""% of the two tier's "solve.loop" seconds in which its kernels ran: the
traced seconds of K1's and K2's kernels (grad_kernel, project_kernel)
over the loops' seconds summed over the window's cli calls
(per_file_stages stats["solve_loop_s"]).  Read only where every loop of
the window ran the two tier (stats["tiers"]): a program whose loop
spans carry no tier, or a call in another tier, gives None."""

KERNELS = ("grad_kernel", "project_kernel")


def read(record):
    t, stats = record["trace"], record["stats"]
    if t is None or not stats or not all(
            set(s.get("tiers", {})) == {"two"} for s in stats):
        return None
    loop_s = sum(s["solve_loop_s"] for s in stats)
    kernel_s = sum(sec for name, sec in t["device_ops"]
                   if name.split(" ")[-1] in KERNELS)
    return 100.0 * kernel_s / loop_s if loop_s > 0 else None
