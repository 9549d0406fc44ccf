"""Per-file traffic with the program's stages: per_file's requests, and
each cycle's stage seconds and counts read from the spans the program
closes in each `cli.main` call.

A per-file call runs on the calling thread, so the spans "read",
"solve.setup", "solve.loop", "fetch" and "png" each close there; each
call is wrapped in `profiling.collected(...)` for them, which works
whether or not the spans are recorded.  A cycle returns per_file's
requests and these stats:

  requests                     the cycle's cli calls;
  read_s, solve_setup_s,       each stage's seconds, summed over the
  solve_loop_s, fetch_s, png_s cycle's calls;
  fetch_bytes, png_bytes       the "fetch" and "png" spans' "bytes";
  setup_bytes                  the "solve.setup" spans' "bytes" (the
                               host -> device uploads), where every one
                               carries it: a program without the
                               counter gives no such key;
  tiers                        {tier: calls} from the "solve.loop"
                               spans' "tier", where every one carries
                               it (likewise).
"""

from __future__ import annotations

import contextlib

from benchmark.entries import per_file

# span name -> the stats key of its seconds
STAGES = {"read": "read_s", "solve.setup": "solve_setup_s",
          "solve.loop": "solve_loop_s", "fetch": "fetch_s", "png": "png_s"}


class _Collecting:
    """The cli module with main wrapped: each call's stage spans are added
    to `spans` (span name -> the spans that closed)."""

    def __init__(self, cli):
        self._cli = cli
        self.spans = {name: [] for name in STAGES}

    def main(self, argv):
        from jpeg2png_tpu_torch.utils import profiling

        with contextlib.ExitStack() as stack:
            got = {name: stack.enter_context(profiling.collected(name))
                   for name in STAGES}
            rc = self._cli.main(argv)
        for name, closed in got.items():
            self.spans[name] += closed
        return rc


class Entry(per_file.Entry):

    def run(self, k: int):
        """Cycle number k (the warm cycle is -1): (requests, stats)."""
        cli, self.cli = self.cli, _Collecting(self.cli)
        try:
            reqs, _ = super().run(k)
            spans = self.cli.spans
        finally:
            self.cli = cli
        stats = {"requests": len(reqs)}
        for name, key in STAGES.items():
            stats[key] = sum(sp.seconds for sp in spans[name])
        for name in ("fetch", "png"):
            stats[f"{name}_bytes"] = sum(sp.attrs.get("bytes", 0)
                                         for sp in spans[name])
        setups, loops = spans["solve.setup"], spans["solve.loop"]
        if setups and all("bytes" in sp.attrs for sp in setups):
            stats["setup_bytes"] = sum(sp.attrs["bytes"] for sp in setups)
        if loops and all("tier" in sp.attrs for sp in loops):
            stats["tiers"] = {}
            for sp in loops:
                tier = sp.attrs["tier"]
                stats["tiers"][tier] = stats["tiers"].get(tier, 0) + 1
        return reqs, stats
