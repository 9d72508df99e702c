"""Host syncs a step: the program's `host_syncs.*` counters over its
`recon.steps`, grown from the window's start to the end of the traced
steps (the set-up's syncs, the capture's among them, left out)."""

from benchmark import program
from benchmark import net_kernels


def read(ctx):
    return net_kernels.host_syncs_per_step(
        program.counters(), ctx["window"].get("counters_at_start"))
