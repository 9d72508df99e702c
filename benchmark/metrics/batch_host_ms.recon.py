"""Host ms a step of the loader (the program's `mr.recon.batch` span: the
draw, the gather into pinned memory and the copies to the card)."""

from benchmark import program
from benchmark import net_kernels


def read(ctx):
    return net_kernels.batch_ms_per_step(program.span_table())
