"""Device ms a step of the hard kernels (K1-K4)."""

from benchmark import readers


def read(ctx):
    return readers.group_ms_per_step(ctx, "hard")
