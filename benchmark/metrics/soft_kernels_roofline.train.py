"""The soft kernels' share of their roofline bound in a training step, in %."""

from benchmark import readers


def read(ctx):
    return readers.roofline_share(ctx, "soft")
