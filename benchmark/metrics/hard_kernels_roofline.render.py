"""The hard kernels' share of their roofline bound in a render call, in %."""

from benchmark import readers


def read(ctx):
    return readers.roofline_share(ctx, "hard")
