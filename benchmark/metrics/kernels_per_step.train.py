"""Device operations a training step."""

from benchmark import readers


def read(ctx):
    return readers.ops_per_step(ctx)
