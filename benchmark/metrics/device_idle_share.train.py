"""The share of the traced window in which no device operation ran, in %."""

from benchmark import readers


def read(ctx):
    return readers.idle_share(ctx)
