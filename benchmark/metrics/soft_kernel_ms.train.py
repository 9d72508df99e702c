"""Device ms a step of the soft kernels (K5-K8)."""

from benchmark import readers


def read(ctx):
    return readers.group_ms_per_step(ctx, "soft")
