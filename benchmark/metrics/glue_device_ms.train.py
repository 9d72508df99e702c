"""Device ms a step of every operation that is no renderer kernel:
packing, scatter plans, normals, shading, losses, the optimizer."""

from benchmark import readers


def read(ctx):
    return readers.glue_ms_per_step(ctx)
