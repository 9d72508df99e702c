"""Host ms a render call in the rasterizer's host code (`ops/rasterize`:
the projection, backend choice, the packing, K1's launch and the
composite over the background; the program's `mr.rasterize` span)."""

from benchmark import program


def read(ctx):
    return program.render_ms_per_call(program.span_table(), "mr.rasterize")
