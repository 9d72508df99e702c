"""Host ms a render call in the shading (the pixel mask and the Phong
shader's dispatch; the program's `mr.shade` span)."""

from benchmark import program


def read(ctx):
    return program.render_ms_per_call(program.span_table(), "mr.shade")
