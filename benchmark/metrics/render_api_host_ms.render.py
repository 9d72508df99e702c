"""Host ms a render call inside `mesh_renderer.render` but in none of its
finer spans: the argument checks, broadcasting and the attribute
concatenation (the self time of the program's `mr.render` span)."""

from benchmark import program


def read(ctx):
    return program.render_ms_per_call(program.span_table(), "mr.render",
                                      self_time=True)
