"""Idle device ms a render call in the traced window's named gaps whose
innermost host span is one of the program's (`mr.*`): the gaps the
program's own layers leave (`trace.py` names the longest gaps only)."""

from benchmark import program


def read(ctx):
    return program.program_idle_ms_per_call(ctx["trace"],
                                            program.span_table())
