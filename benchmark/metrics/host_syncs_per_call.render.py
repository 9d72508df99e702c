"""Reads of device values on the host a render call: the program's
`host_syncs.*` counters over its `render.calls`, over the whole process
(set-up's one-off reads included)."""

from benchmark import program


def read(ctx):
    return program.host_syncs_per_call(program.counters())
