"""Host ms a render call: from the call to its return, before the wait
for the card."""

from benchmark import readers


def read(ctx):
    return readers.host_ms_per_step(ctx)
