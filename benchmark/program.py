"""What the per-layer metrics read from the program itself: the span table
and the counters of `pytorch_mesh_renderer_tpu_torch.utils.profiling`.

The program records a span (`mr.render`, `mr.step.replay`, ...) only while
a torch.profiler profile records, so the table holds the traced windows
of the run alone; its counters (`render.calls`, `host_syncs.<site>`) count
over the whole process. Each function returns None where what it divides
by is absent or zero: a program without the span and counter system
records neither, and its metrics are left out of the result line.
"""

from __future__ import annotations

RENDER = "mr.render"
REPLAY = "mr.step.replay"
STEP_CALLS = ("mr.step", "mr.loop")


def _profiling():
    """The program's profiling module, or None where it has no span table
    or counters."""
    try:
        from pytorch_mesh_renderer_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not (hasattr(profiling, "span_table")
            and hasattr(profiling, "counters")):
        return None
    return profiling


def span_table():
    """{name: (count, host seconds, self seconds)}, or {}."""
    profiling = _profiling()
    return {} if profiling is None else profiling.span_table()


def counters():
    """{name: count}, or {}."""
    profiling = _profiling()
    return {} if profiling is None else profiling.counters()


def _count(table, name):
    return table.get(name, (0, 0.0, 0.0))[0]


def render_ms_per_call(table, name, self_time=False):
    """1e3 x the host seconds of span `name` (its self seconds with
    `self_time`) over the `mr.render` calls; None where either is
    absent."""
    calls = _count(table, RENDER)
    if not calls or not _count(table, name):
        return None
    _, host_s, self_s = table[name]
    return 1e3 * (self_s if self_time else host_s) / calls


def host_syncs_per_call(counts):
    """The `host_syncs.*` counters' sum over `render.calls`; None where
    no render was counted."""
    calls = counts.get("render.calls", 0)
    if not calls:
        return None
    syncs = sum(n for name, n in counts.items()
                if name.startswith("host_syncs."))
    return syncs / calls


def program_idle_ms_per_call(trace, table):
    """1e3 x the idle seconds of the traced window's named gaps whose
    innermost host span is one of the program's (`mr.*`), over the
    traced calls; None where the program recorded no `mr.render`."""
    if not _count(table, RENDER) or not trace["units"]:
        return None
    idle = sum(seconds for name, seconds in trace["idle_by_host"].items()
               if name.startswith("mr."))
    return 1e3 * idle / trace["units"]


def replay_ms_per_step(table):
    """1e3 x the host seconds of the `mr.step.replay` spans over their
    count; None where none was recorded."""
    replays = _count(table, REPLAY)
    if not replays:
        return None
    return 1e3 * table[REPLAY][1] / replays


def step_prep_ms_per_step(table):
    """1e3 x (the host seconds of the step and loop calls, `mr.step` and
    `mr.loop`, less those of the replays inside them) over the replays;
    None where none was recorded. The program never opens one of those
    calls inside the other."""
    replays = _count(table, REPLAY)
    if not replays:
        return None
    calls_s = sum(table[name][1] for name in STEP_CALLS if name in table)
    return 1e3 * (calls_s - table[REPLAY][1]) / replays
