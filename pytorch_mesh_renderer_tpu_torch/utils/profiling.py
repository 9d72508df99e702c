"""Profiling: the program's spans and counters, traces and throughput.

Port of `pytorch_mesh_renderer_tpu/utils/profiling.py:18-60` (a trace of
the enclosed block, named regions on its timeline, the steady-state
throughput of a callable), extended into the port's one span and counter
system:

  * `annotate(name)` opens a span. While a `torch.profiler` profile
    records, the span is a `record_function` event on the profiler's
    timeline, beside the card's kernels, and adds its count, host seconds
    and self seconds (host seconds less those of the spans opened inside
    it, on the same thread) to an in-memory table, `span_table()`. With
    no profile recording it costs one check and a no-op `with`, and
    records nothing.
  * `count(name, n)` adds to an always-on counter, `counters()`: the
    kernels' launches (`launches.<kernel>`), the render calls
    (`render.calls`) and the reads of device values on the host
    (`host_syncs.<site>`).

Both live for the process; `reset()` clears them. The spans the program
opens and the counters it keeps are listed in PERF.md, section 3.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

import torch

TRACE_FILE = "trace.json"

_OFF = contextlib.nullcontext()
_LOCK = threading.Lock()
_SPANS = {}  # name -> [count, host seconds, self seconds]
_COUNTS = {}  # name -> count
_OPEN = threading.local()  # .stack: the open spans' children seconds


class _Span:
    """A span while a profile records: a `record_function` event, timed
    on the host clock around it."""

    __slots__ = ("name", "record", "start")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        stack = getattr(_OPEN, "stack", None)
        if stack is None:
            stack = _OPEN.stack = []
        stack.append(0.0)
        self.start = time.perf_counter()
        self.record = torch.profiler.record_function(self.name)
        self.record.__enter__()
        return self

    def __exit__(self, *exc):
        self.record.__exit__(*exc)
        seconds = time.perf_counter() - self.start
        stack = _OPEN.stack
        children = stack.pop()
        if stack:
            stack[-1] += seconds
        with _LOCK:
            entry = _SPANS.setdefault(self.name, [0, 0.0, 0.0])
            entry[0] += 1
            entry[1] += seconds
            entry[2] += seconds - children
        return False


def annotate(name: str):
    """A named span (`with profiling.annotate("mr.render"): ...`): on the
    profiler's timeline and in `span_table()` while a profile records,
    else a shared no-op context."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name)


def span_table():
    """{name: (count, host seconds, self seconds)} of the spans closed
    while a profile recorded, since the process started or `reset()`."""
    with _LOCK:
        return {name: tuple(entry) for name, entry in _SPANS.items()}


def count(name: str, n: int = 1) -> None:
    """Adds `n` to the counter `name`."""
    with _LOCK:
        _COUNTS[name] = _COUNTS.get(name, 0) + n


def counters():
    """{name: count} of every counter, since the process started or
    `reset()`."""
    with _LOCK:
        return dict(_COUNTS)


def reset() -> None:
    """Clears the span table and the counters."""
    with _LOCK:
        _SPANS.clear()
        _COUNTS.clear()


@contextlib.contextmanager
def trace(log_dir: str):
    """Traces the enclosed block with torch.profiler (the host's ops and,
    on a card, its kernels) and writes a Chrome trace to
    `log_dir/trace.json`, viewable in chrome://tracing or Perfetto:

        with profiling.trace("render_trace"):
            images = render(...)
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def measure_throughput(fn, *args, iters: int = 20, warmup: int = 2,
                       items_per_call: int = 1):
    """Steady-state throughput of `fn(*args)`.

    `warmup` untimed calls, then `iters` calls timed back to back
    (`microbench/common.wall_ms`, one window: CUDA events on a card, the
    host clock on the CPU) on the card when there is one, else on the
    CPU. Returns (items_per_sec, seconds_per_call).
    """
    from ..microbench import common

    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    ms = common.wall_ms(lambda: fn(*args), device, iters, windows=1,
                        warmup=warmup)
    return items_per_call * 1e3 / ms, ms / 1e3
