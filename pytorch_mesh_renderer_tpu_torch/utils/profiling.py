"""Profiling and throughput measurement.

Port of `pytorch_mesh_renderer_tpu/utils/profiling.py:18-60`: a trace of
the enclosed block (`torch.profiler` in place of `jax.profiler`, written
as a Chrome trace), named regions on its timeline, and the steady-state
throughput of a callable, timed by `microbench/common.wall_ms` (CUDA
events on a card, the host clock on the CPU).
"""

from __future__ import annotations

import contextlib
import os

import torch

from ..microbench import common

TRACE_FILE = "trace.json"


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


def annotate(name: str):
    """Named region that shows up on the profiler timeline."""
    return torch.profiler.record_function(name)


def measure_throughput(fn, *args, iters: int = 20, warmup: int = 2,
                       items_per_call: int = 1):
    """Steady-state throughput of `fn(*args)`.

    `warmup` untimed calls, then `iters` calls timed back to back
    (`common.wall_ms`, one window) on the card when there is one, else on
    the CPU. Returns (items_per_sec, seconds_per_call).
    """
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    ms = common.wall_ms(lambda: fn(*args), device, iters, windows=1,
                        warmup=warmup)
    return items_per_call * 1e3 / ms, ms / 1e3
