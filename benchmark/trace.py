"""The device trace of a traced window and its reduction: the device
operations by name, the union of their intervals (busy time), the idle
gaps and what the host was doing in them.

The window is a `bench.window` span around a fixed number of the cell's
units and the wait for the card after them; the units run inside spans of
their own (`bench.step`, `bench.loop_call`, `bench.render_call`,
`bench.wait`), which name the host's activity in the idle gaps.
"""

from __future__ import annotations

import re
import sys

import numpy as np
import torch

ATTEMPTS = 3
GAP_NAMES = 400  # the longest gaps that are named by the host's activity


def span(name):
    return torch.profiler.record_function(name)


def short_name(name):
    """A kernel's identifier without its namespaces, template and
    arguments: `void (anonymous namespace)::f<...>(args)` -> `f`."""
    name = re.sub(r"^void ", "", name.strip()).replace(
        "(anonymous namespace)::", "")
    base = re.split(r"[(<]", name, maxsplit=1)[0].strip() or name
    return base.rsplit("::", 1)[-1]


def label(name):
    """A device operation's name for the breakdown: without its argument
    list, at most 100 characters."""
    name = re.sub(r"^void ", "", name.strip())
    if name.endswith(")") and "(" in name:
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name[:100]


def capture(run, sync):
    """Runs `run()` (returns the units it ran) inside the traced window;
    returns the reduced Trace. A profile that records no device operation
    is taken again, up to ATTEMPTS times; then None."""
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with span("bench.window"):
                units = run()
                sync()
        reduced = reduce(prof.events(), units)
        if reduced is not None:
            return reduced
        print(f"the profiler recorded no device operation (attempt "
              f"{attempt + 1}); tracing again", file=sys.stderr, flush=True)
    return None


def _union(starts, ends):
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    merged = []
    cur_s, cur_e = s[0], e[0]
    for a, b in zip(s[1:], e[1:]):
        if a > cur_e:
            merged.append((cur_s, cur_e))
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    merged.append((cur_s, cur_e))
    return np.array(merged)


def reduce(events, units, device_type=torch.autograd.DeviceType.CUDA):
    """Trace of profiler events: None when no device operation ran.

    The profiler mirrors each host span (`record_function`) on the device's
    timeline as an annotation; those are no device operations and are left
    out, as every device event that has the name of a host event."""
    window = None
    dev, host = [], []
    for ev in events:
        tr = ev.time_range
        if ev.device_type == device_type:
            if not getattr(ev, "is_user_annotation", False):
                dev.append((ev.name, tr.start, tr.end))
        else:
            if ev.name == "bench.window" and window is None:
                window = (tr.start, tr.end)
            host.append((ev.name, tr.start, tr.end))
    host_names = {h[0] for h in host}
    dev = [d for d in dev if d[0] not in host_names]
    if not dev or window is None:
        return None
    w0, w1 = window
    names = [d[0] for d in dev]
    starts = np.clip(np.array([d[1] for d in dev], float), w0, w1)
    ends = np.clip(np.array([d[2] for d in dev], float), w0, w1)
    by_name = {}
    for name, a, b in zip(names, starts, ends):
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
    merged = _union(starts, ends)
    busy = float(np.sum(merged[:, 1] - merged[:, 0])) * 1e-6
    gap_s = np.concatenate([[w0], merged[:, 1]])
    gap_e = np.concatenate([merged[:, 0], [w1]])
    lengths = gap_e - gap_s
    keep = np.argsort(-lengths)[:GAP_NAMES]
    h_name = [h[0] for h in host if h[0] != "bench.window"]
    h_s = np.array([h[1] for h in host if h[0] != "bench.window"], float)
    h_e = np.array([h[2] for h in host if h[0] != "bench.window"], float)
    idle = {}
    for i in keep:
        if lengths[i] <= 0:
            continue
        mid = 0.5 * (gap_s[i] + gap_e[i])
        inside = np.nonzero((h_s <= mid) & (h_e >= mid))[0] if len(
            h_s) else []
        if len(inside):
            j = inside[np.argmin(h_e[inside] - h_s[inside])]
            who = h_name[j]
        else:
            who = "(no host span)"
        idle[who] = idle.get(who, 0.0) + lengths[i] * 1e-6
    return {"units": units, "window_s": (w1 - w0) * 1e-6, "busy_s": busy,
            "ops": len(dev), "by_name": by_name, "idle_by_host": idle}


def breakdown(trace):
    """The result line's breakdown: the ten device operations that took the
    most time and the ten host activities under the longest idle gaps,
    each [name, seconds] over the traced window."""
    by_label = {}
    for name, seconds in trace["by_name"].items():
        by_label[label(name)] = by_label.get(label(name), 0.0) + seconds
    ops = sorted(by_label.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(trace["idle_by_host"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}
