"""What the per-layer metrics' readers share. Each reader
(`metrics/<metric>.py`) has `read(ctx) -> float | None`; None leaves the
metric out of the result line. `ctx` holds:

  * `trace`: the reduced device trace of the traced window (`trace.py`):
    its units, seconds, busy seconds, device operations by name;
  * `kernels`: the renderer kernels by id (`kernels/<id>.json`: group,
    symbols, work model);
  * `work`: (shapes, pair counts, launches a unit) of the cell's kernels,
    from the reference (`roofline.py`), or None;
  * `peaks`: the card's published peaks (`peaks.json`), or None;
  * `window`: the untraced window's host clock (units, steps, host seconds);
  * `steps_per_unit`: steps in one unit (a call of a loop runs several).
"""

from __future__ import annotations

from . import roofline
from .trace import short_name


def kernel_of(ctx, name):
    """The id of the renderer kernel that a device operation's name is, or
    None."""
    base = short_name(name)
    for kid, spec in ctx["kernels"].items():
        if base in spec["symbols"]:
            return kid
    return None


def times_by_kernel(ctx):
    """{kernel id: device seconds over the traced window}, and the seconds
    of every other device operation."""
    out, other = {}, 0.0
    for name, seconds in ctx["trace"]["by_name"].items():
        kid = kernel_of(ctx, name)
        if kid is None:
            other += seconds
        else:
            out[kid] = out.get(kid, 0.0) + seconds
    return out, other


def traced_steps(ctx):
    return ctx["trace"]["units"] * ctx["steps_per_unit"]


def group_ms_per_step(ctx, group):
    """Device ms a step of the group's kernels; None where none ran."""
    times, _ = times_by_kernel(ctx)
    ran = [t for kid, t in times.items()
           if ctx["kernels"][kid]["group"] == group]
    if not ran:
        return None
    return 1e3 * sum(ran) / traced_steps(ctx)


def glue_ms_per_step(ctx):
    """Device ms a step of every operation that is no renderer kernel."""
    return 1e3 * times_by_kernel(ctx)[1] / traced_steps(ctx)


def ops_per_step(ctx):
    return ctx["trace"]["ops"] / traced_steps(ctx)


def idle_share(ctx):
    t = ctx["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def host_ms_per_step(ctx):
    w = ctx["window"]
    return 1e3 * w["host_s"] / w["steps"]


def roofline_share(ctx, group):
    """100 x (the bound of the group's kernels that ran) / (their device
    time); None where one of them has no work model or counts, or the card
    has no peaks on record."""
    if ctx["work"] is None or ctx["peaks"] is None:
        return None
    shape, counts, launches = ctx["work"]
    times, _ = times_by_kernel(ctx)
    bound = spent = 0.0
    for kid, seconds in times.items():
        spec = ctx["kernels"][kid]
        if spec["group"] != group:
            continue
        b = roofline.bound_seconds(spec["work"], shape, counts, ctx["peaks"])
        if b is None:
            return None
        bound += b[0] * launches * ctx["trace"]["units"]
        spent += seconds
    if spent <= 0.0:
        return None
    return 100.0 * bound / spent
