"""Small versions of the cells for the CPU tests: the same modes, code
paths and checks at sizes a test run holds."""

from __future__ import annotations

import time

from benchmark import env, harness

SPHERE = {"kind": "uv_sphere", "radius": 0.8, "resolution": 8}
SMALL = {
    "teapot_256.hard_train_b4": ({"image_size": 32, "mesh": SPHERE},
                                 {"warmup_calls": 1, "trace_calls": 2}),
    "teapot_256.soft_train_b4": ({"image_size": 32, "mesh": SPHERE},
                                 {"warmup_calls": 1, "trace_calls": 2}),
    "cow_fit_128.train": ({"image_size": 32, "mesh": {
        "kind": "uv_sphere", "radius": 0.5, "resolution": 8}},
        {"warmup_calls": 1, "trace_calls": 1, "steps_per_call": 2}),
    "teapot_256.hard_render_b64": ({"image_size": 32, "mesh": SPHERE},
                                   {"warmup_calls": 1, "trace_calls": 2,
                                    "views": 4, "pool": 2}),
}
CELLS = sorted(SMALL)


def cell_files(name):
    """(cell, config, traffic, limits, scene overrides) of a small cell."""
    cell, config, traffic, limits = env.find_cell(name)
    overrides, traffic_overrides = SMALL[name]
    return cell, config, dict(traffic, **traffic_overrides), limits, \
        overrides


def run_small(name, seed=2147483647, seconds=0.5, trace=0):
    """harness.run of the small cell on the CPU: (result, check lines)."""
    cell, config, traffic, limits, overrides = cell_files(name)
    return harness.run(cell, config, traffic, limits, seed, seconds, trace,
                       "cpu", time.perf_counter(), overrides=overrides)
