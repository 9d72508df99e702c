"""One run of one cell:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell's entry in BENCHMARK.json names its configuration
(`configs/<config>.json`) and traffic mix (`traffic/<traffic>.json`); the
mix names its mode (`modes/<mode>.py`), which drives the program. The run:

  1. set-up: the inputs from the seed, the program's objects, its first
     steps (read for the check) and the warm-up, so that nothing builds or
     compiles later; `setup_s` is the time from the start of the process;
  2. the window: the mode's units back to back for `--seconds`, timed by
     the host clock and ended by a wait for the card; the peak of allocated
     device memory over it;
  3. with `--trace 1`, a fixed number of units under torch.profiler, and
     the per-layer metrics read from it (`metrics/<metric>.py`);
  4. the check: the program's state freed, the reference computes the same
     outputs again (`reference/`), and each number of `compare.py` is held
     to its limit (`limits/<cell>.json`).

The last line on standard output is the JSON result; the last lines on
standard error are the numbers of the check beside their limits. Without
a CUDA card, with fewer cards than the cell asks for, or where JAX or the
JAX package has been loaded, the run prints no result and exits non-zero.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import math
import os
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "pytorch_mesh_renderer_tpu")

# On the card's host a new process runs its host code about a tenth slower
# for its first 20 to 50 seconds (seldom longer), then steps to a steady
# faster level, whatever it runs meanwhile (a sleep serves as well as
# work). The measured window starts no earlier than this many seconds
# after the process started; the wait is not set-up and is not in setup_s.
SETTLE_S = 60.0


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        prog="benchmark/run.py", description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def load_mode(traffic):
    return importlib.import_module(f"benchmark.modes.{traffic['mode']}")


def load_reader(name):
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell_metrics(bench, cell_name, section, reported=None):
    """The entries of BENCHMARK.json's `section` that this cell reports: a
    metric listing workloads names it; one without, every cell that reports
    the end-to-end metric it moves (`reported`)."""
    out = []
    for metric in bench[section]:
        if "workloads" in metric:
            if cell_name in metric["workloads"]:
                out.append(metric)
        elif section == "end_to_end" or metric["moves"] in reported:
            out.append(metric)
    return out


def _number(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else str(x)


def kernels_table():
    from .env import HERE, load_json
    folder = os.path.join(HERE, "kernels")
    return {name[:-5]: load_json(folder, name)
            for name in sorted(os.listdir(folder)) if name.endswith(".json")}


def peaks_for(kind):
    from .env import HERE, load_json
    return load_json(HERE, "peaks.json").get(kind)


def run(cell, config, traffic, limits, seed, seconds, trace, device,
        started, overrides=None, chips=1):
    """One run of `cell`; returns (result dict, check lines). `started` is
    the host clock at the start of the process."""
    import torch

    from . import compare, env, trace as tracing

    entered = time.perf_counter()
    e = env.Env(cell["name"], config, traffic, seed, device, overrides)
    mode = load_mode(traffic)
    c = mode.Cell(e)
    e.sync()
    made = time.perf_counter()
    c.build()
    built = time.perf_counter()
    c.warm()
    e.sync()
    warmed = time.perf_counter()
    print(f"set-up: {entered - started:.3f} s to the run (imports, the "
          f"card), inputs {made - entered:.3f} s, program {built - made:.3f}"
          f" s, first steps and warm-up {warmed - built:.3f} s",
          file=sys.stderr, flush=True)
    on_card = e.device.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(e.device) if on_card else 0
    setup_s = time.perf_counter() - started
    if on_card:
        wait = SETTLE_S - (time.perf_counter() - started)
        if wait > 0:
            print(f"settle: {wait:.3f} s before the window", file=sys.stderr,
                  flush=True)
            time.sleep(wait)
        torch.cuda.reset_peak_memory_stats(e.device)
    window = c.window(seconds)
    peak = torch.cuda.max_memory_allocated(e.device) if on_card else 0
    bench = env.benchmark_file()
    e2e = {m["name"]: m for m in cell_metrics(bench, cell["name"],
                                              "end_to_end")}
    values = dict(window["metrics"], setup_s=setup_s,
                  peak_mem_gib=peak / 2 ** 30)
    metrics = {name: {"value": values[name], "unit": m["unit"]}
               for name, m in e2e.items() if name in values}
    kind = torch.cuda.get_device_name(e.device) if on_card else "cpu"
    device_info = {"platform": "gpu" if on_card else "cpu", "kind": kind,
                   "count": chips, "memory_peak_bytes": max(setup_peak, peak)}
    traced = None
    if trace:
        count = traffic["trace_calls"]
        traced = tracing.capture(lambda: c.traced(count, tracing.span),
                                 e.sync)
    c.finish()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers = c.numbers(c.readings)
    correct, checks = compare.judge(numbers, limits["limits"])
    result = {"correct": correct, "attempted": window["steps"],
              "failed": window["failed"]}
    if trace:
        metrics = {}
        if traced is not None:
            ctx = {"trace": traced, "kernels": kernels_table(),
                   "work": c.work_inputs(), "peaks": peaks_for(kind),
                   "window": window, "steps_per_unit": c.steps_per_unit}
            for m in cell_metrics(bench, cell["name"], "per_layer",
                                  set(e2e)):
                value = load_reader(m["name"])(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            device_info["busy_s"] = traced["busy_s"]
            device_info["window_s"] = traced["window_s"]
    result["metrics"] = metrics
    result["device"] = device_info
    if traced is not None:
        result["breakdown"] = tracing.breakdown(traced)
    result["checks"] = {name: {"value": _number(v["value"]),
                               "limit": v["limit"]}
                        for name, v in checks.items()}
    lines = [f"check {name}: {v['value']!r} (limit {v['limit']!r}) "
             f"{'ok' if v['value'] <= v['limit'] else 'FAILS'}"
             for name, v in checks.items()]
    lines.append(f"correct: {str(correct).lower()}")
    return result, lines


def main(argv=None, started=None):
    started = time.perf_counter() if started is None else started
    args = parse_args(argv)
    import torch

    from . import env
    cell, config, traffic, limits = env.find_cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA devices, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, lines = run(cell, config, traffic, limits, args.seed,
                        args.seconds, args.trace, "cuda", started,
                        chips=cell["chips"])
    loaded = forbidden_modules()
    if loaded:
        print(f"loaded in this process: {', '.join(loaded)}; the benchmark "
              "may load neither JAX nor the JAX package", file=sys.stderr)
        return 1
    sys.stderr.write("\n".join(lines) + "\n")
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
