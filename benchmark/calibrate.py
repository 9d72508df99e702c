"""The readings that a cell's limits are set from (limits/<cell>.json),
in one process on the card:

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--seconds 2] [--out FILE]

For each of `--seeds`, the program's numbers: a run's set-up, a short
window and the check, as benchmark/run.py makes them (the lower readings).
For each of `--control-seeds`, the numbers of the control: the reference
put in the program's place and computed with its camera products in TF32,
the nearest precision below the configuration's float32; and of each fault
the cell's mode can have, planted in the reference put in the program's
place: a step that leaves its state unchanged, half of the batch left out
(the mean taken over the rest) and one answer altered where it is
produced. Each reading is a JSON line; the last line sums them up: the
largest program reading and the smallest control and fault readings of
each number.

The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from benchmark import env, harness  # noqa: E402


def readings(name, seeds, control_seeds, seconds, device, overrides=None,
             traffic_overrides=None, emit=print):
    """{kind: {number: [readings]}} with kind 'program', 'control' or a
    fault's name."""
    cell, config, traffic, limits = env.find_cell(name)
    traffic = dict(traffic, **(traffic_overrides or {}))
    mode = harness.load_mode(traffic)
    out = {}

    def add(kind, seed, numbers):
        emit(json.dumps({"workload": name, "seed": seed, "kind": kind,
                         "numbers": {k: harness._number(v)
                                     for k, v in numbers.items()}}))
        for key, value in numbers.items():
            out.setdefault(kind, {}).setdefault(key, []).append(value)

    for seed in sorted(set(seeds) | set(control_seeds)):
        e = env.Env(name, config, traffic, seed, device, overrides)
        c = mode.Cell(e)
        if seed in seeds:
            c.build()
            c.warm()
            c.window(seconds)
            c.finish()
            gc.collect()
            add("program", seed, c.numbers(c.readings))
        if seed in control_seeds:
            add("control", seed, c.numbers(c.reference(tf32=True)))
            for fault in mode.FAULTS:
                add(fault, seed, c.numbers(c.reference(fault=fault)))
        del c
        gc.collect()
        if e.device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def summary(out):
    """The largest program reading and the smallest of each other kind."""
    table = {}
    for kind, numbers in out.items():
        pick = max if kind == "program" else min
        for key, values in numbers.items():
            table.setdefault(key, {})[kind] = pick(values)
    return table


def propose(table, training):
    """{number: (lower, upper, limit)} from summary(): the lower reading is
    the program's largest; the upper the control's smallest where that is
    three times the lower or more, and for a training cell also each
    fault's smallest that reads ten times the lower or more (a state left
    unchanged: three times), the least of these. The limit lies between,
    with more room above the lower: lower^(1/3) upper^(2/3), or a tenth of
    the upper where the lower is 0. A number with no upper reading gets
    none."""
    out = {}
    for key, kinds in table.items():
        lower = float(kinds.get("program", float("nan")))
        uppers = []
        for kind, value in kinds.items():
            value = float(value)
            if kind == "program":
                continue
            factor = 3.0 if kind in ("control", "state_unchanged") else 10.0
            if kind != "control" and not training:
                continue
            if value >= factor * lower and value > 0:
                uppers.append(value)
        upper = min(uppers) if uppers else None
        if upper is None or upper == float("inf"):
            limit = None
        elif lower > 0:
            limit = lower ** (1 / 3) * upper ** (2 / 3)
        else:
            limit = upper / 10
        out[key] = (lower, upper, limit)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2

    def ints(text):
        return [int(s) for s in text.split(",") if s]

    lines = []

    def emit(line):
        print(line, flush=True)
        lines.append(line)

    t0 = time.perf_counter()
    out = readings(args.workload, ints(args.seeds), ints(args.control_seeds),
                   args.seconds, "cuda", emit=emit)
    table = summary(out)
    training = harness.load_mode(env.find_cell(args.workload)[2]).KIND
    emit(json.dumps({"workload": args.workload, "summary": table,
                     "proposed": propose(table, training == "train"),
                     "seconds": time.perf_counter() - t0,
                     "card": torch.cuda.get_device_name(0)}, default=str))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
