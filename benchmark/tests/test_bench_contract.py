"""BENCHMARK.json against the benchmark's contract: every name, unit and
text within its characters and lengths, every cell's files present, every
per-layer metric with its reader, and the harness finding cells by name."""

from __future__ import annotations

import json
import os
import re

import pytest

from benchmark import env, harness

ROOT = env.ROOT
BENCH = env.benchmark_file()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TEXT_KEYS = ("why", "layer", "source")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _text_ok(text):
    return (isinstance(text, str) and 1 <= len(text) <= 200
            and "\n" not in text and "\t" not in text)


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_text_ok(word) for word in BENCH["command"])
    assert BENCH["command"][1].startswith(tuple(p + "/" for p in
                                                BENCH["paths"]))
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    for path in BENCH["paths"]:
        assert PATH.match(path) and not path.startswith("/")
        assert ".." not in path.split("/")
        assert not path.endswith("_torch")
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_have_the_contract_keys(section):
    entries = BENCH[section]
    assert entries
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for entry in entries:
        extra = set(entry) - KEYS[section]
        assert extra <= {"workloads"}, (entry["name"], extra)
        assert KEYS[section] <= set(entry), entry["name"]
        assert NAME.match(entry["name"]), entry["name"]
        for key in TEXT_KEYS:
            if key in entry:
                assert _text_ok(entry[key]), (entry["name"], key)
        if "unit" in entry:
            assert UNIT.match(entry["unit"]), entry["unit"]
        if "better" in entry:
            assert entry["better"] in ("lower", "higher")


def test_configs_and_cells_refer_to_files_that_exist():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert c["file"].startswith("benchmark/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["source"] == c["source"]
    pairs = set()
    for w in BENCH["workloads"]:
        assert w["config"] in configs
        assert NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        env.find_cell(w["name"])  # config, traffic and limits files load
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == set(configs)


def test_bounds_and_metric_coverage():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        path = os.path.join(env.HERE, "metrics", m["name"] + ".py")
        assert os.path.exists(path), m["name"]
        assert callable(harness.load_reader(m["name"]))
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"], set()).add(m["name"])
    for w in BENCH["workloads"]:
        reported = {m["name"] for m in harness.cell_metrics(
            BENCH, w["name"], "end_to_end")}
        assert "setup_s" in reported and len(reported) >= 2, w["name"]
        per_layer = harness.cell_metrics(BENCH, w["name"], "per_layer",
                                         reported)
        assert per_layer, w["name"]
        for m in per_layer:  # each moves a metric that the cell reports
            assert m["moves"] in reported, (w["name"], m["name"])


def test_roofline_metrics_are_named_and_in_percent():
    for m in BENCH["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline")
            assert m["unit"] == "%"


def test_harness_finds_cells_by_name():
    for w in BENCH["workloads"]:
        cell, config, traffic, limits = env.find_cell(w["name"])
        assert cell["name"] == w["name"]
        assert config["name"] == w["config"]
        assert harness.load_mode(traffic).Cell is not None
        assert limits["limits"]
    with pytest.raises(KeyError):
        env.find_cell("no_such.cell")
