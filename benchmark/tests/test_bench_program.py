"""The per-layer metrics that read the program's own spans and counters
(`program.py`), on a synthetic span table, counters and trace: each
reading by hand, the parts adding up to the whole, and None where the
program has no span and counter system."""

from __future__ import annotations

import pytest

from benchmark import harness, program

MS = 1e3
# Ten render calls: 30 ms in mr.render, of which 6 ms its own.
RENDER_TABLE = {
    "mr.render": (10, 0.030, 0.006),
    "mr.camera": (10, 0.004, 0.004),
    "mr.rasterize": (10, 0.015, 0.009),
    "mr.rasterize.pack": (10, 0.004, 0.004),
    "mr.rasterize.launch": (10, 0.002, 0.002),
    "mr.shade": (10, 0.005, 0.005),
}
RENDER_COUNTS = {"render.calls": 2000, "host_syncs.camera": 4000,
                 "host_syncs.mesh_plan": 2, "launches.rasterize_fused_fwd":
                 2000}
RENDER_TRACE = {"units": 8, "idle_by_host": {
    "mr.render": 0.002, "mr.camera": 0.0004, "bench.render_call": 0.001,
    "aten::select": 0.003, "cudaLaunchKernel": 0.0001}}
# 300 replays: 200 in step calls (mr.step), 100 in one loop call.
TRAIN_TABLE = {
    "mr.step": (200, 0.180, 0.020),
    "mr.step.load": (201, 0.030, 0.030),
    "mr.step.replay": (300, 0.210, 0.210),
    "mr.loop": (1, 0.081, 0.0),
}
READERS = ("render_api_host_ms.render", "camera_host_ms.render",
           "rasterize_host_ms.render", "shade_host_ms.render",
           "host_syncs_per_call.render", "program_idle_ms.render",
           "replay_host_ms.train", "step_prep_host_ms.train")


def test_render_host_metrics_add_up_to_the_render_span():
    parts = [program.render_ms_per_call(RENDER_TABLE, "mr.render",
                                        self_time=True)]
    parts += [program.render_ms_per_call(RENDER_TABLE, name)
              for name in ("mr.camera", "mr.rasterize", "mr.shade")]
    assert parts == pytest.approx([0.6, 0.4, 1.5, 0.5])
    assert sum(parts) == pytest.approx(MS * 0.030 / 10)


def test_host_syncs_per_call_and_program_idle_by_hand():
    assert program.host_syncs_per_call(RENDER_COUNTS) == pytest.approx(
        4002 / 2000)
    # Only the gaps under the program's spans: (2 + 0.4) ms over 8 calls.
    assert program.program_idle_ms_per_call(
        RENDER_TRACE, RENDER_TABLE) == pytest.approx(2.4 / 8)
    no_gap = dict(RENDER_TRACE, idle_by_host={"aten::select": 0.003})
    assert program.program_idle_ms_per_call(no_gap, RENDER_TABLE) == 0.0
    assert program.host_syncs_per_call({"render.calls": 5}) == 0.0


def test_train_metrics_add_up_to_the_step_and_loop_calls():
    replay = program.replay_ms_per_step(TRAIN_TABLE)
    prep = program.step_prep_ms_per_step(TRAIN_TABLE)
    assert replay == pytest.approx(0.7)
    assert prep == pytest.approx(MS * (0.180 + 0.081 - 0.210) / 300)
    assert replay + prep == pytest.approx(MS * (0.180 + 0.081) / 300)


def test_readers_give_none_where_the_program_recorded_nothing():
    for table in ({}, {"mr.render": (0, 0.0, 0.0)}):
        assert program.render_ms_per_call(table, "mr.render") is None
        assert program.program_idle_ms_per_call(RENDER_TRACE, table) is None
        assert program.replay_ms_per_step(table) is None
        assert program.step_prep_ms_per_step(table) is None
    assert program.render_ms_per_call({"mr.render": (3, 1.0, 0.5)},
                                      "mr.camera") is None
    assert program.host_syncs_per_call({}) is None
    assert program.host_syncs_per_call({"host_syncs.camera": 2}) is None


@pytest.mark.parametrize("name", READERS)
def test_each_reader_reads_the_program_and_is_silent_without_it(
        name, monkeypatch):
    ctx = {"trace": RENDER_TRACE}
    monkeypatch.setattr(program, "span_table",
                        lambda: dict(RENDER_TABLE, **TRAIN_TABLE))
    monkeypatch.setattr(program, "counters", lambda: dict(RENDER_COUNTS))
    value = harness.load_reader(name)(ctx)
    assert isinstance(value, float) and value >= 0.0
    # A program without span_table and counters (older than them).
    monkeypatch.undo()
    monkeypatch.setattr(program, "_profiling", lambda: None)
    assert harness.load_reader(name)(ctx) is None


def test_the_program_has_the_span_and_counter_system():
    from pytorch_mesh_renderer_tpu_torch.utils import profiling
    assert program._profiling() is profiling
    assert isinstance(program.span_table(), dict)
    assert isinstance(program.counters(), dict)
