"""The port's spans and counters (`utils/profiling.py`) on the CPU: a span
records nothing without a profile and a `record_function` event with its
count, host and self seconds under one; the counters of render calls,
host syncs and kernel launches; the spans the hard render and the
training step and loop open."""

from __future__ import annotations

import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import pytorch_mesh_renderer_tpu_torch as pmt
from pytorch_mesh_renderer_tpu_torch import parallel
from pytorch_mesh_renderer_tpu_torch.ops import mesh as mesh_ops
from pytorch_mesh_renderer_tpu_torch.ops import rasterize as rasterize_ops
from pytorch_mesh_renderer_tpu_torch.utils import profiling

RENDER_CHILDREN = ("mr.camera", "mr.rasterize", "mr.shade")


@pytest.fixture(autouse=True)
def _clean():
    profiling.reset()
    yield
    profiling.reset()


def _recording():
    return profile(activities=[ProfilerActivity.CPU])


def _cube_args(size=24):
    v, t, n = pmt.shapes.cube(2.0)
    rot = pmt.camera.euler_matrices(
        torch.tensor([[-20.0, 0.0, 60.0]]))[:, :3, :3]
    vw, nw = v[None] @ rot.transpose(1, 2), n[None] @ rot.transpose(1, 2)
    return (vw, t.flip(1).contiguous(), nw, torch.ones_like(vw),
            torch.tensor([0.0, 0.0, 6.0]), torch.zeros(3),
            torch.tensor([0.0, 1.0, 0.0]), torch.tensor([[[0.0, 0.0, 6.0]]]),
            torch.ones(1, 1, 3), size, size)


def test_without_a_profile_a_span_records_nothing():
    assert not torch.autograd._profiler_enabled()
    first, second = profiling.annotate("a"), profiling.annotate("b")
    assert first is second  # one shared no-op context
    with first:
        with profiling.annotate("a.inner"):
            pass
    assert profiling.span_table() == {}


def test_spans_under_a_profile_are_host_events_with_counts_and_self_time():
    with _recording() as prof:
        for _ in range(3):
            with profiling.annotate("outer"):
                time.sleep(0.002)
                with profiling.annotate("outer.inner"):
                    time.sleep(0.004)
                with profiling.annotate("outer.inner"):
                    time.sleep(0.001)
    names = [e.name for e in prof.events()]
    assert names.count("outer") == 3 and names.count("outer.inner") == 6
    table = profiling.span_table()
    assert set(table) == {"outer", "outer.inner"}
    count, host_s, self_s = table["outer"]
    inner_count, inner_host_s, inner_self_s = table["outer.inner"]
    assert (count, inner_count) == (3, 6)
    assert inner_self_s == inner_host_s  # no span inside it
    assert self_s == pytest.approx(host_s - inner_host_s, abs=1e-9)
    assert host_s >= 0.021 and inner_host_s >= 0.015 and self_s >= 0.006
    # Once the profile stops, spans record nothing again.
    with profiling.annotate("outer"):
        pass
    assert profiling.span_table()["outer"][0] == 3


def test_each_thread_keeps_its_own_stack_of_open_spans():
    def worker():
        # A new thread does not see the profile's enabled flag, which is
        # the starting thread's, so the span is opened directly here.
        with profiling._Span("thread"):
            time.sleep(0.003)

    with _recording():
        with profiling.annotate("main"):
            thread = threading.Thread(target=worker)
            thread.start()
            thread.join(timeout=30)
            assert not thread.is_alive()
    table = profiling.span_table()
    # The other thread's span is no child of the main thread's.
    assert table["main"][2] == table["main"][1]
    assert table["thread"][0] == 1


def test_counters_count_and_reset_clears_both_tables():
    profiling.count("x")
    profiling.count("x", 4)
    counts = profiling.counters()
    assert counts == {"x": 5}
    counts["x"] = 0  # a copy
    assert profiling.counters() == {"x": 5}
    with _recording():
        with profiling.annotate("s"):
            pass
    profiling.reset()
    assert profiling.counters() == {} and profiling.span_table() == {}


def test_a_hard_render_counts_its_call_and_syncs_and_opens_its_spans():
    args = _cube_args()
    images = pmt.mesh_renderer.render(*args)
    # The plain route on the CPU: no kernel launch is counted.
    assert profiling.counters() == {"render.calls": 1,
                                    "host_syncs.camera": 2}
    assert profiling.span_table() == {}
    with _recording() as prof:
        traced = pmt.mesh_renderer.render(*args)
    assert torch.equal(images, traced)
    assert profiling.counters() == {"render.calls": 2,
                                    "host_syncs.camera": 4}
    table = profiling.span_table()
    # mr.rasterize.launch opens around K1's launch, on the card only.
    assert set(table) == {"mr.render", "mr.rasterize.pack",
                          *RENDER_CHILDREN}
    assert all(entry[0] == 1 for entry in table.values())
    names = {e.name for e in prof.events()}
    assert set(table) <= names
    # The render's self time and its children's host time add up to it.
    count, host_s, self_s = table["mr.render"]
    parts = self_s + sum(table[name][1] for name in RENDER_CHILDREN)
    assert parts == pytest.approx(host_s, rel=1e-9)
    assert table["mr.rasterize.pack"][1] <= table["mr.rasterize"][1]


def test_the_rasterize_entry_points_open_one_span_each():
    vw, tris = _cube_args()[:2]
    cams = pmt.camera.clip_space_transforms(
        torch.tensor([[0.0, 0.0, 6.0]]), torch.zeros(1, 3),
        torch.tensor([[0.0, 1.0, 0.0]]), torch.full([1], 40.0),
        torch.full([1], 0.01), torch.full([1], 10.0), 16, 16)
    with _recording():
        rasterize_ops.rasterize(vw, vw, tris, cams, 16, 16, torch.zeros(3))
        clip = pmt.camera.transform_homogeneous(cams, vw)
        rasterize_ops.rasterize_clip_space(clip, vw, tris, 16, 16,
                                           torch.zeros(3))
    table = profiling.span_table()
    assert table["mr.rasterize"][0] == 2
    assert table["mr.rasterize.pack"][0] == 2


def test_mesh_host_reads_are_counted_once_per_plan_or_edge_list():
    tris = torch.tensor([[0, 1, 2], [2, 3, 0]], dtype=torch.int32)
    mesh_ops.compute_edges_list(tris)
    mesh_ops.compute_edges_list(tris.numpy())  # an array: no device read
    values = torch.ones(1, 6, 2)
    mesh_ops.segment_sum(values, tris, 4)
    mesh_ops.segment_sum(values, tris, 4)  # the cached plan: no read
    assert profiling.counters() == {"host_syncs.mesh_edges": 1,
                                    "host_syncs.mesh_plan": 1}


def _step_parts():
    param = torch.zeros(3, requires_grad=True)
    optimizer = torch.optim.SGD([param], lr=0.1)

    def loss_fn(params, batch):
        return ((params[0] - batch) ** 2).sum()

    return loss_fn, optimizer, param


def test_step_and_loop_calls_are_spans_that_never_nest():
    loss_fn, optimizer, param = _step_parts()
    step = parallel.make_train_step(loss_fn, optimizer)
    batch = torch.ones(3)
    with _recording():
        for _ in range(3):
            step(batch)
    table = profiling.span_table()
    assert table["mr.step"][0] == 3
    # On the CPU a step runs eagerly: nothing is replayed or loaded.
    assert "mr.step.replay" not in table and "mr.step.load" not in table
    loss_fn, optimizer, param = _step_parts()
    loop = parallel.make_train_loop(loss_fn, optimizer, 4)
    profiling.reset()
    with _recording():
        losses = loop(batch)
    assert losses.shape == (4,)
    table = profiling.span_table()
    assert set(table) == {"mr.loop"} and table["mr.loop"][0] == 1
