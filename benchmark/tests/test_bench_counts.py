"""The roofline's work and byte counts, and the reference's pair counts,
on tiny scenes worked out by hand."""

from __future__ import annotations

import pytest
import torch

from benchmark import readers, roofline, trace
from benchmark.reference import hard, soft

PEAKS = {"fp32_flops_per_s": 67e12, "hbm_bytes_per_s": 3.35e12}


def _triangle_scene():
    """One triangle facing the camera at z = 0, seen from z = 4 at 8x8:
    its clip-space corners, faces in both windings."""
    v = torch.tensor([[[-0.9, -0.9, 0.0], [0.83, -0.9, 0.0],
                       [-0.9, 0.77, 0.0]]])
    ccw = torch.tensor([[0, 1, 2]])
    cam = (torch.tensor([[0.0, 0.0, 4.0]]), torch.zeros(1, 3),
           torch.tensor([[0.0, 1.0, 0.0]]))
    return v, ccw, cam


def _inside_by_hand(v, cam, size):
    """Pixels whose centre lies inside the projected triangle, counted by
    the half-plane tests on the NDC corners."""
    from benchmark.reference import camera
    m = camera.clip_transforms(*cam, 40.0, 0.01, 10.0, size, size)
    clip = camera.to_clip(m, v)[0]
    ndc = clip[:, :2] / clip[:, 3:]
    count = 0
    for row in range(size):
        for col in range(size):
            p = torch.tensor([(col + 0.5) * 2 / size - 1,
                              (row + 0.5) * 2 / size - 1])
            signs = []
            for i in range(3):
                a, b = ndc[i], ndc[(i + 1) % 3]
                signs.append(float((b[0] - a[0]) * (p[1] - a[1])
                                   - (b[1] - a[1]) * (p[0] - a[0])))
            if all(s > 0 for s in signs) or all(s < 0 for s in signs):
                count += 1
    return count


def test_hard_pairs_are_the_pixels_inside_one_triangle():
    v, ccw, cam = _triangle_scene()
    counts = {}
    hard.count(v, ccw.flip(1), *cam, 8, 40.0, 0.01, 10.0, counts)
    want = _inside_by_hand(v, cam, 8)
    assert want > 0
    assert counts == {"hard_pairs": want, "covered": want}


def test_soft_pairs_grow_with_the_blur_radius():
    v, ccw, cam = _triangle_scene()
    tight, wide = {}, {}
    for blur, counts in ((1e-6, tight), (0.3, wide)):
        soft.render(v, ccw, None, *cam, None, None, 8, 40.0, 0.01, 10.0,
                    1e-4, 1.0, blur, shade=False, counts=counts)
    assert tight["soft_pairs"] == _inside_by_hand(v, cam, 8)
    assert wide["soft_pairs"] > tight["soft_pairs"]
    assert wide["touched"] == wide["soft_pairs"]  # one triangle


def test_hard_forward_counts_by_hand():
    s = dict(B=2, V=10, T=4, H=8, W=8, A=9)
    c = {"hard_pairs": 100, "covered": 50}
    flops, nbytes = roofline.hard_forward(s, c)
    assert flops == 23 * 100 + (6 + 5 * 9) * 50
    assert nbytes == 4 * (2 * 10 * 13 + 12) + 4 * 2 * 64 * 10
    flops, nbytes = roofline.hard_backward(s, c)
    assert flops == (30 + 6 * 9) * 50
    assert nbytes == 4 * (50 * 11 + 2 * 10 * 13 + 12) + 4 * 2 * 10 * 13


def test_soft_counts_by_hand():
    s = dict(B=1, V=3, T=1, H=4, W=4, A=0, L=2)
    c = {"soft_pairs": 10, "touched": 5}
    assert roofline.soft_silhouette_forward(s, c) == (
        59 * 10, 4 * (12 + 3) + 4 * 16)
    assert roofline.soft_silhouette_backward(s, c) == (
        118 * 10, 4 * (10 + 12 + 3) + 4 * 12)
    per_pair = 59 + 83 + 17 * 2
    inputs = 4 * (3 * 13 + 3 + 8)
    assert roofline.soft_forward(s, c) == (per_pair * 10,
                                           inputs + 4 * 16 * 4)
    assert roofline.soft_backward(s, c) == (2 * per_pair * 10,
                                            4 * 8 * 5 + 2 * inputs)


def test_bound_takes_the_larger_time_and_refuses_missing_counts():
    s = dict(B=1, V=3, T=1, H=4, W=4, A=9, L=0)
    seconds, which = roofline.bound_seconds(
        "hard_forward", s, {"hard_pairs": 10 ** 12, "covered": 0}, PEAKS)
    assert which == "flops" and seconds == pytest.approx(23e12 / 67e12)
    seconds, which = roofline.bound_seconds(
        "hard_forward", s, {"hard_pairs": 0, "covered": 0}, PEAKS)
    assert which == "bytes"
    assert roofline.bound_seconds("hard_forward", s, {}, PEAKS) is None
    assert roofline.bound_seconds(None, s, {}, PEAKS) is None


def _ctx(by_name, units=2, steps_per_unit=1, work=None):
    kernels = {"K1": {"group": "hard", "symbols":
                      ["rasterize_fused_fwd_kernel"],
                      "work": "hard_forward"},
               "K3": {"group": "hard", "symbols":
                      ["rasterize_bary_fwd_kernel"], "work": None}}
    t = {"units": units, "window_s": 1.0, "busy_s": 0.25, "ops": 10,
         "by_name": by_name, "idle_by_host": {}}
    return {"trace": t, "kernels": kernels, "work": work, "peaks": PEAKS,
            "window": {"host_s": 0.5, "steps": 100},
            "steps_per_unit": steps_per_unit}


def test_readers_split_kernel_and_glue_time():
    by_name = {"void (anonymous namespace)::rasterize_fused_fwd_kernel("
               "float const*)": 0.004, "void at::native::add_kernel<4>()":
               0.006}
    ctx = _ctx(by_name, units=2)
    assert readers.group_ms_per_step(ctx, "hard") == pytest.approx(2.0)
    assert readers.group_ms_per_step(ctx, "soft") is None
    assert readers.glue_ms_per_step(ctx) == pytest.approx(3.0)
    assert readers.ops_per_step(ctx) == 5
    assert readers.idle_share(ctx) == pytest.approx(75.0)
    assert readers.host_ms_per_step(ctx) == pytest.approx(5.0)


def test_roofline_share_is_bound_over_time_and_silent_without_a_model():
    shape = dict(B=1, V=3, T=1, H=4, W=4, A=9, L=0)
    counts = {"hard_pairs": 0, "covered": 0}
    by_name = {"rasterize_fused_fwd_kernel": 1e-3}
    ctx = _ctx(by_name, units=2, work=(shape, counts, 1))
    bound, _ = roofline.bound_seconds("hard_forward", shape, counts, PEAKS)
    assert readers.roofline_share(ctx, "hard") == pytest.approx(
        100 * 2 * bound / 1e-3)
    by_name["rasterize_bary_fwd_kernel"] = 1e-3  # K3: no work model
    assert readers.roofline_share(ctx, "hard") is None
    assert readers.roofline_share(_ctx({}, work=None), "hard") is None


class _Range:
    def __init__(self, start, end):
        self.start, self.end = start, end


class _Event:
    def __init__(self, name, device, start, end, annotation=False):
        self.name, self.device_type = name, device
        self.time_range = _Range(start, end)
        self.is_user_annotation = annotation


def test_trace_reduction_unions_device_time_and_names_gaps():
    cuda = torch.autograd.DeviceType.CUDA
    cpu = torch.autograd.DeviceType.CPU
    events = [
        _Event("bench.window", cpu, 0, 100),
        _Event("bench.step", cpu, 0, 40),
        _Event("bench.wait", cpu, 40, 100),
        _Event("bench.step", cuda, 0, 100, annotation=True),
        _Event("k_a", cuda, 10, 30),
        _Event("k_b", cuda, 20, 40),  # overlaps k_a
        _Event("k_a", cuda, 70, 80),
    ]
    t = trace.reduce(events, units=2)
    assert t["busy_s"] == pytest.approx(40e-6)
    assert t["window_s"] == pytest.approx(100e-6)
    assert t["ops"] == 3
    assert t["by_name"]["k_a"] == pytest.approx(30e-6)
    assert t["idle_by_host"]["bench.wait"] == pytest.approx(50e-6)
    assert t["idle_by_host"]["bench.step"] == pytest.approx(10e-6)
    b = trace.breakdown(t)
    assert b["device_ops"][0] == ["k_a", pytest.approx(30e-6)]
    assert trace.reduce([_Event("bench.window", cpu, 0, 1)], 1) is None


def test_kernel_names_match_without_namespaces_or_arguments():
    assert trace.short_name("void (anonymous namespace)::soft_bwd_kernel"
                            "<4>(float*, int)") == "soft_bwd_kernel"
    assert trace.label("void at::native::f<int>(float*, int)") == \
        "at::native::f<int>"
