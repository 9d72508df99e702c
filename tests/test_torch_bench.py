"""PyTorch port: the bench (`python -m pytorch_mesh_renderer_tpu_torch.
bench`), the cost counts it reports (`utils/cost.py`) and the profiling
helpers (`utils/profiling.py`), on the CPU.

  * The visited pairs of `cost.hard_visits` and `cost.soft_visits` equal
    a brute-force count, block by block, pixel by pixel and row pair by
    row pair in Python loops over numpy float32 values, of the same culls:
    K1's per-block `row_may_cover` (tests/test_torch_hard_work.py's
    direct evaluation) and the soft kernels' block staging and
    `scan_row_pairs`.
  * Each bench mode runs in-process at 16^2-32^2, batch 1, one or two
    iterations: its JSON line holds bench.py's keys and the port's, every
    number finite, the device-only ones null on the CPU; no file appears
    in the repository. `--stress` hands its sizes to the hard step;
    without a card and without `--device cpu` the bench raises.
  * `profiling.trace` writes a Chrome trace holding an `annotate` region;
    `measure_throughput` returns positive rates.
"""

import json
import math
import os

import numpy as np
import pytest
import torch

from pytorch_mesh_renderer_tpu_torch import bench
from pytorch_mesh_renderer_tpu_torch.ops import rasterize_cuda as rc
from pytorch_mesh_renderer_tpu_torch.ops import soft_rasterize_cuda as sc
from pytorch_mesh_renderer_tpu_torch.utils import cost, profiling, test_utils

from test_torch_hard_work import _row_may_cover_direct, _scene

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = np.float32
KEYS = ("metric", "value", "unit", "ms_per_step", "vs_baseline",
        "model_flops_per_step", "model_hbm_bytes_per_step",
        "achieved_tflops", "achieved_hbm_gbps", "pct_h100_fp32_peak",
        "pct_h100_hbm_bw", "device", "eager_ms_per_step",
        "device_ms_per_step", "kernels_per_step")
CARD_ONLY = ("pct_h100_fp32_peak", "pct_h100_hbm_bw", "device_ms_per_step",
             "kernels_per_step")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes on one machine; the plain
    versions' large elementwise ops would otherwise take a thread per core
    in every worker at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", ["random", "ties"])
def test_hard_visits_equal_a_brute_force_count(name):
    clip, tris, _, width, height = _scene(name)
    table = rc.pack_rows(torch.from_numpy(np.array(clip)),
                         torch.from_numpy(np.array(tris)), False)[0]
    rows = table.numpy()
    want = 0
    for b, by, bx, t in np.ndindex(rows.shape[0], -(-height // 16),
                                   -(-width // 16), rows.shape[1]):
        if _row_may_cover_direct(rows[b, t], width, height, bx, by):
            want += sum(1 for y in range(16 * by, 16 * by + 16)
                        for x in range(16 * bx, 16 * bx + 16)
                        if x < width and y < height)
    assert 0 < want == cost.hard_visits(table, width, height)


@pytest.mark.parametrize("name", ["random3", "on_edges"])
def test_soft_visits_equal_a_brute_force_count(name):
    scene = test_utils.soft_scene(name, "cpu")
    width, height = scene.width, scene.height
    rows = scene.table.numpy()
    px, py = (t.numpy() for t in sc.pixel_centers(width, height, 0, height,
                                                  "cpu"))
    forward = backward = 0
    for b, by, bx, t in np.ndindex(rows.shape[0], -(-height // 16),
                                   -(-width // 16), rows.shape[1]):
        r = rows[b, t]
        xs = range(16 * bx, min(16 * bx + 16, width))
        ys = range(16 * by, min(16 * by + 16, height))
        # The block's pixel-centre extent inside the blur-inflated bbox.
        staged = (r[21] > F32(0.0) and r[23] >= px[xs[0]]
                  and r[22] <= px[xs[-1]] and r[25] >= py[ys[-1]]
                  and r[24] <= py[ys[0]])
        if not staged:
            continue
        forward += len(xs) * len(ys)
        for top in ys[::2]:  # a row pair: rows top and top + 1
            bottom = min(top + 1, ys[-1])
            backward += 32 * bool(py[top] >= r[24] and py[bottom] <= r[25])
    assert 0 < backward and 0 < forward
    assert cost.soft_visits(scene.table, width, height) == (forward,
                                                            backward)


def test_bound_ms_takes_the_larger_time():
    assert cost.bound_ms(3.35e9, 0) == (1.0, "bytes")
    assert cost.bound_ms(0, 67e9) == (1.0, "operations")
    assert cost.bound_ms(1.0, 0, 989e9, cost.PEAK_BF16_PER_S) == (
        1.0, "operations")


def _check_line(record, mode_keys=()):
    assert set(KEYS) | set(mode_keys) <= set(record)
    json.loads(json.dumps(record, allow_nan=False))
    assert record["device"] == "cpu"
    for key in CARD_ONLY:
        assert record[key] is None, key
    for key, value in record.items():
        if isinstance(value, (int, float)):
            assert math.isfinite(value), key
    assert record["value"] > 0 and record["ms_per_step"] > 0
    assert record["model_flops_per_step"] > 0
    assert record["model_hbm_bytes_per_step"] > 0
    assert record["eager_ms_per_step"] > 0


MODES = {
    "hard": ["--size", "16", "--sphere-resolution", "6"],
    "soft": ["--soft", "--size", "16", "--sphere-resolution", "6"],
    "silhouette": ["--soft", "--silhouette", "--size", "24",
                   "--sphere-resolution", "6"],
    "pose": ["--pose", "--steps", "2", "--size", "32"],
    "soft_sweep": ["--soft-sweep", "--size", "16"],
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_bench_mode_prints_its_json_line(mode, capsys):
    before = sorted(os.listdir(REPO_ROOT))
    records = bench.main(MODES[mode] + ["--device", "cpu", "--batch", "1",
                                        "--iters", "1"])
    printed = [json.loads(line) for line in
               capsys.readouterr().out.splitlines()]
    assert printed == records
    assert len(records) == (9 if mode == "soft_sweep" else 1)
    for record in records:
        _check_line(record, ("final_iou_loss",) if mode == "pose" else ())
        assert record["unit"] == ("steps/sec" if mode == "pose"
                                  else "renders/sec")
    assert sorted(os.listdir(REPO_ROOT)) == before


def test_stress_hands_its_sizes_to_the_hard_step(monkeypatch):
    seen = {}

    def fake(args, device, card):
        seen.update(vars(args))
        return []
    monkeypatch.setattr(bench, "bench_render_step", fake)
    bench.main(["--stress", "--device", "cpu"])
    assert (seen["size"], seen["batch"], seen["sphere_resolution"],
            seen["iters"]) == (512, 64, 72, 5)
    assert not seen["soft"]


def test_bench_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        bench.main(["--size", "16", "--batch", "1", "--iters", "1"])


def test_profiling_trace_and_throughput(tmp_path):
    x = torch.ones(64, 64)
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("matmul_region"):
            (x @ x).sum()
    with open(tmp_path / profiling.TRACE_FILE) as f:
        trace = f.read()
    assert "matmul_region" in trace
    rate, seconds = profiling.measure_throughput(
        lambda a: a @ a, x, iters=3, warmup=1, items_per_call=4)
    assert rate > 0 and seconds > 0
    assert math.isclose(rate, 4 / seconds)
