"""The reconstruction cell (`softras_recon_64.recon_train_b64`, mode
`recon_train`) small on the CPU: its files load, a sound run is correct,
the control and a run with the timed path broken underneath are not, and
its new per-layer readers read what they should on synthetic tables."""

from __future__ import annotations

import json
import time

import pytest
import torch

from benchmark import compare, env, harness, net_kernels

NAME = "softras_recon_64.recon_train_b64"
SEED = 2147483647


def small_files():
    """(cell, config, traffic, limits) of the cell at a size the CPU
    holds: 16^2 images, a level-1 icosphere template, narrow widths, a
    data set of 6 objects and 2 objects a batch."""
    cell, config, traffic, limits = env.find_cell(NAME)
    config = json.loads(json.dumps(config))
    config["scene"].update(image_size=16, template={
        "kind": "icosphere", "subdivisions": 1})
    config["network"]["encoder"].update(dim1=4, dim2=32, dim_out=16)
    config["network"]["decoder"].update(dim_in=16, dim_hidden=[32, 64])
    config["dataset"].update(objects=6, meshes=["cube", "icosphere_1",
                                                "icosphere_2"])
    traffic = dict(traffic, objects=2, warmup_calls=1, trace_calls=3)
    return cell, config, traffic, limits


def run_small(seed=SEED, trace=0):
    cell, config, traffic, limits = small_files()
    return harness.run(cell, config, traffic, limits, seed, 0.5, trace,
                       "cpu", time.perf_counter())


def _cell(seed=SEED):
    cell, config, traffic, _ = small_files()
    e = env.Env(NAME, config, traffic, seed, "cpu")
    return harness.load_mode(traffic).Cell(e)


def test_the_cells_files_load_and_name_its_mode():
    cell, config, traffic, limits = env.find_cell(NAME)
    assert cell["chips"] == 1 and traffic["mode"] == "recon_train"
    assert config["reduced"] == ["dataset"]
    assert config["precision"] == "float32, TF32 off"
    assert set(limits["limits"]) == {"loss_gap", "grad_gap", "change_gap",
                                     "image_mean_gap", "image_max_gap"}
    assert harness.load_mode(traffic).KIND == "train"


def test_the_start_is_the_configurations_and_the_inputs_the_seeds():
    """Every seed starts from the configuration's weights (weights.seed);
    the seed draws the data set and the loader's batches."""
    a, b = _cell(SEED), _cell(SEED - 1)
    assert a.start.keys() == b.start.keys()
    assert all(torch.equal(a.start[k], b.start[k]) for k in a.start)
    assert not torch.equal(a.images, b.images)
    assert not torch.equal(a.batches[0]["images"], b.batches[0]["images"])


def test_a_sound_run_is_correct_and_reports_its_metrics():
    result, lines = run_small()
    assert result["correct"], lines
    assert result["attempted"] > 0 and result["failed"] == 0
    assert {"setup_s", "train_images_per_s",
            "peak_mem_gib"} == set(result["metrics"])
    assert lines[-1] == "correct: true"


def test_the_control_is_not_correct():
    c = _cell()
    _, _, _, limits = small_files()
    correct, checks = compare.judge(c.numbers(c.reference(tf32=True)),
                                    limits["limits"])
    assert not correct, checks


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "altered"])
def test_each_planted_fault_is_not_correct(fault):
    c = _cell()
    _, _, _, limits = small_files()
    correct, checks = compare.judge(c.numbers(c.reference(fault=fault)),
                                    limits["limits"])
    assert not correct, checks


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "altered"])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    from pytorch_mesh_renderer_tpu_torch.models import soft_mesh_renderer
    from pytorch_mesh_renderer_tpu_torch.ops import losses
    if fault == "state_unchanged":
        monkeypatch.setattr(torch.optim.Adam, "step",
                            lambda self, closure=None: None)
    elif fault == "half_batch":
        iou = losses.iou_loss
        monkeypatch.setattr(losses, "iou_loss", lambda p, t: iou(
            p[: p.shape[0] // 2], t[: t.shape[0] // 2]))
    else:
        render = soft_mesh_renderer.render_silhouette

        def altered(*args, **kwargs):
            out = render(*args, **kwargs).clone()
            out[0, out.shape[1] // 2, out.shape[2] // 2] += 1.0
            return out

        monkeypatch.setattr(soft_mesh_renderer, "render_silhouette",
                            altered)
    result, lines = run_small()
    assert not result["correct"], lines


def test_the_new_readers_by_hand():
    ctx = {"trace": {"units": 4, "by_name": {
        "void cutlass::Kernel2<cutlass_80_simt_sgemm_128x64_8x5_nn_align1>"
        "(Params)": 0.004,
        "sm90_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs": 0.002,
        "void cudnn::bn_fw_tr_1C11_kernel_NCHW<float>(float*)": 0.001,
        "void at::native::vectorized_elementwise_kernel<4, at::native::"
        "direct_copy_kernel_cuda<c10::convert<float>>>(int)": 0.0005,
        "void scal_kernel<float, float, 1, true, 6, 5, 5, 3>"
        "(cublasTransposeParams<float>, float const*)": 0.002,
        "soft_sil_fwd_kernel": 0.003}},
        "kernels": {"K5": {"group": "soft",
                           "symbols": ["soft_sil_fwd_kernel"]}},
        "steps_per_unit": 1}
    assert net_kernels.network_ms_per_step(ctx) == pytest.approx(2.0)
    assert net_kernels.glue_ms_per_step(ctx) == pytest.approx(0.375)
    table = {"mr.recon.batch": (10, 0.005, 0.005)}
    assert net_kernels.batch_ms_per_step(table) == pytest.approx(0.5)
    assert net_kernels.batch_ms_per_step({}) is None
    before = {"recon.steps": 3, "host_syncs.capture": 1}
    after = {"recon.steps": 103, "host_syncs.capture": 1,
             "host_syncs.mesh_plan": 2}
    assert net_kernels.host_syncs_per_step(after, before) == 0.02
    assert net_kernels.host_syncs_per_step(before, before) is None
    assert net_kernels.host_syncs_per_step(after, None) is None
    no_net = dict(ctx, trace={"units": 4, "by_name": {"abc_kernel": 1.0}})
    assert net_kernels.network_ms_per_step(no_net) is None
