"""PyTorch port of scripts/patch_scatter_microbench.py (S3) vs the JAX
script, and the bench scenes (utils/scenes.py) vs bench.build_scene.

The script's `main` runs in this process in interpret mode at the headline
config, batch 1; the arrays it hands to `jax.block_until_ready` are
recorded. On the script's own clip vertices:

  * stage A: the port's bbox (binning._bbox_live_cols' formula) equals the
    script's packed columns 16-19 bit for bit, and the port's plan gives
    the same instances, origins and drop count;
  * stage B: the port's plain patch evaluation of the script's instance
    table equals the script's kernel outputs within 1e-6 of max |value|
    (XLA on the CPU contracts products into FMAs), with the same valid
    lanes;
  * stage C: the port's two merges of the script's kernel outputs equal the
    script's merges: ids, bc and z bit for bit;
  * end to end on the port's own packing: both merges give the port's
    production forward (K3's plain version) exactly, and the script's
    production ids. (bc is not compared across the packages here: the two
    packings' edge coefficients differ in the last bits, and bc = e / sum(e)
    scales that up for the teapot's smallest triangles; the port's
    rasterizer tests hold that comparison.)
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bench
from pytorch_mesh_renderer_tpu.ops import camera as jcam
from pytorch_mesh_renderer_tpu_torch.microbench import patch_scatter as ps
from pytorch_mesh_renderer_tpu_torch.ops import rasterize_barycentric_cuda as rb
from pytorch_mesh_renderer_tpu_torch.utils import scenes
from test_torch_microbench_edge import run_script

PATCH = (16, 8)


def _jax_clip(batch, size, sphere):
    """The script's scene and clip vertices (patch_scatter_microbench.py:
    104-114): bench.build_scene through the JAX camera."""
    scene = bench.build_scene(batch, size, sphere)
    ones = jnp.ones([batch])
    cams = jcam.clip_space_transforms(
        scene["eye"], scene["center"], scene["up"], 40.0 * ones,
        0.01 * ones, 10.0 * ones, size, size)
    return scene, np.asarray(jcam.transform_homogeneous(
        cams, scene["vertices"]))


@pytest.mark.parametrize("config", ["headline", "stress"])
def test_scenes_match_the_bench(config):
    size, sphere = ps.CONFIGS[config]
    scene, clip = _jax_clip(4, size, sphere)
    port = scenes.build_scene(4, "cpu", sphere)
    assert port["mesh_name"] == scene["mesh_name"]
    assert port["tri_count"] == scene["tri_count"]
    np.testing.assert_array_equal(port["triangles"].numpy(),
                                  scene["triangles"])
    for key in ("vertices", "normals", "diffuse", "eye", "center", "up",
                "lights", "intensities"):
        np.testing.assert_allclose(port[key].numpy(), np.asarray(scene[key]),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(scenes.clip_vertices(port, size).numpy(),
                               clip, rtol=1e-6, atol=1e-6)


def _equal(port_tree, script_tree):
    for port, ref in zip(port_tree, script_tree):
        np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


def test_stages_match_the_script(monkeypatch, capsys):
    recorded, printed = run_script(
        "patch_scatter_microbench", ["--batch", "1", "--iters", "1",
                                     "--windows", "1", "--interpret"],
        monkeypatch, capsys)
    assert printed["id_mismatch_px"] == printed["scatter_id_mismatch_px"] == 0
    # The script's order: pack, production, plan, patch end to end,
    # production, plan, kernel, scatter merge, then the timed calls.
    packed, script_prod = recorded[0], recorded[4]
    (script_sort, _), script_scatter = recorded[3], recorded[7]
    script_table, script_inst, script_dropped = recorded[5]
    script_eval = recorded[6]
    scene, clip = _jax_clip(1, 256, None)
    tris = torch.from_numpy(np.ascontiguousarray(scene["triangles"],
                                                 np.int32))
    clip = torch.from_numpy(clip.copy())

    # Stage A.
    rows, bbox = ps.pack(clip, tris)
    np.testing.assert_array_equal(bbox.numpy(), packed[..., 16:20])
    table, inst_tri, n_dropped = ps.plan(rows, bbox, 256, PATCH, 32, 4)
    np.testing.assert_array_equal(inst_tri.numpy(), script_inst)
    np.testing.assert_array_equal(table[..., 16:18].numpy(),
                                  script_table[..., 21:23])
    assert n_dropped.tolist() == script_dropped.tolist() == [0]

    # Stage B on the script's own instance table (its 24 columns: the 16
    # the port packs, the bbox and 1/|det|, then the origin).
    theirs = torch.from_numpy(np.concatenate(
        [script_table[..., :16], script_table[..., 21:23],
         np.zeros(script_table.shape[:2] + (2,), np.float32)], -1))
    port_eval = ps.patch_eval_torch(theirs, 256, PATCH)
    np.testing.assert_array_equal(port_eval[0].numpy() < 2.0,
                                  script_eval[0] < 2.0)
    for port, ref in zip(port_eval, script_eval):
        assert (float(np.abs(port.numpy() - ref).max())
                <= 1e-6 * float(np.abs(ref).max()))

    # Stage C on the script's kernel outputs.
    kouts = [torch.from_numpy(np.asarray(a).copy()) for a in script_eval]
    inst = torch.from_numpy(script_inst.astype(np.int64))
    _equal(ps.merge_sort(*kouts, theirs, inst, 256, PATCH), script_sort)
    _equal(ps.merge_scatter(*kouts, theirs, inst, 256, PATCH),
           script_scatter)

    # End to end on the port's packing against its production forward.
    outs = ps.patch_eval_torch(table, 256, PATCH)
    prod = rb.rasterize_barycentric_torch(clip, tris, 256, 256)
    np.testing.assert_array_equal(prod[0].numpy(), script_prod[0])
    for merge in (ps.merge_sort, ps.merge_scatter):
        ids, bc, z = merge(*outs, table, inst_tri, 256, PATCH)
        assert torch.equal(ids, prod[0])
        assert float((bc - prod[1]).abs().max()) <= 1e-6
        assert float((z - prod[2]).abs().max()) <= 1e-6


def test_main_on_the_cpu_prints_the_script_keys(monkeypatch, capsys):
    # The configs shrunk to 64x64 so that the plain production forward
    # stays quick on the CPU; the stress mesh is a 128-triangle sphere.
    monkeypatch.setitem(ps.CONFIGS, "headline", (64, None))
    monkeypatch.setitem(ps.CONFIGS, "stress", (64, 8))
    for config in ("headline", "stress"):
        ps.main(["--device", "cpu", "--config", config, "--batch", "2",
                 "--iters", "1", "--windows", "1"])
        printed = json.loads(capsys.readouterr().out)
        assert printed["config"] == config and printed["batch"] == 2
        assert printed["capped_or_overflowed_triangles"] == 0
        assert printed["id_mismatch_px"] == 0
        assert printed["scatter_id_mismatch_px"] == 0
        assert printed["bc_max_err"] <= 1e-6 and printed["z_max_err"] <= 1e-6
        assert printed["instances_live"] <= printed["instances_padded"]
        assert printed["patch_vs_prod"] > 0.0 and printed["device"] == "cpu"


def test_the_cap_and_the_budget_drop_triangles():
    scene = scenes.build_scene(1, "cpu")
    rows, bbox = ps.pack(scenes.clip_vertices(scene, 256),
                         scene["triangles"])
    _, inst_tri, n_dropped = ps.plan(rows, bbox, 256, PATCH, 32, 4)
    assert int(n_dropped.sum()) == 0
    live = int((inst_tri < rows.shape[1]).sum())
    # A budget of one instance per triangle cannot hold them all.
    _, small_inst, small_dropped = ps.plan(rows, bbox, 256, PATCH, 32, 1)
    assert int(small_dropped.sum()) > 0
    assert 0 < int((small_inst < rows.shape[1]).sum()) < live
    # Capped at one instance, every triangle spanning two is dropped.
    _, _, capped = ps.plan(rows, bbox, 256, PATCH, 1, 4)
    assert int(capped.sum()) > 0
    with pytest.raises(ValueError, match="128"):
        ps.parse_patch("8x8")


def test_the_kernel_needs_a_card():
    with pytest.raises(ValueError, match="CUDA"):
        ps.launch_patch_eval(torch.zeros(1, 8, ps.TABLE_COLS), 64, PATCH)
