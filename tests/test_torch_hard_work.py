"""PyTorch port: the model of the hard forward kernel K1's split
(`utils/hard_work.split_forward_torch`) and the count of where its work
falls (`hard_work.block_keeps`, `kept_counts`, `count_summary`).

K1 runs a cluster of kSplit CTAs per pixel block; CTA s tests the rows
t = s (mod kSplit) alone and the partial winners are merged by the smaller
z, then the larger id. The model does the same with the plain forward:
its merged ids, bc and attributes must equal the whole run bit for bit at
every split, and z in value, on a seeded random scene, on a scene snapped
to pixel centres whose triangles tie in depth (+0.0 against -0.0 too), and
on the zero-triangle mesh. (The plain version's z is its chunk's minimum,
so where +0.0 and -0.0 tie its sign of zero depends on the chunking; the
kernel keeps the winner's own z.) The card holds the kernel itself to the
rule bit for bit, z included, across splits and against K3
(tests/test_torch_cuda.py, chip_smoke.py phase 3).

Against the JAX package: the merged model on the random scene against
K1's Pallas counterpart (`rasterize_interpolate_pallas_batched`) in
interpret mode, as tests/test_torch_rasterize.py runs it: ids equal, bc
and attributes within that test's 2e-5 (measured 1.4e-6 and 2.9e-6; the
JAX side may contract products into FMAs). The snapped scene is not held
to JAX pixel by pixel: its edges run through pixel centres, where the
inside test is decided by rounding and the two packages round differently
(242 of 5,760 ids differ against the Pallas kernel). On both scenes every
pixel the JAX package covers (the Pallas kernel on the random scene,
`rasterize_barycentric_xla` on the snapped one) has its winner among the
rows that K1's cull keeps for that pixel's block, and the cull equals a
direct scalar evaluation of the kernel's rule
(`row_may_cover` in csrc/rasterize_common.cuh) in numpy float32.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pytorch_mesh_renderer_tpu.ops import camera as jcam
from pytorch_mesh_renderer_tpu.ops.rasterize_pallas import (
    rasterize_interpolate_pallas_batched)
from pytorch_mesh_renderer_tpu.ops.rasterize_xla import (
    rasterize_barycentric_xla)
from pytorch_mesh_renderer_tpu_torch.ops import rasterize_cuda as rc
from pytorch_mesh_renderer_tpu_torch.utils import hard_work

F32 = np.float32


@functools.cache
def _random_scene(seed=0, batch=2, vertex_count=24, tri_count=30,
                  attr_count=5, width=48, height=40):
    """tests/test_rasterize_pallas.py's random scene as numpy arrays:
    (clip [B, V, 4], triangles [T, 3], attributes [B, V, A], W, H)."""
    rng = np.random.RandomState(seed)
    verts = (rng.randn(batch, vertex_count, 3) * 0.5).astype(F32)
    tris = rng.randint(0, vertex_count, (tri_count, 3)).astype(np.int32)
    attrs = rng.randn(batch, vertex_count, attr_count).astype(F32)
    eye = jnp.tile(jnp.array([[0.0, 0.0, 3.0]]), (batch, 1))
    up = jnp.tile(jnp.array([[0.0, 1.0, 0.0]]), (batch, 1))
    cam = jcam.clip_space_transforms(eye, jnp.zeros((batch, 3)), up, 40.0,
                                     0.01, 10.0, width, height)
    clip = np.asarray(jcam.transform_homogeneous(cam, jnp.asarray(verts)))
    return clip, tris, attrs, width, height


@functools.cache
def _ties_scene(seed=3, batch=2, tri_count=160, width=40, height=36):
    """Small triangles with their own corners on pixel centres, each at one
    depth of {0.5, 0.25, 0.0, -0.0, -0.5} (w = 1), so that many pixels
    see equal z from several triangles: exact ties, +0.0 against -0.0 too.
    The image is not a whole number of 16x16 blocks."""
    rng = np.random.RandomState(seed)
    first = np.stack([rng.randint(0, width, (batch, tri_count)),
                      rng.randint(0, height, (batch, tri_count))], -1)
    corners = first[:, :, None, :] + rng.randint(-7, 8, (batch, tri_count,
                                                        3, 2))
    corners[:, :, 0] = first
    scale = np.array([F32(2.0 / width), F32(2.0 / height)], F32)
    ndc = ((corners + 0.5) * scale - 1.0).astype(F32)
    depth = np.array([0.5, 0.25, 0.0, -0.0, -0.5], F32)[
        rng.randint(0, 5, (batch, tri_count))]
    clip = np.concatenate([
        ndc, np.broadcast_to(depth[:, :, None, None], ndc.shape[:3] + (1,)),
        np.ones(ndc.shape[:3] + (1,), F32)], -1)
    clip = clip.reshape(batch, 3 * tri_count, 4)
    tris = np.arange(3 * tri_count, dtype=np.int32).reshape(tri_count, 3)
    attrs = rng.randn(batch, 3 * tri_count, 4).astype(F32)
    return clip, tris, attrs, width, height


def _scene(name):
    if name == "ties":
        return _ties_scene()
    clip, tris, attrs, width, height = _random_scene()
    return clip, (tris[:0] if name == "empty" else tris), attrs, width, height


def _t(array):
    return torch.from_numpy(np.array(array))


def _bits(tensor):
    """The tensor's bits: -0.0 and 0.0 differ."""
    return tensor.view(torch.int32) if tensor.is_floating_point() else tensor


def test_ties_scene_has_signed_zero_ties():
    clip, tris, attrs, width, height = _ties_scene()
    z = rc.rasterize_interpolate_torch(_t(clip), _t(attrs), _t(tris), width,
                                       height, with_z=True)[3]
    assert bool((z == 0.0).any())
    assert bool((torch.signbit(z) & (z == 0.0)).any())  # -0.0 wins somewhere
    assert bool((~torch.signbit(z) & (z == 0.0)).any())


@pytest.mark.parametrize("scene", ["random", "ties", "empty"])
@pytest.mark.parametrize("split", [2, 3, 4, 8])
def test_split_model_merges_to_the_whole_run_bit_for_bit(scene, split):
    clip, tris, attrs, width, height = _scene(scene)
    args = (_t(clip), _t(attrs), _t(tris), width, height)
    whole = rc.rasterize_interpolate_torch(*args, with_z=True)
    merged = hard_work.split_forward_torch(*args, split)
    for got, want in zip(merged, whole):
        assert got.dtype == want.dtype and got.shape == want.shape
    for got, want in zip(merged[:3], whole[:3]):  # ids, bc, attributes
        assert torch.equal(_bits(got), _bits(want))
    # z: equal in value; its bits differ only in the sign of a zero, which
    # the plain version takes from its chunk's amin over +0.0 and -0.0.
    z, z_whole = merged[3], whole[3]
    assert torch.equal(z, z_whole)
    assert bool((z[_bits(z) != _bits(z_whole)] == 0.0).all())
    if scene == "empty":
        assert not bool(merged[0].any()) and bool((merged[3] == 1.0).all())


def test_split_model_matches_the_jax_kernel():
    clip, tris, attrs, width, height = _random_scene()
    ids, bc, attr_img, _ = hard_work.split_forward_torch(
        _t(clip), _t(attrs), _t(tris), width, height, 4)
    ids_p, bc_p, attr_p = map(np.asarray, rasterize_interpolate_pallas_batched(
        jnp.asarray(clip), jnp.asarray(attrs), jnp.asarray(tris), width,
        height, interpret=True, spatial_sort=False, dot_precision="highest"))
    np.testing.assert_array_equal(ids.numpy(), ids_p)
    np.testing.assert_allclose(bc.numpy(), bc_p, atol=2e-5)
    np.testing.assert_allclose(attr_img.numpy(), attr_p, atol=2e-5)
    _assert_winners_survive_the_cull(clip, tris, width, height, ids_p, bc_p)


def _assert_winners_survive_the_cull(clip, tris, width, height, ids, bc):
    """Every pixel covered in the JAX package's (ids [B, H, W], bc) has its
    winner among the rows that K1's cull keeps for the pixel's block."""
    keeps = hard_work.block_keeps(
        rc.pack_rows(_t(clip), _t(tris), False)[0], width, height).numpy()
    b, rows, cols = np.nonzero(bc.sum(-1) > 0.0)
    assert rows.size > 0
    assert keeps[b, rows // 16, cols // 16, ids[b, rows, cols]].all()


def _row_may_cover_direct(row, width, height, bx, by):
    """`row_may_cover` of csrc/rasterize_common.cuh for one row and one
    16x16 block, in numpy float32 scalars in the kernel's operation
    order."""
    scale_x, scale_y = F32(rc.pixel_scale(width)), F32(rc.pixel_scale(height))

    def ndc(index, scale):
        return (F32(index) + F32(0.5)) * scale - F32(1.0)

    px_lo, px_hi = ndc(16 * bx, scale_x), ndc(min(16 * bx + 16, width) - 1,
                                              scale_x)
    py_lo, py_hi = ndc(16 * by, scale_y), ndc(min(16 * by + 16, height) - 1,
                                              scale_y)
    if not row[15] > F32(0.0):
        return False
    px_max = np.fmax(F32(1.0), np.fmax(abs(px_lo), abs(px_hi)))
    py_max = np.fmax(F32(1.0), np.fmax(abs(py_lo), abs(py_hi)))
    for edge in range(3):
        a, b, c = row[3 * edge:3 * edge + 3]
        e = [a * x + b * y + c for x, y in ((px_lo, py_lo), (px_hi, py_lo),
                                            (px_lo, py_hi), (px_hi, py_hi))]
        bound = (F32(1e-6) * (abs(a) * px_max + abs(b) * py_max + abs(c))
                 + F32(1e-30))
        if np.fmax(np.fmax(e[0], e[1]), np.fmax(e[2], e[3])) < (
                F32(-2.0) * bound):
            return False
    return True


@pytest.mark.parametrize("scene", ["random", "ties"])
def test_cull_counts_equal_a_direct_evaluation(scene):
    clip, tris, _, width, height = _scene(scene)
    table = rc.pack_rows(_t(clip), _t(tris), False)[0]
    keeps = hard_work.block_keeps(table, width, height)
    rows = table.numpy()
    direct = np.zeros(keeps.shape, bool)
    for b, by, bx, t in np.ndindex(*direct.shape):
        direct[b, by, bx, t] = _row_may_cover_direct(rows[b, t], width,
                                                     height, bx, by)
    np.testing.assert_array_equal(keeps.numpy(), direct)
    assert 0 < direct.sum() < direct.size  # the cull keeps some, drops some

    split = 3
    counts = hard_work.kept_counts(table, width, height, split).numpy()
    for s in range(split):
        np.testing.assert_array_equal(counts[..., s],
                                      direct[..., s::split].sum(-1))
    summary = hard_work.count_summary(table, width, height, splits=(2, 4))
    per_block = direct.sum(-1)
    assert summary["blocks"] == per_block.size
    assert summary["busy_blocks"] == int((per_block > 0).sum())
    assert summary["max_kept"] == int(per_block.max())
    assert summary["kept_pairs"] == int(per_block.sum())
    assert summary["busiest_cta"] == {
        s: int(max(direct[..., r::s].sum(-1).max() for r in range(s)))
        for s in (2, 4)}
    # K1's cluster serves a group of 2x2 blocks: a thread of CTA r runs
    # each row t = r (mod s) once for each block of the group it may cover.
    group_tests = {s: 0 for s in (2, 4)}
    for b, gy, gx in np.ndindex(direct.shape[0], -(-direct.shape[1] // 2),
                                -(-direct.shape[2] // 2)):
        group = direct[b, 2 * gy:2 * gy + 2, 2 * gx:2 * gx + 2]
        for s in group_tests:
            for r in range(s):
                group_tests[s] = max(group_tests[s],
                                     int(group[..., r::s].sum()))
    assert summary["busiest_group_cta"] == group_tests


def test_every_jax_winner_survives_the_cull_on_the_ties_scene():
    clip, tris, _, width, height = _ties_scene()
    ids, bc = (np.stack(a) for a in zip(*(
        map(np.asarray, rasterize_barycentric_xla(
            jnp.asarray(image), jnp.asarray(tris), width, height)[:2])
        for image in clip)))
    _assert_winners_survive_the_cull(clip, tris, width, height, ids, bc)


def test_off_screen_floor_table_keeps_no_row():
    clip, _, tris, size = hard_work.scene_tables("teapot 256",
                                                 torch.device("cpu"))
    assert bool(hard_work.block_keeps(rc.pack_rows(clip, tris, False)[0],
                                      size, size).any())
    table = rc.pack_rows(hard_work.off_screen(clip), tris, False)[0]
    assert not bool(hard_work.block_keeps(table, size, size).any())
