"""PyTorch port: the model of the hard forward kernel K1's split
(`utils/hard_work.split_forward_torch`) and the count of where its work
falls (`hard_work.block_keeps`, `kept_counts`, `count_summary`); the same
for the backward K2 (`hard_work.bwd_counts`, `warp_gradients_torch`).

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

The backward K2 reduces each winner's terms per warp of 8x4 pixels before
one global atomic per column: `hard_work.bwd_counts` (active pixels,
their distinct winners, warps, runs and distinct winners per warp and per 16x16 tile) equals a
direct count by Python loops, and the plain model of that reduction
(`hard_work.warp_gradients_torch`) equals the plain backward
(`triangle_gradients_torch`, one sum per pixel) within 1e-6 of its max
|value| at A = 0, 1, 9 and 13: the reduction changes only the order of
f32 sums.

K4 runs K2's body without attributes: the same model at A = 0 equals the
plain version of K4 (`rasterize_barycentric_cuda.
triangle_gradients_bary_torch`) within 1e-6 of its max |value| on every
scene, and, scattered to the vertices, the JAX package's K4
(`_backward_pallas`, through `jax.grad` of
`rasterize_barycentric_pallas_batched` in interpret mode) within 1e-5 of
its max |value|, the JAX suite's gate between its backward backends.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_mesh_renderer_tpu.ops import camera as jcam
from pytorch_mesh_renderer_tpu.ops.rasterize_pallas import (
    rasterize_barycentric_pallas_batched, rasterize_interpolate_pallas_batched)
from pytorch_mesh_renderer_tpu.ops.rasterize_xla import (
    rasterize_barycentric_xla)
from pytorch_mesh_renderer_tpu_torch.ops import rasterize_barycentric_cuda as rb
from pytorch_mesh_renderer_tpu_torch.ops import rasterize_cuda as rc
from pytorch_mesh_renderer_tpu_torch.utils import hard_work, test_utils

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


_ties_scene = functools.cache(test_utils.ties_scene)


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


# The backward K2 (csrc/rasterize_fused_bwd.cu): where its work falls
# (`hard_work.bwd_counts`) against a direct count, and the plain model of
# its reduction per 8x4 warp and winner (`hard_work.warp_gradients_torch`)
# against the plain backward.

def _forward(scene, attr_count=None):
    """(clip, triangles, attributes, width, height, ids, bc) of a scene
    through the plain forward; attributes redrawn with attr_count columns
    when given."""
    clip, tris, attrs, width, height = _scene(scene)
    if attr_count is not None:
        attrs = np.random.RandomState(attr_count).randn(
            *attrs.shape[:2], attr_count).astype(F32)
    ids, bc = rc.rasterize_interpolate_torch(
        _t(clip), _t(attrs), _t(tris), width, height)[:2]
    return clip, tris, attrs, width, height, ids, bc


def _direct_bwd_counts(ids, bc):
    """bwd_counts' per-image dicts by Python loops over pixels, lanes,
    warps and tiles, the activity test in numpy float32 in the kernels'
    order."""
    ids, bc = ids.numpy(), bc.numpy()
    images = []
    for b in range(ids.shape[0]):
        height, width = ids[b].shape
        winner = np.full((height, width), -1)
        for y, x in np.ndindex(height, width):
            c = bc[b, y, x]
            if not (ids[b, y, x] == 0 and (c[0] + c[1]) + c[2] < F32(0.9)):
                winner[y, x] = ids[b, y, x]

        def blocks(bw, bh):
            return [[winner[y, x] if y < height and x < width else -1
                     for y in range(by, by + bh) for x in range(bx, bx + bw)]
                    for by in range(0, height, bh)
                    for bx in range(0, width, bw)]

        flat = list(winner.reshape(-1)) + [-1] * (-winner.size % 32)
        row_warps = [flat[i:i + 32] for i in range(0, len(flat), 32)]
        warps, tiles = blocks(8, 4), blocks(16, 16)
        tile_winners = [len({v for v in t if v >= 0}) for t in tiles]
        images.append({
            "pixels": winner.size,
            "active_pixels": int((winner >= 0).sum()),
            "winners": len({v for v in winner.reshape(-1) if v >= 0}),
            "row_warps": len(row_warps),
            "row_warps_active": sum(max(w) >= 0 for w in row_warps),
            "row_runs": sum(1 for w in row_warps for i, v in enumerate(w)
                            if v >= 0 and (i == 0 or w[i - 1] != v)),
            "warps_active": sum(max(w) >= 0 for w in warps),
            "warp_winners": sum(len({v for v in w if v >= 0})
                                for w in warps),
            "tiles": len(tiles),
            "tiles_active": sum(max(t) >= 0 for t in tiles),
            "tile_winners": sum(tile_winners),
            "busiest_tile_winners": max(tile_winners),
        })
    return images


@pytest.mark.parametrize("scene", ["random", "ties", "empty"])
def test_backward_counts_equal_a_direct_count(scene):
    *_, ids, bc = _forward(scene)
    counts = hard_work.bwd_counts(ids, bc)
    direct = _direct_bwd_counts(ids, bc)
    assert counts["per_image"] == direct
    for key, total in counts["total"].items():
        values = [image[key] for image in direct]
        assert total == (max(values) if key.startswith("busiest")
                         else sum(values))
    active = counts["total"]["active_pixels"]
    assert (active == 0) == (scene == "empty")
    if active:  # winners that K2's 8x4 warps join, and tiles join further
        total = counts["total"]
        assert total["tile_winners"] < total["warp_winners"] < total[
            "row_runs"]
        assert 0 < total["winners"] <= total["tile_winners"]


@pytest.mark.parametrize("scene", ["random", "ties", "empty"])
def test_backward_writes_only_the_winners_rows(scene):
    """The rows of the plain backward's table that are not zero are rows
    of `bwd_counts`' winners, image by image: the rows that chip_smoke.py's
    K2 and K4 bounds charge."""
    clip, tris, attrs, width, height, ids, bc = _forward(scene)
    table, inv_abs_det = rc.pack_rows(_t(clip), _t(tris), True)
    corner = rc.pack_corner_attributes(_t(attrs), _t(tris))
    rng = np.random.RandomState(7)
    plain = rc.triangle_gradients_torch(
        ids, bc, _t(rng.randn(*bc.shape).astype(F32)),
        _t(rng.randn(*ids.shape, attrs.shape[-1]).astype(F32)), table,
        inv_abs_det, corner)
    active = hard_work.active_pixels(ids, bc)
    counts = hard_work.bwd_counts(ids, bc)["per_image"]
    for b in range(ids.shape[0]):
        winners = set(ids[b][active[b]].tolist())
        written = set(torch.nonzero(plain[b].abs().amax(-1) > 0)[:, 0]
                      .tolist())
        assert written <= winners
        assert len(winners) == counts[b]["winners"]
        assert (len(written) > 0) == (scene != "empty")


@pytest.mark.parametrize("scene", ["random", "ties", "empty"])
@pytest.mark.parametrize("attr_count", [0, 1, 9, 13])
def test_k2_reduction_model_equals_the_plain_backward(scene, attr_count):
    clip, tris, attrs, width, height, ids, bc = _forward(scene, attr_count)
    table, inv_abs_det = rc.pack_rows(_t(clip), _t(tris), True)
    corner = rc.pack_corner_attributes(_t(attrs), _t(tris))
    rng = np.random.RandomState(5)
    operands = (ids, bc, _t(rng.randn(*bc.shape).astype(F32)),
                _t(rng.randn(*ids.shape, attr_count).astype(F32)), table,
                inv_abs_det, corner)
    plain = rc.triangle_gradients_torch(*operands)
    model = hard_work.warp_gradients_torch(*operands)
    assert model.shape == plain.shape == (2, len(tris), 9 + 3 * attr_count)
    if scene == "empty":
        assert plain.numel() == 0
        return
    scale = float(plain.abs().max())
    assert scale > 0.0
    assert float((model - plain).abs().max()) <= 1e-6 * scale


# The barycentric-only backward K4 runs K2's body at A = 0: its plain
# model is warp_gradients_torch without attributes.

def _k4_operands(scene):
    """(ids, bc, df/dbc, table, inv_abs_det) of a scene's plain forward,
    df/dbc drawn from a seeded numpy generator, and the scene."""
    clip, tris, attrs, width, height, ids, bc = _forward(scene)
    table, inv_abs_det = rc.pack_rows(_t(clip), _t(tris), True)
    df_dbc = _t(np.random.RandomState(11).randn(*bc.shape).astype(F32))
    return (ids, bc, df_dbc, table, inv_abs_det), (clip, tris, width,
                                                   height)


def _k4_model(ids, bc, df_dbc, table, inv_abs_det):
    no_attrs = torch.zeros(ids.shape + (0,))
    corner = torch.zeros(table.shape[:2] + (3, 0))
    return hard_work.warp_gradients_torch(ids, bc, df_dbc, no_attrs, table,
                                          inv_abs_det, corner)


@pytest.mark.parametrize("scene", ["random", "ties", "empty"])
def test_k4_reduction_model_equals_the_plain_backward(scene):
    operands, _ = _k4_operands(scene)
    plain = rb.triangle_gradients_bary_torch(*operands)
    model = _k4_model(*operands)
    assert model.shape == plain.shape == (2, operands[3].shape[1], 9)
    if scene == "empty":
        assert plain.numel() == 0
        return
    scale = float(plain.abs().max())
    assert scale > 0.0
    assert float((model - plain).abs().max()) <= 1e-6 * scale


def test_k4_reduction_model_matches_the_jax_kernel():
    (ids, bc, df_dbc, table, inv_abs_det), (clip, tris, width, height) = (
        _k4_operands("random"))
    ours = rc.scatter_triangle_gradients(
        _k4_model(ids, bc, df_dbc, table, inv_abs_det), _t(tris),
        clip.shape[1])[0].numpy()

    def loss(c):
        bc_j = rasterize_barycentric_pallas_batched(
            c, jnp.asarray(tris), width, height, interpret=True,
            dot_precision="highest")[1]
        return jnp.sum(bc_j * jnp.asarray(df_dbc.numpy()))

    bc_j = np.asarray(rasterize_barycentric_pallas_batched(
        jnp.asarray(clip), jnp.asarray(tris), width, height, interpret=True,
        dot_precision="highest")[1])
    np.testing.assert_allclose(bc.numpy(), bc_j, atol=2e-5)
    theirs = np.asarray(jax.grad(loss)(jnp.asarray(clip)))
    assert ours.shape == theirs.shape == clip.shape
    scale = float(np.abs(theirs).max())
    assert scale > 0.0
    np.testing.assert_allclose(ours / scale, theirs / scale, rtol=0,
                               atol=1e-5)
