"""PyTorch port: the fused rasterizer (K1) — plain version vs the JAX
package, goldens and contracts. The CUDA kernel itself is held against the
plain version on the card by tests/test_torch_cuda.py.

Tolerances, with their reasons:
  * vs the dense XLA spec (`rasterize_barycentric_xla`) on the 64x48 cube:
    ids equal, bc and z to 1e-6. Both evaluate the same edge functions in
    fp32; XLA on the CPU may contract products into FMAs and divides where
    the port multiplies by a reciprocal, which moves the last bits.
  * vs the Pallas kernel in interpret mode on the 48x40 random scenes:
    2e-5, the JAX suite's own forward tolerance for that comparison.
  * row strips, chunk sizes: exactly equal (the same operations per pixel).
  * goldens: the reference gate, <= 0.1% of pixels off by > 0.01.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_mesh_renderer_tpu.ops import camera as jcam
from pytorch_mesh_renderer_tpu.ops.rasterize_pallas import (
    _pack_triangle_data, rasterize_interpolate_pallas_batched)
from pytorch_mesh_renderer_tpu.ops.rasterize_xla import (
    rasterize_barycentric_xla)
from pytorch_mesh_renderer_tpu_torch import config as config_lib
from pytorch_mesh_renderer_tpu_torch.ops import rasterize as rasterize_ops
from pytorch_mesh_renderer_tpu_torch.ops import rasterize_cuda as rc
from pytorch_mesh_renderer_tpu_torch.utils import test_utils

from conftest import GOLDEN_DIR, ORACLE_DIR

CUBE_VERTICES = np.array(
    [[-1, -1, 1], [-1, -1, -1], [-1, 1, -1], [-1, 1, 1], [1, -1, 1],
     [1, -1, -1], [1, 1, -1], [1, 1, 1]], np.float32)
CUBE_TRIANGLES = np.array(
    [[0, 1, 2], [2, 3, 0], [3, 2, 6], [6, 7, 3], [7, 6, 5], [5, 4, 7],
     [4, 5, 1], [1, 0, 4], [5, 6, 2], [2, 1, 5], [7, 4, 0], [0, 3, 7]],
    np.int32)


def _cube_clip(width=64, height=48, eye=(2.0, 3.0, 6.0)):
    """[8, 4] clip-space cube of tests/test_rasterize_pallas.py."""
    perspective = jcam.perspective(
        width / height, jnp.array([40.0]), jnp.array([0.01]),
        jnp.array([10.0]))
    look = jcam.look_at(jnp.array([list(eye)]), jnp.zeros([1, 3]),
                        jnp.array([[0.0, 1.0, 0.0]]))
    proj = jnp.matmul(perspective, look, precision=jax.lax.Precision.HIGHEST)
    return np.asarray(jcam.transform_homogeneous(
        proj, jnp.asarray(CUBE_VERTICES)[None])[0])


def _random_scene(seed=0, batch=2, vertex_count=24, tri_count=30,
                  attr_count=9, width=48, height=40):
    """tests/test_rasterize_pallas.py's random scene, as numpy arrays:
    (clip vertices [B, V, 4], triangles, attributes [B, V, A])."""
    rng = np.random.RandomState(seed)
    verts = (rng.randn(batch, vertex_count, 3) * 0.5).astype(np.float32)
    tris = rng.randint(0, vertex_count, (tri_count, 3)).astype(np.int32)
    attrs = rng.randn(batch, vertex_count, attr_count).astype(np.float32)
    eye = jnp.tile(jnp.array([[0.0, 0.0, 3.0]]), (batch, 1))
    up = jnp.tile(jnp.array([[0.0, 1.0, 0.0]]), (batch, 1))
    cam = jcam.clip_space_transforms(eye, jnp.zeros((batch, 3)), up, 40.0,
                                     0.01, 10.0, width, height)
    clip = np.asarray(jcam.transform_homogeneous(cam, jnp.asarray(verts)))
    return clip, tris, attrs


def _t(array):
    return torch.from_numpy(np.array(array))


def _plain(clip, attrs, tris, width, height, **kwargs):
    return rc.rasterize_interpolate_torch(_t(clip), _t(attrs), _t(tris),
                                          width, height, **kwargs)


def test_plain_matches_xla_spec_and_oracle_on_cube():
    width, height = 64, 48
    clip = _cube_clip(width, height)
    ids_x, bc_x, z_x = map(np.asarray, rasterize_barycentric_xla(
        clip, CUBE_TRIANGLES, width, height))
    ids, bc, _, z = _plain(clip[None], CUBE_VERTICES[None] * 0.5 + 0.5,
                           CUBE_TRIANGLES, width, height, with_z=True)
    np.testing.assert_array_equal(ids[0].numpy(), ids_x)
    np.testing.assert_allclose(bc[0].numpy(), bc_x, atol=1e-6)
    np.testing.assert_allclose(z[0].numpy(), z_x, atol=1e-6)

    # The reference kernel's snapshot, gated as tests/test_rasterize_hard.py
    # gates the JAX spec.
    with np.load(os.path.join(ORACLE_DIR,
                              "hard_kernel_cube_64x48.npz")) as ref:
        covered = ref["bc"].sum(-1) > 0.5
        np.testing.assert_allclose(bc[0].numpy(), ref["bc"], atol=1e-4)
        np.testing.assert_array_equal(ids[0].numpy()[covered],
                                      ref["ids"][covered])


@pytest.mark.parametrize("attr_count", [3, 9, 16])
def test_plain_matches_pallas_kernel(attr_count):
    width, height = 48, 40
    clip, tris, attrs = _random_scene(attr_count=attr_count, width=width,
                                      height=height)
    ids_p, bc_p, attr_p = map(np.asarray, rasterize_interpolate_pallas_batched(
        jnp.asarray(clip), jnp.asarray(attrs), jnp.asarray(tris), width,
        height, interpret=True, spatial_sort=False,
        dot_precision="highest"))
    ids, bc, attr_img = _plain(clip, attrs, tris, width, height)
    assert attr_img.shape == (2, height, width, attr_count)
    np.testing.assert_array_equal(ids.numpy(), ids_p)
    np.testing.assert_allclose(bc.numpy(), bc_p, atol=2e-5)
    np.testing.assert_allclose(attr_img.numpy(), attr_p, atol=2e-5)


def test_packing_matches_jax_packing():
    clip, tris, _ = _random_scene()
    ours = rc.pack_triangles(_t(clip), _t(tris)).numpy()
    theirs = np.stack([np.asarray(_pack_triangle_data(
        jnp.asarray(c), jnp.asarray(tris), 1)) for c in clip])
    assert ours.shape == (2, 30, rc.TRI_COLS)
    np.testing.assert_allclose(ours[..., :15], theirs[..., :15], rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(ours[..., 15], theirs[..., 15])


def test_row_strips_reassemble_full_image():
    width, height = 48, 40
    clip, tris, attrs = _random_scene(width=width, height=height)
    full = _plain(clip, attrs, tris, width, height, with_z=True)
    strip_h = height // 2
    strips = [_plain(clip, attrs, tris, width, strip_h, with_z=True,
                     row_offset=i * strip_h, full_height=height)
              for i in range(2)]
    for k, whole in enumerate(full):
        np.testing.assert_array_equal(
            torch.cat([s[k] for s in strips], dim=1).numpy(), whole.numpy())


def test_chunk_size_and_ties():
    """The chunked z-buffer gives the same answer for any chunk size, and a
    depth tie goes to the larger triangle id."""
    clip, tris, attrs = _random_scene()
    tris = np.concatenate([tris, tris[::-1]])  # every triangle twice
    outs = [_plain(clip, attrs, tris, 48, 40, triangle_chunk=c, with_z=True)
            for c in (1, 7, 64)]
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    ids, bc = outs[0][0].numpy(), outs[0][1].numpy()
    covered = bc.sum(-1) > 0
    assert covered.any()
    # Of the two copies of a triangle, the later one (ids 30..59) wins.
    assert (ids[covered] >= 30).all()


def test_uncovered_pixels_are_exactly_zero():
    clip, tris, attrs = _random_scene(width=32, height=24)
    ids, bc, attr_img, z = _plain(clip, attrs, tris, 32, 24, with_z=True)
    uncovered = bc.abs().sum(-1) == 0.0
    assert uncovered.any(), "test scene should leave background pixels"
    assert (ids[uncovered] == 0).all()
    assert (attr_img[uncovered] == 0.0).all()
    assert (z[uncovered] == 1.0).all()


def test_zero_triangle_mesh_renders_background():
    clip, _, attrs = _random_scene()
    background = torch.tensor([0.5, -1.0, 2.0] * 3)
    out = rasterize_ops.rasterize_clip_space(
        _t(clip), _t(attrs), torch.zeros(0, 3, dtype=torch.int32), 48, 40,
        background)
    assert out.shape == (2, 40, 48, 9)
    np.testing.assert_array_equal(out.numpy(),
                                  np.broadcast_to(background.numpy(),
                                                  out.shape))


def _simple_triangle_clip(w_vector):
    clip = np.array([[-0.5, -0.5, 0.8, 1.0], [0.0, 0.5, 0.3, 1.0],
                     [0.5, -0.5, 0.3, 1.0]], np.float32)
    return clip * np.reshape(np.asarray(w_vector, np.float32), [3, 1])


@pytest.mark.parametrize("w_vector,golden", [
    ((1.0, 1.0, 1.0), "Simple_Triangle.png"),
    ((0.2, 0.5, 2.0), "Perspective_Corrected_Triangle.png"),
])
def test_triangle_goldens(w_vector, golden):
    clip = _simple_triangle_clip(w_vector)[None]
    _, bc, _ = _plain(clip, np.zeros([1, 3, 1], np.float32),
                      np.array([[0, 1, 2]], np.int32), 640, 480)
    image = torch.cat([bc[0], torch.ones(480, 640, 1)], dim=2)
    test_utils.expect_image_file_and_render_are_near(
        os.path.join(GOLDEN_DIR, golden), image)


def test_unlit_cube_goldens():
    """tests/test_rasterize_hard.py's two-cube batch through `rasterize`."""
    width, height = 640, 480
    vertex_rgba = np.concatenate(
        [CUBE_VERTICES * 0.5 + 0.5, np.ones([8, 1], np.float32)], axis=1)
    perspective = jcam.perspective(
        width / height, jnp.array([40.0]), jnp.array([0.01]),
        jnp.array([10.0]))
    projections = [jnp.matmul(
        perspective, jcam.look_at(jnp.array([eye]), jnp.zeros([1, 3]),
                                  jnp.array([[0.0, 1.0, 0.0]])),
        precision=jax.lax.Precision.HIGHEST)
        for eye in ([2.0, 3.0, 6.0], [-3.0, 1.0, 6.0])]
    rendered = rasterize_ops.rasterize(
        _t(np.stack([CUBE_VERTICES] * 2)), _t(np.stack([vertex_rgba] * 2)),
        _t(CUBE_TRIANGLES), _t(np.concatenate(projections)), width, height,
        torch.zeros(4))
    for i in (0, 1):
        test_utils.expect_image_file_and_render_are_near(
            os.path.join(GOLDEN_DIR, "Unlit_Cube_%d.png" % i), rendered[i])


def test_cuda_backend_on_cpu_tensor_raises():
    clip, tris, attrs = _random_scene()
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        rasterize_ops.rasterize_clip_space(
            _t(clip), _t(attrs), _t(tris), 48, 40, torch.zeros(9),
            config=config_lib.HardRasterizerConfig(backend="cuda"))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        rc.rasterize_interpolate_cuda(_t(clip), _t(attrs), _t(tris), 48, 40)
    with pytest.raises(ValueError, match="backend must be one of"):
        config_lib.HardRasterizerConfig(backend="pallas")


def test_wrappers_validate_inputs():
    clip, tris, attrs = _random_scene()
    for fn in (rc.rasterize_interpolate_torch, rc.rasterize_interpolate_cuda):
        with pytest.raises(TypeError, match="int32"):
            fn(_t(clip), _t(attrs), _t(tris).long(), 48, 40)
        with pytest.raises(TypeError, match="float32"):
            fn(_t(clip).double(), _t(attrs), _t(tris), 48, 40)
        with pytest.raises(ValueError, match=r"\[batch, V, 4\]"):
            fn(_t(clip)[..., :3], _t(attrs), _t(tris), 48, 40)
        with pytest.raises(ValueError, match=r"\[batch, V, A\]"):
            fn(_t(clip), _t(attrs)[:, :5], _t(tris), 48, 40)
        with pytest.raises(ValueError, match="different devices"):
            fn(_t(clip), _t(attrs).to("meta"), _t(tris), 48, 40)


def test_backward_raises_not_implemented():
    clip, tris, attrs = _random_scene()
    clip_t = _t(clip).requires_grad_(True)
    _, bc, attr_img = rc.rasterize_interpolate_torch(clip_t, _t(attrs),
                                                     _t(tris), 48, 40)
    with pytest.raises(NotImplementedError, match="K2"):
        (bc.sum() + attr_img.sum()).backward()
    out = rasterize_ops.rasterize_clip_space(clip_t, _t(attrs), _t(tris), 48,
                                             40, torch.zeros(9))
    with pytest.raises(NotImplementedError, match="ported next"):
        out.sum().backward()
