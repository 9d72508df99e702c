"""PyTorch port: the hard Phong renderer end to end (the slice's forward
path) vs the JAX package and the reference goldens.

Gates, with their reasons:
  * port `render` vs JAX `render` (XLA backend): the reference image gate
    (<= 0.1% of pixels off by > 0.01) over the whole image, and 1e-4 max
    abs on pixels both renders cover. Camera products and shading sums
    round in different orders in the two frameworks; a pixel whose centre
    lies within rounding of a triangle edge may flip winner, hence the
    outlier budget rather than an all-pixel bound.
  * goldens: the same gate as tests/test_mesh_renderer.py.
  * the stdlib PNG reader: equal to imageio, byte for byte.
"""

import glob
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pytorch_mesh_renderer_tpu import config as jconfig
from pytorch_mesh_renderer_tpu.models import mesh_renderer as jrenderer
from pytorch_mesh_renderer_tpu.ops import shading as jshading
from pytorch_mesh_renderer_tpu_torch import config as config_lib
from pytorch_mesh_renderer_tpu_torch.models import mesh_renderer
from pytorch_mesh_renderer_tpu_torch.ops import camera, shading
from pytorch_mesh_renderer_tpu_torch.utils import debug, test_utils
from pytorch_mesh_renderer_tpu_torch.utils.convert import scene_to_torch

from conftest import GOLDEN_DIR

CUBE_VERTICES = torch.tensor(
    [[-1, -1, 1], [-1, -1, -1], [-1, 1, -1], [-1, 1, 1], [1, -1, 1],
     [1, -1, -1], [1, 1, -1], [1, 1, 1]], dtype=torch.float32)
CUBE_NORMALS = CUBE_VERTICES / torch.linalg.norm(CUBE_VERTICES, dim=1,
                                                 keepdim=True)
CUBE_TRIANGLES = torch.tensor(
    [[0, 1, 2], [2, 3, 0], [3, 2, 6], [6, 7, 3], [7, 6, 5], [5, 4, 7],
     [4, 5, 1], [1, 0, 4], [5, 6, 2], [2, 1, 5], [7, 4, 0], [0, 3, 7]],
    dtype=torch.int32)


def _render_both(scene, size, **kwargs):
    """(port image, JAX image) of one numpy scene dict, as numpy."""
    args = ("vertices", "triangles", "normals", "diffuse", "eye", "center",
            "up", "lights", "intensities")
    ts = scene_to_torch(scene, "cpu")
    ours = mesh_renderer.render(*[ts[k] for k in args], size, size,
                                **kwargs)
    theirs = jrenderer.render(
        *[np.asarray(scene[k]) for k in args], size, size,
        config=jconfig.HardRasterizerConfig(backend="xla"), **kwargs)
    return ours.numpy(), np.asarray(theirs)


def _assert_renders_agree(ours, theirs):
    assert ours.shape == theirs.shape and np.isfinite(ours).all()
    for i in range(ours.shape[0]):
        matched, fraction = test_utils.images_are_near(theirs[i], ours[i])
        assert matched, f"image {i}: {fraction} of pixels are outliers"
    both = (ours[..., 3] > 0.5) & (theirs[..., 3] > 0.5)
    assert both.mean() > 0.05, "scene should cover part of the image"
    np.testing.assert_allclose(ours[both], theirs[both], atol=1e-4)


def test_render_matches_jax_on_teapot():
    """The headline teapot scene (bench.build_scene), cut to 64x64 batch 2."""
    import bench

    scene = bench.build_scene(batch=2, size=64)
    assert scene["mesh_name"] == "teapot" and scene["tri_count"] == 2464
    _assert_renders_agree(*_render_both(scene, 64))


def test_render_matches_jax_on_entry_scene():
    """The scene of `__graft_entry__.entry()` (rotated cubes, batch 4,
    64x64), through both packages."""
    import __graft_entry__ as ge

    scene = ge._cube_scene(batch=4, image_size=64)
    _assert_renders_agree(*_render_both(scene, scene["image_size"]))


def _two_view_cube():
    model = camera.euler_matrices(
        torch.tensor([[-20.0, 0.0, 60.0], [45.0, 60.0, 0.0]]))[:, :3, :3]
    vertices = torch.einsum("bij,vj->bvi", model, CUBE_VERTICES)
    normals = torch.einsum("bij,vj->bvi", model, CUBE_NORMALS)
    return vertices, normals


def test_renders_simple_cube_goldens():
    vertices, normals = _two_view_cube()
    renderer = mesh_renderer.MeshRenderer(640, 480)
    images = renderer(
        vertices, CUBE_TRIANGLES, normals, torch.ones_like(vertices),
        torch.tensor([0.0, 0.0, 6.0]), torch.zeros(2, 3),
        torch.tensor([0.0, 1.0, 0.0]),
        torch.tensor([[[0.0, 0.0, 6.0]]]).repeat(2, 1, 1),
        torch.ones(2, 1, 3))
    for i in range(2):
        test_utils.expect_image_file_and_render_are_near(
            os.path.join(GOLDEN_DIR, "Gray_Cube_%i.png" % i), images[i])


def test_complex_shading_goldens():
    """Specular highlights, per-vertex colors, two lights, tone mapping."""
    vertices, normals = _two_view_cube()
    diffuse = torch.tensor([[
        [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0], [1.0, 1.0, 1.0],
        [1.0, 1.0, 0.0], [1.0, 0.0, 1.0], [0.0, 1.0, 1.0],
        [0.5, 0.5, 0.5]]]).repeat(2, 1, 1)
    specular = torch.tensor([[
        [0.0, 1.0, 0.0], [0.0, 0.0, 1.0], [1.0, 1.0, 1.0], [1.0, 1.0, 0.0],
        [1.0, 0.0, 1.0], [0.0, 1.0, 1.0], [0.5, 0.5, 0.5],
        [1.0, 0.0, 0.0]]]).repeat(2, 1, 1)
    args = (vertices, CUBE_TRIANGLES, normals, diffuse,
            torch.tensor([[0.0, 0.0, 6.0], [0.0, 0.2, 18.0]]),
            torch.tensor([[0.0, 0.0, 0.0], [0.1, -0.1, 0.1]]),
            torch.tensor([[0.0, 1.0, 0.0], [0.1, 1.0, 0.15]]),
            torch.tensor([[[0.0, 0.0, 6.0], [1.0, 2.0, 6.0]],
                          [[0.0, -2.0, 4.0], [1.0, 3.0, 4.0]]]),
            torch.tensor([[[1.0, 1.0, 1.0], [1.0, 1.0, 1.0]],
                          [[2.0, 0.0, 1.0], [0.0, 2.0, 1.0]]]), 640, 480)
    kwargs = dict(specular_colors=specular, ambient_color=torch.tensor(
        [[0.0, 0.0, 0.0], [0.1, 0.1, 0.2]]), fov_y=torch.tensor([40.0, 13.3]),
        near_clip=0.1, far_clip=25.0)
    renders = mesh_renderer.render(
        *args, shininess_coefficients=6.0 * torch.ones(2, 8), **kwargs)
    # Scalar shininess broadcasting must give the same image.
    broadcast = mesh_renderer.render(*args, shininess_coefficients=6.0,
                                     **kwargs)
    np.testing.assert_allclose(renders.numpy(), broadcast.numpy(), atol=1e-5)
    tonemapped = torch.cat(
        [mesh_renderer.tone_mapper(renders[..., :3], 0.7),
         renders[..., 3:4]], dim=3)
    for i in range(2):
        test_utils.expect_image_file_and_render_are_near(
            os.path.join(GOLDEN_DIR, "Colored_Cube_%i.png" % i),
            tonemapped[i])


def test_shading_matches_jax():
    """phong_shader with every term on, and tone_mapper, vs JAX (1e-5: the
    specular term is a pow of a cross-pixel normalised dot product)."""
    rng = np.random.RandomState(7)
    b, h, w, lights = 2, 5, 6, 2

    def unit(*shape):
        x = rng.randn(*shape).astype(np.float32)
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    inputs = dict(
        normals=unit(b, h, w, 3),
        alphas=(rng.rand(b, h, w) > 0.3).astype(np.float32),
        pixel_positions=rng.randn(b, h, w, 3).astype(np.float32),
        light_positions=(rng.randn(b, lights, 3) * 3).astype(np.float32),
        light_intensities=rng.rand(b, lights, 3).astype(np.float32) * 2,
        diffuse_colors=rng.rand(b, h, w, 3).astype(np.float32),
        camera_position=rng.randn(b, 3).astype(np.float32) * 4,
        specular_colors=rng.rand(b, h, w, 3).astype(np.float32),
        shininess_coefficients=(rng.rand(b, h, w) * 8).astype(np.float32),
        ambient_color=rng.rand(b, 3).astype(np.float32) * 0.2)
    ours = shading.phong_shader(
        **{k: torch.from_numpy(v) for k, v in inputs.items()})
    theirs = jshading.phong_shader(
        **{k: jnp.asarray(v) for k, v in inputs.items()})
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(
        shading.tone_mapper(ours[..., :3], 0.7).numpy(),
        np.asarray(jshading.tone_mapper(theirs[..., :3], 0.7)), rtol=1e-5,
        atol=1e-5)


def test_render_validates_arguments():
    vertices, normals = _two_view_cube()
    args = [vertices, CUBE_TRIANGLES, normals, torch.ones_like(vertices),
            torch.tensor([0.0, 0.0, 6.0]), torch.zeros(2, 3),
            torch.tensor([0.0, 1.0, 0.0]), torch.ones(2, 1, 3),
            torch.ones(2, 1, 3), 16, 12]
    with pytest.raises(ValueError, match="without shininess"):
        mesh_renderer.render(*args, specular_colors=torch.ones_like(vertices))
    with pytest.raises(ValueError, match="without specular"):
        mesh_renderer.render(*args, shininess_coefficients=2.0)
    bad = list(args)
    bad[4] = torch.zeros(3, 3)
    with pytest.raises(ValueError, match="camera_position"):
        mesh_renderer.render(*bad)
    bad = list(args)
    bad[2] = normals.to("meta")  # tensors are never moved implicitly
    with pytest.raises(ValueError, match="move it explicitly"):
        mesh_renderer.render(*bad)


def test_debug_checks():
    with pytest.raises(ValueError, match="bad"):
        debug.check_isnan_isinf(torch.tensor([1.0, float("nan")]), "bad")
    debug.check_isnan_isinf(torch.ones(3), "fine")
    with pytest.warns(RuntimeWarning, match="NON-FINITE"):
        debug.debug_check_finite(torch.tensor([float("inf")]), "x")
    vertices, normals = _two_view_cube()
    nan_lights = torch.full((2, 1, 3), float("nan"))
    config_lib.set_debug_checks(True)
    try:
        with pytest.warns(RuntimeWarning, match="render output"):
            mesh_renderer.render(
                vertices, CUBE_TRIANGLES, normals, torch.ones_like(vertices),
                torch.tensor([0.0, 0.0, 6.0]), torch.zeros(2, 3),
                torch.tensor([0.0, 1.0, 0.0]), nan_lights,
                torch.ones(2, 1, 3), 16, 12)
    finally:
        config_lib.set_debug_checks(False)


@pytest.mark.parametrize("name", sorted(
    os.path.basename(p) for p in glob.glob(os.path.join(GOLDEN_DIR,
                                                        "*.png"))))
def test_png_reader_matches_imageio(name):
    import imageio.v2 as imageio

    path = os.path.join(GOLDEN_DIR, name)
    np.testing.assert_array_equal(test_utils.read_png(path),
                                  imageio.imread(path))
