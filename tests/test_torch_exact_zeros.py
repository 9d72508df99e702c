"""PyTorch port: derivatives at exact zeros match the JAX package's.

`jnp.abs` has derivative +1 at 0 and `torch.abs` has 0. Where the port
takes |x| of a value that can be exactly 0, it must take JAX's one-sided
derivative, or its gradient leaves the JAX package's:

  * the soft renderer's L1 normalisation of the corner weights, at pixel
    centres that lie exactly on a triangle edge
    (`test_utils.on_edges_arrays`: an odd image width puts the centre
    column at x = 0, where the sphere's poles project). The
    vertex gradient of sum(rgba^2) must equal `jax.grad` of the JAX
    package's XLA route within 1e-4 of its max |value| (the forward agrees
    to ~1e-5, and the camera's products round in another order in each
    framework). Before the repair the port was off by 15,710 of 299 (at
    sigma 1e-4, gamma 1e-3) and 455 of 140 (at 3e-5, 1e-2);
  * `losses.image_l1_loss` where the render equals its target: JAX's
    gradient is 1 / N at every pixel.

`jnp.clip` is `lax.min(lax.max(x, lo), hi)`, whose derivative is 1/2 at
exactly lo or hi (`torch.clamp` passes 1 there). The port clips through
`math_utils.clip`, which takes JAX's derivative:

  * the soft renderer's edge offset t and light cosine, on
    `test_utils.t_bound_arrays` (t exactly 0 and 1, cosines exactly 1
    and 0). Before the repair the port passed 0 there. The silhouette's
    gradient does not depend on the rule (the squared distance's
    t-derivative is 0 at the nearest point), so K6 needs no gate;
  * the hard Phong shader's cosine and specular clips and the tone
    mapper's clip at 1.

Degenerate triangles (`test_utils.zero_edge_arrays`: one with a
zero-length edge, a collinear one and a duplicate, beside a triangle):
JAX's soft gradient is NaN at the zero-length edge's corners, on both of
its routes. The port's plain route is finite there and equals JAX's XLA
route wherever that is finite.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_mesh_renderer_tpu import config as jconfig
from pytorch_mesh_renderer_tpu.models import soft_mesh_renderer as jsoft
from pytorch_mesh_renderer_tpu.ops import losses as jlosses
from pytorch_mesh_renderer_tpu.ops import shading as jshading
from pytorch_mesh_renderer_tpu.ops import soft_rasterize as jsoft_rasterize
from pytorch_mesh_renderer_tpu_torch.models import soft_mesh_renderer
from pytorch_mesh_renderer_tpu_torch.ops import losses, shading
from pytorch_mesh_renderer_tpu_torch.ops import soft_rasterize
from pytorch_mesh_renderer_tpu_torch.ops import soft_rasterize_cuda
from pytorch_mesh_renderer_tpu_torch.utils import test_utils

WIDTH, HEIGHT = test_utils.ON_EDGES_SIZE
KEYS = ("triangles", "diffuse", "eye", "center", "up", "lights",
        "intensities")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes on one machine; the plain
    versions' large elementwise ops would otherwise take a thread per core
    in every worker at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("sigma,gamma", [(1e-4, 1e-3), (3e-5, 1e-2)])
def test_soft_gradient_at_pixel_centres_on_edges_matches_jax(sigma, gamma):
    scene = test_utils.on_edges_arrays()
    kwargs = dict(sigma_val=sigma, gamma_val=gamma,
                  blur_radius=test_utils.ON_EDGES_BLUR)

    def loss(vertices):
        images = jsoft.render(vertices, *[scene[k] for k in KEYS], WIDTH,
                              HEIGHT, **kwargs)
        return jnp.sum(images ** 2)

    want = np.asarray(jax.grad(loss)(jnp.asarray(scene["vertices"])))
    vertices = torch.from_numpy(scene["vertices"]).requires_grad_(True)
    images = soft_mesh_renderer.render(
        vertices, *[torch.from_numpy(scene[k]) for k in KEYS], WIDTH,
        HEIGHT, **kwargs)
    (images ** 2).sum().backward()
    got = vertices.grad.numpy()
    scale = float(np.abs(want).max())
    assert scale > 0.0 and np.isfinite(got).all()
    assert float(np.abs(got - want).max()) <= 1e-4 * scale


def test_image_l1_gradient_at_equal_pixels_matches_jax():
    rng = np.random.RandomState(1)
    image = rng.uniform(0.0, 1.0, (2, 7, 5, 4)).astype(np.float32)
    want = np.asarray(jax.grad(
        lambda x: jlosses.image_l1_loss(x, jax.lax.stop_gradient(x)))(
            jnp.asarray(image)))
    np.testing.assert_array_equal(want, np.float32(1.0 / image.size))
    x = torch.from_numpy(image).requires_grad_(True)
    losses.image_l1_loss(x, x.detach()).backward()
    np.testing.assert_array_equal(x.grad.numpy(), want)
    # Away from ties the loss and its gradient are jnp.abs's.
    target = rng.uniform(0.0, 1.0, image.shape).astype(np.float32)
    x.grad = None
    loss = losses.image_l1_loss(x, torch.from_numpy(target))
    loss.backward()
    np.testing.assert_allclose(
        loss.item(), float(jlosses.image_l1_loss(image, target)), rtol=1e-6)
    np.testing.assert_array_equal(
        x.grad.numpy(), np.sign(image - target) / np.float32(image.size))


T_BOUND_INPUTS = ("clip", "world", "normals", "colors", "lights",
                  "intensities")
T_BOUND_KWARGS = dict(sigma_val=test_utils.T_BOUND_SIGMA,
                      blur_radius=test_utils.T_BOUND_BLUR)
XLA = jconfig.SoftRasterizerConfig(backend="xla")


def _assert_jacobians_agree(got, want):
    """Each input's Jacobian within 1e-4 of the largest |value| of all."""
    scale = max(float(np.abs(w).max()) for w in want)
    assert scale > 0.0
    for name, g, w in zip(T_BOUND_INPUTS, got, want):
        g = np.asarray(g)
        assert g.shape == w.shape and np.isfinite(g).all(), name
        assert float(np.abs(g - w).max()) <= 1e-4 * scale, (
            name, float(np.abs(g - w).max()), scale)


@pytest.mark.parametrize("pixel", sorted(test_utils.T_BOUND_PIXELS))
def test_soft_gradient_at_clip_bounds_matches_jax_xla(pixel):
    """The Jacobian of the weighted rgba at a pixel where t is exactly 0,
    where t is exactly 1, and where a light's cosine is exactly 1 (and
    another's exactly 0), with respect to every input, against jax.jacrev
    of the XLA route."""
    arrays = test_utils.t_bound_arrays()
    size = test_utils.T_BOUND_SIZE
    row, col = test_utils.T_BOUND_PIXELS[pixel]
    weights = arrays["weights"][0, row, col]

    def jax_pixel(*inputs):
        rgba = jsoft_rasterize.rasterize_clip_space_batch(
            inputs[0], arrays["triangles"], *inputs[1:], size, size,
            gamma_val=test_utils.T_BOUND_GAMMA, config=XLA,
            **T_BOUND_KWARGS)
        return rgba[0, row, col] * weights

    def torch_pixel(*inputs):
        rgba = soft_rasterize.rasterize_clip_space_batch(
            inputs[0], torch.from_numpy(arrays["triangles"]), *inputs[1:],
            size, size, gamma_val=test_utils.T_BOUND_GAMMA,
            **T_BOUND_KWARGS)
        return rgba[0, row, col] * torch.from_numpy(weights)

    inputs = [arrays[k] for k in T_BOUND_INPUTS]
    want = [np.asarray(j) for j in jax.jacrev(
        jax_pixel, argnums=tuple(range(len(inputs))))(
            *[jnp.asarray(x) for x in inputs])]
    np.testing.assert_allclose(
        torch_pixel(*map(torch.from_numpy, inputs)).numpy(),
        np.asarray(jax_pixel(*inputs)), rtol=1e-6, atol=1e-7)
    got = torch.autograd.functional.jacobian(
        torch_pixel, tuple(map(torch.from_numpy, inputs)))
    _assert_jacobians_agree(got, want)


ZERO_EDGE_KWARGS = dict(sigma_val=test_utils.ZERO_EDGE_SIGMA,
                        blur_radius=test_utils.ZERO_EDGE_BLUR)


@pytest.mark.parametrize("output", ["render", "silhouette"])
def test_soft_gradient_beside_a_zero_length_edge_matches_jax_where_finite(
        output):
    """On test_utils.zero_edge_arrays (a triangle, one with a zero-length
    edge, a collinear one and a duplicate), the gradient of the weighted
    rgba (or alpha) with respect to every input equals jax.grad of the XLA
    route within 1e-4 of its max |value| wherever JAX's is finite. JAX's is
    NaN at the corners of the zero-length edge, vertices 1 and 3; the
    port's is finite there, and 0 at vertex 3, which only the degenerate
    triangle holds. The forwards agree within 1e-6."""
    arrays = test_utils.zero_edge_arrays()
    size = test_utils.ZERO_EDGE_SIZE
    names = T_BOUND_INPUTS if output == "render" else ("clip",)
    weights = arrays["weights"] if output == "render" else (
        arrays["weights"][..., 3])

    def jax_out(*inputs):
        if output == "render":
            return jsoft_rasterize.rasterize_clip_space_batch(
                inputs[0], arrays["triangles"], *inputs[1:], size, size,
                gamma_val=test_utils.ZERO_EDGE_GAMMA, config=XLA,
                **ZERO_EDGE_KWARGS)
        return jsoft_rasterize.rasterize_silhouette_clip_space_batch(
            inputs[0], arrays["triangles"], size, size, config=XLA,
            **ZERO_EDGE_KWARGS)

    def torch_out(*inputs):
        triangles = torch.from_numpy(arrays["triangles"])
        if output == "render":
            return soft_rasterize.rasterize_clip_space_batch(
                inputs[0], triangles, *inputs[1:], size, size,
                gamma_val=test_utils.ZERO_EDGE_GAMMA, **ZERO_EDGE_KWARGS)
        return soft_rasterize.rasterize_silhouette_clip_space_batch(
            inputs[0], triangles, size, size, **ZERO_EDGE_KWARGS)

    inputs = [arrays[k] for k in names]
    want = [np.asarray(g) for g in jax.grad(
        lambda *x: jnp.sum(jax_out(*x) * weights),
        argnums=tuple(range(len(inputs))))(*map(jnp.asarray, inputs))]
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in inputs]
    out = torch_out(*leaves)
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jax_out(*inputs)), rtol=0,
                               atol=1e-6)
    assert float(out.detach().max()) > 0.5
    (out * torch.from_numpy(weights)).sum().backward()
    scale = max(float(np.abs(w[np.isfinite(w)]).max()) for w in want)
    assert scale > 0.0
    for name, leaf, w in zip(names, leaves, want):
        got = leaf.grad.numpy()
        finite = np.isfinite(w)
        assert np.isfinite(got).all(), name
        assert float(np.abs(got - w)[finite].max()) <= 1e-4 * scale, name
        if name == "clip":
            assert sorted({int(v) for v in np.argwhere(~finite)[:, 1]}) == [
                1, 3]
            np.testing.assert_array_equal(got[0, 3], 0.0)
        else:
            assert finite.all(), name


def _old_clip(x, lo, hi):
    """The rule the port took before: gradient strictly inside only."""
    return torch.where((x > lo) & (x < hi), x,
                       torch.clamp(x, lo, hi).detach())


def test_silhouette_gradient_does_not_depend_on_the_clip_rule(monkeypatch):
    """d alpha / d clip on t_bound_arrays equals jax.jacrev of the XLA
    route, and is bit for bit the same under the rule that passes no
    gradient at t's bounds: the squared distance's t-derivative is 0 at
    the nearest point, so K6 (which has no t chain) needs no gate."""
    arrays = test_utils.t_bound_arrays()
    size = test_utils.T_BOUND_SIZE

    def alpha(clip_vertices):
        return soft_rasterize.rasterize_silhouette_clip_space_batch(
            clip_vertices, torch.from_numpy(arrays["triangles"]), size, size,
            **T_BOUND_KWARGS)

    want = np.asarray(jax.jacrev(
        lambda c: jsoft_rasterize.rasterize_silhouette_clip_space_batch(
            c, arrays["triangles"], size, size, config=XLA,
            **T_BOUND_KWARGS))(jnp.asarray(arrays["clip"])))
    clip_vertices = torch.from_numpy(arrays["clip"])
    got = torch.autograd.functional.jacobian(alpha, clip_vertices).numpy()
    scale = float(np.abs(want).max())
    assert scale > 0.0
    assert float(np.abs(got - want).max()) <= 1e-4 * scale
    monkeypatch.setattr(soft_rasterize_cuda, "clip", _old_clip)
    old = torch.autograd.functional.jacobian(alpha, clip_vertices).numpy()
    np.testing.assert_array_equal(old, got)


def _shader_inputs():
    """Two images of 2x2 pixels on the plane z = 0, normals (0, 0, 1):
    light 0 stands on pixel (0, 0)'s normal (cosine exactly 1 there),
    light 1 lies in the plane (cosine exactly 0 at every pixel of image
    0); the camera looks down at pixel (0, 0), so the specular cosine,
    L2-normalised over the pixels, is largest there."""
    rng = np.random.RandomState(3)
    xy = np.float32([[[0.0, 0.0], [0.5, 0.0]], [[0.0, 0.5], [0.5, 0.5]]])
    positions = np.concatenate([xy, np.zeros((2, 2, 1), np.float32)], -1)
    positions = np.stack([positions, positions + np.float32([0, 0, 0.3])])
    normals = np.zeros_like(positions)
    normals[..., 2] = 1.0
    lights = np.float32([[[0.0, 0.0, 2.0], [4.0, 1.0, 0.0]],
                         [[0.2, 0.1, 2.0], [3.0, 0.0, 1.0]]])
    return dict(
        normals=normals, alphas=np.ones((2, 2, 2), np.float32),
        pixel_positions=positions, light_positions=lights,
        light_intensities=rng.uniform(0.5, 1.5, (2, 2, 3)).astype(
            np.float32),
        diffuse_colors=rng.uniform(0.2, 1.0, (2, 2, 2, 3)).astype(
            np.float32),
        camera_position=np.float32([[0.0, 0.0, 5.0], [0.1, 0.2, 5.0]]),
        specular_colors=rng.uniform(0.2, 1.0, (2, 2, 2, 3)).astype(
            np.float32),
        shininess_coefficients=np.float32([2.0, 3.0]),
        weights=rng.uniform(-1.0, 1.0, (2, 2, 2, 4)).astype(np.float32))


SHADER_INPUTS = ("normals", "pixel_positions", "light_positions",
                 "light_intensities", "diffuse_colors", "specular_colors")


def test_hard_shader_gradient_at_clip_bounds_matches_jax():
    """phong_shader then tone_mapper, where the diffuse cosine is exactly 1
    and exactly 0 and the tone-mapped maximum is exactly 1: the gradient
    of the weighted image with respect to each differentiable input
    equals jax.grad's within 1e-4 of its max |value|."""
    arrays = _shader_inputs()

    def jax_loss(*inputs):
        kw = dict(zip(SHADER_INPUTS, inputs))
        image = jshading.phong_shader(
            alphas=arrays["alphas"], camera_position=arrays[
                "camera_position"], shininess_coefficients=arrays[
                    "shininess_coefficients"], **kw)
        mapped = jshading.tone_mapper(image[..., :3], 0.7)
        return (jnp.sum(image * arrays["weights"])
                + jnp.sum(mapped * arrays["weights"][..., :3]))

    def torch_loss(*inputs):
        kw = dict(zip(SHADER_INPUTS, inputs))
        image = shading.phong_shader(
            alphas=torch.from_numpy(arrays["alphas"]),
            camera_position=torch.from_numpy(arrays["camera_position"]),
            shininess_coefficients=torch.from_numpy(
                arrays["shininess_coefficients"]), **kw)
        mapped = shading.tone_mapper(image[..., :3], 0.7)
        weights = torch.from_numpy(arrays["weights"])
        return ((image * weights).sum()
                + (mapped * weights[..., :3]).sum())

    inputs = [arrays[k] for k in SHADER_INPUTS]
    want = jax.grad(jax_loss, argnums=tuple(range(len(inputs))))(
        *[jnp.asarray(x) for x in inputs])
    tensors = [torch.from_numpy(x).requires_grad_(True) for x in inputs]
    loss = torch_loss(*tensors)
    np.testing.assert_allclose(loss.item(), float(jax_loss(*inputs)),
                               rtol=1e-6)
    loss.backward()
    for name, t, w in zip(SHADER_INPUTS, tensors, want):
        w = np.asarray(w)
        scale = float(np.abs(w).max())
        assert scale > 0.0, name
        err = float(np.abs(t.grad.numpy() - w).max())
        assert err <= 1e-4 * scale, (name, err, scale)
