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
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_mesh_renderer_tpu.models import soft_mesh_renderer as jsoft
from pytorch_mesh_renderer_tpu.ops import losses as jlosses
from pytorch_mesh_renderer_tpu_torch.models import soft_mesh_renderer
from pytorch_mesh_renderer_tpu_torch.ops import losses
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
