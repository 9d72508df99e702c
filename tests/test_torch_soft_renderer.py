"""PyTorch port: the soft renderer end to end (`render`,
`render_silhouette`), the losses and the multi-view silhouette fit, vs the
JAX package and the vendored reference oracles.

All inputs are made from seeds with numpy (or read from the repository's
assets) and handed to both packages; the port runs on the CPU, so every
call takes the plain versions of K5-K8.
Tolerances, with their reasons:
  * `render` and `render_silhouette` vs the JAX models (XLA backend) on the
    cube and on the teapot (32x32, batch 2), and `render` of the cube with
    65 lights (16x16), at the renderer's defaults
    (sigma 1e-5, gamma 1e-4): atol 1e-4 / rtol 1e-3 on every channel. The
    camera products round in another order in each framework: at sigma
    1e-5 a 1e-7 shift of a projected vertex moves an edge pixel's coverage
    logit by ~1e-3, and at gamma 1e-4 a 1e-8 shift of a depth moves its
    softmax weight by 1e-4 relative.
  * silhouette alpha equals the full render's alpha bit for bit.
  * the cube's d mean(rgba^2) / d vertices vs
    `jax.grad`, with one light and with 65: 1e-3 of the JAX gradient's max
    |value|. At sigma 1e-5 the
    coverage derivative is ~1e5 at edge pixels, so the camera's rounding
    differences (above) reach the gradient ten times more than at the
    kernel-level scenes of tests/test_torch_soft_rasterize.py (1e-4).
  * the losses vs JAX `ops/losses.py`: rtol 1e-6 (the same f32 sums);
    the reference oracle `losses_example7b_cube`: its JAX twin's gates
    (rtol 1e-5 Laplacian, 1e-6 edge).
  * the cow fit, three Adam steps at 32x32 (sphere resolution 8) vs the
    same steps in JAX with `optax.adam`: losses rtol 1e-4 per step, the
    offsets within 1e-5 (Adam's first steps move every offset by about
    lr = 1e-2 whatever the gradient's size).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_mesh_renderer_tpu.models import shapes as jshapes
from pytorch_mesh_renderer_tpu.models import soft_mesh_renderer as jsoft
from pytorch_mesh_renderer_tpu.ops import losses as jlosses
from pytorch_mesh_renderer_tpu.ops import mesh as jmesh
from pytorch_mesh_renderer_tpu_torch import config as config_lib
from pytorch_mesh_renderer_tpu_torch.models import soft_mesh_renderer
from pytorch_mesh_renderer_tpu_torch.ops import losses, mesh
from pytorch_mesh_renderer_tpu_torch.utils import test_utils
from pytorch_mesh_renderer_tpu_torch.utils.convert import scene_to_torch

from conftest import ASSETS_DIR, ORACLE_DIR

RENDER_KEYS = ("vertices", "triangles", "diffuse", "eye", "center", "up",
               "lights", "intensities")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes on one machine; the plain
    soft versions' large elementwise ops would otherwise take a thread per
    core in every worker at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _cube_scene():
    v, t, _ = jshapes.cube(2.0)
    v = np.asarray(v)
    rng = np.random.RandomState(3)
    return dict(vertices=v[None], triangles=np.asarray(t), normals=v[None],
                diffuse=rng.uniform(0.2, 1.0, (1, 8, 3)),
                eye=[[2.0, 3.0, 6.0]], center=[[0.0, 0.0, 0.0]],
                up=[[0.0, 1.0, 0.0]], lights=[[[0.0, 2.0, 6.0]]],
                intensities=[[1.0]])


def _teapot_scene(batch=2):
    """bench.py's soft scene (CCW teapot, two lights, scalar intensities)."""
    import bench

    scene = bench.build_scene(batch, 32)
    out = {k: np.asarray(scene[k]) for k in
           ("vertices", "normals", "diffuse", "eye", "center", "up",
            "lights")}
    out["triangles"] = np.asarray(scene["triangles"])[:, ::-1].copy()
    out["intensities"] = np.asarray(scene["intensities"])[..., 0]
    return out


def _render_both(scene, size, silhouette=False, **kwargs):
    ts = scene_to_torch(scene, "cpu")
    if silhouette:
        keys = ("vertices", "triangles", "eye", "center", "up")
        ours = soft_mesh_renderer.render_silhouette(
            *[ts[k] for k in keys], size, size, **kwargs)
        theirs = jsoft.render_silhouette(
            *[np.asarray(scene[k], np.float32 if k != "triangles"
                         else np.int32) for k in keys], size, size, **kwargs)
    else:
        ours = soft_mesh_renderer.render(*[ts[k] for k in RENDER_KEYS],
                                         size, size, **kwargs)
        theirs = jsoft.render(
            *[np.asarray(scene[k], np.float32 if k != "triangles"
                         else np.int32) for k in RENDER_KEYS], size, size,
            **kwargs)
    return ours, np.asarray(theirs)


@pytest.mark.parametrize("name", ["cube", "teapot"])
def test_render_and_silhouette_match_jax(name):
    scene = _cube_scene() if name == "cube" else _teapot_scene()
    ours, theirs = _render_both(scene, 32)
    assert ours.shape == theirs.shape and bool(torch.isfinite(ours).all())
    assert 0.05 < float((ours[..., 3] > 0.5).float().mean()) < 0.95
    np.testing.assert_allclose(ours.numpy(), theirs, atol=1e-4, rtol=1e-3)
    sil, sil_jax = _render_both(scene, 32, silhouette=True)
    assert torch.equal(sil, ours[..., 3])
    np.testing.assert_allclose(sil.numpy(), sil_jax, atol=1e-4)


def test_vertex_gradient_matches_jax():
    """d mean(rgba^2) / d vertices on the cube: the rgb (softmax, shading)
    and alpha (silhouette) chains together."""
    scene = _cube_scene()
    ts = scene_to_torch(scene, "cpu")
    v = ts["vertices"].clone().requires_grad_(True)
    images = soft_mesh_renderer.render(v, *[ts[k] for k in RENDER_KEYS[1:]],
                                       32, 32)
    torch.mean(images ** 2).backward()
    rest = [np.asarray(scene[k], np.float32 if k != "triangles"
                       else np.int32) for k in RENDER_KEYS[1:]]

    def loss(vertices):
        out = jsoft.render(vertices, *rest, 32, 32)
        return jnp.mean(out ** 2)

    want = np.asarray(jax.grad(loss)(jnp.asarray(scene["vertices"],
                                                 jnp.float32)))
    scale = float(np.abs(want).max())
    assert scale > 0.0 and bool(torch.isfinite(v.grad).all())
    assert float(np.abs(v.grad.numpy() - want).max()) <= 1e-3 * scale


def test_render_with_65_lights_and_its_gradient_match_jax():
    """65 lights, past the 64 the soft kernels once held in shared memory:
    the render and d mean(rgba^2) / d vertices of the cube at 16x16 match
    the JAX package's, within the gates above."""
    scene = _cube_scene()
    rng = np.random.RandomState(65)
    scene["lights"] = (rng.randn(1, 65, 3) * 3.0 + [0.0, 2.0, 6.0]).tolist()
    scene["intensities"] = rng.uniform(0.005, 0.03, (1, 65)).tolist()
    ours, theirs = _render_both(scene, 16)
    assert ours.shape == (1, 16, 16, 4) and bool(torch.isfinite(ours).all())
    assert float(ours[..., :3].max()) > 0.1
    np.testing.assert_allclose(ours.numpy(), theirs, atol=1e-4, rtol=1e-3)

    ts = scene_to_torch(scene, "cpu")
    v = ts["vertices"].clone().requires_grad_(True)
    images = soft_mesh_renderer.render(v, *[ts[k] for k in RENDER_KEYS[1:]],
                                       16, 16)
    torch.mean(images ** 2).backward()
    rest = [np.asarray(scene[k], np.float32 if k != "triangles"
                       else np.int32) for k in RENDER_KEYS[1:]]

    def loss(vertices):
        return jnp.mean(jsoft.render(vertices, *rest, 16, 16) ** 2)

    want = np.asarray(jax.grad(loss)(jnp.asarray(scene["vertices"],
                                                 jnp.float32)))
    scale = float(np.abs(want).max())
    assert scale > 0.0 and bool(torch.isfinite(v.grad).all())
    assert float(np.abs(v.grad.numpy() - want).max()) <= 1e-3 * scale


def test_silhouette_backward_matches_full_render_backward():
    """render_silhouette's vertex gradient is the full render's alpha
    gradient (K6's chain is K8's alpha chain), within 1e-5 of its scale."""
    ts = scene_to_torch(_cube_scene(), "cpu")
    grads = []
    for silhouette in (True, False):
        v = ts["vertices"].clone().requires_grad_(True)
        if silhouette:
            alpha = soft_mesh_renderer.render_silhouette(
                v, ts["triangles"], ts["eye"], ts["center"], ts["up"], 32,
                32)
        else:
            alpha = soft_mesh_renderer.render(
                v, *[ts[k] for k in RENDER_KEYS[1:]], 32, 32)[..., 3]
        torch.mean(alpha ** 2).backward()
        grads.append(v.grad)
    scale = float(grads[1].abs().max())
    assert scale > 0.0
    assert float((grads[0] - grads[1]).abs().max()) <= 1e-5 * scale


def test_render_validation_and_device_rules():
    ts = scene_to_torch(_cube_scene(), "cpu")
    args = [ts[k] for k in RENDER_KEYS]
    with pytest.raises(ValueError, match="Vertices"):
        soft_mesh_renderer.render(args[0][0], *args[1:], 16, 16)
    with pytest.raises(ValueError, match="light_intensities"):
        soft_mesh_renderer.render(*args[:7], args[7][..., None], 16, 16)
    with pytest.raises(ValueError, match="camera_position"):
        soft_mesh_renderer.render(args[0], args[1], args[2],
                                  torch.zeros(2, 3), *args[4:], 16, 16)
    with pytest.raises(ValueError, match="backend='cuda'"):
        soft_mesh_renderer.render_silhouette(
            *[ts[k] for k in ("vertices", "triangles", "eye", "center",
                              "up")], 16, 16,
            config=config_lib.SoftRasterizerConfig(backend="cuda"))
    # Python sequences are materialised on the vertices' device.
    out = soft_mesh_renderer.render(
        args[0], args[1].numpy(), args[2], [2.0, 3.0, 6.0], [0.0, 0.0, 0.0],
        [0.0, 1.0, 0.0], args[6], args[7], 16, 16)
    assert out.shape == (1, 16, 16, 4) and out.device == args[0].device


def test_debug_checks_warn_on_non_finite_output():
    ts = scene_to_torch(_cube_scene(), "cpu")
    config_lib.set_debug_checks(True)
    try:
        with pytest.warns(RuntimeWarning, match="render_silhouette output"):
            soft_mesh_renderer.render_silhouette(
                ts["vertices"], ts["triangles"], ts["eye"], ts["center"],
                ts["up"], 16, 16, sigma_val=float("nan"))
    finally:
        config_lib.set_debug_checks(False)


def test_losses_match_jax_and_reference_oracle():
    v, t, _ = jshapes.cube(2.0)
    v, t = np.asarray(v), np.asarray(t)
    edges = mesh.compute_edges_list(torch.tensor(t))
    np.testing.assert_array_equal(edges.numpy(),
                                  np.asarray(jmesh.compute_edges_list(t)))
    rng = np.random.RandomState(4)
    noisy = (v + rng.randn(*v.shape) * 0.1).astype(np.float32)
    for verts in (v, noisy):
        tv = torch.from_numpy(verts)
        for ours, theirs in (
                (losses.edge_loss(tv, edges),
                 jlosses.edge_loss(verts, edges.numpy())),
                (losses.laplacian_smoothing_loss(tv, edges),
                 jlosses.laplacian_smoothing_loss(verts, edges.numpy()))):
            np.testing.assert_allclose(float(ours), float(theirs), rtol=1e-6)
    with np.load(os.path.join(ORACLE_DIR, "losses_example7b_cube.npz")) as r:
        tv = torch.from_numpy(v)
        np.testing.assert_allclose(
            float(losses.laplacian_smoothing_loss(tv, edges)),
            float(r["lap"]), rtol=1e-5)
        np.testing.assert_allclose(float(losses.edge_loss(tv, edges)),
                                   float(r["edge"]), rtol=1e-6)
    a = rng.uniform(0.0, 1.0, (2, 8, 8)).astype(np.float32)
    b = rng.uniform(0.0, 1.0, (2, 8, 8)).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for ours, theirs in (
            (losses.image_l1_loss(ta, tb), jlosses.image_l1_loss(a, b)),
            (losses.silhouette_mse_loss(ta, tb),
             jlosses.silhouette_mse_loss(a, b)),
            (losses.silhouette_iou(ta, tb), jlosses.silhouette_iou(a, b))):
        np.testing.assert_allclose(float(ours), float(theirs), rtol=1e-6)
    ones = torch.ones(4, 4)
    assert float(losses.silhouette_iou(ones, ones)) == pytest.approx(1.0)
    assert float(losses.silhouette_iou(torch.zeros(4, 4), ones)) == 0.0


def _cow_targets(size):
    """The four vendored cow silhouettes, nearest-downsampled as
    examples/fit_shape_multiview.py:load_targets does."""
    out = []
    for i in range(1, 5):
        img = test_utils.read_png(os.path.join(
            ASSETS_DIR, "example_targets", f"example7b_target{i}.png"))
        alpha = img[..., 3].astype(np.float32) / 255.0
        ys = np.arange(size) * alpha.shape[0] // size
        xs = np.arange(size) * alpha.shape[1] // size
        out.append(alpha[ys][:, xs])
    return np.stack(out)


def test_cow_fit_steps_match_jax_adam():
    """Three steps of the flagship fit (examples/fit_shape_multiview.py) at
    32x32 and sphere resolution 8: torch.optim.Adam vs optax.adam."""
    import optax

    size, steps, sigma = 32, 3, 3e-5
    verts0, tris, _ = jshapes.sphere(0.5, resolution=8)
    verts0, tris = np.asarray(verts0), np.asarray(tris)
    edges = np.asarray(jmesh.compute_edges_list(tris))
    phis = np.linspace(0.0, 2 * np.pi, 4, endpoint=False)
    eyes = np.stack([2.0 * np.sin(phis), 0.3 * np.ones(4),
                     2.0 * np.cos(phis)], -1).astype(np.float32)
    centers, ups = np.zeros([4, 3], np.float32), np.tile(
        np.float32([[0.0, 1.0, 0.0]]), [4, 1])
    targets = _cow_targets(size)

    def jloss(params):
        vertices = verts0 + params["offsets"]
        alpha = jsoft.render_silhouette(
            jnp.tile(vertices[None], [4, 1, 1]), tris, eyes, centers, ups,
            size, size, sigma_val=sigma)
        return (jlosses.silhouette_mse_loss(alpha, targets)
                + 0.3 * jlosses.edge_loss(vertices, edges)
                + 0.1 * jlosses.laplacian_smoothing_loss(vertices, edges))

    opt = optax.adam(1e-2)
    params = {"offsets": jnp.zeros_like(verts0)}
    state = opt.init(params)
    step = jax.jit(jax.value_and_grad(jloss))
    jax_losses = []
    for _ in range(steps):
        loss, grads = step(params)
        updates, state = opt.update(grads, state)
        params = optax.apply_updates(params, updates)
        jax_losses.append(float(loss))

    v0 = torch.from_numpy(verts0)
    t_tris, t_edges = torch.from_numpy(tris), torch.from_numpy(edges)
    cams = [torch.from_numpy(a) for a in (eyes, centers, ups)]
    t_targets = torch.from_numpy(targets)
    offsets = torch.zeros_like(v0, requires_grad=True)
    adam = torch.optim.Adam([offsets], lr=1e-2)
    port_losses = []
    for _ in range(steps):
        adam.zero_grad()
        vertices = v0 + offsets
        alpha = soft_mesh_renderer.render_silhouette(
            vertices[None].expand(4, -1, -1), t_tris, *cams, size, size,
            sigma_val=sigma)
        loss = (losses.silhouette_mse_loss(alpha, t_targets)
                + 0.3 * losses.edge_loss(vertices, t_edges)
                + 0.1 * losses.laplacian_smoothing_loss(vertices, t_edges))
        loss.backward()
        adam.step()
        port_losses.append(loss.item())
    np.testing.assert_allclose(port_losses, jax_losses, rtol=1e-4)
    assert port_losses[-1] < port_losses[0]
    np.testing.assert_allclose(offsets.detach().numpy(),
                               np.asarray(params["offsets"]), atol=1e-5)
