"""PyTorch port: the hard rasterizer's analytic backward (the plain
versions of K2 and K4) and the barycentric-only entry point (K3's plain
version) vs the JAX package. The CUDA kernels themselves are held against
these plain versions on the card by tests/test_torch_cuda.py.

All inputs are made from seeds with numpy and handed to both packages.
Tolerances, with their reasons:
  * fused backward vs `jax.grad` of the JAX `rasterize` (XLA backend, and
    once the Pallas backend in interpret mode) on the random 48x40 scenes:
    1e-5 of the JAX gradient's max |value|, per tensor, the JAX suite's own
    CPU gate between its two backward backends
    (tests/test_rasterize_pallas.py:137-153). The per-pixel sums run in
    another order in each.
  * barycentric-only forward vs `rasterize_barycentric_xla` / `_pallas` on
    the 64x48 cube: ids equal, bc and z to 1e-6 (as
    tests/test_torch_rasterize.py); its gradient atol 1e-4 / rtol 1e-5, as
    tests/test_rasterize_pallas.py:70.
  * Jacobian twins of tests/test_rasterize_hard.py:149-212 through the
    port's `rasterize_barycentric`, with their reference gates: simple
    triangle atol 0.1 / rtol 0.01; internal cube at most 2% of entries off
    by more than 1% (relative to |numerical|); no vertex-z gradient, exactly.
  * row strips: their gradients sum to the full image's to 1e-6 of its max
    |value| (the same per-pixel terms, summed per strip first).
  * the zero-triangle mesh: gradients exactly zero.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_mesh_renderer_tpu import config as jconfig
from pytorch_mesh_renderer_tpu.ops import camera as jcam
from pytorch_mesh_renderer_tpu.ops import rasterize as jrasterize
from pytorch_mesh_renderer_tpu.ops.rasterize_pallas import (
    _pack_triangle_data, rasterize_barycentric_pallas)
from pytorch_mesh_renderer_tpu.ops.rasterize_xla import (
    rasterize_barycentric_xla)
from pytorch_mesh_renderer_tpu_torch import config as config_lib
from pytorch_mesh_renderer_tpu_torch.ops import rasterize as rasterize_ops
from pytorch_mesh_renderer_tpu_torch.ops import rasterize_barycentric_cuda as rb
from pytorch_mesh_renderer_tpu_torch.ops import rasterize_cuda as rc
from pytorch_mesh_renderer_tpu_torch.utils import test_utils

CUBE_VERTICES = np.array(
    [[-1, -1, 1], [-1, -1, -1], [-1, 1, -1], [-1, 1, 1], [1, -1, 1],
     [1, -1, -1], [1, 1, -1], [1, 1, 1]], np.float32)
CUBE_TRIANGLES = np.array(
    [[0, 1, 2], [2, 3, 0], [3, 2, 6], [6, 7, 3], [7, 6, 5], [5, 4, 7],
     [4, 5, 1], [1, 0, 4], [5, 6, 2], [2, 1, 5], [7, 4, 0], [0, 3, 7]],
    np.int32)
# The reference's kernel-isolation NDC cube (tests/test_rasterize_hard.py).
NDC_CUBE = np.array(
    [[-0.43889722, -0.53184521, 0.85293502, 1.0],
     [-0.37635487, 0.22206162, 0.90555805, 1.0],
     [-0.22849123, 0.76811147, 0.80993629, 1.0],
     [-0.2805393, -0.14092168, 0.71602166, 1.0],
     [0.18631913, -0.62634289, 0.88603103, 1.0],
     [0.16183566, 0.08129397, 0.93020856, 1.0],
     [0.44147962, 0.53497446, 0.85076219, 1.0],
     [0.53008741, -0.31276882, 0.77620775, 1.0]], np.float32)
SIMPLE_TRIANGLE = np.array([[-0.5, -0.5, 0.8, 1.0], [0.0, 0.5, 0.3, 1.0],
                            [0.5, -0.5, 0.3, 1.0]], np.float32)
PLAIN = config_lib.HardRasterizerConfig(backend="torch")


def _t(array):
    return torch.from_numpy(np.array(array))


def _random_scene(attr_count, seed=0, batch=2, vertex_count=24,
                  tri_count=30, width=48, height=40):
    """tests/test_rasterize_pallas.py's random scene as numpy arrays:
    (world vertices, triangles, attributes, camera matrices, background)."""
    rng = np.random.RandomState(seed)
    verts = (rng.randn(batch, vertex_count, 3) * 0.5).astype(np.float32)
    tris = rng.randint(0, vertex_count, (tri_count, 3)).astype(np.int32)
    attrs = rng.randn(batch, vertex_count, attr_count).astype(np.float32)
    eye = jnp.tile(jnp.array([[0.0, 0.0, 3.0]]), (batch, 1))
    up = jnp.tile(jnp.array([[0.0, 1.0, 0.0]]), (batch, 1))
    cam = np.asarray(jcam.clip_space_transforms(
        eye, jnp.zeros((batch, 3)), up, 40.0, 0.01, 10.0, width, height))
    bg = rng.randn(attr_count).astype(np.float32)
    return verts, tris, attrs, cam, bg


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


def _port_fused_grads(verts, tris, attrs, cam, bg, width, height, **kwargs):
    """Gradients of sum(sin(rasterize)) w.r.t. (vertices, attributes)."""
    v = _t(verts).requires_grad_(True)
    a = _t(attrs).requires_grad_(True)
    out = rasterize_ops.rasterize(v, a, _t(tris), _t(cam), width, height,
                                  _t(bg), config=PLAIN, **kwargs)
    torch.sin(out).sum().backward()
    return v.grad.numpy(), a.grad.numpy()


def _jax_fused_grads(verts, tris, attrs, cam, bg, width, height, backend):
    cfg = jconfig.HardRasterizerConfig(backend=backend)

    def loss(v, a):
        return jnp.sum(jnp.sin(jrasterize.rasterize(
            v, a, tris, cam, width, height, bg, config=cfg)))

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1))(
        jnp.asarray(verts), jnp.asarray(attrs))]


def _assert_scaled_close(ours, theirs, tol):
    scale = float(np.abs(theirs).max())
    assert scale > 0.0, "the reference gradient should not vanish"
    np.testing.assert_allclose(ours / scale, theirs / scale, rtol=0,
                               atol=tol)


@pytest.mark.parametrize("attr_count", [3, 9, 16])
def test_fused_backward_matches_jax_xla(attr_count):
    scene = _random_scene(attr_count)
    ours = _port_fused_grads(*scene, 48, 40)
    theirs = _jax_fused_grads(*scene, 48, 40, "xla")
    for o, t in zip(ours, theirs):
        assert o.shape == t.shape
        _assert_scaled_close(o, t, 1e-5)


def test_fused_backward_matches_jax_pallas_interpret():
    """The Pallas backward (K2 itself), run as the JAX suite runs it on the
    CPU: in interpret mode."""
    scene = _random_scene(9)
    ours = _port_fused_grads(*scene, 48, 40)
    theirs = _jax_fused_grads(*scene, 48, 40, "pallas")
    for o, t in zip(ours, theirs):
        _assert_scaled_close(o, t, 1e-5)


def test_inverse_abs_det_matches_jax_packing():
    """The backward's 1/|det| is column 20 of the JAX package's packing."""
    verts, tris, _, cam, _ = _random_scene(3)
    clip = np.asarray(jcam.transform_homogeneous(jnp.asarray(cam),
                                                 jnp.asarray(verts)))
    _, inv_abs_det = rc.pack_rows(_t(clip), _t(tris), True)
    theirs = np.stack([np.asarray(_pack_triangle_data(
        jnp.asarray(c), jnp.asarray(tris), 1))[:, 20] for c in clip])
    assert inv_abs_det.shape == (2, 30)
    np.testing.assert_allclose(inv_abs_det.numpy(), theirs, rtol=1e-6)


@pytest.mark.parametrize("reference", ["xla", "pallas"])
def test_barycentric_matches_jax_on_cube(reference):
    width, height = 64, 48
    clip = _cube_clip(width, height)
    jax_fn = {"xla": rasterize_barycentric_xla,
              "pallas": rasterize_barycentric_pallas}[reference]

    def loss_terms(bc):
        return (bc ** 2).sum() + (bc[..., 0] * bc[..., 1]).sum()

    ids_j, bc_j, z_j = map(np.asarray, jax_fn(clip, CUBE_TRIANGLES, width,
                                              height))
    g_j = np.asarray(jax.grad(lambda c: loss_terms(
        jax_fn(c, CUBE_TRIANGLES, width, height)[1]))(clip))

    c = _t(clip).requires_grad_(True)
    ids, bc, z = rasterize_ops.rasterize_barycentric(
        c, _t(CUBE_TRIANGLES), width, height)
    np.testing.assert_array_equal(ids.numpy(), ids_j)
    np.testing.assert_allclose(bc.detach().numpy(), bc_j, atol=1e-6)
    np.testing.assert_allclose(z.numpy(), z_j, atol=1e-6)
    assert not z.requires_grad and ids.dtype == torch.int32
    loss_terms(bc).backward()
    np.testing.assert_allclose(c.grad.numpy(), g_j, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(c.grad.numpy()[:, 2], 0.0)


def test_simple_triangle_gradient():
    """Twin of tests/test_rasterize_hard.py::test_simple_triangle_gradient:
    one interior pixel's barycentrics, eps 4e-2 central differences."""
    triangles = _t([[0, 1, 2]]).int()

    def pixel_bc(clip):
        _, bc, _ = rasterize_ops.rasterize_barycentric(clip, triangles, 640,
                                                       480)
        return bc[245, 325, :]

    analytical = test_utils.get_analytical_jacobian(pixel_bc,
                                                    _t(SIMPLE_TRIANGLE))
    numerical = test_utils.get_numerical_jacobian(pixel_bc, SIMPLE_TRIANGLE,
                                                  eps=4e-2)
    assert analytical.shape == numerical.shape == (12, 3)
    np.testing.assert_allclose(analytical, numerical, atol=0.1, rtol=0.01)


def test_internal_render_gradient():
    """Twin of tests/test_rasterize_hard.py::test_internal_render_gradient:
    the Jacobian of every pixel's barycentrics on the NDC cube at 28x21."""
    triangles = _t(CUBE_TRIANGLES)

    def get_bc(clip):
        return rasterize_ops.rasterize_barycentric(clip, triangles, 28, 21)[1]

    analytical = test_utils.get_analytical_jacobian(get_bc, _t(NDC_CUBE))
    numerical = test_utils.get_numerical_jacobian(get_bc, NDC_CUBE, eps=4e-2)
    assert np.abs(analytical).sum() > 0.0
    matched, message = test_utils.check_jacobians_are_nearly_equal(
        analytical, numerical, 0.01, 0.02)
    assert matched, message


def test_no_gradient_to_vertex_z():
    clip = _t(SIMPLE_TRIANGLE).requires_grad_(True)
    _, bc, _ = rasterize_ops.rasterize_barycentric(clip, _t([[0, 1, 2]]).int(),
                                                   32, 32)
    (bc ** 2).sum().backward()
    grad = clip.grad.numpy()
    np.testing.assert_array_equal(grad[:, 2], 0.0)
    assert np.abs(grad[:, [0, 1, 3]]).sum() > 0.0


def _strip_gradients(fused, row_offset, strip_height, full_height):
    """Clip (and attribute) gradients of one strip's rows, or of the whole
    image when strip_height == full_height, under a seeded cotangent."""
    verts, tris, attrs, cam, _ = _random_scene(9)
    clip = _t(np.asarray(jcam.transform_homogeneous(
        jnp.asarray(cam), jnp.asarray(verts)))).requires_grad_(True)
    a = _t(attrs).requires_grad_(True)
    rng = np.random.RandomState(3)
    g_bc = _t(rng.randn(2, full_height, 48, 3).astype(np.float32))
    g_attr = _t(rng.randn(2, full_height, 48, 9).astype(np.float32))
    rows = slice(row_offset, row_offset + strip_height)
    kwargs = dict(row_offset=row_offset, full_height=full_height)
    if fused:
        _, bc, attr_img = rc.rasterize_interpolate_torch(
            clip, a, _t(tris), 48, strip_height, **kwargs)
        ((bc * g_bc[:, rows]).sum()
         + (attr_img * g_attr[:, rows]).sum()).backward()
        return clip.grad.numpy(), a.grad.numpy()
    _, bc, _ = rb.rasterize_barycentric_torch(clip, _t(tris), 48,
                                              strip_height, **kwargs)
    (bc * g_bc[:, rows]).sum().backward()
    return (clip.grad.numpy(),)


@pytest.mark.parametrize("fused", [True, False])
def test_row_strip_gradients_sum_to_full_image(fused):
    full = _strip_gradients(fused, 0, 40, 40)
    strips = [_strip_gradients(fused, 20 * i, 20, 40) for i in range(2)]
    for k, whole in enumerate(full):
        assert np.abs(whole).max() > 0.0
        _assert_scaled_close(strips[0][k] + strips[1][k], whole, 1e-6)


def test_zero_triangle_mesh_backward_is_zero():
    verts, _, attrs, cam, bg = _random_scene(9)
    v = _t(verts).requires_grad_(True)
    a = _t(attrs).requires_grad_(True)
    empty = torch.zeros(0, 3, dtype=torch.int32)
    out = rasterize_ops.rasterize(v, a, empty, _t(cam), 48, 40, _t(bg))
    torch.sin(out).sum().backward()
    assert torch.equal(v.grad, torch.zeros_like(v))
    assert torch.equal(a.grad, torch.zeros_like(a))

    clip = _t(NDC_CUBE).requires_grad_(True)
    _, bc, _ = rasterize_ops.rasterize_barycentric(clip, empty, 28, 21)
    bc.sum().backward()
    assert torch.equal(clip.grad, torch.zeros_like(clip))


def test_ids_and_z_take_no_cotangent():
    """Only bc and the attributes carry a cotangent: a loss on the
    attributes alone gives the same gradient as one that also reads the
    (non-differentiable) ids and z."""
    verts, tris, attrs, cam, _ = _random_scene(3)
    clip = np.asarray(jcam.transform_homogeneous(jnp.asarray(cam),
                                                 jnp.asarray(verts)))
    grads = []
    for with_z in (False, True):
        c = _t(clip).requires_grad_(True)
        outs = rc.rasterize_interpolate_torch(c, _t(attrs), _t(tris), 48, 40,
                                              with_z=with_z)
        assert not outs[0].requires_grad
        loss = outs[2].sum()
        if with_z:
            assert not outs[3].requires_grad
            loss = loss + outs[3].sum() + outs[0].sum()
        loss.backward()
        grads.append(c.grad)
    assert torch.equal(grads[0], grads[1])
    assert float(grads[0].abs().max()) > 0.0


def test_kernel_backward_on_cpu_tensors_raises():
    """There is no fallback: the kernels' backward entry points refuse CPU
    tensors instead of running the plain version."""
    verts, tris, attrs, cam, _ = _random_scene(3)
    clip = _t(np.asarray(jcam.transform_homogeneous(jnp.asarray(cam),
                                                    jnp.asarray(verts))))
    table, inv = rc.pack_rows(clip, _t(tris), True)
    corner = rc.pack_corner_attributes(_t(attrs), _t(tris))
    ids, bc, _ = rc.rasterize_interpolate_torch(clip, _t(attrs), _t(tris), 48,
                                                40)
    g_bc, g_attr = torch.ones_like(bc), torch.ones(2, 40, 48, 3)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        rc.rasterize_interpolate_backward_cuda(ids, bc, g_bc, g_attr, table,
                                               inv, corner, _t(tris), 24)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        rb.rasterize_barycentric_backward_cuda(ids, bc, g_bc, table, inv,
                                               _t(tris), 24)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        rb.rasterize_barycentric_cuda(clip, _t(tris), 48, 40)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        rasterize_ops.rasterize_barycentric(
            clip[0], _t(tris), 48, 40,
            config=config_lib.HardRasterizerConfig(backend="cuda"))
