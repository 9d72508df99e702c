"""PyTorch port on the card: the CUDA kernels vs their plain PyTorch
versions.

Every test here is marked `cuda` and skips without an NVIDIA GPU. The
machine with the card has no JAX, and tests/conftest.py imports it, so run
them there without the conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The forward kernels (K1, K3) and their plain versions run the same fp32
operations in the same order (the kernels are built with --fmad=false):
ids must be equal and bc, z and attributes agree to 1e-6. The backward
kernels (K2, K4) sum per-pixel terms into per-triangle rows with atomic
adds in an order that changes from run to run: their gradients agree with
the plain versions' to 1e-5 of the plain tensor's max |value|, per tensor,
the JAX suite's CPU gate between its two backward backends.

The soft kernels (K5-K8) against their plain versions: forward rgb within
2e-5 abs and 1e-4 rel (the JAX suite's Pallas-vs-XLA gate) and alpha within
1e-6 (the kernels aggregate the softmax triangle by triangle, the plain
version chunk by chunk; the silhouette product runs in the same order in
both); K5's alpha equals K7's bit for bit (shared device code); the
backward kernels (K6, K8) within `test_utils.SOFT_GRAD_RTOL` of each plain
tensor's max |value|, the table gradient's per group of columns that come
from one input of the packing: clip, world, normals, colours
(`test_utils.SOFT_DTABLE_GROUPS`; atomic adds again). d/dgamma and the z columns are compared only where the triangles
differ in depth: on the two-triangle scene every triangle lies at NDC z
0.25, so the render does not depend on gamma at all and both routes return
f32 cancellation noise (per-pixel terms W (shade - rgb) z / gamma^2 of ~4e2
that cancel). The soft scenes and gates are `utils/test_utils`'s, shared
with chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from pytorch_mesh_renderer_tpu_torch import config as config_lib
from pytorch_mesh_renderer_tpu_torch.models import (mesh_renderer, shapes,
                                                    soft_mesh_renderer)
from pytorch_mesh_renderer_tpu_torch.ops import camera
from pytorch_mesh_renderer_tpu_torch.ops import rasterize as rasterize_ops
from pytorch_mesh_renderer_tpu_torch.ops import rasterize_barycentric_cuda as rb
from pytorch_mesh_renderer_tpu_torch.ops import rasterize_cuda as rc
from pytorch_mesh_renderer_tpu_torch.ops import soft_rasterize_cuda as sc
from pytorch_mesh_renderer_tpu_torch.utils import test_utils

pytestmark = pytest.mark.cuda

CUBE_VERTICES = [[-1, -1, 1], [-1, -1, -1], [-1, 1, -1], [-1, 1, 1],
                 [1, -1, 1], [1, -1, -1], [1, 1, -1], [1, 1, 1]]
CUBE_TRIANGLES = [[0, 1, 2], [2, 3, 0], [3, 2, 6], [6, 7, 3], [7, 6, 5],
                  [5, 4, 7], [4, 5, 1], [1, 0, 4], [5, 6, 2], [2, 1, 5],
                  [7, 4, 0], [0, 3, 7]]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _snapped_scene(dev, batch=2, vertex_count=300, tri_count=2000,
                   width=80, height=56):
    """Many overlapping triangles whose vertices project exactly onto pixel
    centres, so edges run through pixel centres (edge value 0) and along
    the kernel's block boundaries: the hardest case for the block cull."""
    rng = np.random.RandomState(1)
    cols = rng.randint(0, width, (batch, vertex_count))
    rows = rng.randint(0, height, (batch, vertex_count))
    ndc = np.stack([(cols + 0.5) * np.float32(2.0 / width) - 1.0,
                    (rows + 0.5) * np.float32(2.0 / height) - 1.0,
                    rng.uniform(-0.9, 0.9, (batch, vertex_count))], -1)
    # Small triangles: each picks three vertices that are close in index.
    first = rng.randint(0, vertex_count - 8, tri_count)
    tris = np.stack([first, first + rng.randint(1, 4, tri_count),
                     first + rng.randint(4, 8, tri_count)], -1)
    clip = np.concatenate([ndc, np.ones((batch, vertex_count, 1))], -1)
    attrs = rng.randn(batch, vertex_count, 5)
    return (torch.tensor(clip, dtype=torch.float32, device=dev),
            torch.tensor(attrs, dtype=torch.float32, device=dev),
            torch.tensor(tris, dtype=torch.int32, device=dev), width, height)


def _scene(name, dev):
    """(clip [B, V, 4], attributes [B, V, A], triangles, width, height)."""
    f32 = dict(dtype=torch.float32, device=dev)
    if name == "snapped":
        return _snapped_scene(dev)
    if name == "cube":
        batch, verts = 1, torch.tensor([CUBE_VERTICES], **f32)
        tris = torch.tensor(CUBE_TRIANGLES, dtype=torch.int32, device=dev)
        attrs, eye, (width, height) = verts * 0.5 + 0.5, [2.0, 3.0, 6.0], (
            64, 48)
    else:  # random<A>: tests/test_rasterize_pallas.py's random scene
        batch, width, height = 2, 48, 40
        rng = np.random.RandomState(0)
        verts = torch.tensor(rng.randn(batch, 24, 3) * 0.5, **f32)
        tris = torch.tensor(rng.randint(0, 24, (30, 3)), dtype=torch.int32,
                            device=dev)
        attrs = torch.tensor(rng.randn(batch, 24, int(name[6:])), **f32)
        eye = [0.0, 0.0, 3.0]
    cam = camera.clip_space_transforms(
        torch.tensor([eye] * batch, **f32), torch.zeros(batch, 3, **f32),
        torch.tensor([[0.0, 1.0, 0.0]] * batch, **f32),
        torch.full((batch,), 40.0, **f32), torch.full((batch,), 0.01, **f32),
        torch.full((batch,), 10.0, **f32), width, height)
    return (camera.transform_homogeneous(cam, verts), attrs, tris, width,
            height)


def _assert_same(kernel, plain):
    torch.cuda.synchronize()
    assert len(kernel) == len(plain)
    assert torch.equal(kernel[0], plain[0])
    for k, p in zip(kernel[1:], plain[1:]):
        assert k.shape == p.shape and k.dtype == p.dtype
        if k.numel():
            assert float((k - p).abs().max()) <= 1e-6


@pytest.mark.parametrize("scene", ["cube", "random3", "random9", "random16",
                                   "snapped"])
@pytest.mark.parametrize("with_z", [True, False])
def test_kernel_matches_plain_version(dev, scene, with_z):
    clip, attrs, tris, width, height = _scene(scene, dev)
    before = rc.LAUNCHES
    kernel = rc.rasterize_interpolate_cuda(clip, attrs, tris, width, height,
                                           with_z=with_z)
    assert rc.LAUNCHES == before + 1
    plain = rc.rasterize_interpolate_torch(clip, attrs, tris, width, height,
                                           with_z=with_z)
    _assert_same(kernel, plain)


def test_row_strips_and_empty_mesh(dev):
    clip, attrs, tris, _, _ = _scene("random9", dev)
    full = rc.rasterize_interpolate_cuda(clip, attrs, tris, 48, 40,
                                         with_z=True)
    for i in range(2):
        strip = rc.rasterize_interpolate_cuda(
            clip, attrs, tris, 48, 20, row_offset=20 * i, full_height=40,
            with_z=True)
        for s, f in zip(strip, full):
            assert torch.equal(s, f[:, 20 * i:20 * (i + 1)])
    empty = tris[:0]
    _assert_same(
        rc.rasterize_interpolate_cuda(clip, attrs, empty, 48, 40, with_z=True),
        rc.rasterize_interpolate_torch(clip, attrs, empty, 48, 40,
                                       with_z=True))


def test_render_backward_launches_kernel_once(dev):
    _, _, tris, width, height = _scene("cube", dev)
    vertices = torch.tensor([CUBE_VERTICES], dtype=torch.float32,
                            device=dev)
    args = (tris.flip(1).contiguous(), vertices, torch.ones_like(vertices),
            torch.tensor([2.0, 3.0, 6.0], device=dev),
            torch.zeros(3, device=dev),
            torch.tensor([0.0, 1.0, 0.0], device=dev),
            torch.tensor([[[0.0, 0.0, 6.0]]], device=dev),
            torch.ones(1, 1, 3, device=dev), width, height)
    grads = []
    for config in (None, config_lib.HardRasterizerConfig(backend="torch")):
        v = vertices.clone().requires_grad_(True)
        images = mesh_renderer.render(v, *args, config=config)
        before = (rc.LAUNCHES, rc.BWD_LAUNCHES)
        (images[..., :3] ** 2).mean().backward()
        torch.cuda.synchronize()
        grads.append(v.grad)
        if config is None:  # 'auto' on a CUDA tensor: the kernels
            assert (rc.LAUNCHES, rc.BWD_LAUNCHES) == (before[0],
                                                      before[1] + 1)
    scale = float(grads[1].abs().max())
    assert scale > 0.0 and bool(torch.isfinite(grads[0]).all())
    assert float((grads[0] - grads[1]).abs().max()) <= 1e-5 * scale


def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    clip, attrs, tris, width, height = _scene("cube", dev)
    with pytest.raises(TypeError):
        rc.rasterize_interpolate_cuda(clip.double(), attrs, tris, width,
                                      height)
    with pytest.raises(ValueError, match="different devices"):
        rc.rasterize_interpolate_cuda(clip, attrs.cpu(), tris, width, height)
    with pytest.raises(ValueError, match="CUDA"):
        rc.launch_fused_fwd(rc.pack_rows(clip, tris, False)[0].cpu(),
                            rc.pack_corner_attributes(attrs, tris).cpu(),
                            width, height, 0, height, False)


def _assert_grads_close(kernel, plain, rtol=1e-5):
    """Per tensor: finite, and within rtol of the plain tensor's max
    |value|."""
    torch.cuda.synchronize()
    assert len(kernel) == len(plain)
    for k, p in zip(kernel, plain):
        assert k.shape == p.shape and k.dtype == p.dtype
        assert bool(torch.isfinite(k).all())
        if p.numel():
            scale = float(p.abs().max())
            assert float((k - p).abs().max()) <= rtol * scale


def _cotangents(ids, n_attr, seed=5):
    rng = np.random.RandomState(seed)
    f32 = dict(dtype=torch.float32, device=ids.device)
    return (torch.tensor(rng.randn(*ids.shape, 3), **f32),
            torch.tensor(rng.randn(*ids.shape, n_attr), **f32))


@pytest.mark.parametrize("scene", ["cube", "random3", "random9", "random16",
                                   "snapped"])
def test_fused_backward_kernel_matches_plain_version(dev, scene):
    clip, attrs, tris, width, height = _scene(scene, dev)
    table, inv_abs_det = rc.pack_rows(clip, tris, True)
    corner = rc.pack_corner_attributes(attrs, tris)
    ids, bc, _ = rc.launch_fused_fwd(table, corner, width, height, 0, height,
                                     False)
    g_bc, g_attr = _cotangents(ids, attrs.shape[-1])
    operands = (ids, bc, g_bc, g_attr, table, inv_abs_det, corner)
    before = rc.BWD_LAUNCHES
    kernel_table = rc.launch_fused_bwd(*operands)
    assert rc.BWD_LAUNCHES == before + 1
    plain_table = rc.triangle_gradients_torch(*operands)
    assert float(plain_table.abs().max()) > 0.0
    _assert_grads_close([kernel_table], [plain_table])
    _assert_grads_close(
        rc.rasterize_interpolate_backward_cuda(*operands, tris,
                                               clip.shape[1]),
        rc.rasterize_interpolate_backward_torch(*operands, tris,
                                                clip.shape[1]))


@pytest.mark.parametrize("scene", ["cube", "random3", "random9", "random16",
                                   "snapped"])
def test_barycentric_kernels_match_plain_versions(dev, scene):
    clip, _, tris, width, height = _scene(scene, dev)
    grads = []
    outs = []
    for kernel in (True, False):
        c = clip.clone().requires_grad_(True)
        before = (rb.FWD_LAUNCHES, rb.BWD_LAUNCHES)
        fn = (rb.rasterize_barycentric_cuda if kernel
              else rb.rasterize_barycentric_torch)
        ids, bc, z = fn(c, tris, width, height)
        g_bc, _ = _cotangents(ids, 0)
        (bc * g_bc).sum().backward()
        after = (rb.FWD_LAUNCHES, rb.BWD_LAUNCHES)
        assert after == ((before[0] + 1, before[1] + 1) if kernel
                         else before)
        outs.append((ids, bc.detach(), z))
        grads.append(c.grad)
    _assert_same(*outs)
    assert float(grads[1].abs().max()) > 0.0
    _assert_grads_close([grads[0]], [grads[1]])
    assert bool((grads[0][..., 2] == 0.0).all())


def test_backward_row_strips_and_empty_mesh(dev):
    clip, attrs, tris, _, _ = _scene("random9", dev)
    g_bc, g_attr = _cotangents(torch.zeros(2, 40, 48, device=dev), 9)

    def grads(triangles, strip_height, row_offset):
        c = clip.clone().requires_grad_(True)
        a = attrs.clone().requires_grad_(True)
        _, bc, attr_img = rc.rasterize_interpolate_cuda(
            c, a, triangles, 48, strip_height, row_offset=row_offset,
            full_height=40)
        rows = slice(row_offset, row_offset + strip_height)
        ((bc * g_bc[:, rows]).sum()
         + (attr_img * g_attr[:, rows]).sum()).backward()
        return c.grad, a.grad

    full = grads(tris, 40, 0)
    strips = [grads(tris, 20, 20 * i) for i in range(2)]
    _assert_grads_close([s + t for s, t in zip(*strips)], full)
    for g in grads(tris[:0], 40, 0):
        assert torch.equal(g, torch.zeros_like(g))
    c = clip[0].clone().requires_grad_(True)
    _, bc, _ = rasterize_ops.rasterize_barycentric(c, tris[:0], 48, 40)
    bc.sum().backward()
    assert torch.equal(c.grad, torch.zeros_like(c))


def test_backward_launchers_reject_what_the_kernels_do_not_take(dev):
    clip, attrs, tris, width, height = _scene("cube", dev)
    table, inv_abs_det = rc.pack_rows(clip, tris, True)
    corner = rc.pack_corner_attributes(attrs, tris)
    ids, bc, _ = rc.launch_fused_fwd(table, corner, width, height, 0, height,
                                     False)
    g_bc, g_attr = _cotangents(ids, 3)
    operands = [ids, bc, g_bc, g_attr, table, inv_abs_det, corner]
    with pytest.raises(ValueError, match="CUDA"):
        rc.launch_fused_bwd(*[t.cpu() for t in operands])
    with pytest.raises(TypeError, match="float32"):
        rc.launch_fused_bwd(*operands[:2], g_bc.double(), *operands[3:])
    with pytest.raises(ValueError, match="contiguous"):
        rc.launch_fused_bwd(*operands[:2], g_bc.transpose(1, 2).contiguous()
                            .transpose(1, 2), *operands[3:])
    with pytest.raises(ValueError, match="shapes"):
        rc.launch_fused_bwd(*operands[:4], table[:, :5], *operands[5:])
    bary = [ids, bc, g_bc, table, inv_abs_det]
    with pytest.raises(ValueError, match="CUDA"):
        rb.launch_bary_bwd(*[t.cpu() for t in bary])
    with pytest.raises(TypeError, match="int32"):
        rb.launch_bary_bwd(ids.long(), *bary[1:])
    with pytest.raises(ValueError, match="contiguous"):
        rb.launch_bary_bwd(ids, bc, g_bc[:, ::2], table, inv_abs_det)


SOFT_SCENES = test_utils.SOFT_SCENES
SOFT_GRAD_RTOL = test_utils.SOFT_GRAD_RTOL


def _soft_launches():
    return (sc.FWD_LAUNCHES, sc.SIL_FWD_LAUNCHES, sc.BWD_LAUNCHES,
            sc.SIL_BWD_LAUNCHES)


@pytest.mark.parametrize("scene", SOFT_SCENES)
def test_soft_forward_kernels_match_plain_versions(dev, scene):
    soft_scene = test_utils.soft_scene(scene, dev)
    before = _soft_launches()
    (rgba, _, _), _, _ = test_utils.compare_soft_forward(soft_scene)
    assert _soft_launches() == (before[0] + 1, before[1] + 1) + before[2:]
    assert float(rgba[..., 3].max()) > 0.5


@pytest.mark.parametrize("scene", SOFT_SCENES)
def test_soft_backward_kernels_match_plain_versions(dev, scene):
    soft_scene = test_utils.soft_scene(scene, dev)
    k7, alpha, _ = test_utils.compare_soft_forward(soft_scene)
    d_rgba = test_utils.soft_cotangents(soft_scene.table.shape[0],
                                        soft_scene.height, soft_scene.width,
                                        dev)
    before = _soft_launches()
    _, sil_dtable, errors = test_utils.compare_soft_backward(
        soft_scene, k7, alpha, d_rgba)
    assert _soft_launches() == before[:2] + (before[2] + 1, before[3] + 1)
    # Every compared part of K8's gradient is exercised (nonzero) but the
    # columns that take none.
    assert all(scale > 0.0 for label, _, scale in errors["soft_bwd"]
               if "none" not in label)
    # K6 writes only the edge columns.
    assert torch.equal(sil_dtable[..., :9], torch.zeros_like(
        sil_dtable[..., :9]))
    assert torch.equal(sil_dtable[..., 15:], torch.zeros_like(
        sil_dtable[..., 15:]))


def test_soft_row_strips_and_empty_mesh(dev):
    """Row strips reassemble the full image exactly and their table
    gradients sum to the full image's; a mesh without triangles renders
    background and has zero gradients."""
    full = test_utils.soft_scene("random3", dev)
    k7, alpha, _ = test_utils.compare_soft_forward(full)
    d_rgba = test_utils.soft_cotangents(2, full.height, full.width, dev)
    full_grads = test_utils.compare_soft_backward(full, k7, alpha, d_rgba)
    strip_grads = []
    for i in range(2):
        rows = slice(20 * i, 20 * (i + 1))
        strip = full._replace(height=20, params=sc.make_params(
            test_utils.SOFT_SIGMA, test_utils.SOFT_GAMMA,
            test_utils.SOFT_BLUR, 20 * i, dev))
        strip_k7, strip_alpha, _ = test_utils.compare_soft_forward(
            strip, 20 * i, 40)
        for s, f in zip(strip_k7, k7):
            assert torch.equal(s, f[:, rows])
        assert torch.equal(strip_alpha, alpha[:, rows])
        strip_grads.append(test_utils.compare_soft_backward(
            strip, strip_k7, strip_alpha, d_rgba[:, rows].contiguous(),
            20 * i, 40))
    for k in range(2):
        test_utils.grad_errors("the strips' dtable", strip_grads[0][k]
                               + strip_grads[1][k], full_grads[k],
                               SOFT_GRAD_RTOL, test_utils.SOFT_DTABLE_GROUPS)
    empty = full._replace(table=full.table[:, :0].contiguous())
    k7, alpha, _ = test_utils.compare_soft_forward(empty)
    assert torch.equal(k7[0], torch.zeros_like(k7[0]))
    dtable, _, errors = test_utils.compare_soft_backward(empty, k7, alpha,
                                                         d_rgba)
    assert dtable.shape == empty.table.shape
    # dlights, dsigma and dgamma: zero on both routes.
    assert all(err == scale == 0.0 for _, err, scale in errors["soft_bwd"])


def _soft_render_args(dev):
    v, t, _ = shapes.cube(2.0)
    f32 = dict(dtype=torch.float32, device=dev)
    return (v[None].to(dev), t.to(dev), torch.ones(1, 8, 3, **f32),
            torch.tensor([2.0, 3.0, 6.0], **f32), torch.zeros(3, **f32),
            torch.tensor([0.0, 1.0, 0.0], **f32),
            torch.tensor([[[0.0, 2.0, 6.0]]], **f32), torch.ones(1, 1, **f32),
            32, 32)


def test_soft_render_launch_counters_and_no_plain_route(dev, monkeypatch):
    """render and render_silhouette on a CUDA tensor launch K7/K8 and K5/K6
    and never reach the plain versions, under 'auto' and 'cuda'."""
    def refuse(*args, **kwargs):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(sc, "soft_forward_torch_packed", refuse)
    monkeypatch.setattr(sc, "soft_backward_torch_packed", refuse)
    monkeypatch.setattr(sc, "soft_silhouette_backward_torch_packed", refuse)
    args = _soft_render_args(dev)
    for config in (None, config_lib.SoftRasterizerConfig(backend="cuda")):
        v = args[0].clone().requires_grad_(True)
        before = (sc.FWD_LAUNCHES, sc.BWD_LAUNCHES, sc.SIL_FWD_LAUNCHES,
                  sc.SIL_BWD_LAUNCHES)
        images = soft_mesh_renderer.render(v, *args[1:], config=config)
        alpha = soft_mesh_renderer.render_silhouette(
            v, args[1], *args[3:6], 32, 32, config=config)
        (images.square().mean() + alpha.square().mean()).backward()
        torch.cuda.synchronize()
        after = (sc.FWD_LAUNCHES, sc.BWD_LAUNCHES, sc.SIL_FWD_LAUNCHES,
                 sc.SIL_BWD_LAUNCHES)
        assert after == tuple(b + 1 for b in before)
        assert torch.equal(alpha, images[..., 3].detach())
        assert bool(torch.isfinite(v.grad).all())
        assert float(v.grad.abs().max()) > 0.0


def test_soft_render_gradients_match_plain_route(dev):
    args = _soft_render_args(dev)
    plain_cfg = config_lib.SoftRasterizerConfig(backend="torch")
    grads = []
    for config in (None, plain_cfg):
        v = args[0].clone().requires_grad_(True)
        sigma = torch.tensor(1e-4, device=dev, requires_grad=True)
        images = soft_mesh_renderer.render(v, *args[1:], sigma_val=sigma,
                                           gamma_val=1e-2, config=config)
        images.square().mean().backward()
        grads.append((v.grad, sigma.grad))
    _assert_grads_close(grads[0], grads[1], SOFT_GRAD_RTOL)


def test_soft_large_mesh_renders_in_one_launch(dev):
    """A sphere of 2 * 157^2 = 49,298 triangles, above the JAX package's
    per-pass cap of 49,152, renders in one launch per kernel at 64x64."""
    sphere = test_utils.soft_scene("sphere", dev)
    assert sphere.table.shape[1] == 49298
    before = _soft_launches()
    k7, alpha, _ = test_utils.compare_soft_forward(sphere)
    test_utils.compare_soft_backward(
        sphere, k7, alpha, test_utils.soft_cotangents(1, 64, 64, dev))
    assert _soft_launches() == tuple(b + 1 for b in before)
    assert 0.2 < float((alpha > 0.5).float().mean()) < 0.9
