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
"""

import numpy as np
import pytest
import torch

from pytorch_mesh_renderer_tpu_torch import config as config_lib
from pytorch_mesh_renderer_tpu_torch.models import mesh_renderer
from pytorch_mesh_renderer_tpu_torch.ops import camera
from pytorch_mesh_renderer_tpu_torch.ops import rasterize as rasterize_ops
from pytorch_mesh_renderer_tpu_torch.ops import rasterize_barycentric_cuda as rb
from pytorch_mesh_renderer_tpu_torch.ops import rasterize_cuda as rc

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


def _assert_grads_close(kernel, plain):
    """Per tensor: within 1e-5 of the plain tensor's max |value|."""
    torch.cuda.synchronize()
    assert len(kernel) == len(plain)
    for k, p in zip(kernel, plain):
        assert k.shape == p.shape and k.dtype == p.dtype
        if p.numel():
            scale = float(p.abs().max())
            assert float((k - p).abs().max()) <= 1e-5 * scale


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
