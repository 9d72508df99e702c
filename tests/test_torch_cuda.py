"""PyTorch port on the card: the CUDA kernel vs its plain PyTorch version.

Every test here is marked `cuda` and skips without an NVIDIA GPU. The
machine with the card has no JAX, and tests/conftest.py imports it, so run
them there without the conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The kernel and the plain version run the same fp32 operations in the same
order (the kernel is built with --fmad=false): ids must be equal and bc, z
and attributes agree to 1e-6.
"""

import numpy as np
import pytest
import torch

from pytorch_mesh_renderer_tpu_torch import config as config_lib
from pytorch_mesh_renderer_tpu_torch.models import mesh_renderer
from pytorch_mesh_renderer_tpu_torch.ops import camera
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


def test_render_auto_uses_kernel_and_backward_raises(dev):
    clip, attrs, tris, width, height = _scene("cube", dev)
    del clip, attrs
    vertices = torch.tensor([CUBE_VERTICES], dtype=torch.float32,
                            device=dev).requires_grad_(True)
    args = (vertices, tris.flip(1).contiguous(), vertices.detach(),
            torch.ones_like(vertices), torch.tensor([2.0, 3.0, 6.0],
                                                    device=dev),
            torch.zeros(3, device=dev), torch.tensor([0.0, 1.0, 0.0],
                                                     device=dev),
            torch.tensor([[[0.0, 0.0, 6.0]]], device=dev),
            torch.ones(1, 1, 3, device=dev), width, height)
    before = rc.LAUNCHES
    images = mesh_renderer.render(*args)
    assert rc.LAUNCHES == before + 1
    plain = mesh_renderer.render(
        *args, config=config_lib.HardRasterizerConfig(backend="torch"))
    assert float((images - plain).detach().abs().max()) <= 1e-5
    with pytest.raises(NotImplementedError, match="ported next"):
        images.sum().backward()


def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    clip, attrs, tris, width, height = _scene("cube", dev)
    with pytest.raises(TypeError):
        rc.rasterize_interpolate_cuda(clip.double(), attrs, tris, width,
                                      height)
    with pytest.raises(ValueError, match="different devices"):
        rc.rasterize_interpolate_cuda(clip, attrs.cpu(), tris, width, height)
    with pytest.raises(ValueError, match="CUDA"):
        rc.launch_fused_fwd(rc.pack_triangles(clip, tris).cpu(),
                            rc.pack_corner_attributes(attrs, tris).cpu(),
                            width, height, 0, height, False)
