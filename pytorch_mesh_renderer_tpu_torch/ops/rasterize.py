"""Hard rasterization + attribute interpolation (batched, differentiable).

Port of `pytorch_mesh_renderer_tpu/ops/rasterize.py:20-142`: backend
dispatch to the fused rasterizer, then the alpha composite
clamp(2 * sum(barycentrics), 0, 1) over `background_value`; and
`rasterize_barycentric`, the barycentric-only entry point (the reference
kernel's contract). Gradients reach the clip vertices and the attributes
through the kernels' analytic backward.

Backend choice is by tensor device, never by fallback: under 'auto' a CPU
tensor takes the plain PyTorch version and a CUDA tensor the CUDA kernel;
'cuda' on a CPU tensor raises; 'torch' forces the plain version.
"""

from __future__ import annotations

import torch

from .. import config as config_lib
from ..utils.capture import constant
from . import camera
from .math_utils import clip
from .mesh import int32_index
from .rasterize_barycentric_cuda import (rasterize_barycentric_cuda,
                                         rasterize_barycentric_torch)
from .rasterize_cuda import (rasterize_interpolate_cuda,
                             rasterize_interpolate_torch)


def select_backend(cfg: config_lib.HardRasterizerConfig,
                   device: torch.device) -> str:
    """'cuda' or 'torch' for a tensor on `device` under `cfg`."""
    if cfg.backend == "auto":
        return "cuda" if device.type == "cuda" else "torch"
    if cfg.backend == "cuda" and device.type != "cuda":
        raise ValueError(
            f"backend='cuda' needs CUDA tensors, got a tensor on {device}")
    return cfg.backend


def rasterize_barycentric(clip_space_vertices, triangles, image_width,
                          image_height, config=None, row_offset=None,
                          full_height=None):
    """Rasterize one mesh in clip space to (ids, barycentrics, z-buffer).

    Args:
      clip_space_vertices: [vertex_count, 4] f32 clip-space positions.
      triangles: [triangle_count, 3] int32, on the same device.
      image_width, image_height: ints (the strip size when row_offset /
        full_height render rows [row_offset, row_offset + image_height) of
        a full_height-row image; row_offset None is 0).

    Returns:
      (ids [H, W] i32, barycentrics [H, W, 3] f32, z [H, W] f32);
      uncovered pixels have id 0, barycentrics 0 and z 1. Gradients flow
      through the barycentrics only (no vertex-z gradient).
    """
    if clip_space_vertices.dim() != 2:
        raise ValueError("clip_space_vertices must have shape [V, 4].")
    cfg = config or config_lib.HARD_CONFIG
    triangles = int32_index(triangles)
    row_offset = row_offset or 0
    if select_backend(cfg, clip_space_vertices.device) == "cuda":
        ids, bc, z = rasterize_barycentric_cuda(
            clip_space_vertices[None], triangles, image_width, image_height,
            row_offset=row_offset, full_height=full_height)
    else:
        ids, bc, z = rasterize_barycentric_torch(
            clip_space_vertices[None], triangles, image_width, image_height,
            row_offset=row_offset, full_height=full_height,
            triangle_chunk=cfg.triangle_chunk)
    return ids[0], bc[0], z[0]


def rasterize(world_space_vertices, attributes, triangles, camera_matrices,
              image_width, image_height, background_value, config=None,
              row_offset=None, full_height=None):
    """Rasterize a batch of meshes and interpolate vertex attributes.

    Args:
      world_space_vertices: [batch_size, vertex_count, 3] f32 xyz positions.
      attributes: [batch_size, vertex_count, attribute_count] f32, each
        attribute barycentrically interpolated across its triangle.
      triangles: [triangle_count, 3] int32, CW winding toward the viewer.
      camera_matrices: [batch_size, 4, 4] f32 model-view-perspective.
      image_width, image_height: ints.
      background_value: [attribute_count] f32 value for uncovered pixels.

    Returns:
      [batch_size, image_height, image_width, attribute_count] f32.
    """
    clip_space_vertices = camera.transform_homogeneous(
        camera_matrices, world_space_vertices)
    return rasterize_clip_space(clip_space_vertices, attributes, triangles,
                                image_width, image_height, background_value,
                                config=config, row_offset=row_offset,
                                full_height=full_height)


def rasterize_clip_space(clip_space_vertices, attributes, triangles,
                         image_width, image_height, background_value,
                         config=None, row_offset=None, full_height=None):
    """Rasterize clip-space meshes and interpolate vertex attributes.

    Per-pixel attributes are the winning triangle's corner attributes
    summed with barycentric weights; alpha = clamp(2 * sum(barycentrics),
    0, 1) composites them over `background_value`. Gradients reach
    clip_space_vertices and attributes: the CUDA kernel's backward under
    the 'cuda' route, the plain analytic backward under 'torch'.
    """
    if not image_width > 0:
        raise ValueError("Image width must be > 0.")
    if not image_height > 0:
        raise ValueError("Image height must be > 0.")
    if clip_space_vertices.dim() != 3:
        raise ValueError("The vertex buffer must be 3D.")

    cfg = config or config_lib.HARD_CONFIG
    device = clip_space_vertices.device
    row_offset = row_offset or 0
    attributes = attributes.to(torch.float32)
    triangles = int32_index(triangles)
    if select_backend(cfg, device) == "cuda":
        _, bc, attribute_images = rasterize_interpolate_cuda(
            clip_space_vertices, attributes, triangles, image_width,
            image_height, row_offset=row_offset, full_height=full_height)
    else:
        _, bc, attribute_images = rasterize_interpolate_torch(
            clip_space_vertices, attributes, triangles, image_width,
            image_height, row_offset=row_offset, full_height=full_height,
            triangle_chunk=cfg.triangle_chunk)

    alphas = clip(torch.sum(2.0 * bc, dim=-1), 0.0, 1.0)[..., None]
    if torch.is_tensor(background_value) and background_value.device != device:
        raise ValueError(
            f"background_value lies on {background_value.device}, but the "
            f"vertices lie on {device}; move it explicitly.")
    background_value = (background_value.to(torch.float32)
                        if torch.is_tensor(background_value)
                        else constant(background_value, device))
    return alphas * attribute_images + (1.0 - alphas) * background_value
