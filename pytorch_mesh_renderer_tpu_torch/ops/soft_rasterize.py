"""Soft (SoftRas, Liu 2019) probabilistic rasterizer.

Port of the public surface of `pytorch_mesh_renderer_tpu/ops/
soft_rasterize.py`: the geometry helpers `edge_function` and
`point_to_segment_nearest`, and the entry points `rasterize_batch`,
`rasterize`, `rasterize_clip_space_batch` and
`rasterize_silhouette_clip_space_batch`, with `row_offset`/`full_height`
for row strips.

Each entry point packs the per-triangle table and dispatches by config and
tensor device, never by fallback: under 'auto' a CPU tensor takes the plain
PyTorch version and a CUDA tensor the CUDA kernels (K7 forward and K8
backward for the full render, K5 and K6 for the silhouette); 'cuda' on a
CPU tensor raises; 'torch' forces the plain version
(ops/soft_rasterize_cuda.py). There is one plain implementation, the twin
of the math the kernels compute; the CPU tests hold it against both the
JAX package's XLA scan and its Pallas kernels.

`blur_radius` is a Python float (it shapes the packed bboxes); sigma and
gamma may be floats or 0-D tensors that require a gradient.
"""

from __future__ import annotations

import torch

from .. import config as config_lib
from . import camera
from .math_utils import clip
from .rasterize import select_backend
from .soft_rasterize_cuda import (EPS, soft_rasterize,  # noqa: F401
                                  soft_rasterize_silhouette)


def edge_function(p, v0, v1):
    """Signed parallelogram area of (p - v0) x (v1 - v0), 2D inputs [..., 2+].

    Positive when p is right of segment v0->v1 (clockwise [p, v0, v1]).
    """
    v0p = p - v0
    v01 = v1 - v0
    return v0p[..., 0] * v01[..., 1] - v0p[..., 1] * v01[..., 0]


def point_to_segment_nearest(p, a, b):
    """Nearest point on 2D segment [a, b] to p, and its normalized offset t.

    Broadcasts over leading dims; the last dim is xy. A degenerate segment
    has its length clamped at 1e-12.
    """
    ab = b - a
    len_ab = torch.sqrt(torch.sum(ab * ab, dim=-1))
    n = ab / torch.clamp(len_ab, min=1e-12)[..., None]
    t = torch.sum((p - a) * n, dim=-1) / torch.clamp(len_ab, min=1e-12)
    t = clip(t, 0.0, 1.0)
    return a + t[..., None] * ab, t


def _rows(image_height, row_offset, full_height):
    row_offset = 0 if row_offset is None else int(row_offset)
    full_height = image_height if full_height is None else int(full_height)
    if row_offset < 0 or full_height < 1:
        raise ValueError("row_offset must be >= 0 and full_height >= 1")
    return row_offset, full_height


def _check_scene(clip_space_vertices, triangles, image_width, image_height):
    if clip_space_vertices.dim() != 3 or clip_space_vertices.shape[-1] != 4:
        raise ValueError("clip_space_vertices must have shape [batch, V, 4],"
                         f" got {tuple(clip_space_vertices.shape)}")
    if clip_space_vertices.shape[0] < 1:
        raise ValueError("batch must be >= 1")
    if triangles.dim() != 2 or triangles.shape[-1] != 3:
        raise ValueError("triangles must have shape [T, 3], got "
                         f"{tuple(triangles.shape)}")
    if triangles.device != clip_space_vertices.device:
        raise ValueError(
            f"triangles lie on {triangles.device}, but the vertices lie on "
            f"{clip_space_vertices.device}; move them explicitly.")
    if image_width < 1 or image_height < 1:
        raise ValueError("image_width and image_height must be >= 1")


def rasterize_clip_space_batch(clip_space_vertices, triangles,
                               world_space_vertices, normals, diffuse_colors,
                               light_positions, light_intensities,
                               image_width, image_height, sigma_val,
                               gamma_val, blur_radius=0.01, config=None,
                               row_offset=None, full_height=None):
    """Batched soft rasterization of already-projected meshes.

    Args:
      clip_space_vertices: [B, V, 4] f32.
      triangles: [T, 3] int, CCW winding toward the viewer.
      world_space_vertices, normals, diffuse_colors: [B, V, 3] f32.
      light_positions: [B, L, 3] f32; light_intensities: [B, L] f32.
      sigma_val, gamma_val: SoftRas sharpness and depth temperature.

    Returns:
      [B, H, W, 4] f32 RGBA: RGB aggregated by softmax depth weights over
      an EPS background, alpha the silhouette probability.
    """
    cfg = config or config_lib.SOFT_CONFIG
    _check_scene(clip_space_vertices, triangles, image_width, image_height)
    row_offset, full_height = _rows(image_height, row_offset, full_height)
    lights = torch.cat([light_positions.to(torch.float32),
                        light_intensities.to(torch.float32)[..., None]],
                       dim=-1)
    use_kernel = select_backend(cfg, clip_space_vertices.device) == "cuda"
    return soft_rasterize(
        clip_space_vertices.to(torch.float32), triangles,
        world_space_vertices.to(torch.float32), normals.to(torch.float32),
        diffuse_colors.to(torch.float32), lights, sigma_val, gamma_val,
        blur_radius, image_width, image_height, row_offset, full_height,
        use_kernel, cfg.triangle_chunk)


def rasterize_silhouette_clip_space_batch(clip_space_vertices, triangles,
                                          image_width, image_height,
                                          sigma_val, blur_radius=0.01,
                                          config=None, row_offset=None,
                                          full_height=None):
    """Silhouette-only (alpha channel) batched rasterization: [B, H, W].

    Bit-identical to `rasterize_clip_space_batch(...)[..., 3]` on one
    route (same geometry, same product order), but needs no lights,
    normals or colours; on a CUDA tensor it runs the silhouette kernels
    K5 and K6.
    """
    cfg = config or config_lib.SOFT_CONFIG
    _check_scene(clip_space_vertices, triangles, image_width, image_height)
    row_offset, full_height = _rows(image_height, row_offset, full_height)
    use_kernel = select_backend(cfg, clip_space_vertices.device) == "cuda"
    return soft_rasterize_silhouette(
        clip_space_vertices.to(torch.float32), triangles, sigma_val,
        blur_radius, image_width, image_height, row_offset, full_height,
        use_kernel, cfg.triangle_chunk)


def rasterize_batch(clip_space_vertices, triangles, world_space_vertices,
                    normals, diffuse_colors, light_positions,
                    light_intensities, image_width, image_height, sigma_val,
                    gamma_val, blur_radius=0.01, config=None,
                    row_offset=None, full_height=None,
                    silhouette_only=False):
    """Soft-rasterize one mesh already transformed to clip space.

    Clip xyzw [V, 4], triangles [T, 3] (CCW), world positions, unit
    normals and diffuse colours [V, 3], lights [L, 3] with scalar
    intensities [L]; returns a lit RGBA image [H, W, 4]. With
    silhouette_only the RGB channels are 0 and alpha comes from the
    silhouette route.
    """
    if silhouette_only:
        alpha = rasterize_silhouette_clip_space_batch(
            clip_space_vertices[None], triangles, image_width, image_height,
            sigma_val, blur_radius=blur_radius, config=config,
            row_offset=row_offset, full_height=full_height)[0]
        return torch.cat([torch.zeros(alpha.shape + (3,), dtype=alpha.dtype,
                                      device=alpha.device),
                          alpha[..., None]], dim=-1)
    return rasterize_clip_space_batch(
        clip_space_vertices[None], triangles, world_space_vertices[None],
        normals[None], diffuse_colors[None], light_positions[None],
        light_intensities[None], image_width, image_height, sigma_val,
        gamma_val, blur_radius=blur_radius, config=config,
        row_offset=row_offset, full_height=full_height)[0]


def rasterize(world_space_vertices, triangles, normals, diffuse_colors,
              light_positions, light_intensities, camera_matrices,
              image_width, image_height, sigma_val, gamma_val,
              blur_radius=0.01, config=None, row_offset=None,
              full_height=None):
    """Soft-rasterize a batch of meshes in world space.

    camera_matrices: [B, 4, 4] model-view-perspective; the rest as
    rasterize_clip_space_batch.
    """
    clip_space_vertices = camera.transform_homogeneous(
        camera_matrices, world_space_vertices)
    return rasterize_clip_space_batch(
        clip_space_vertices, triangles, world_space_vertices, normals,
        diffuse_colors, light_positions, light_intensities, image_width,
        image_height, sigma_val, gamma_val, blur_radius=blur_radius,
        config=config, row_offset=row_offset, full_height=full_height)
