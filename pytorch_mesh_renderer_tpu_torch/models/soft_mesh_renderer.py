"""Soft (SoftRas, Liu 2019) mesh renderer.

Port of `pytorch_mesh_renderer_tpu/models/soft_mesh_renderer.py:25-143`:
the same validation, broadcasting and defaults (sigma 1e-5, gamma 1e-4,
blur 0.01, fov_y 40, near 0.01, far 10), camera matrices, automatic vertex
normals, then the soft rasterizer (shading is fused into it), and the
debug-check hook.

Triangle winding: counter-clockwise toward the viewer (back faces are
culled by signed area). Light intensities are scalars per light [B, L],
not the hard renderer's RGB.

Tensors are never moved between devices: every tensor argument must lie on
the device of `vertices`; Python numbers and sequences are materialised
there.
"""

from __future__ import annotations

from .. import config as config_lib
from ..ops import camera, mesh
from ..ops.soft_rasterize import (rasterize,
                                  rasterize_silhouette_clip_space_batch)
from ..utils.debug import debug_check_finite
from .mesh_renderer import (_as_f32, _broadcast_camera_vec,
                            _broadcast_scalar, _vertices_and_triangles)

__all__ = ["render", "render_silhouette"]


def _clip_space_transforms(camera_position, camera_lookat, camera_up,
                           fov_y, near_clip, far_clip, image_width,
                           image_height, batch_size, device):
    vec = [_broadcast_camera_vec(v, batch_size, device, name)
           for v, name in ((camera_position, "camera_position"),
                           (camera_lookat, "camera_lookat"),
                           (camera_up, "camera_up"))]
    scalars = [_broadcast_scalar(v, batch_size, device, name)
               for v, name in ((fov_y, "fov_y"), (near_clip, "near_clip"),
                               (far_clip, "far_clip"))]
    return camera.clip_space_transforms(*vec, *scalars, image_width,
                                        image_height)


def render(vertices, triangles, diffuse_colors, camera_position,
           camera_lookat, camera_up, light_positions, light_intensities,
           image_width, image_height, sigma_val=1e-5, gamma_val=1e-4,
           blur_radius=0.01, fov_y=40.0, near_clip=0.01, far_clip=10.0,
           config=None):
    """Soft-renders an input scene, returning lit RGBA images.

    Args:
      vertices: [batch_size, vertex_count, 3] f32 world positions.
      triangles: [triangle_count, 3] int32, CCW winding toward the viewer.
      diffuse_colors: [batch_size, vertex_count, 3] f32 in [0, 1].
      camera_position / camera_lookat / camera_up: [batch_size, 3] or [3].
      light_positions: [batch_size, light_count, 3] f32.
      light_intensities: [batch_size, light_count] f32 (a scalar per light).
      sigma_val, gamma_val: SoftRas sharpness and depth temperature (floats
        or 0-D tensors, differentiable); blur_radius: the sampling cutoff,
        a Python float.

    Returns:
      [batch_size, image_height, image_width, 4] f32 RGBA; RGB aggregated
      by softmax depth weights, alpha by the silhouette probability.
    """
    vertices, triangles = _vertices_and_triangles(vertices, triangles)
    device = vertices.device
    batch_size = vertices.shape[0]
    light_positions = _as_f32(light_positions, device, "light_positions")
    if light_positions.dim() != 3 or light_positions.shape[-1] != 3:
        raise ValueError(
            "light_positions must have shape [batch_size, light_count, 3].")
    light_intensities = _as_f32(light_intensities, device,
                                "light_intensities")
    if light_intensities.dim() != 2:
        raise ValueError(
            "light_intensities must have shape [batch_size, light_count].")
    diffuse_colors = _as_f32(diffuse_colors, device, "diffuse_colors")
    if diffuse_colors.dim() != 3 or diffuse_colors.shape[-1] != 3:
        raise ValueError(
            "diffuse_colors must have shape [batch_size, vertex_count, 3].")

    clip_space_transforms = _clip_space_transforms(
        camera_position, camera_lookat, camera_up, fov_y, near_clip,
        far_clip, image_width, image_height, batch_size, device)
    normals = mesh.compute_vertex_normals(vertices, triangles)
    images = rasterize(
        vertices, triangles, normals, diffuse_colors, light_positions,
        light_intensities, clip_space_transforms, image_width, image_height,
        sigma_val, gamma_val, blur_radius=blur_radius, config=config)
    if config_lib.debug_checks_enabled():
        debug_check_finite(images, "soft_mesh_renderer.render output")
    return images


def render_silhouette(vertices, triangles, camera_position, camera_lookat,
                      camera_up, image_width, image_height, sigma_val=1e-5,
                      blur_radius=0.01, fov_y=40.0, near_clip=0.01,
                      far_clip=10.0, config=None):
    """Soft-renders only the silhouette (alpha) channel: [B, H, W] in [0, 1].

    Bit-identical to `render(...)[..., 3]` on the same route: alpha =
    1 - prod_t(1 - coverage_t) needs no lights, normals, colours, shading
    or softmax-depth aggregation (depth enters only through the validity
    gate), so the silhouette kernels skip them and the backward reduces
    only the edge-endpoint gradients and dsigma. This is the path of
    silhouette-loss shape and pose fitting. gamma does not enter it; sigma
    is differentiable.
    """
    vertices, triangles = _vertices_and_triangles(vertices, triangles)
    device = vertices.device
    clip_space_transforms = _clip_space_transforms(
        camera_position, camera_lookat, camera_up, fov_y, near_clip,
        far_clip, image_width, image_height, vertices.shape[0], device)
    clip = camera.transform_homogeneous(clip_space_transforms, vertices)
    alpha = rasterize_silhouette_clip_space_batch(
        clip, triangles, image_width, image_height, sigma_val,
        blur_radius=blur_radius, config=config)
    if config_lib.debug_checks_enabled():
        debug_check_finite(alpha, "render_silhouette output")
    return alpha
