"""Phong shading + tone mapping.

Port of `pytorch_mesh_renderer_tpu/ops/shading.py:16-120`: pixelwise
lighting over [batch, light, pixel] axes with broadcasting, including the
cross-pixel L2 normalisation of the specular term and the final vertical
flip.
"""

from __future__ import annotations

import torch

from ..utils.capture import constant
from .math_utils import clip, normalize


def phong_shader(normals, alphas, pixel_positions, light_positions,
                 light_intensities, diffuse_colors=None, camera_position=None,
                 specular_colors=None, shininess_coefficients=None,
                 ambient_color=None):
    """Pixelwise Phong lighting from rasterized buffers.

    Args:
      normals: [B, H, W, 3] f32 world-space unit normals per pixel.
      alphas: [B, H, W] f32 per-pixel alpha.
      pixel_positions: [B, H, W, 3] f32 world-space positions per pixel.
      light_positions: [B, L, 3] f32.
      light_intensities: [B, L, 3] f32 (may exceed 1).
      diffuse_colors: [B, H, W, 3] f32 in [0, 1].
      camera_position: [B, 3] f32; if provided, specular terms are computed
        and specular_colors/shininess_coefficients are required.
      specular_colors: [B, H, W, 3] f32.
      shininess_coefficients: broadcastable to [B, H, W] f32.
      ambient_color: [B, 3] f32 added to each pixel (scaled by diffuse).

    Returns:
      [B, H, W, 4] f32 lit RGBA; RGB zeroed where alpha <= 0.5 and the image
      flipped vertically.
    """
    batch_size, image_height, image_width = normals.shape[:3]
    light_count = light_positions.shape[1]
    pixel_count = image_height * image_width

    normals = normals.reshape(batch_size, -1, 3)
    alphas = alphas.reshape(batch_size, -1, 1)
    diffuse_colors = diffuse_colors.reshape(batch_size, -1, 3)
    if camera_position is not None:
        specular_colors = specular_colors.reshape(batch_size, -1, 3)

    # Ambient component.
    output_colors = torch.zeros([batch_size, pixel_count, 3],
                                dtype=torch.float32, device=normals.device)
    if ambient_color is not None:
        output_colors = output_colors + (
            ambient_color[:, None, :] * diffuse_colors)

    # Diffuse component.
    pixel_positions = pixel_positions.reshape(batch_size, -1, 3)
    directions_to_lights = normalize(
        light_positions[:, :, None, :] - pixel_positions[:, None, :, :],
        p=2, dim=3)  # [B, L, P, 3]
    # Clamp: light contributes only when facing the surface.
    normals_dot_lights = clip(
        torch.sum(normals[:, None, :, :] * directions_to_lights, dim=3),
        0.0, 1.0)  # [B, L, P]
    diffuse_output = (
        diffuse_colors[:, None, :, :] * normals_dot_lights[..., None] *
        light_intensities[:, :, None, :])
    output_colors = output_colors + torch.sum(diffuse_output, dim=1)

    # Specular component.
    if camera_position is not None:
        camera_position = camera_position.reshape(batch_size, 1, 3)
        mirror_reflection_direction = normalize(
            2.0 * normals_dot_lights[..., None] * normals[:, None, :, :] -
            directions_to_lights, p=2, dim=3)
        direction_to_camera = normalize(
            camera_position - pixel_positions, p=2, dim=2)
        reflection_dot_camera = torch.sum(
            mirror_reflection_direction * direction_to_camera[:, None, :, :],
            dim=3)  # [B, L, P]
        # L2-normalized across the pixel axis before clamping, as in the
        # JAX package and its reference (render.py:342-348).
        reflection_dot_camera = clip(
            normalize(reflection_dot_camera, p=2, dim=2), 0.0, 1.0)
        # Specular only contributes where diffuse does.
        reflection_dot_camera = torch.where(
            normals_dot_lights != 0.0, reflection_dot_camera, 0.0)
        reflection_dot_camera = reflection_dot_camera.reshape(
            batch_size, light_count, image_height, image_width)
        shininess = (shininess_coefficients.to(torch.float32)
                     if torch.is_tensor(shininess_coefficients)
                     else constant(shininess_coefficients, normals.device))
        shininess = shininess[:, None] if shininess.dim() > 0 else shininess
        specularity = torch.pow(reflection_dot_camera, shininess).reshape(
            batch_size, light_count, pixel_count, 1)
        specular_output = (
            specular_colors[:, None, :, :] * specularity *
            light_intensities[:, :, None, :])
        output_colors = output_colors + torch.sum(specular_output, dim=1)

    rgb_images = output_colors.reshape(
        batch_size, image_height, image_width, 3)
    alpha_images = alphas.reshape(batch_size, image_height, image_width, 1)
    rgb_images = torch.where(alpha_images > 0.5, rgb_images, 0.0)
    return torch.flip(torch.cat([rgb_images, alpha_images], dim=3), dims=[1])


def tone_mapper(image, gamma):
    """Gamma correction with per-image max rescaling.

    Computes A * image**gamma with A chosen per image so the max value is
    ~1, then clips to [0, 1]. An all-black image passes through unscaled.
    """
    batch_size = image.shape[0]
    corrected_image = torch.pow(image, gamma)
    image_max = torch.amax(corrected_image.reshape(batch_size, -1), dim=1)
    safe_max = torch.where(image_max > 0.0, image_max, 1.0)
    scaled_image = corrected_image / safe_max.reshape(batch_size, 1, 1, 1)
    return clip(scaled_image, 0.0, 1.0)
