"""Phong shading + tone mapping.

Port of `pytorch_mesh_renderer_tpu/ops/shading.py:16-120`: pixelwise
lighting over [batch, light, pixel] axes with broadcasting, including the
cross-pixel L2 normalisation of the specular term and the final vertical
flip. `phong_shader` is the plain version and the spec.

On the card the hard renderer's diffuse and ambient shading runs as one
hand-written CUDA kernel each way instead (`csrc/phong_shade.cu`):
`phong_shade_cuda` reads the rasterizer's [B, H, W, A] attributes in place
and returns what `phong_shader` returns for them, and its backward is the
analytic one that autograd takes through those ops
(`phong_diffuse_backward_torch` writes it out in PyTorch). Each launch
counts one `launches.phong_shade_fwd` or `launches.phong_shade_bwd`
(`utils/profiling.count`), once at a CUDA graph's capture.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from ..utils import kernels, profiling
from ..utils.capture import constant
from .math_utils import clip, normalize
from .rasterize_cuda import check_kernel_operands

# The attribute columns the shading reads: normal, position, diffuse.
SHADED_ATTRIBUTES = 9
_EPS = 1e-12


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


def _normalize_backward(x, g):
    """The gradient of `normalize(x, dim=-1)` for the cotangent g, along
    autograd's chain: the quotient, the clamp at eps (nothing passes below
    it), the square root (grad / (2 sqrt), 0 / 0 at a zero-length x) and
    the squares."""
    norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    m = torch.clamp(norm, min=_EPS)
    g_norm = torch.where(norm >= _EPS,
                         -torch.sum(g * x, dim=-1, keepdim=True) / (m * m),
                         0.0)
    return g / m + (g_norm / (2.0 * norm)) * (2.0 * x)


def _clip_slope(s):
    """`math_utils.clip(s, 0, 1)`'s derivative: 1 inside (0, 1), 1/2 at
    exactly 0 or 1, 0 outside."""
    return torch.where((s > 0.0) & (s < 1.0), 1.0,
                       torch.where((s == 0.0) | (s == 1.0), 0.5, 0.0))


def phong_diffuse_backward_torch(pixel_attributes, light_positions,
                                 light_intensities, ambient_color, d_images):
    """The backward of the hard renderer's diffuse and ambient shading, as
    the CUDA kernel computes it: the gradient that autograd takes through
    `phong_shader` after the renderer's slices of the attributes, written
    out per pixel and light.

    Args:
      pixel_attributes: [B, H, W, A] f32, A >= 9: normal, position and
        diffuse colour in columns 0-8 (the diffuse's background is -1).
      light_positions, light_intensities: [B, L, 3] f32.
      ambient_color: [B, 3] f32 or None.
      d_images: [B, H, W, 4] f32 cotangent of the flipped RGBA image.

    Returns:
      [B, H, W, A] f32: the attributes' gradient, zero beyond column 8.
    """
    batch, height, width, n_attr = pixel_attributes.shape
    x = pixel_attributes.reshape(batch, -1, n_attr)
    n, q, d = x[..., 0:3], x[..., 3:6], x[..., 6:9]
    mask = torch.any(d >= 0.0, dim=-1, keepdim=True)
    g = torch.flip(d_images, dims=[1])[..., :3].reshape(batch, -1, 3)
    g = torch.where(mask, g, 0.0)
    n_hat = normalize(n, p=2, dim=-1)
    g_d = torch.zeros_like(g)
    g_n_hat = torch.zeros_like(g)
    g_q = torch.zeros_like(g)
    for light in range(light_positions.shape[1]):
        to_light = light_positions[:, light, None, :] - q
        u = normalize(to_light, p=2, dim=-1)
        s = torch.sum(n_hat * u, dim=-1, keepdim=True)
        g_lit = g * light_intensities[:, light, None, :]
        g_d = g_d + g_lit * clip(s, 0.0, 1.0)
        g_s = torch.sum(g_lit * d, dim=-1, keepdim=True) * _clip_slope(s)
        g_n_hat = g_n_hat + g_s * u
        g_q = g_q - _normalize_backward(to_light, g_s * n_hat)
    if ambient_color is not None:
        g_d = g_d + g * ambient_color[:, None, :]
    rest = torch.zeros(batch, x.shape[1], n_attr - SHADED_ATTRIBUTES,
                       dtype=x.dtype, device=x.device)
    return torch.cat([_normalize_backward(n, g_n_hat), g_q, g_d, rest],
                     dim=-1).reshape(batch, height, width, n_attr)


def _check_shading_operands(pixel_attributes, light_positions,
                            light_intensities, ambient_color):
    """Raise unless the operands are what the shading kernels take."""
    f32 = torch.float32
    operands = [("pixel_attributes", pixel_attributes, f32),
                ("light_positions", light_positions, f32),
                ("light_intensities", light_intensities, f32)]
    if ambient_color is not None:
        operands.append(("ambient_color", ambient_color, f32))
    check_kernel_operands(pixel_attributes.device, operands)
    batch, height, width, n_attr = (tuple(pixel_attributes.shape)
                                    if pixel_attributes.dim() == 4
                                    else (0, 0, 0, 0))
    lights = (batch, light_positions.shape[1]
              if light_positions.dim() == 3 else -1, 3)
    if (n_attr < SHADED_ATTRIBUTES or light_positions.shape != lights
            or light_intensities.shape != lights or (
                ambient_color is not None
                and ambient_color.shape != (batch, 3))):
        raise ValueError(
            "shading operands have shapes "
            f"{[tuple(t.shape) for _, t, _ in operands]}; want "
            f"[B, H, W, A >= {SHADED_ATTRIBUTES}], [B, L, 3] twice and "
            "[B, 3]")
    if lights[1] >= 2 ** 31 or height * width >= 2 ** 31 - 256:
        raise ValueError("the shading exceeds the kernels' int32 extents")


def launch_phong_shade_fwd(pixel_attributes, light_positions,
                           light_intensities, ambient_color=None):
    """Launch the forward shading kernel; returns the [B, H, W, 4] image
    `phong_shader` returns for these attributes (the renderer's
    `_shade_torch`). Operands: contiguous f32 CUDA tensors on one device,
    attributes [B, H, W, A >= 9], lights [B, L, 3], ambient [B, 3] or
    None."""
    _check_shading_operands(pixel_attributes, light_positions,
                            light_intensities, ambient_color)
    batch, height, width, n_attr = pixel_attributes.shape
    images = torch.empty(batch, height, width, 4, dtype=torch.float32,
                         device=pixel_attributes.device)
    lib = kernels.load_library()
    with torch.cuda.device(images.device):
        stream = torch.cuda.current_stream(images.device).cuda_stream
        error = lib.phong_shade_fwd(
            pixel_attributes.data_ptr(), light_positions.data_ptr(),
            light_intensities.data_ptr(),
            None if ambient_color is None else ambient_color.data_ptr(),
            images.data_ptr(), batch, light_positions.shape[1], n_attr,
            height, width, stream)
    kernels.check_cuda_error(lib, error, "phong_shade_fwd launch")
    profiling.count("launches.phong_shade_fwd")
    return images


def launch_phong_shade_bwd(pixel_attributes, light_positions,
                           light_intensities, ambient_color, d_images):
    """Launch the backward shading kernel; returns the [B, H, W, A]
    gradient of the attributes, as `phong_diffuse_backward_torch`.
    Operands as `launch_phong_shade_fwd`'s, and d_images [B, H, W, 4]."""
    _check_shading_operands(pixel_attributes, light_positions,
                            light_intensities, ambient_color)
    batch, height, width, n_attr = pixel_attributes.shape
    if (tuple(d_images.shape) != (batch, height, width, 4)
            or d_images.device != pixel_attributes.device
            or d_images.dtype != torch.float32):
        raise ValueError(f"d_images must be f32 [B, H, W, 4] on the "
                         f"attributes' device, got {tuple(d_images.shape)}")
    d_images = d_images.contiguous()
    if d_images.data_ptr() % 16:  # the kernel reads a pixel as one float4
        d_images = d_images.clone()
    d_attrs = torch.empty_like(pixel_attributes)
    lib = kernels.load_library()
    with torch.cuda.device(d_attrs.device):
        stream = torch.cuda.current_stream(d_attrs.device).cuda_stream
        error = lib.phong_shade_bwd(
            pixel_attributes.data_ptr(), light_positions.data_ptr(),
            light_intensities.data_ptr(),
            None if ambient_color is None else ambient_color.data_ptr(),
            d_images.data_ptr(), d_attrs.data_ptr(), batch,
            light_positions.shape[1], n_attr, height, width, stream)
    kernels.check_cuda_error(lib, error, "phong_shade_bwd launch")
    profiling.count("launches.phong_shade_bwd")
    return d_attrs


class _PhongShade(torch.autograd.Function):
    """The shading kernel forward, its backward kernel backward; gradients
    reach the attributes only."""

    @staticmethod
    def forward(ctx, pixel_attributes, light_positions, light_intensities,
                ambient_color):
        ctx.save_for_backward(pixel_attributes, light_positions,
                              light_intensities, ambient_color)
        return launch_phong_shade_fwd(pixel_attributes, light_positions,
                                      light_intensities, ambient_color)

    @staticmethod
    @once_differentiable
    def backward(ctx, d_images):
        return (launch_phong_shade_bwd(*ctx.saved_tensors, d_images),
                None, None, None)


def phong_shade_cuda(pixel_attributes, light_positions, light_intensities,
                     ambient_color=None):
    """The hard renderer's diffuse and ambient Phong shading on the card.

    Args:
      pixel_attributes: [B, H, W, A] f32 CUDA, A >= 9: the rasterized
        normal, position and diffuse colour in columns 0-8, background -1.
      light_positions, light_intensities: [B, L, 3] (or [1, L, 3]) f32.
      ambient_color: [B, 3] f32 or None.

    Returns:
      [B, H, W, 4] f32 lit RGBA, flipped vertically, RGB zeroed where no
      diffuse channel is >= 0: `phong_shader`'s image of these attributes
      without specular terms. Gradients reach `pixel_attributes` only; the
      lights and the ambient colour take none.
    """
    batch = pixel_attributes.shape[0]

    def per_image(x):
        return (x if x.shape[0] == batch else
                x.expand(batch, -1, -1)).contiguous()

    return _PhongShade.apply(
        pixel_attributes.contiguous(), per_image(light_positions),
        per_image(light_intensities),
        None if ambient_color is None else ambient_color.contiguous())
