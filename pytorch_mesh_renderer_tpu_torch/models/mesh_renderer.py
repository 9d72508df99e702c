"""Hard (Genova 2018 sampled un-clipped barycentric) mesh renderer.

Port of `pytorch_mesh_renderer_tpu/models/mesh_renderer.py:28-173`: the
same argument validation, broadcasting and defaults, attribute packing,
camera matrices, rasterization over background value -1, Phong shading
with the diffuse-based pixel mask, and the vertical flip. `MeshRenderer`
wraps `render` as an nn.Module.

Triangle winding: clockwise as seen from the viewer.

Tensors are never moved between devices: every tensor argument must lie on
the device of `vertices`; Python numbers and sequences are materialised
there (`utils/capture.constant`: a number by a device fill, a sequence or
array copied once per device, so a step that passes them can be captured
into a CUDA graph after its warm-up).

Under the default backend 'auto' the diffuse and ambient shading runs on
a card as the hand-written kernel pair of `ops/shading.phong_shade_cuda`;
specular shading and gradients into the lights take the plain ops, which
every call takes under 'torch'; under 'cuda' they raise (`_shade`).

Each call counts one `render.calls` and, while a `torch.profiler`
profile records, is an `mr.render` span whose shading is an `mr.shade`
span (`utils/profiling`); the camera and the rasterizer open their own.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .. import config as config_lib
from ..ops import camera
from ..ops.math_utils import normalize
from ..ops.mesh import int32_index
from ..ops.rasterize import rasterize
from ..ops.shading import (  # re-export: tone_mapper
    phong_shade_cuda, phong_shader, tone_mapper)
from ..utils import profiling
from ..utils.capture import constant
from ..utils.debug import debug_check_finite

__all__ = ["render", "MeshRenderer", "phong_shader", "tone_mapper"]


def _as_f32(value, device, name):
    if torch.is_tensor(value):
        if value.device != device:
            raise ValueError(
                f"{name} lies on {value.device}, but vertices lie on "
                f"{device}; move it explicitly.")
        return value.to(torch.float32)
    return constant(value, device)


def _vertices_and_triangles(vertices, triangles):
    """(vertices as f32 [B, V, 3], triangles as int32 [T, 3] on the
    vertices' device). Numpy triangles are materialised there; a tensor on
    another device raises."""
    if not torch.is_tensor(vertices):
        raise TypeError("vertices must be a torch.Tensor")
    device = vertices.device
    vertices = vertices.to(torch.float32)
    if vertices.dim() != 3 or vertices.shape[-1] != 3:
        raise ValueError(
            "Vertices must have shape [batch_size, vertex_count, 3].")
    if not torch.is_tensor(triangles):
        # A reversed view such as tris[:, ::-1] has negative strides, which
        # torch.as_tensor refuses; jnp.asarray takes it. The copy to the
        # device is made once per array (utils/capture.constant).
        triangles = constant(np.ascontiguousarray(triangles), device,
                             torch.int32)
    elif triangles.device != device:
        raise ValueError(
            f"triangles lie on {triangles.device}, but vertices lie on "
            f"{device}; move them explicitly.")
    triangles = int32_index(triangles)
    if triangles.dim() != 2 or triangles.shape[-1] != 3:
        raise ValueError("Triangles must have shape [triangle_count, 3].")
    return vertices, triangles


def _broadcast_camera_vec(value, batch_size, device, name):
    value = _as_f32(value, device, name)
    if tuple(value.shape) == (3,):
        return value[None, :].expand(batch_size, 3)
    if tuple(value.shape) != (batch_size, 3):
        raise ValueError(
            "%s must have shape [batch_size, 3] or [3]." % name)
    return value


def _broadcast_scalar(value, batch_size, device, name):
    if isinstance(value, (float, int)):
        return torch.full([batch_size], float(value), dtype=torch.float32,
                          device=device)
    value = _as_f32(value, device, name)
    if value.dim() == 0:
        return value[None].expand(batch_size)
    if tuple(value.shape) != (batch_size,):
        raise ValueError(
            "%s must be a float, a 0D tensor, or a 1D tensor with shape "
            "[batch_size]." % name)
    return value


def render(vertices, triangles, normals, diffuse_colors, camera_position,
           camera_lookat, camera_up, light_positions, light_intensities,
           image_width, image_height, specular_colors=None,
           shininess_coefficients=None, ambient_color=None, fov_y=40.0,
           near_clip=0.01, far_clip=10.0, config=None):
    """Renders an input scene with Phong shading to an RGBA image batch.

    Shapes and defaults are those of the JAX package's `render`:
    vertices, normals and diffuse_colors [B, V, 3]; triangles [T, 3] int32
    (CW); camera_position/lookat/up [B, 3] or [3]; light_positions and
    light_intensities [B, L, 3]; optional specular_colors [B, V, 3] with
    shininess_coefficients (float, [B] or [B, V]); ambient_color [B, 3];
    fov_y, near_clip, far_clip as floats, 0D or [B] tensors.

    Returns:
      [B, image_height, image_width, 4] f32 lit RGBA; RGB is
      pre-tonemapping (may exceed 1), alpha is ~1 on mesh pixels and 0 on
      background.
    """
    profiling.count("render.calls")
    with profiling.annotate("mr.render"):
        return _render(vertices, triangles, normals, diffuse_colors,
                       camera_position, camera_lookat, camera_up,
                       light_positions, light_intensities, image_width,
                       image_height, specular_colors, shininess_coefficients,
                       ambient_color, fov_y, near_clip, far_clip, config)


def _render(vertices, triangles, normals, diffuse_colors, camera_position,
            camera_lookat, camera_up, light_positions, light_intensities,
            image_width, image_height, specular_colors,
            shininess_coefficients, ambient_color, fov_y, near_clip,
            far_clip, config):
    """`render`'s body, inside its span."""
    vertices, triangles = _vertices_and_triangles(vertices, triangles)
    device = vertices.device
    batch_size = vertices.shape[0]
    normals = _as_f32(normals, device, "normals")
    if normals.dim() != 3 or normals.shape[-1] != 3:
        raise ValueError(
            "Normals must have shape [batch_size, vertex_count, 3].")
    light_positions = _as_f32(light_positions, device, "light_positions")
    if light_positions.dim() != 3 or light_positions.shape[-1] != 3:
        raise ValueError(
            "light_positions must have shape [batch_size, light_count, 3].")
    light_intensities = _as_f32(light_intensities, device,
                                "light_intensities")
    if light_intensities.dim() != 3 or light_intensities.shape[-1] != 3:
        raise ValueError(
            "light_intensities must have shape [batch_size, light_count, 3].")
    diffuse_colors = _as_f32(diffuse_colors, device, "diffuse_colors")
    if diffuse_colors.dim() != 3 or diffuse_colors.shape[-1] != 3:
        raise ValueError(
            "diffuse_colors must have shape [batch_size, vertex_count, 3].")
    if ambient_color is not None:
        ambient_color = _as_f32(ambient_color, device, "ambient_color")
        if list(ambient_color.shape) != [batch_size, 3]:
            raise ValueError("ambient_color must have shape [batch_size, 3].")
    camera_position = _broadcast_camera_vec(camera_position, batch_size,
                                            device, "camera_position")
    camera_lookat = _broadcast_camera_vec(camera_lookat, batch_size, device,
                                          "camera_lookat")
    camera_up = _broadcast_camera_vec(camera_up, batch_size, device,
                                      "camera_up")
    fov_y = _broadcast_scalar(fov_y, batch_size, device, "fov_y")
    near_clip = _broadcast_scalar(near_clip, batch_size, device, "near_clip")
    far_clip = _broadcast_scalar(far_clip, batch_size, device, "far_clip")
    if specular_colors is not None and shininess_coefficients is None:
        raise ValueError(
            "Specular colors were supplied without shininess coefficients.")
    if shininess_coefficients is not None and specular_colors is None:
        raise ValueError(
            "Shininess coefficients were supplied without specular colors.")
    if specular_colors is not None:
        specular_colors = _as_f32(specular_colors, device, "specular_colors")
        shininess_coefficients = _as_f32(shininess_coefficients, device,
                                         "shininess_coefficients")
        if specular_colors.dim() != 3:
            raise ValueError(
                "The specular colors must have shape [batch_size, "
                "vertex_count, 3].")
        if shininess_coefficients.dim() > 2:
            raise ValueError(
                "The shininess coefficients must have shape at most "
                "[batch_size, vertex_count].")
        # Per-vertex shininess is interpolated as an attribute; scalar or
        # per-batch shininess broadcasts in the shader.
        if shininess_coefficients.dim() < 2:
            vertex_attributes = torch.cat(
                [normals, vertices, diffuse_colors, specular_colors], dim=2)
        else:
            vertex_attributes = torch.cat(
                [normals, vertices, diffuse_colors, specular_colors,
                 shininess_coefficients[..., None]], dim=2)
    else:
        vertex_attributes = torch.cat(
            [normals, vertices, diffuse_colors], dim=2)

    clip_space_transforms = camera.clip_space_transforms(
        camera_position, camera_lookat, camera_up, fov_y, near_clip,
        far_clip, image_width, image_height)

    background_value = torch.full([vertex_attributes.shape[2]], -1.0,
                                  dtype=torch.float32, device=device)
    pixel_attributes = rasterize(
        vertices, vertex_attributes, triangles, clip_space_transforms,
        image_width, image_height, background_value, config=config)

    with profiling.annotate("mr.shade"):
        images = _shade(pixel_attributes, light_positions, light_intensities,
                        camera_position, specular_colors,
                        shininess_coefficients, ambient_color, config)
    if config_lib.debug_checks_enabled():
        debug_check_finite(images, "mesh_renderer.render output")
    return images


def _shade(pixel_attributes, light_positions, light_intensities,
           camera_position, specular_colors, shininess_coefficients,
           ambient_color, config):
    """Phong shading of the rasterized attributes (normals, positions,
    diffuse, then specular and shininess when given) under the pixel mask
    of covered pixels: the diffuse attribute's background is -1.

    The route follows `config.backend`, as the rasterizer's does. Under
    'torch' every call runs the plain ops (`_shade_torch`), the reference
    the kernels are held to. Under 'auto' a call on a card without
    specular terms and with no gradient wanted for the lights or the
    ambient colour runs the shading kernels (`shading.phong_shade_cuda`),
    and any other the plain ops; under 'cuda' those others raise. A call on
    a card that runs the plain ops counts one `shade.unfused`."""
    backend = (config or config_lib.HARD_CONFIG).backend
    on_card = pixel_attributes.is_cuda
    if backend == "cuda" or (backend == "auto" and on_card):
        lighting = (light_positions, light_intensities, ambient_color)
        wants_grad = torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in lighting)
        if specular_colors is None and not wants_grad:
            return phong_shade_cuda(pixel_attributes, *lighting)
        if backend == "cuda":
            raise ValueError(
                "backend='cuda' shades diffuse and ambient light with no "
                "gradient for the lights or the ambient colour; specular "
                "shading and light gradients need backend='auto' or 'torch'")
    if on_card:
        profiling.count("shade.unfused")
    return _shade_torch(pixel_attributes, light_positions, light_intensities,
                        camera_position, specular_colors,
                        shininess_coefficients, ambient_color)


def _shade_torch(pixel_attributes, light_positions, light_intensities,
                 camera_position, specular_colors, shininess_coefficients,
                 ambient_color):
    """`_shade` in plain PyTorch ops: the slices, the mask and
    `phong_shader`, with autograd through them."""
    pixel_normals = normalize(pixel_attributes[..., 0:3], p=2, dim=3)
    pixel_positions = pixel_attributes[..., 3:6]
    pixel_diffuse = pixel_attributes[..., 6:9]
    pixel_specular = None
    shininess_for_shader = None
    if specular_colors is not None:
        pixel_specular = pixel_attributes[..., 9:12]
        if shininess_coefficients.dim() == 2:
            shininess_for_shader = pixel_attributes[..., 12]
        else:
            shininess_for_shader = shininess_coefficients.reshape(-1, 1, 1)

    pixel_mask = torch.any(pixel_diffuse >= 0.0, dim=3).to(torch.float32)

    return phong_shader(
        normals=pixel_normals,
        alphas=pixel_mask,
        pixel_positions=pixel_positions,
        light_positions=light_positions,
        light_intensities=light_intensities,
        diffuse_colors=pixel_diffuse,
        camera_position=(camera_position if specular_colors is not None
                         else None),
        specular_colors=pixel_specular,
        shininess_coefficients=shininess_for_shader,
        ambient_color=ambient_color)


class MeshRenderer(nn.Module):
    """`render` as a module: the image size and rasterizer config are fixed
    at construction; the scene tensors are the forward arguments.

    The renderer has no learned weights, so the module holds no
    parameters: whatever a caller optimises (vertices, colors, lights) is
    passed to `forward`.
    """

    def __init__(self, image_width: int, image_height: int,
                 fov_y=40.0, near_clip=0.01, far_clip=10.0, config=None):
        super().__init__()
        self.image_width = int(image_width)
        self.image_height = int(image_height)
        self.fov_y = fov_y
        self.near_clip = near_clip
        self.far_clip = far_clip
        self.config = config

    def forward(self, vertices, triangles, normals, diffuse_colors,
                camera_position, camera_lookat, camera_up, light_positions,
                light_intensities, specular_colors=None,
                shininess_coefficients=None, ambient_color=None):
        return render(vertices, triangles, normals, diffuse_colors,
                      camera_position, camera_lookat, camera_up,
                      light_positions, light_intensities, self.image_width,
                      self.image_height, specular_colors=specular_colors,
                      shininess_coefficients=shininess_coefficients,
                      ambient_color=ambient_color, fov_y=self.fov_y,
                      near_clip=self.near_clip, far_clip=self.far_clip,
                      config=self.config)

    def extra_repr(self) -> str:
        return f"image_width={self.image_width}, " \
               f"image_height={self.image_height}"
