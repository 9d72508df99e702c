"""Camera and projective-geometry math.

Port of `pytorch_mesh_renderer_tpu/ops/camera.py:35-210`: XYZ Tait-Bryan
euler rotation matrices, a gluLookAt-style view matrix, a
gluPerspective-style projection, and batched homogeneous transforms.

Everything is fp32. The JAX package forces HIGHEST precision on its camera
matmuls (camera.py:131-134, 196-199) because vertex projection feeds the
edge functions whose sign decides coverage. Here the 4x4 products are
written out as sums of elementwise products, so they never take a TF32
path whatever `torch.backends.cuda.matmul.allow_tf32` says, and they round
the same way on the CPU and on the card.

`look_at` checks for degenerate cameras eagerly on every call (PyTorch has
no tracing to hide the values), raising AssertionError as the JAX
package's eager path does. The check reads the values on the host, so it
is skipped while the card's stream captures a CUDA graph (a step of
`parallel.make_train_step`), as the JAX package skips it under `jit`
(`pytorch_mesh_renderer_tpu/ops/camera.py:91-99`); every camera such a
step renders was checked in its eager warm-up. Each check that reads
counts one `host_syncs.camera` (`utils/profiling.count`).
"""

from __future__ import annotations

import math

import torch

from ..utils import profiling
from ..utils.capture import capturing

_DEGENERACY_CUTOFF = 1e-6


def _bmm4(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[B, N, K] x [B, K, M] in plain fp32, summed in order over K."""
    out = a[:, :, 0:1] * b[:, 0:1, :]
    for k in range(1, a.shape[2]):
        out = out + a[:, :, k:k + 1] * b[:, k:k + 1, :]
    return out


def euler_matrices(angles: torch.Tensor) -> torch.Tensor:
    """XYZ Tait-Bryan rotation as 4x4 matrices.

    Args:
      angles: [batch_size, 3] X, Y, Z angles in radians.

    Returns:
      [batch_size, 4, 4] f32 rotation matrices.
    """
    angles = angles.to(torch.float32)
    s = torch.sin(angles)
    c = torch.cos(angles)
    c0, c1, c2 = c[:, 0], c[:, 1], c[:, 2]
    s0, s1, s2 = s[:, 0], s[:, 1], s[:, 2]
    zeros = torch.zeros_like(s0)
    ones = torch.ones_like(s0)
    rows = [
        [c2 * c1, c2 * s1 * s0 - c0 * s2, s2 * s0 + c2 * c0 * s1, zeros],
        [c1 * s2, c2 * c0 + s2 * s1 * s0, c0 * s2 * s1 - c2 * s0, zeros],
        [-s1, c1 * s0, c1 * c0, zeros],
        [zeros, zeros, zeros, ones],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _check_not_degenerate(norm: torch.Tensor, message: str) -> None:
    if capturing(norm):
        return
    profiling.count("host_syncs.camera")
    if not bool(torch.all(norm > _DEGENERACY_CUTOFF)):
        raise AssertionError(message)


def look_at(eye: torch.Tensor, center: torch.Tensor,
            world_up: torch.Tensor) -> torch.Tensor:
    """Right-handed world->eye camera extrinsics (gluLookAt semantics).

    Args:
      eye, center, world_up: [batch_size, 3] f32 tensors on one device.

    Returns:
      [batch_size, 4, 4] f32 view matrices.

    Raises:
      AssertionError: eye and center coincide, or up is parallel to the
        gaze or zero.
    """
    eye = eye.to(torch.float32)
    center = center.to(torch.float32)
    world_up = world_up.to(torch.float32)
    batch_size = center.shape[0]

    forward = center - eye
    forward_norm = torch.sqrt(
        torch.sum(forward * forward, dim=1, keepdim=True))
    _check_not_degenerate(
        forward_norm,
        "Camera matrix is degenerate because eye and center are close.")
    forward = forward / forward_norm

    to_side = torch.linalg.cross(forward, world_up, dim=1)
    to_side_norm = torch.sqrt(
        torch.sum(to_side * to_side, dim=1, keepdim=True))
    _check_not_degenerate(
        to_side_norm,
        "Camera matrix is degenerate because up and gaze are too close or "
        "because up is degenerate.")
    to_side = to_side / to_side_norm
    cam_up = torch.linalg.cross(to_side, forward, dim=1)

    f32 = dict(dtype=torch.float32, device=eye.device)
    zeros_col = torch.zeros([batch_size, 3, 1], **f32)
    w_row = torch.cat([torch.zeros([batch_size, 1, 3], **f32),
                       torch.ones([batch_size, 1, 1], **f32)], dim=2)
    rotation = torch.stack([to_side, cam_up, -forward], dim=1)  # [B, 3, 3]
    view_rotation = torch.cat(
        [torch.cat([rotation, zeros_col], dim=2), w_row], dim=1)

    identity = torch.eye(3, **f32).expand(batch_size, 3, 3)
    view_translation = torch.cat(
        [torch.cat([identity, -eye[:, :, None]], dim=2), w_row], dim=1)
    return _bmm4(view_rotation, view_translation)


def perspective(aspect_ratio: float, fov_y: torch.Tensor,
                near_clip: torch.Tensor,
                far_clip: torch.Tensor) -> torch.Tensor:
    """Perspective projection matrices (gluPerspective semantics).

    Args:
      aspect_ratio: float, image width / height.
      fov_y: [batch_size] f32 vertical field of view in degrees.
      near_clip, far_clip: [batch_size] f32 clip plane distances.

    Returns:
      [batch_size, 4, 4] f32 matrices mapping right-handed eye space to
      left-handed clip space.
    """
    fov_y = fov_y.to(torch.float32)
    near_clip = near_clip.to(torch.float32)
    far_clip = far_clip.to(torch.float32)
    # pi/360 converts degrees to radians and halves the angle in one step.
    focal_y = 1.0 / torch.tan(fov_y * (math.pi / 360.0))
    depth_range = far_clip - near_clip
    p_22 = -(far_clip + near_clip) / depth_range
    p_23 = -2.0 * (far_clip * near_clip / depth_range)

    zeros = torch.zeros_like(p_23)
    rows = [
        [focal_y / aspect_ratio, zeros, zeros, zeros],
        [zeros, focal_y, zeros, zeros],
        [zeros, zeros, p_22, p_23],
        [zeros, zeros, -torch.ones_like(p_23), zeros],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def transform_homogeneous(matrices: torch.Tensor,
                          vertices: torch.Tensor) -> torch.Tensor:
    """Applies batched 4x4 homogeneous transforms to xyz vertices.

    Args:
      matrices: [batch_size, 4, 4] f32.
      vertices: [batch_size, N, 3] f32.

    Returns:
      [batch_size, N, 4] f32 xyzw vertices, (M [v, 1]^T)^T.
    """
    if matrices.dim() != 3:
        raise ValueError(
            "matrices must have 3 dimensions (missing batch dimension?)")
    if vertices.dim() != 3:
        raise ValueError(
            "vertices must have 3 dimensions (missing batch dimension?)")
    matrices = matrices.to(torch.float32)
    vertices = vertices.to(torch.float32)
    homogeneous = torch.cat(
        [vertices, torch.ones(vertices.shape[:2] + (1,), dtype=torch.float32,
                              device=vertices.device)], dim=2)
    return _bmm4(homogeneous, matrices.transpose(1, 2))


def clip_space_transforms(camera_position, camera_lookat, camera_up,
                          fov_y, near_clip, far_clip,
                          image_width: int, image_height: int) -> torch.Tensor:
    """perspective(fov) @ look_at(eye, center, up), [batch_size, 4, 4]."""
    with profiling.annotate("mr.camera"):
        camera_matrices = look_at(camera_position, camera_lookat, camera_up)
        perspective_transforms = perspective(
            image_width / image_height, fov_y, near_clip, far_clip)
        return _bmm4(perspective_transforms, camera_matrices)
