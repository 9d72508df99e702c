"""Camera transforms of the plain reference: gluLookAt, gluPerspective and
the homogeneous transform, in float32.

`tf32=True` rounds the operands of every 4x4 product to TF32 (10 explicit
mantissa bits) before the float32 sum, as a TF32 matrix multiplication
does: the control that a lower precision must fail.
"""

from __future__ import annotations

import math

import torch


def tf32_round(x):
    """x rounded to TF32, to nearest with ties away from zero; the
    gradient passes through as the identity's."""
    bits = x.detach().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return x + (rounded - x).detach()


def bmm4(a, b, tf32=False):
    """[B, N, K] x [B, K, M] as a float32 sum over K in order."""
    if tf32:
        a, b = tf32_round(a), tf32_round(b)
    out = a[:, :, 0:1] * b[:, 0:1, :]
    for k in range(1, a.shape[2]):
        out = out + a[:, :, k:k + 1] * b[:, k:k + 1, :]
    return out


def look_at(eye, center, up, tf32=False):
    """[B, 4, 4] world-to-eye matrices."""
    forward = center - eye
    forward = forward / torch.sqrt(torch.sum(forward * forward, 1, True))
    side = torch.linalg.cross(forward, up, dim=1)
    side = side / torch.sqrt(torch.sum(side * side, 1, True))
    cam_up = torch.linalg.cross(side, forward, dim=1)
    batch = eye.shape[0]
    f32 = dict(dtype=torch.float32, device=eye.device)
    rot = torch.zeros(batch, 4, 4, **f32)
    rot[:, 0, :3], rot[:, 1, :3], rot[:, 2, :3] = side, cam_up, -forward
    rot[:, 3, 3] = 1.0
    trans = torch.eye(4, **f32).repeat(batch, 1, 1)
    trans[:, :3, 3] = -eye
    return bmm4(rot, trans, tf32)


def perspective(aspect, fov_y, near, far, batch, device):
    """[B, 4, 4] projections from right-handed eye space to clip space."""
    f32 = dict(dtype=torch.float32, device=device)
    fov = torch.full([batch], fov_y, **f32)
    near = torch.full([batch], near, **f32)
    far = torch.full([batch], far, **f32)
    focal = 1.0 / torch.tan(fov * (math.pi / 360.0))
    depth = far - near
    p = torch.zeros(batch, 4, 4, **f32)
    p[:, 0, 0] = focal / aspect
    p[:, 1, 1] = focal
    p[:, 2, 2] = -(far + near) / depth
    p[:, 2, 3] = -2.0 * (far * near / depth)
    p[:, 3, 2] = -1.0
    return p


def clip_transforms(eye, center, up, fov_y, near, far, width, height,
                    tf32=False):
    """perspective @ look_at, [B, 4, 4]."""
    proj = perspective(width / height, fov_y, near, far, eye.shape[0],
                       eye.device)
    return bmm4(proj, look_at(eye, center, up, tf32), tf32)


def to_clip(matrices, vertices, tf32=False):
    """[B, V, 4] clip-space positions of [B, V, 3] vertices."""
    ones = torch.ones(vertices.shape[:2] + (1,), dtype=torch.float32,
                      device=vertices.device)
    return bmm4(torch.cat([vertices, ones], 2), matrices.transpose(1, 2),
                tf32)
