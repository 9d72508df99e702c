"""Homogeneous edge-function math for the hard rasterizer.

Port of `pytorch_mesh_renderer_tpu/ops/barycentric.py:22-84`: the
Olano-Greer unnormalized 3x3 inverse whose sign is taken from the
determinant, so the edge functions of neighbouring triangles agree up to
sign and rasterization is crack-free without fixed-point arithmetic.
"""

from __future__ import annotations

import torch

# Below this barycentric-coordinate sum, a pixel is treated as degenerate /
# background in the backward pass.
DEGENERATE_BARYCENTRIC_CUTOFF = 0.9


def unnormalized_matrix_inverse(x: torch.Tensor, y: torch.Tensor,
                                w: torch.Tensor):
    """Sign-corrected adjugate of M = [[x0,x1,x2],[y0,y1,y2],[w0,w1,w2]].

    Args:
      x, y, w: [..., 3] f32 per-triangle vertex clip coordinates.

    Returns:
      (m_inv [..., 3, 3], det [...]). Row i of m_inv holds the coefficients
      (a, b, c) of edge function i: e_i(px, py) = a*px + b*py + c. If
      det(M) < 0 every entry is negated, so inside tests do not depend on
      orientation.
    """
    x0, x1, x2 = x[..., 0], x[..., 1], x[..., 2]
    y0, y1, y2 = y[..., 0], y[..., 1], y[..., 2]
    w0, w1, w2 = w[..., 0], w[..., 1], w[..., 2]

    m0 = y1 * w2 - w1 * y2
    m1 = x2 * w1 - w2 * x1
    m2 = x1 * y2 - y1 * x2
    m3 = y2 * w0 - w2 * y0
    m4 = x0 * w2 - w0 * x2
    m5 = x2 * y0 - y2 * x0
    m6 = y0 * w1 - w0 * y1
    m7 = x1 * w0 - w1 * x0
    m8 = x0 * y1 - y0 * x1

    det = x0 * m0 + x1 * m3 + x2 * m6
    m_inv = torch.stack([
        torch.stack([m0, m1, m2], dim=-1),
        torch.stack([m3, m4, m5], dim=-1),
        torch.stack([m6, m7, m8], dim=-1),
    ], dim=-2)
    sign = torch.where(det < 0.0, -1.0, 1.0).to(m_inv.dtype)
    return m_inv * sign[..., None, None], det


def pixel_is_inside(e0: torch.Tensor, e1: torch.Tensor,
                    e2: torch.Tensor) -> torch.Tensor:
    """Inside test: all edge values non-negative, at least one positive.

    Degenerate (zero-area) triangles always fail; a NaN edge value fails.
    """
    nonneg = (e0 >= 0.0) & (e1 >= 0.0) & (e2 >= 0.0)
    some_pos = (e0 > 0.0) | (e1 > 0.0) | (e2 > 0.0)
    return nonneg & some_pos


def ndc_pixel_centers(image_width: int, image_height: int,
                      device: torch.device | str = "cpu"):
    """NDC coordinates of pixel centers.

    Returns (px [W], py [H]) where px = (ix+0.5)/(W/2) - 1. Row 0 is the
    *bottom* of NDC space; the shading layer flips vertically at the end.
    """
    px = (torch.arange(image_width, dtype=torch.float32, device=device)
          + 0.5) / (0.5 * image_width) - 1.0
    py = (torch.arange(image_height, dtype=torch.float32, device=device)
          + 0.5) / (0.5 * image_height) - 1.0
    return px, py
