"""Mesh geometry ops.

Port of `pytorch_mesh_renderer_tpu/ops/mesh.py:17-47`: area-weighted
per-vertex normals, accumulated with `index_add_`.
"""

from __future__ import annotations

import torch

from .math_utils import normalize


def compute_vertex_normals(vertices: torch.Tensor,
                           triangles: torch.Tensor) -> torch.Tensor:
    """Area-weighted vertex normals from face geometry.

    Face normals (scaled by 2x face area) are accumulated onto each incident
    vertex, one corner at a time, and the result is L2-normalized.

    Args:
      vertices: [batch_size, vertex_count, 3] f32 world-space positions.
      triangles: [triangle_count, 3] int vertex indices on the same device.

    Returns:
      [batch_size, vertex_count, 3] f32 unit normal vectors.
    """
    vertices = vertices.to(torch.float32)
    tris = triangles.long()
    face_vertices = vertices[:, tris, :]  # [B, T, 3(corner), 3(xyz)]
    v0 = face_vertices[:, :, 0]
    v1 = face_vertices[:, :, 1]
    v2 = face_vertices[:, :, 2]
    corner_normals = (torch.linalg.cross(v1 - v0, v2 - v0, dim=-1),
                      torch.linalg.cross(v2 - v1, v0 - v1, dim=-1),
                      torch.linalg.cross(v0 - v2, v1 - v2, dim=-1))

    normals = torch.zeros_like(vertices)
    for k, contribution in enumerate(corner_normals):
        normals.index_add_(1, tris[:, k], contribution)
    return normalize(normals, p=2, dim=-1, eps=1e-6)
