"""Mesh geometry ops.

Port of `pytorch_mesh_renderer_tpu/ops/mesh.py`: area-weighted per-vertex
normals, accumulated with `index_add_`, and the unique edge list of a mesh.
"""

from __future__ import annotations

import numpy as np
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


def compute_edges_list(triangles) -> torch.Tensor:
    """Unique undirected edges of a triangle mesh.

    The pairs (v0, v1), (v1, v2), (v0, v2) of every face, deduplicated as
    ordered pairs and sorted, as `pytorch_mesh_renderer_tpu/ops/mesh.py:50`
    does. Computed on the host: it waits for the card and copies the
    triangles there and back, so it belongs in a loss's setup, outside a
    step that `parallel.make_train_step` captures into a CUDA graph (such
    a capture raises on the copy).

    Args:
      triangles: [triangle_count, 3] int tensor or array.

    Returns:
      [edge_count, 2] int32 tensor of unique edges, on the device of
      `triangles` (the CPU for an array).
    """
    device = triangles.device if torch.is_tensor(triangles) else "cpu"
    tris = (triangles.cpu().numpy() if torch.is_tensor(triangles)
            else np.asarray(triangles))
    edges = np.concatenate(
        [tris[:, :2], tris[:, 1:], tris[:, ::2]], axis=0).reshape(-1, 2)
    edges = np.unique(edges, axis=0).astype(np.int32)
    return torch.from_numpy(edges).to(device)
