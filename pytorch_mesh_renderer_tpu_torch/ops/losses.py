"""Inverse-rendering losses.

Port of `pytorch_mesh_renderer_tpu/ops/losses.py:20-78`: the shape-fitting
regularizers of the multi-view silhouette fit (mean edge length and
uniform-weight Laplacian smoothing) and the image losses of the
optimization loops. The Laplacian's neighbour sum and degree are two
`index_add_` scatters, as they are two scatter-adds in the JAX package.
"""

from __future__ import annotations

import torch


def edge_loss(vertices: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """Mean edge length of a single mesh.

    Args:
      vertices: [V, 3] f32.
      edges: [E, 2] int unique undirected edges (mesh.compute_edges_list).
    """
    edges = edges.long()
    d = vertices[edges[:, 0]] - vertices[edges[:, 1]]
    return torch.mean(torch.sqrt(torch.sum(d * d, dim=1)))


def laplacian_smoothing_loss(vertices: torch.Tensor,
                             edges: torch.Tensor) -> torch.Tensor:
    """Uniform-weight Laplacian smoothing objective of a single mesh.

    (L v)_i = mean of the neighbours of v_i minus v_i; the loss is
    sum_i ||(L v)_i|| / V.

    Args:
      vertices: [V, 3] f32.
      edges: [E, 2] int unique undirected edges.
    """
    n_vertices = vertices.shape[0]
    edges = edges.long()
    e0, e1 = edges[:, 0], edges[:, 1]
    neighbor_sum = torch.zeros_like(vertices)
    neighbor_sum.index_add_(0, e0, vertices[e1])
    neighbor_sum.index_add_(0, e1, vertices[e0])
    ones = torch.ones(e0.shape, dtype=vertices.dtype, device=vertices.device)
    degree = torch.zeros(n_vertices, dtype=vertices.dtype,
                         device=vertices.device)
    degree.index_add_(0, e0, ones)
    degree.index_add_(0, e1, ones)
    inv_degree = torch.where(degree > 0.0,
                             1.0 / torch.clamp(degree, min=1.0), 0.0)
    lap = neighbor_sum * inv_degree[:, None] - vertices
    return torch.sum(torch.sqrt(torch.sum(lap * lap, dim=1))) / n_vertices


def image_l1_loss(rendered: torch.Tensor,
                  target: torch.Tensor) -> torch.Tensor:
    """Mean absolute pixel error."""
    return torch.mean(torch.abs(rendered - target))


def silhouette_mse_loss(rendered_alpha: torch.Tensor,
                        target_alpha: torch.Tensor) -> torch.Tensor:
    """Mean squared silhouette error."""
    return torch.mean((rendered_alpha - target_alpha) ** 2)


def silhouette_iou(rendered_alpha: torch.Tensor, target_alpha: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """Soft intersection-over-union of two [0, 1] silhouettes."""
    inter = torch.sum(rendered_alpha * target_alpha)
    union = torch.sum(rendered_alpha) + torch.sum(target_alpha) - inter
    return inter / torch.clamp(union, min=eps)
