"""Inverse-rendering losses.

Port of `pytorch_mesh_renderer_tpu/ops/losses.py:20-78`: the shape-fitting
regularizers of the multi-view silhouette fit (mean edge length and
uniform-weight Laplacian smoothing) and the image losses of the
optimization loops. The Laplacian's neighbour sum is one scatter-add over
the edges' two ends, as it is two scatter-adds in the JAX package; here it
and the gathers of both losses go through `ops/mesh.py`'s deterministic
`segment_sum` and `gather`, whose plan comes from the edges tensor, so a
fit's gradient has the same bits on every run.
"""

from __future__ import annotations

import torch

from .mesh import gather, segment_sum, vertex_plan


def edge_loss(vertices: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """Mean edge length of a single mesh.

    Args:
      vertices: [V, 3] f32.
      edges: [E, 2] int unique undirected edges (mesh.compute_edges_list).
    """
    ends = gather(vertices, edges)  # [E, 2, 3]
    d = ends[:, 0] - ends[:, 1]
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
    # Each end of an edge takes the other end: position (i, 0) of the
    # edges sums vertex edges[i, 1], and (i, 1) sums edges[i, 0].
    neighbor_sum = segment_sum(gather(vertices, edges).flip(1), edges,
                               n_vertices)
    degree = vertex_plan(edges, n_vertices).degree.to(vertices.dtype)
    inv_degree = torch.where(degree > 0.0,
                             1.0 / torch.clamp(degree, min=1.0), 0.0)
    lap = neighbor_sum * inv_degree[:, None] - vertices
    return torch.sum(torch.sqrt(torch.sum(lap * lap, dim=1))) / n_vertices


def image_l1_loss(rendered: torch.Tensor,
                  target: torch.Tensor) -> torch.Tensor:
    """Mean absolute pixel error.

    Where a pixel equals its target the derivative is +1 / N, as
    `jnp.abs`'s is (torch.abs's is 0 there).
    """
    diff = rendered - target
    return torch.mean(torch.where(diff >= 0.0, diff, -diff))


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
