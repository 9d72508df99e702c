"""Inverse-rendering losses.

Port of `pytorch_mesh_renderer_tpu/ops/losses.py:20-78`: the shape-fitting
regularizers of the multi-view silhouette fit (mean edge length and
uniform-weight Laplacian smoothing) and the image losses of the
optimization loops. The Laplacian's neighbour sum is one scatter-add over
the edges' two ends, as it is two scatter-adds in the JAX package; here it
and the gathers of both losses go through `ops/mesh.py`'s deterministic
`segment_sum` and `gather`, whose plan comes from the edges tensor, so a
fit's gradient has the same bits on every run.

The batched losses of SoftRas's single-view reconstruction
(`examples/recon.py`; Liu et al. 2019, `soft_renderer/losses.py`) take a
batch of meshes [B, V, 3] or silhouettes [B, H, W]: `iou_loss`,
`squared_laplacian_loss` and `flatten_loss`. Their gathers and sums go
through the same `gather` and `segment_sum`, and none reads a value on
the host, so a captured step may call them.
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
    lap = _uniform_laplacian(vertices, edges)
    return torch.sum(torch.sqrt(torch.sum(lap * lap, dim=1))) / len(vertices)


def _uniform_laplacian(vertices, edges):
    """(L v)_i = the mean of v_i's neighbours minus v_i, [..., V, 3]."""
    n_vertices = vertices.shape[-2]
    # Each end of an edge takes the other end: position (i, 0) of the
    # edges sums vertex edges[i, 1], and (i, 1) sums edges[i, 0].
    neighbor_sum = segment_sum(gather(vertices, edges).flip(-2), edges,
                               n_vertices)
    degree = vertex_plan(edges, n_vertices).degree.to(vertices.dtype)
    inv_degree = torch.where(degree > 0.0,
                             1.0 / torch.clamp(degree, min=1.0), 0.0)
    return neighbor_sum * inv_degree[:, None] - vertices


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


def iou_loss(predicted: torch.Tensor, target: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """SoftRas's IoU loss of a batch of silhouettes [B, H, W]:
    1 - mean_b(sum(p t) / (sum(p + t - p t) + eps)), the sums over each
    image's pixels."""
    inter = torch.sum(predicted * target, dim=(1, 2))
    union = torch.sum(predicted + target - predicted * target,
                      dim=(1, 2)) + eps
    return 1.0 - torch.mean(inter / union)


def squared_laplacian_loss(vertices: torch.Tensor,
                           edges: torch.Tensor) -> torch.Tensor:
    """SoftRas's Laplacian loss, averaged over a batch of meshes.

    For each mesh, sum_i ||v_i - mean_{j in N(i)} v_j||^2, N(i) the
    vertices that share an edge with v_i (the squared form; the cow fit's
    `laplacian_smoothing_loss` sums the norms unsquared over one mesh).

    Args:
      vertices: [B, V, 3] f32.
      edges: [E, 2] int, each undirected edge once (such as
        `mesh.compute_edge_wings(triangles)[:, :2]`).
    """
    lap = _uniform_laplacian(vertices, edges)
    return torch.mean(torch.sum(lap * lap, dim=(1, 2)))


def flatten_loss(vertices: torch.Tensor, wings: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """SoftRas's flatten loss, averaged over a batch of meshes.

    For each mesh, sum over its edges (a, b) with opposite vertices c and
    d of (cos theta + 1)^2, theta the angle between the two triangles'
    heights from the edge (the components of c - a and d - a normal to
    b - a): 0 where the two triangles lie flat, 4 where they fold onto
    each other. `eps` enters where SoftRas's code adds it.

    Args:
      vertices: [B, V, 3] f32.
      wings: [E, 4] int rows (a, b, c, d) (`mesh.compute_edge_wings`).
    """
    corners = gather(vertices, wings)  # [B, E, 4, 3]
    v0, v1, v2, v3 = corners.unbind(2)
    a = v1 - v0
    a_l2 = torch.sum(a * a, dim=-1)
    a_l1 = torch.sqrt(a_l2 + eps)

    def height(b):
        b_l2 = torch.sum(b * b, dim=-1)
        b_l1 = torch.sqrt(b_l2 + eps)
        ab = torch.sum(a * b, dim=-1)
        cos = ab / (a_l1 * b_l1 + eps)
        sin = torch.sqrt(1.0 - cos * cos + eps)
        return b - a * (ab / (a_l2 + eps))[..., None], b_l1 * sin

    h1, h1_l1 = height(v2 - v0)
    h2, h2_l1 = height(v3 - v0)
    cos = torch.sum(h1 * h2, dim=-1) / (h1_l1 * h2_l1 + eps)
    return torch.mean(torch.sum((cos + 1.0) ** 2, dim=1))
