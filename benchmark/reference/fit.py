"""The multi-view fit's objective and optimizer, plain: the unique edges of
a mesh, the mean edge length, the uniform Laplacian, the silhouette MSE and
Adam (Kingma and Ba 2015, with PyTorch's eps outside the square root of
the bias-corrected second moment)."""

from __future__ import annotations

import numpy as np
import torch

from . import soft


def unique_edges(faces):
    """[E, 2] int64: the pairs (v0, v1), (v1, v2), (v0, v2) of every face,
    each ordered pair once, sorted."""
    f = faces.detach().cpu().numpy().astype(np.int64)
    pairs = np.concatenate([f[:, :2], f[:, 1:], f[:, ::2]]).reshape(-1, 2)
    return torch.as_tensor(np.unique(pairs, axis=0), device=faces.device)


def edge_loss(vertices, edges):
    d = vertices[edges[:, 0]] - vertices[edges[:, 1]]
    return torch.mean(torch.sqrt(torch.sum(d * d, 1)))


def laplacian_loss(vertices, edges):
    """sum_i |mean of v_i's neighbours - v_i| / V, a vertex's neighbours
    being the other ends of the edges it is an end of."""
    n = vertices.shape[0]
    nsum = torch.zeros_like(vertices).index_add(
        0, edges[:, 0], vertices[edges[:, 1]]).index_add(
        0, edges[:, 1], vertices[edges[:, 0]])
    degree = torch.bincount(edges.reshape(-1), minlength=n).to(
        vertices.dtype)
    inv = torch.where(degree > 0, 1.0 / torch.clamp(degree, min=1.0), 0.0)
    lap = nsum * inv[:, None] - vertices
    return torch.sum(torch.sqrt(torch.sum(lap * lap, 1))) / n


class Adam:
    """Adam on one tensor, float32."""

    def __init__(self, lr, betas, eps):
        self.lr, (self.b1, self.b2), self.eps = lr, betas, eps
        self.m = self.v = None
        self.t = 0

    def step(self, param, grad):
        if self.m is None:
            self.m, self.v = torch.zeros_like(param), torch.zeros_like(param)
        self.t += 1
        self.m = self.b1 * self.m + (1.0 - self.b1) * grad
        self.v = self.b2 * self.v + (1.0 - self.b2) * grad * grad
        c1 = 1.0 - self.b1 ** self.t
        c2 = 1.0 - self.b2 ** self.t
        denom = torch.sqrt(self.v) / (c2 ** 0.5) + self.eps
        return param - (self.lr / c1) * self.m / denom


def fit_loss_and_grad(problem, offsets, fit, size, fov_y, near, far, sigma,
                      blur, tf32=False, counts=None, views=None):
    """(loss, gradient [V, 3], silhouettes [N, S, S]) of the fit at
    `offsets`: silhouette MSE over the views plus the weighted edge and
    Laplacian losses. `views` (default all) renders a subset, whose MSE
    is the mean over it."""
    weights = fit["loss"]
    sel = slice(None) if views is None else views
    eye, center, up = (problem[k][sel] for k in ("eye", "center", "up"))
    target = problem["targets"][sel]
    n = target.numel()
    x = offsets.detach().clone().requires_grad_(True)
    verts = problem["vertices"] + x
    batch = eye.shape[0]

    def pixel_loss(alpha, _rgb, b, r, c):
        return weights["silhouette_mse"] * torch.sum(
            (alpha - target[b, r, c]) ** 2) / n

    view_verts = verts[None].expand(batch, -1, -1)
    alpha = soft.render(view_verts, problem["faces"], None, eye, center, up,
                        None, None, size, fov_y, near, far, sigma, 1.0,
                        blur, shade=False, tf32=tf32, pixel_loss=pixel_loss,
                        counts=counts)
    edges = problem["ref_edges"]
    reg = (weights["edge"] * edge_loss(verts, edges)
           + weights["laplacian"] * laplacian_loss(verts, edges))
    reg.backward()
    sil = weights["silhouette_mse"] * torch.mean((alpha - target) ** 2)
    return float(sil + reg.detach()), x.grad.detach(), alpha
