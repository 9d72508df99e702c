"""The plain reference of SoftRas's single-view reconstruction step (Liu et
al. 2019, `examples/recon`): the network's equations, the losses, the
silhouettes and Adam, in float32 with TF32 off.

The network runs from a dict of parameters (the port's module names),
BatchNorm in training mode. Its layers are the plain `torch` calls
(`F.conv2d`, `F.batch_norm`, `F.linear`) in SoftRas's order, which on the
card run with TF32 off (`strict_float32`): so the reference decodes the
meshes the program decodes from the same parameters to the same bits,
and no ReLU, and no triangle that faces the camera edge-on, is decided
one way in the program and the other in the reference by rounding alone
(either would flip a gradient term or a silhouette's sliver).
`tf32=True` rounds the operands of every convolution and product, and the
camera's, to TF32 before the float32 sum, as a TF32 unit does: the control
that a lower precision must fail. The silhouettes are `soft.render`'s
(`shade=False`), tile by tile. The IoU loss is not a sum over pixels, so
its gradient reaches the silhouettes in two passes: the first renders
them and gives each image's intersection I and union U; the second
renders again with the loss's derivative at each pixel,
-(t / U - I (1 - t) / U^2) / M for M images, as the per-pixel weight of
the alpha it adds into the vertices' gradient. The Laplacian and flatten
losses are SoftRas's forms (`soft_renderer/losses.py`), the flatten loss
over every edge.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import fit, soft
from .camera import tf32_round

BN_EPS = 1e-5
BN_MOMENTUM = 0.1
CONV_BIASES = ("encoder.conv1.bias", "encoder.conv2.bias",
               "encoder.conv3.bias")


def strict_float32():
    """TF32 off for products and convolutions, process-wide."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _round(x, tf32):
    return tf32_round(x) if tf32 else x


def _linear(p, name, x, tf32):
    return F.linear(_round(x, tf32), _round(p[name + ".weight"], tf32),
                    p[name + ".bias"])


def encode(p, images, tf32=False):
    """[N, 4, S, S] in [0, 1] -> features [N, dim_out]."""
    x = images
    for i in (1, 2, 3):
        x = F.conv2d(_round(x, tf32),
                     _round(p[f"encoder.conv{i}.weight"], tf32),
                     p[f"encoder.conv{i}.bias"], stride=2, padding=2)
        channels = x.shape[1]
        x = F.relu(F.batch_norm(
            x, torch.zeros(channels, device=x.device),
            torch.ones(channels, device=x.device),
            p[f"encoder.bn{i}.weight"], p[f"encoder.bn{i}.bias"], True,
            BN_MOMENTUM, BN_EPS))
    x = x.flatten(1)
    for i in (1, 2, 3):
        x = F.relu(_linear(p, f"encoder.fc{i}", x, tf32))
    return x


def decode(p, features, template, decoder, tf32=False):
    """Features [N, F] -> vertices [N, V, 3] (SoftRas's Decoder)."""
    h = F.relu(_linear(p, "decoder.fc2", F.relu(
        _linear(p, "decoder.fc1", features, tf32)), tf32))
    centroid = _linear(p, "decoder.fc_centroid", h, tf32) * decoder[
        "centroid_scale"]
    bias = (_linear(p, "decoder.fc_bias", h, tf32)
            * decoder["bias_scale"]).view(h.shape[0], -1, 3)
    base = template * decoder["obj_scale"]
    sign = torch.sign(base)
    base = torch.abs(base)
    base = torch.log(base / (1 - base))
    centroid = torch.tanh(centroid[:, None, :])
    v = torch.sigmoid(base + bias) * sign
    v = F.relu(v) * (1 - centroid) - F.relu(-v) * (centroid + 1)
    return (v + centroid) * 0.5


def edge_wings(faces):
    """[E, 4] int64 (a, b, c, d): each edge (a < b) and the third vertices
    of the two faces that hold it, by a loop over the faces."""
    found = {}
    for face in np.asarray(faces.cpu(), np.int64).tolist():
        for k in range(3):
            a, b, c = face[k], face[(k + 1) % 3], face[(k + 2) % 3]
            found.setdefault((min(a, b), max(a, b)), []).append(c)
    return torch.tensor([[a, b] + found[(a, b)] for a, b in sorted(found)],
                        device=faces.device)


def laplacian_loss(vertices, edges):
    """Mean over meshes [B, V, 3] of sum_i |v_i - mean of its
    neighbours|^2 (SoftRas's LaplacianLoss)."""
    n = vertices.shape[1]
    nsum = torch.zeros_like(vertices).index_add(
        1, edges[:, 0], vertices[:, edges[:, 1]]).index_add(
        1, edges[:, 1], vertices[:, edges[:, 0]])
    degree = torch.bincount(edges.reshape(-1), minlength=n).to(vertices)
    lap = vertices - nsum / degree[None, :, None]
    return (lap * lap).sum((1, 2)).mean()


def flatten_loss(vertices, wings, eps=1e-6):
    """Mean over meshes of SoftRas's FlattenLoss."""
    v0, v1, v2, v3 = (vertices[:, wings[:, k]] for k in range(4))
    a = v1 - v0
    al2 = a.pow(2).sum(-1)
    al1 = (al2 + eps).sqrt()

    def height(b):
        bl2 = b.pow(2).sum(-1)
        bl1 = (bl2 + eps).sqrt()
        ab = (a * b).sum(-1)
        cos = ab / (al1 * bl1 + eps)
        sin = (1 - cos.pow(2) + eps).sqrt()
        return b - a * (ab / (al2 + eps))[:, :, None], bl1 * sin

    h1, l1 = height(v2 - v0)
    h2, l2 = height(v3 - v0)
    cos = (h1 * h2).sum(-1) / (l1 * l2 + eps)
    return (cos + 1).pow(2).sum(1).mean()


def _render(vertices, faces, eyes, sc, tf32, pixel_loss=None, counts=None):
    zeros = torch.zeros_like(eyes)
    up = torch.tensor(sc["up"], dtype=torch.float32,
                      device=eyes.device).expand_as(eyes)
    return soft.render(vertices, faces, None, eyes, zeros, up, None, None,
                       sc["image_size"], sc["fov_y"], sc["near_clip"],
                       sc["far_clip"], sc["sigma"], 1.0, sc["blur_radius"],
                       shade=False, tf32=tf32, pixel_loss=pixel_loss,
                       counts=counts)


def render_groups(vertices, batch):
    """(meshes [4n, V, 3], eyes [4n, 3], targets [4n, S, S]) of the four
    groups: mesh_a at a, mesh_b at a, mesh_a at b, mesh_b at b."""
    n = vertices.shape[0] // 2
    a, b = vertices[:n], vertices[n:]
    ea, eb = batch["eyes"][:n], batch["eyes"][n:]
    alpha = batch["images"][:, 3].to(torch.float32) / 255
    ta, tb = alpha[:n], alpha[n:]
    return (torch.cat([a, b, a, b]), torch.cat([ea, ea, eb, eb]),
            torch.cat([ta, ta, tb, tb]))


def step(p, batch, template, faces, config, grad=True, tf32=False,
         counts=None):
    """(loss, {name: gradient} or None, silhouettes [4n, S, S]) of one
    training step's loss at parameters `p` on `batch` ({"images": [2n, 4,
    S, S] uint8, "eyes": [2n, 3]}, viewpoint a's first)."""
    sc, loss_cfg = config["scene"], config["loss"]
    decoder = config["network"]["decoder"]
    wings = edge_wings(faces)
    leaf = {k: v.detach().clone().requires_grad_(grad) for k, v in p.items()}
    images = batch["images"].to(torch.float32) / 255
    with torch.set_grad_enabled(grad):
        vertices = decode(leaf, encode(leaf, images, tf32), template,
                          decoder, tf32)
        reg = (loss_cfg["laplacian"] * laplacian_loss(vertices, wings[:, :2])
               + loss_cfg["flatten"] * flatten_loss(vertices, wings))
    meshes, eyes, target = render_groups(vertices.detach(), batch)
    alpha = _render(meshes, faces, eyes, sc, tf32, counts=counts)
    inter = (alpha * target).sum((1, 2))
    union = (alpha + target - alpha * target).sum((1, 2)) + loss_cfg[
        "iou_eps"]
    m = alpha.shape[0]
    iou = loss_cfg["iou"] * (1 - (inter / union).sum() / m)
    loss = float(iou + reg.detach())
    if not grad:
        return loss, None, alpha
    weight = -loss_cfg["iou"] * (target / union[:, None, None] - (
        inter / union ** 2)[:, None, None] * (1 - target)) / m
    vleaf = meshes.clone().requires_grad_(True)

    def pixel_loss(a, _rgb, b, r, c):
        return torch.sum(a * weight[b, r, c])

    _render(vleaf, faces, eyes, sc, tf32, pixel_loss=pixel_loss)
    n = vertices.shape[0] // 2
    g = vleaf.grad
    d_vertices = torch.cat([g[:n] + g[2 * n:3 * n], g[n:2 * n] + g[3 * n:]])
    (reg + (vertices * d_vertices).sum()).backward()
    return loss, {k: v.grad for k, v in leaf.items()}, alpha


class Adam:
    """`fit.Adam` (PyTorch's Adam, float32) on each tensor of a dict."""

    def __init__(self, lr, betas, eps):
        self.lr, self.betas, self.eps = lr, betas, eps
        self.each = {}

    def step(self, params, grads):
        return {name: self.each.setdefault(
            name, fit.Adam(self.lr, self.betas, self.eps)).step(x, grads[name])
            for name, x in params.items()}
