"""The plain reference of SoftRas's single-view reconstruction step (Liu et
al. 2019, `examples/recon`), for the tests of
`pytorch_mesh_renderer_tpu_torch/examples/recon.py`.

Plain float32 `torch` in one file: it imports no kernel and no module of
the port, and no JAX. On a card it turns TF32 off and asks cuDNN for
deterministic algorithms (`strict_float32`). It holds:

  * the network's equations over a dict of parameters named as the port's
    module names them (`encoder.conv1.weight`, ...), BatchNorm in training
    mode (the batch's statistics);
  * the cameras (gluLookAt, gluPerspective) and a dense SoftRas silhouette
    over every (pixel, triangle) pair, gated as the port's renderer gates
    a pair (front-facing, inside or within the blur radius, inside the
    blurred box), recomputed triangle chunk by chunk in the backward so
    that its memory stays at one chunk's graph;
  * SoftRas's losses in its own forms: the IoU loss of each of the four
    render groups, the Laplacian as the dense matrix of
    `soft_renderer/losses.py` and the flatten loss over edge wings found
    by a loop over the faces;
  * Adam, as PyTorch's (eps outside the square root of the bias-corrected
    second moment).

Departures from SoftRas, as the port's: its cameras and blur radius (see
the port's module), the icosphere template's vertex order, and the
flatten loss over every edge.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

BN_EPS = 1e-5


def strict_float32():
    """TF32 off and cuDNN deterministic, process-wide."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


# ---- the network -------------------------------------------------------


def _batch_norm(x, weight, bias):
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = ((x - mean) ** 2).mean(dim=(0, 2, 3), keepdim=True)
    return ((x - mean) / torch.sqrt(var + BN_EPS) * weight[None, :, None, None]
            + bias[None, :, None, None])


def encode(p, images):
    """[N, 4, S, S] f32 in [0, 1] -> features [N, dim_out]."""
    x = images
    for i in (1, 2, 3):
        x = F.conv2d(x, p[f"encoder.conv{i}.weight"],
                     p[f"encoder.conv{i}.bias"], stride=2, padding=2)
        x = F.relu(_batch_norm(x, p[f"encoder.bn{i}.weight"],
                               p[f"encoder.bn{i}.bias"]))
    x = x.reshape(x.shape[0], -1)
    for i in (1, 2, 3):
        x = F.relu(x @ p[f"encoder.fc{i}.weight"].T
                   + p[f"encoder.fc{i}.bias"])
    return x


def decode(p, features, template, centroid_scale=0.1, bias_scale=1.0,
           obj_scale=0.5):
    """Features [N, F] -> vertices [N, V, 3] (SoftRas's Decoder)."""
    def fc(name, x):
        return x @ p[f"decoder.{name}.weight"].T + p[f"decoder.{name}.bias"]

    h = F.relu(fc("fc2", F.relu(fc("fc1", features))))
    centroid = torch.tanh(fc("fc_centroid", h) * centroid_scale)[:, None, :]
    bias = (fc("fc_bias", h) * bias_scale).reshape(h.shape[0], -1, 3)
    base = template * obj_scale
    sign = torch.sign(base)
    base = torch.abs(base)
    base = torch.log(base / (1 - base))
    v = torch.sigmoid(base + bias) * sign
    v = F.relu(v) * (1 - centroid) - F.relu(-v) * (centroid + 1)
    return (v + centroid) * 0.5


# ---- cameras and the dense silhouette ---------------------------------


def clip_matrices(eyes, fov_y, near, far):
    """[N, 4, 4] perspective @ look_at(eye, origin, +y), square images."""
    n = eyes.shape[0]
    forward = -eyes / eyes.norm(dim=1, keepdim=True)
    up = torch.tensor([0.0, 1.0, 0.0]).to(eyes).expand(n, 3)
    side = torch.linalg.cross(forward, up, dim=1)
    side = side / side.norm(dim=1, keepdim=True)
    cam_up = torch.linalg.cross(side, forward, dim=1)
    view = torch.zeros(n, 4, 4).to(eyes)
    view[:, 0, :3], view[:, 1, :3], view[:, 2, :3] = side, cam_up, -forward
    view[:, :3, 3] = -torch.einsum("nij,nj->ni", view[:, :3, :3], eyes)
    view[:, 3, 3] = 1.0
    focal = 1.0 / math.tan(math.radians(fov_y) / 2)
    proj = torch.zeros(4, 4).to(eyes)
    proj[0, 0] = proj[1, 1] = focal
    proj[2, 2] = -(far + near) / (far - near)
    proj[2, 3] = -2.0 * far * near / (far - near)
    proj[3, 2] = -1.0
    return proj @ view


def _chunk_keep(ndc, faces, px, py, sigma, blur):
    """prod over the chunk's triangles of (1 - coverage) [N, S, S]: the
    coverage sigmoid(+-d^2 / sigma) of each gated (pixel, triangle) pair,
    d the distance to the triangle's nearest edge, + inside. The depth
    gate is left out: every mesh of the tests lies between the near and
    far planes, where it passes."""
    tri = ndc[:, faces]  # [N, C, 3, 2]
    x, y = (tri[..., k][..., None, None] for k in range(2))  # [N, C, 3, 1, 1]
    px, py = px[None, None], py[None, None]
    x0, x1, x2 = x.unbind(2)
    y0, y1, y2 = y.unbind(2)
    area = (x0 - x1) * (y2 - y1) - (y0 - y1) * (x2 - x1)
    front = area < 0
    det = x0 * (y1 - y2) - x1 * (y0 - y2) + x2 * (y0 - y1)
    det = torch.where(det != 0, det, torch.ones_like(det))
    w0 = ((y1 - y2) * px + (x2 - x1) * py + (x1 * y2 - x2 * y1)) / det
    w1 = ((y2 - y0) * px + (x0 - x2) * py + (x2 * y0 - x0 * y2)) / det
    w2 = ((y0 - y1) * px + (x1 - x0) * py + (x0 * y1 - x1 * y0)) / det
    inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)

    def segment(ax, ay, bx, by):
        abx, aby = bx - ax, by - ay
        t = (((px - ax) * abx + (py - ay) * aby)
             / (abx * abx + aby * aby).clamp(min=1e-24)).clamp(0, 1)
        dx, dy = ax + t * abx - px, ay + t * aby - py
        return dx * dx + dy * dy

    d2 = torch.minimum(torch.minimum(segment(x0, y0, x1, y1),
                                     segment(x1, y1, x2, y2)),
                       segment(x2, y2, x0, y0))
    in_box = ((px >= x.amin(2) - blur) & (px <= x.amax(2) + blur)
              & (py >= y.amin(2) - blur) & (py <= y.amax(2) + blur))
    gate = front & in_box & (inside | (d2 <= blur * blur))
    coverage = torch.sigmoid(torch.where(inside, d2, -d2) / sigma)
    keep = torch.where(gate, 1 - coverage, torch.ones_like(coverage))
    return torch.prod(keep, dim=1)


def silhouettes(vertices, faces, eyes, size, fov_y, near, far, sigma, blur,
                chunk=128):
    """[N, S, S] SoftRas alpha 1 - prod(1 - coverage) of meshes [N, V, 3]
    (CCW faces [T, 3]) seen from `eyes` [N, 3], rows top-down."""
    matrices = clip_matrices(eyes, fov_y, near, far)
    ones = torch.ones(vertices.shape[:2] + (1,)).to(vertices)
    clip = torch.cat([vertices, ones], 2) @ matrices.transpose(1, 2)
    ndc = clip[..., :2] / clip[..., 3:]
    centres = (torch.arange(size).to(vertices) + 0.5) * 2 / size - 1
    px, py = centres[None, :], -centres[:, None]
    faces = faces.long()
    keep = 1
    for start in range(0, faces.shape[0], chunk):
        keep = keep * checkpoint(
            _chunk_keep, ndc, faces[start:start + chunk], px, py, sigma,
            blur, use_reentrant=False)
    return 1 - keep


# ---- the losses -------------------------------------------------------


def iou_loss(predict, target, eps=1e-6):
    """SoftRas's `iou_loss`: 1 - mean over the images of I / (U + eps)."""
    intersect = (predict * target).sum((1, 2))
    union = (predict + target - predict * target).sum((1, 2)) + eps
    return 1 - (intersect / union).sum() / intersect.numel()


def multiview_iou_loss(groups, target_a, target_b):
    """SoftRas's `multiview_iou_loss` of the four render groups."""
    return (iou_loss(groups[0], target_a) + iou_loss(groups[1], target_a)
            + iou_loss(groups[2], target_b) + iou_loss(groups[3], target_b)) / 4


def laplacian_matrix(faces, vertex_count):
    """SoftRas's LaplacianLoss matrix: 1 on the diagonal, -1 / deg(i) at
    each neighbour j of i."""
    lap = np.zeros([vertex_count, vertex_count], np.float32)
    f = np.asarray(faces, np.int64)
    for a, b in ((0, 1), (1, 0), (1, 2), (2, 1), (2, 0), (0, 2)):
        lap[f[:, a], f[:, b]] = -1
    degree = -lap.sum(1)
    lap[np.arange(vertex_count), np.arange(vertex_count)] = degree
    return torch.from_numpy(lap / degree[:, None])


def laplacian_loss(vertices, lap):
    """Mean over the meshes of sum((L v)^2)."""
    return (torch.matmul(lap, vertices) ** 2).sum((1, 2)).mean()


def edge_wings(faces):
    """[E, 4] (a, b, c, d): each edge and the third vertices of its two
    faces, found by a loop over the faces (SoftRas's FlattenLoss setup)."""
    found = {}
    for face in np.asarray(faces, np.int64).tolist():
        for k in range(3):
            a, b, c = face[k], face[(k + 1) % 3], face[(k + 2) % 3]
            found.setdefault((min(a, b), max(a, b)), []).append(c)
    return torch.tensor([[a, b] + found[(a, b)] for a, b in sorted(found)])


def flatten_loss(vertices, wings, eps=1e-6):
    """SoftRas's FlattenLoss, mean over the meshes."""
    v0, v1, v2, v3 = (vertices[:, wings[:, k]] for k in range(4))
    a1 = v1 - v0
    b1 = v2 - v0
    a1l2 = a1.pow(2).sum(-1)
    b1l2 = b1.pow(2).sum(-1)
    a1l1 = (a1l2 + eps).sqrt()
    b1l1 = (b1l2 + eps).sqrt()
    ab1 = (a1 * b1).sum(-1)
    cos1 = ab1 / (a1l1 * b1l1 + eps)
    sin1 = (1 - cos1.pow(2) + eps).sqrt()
    c1 = a1 * (ab1 / (a1l2 + eps))[:, :, None]
    cb1 = b1 - c1
    cb1l1 = b1l1 * sin1
    a2 = v1 - v0
    b2 = v3 - v0
    a2l2 = a2.pow(2).sum(-1)
    b2l2 = b2.pow(2).sum(-1)
    a2l1 = (a2l2 + eps).sqrt()
    b2l1 = (b2l2 + eps).sqrt()
    ab2 = (a2 * b2).sum(-1)
    cos2 = ab2 / (a2l1 * b2l1 + eps)
    sin2 = (1 - cos2.pow(2) + eps).sqrt()
    c2 = a2 * (ab2 / (a2l2 + eps))[:, :, None]
    cb2 = b2 - c2
    cb2l1 = b2l1 * sin2
    cos = (cb1 * cb2).sum(-1) / (cb1l1 * cb2l1 + eps)
    return (cos + 1).pow(2).sum(1).mean()


# ---- the step ---------------------------------------------------------


def step_loss(p, batch, template, faces, settings):
    """(loss, silhouettes [4n, S, S]) of one step: `batch` as the port's
    Loader gives it, `settings` a dict of size, fov_y, near, far, sigma,
    blur, lambda_laplacian, lambda_flatten."""
    s = settings
    images = batch["images"].to(torch.float32) / 255
    vertices = decode(p, encode(p, images), template)
    n = vertices.shape[0] // 2
    mesh_a, mesh_b = vertices[:n], vertices[n:]
    eye_a, eye_b = batch["eyes"][:n], batch["eyes"][n:]
    alpha = silhouettes(torch.cat([mesh_a, mesh_b, mesh_a, mesh_b]), faces,
                        torch.cat([eye_a, eye_a, eye_b, eye_b]), s["size"],
                        s["fov_y"], s["near"], s["far"], s["sigma"],
                        s["blur"])
    groups = alpha.split(n)
    target_a, target_b = images[:n, 3], images[n:, 3]
    loss = (multiview_iou_loss(groups, target_a, target_b)
            + s["lambda_laplacian"] * laplacian_loss(
                vertices, laplacian_matrix(faces, template.shape[0]))
            + s["lambda_flatten"] * flatten_loss(vertices, edge_wings(faces)))
    return loss, alpha


class Adam:
    """Adam over a dict of tensors, float32."""

    def __init__(self, lr, betas=(0.9, 0.999), eps=1e-8):
        self.lr, (self.b1, self.b2), self.eps = lr, betas, eps
        self.m, self.v, self.t = {}, {}, 0

    def step(self, params, grads):
        self.t += 1
        c1 = 1 - self.b1 ** self.t
        c2 = 1 - self.b2 ** self.t
        out = {}
        for name, x in params.items():
            g = grads[name]
            m = self.b1 * self.m.get(name, torch.zeros_like(x)) + (
                1 - self.b1) * g
            v = self.b2 * self.v.get(name, torch.zeros_like(x)) + (
                1 - self.b2) * g * g
            self.m[name], self.v[name] = m, v
            out[name] = x - (self.lr / c1) * m / (v.sqrt() / c2 ** 0.5
                                                  + self.eps)
        return out
