"""The plain soft renderer: SoftRas (Liu et al. 2019) coverage and
softmax-depth aggregation with per-pixel Lambertian lighting, in float32.

Each (pixel, triangle) pair within the blur radius of a front-facing
triangle has coverage sigmoid(+-d^2 / sigma), d the distance from the pixel
centre to the triangle's nearest edge (+ inside, - outside); alpha is
1 - prod(1 - coverage); colour is the softmax over z / gamma of each
triangle's interpolated colour times its light sum, against a background
weight exp(EPS / gamma). The interpolation uses the perspective-correct
screen barycentrics, clamped to the nearest edge outside the triangle.

The images are a differentiable function of the vertices. The pairs are
evaluated tile by tile (`tiles.py`), and where a per-pixel loss is given
each chunk's part of it is differentiated at once, so that the memory
stays at one chunk's graph.
"""

from __future__ import annotations

import torch

from . import camera, tiles

EPS = 1e-10
NEG_BIG = -1e30


def vertex_normals(vertices, faces):
    """[B, V, 3] area-weighted unit normals of CCW faces."""
    fv = vertices[:, faces]  # [B, T, 3, 3]
    v0, v1, v2 = fv.unbind(2)
    corner = torch.stack([torch.linalg.cross(v1 - v0, v2 - v0, dim=-1),
                          torch.linalg.cross(v2 - v1, v0 - v1, dim=-1),
                          torch.linalg.cross(v0 - v2, v1 - v2, dim=-1)], 2)
    acc = torch.zeros_like(vertices).index_add(
        1, faces.reshape(-1), corner.reshape(vertices.shape[0], -1, 3))
    norm = torch.sqrt(torch.sum(acc * acc, -1, keepdim=True))
    return acc / torch.clamp(norm, min=1e-6)


def pack(clip, faces, world, normals, colors, blur):
    """[B, T, 53] per-triangle rows (differentiable): 0-8 the 2D inverse
    (screen barycentric coefficients), 9-14 NDC corner xy, 15-17 NDC z, 18
    keep (front-facing, not degenerate), 19-22 the box widened by the blur
    radius, 23-25 1/w, 26-34 world corners, 35-43 normal corners, 44-52
    colour corners."""
    batch, n_tri = clip.shape[0], faces.shape[0]
    tv = clip[:, faces]
    w = tv[..., 3]
    safe_w = torch.where(w != 0.0, w, 1.0)
    ndc = tv[..., :3] / safe_w[..., None]
    vx, vy, vz = ndc.unbind(-1)
    x0, x1, x2 = vx.unbind(-1)
    y0, y1, y2 = vy.unbind(-1)
    area = (x0 - x1) * (y2 - y1) - (y0 - y1) * (x2 - x1)
    det = x0 * (y1 - y2) - x1 * (y0 - y2) + x2 * (y0 - y1)
    keep = ((area < 0.0) & (det != 0.0)).to(torch.float32)
    inv_det = torch.where(det != 0.0,
                          1.0 / torch.where(det != 0.0, det, 1.0), 0.0)
    adj = torch.stack([y1 - y2, x2 - x1, x1 * y2 - x2 * y1,
                       y2 - y0, x0 - x2, x2 * y0 - x0 * y2,
                       y0 - y1, x1 - x0, x0 * y1 - x1 * y0], -1)
    box = torch.stack([vx.amin(-1) - blur, vx.amax(-1) + blur,
                       vy.amin(-1) - blur, vy.amax(-1) + blur], -1)

    def corners(values):
        return values[:, faces].reshape(batch, n_tri, 9)

    return torch.cat([
        adj * inv_det[..., None], torch.stack([x0, y0, x1, y1, x2, y2], -1),
        vz, keep[..., None], box, 1.0 / safe_w, corners(world),
        corners(normals), corners(colors)], -1)


def pixel_centers(width, height, device):
    """(px [W], py [H]), rows top-down, with IEEE divisions."""
    f32 = dict(dtype=torch.float32, device=device)
    w = torch.full((), float(width), **f32)
    h = torch.full((), float(height), **f32)
    px = 2.0 * (torch.arange(width, **f32) + 0.5) / w - 1.0
    py = -2.0 * (torch.arange(height, **f32) + 0.5) / h + 1.0
    return px, py


def _clip01(x):
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, zero), zero + 1.0)


def _safe_sqrt(x):
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def _segment(px, py, ax, ay, bx, by):
    abx, aby = bx - ax, by - ay
    inv = 1.0 / torch.clamp(abx * abx + aby * aby, min=1e-24)
    t = _clip01(((px - ax) * abx + (py - ay) * aby) * inv)
    nx = ax + t * abx - px
    ny = ay + t * aby - py
    return nx * nx + ny * ny, t


def pair_outputs(rows, pad_ok, px, py, sigma, gamma, sq_blur, lights,
                 shade):
    """Per-pixel outputs of a chunk of groups.

    rows: [G, K, 1, 53]; pad_ok [G, K, P] (a real triangle and pixel);
    px, py [G, 1, P]; lights [G, L, 4] (xyz, intensity).
    Returns (alpha [G, P], rgb [G, P, 3] or None, valid [G, K, P]).
    """
    def col(k):
        return rows[..., k]

    bc = [col(3 * i) * px + col(3 * i + 1) * py + col(3 * i + 2)
          for i in range(3)]
    inside = (bc[0] >= 0.0) & (bc[1] >= 0.0) & (bc[2] >= 0.0)
    x0, y0, x1, y1, x2, y2 = (col(k) for k in range(9, 15))
    d01, t01 = _segment(px, py, x0, y0, x1, y1)
    d12, t12 = _segment(px, py, x1, y1, x2, y2)
    d20, t20 = _segment(px, py, x2, y2, x0, y0)
    sq_dist = torch.amin(torch.stack([d01, d12, d20]), 0)
    pick01 = (d01 <= d12) & (d01 <= d20)
    pick12 = ~pick01 & (d12 <= d20)
    zero = torch.zeros((), dtype=torch.float32, device=rows.device)
    eb = [torch.where(pick01, 1.0 - t01, torch.where(pick12, zero, t20)),
          torch.where(pick01, t01, torch.where(pick12, 1.0 - t12, zero)),
          torch.where(pick01, zero, torch.where(pick12, t12, 1.0 - t20))]
    cb = [torch.where(inside, b, e) for b, e in zip(bc, eb)]
    ow = [cb[k] * col(23 + k) for k in range(3)]
    denom = sum(torch.where(o >= 0.0, o, -o) for o in ow)
    sb = [o * (1.0 / torch.clamp(denom, min=1e-12)) for o in ow]
    z = 0.5 - (sb[0] * col(15) + sb[1] * col(16) + sb[2] * col(17)) * 0.5
    valid = (pad_ok & (col(18) > 0.0) & (px >= col(19)) & (px <= col(20))
             & (py >= col(21)) & (py <= col(22))
             & (inside | (sq_dist <= sq_blur)) & (z >= 0.0) & (z <= 1.0))
    sgn = torch.where(inside, 1.0, -1.0)
    coverage = torch.where(valid, torch.sigmoid(sgn * sq_dist / sigma), zero)
    alpha = 1.0 - torch.prod(1.0 - coverage, dim=1)
    if not shade:
        return alpha, None, valid

    def interp(first):
        return [sb[0] * col(first + c) + sb[1] * col(first + 3 + c)
                + sb[2] * col(first + 6 + c) for c in range(3)]

    p3, u, color = interp(26), interp(35), interp(44)
    n_inv = 1.0 / torch.clamp(_safe_sqrt(sum(uc * uc for uc in u)),
                              min=1e-12)
    n = [uc * n_inv for uc in u]
    light_sum = torch.zeros_like(p3[0])
    for l in range(lights.shape[1]):
        def light(k):
            return lights[:, l, k].reshape(-1, 1, 1)
        d = [light(c) - p3[c] for c in range(3)]
        d_inv = 1.0 / torch.clamp(_safe_sqrt(sum(dc * dc for dc in d)),
                                  min=1e-12)
        ct = (d[0] * n[0] + d[1] * n[1] + d[2] * n[2]) * d_inv
        light_sum = light_sum + _clip01(ct) * light(3)
    logit = torch.where(valid, z / gamma, NEG_BIG)
    floor = (EPS / gamma).detach()
    top = torch.maximum(logit.detach().amax(1), floor)  # [G, P]
    weight = coverage * torch.exp(logit - top[:, None])
    total = weight.sum(1) + torch.clamp(torch.exp(floor - top), min=EPS)
    rgb = torch.stack([(weight * c * light_sum).sum(1) / total
                       for c in color], -1)
    return alpha, rgb, valid


def render(vertices, faces_ccw, colors, eye, center, up, lights,
           intensities, size, fov_y, near, far, sigma, gamma, blur,
           shade=True, tf32=False, pixel_loss=None, counts=None):
    """Soft render of [B, V, 3] vertices at S x S: [B, S, S, 4] RGBA (with
    `shade`) or [B, S, S] alpha, detached.

    pixel_loss(alpha [N], rgb [N, 3] or None, b, r, c) -> the sum of the
    loss over those pixels; when given, its gradient is added into
    vertices.grad (the vertices must require a gradient). `counts`, a dict,
    receives the pairs that pass the tests and the pixels that any does.
    """
    device = vertices.device
    batch = vertices.shape[0]
    faces = faces_ccw.long()
    matrices = camera.clip_transforms(eye, center, up, fov_y, near, far,
                                      size, size, tf32)
    clip = camera.to_clip(matrices, vertices, tf32)
    zeros = torch.zeros_like(vertices)
    if shade:
        table = pack(clip, faces, vertices, vertex_normals(vertices, faces),
                     colors, blur)
        light4 = torch.cat([lights, intensities[..., None]], -1)
    else:
        table = pack(clip, faces, zeros, zeros, zeros, blur)
        light4 = torch.zeros(batch, 0, 4, device=device)
    leaf = table.detach().requires_grad_(pixel_loss is not None)
    f32 = dict(dtype=torch.float32, device=device)
    sigma_t = torch.full((), sigma, **f32)
    gamma_t = torch.full((), gamma, **f32)
    blur_t = torch.full((), blur, **f32)
    sq_blur = blur_t * blur_t
    px, py = pixel_centers(size, size, device)
    box = leaf.detach()[..., 19:23]
    half = size / 2.0
    cols = torch.stack([(box[..., 0] + 1.0) * half - 0.5,
                        (box[..., 1] + 1.0) * half - 0.5], -1)
    rows = torch.stack([(1.0 - box[..., 3]) * half - 0.5,
                        (1.0 - box[..., 2]) * half - 0.5], -1)
    keep = (leaf.detach()[..., 18] > 0.0) & torch.isfinite(
        cols).all(-1) & torch.isfinite(rows).all(-1)
    alpha_img = torch.zeros(batch, size, size, **f32)
    rgb_img = torch.zeros(batch, size, size, 3, **f32)
    pairs = touched = 0
    for image, tr, tc, tris in tiles.bin_pairs(cols, rows, keep, size,
                                               size):
        r, c, on = tiles.tile_pixels(tr, tc, size, size)
        rr, cc = r.clamp(max=size - 1), c.clamp(max=size - 1)
        with torch.set_grad_enabled(pixel_loss is not None):
            sel = leaf[image[:, None], tris.clamp(min=0)][:, :, None, :]
            pad_ok = (tris >= 0)[:, :, None] & on[:, None, :]
            alpha, rgb, valid = pair_outputs(
                sel, pad_ok, px[cc][:, None, :], py[rr][:, None, :],
                sigma_t, gamma_t, sq_blur, light4[image], shade)
            b = image[:, None].expand_as(rr)[on]
            if pixel_loss is not None:
                part = pixel_loss(alpha[on], None if rgb is None else rgb[on],
                                  b, rr[on], cc[on])
                part.backward()
        pairs += int(valid.sum())
        touched += int(valid.any(1).sum())
        alpha_img[b, rr[on], cc[on]] = alpha.detach()[on]
        if shade:
            rgb_img[b, rr[on], cc[on]] = rgb.detach()[on]
    if pixel_loss is not None and leaf.grad is not None:
        table.backward(leaf.grad)
    if counts is not None:
        counts["soft_pairs"] = counts.get("soft_pairs", 0) + pairs
        counts["touched"] = counts.get("touched", 0) + touched
    if not shade:
        return alpha_img
    return torch.cat([rgb_img, alpha_img[..., None]], -1)
