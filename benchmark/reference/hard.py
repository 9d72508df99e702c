"""The plain hard renderer: un-clipped homogeneous rasterization (Genova et
al. 2018, tf_mesh_renderer), barycentric attribute interpolation, the
alpha composite over -1 and Phong diffuse shading, in float32.

The depth test picks each pixel's triangle (smallest z, ties to the larger
index) without a gradient; the images are then a differentiable function
of the winners' clip vertices and attributes, so autograd gives the
renderer's gradient: the derivative of the barycentrics at a fixed
triangle assignment, with none through z.
"""

from __future__ import annotations

import numpy as np
import torch

from . import camera, tiles


def _inside(e0, e1, e2):
    return ((e0 >= 0.0) & (e1 >= 0.0) & (e2 >= 0.0)
            & ((e0 > 0.0) | (e1 > 0.0) | (e2 > 0.0)))


def pack(clip, faces):
    """[B, T, 16] rows: the sign-corrected adjugate of [[x], [y], [w]]
    (edge i's a, b, c at 3i..3i+2), clip z (9-11), clip w (12-14) and
    liveness (15: 0 when all three w < 0)."""
    tv = clip[:, faces]  # [B, T, 3, 4]
    x, y, _, w = tv.unbind(-1)
    x0, x1, x2 = x.unbind(-1)
    y0, y1, y2 = y.unbind(-1)
    w0, w1, w2 = w.unbind(-1)
    m = [y1 * w2 - w1 * y2, x2 * w1 - w2 * x1, x1 * y2 - y1 * x2,
         y2 * w0 - w2 * y0, x0 * w2 - w0 * x2, x2 * y0 - y2 * x0,
         y0 * w1 - w0 * y1, x1 * w0 - w1 * x0, x0 * y1 - y0 * x1]
    det = x0 * m[0] + x1 * m[3] + x2 * m[6]
    sign = torch.where(det < 0.0, -1.0, 1.0)
    live = (~torch.all(w < 0.0, dim=-1)).to(torch.float32)
    return torch.cat([torch.stack(m, -1) * sign[..., None], tv[..., 2], w,
                      live[..., None]], -1)


def pixel_centers(width, height, device):
    """(px [W], py [H]): (i + 0.5) * f32(2 / n) - 1, row 0 at the bottom."""
    sx = float(np.float32(2.0 / width))
    sy = float(np.float32(2.0 / height))
    px = (torch.arange(width, dtype=torch.float32, device=device) + 0.5
          ) * sx - 1.0
    py = (torch.arange(height, dtype=torch.float32, device=device) + 0.5
          ) * sy - 1.0
    return px, py


def _edges(rows, px, py):
    e = [rows[..., 3 * i] * px + rows[..., 3 * i + 1] * py
         + rows[..., 3 * i + 2] for i in range(3)]
    return e


def winners(table, clip, faces, width, height):
    """Each pixel's triangle [B, H, W] int64 (-1 where none) and the count
    of (pixel, triangle) pairs that pass the inside, liveness and depth
    tests. No gradient."""
    with torch.no_grad():
        device = table.device
        batch, n_tri = table.shape[:2]
        tv = clip[:, faces]
        w = tv[..., 3]
        all_front = torch.all(w > 0.0, dim=-1)
        safe_w = torch.where(w > 0.0, w, 1.0)
        cx = ((tv[..., 0] / safe_w + 1.0) * (width / 2.0) - 0.5)
        cy = ((tv[..., 1] / safe_w + 1.0) * (height / 2.0) - 0.5)
        full_c = torch.tensor([-1.0, width + 1.0], device=device)
        full_r = torch.tensor([-1.0, height + 1.0], device=device)
        cols = torch.stack([cx.amin(-1), cx.amax(-1)], -1)
        rows = torch.stack([cy.amin(-1), cy.amax(-1)], -1)
        exact = all_front[..., None] & torch.isfinite(cols) & torch.isfinite(
            rows)
        cols = torch.where(exact, cols, full_c)
        rows = torch.where(exact, rows, full_r)
        keep = table[..., 15] > 0.0
        px, py = pixel_centers(width, height, device)
        best = torch.full((batch, height, width), -1, dtype=torch.int64,
                          device=device)
        pairs = 0
        for image, tr, tc, tris in tiles.bin_pairs(cols, rows, keep, height,
                                                   width):
            r, c, on = tiles.tile_pixels(tr, tc, height, width)
            rr, cc = r.clamp(max=height - 1), c.clamp(max=width - 1)
            rows_t = table[image[:, None], tris.clamp(min=0)]  # [G, K, 16]
            rows_t = rows_t[:, :, None, :]
            e = _edges(rows_t, px[cc][:, None, :], py[rr][:, None, :])
            num = (e[0] * rows_t[..., 9] + e[1] * rows_t[..., 10]
                   + e[2] * rows_t[..., 11])
            den = (e[0] * rows_t[..., 12] + e[1] * rows_t[..., 13]
                   + e[2] * rows_t[..., 14])
            z = num / torch.where(den != 0.0, den, 1.0)
            valid = (_inside(*e) & (rows_t[..., 15] > 0.0) & (z >= -1.0)
                     & (z <= 1.0) & (tris >= 0)[:, :, None] & on[:, None, :])
            pairs += int(valid.sum())
            zm = torch.where(valid, z, torch.inf)
            zmin = zm.amin(1, keepdim=True)
            at_min = valid & (zm == zmin)
            win = torch.where(at_min, tris[:, :, None], -1).amax(1)
            best[image[:, None].expand_as(rr)[on], rr[on], cc[on]] = win[on]
        return best, pairs


def attributes(table, faces, vertex_attrs, win, width, height):
    """[B, H, W, A] interpolated attributes composited over -1 by alpha =
    clip(2 sum(bc), 0, 1), and the covered-pixel count. Differentiable in
    table and vertex_attrs."""
    device = table.device
    batch = table.shape[0]
    n_attr = vertex_attrs.shape[-1]
    b, r, c = torch.nonzero(win >= 0, as_tuple=True)
    t = win[b, r, c]
    px, py = pixel_centers(width, height, device)
    rows = table[b, t]
    e = _edges(rows, px[c], py[r])
    total = e[0] + e[1] + e[2]
    inv = torch.reciprocal(torch.where(total != 0.0, total, 1.0))
    bc = [ei * inv for ei in e]
    corner = vertex_attrs[b[:, None], faces[t].long()]  # [N, 3, A]
    attr = (corner[:, 0] * bc[0][:, None] + corner[:, 1] * bc[1][:, None]
            + corner[:, 2] * bc[2][:, None])
    f32 = dict(dtype=torch.float32, device=device)
    attr_img = torch.zeros(batch, height, width, n_attr, **f32).index_put(
        (b, r, c), attr)
    bc_sum = torch.zeros(batch, height, width, **f32).index_put(
        (b, r, c), 2.0 * bc[0] + 2.0 * bc[1] + 2.0 * bc[2])
    alpha = torch.minimum(torch.maximum(bc_sum, torch.zeros((), **f32)),
                          torch.ones((), **f32))[..., None]
    return alpha * attr_img + (1.0 - alpha) * -1.0, int(b.numel())


def _normalize(x, dim):
    return x / torch.clamp(torch.sqrt(torch.sum(x * x, dim, True)),
                           min=1e-12)


def shade(attrs, lights, intensities):
    """Phong diffuse shading of [B, H, W, 9] (normal, position, diffuse)
    under point lights [B, L, 3] of RGB intensities [B, L, 3]: [B, H, W, 4]
    with RGB zeroed where alpha <= 0.5, flipped to rows top-down."""
    batch, height, width, _ = attrs.shape
    normals = _normalize(attrs[..., 0:3], 3).reshape(batch, -1, 3)
    positions = attrs[..., 3:6].reshape(batch, -1, 3)
    diffuse = attrs[..., 6:9].reshape(batch, -1, 3)
    mask = torch.any(diffuse >= 0.0, dim=2).to(torch.float32)
    to_light = _normalize(lights[:, :, None, :] - positions[:, None], 3)
    f32 = dict(dtype=torch.float32, device=attrs.device)
    ndl = torch.minimum(torch.maximum(
        torch.sum(normals[:, None] * to_light, 3), torch.zeros((), **f32)),
        torch.ones((), **f32))
    rgb = torch.sum(diffuse[:, None] * ndl[..., None]
                    * intensities[:, :, None, :], 1)
    rgb = rgb.reshape(batch, height, width, 3)
    alpha = mask.reshape(batch, height, width, 1)
    rgb = torch.where(alpha > 0.5, rgb, 0.0)
    return torch.flip(torch.cat([rgb, alpha], 3), dims=[1])


def render(vertices, faces_cw, normals, diffuse, eye, center, up, lights,
           intensities, size, fov_y, near, far, tf32=False, counts=None):
    """[B, S, S, 4] lit RGBA of the hard renderer: vertices, normals and
    diffuse [B, V, 3], faces_cw [T, 3], camera [B, 3], lights [B, L, 3],
    RGB intensities [B, L, 3]. Differentiable in `vertices` (geometry and
    the position attribute). `counts`, a dict, receives the pairs that pass
    the depth test and the covered pixels."""
    matrices = camera.clip_transforms(eye, center, up, fov_y, near, far,
                                      size, size, tf32)
    clip = camera.to_clip(matrices, vertices, tf32)
    faces = faces_cw.long()
    table = pack(clip, faces)
    win, pairs = winners(table.detach(), clip.detach(), faces, size, size)
    attrs, covered = attributes(
        table, faces, torch.cat([normals, vertices, diffuse], 2), win, size,
        size)
    if counts is not None:
        counts["hard_pairs"] = counts.get("hard_pairs", 0) + pairs
        counts["covered"] = counts.get("covered", 0) + covered
    return shade(attrs, lights, intensities)


def count(vertices, faces_cw, eye, center, up, size, fov_y, near, far,
          counts):
    """Adds to `counts` the pairs that pass the depth test and the covered
    pixels of a render, without rendering it."""
    with torch.no_grad():
        matrices = camera.clip_transforms(eye, center, up, fov_y, near, far,
                                          size, size)
        clip = camera.to_clip(matrices, vertices)
        faces = faces_cw.long()
        win, pairs = winners(pack(clip, faces), clip, faces, size, size)
    counts["hard_pairs"] = counts.get("hard_pairs", 0) + pairs
    counts["covered"] = counts.get("covered", 0) + int((win >= 0).sum())
