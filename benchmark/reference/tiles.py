"""Pixel tiles and the triangles whose bounding boxes reach them.

Both plain renderers evaluate (pixel, triangle) pairs only where a
triangle's pixel bounding box overlaps a TILE x TILE pixel tile, so that a
reference render costs what its pairs cost and not B x H x W x T. A box is
widened by a pixel on each side, so the binning drops no pair that a
renderer's own tests would keep.
"""

from __future__ import annotations

import torch

TILE = 16
PAIR_BUDGET = 1 << 22  # padded (pixel, triangle) pairs per chunk


def _tile_span(lo, hi, extent):
    """First and last tile index [.] of pixel spans [lo, hi] (floats, may
    lie outside the image); first > last where the span misses it."""
    first = torch.clamp(torch.floor(lo) - 1, min=0)
    last = torch.clamp(torch.ceil(hi) + 1, max=extent - 1)
    tiles = (extent + TILE - 1) // TILE
    first_t = torch.div(first, TILE, rounding_mode="floor").long()
    last_t = torch.div(last, TILE, rounding_mode="floor").long()
    miss = (hi < -1) | (lo > extent)
    return first_t.clamp(max=tiles - 1), torch.where(miss, -1, last_t)


def bin_pairs(cols, rows, keep, height, width):
    """Groups of candidate triangles per (image, tile).

    Args:
      cols, rows: [B, T, 2] each triangle's (lowest, highest) pixel column
        and row (floats, inclusive; any values).
      keep: [B, T] bool, the triangles that can cover anything.

    Returns:
      a list of chunks (image [G], tile_row [G], tile_col [G], triangles
      [G, K] int64 with -1 padding), the groups sorted by their count so
      that each chunk pads little, each within PAIR_BUDGET pairs.
    """
    device = cols.device
    batch, n_tri = keep.shape
    ty = (height + TILE - 1) // TILE
    tx = (width + TILE - 1) // TILE
    c0, c1 = _tile_span(cols[..., 0], cols[..., 1], width)
    r0, r1 = _tile_span(rows[..., 0], rows[..., 1], height)
    nx = (c1 - c0 + 1).clamp(min=0)
    ny = (r1 - r0 + 1).clamp(min=0)
    count = torch.where(keep, nx * ny, 0).reshape(-1)
    total = int(count.sum())
    if total == 0:
        return []
    flat = torch.repeat_interleave(torch.arange(batch * n_tri,
                                                device=device), count)
    start = torch.cumsum(count, 0) - count
    local = torch.arange(total, device=device) - start[flat]
    nx_f = nx.reshape(-1)[flat]
    tile_c = c0.reshape(-1)[flat] + local % nx_f
    tile_r = r0.reshape(-1)[flat] + torch.div(local, nx_f,
                                              rounding_mode="floor")
    image = torch.div(flat, n_tri, rounding_mode="floor")
    tri = flat % n_tri
    key = (image * ty + tile_r) * tx + tile_c
    key, order = torch.sort(key, stable=True)
    tri = tri[order]
    groups, per_group = torch.unique_consecutive(key, return_counts=True)
    g_start = torch.cumsum(per_group, 0) - per_group
    by_size = torch.argsort(per_group, stable=True)
    sizes = per_group[by_size].tolist()
    chunks = []
    i = 0
    n_groups = len(sizes)
    while i < n_groups:
        j = i + 1
        while (j < n_groups and
               (j + 1 - i) * sizes[j] * TILE * TILE <= PAIR_BUDGET):
            j += 1
        sel = by_size[i:j]
        k = sizes[j - 1]
        pos = torch.arange(k, device=device)
        idx = g_start[sel][:, None] + pos[None, :]
        valid = pos[None, :] < per_group[sel][:, None]
        tris = torch.where(valid, tri[idx.clamp(max=total - 1)], -1)
        gk = groups[sel]
        chunks.append((torch.div(gk, ty * tx, rounding_mode="floor"),
                       torch.div(gk % (ty * tx), tx, rounding_mode="floor"),
                       gk % tx, tris))
        i = j
    return chunks


def tile_pixels(tile_row, tile_col, height, width):
    """Pixel rows and columns [G, TILE * TILE] of each group's tile, and
    whether each lies inside the image."""
    device = tile_row.device
    r = torch.arange(TILE, device=device).repeat_interleave(TILE)
    c = torch.arange(TILE, device=device).repeat(TILE)
    rows = tile_row[:, None] * TILE + r[None, :]
    cols = tile_col[:, None] * TILE + c[None, :]
    inside = (rows < height) & (cols < width)
    return rows, cols, inside
