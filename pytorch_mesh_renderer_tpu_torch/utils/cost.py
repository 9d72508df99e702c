"""What a step must do on the card, and the least time it could take.

The counterpart of `bench.py:estimate_hard_cost` (:396) and
`estimate_soft_cost` (:321). Those count the (tile, chunk) visits of the
TPU kernels' gathered-binning prepass, which the port does not carry;
this module counts the (pixel, triangle) pairs that the port's kernels
visit after their per-block cull, on this run's data, times operations
per pair read off the kernels:

  * hard (K1, K2): every in-image pixel of a 16x16 block tests every row
    that K1's cull keeps for the block (`hard_work.block_keeps`), at
    HARD_OPS_PER_PAIR; K1 interpolates A attributes per pixel (6 A); K2
    sums (9 + 3A) x 4 operations per active pixel (`hard_work.
    active_pixels`);
  * soft (K7 / K5 forward, K8 / K6 backward): the forwards test every
    in-image pixel of a block against every row the block cull stages
    (`soft_work.staged_rows`); the backwards run, per staged row, the
    16x2-pixel row pairs of the block that the row's bbox touches
    (`csrc/soft_split.cuh: scan_row_pairs`), 32 pixels each; per pair
    SOFT_OPS_PER_PAIR (bench.py:321-348's constants per light L for the
    full kernels; the silhouette kernels keep their geometry terms).

Bytes are counted as the JAX docstrings describe: the forward reads the
tables and writes the images, the backward reads both and the
cotangents and writes the gradient tables.

`bound_ms` turns bytes and operations into the least time at the H100's
published peaks; chip_smoke.py's kernel bounds and the bench's shares of
peak use them.
"""

from __future__ import annotations

import torch

from ..ops.rasterize_cuda import TRI_COLS
from ..ops.soft_rasterize_cuda import COLS, pixel_centers
from . import hard_work, soft_work
from .soft_work import BLOCK

# The card's published peaks (H100 SXM data sheet, at 700 W): device
# memory bytes/s and fp32 operations/s outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# Dense tensor-core products (the same data sheet).
PEAK_TF32_PER_S = 495e12
PEAK_BF16_PER_S = 989e12
# fp32 operations per (pixel, triangle) pair, read off the kernel bodies.
# Hard kernels: 3 edge functions (12), the z interpolation and depth test
# (6). Soft kernels: bench.py:321-348's constants for the full forward
# (K7) and backward (K8), per light L; the silhouette forward (K5) keeps
# their geometry terms (barycentrics 12, segment distances 42, edge pick /
# perspective / L1 27, sigmoid / z 26, the product 2) and its backward
# (K6) adds the coverage chain and the six edge columns (~60).
HARD_OPS_PER_PAIR = 18
SOFT_OPS_PER_PAIR = {"soft_fwd": (215, 23), "soft_bwd": (645, 63),
                     "soft_sil_fwd": (110, 0), "soft_sil_bwd": (170, 0)}


def bound_ms(n_bytes, n_ops, tensor_ops=0, tensor_peak=PEAK_TF32_PER_S):
    """(least time in ms, what bounds it) for moving n_bytes through device
    memory, doing n_ops fp32 operations and tensor_ops tensor-core
    operations at tensor_peak, at the card's peaks (the units run at once:
    the larger time bounds)."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = max(n_ops / PEAK_FP32_PER_S, tensor_ops / tensor_peak)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def pixel_pairs(x_lo, x_hi, y_lo, y_hi, keep, width, height):
    """Sum over triangles of the pixel centres inside [x_lo, x_hi] x
    [y_lo, y_hi] (NDC, [B, T] each) where keep: the (pixel, triangle) pairs
    a rasterizer must test."""
    px, py = pixel_centers(width, height, 0, height, keep.device)
    py = py.flip(0)  # ascending, as searchsorted wants

    def inside(centres, lo, hi):
        return (torch.searchsorted(centres, hi.contiguous(), right=True)
                - torch.searchsorted(centres, lo.contiguous())).clamp(min=0)

    return int((keep * inside(px, x_lo, x_hi)
                * inside(py, y_lo, y_hi)).sum())


def block_pixels(width, height, device):
    """[ceil(H/16), ceil(W/16)] int64: the in-image pixels of each
    block."""
    def extent(size):
        starts = torch.arange(-(-size // BLOCK), device=device) * BLOCK
        return (size - starts).clamp(max=BLOCK)
    return extent(height)[:, None] * extent(width)[None, :]


def hard_visits(table, width, height):
    """(pixel, triangle) pairs K1 tests on `table` [B, T, 16]
    (rasterize_cuda.pack_rows): each kept row of a block
    (`hard_work.block_keeps`) against each of its in-image pixels."""
    keeps = hard_work.block_keeps(table, width, height)
    per_block = keeps.sum(-1)  # [B, nby, nbx]
    return int((per_block * block_pixels(width, height,
                                         table.device)).sum())


def hard_step_cost(table, ids, bc, n_attrs):
    """(fp32 operations, bytes, visited pairs) of one hard training step:
    K1 on `table` [B, T, 16] with n_attrs attributes, and K2 on its ids
    and bc [B, H, W(, 3)]."""
    batch, n_tri = table.shape[:2]
    height, width = ids.shape[1:3]
    pixels = batch * height * width
    pairs = hard_visits(table, width, height)
    active = int(hard_work.active_pixels(ids, bc).sum())
    flops = (pairs * HARD_OPS_PER_PAIR + pixels * 6 * n_attrs
             + active * (9 + 3 * n_attrs) * 4)
    table_bytes = batch * n_tri * (TRI_COLS + 3 * n_attrs) * 4
    image_bytes = pixels * 4 * (4 + n_attrs)  # ids, bc, attributes
    grad_tables = batch * n_tri * (9 + 3 * n_attrs) * 4
    hbm_bytes = (table_bytes + image_bytes) + (
        table_bytes + 2 * image_bytes + grad_tables)
    return flops, hbm_bytes, pairs


def soft_visits(table, width, height):
    """(forward pairs, backward pairs) the soft kernels visit on `table`
    [B, T, 59]: each staged row (`soft_work.staged_rows`) against each
    in-image pixel of its block; each staged row's touched row pairs
    (`scan_row_pairs`: the pair's pixel-centre rows reach into the row's
    bbox), 32 lanes each."""
    device = table.device
    staged = soft_work.staged_rows(table, width, height)  # [B, Y, X, T]
    forward = int((staged.sum(-1) * block_pixels(width, height,
                                                 device)).sum())
    _, py = pixel_centers(width, height, 0, height, device)
    nby = -(-height // BLOCK)
    pad = torch.cat([py, py[-1:].expand(nby * BLOCK - height)])
    rows = pad.view(nby, BLOCK // 2, 2)  # [Y, pairs, (top, bottom)]
    in_image = (torch.arange(nby * BLOCK, device=device)
                < height).view(nby, BLOCK // 2, 2)[..., 0]
    y_lo, y_hi = table[..., 24], table[..., 25]  # [B, T]
    touched = ((rows[None, :, :, None, 0] >= y_lo[:, None, None, :])
               & (rows[None, :, :, None, 1] <= y_hi[:, None, None, :])
               & in_image[None, :, :, None])  # [B, Y, pairs, T]
    pairs_per_row = touched.sum(2)  # [B, Y, T]
    backward = int((staged.sum(2) * pairs_per_row).sum()) * 2 * BLOCK
    return forward, backward


def soft_step_cost(table, n_lights, width, height, silhouette=False):
    """(fp32 operations, bytes, visited forward + backward pairs) of one
    soft training step on `table` [B, T, 59] with n_lights lights: K7 and
    K8, or K5 and K6 for the silhouette."""
    batch, n_tri = table.shape[:2]
    forward, backward = soft_visits(table, width, height)
    fwd, bwd = (("soft_sil_fwd", "soft_sil_bwd") if silhouette
                else ("soft_fwd", "soft_bwd"))

    def ops(name):
        base, per_light = SOFT_OPS_PER_PAIR[name]
        return base + per_light * (0 if silhouette else n_lights)

    flops = forward * ops(fwd) + backward * ops(bwd)
    pixels = batch * height * width
    table_bytes = batch * n_tri * COLS * 4
    fwd_images = pixels * 4 * 6  # rgba, m, sum_w
    bwd_images = pixels * 4 * 11  # residuals and cotangents
    hbm_bytes = (table_bytes + fwd_images) + (
        table_bytes + fwd_images + bwd_images + table_bytes)
    return flops, hbm_bytes, forward + backward
