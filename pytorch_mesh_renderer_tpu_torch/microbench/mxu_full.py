"""The whole per-visit pipeline: production core vs a tensor-core core.

Port of scripts/mxu_full_microbench.py (S2), the integration question
behind mxu_edge: does a contraction on the matrix unit still win once the
whole per-visit pipeline (inside test, depth divide, valid test, winner
selection, carry merge) runs in the contraction's pixel-major frame? Both
variants produce the z-buffer of one 16x128 tile over `visits` visits of C
synthetic triangles: per pixel the smallest valid z, ties to the larger
triangle id, the winner's raw edge values (z = 2, id = -1 and zeros where
no triangle is valid).

  * `prod` (the script's `prod`): the production core unchanged, the
    cluster body of K1 and K3 (csrc/rasterize_cluster_fwd.cuh: a cluster of
    CTAs splits the rows, culls them per group of pixel blocks and per
    block, and merges its partial winners), at K3's launch rule, on the
    packed rows, with positional ids;
  * `tc` (`mxu`): the 3xTF32 `mma.sync` contraction
    [5C, 3 -> 8] @ [8, 2048], then the same masking and winner on the
    products (mxu_full_microbench.py:131-152). Like the JAX kernel it
    omits the production live-column test: harmless here because the
    synthetic table sets column 15 to 1 everywhere, but it measures the
    tc side one compare per pair lighter than a faithful port. The kernel
    stages each CTA's rows in shared memory with `cp.async`, splits them
    into TF32 hi and lo once per CTA, culls the triangles per warp region
    of 2x16 pixels (`tc_keeps` is the plain model of that cull; it keeps
    every pair the plain version counts inside) and runs the products only
    on the survivors, compacted into groups of 8.

Both kernels (csrc/mxu_full.cu) split the visits over batches of CTAs
and merge the partial winners in one shared second pass, order-free
(tc over `common.visit_splits(visits)`; prod over `prod_splits`, just
enough to give every SM a CTA, and with one such split it runs no second
pass); they differ in how a pair's five values are computed. Each sits
beside a plain PyTorch version:
`zbuffer_prod_torch` computes what the cluster body computes (bit for
bit: its merge is a total order);
`zbuffer_tc_torch` rounds the operands to TF32 hi and lo parts as the
kernel does and sums the three exact products in fp32, in its own order, so
a winner may differ where the two best depths lie within Z_TOL.

    python -m pytorch_mesh_renderer_tpu_torch.microbench.mxu_full \
        [--visits 512] [--chunk 8] [--iters 30] [--device cuda|cpu]

prints the script's JSON line: `covered_px`, `id_mismatch_px` and
`max_abs_z_gap` of tc against prod (the finding the script exists for:
how much the contraction's rounding moves knife-edge winners), each
variant's time per call (`*_us`: the device time of its kernels by
torch.profiler on a card, the host clock on the CPU; `*_call_us`:
back-to-back calls by CUDA events) and `speedup` = prod / tc; and, beyond
the script's keys, `prod_shape` (prod's launch on a card: visit splits,
group, cluster split, CTAs and CTAs per SM; `prod_shape`), and
`tc_kept_fraction` and `tc_group_fraction`, the share
of all pairs that tc's cull keeps and that its groups of 8 run through
the products, and `tc_busiest_groups`, the most groups one warp runs in
one stage (`tc_cull_counts`).
"""

from __future__ import annotations

import argparse
import ctypes
import json

import numpy as np
import torch

from ..ops.barycentric import pixel_is_inside
from ..utils import kernels, profiling
from ..utils.device import resolve_device
from . import common

VARIANTS = ("prod", "tc")

# fp32 operations per (triangle, pixel) pair read off the two bodies: the
# three edge functions (12, prod only) and the inside test (6) for every
# pair; for the pairs inside a triangle, num and den (10, prod only), the
# zero-denominator select and the divide (2), the two depth tests and the
# two compares of the carry merge (4).
EDGE_OPS, INSIDE_OPS, DEPTH_OPS, TAIL_OPS = 12, 6, 10, 6

# The tc kernel vs its plain version: the best depths of a pixel where the
# two picked different winners lie within this much of each other (the
# contraction's rounding, ~1e-7 relative in the five values, moves z by
# up to ~1e-6 on this table; 1e-5 leaves a margin).
Z_TOL = 1e-5


# The tc kernel's cull (csrc/mxu_full.cu): a warp's region of the 16x16
# pixel block (2 rows of 16 pixels), the relative margin below which an
# edge must lie at all four corners for a triangle to be dropped, and the
# triangles a CTA stages at once (its survivors are grouped per stage).
REGION_H, REGION_W = 2, 16
CULL_MARGIN = 1e-5
STAGE_TRIS = 128


# prod's CTAs per visit split at most: the tile's 8 pixel blocks, each a
# cluster of at most 8 CTAs (K3's rule at group 1).
PROD_CTAS_PER_SPLIT = 8 * 8


def prod_splits(visits: int, sms: int) -> int:
    """The visit splits prod runs over (its batch images): the fewest,
    among the divisors of `visits` up to common.MAX_SPLITS, whose
    PROD_CTAS_PER_SPLIT CTAs each give every one of `sms` SMs a CTA;
    else common.visit_splits(visits)."""
    for d in range(1, common.MAX_SPLITS + 1):
        if visits % d == 0 and d * PROD_CTAS_PER_SPLIT >= sms:
            return d
    return common.visit_splits(visits)


def make_inputs(visits, chunk, device):
    """The script's inputs from np.random.default_rng(0)
    (mxu_full_microbench.py:64-83): (data [visits*C, 16] packed rows,
    edges scaled by 2, column 15 = 1; coeff [visits*5C, 8] in edge-major
    row order e0 x C, e1 x C, e2 x C, num x C, den x C), f32 on
    `device`."""
    rng = np.random.default_rng(0)
    data = rng.uniform(-1.0, 1.0, size=(visits * chunk, 16)).astype(
        np.float32)
    data[:, 0:9] *= 2.0
    data[:, 15] = 1.0
    return _with_contraction_rows(data, visits, chunk, device)


def make_knife_edge_inputs(device, seed=0):
    """(data, coeff, visits, chunk) as make_inputs' pair, for a table whose
    edges pass through the corner pixel centres of the tc kernel's warp
    regions: for each of the tile's 64 regions, each corner and each of
    the four quadrants, a triangle with a vertex at that corner's centre
    and two edges along the quadrant's sides, each scaled by a seeded
    factor in [0.3, 3) (so that c = -(a x + b y) rounds), and a far third
    edge. Its inside pixels in the region are the corner alone, one of the
    region's border rows or columns, or the whole region: where a cull
    without a margin drops pairs that the plain version keeps. Also
    triangles with a vertex one pixel outside a region, which cover part
    of it or miss it by one pixel. z = 0.5 everywhere; C = 8."""
    rng = np.random.default_rng(seed)
    scale = np.float32(common.PIXEL_SCALE)
    rows = []

    def centre(index):
        return (np.float32(index) + np.float32(0.5)) * scale - np.float32(1)

    for ry in range(0, common.TILE_H, REGION_H):
        for rx in range(0, common.TILE_W, REGION_W):
            corners = [(rx + dx, ry + dy) for dx in (0, REGION_W - 1)
                       for dy in (0, REGION_H - 1)]
            corners += [(rx - 1, ry), (rx + REGION_W, ry + REGION_H)]
            for col, row in corners:
                xc, yc = centre(col), centre(row)
                for sx, sy in ((1, 1), (1, -1), (-1, 1), (-1, -1)):
                    ka, kb = rng.uniform(0.3, 3.0, 2)
                    ra, rb = rng.uniform(-0.2, 0.2, 2)
                    # Through (xc, yc), c in f64 rounded once to f32:
                    # e0 = sx ka ((x - xc) + ra (y - yc)) >= 0 and
                    # e1 = sy kb ((y - yc) + rb (x - xc)) >= 0 tilt by
                    # less than a pixel over the region, so they hold
                    # the quadrant's pixel centres; e2 = 0.5 - sx (x - xc)
                    # - sy (y - yc) > 0 near the vertex.
                    e0 = [sx * ka, sx * ka * ra, 0.0]
                    e1 = [sy * kb * rb, sy * kb, 0.0]
                    e2 = [-sx, -sy, 0.0]
                    for e, base in ((e0, 0.0), (e1, 0.0), (e2, 0.5)):
                        e[:2] = np.float32(e[:2])
                        e[2] = base - (float(e[0]) * float(xc)
                                       + float(e[1]) * float(yc))
                    rows.append(np.concatenate([e0, e1, e2, [0.5] * 3,
                                                [1.0] * 3, [1.0]]))
    chunk = 8
    data = np.asarray(rows, np.float32)
    data = np.concatenate([data, np.zeros((-len(data) % chunk, 16),
                                          np.float32)])
    visits = len(data) // chunk
    return _with_contraction_rows(data, visits, chunk, device) + (visits,
                                                                  chunk)


def make_depth_tie_inputs(device, visits=64, chunk=8, period=61):
    """(data, coeff, visits, chunk) as make_inputs' pair, for a table of
    exact depth ties: row i copies row i mod `period` of make_inputs'
    table (a prime period, so a triangle's copies fall in other visits,
    visit splits and cluster CTAs), and every third base row has z 0 (its
    pairs' z is +0.0 or -0.0). Each pixel's winner is then the last copy
    of its best triangle: the tie to the larger id, across the kernels'
    splits."""
    base = make_inputs(visits, chunk, "cpu")[0].numpy()
    base[0:period:3, 9:12] = 0.0
    data = base[np.arange(visits * chunk) % period]
    return _with_contraction_rows(data, visits, chunk, device) + (visits,
                                                                  chunk)


def _with_contraction_rows(data, visits, chunk, device):
    """(data, coeff) on `device`: the packed rows [visits*C, 16] and their
    edge-major contraction rows [visits*5C, 8] (make_inputs)."""
    m = data.reshape(visits, chunk, 16)
    a = m[:, :, 0:9].reshape(visits, chunk, 3, 3)
    num_c = np.einsum("vcek,vce->vck", a, m[:, :, 9:12])
    den_c = np.einsum("vcek,vce->vck", a, m[:, :, 12:15])
    coeff = np.concatenate(
        [a.transpose(0, 2, 1, 3).reshape(visits, chunk * 3, 3), num_c,
         den_c], axis=1)
    coeff = np.pad(coeff, [(0, 0), (0, 0), (0, 5)])
    coeff = coeff.reshape(visits * 5 * chunk, 8).astype(np.float32)
    return tuple(torch.from_numpy(x).to(device) for x in (data, coeff))


def _winner(e0, e1, e2, z, valid):
    """Per pixel over all [T, N] pairs: the smallest valid z, ties to the
    larger id (the row index), and the winner's edge values; what the
    per-visit carry merge reaches after the last visit."""
    n_tri = z.shape[0]
    ids = torch.arange(n_tri, device=z.device)[:, None]
    z_masked = torch.where(valid, z, torch.inf)
    best_z = z_masked.amin(0)
    at_min = valid & (z_masked == best_z)
    best_id = torch.where(at_min, ids, -1).amax(0)
    covered = best_id >= 0
    row = best_id.clamp(min=0)[None]
    w = [torch.where(covered, e.gather(0, row)[0], 0.0) for e in (e0, e1, e2)]
    return (torch.where(covered, best_z, 2.0), best_id.to(torch.int32), *w)


def zbuffer_prod_torch(data):
    """Plain version of the prod kernel: (z, id i32, we0, we1, we2), each
    [16, 128], from [T, 16] packed rows (T = visits * C)."""
    px, py = common.tile_pixel_coords(data.device)
    e0, e1, e2, num, den = common.affine_values(data, px, py)  # [T, N]
    z = num / torch.where(den != 0.0, den, 1.0)
    valid = (pixel_is_inside(e0, e1, e2) & (data[:, 15, None] > 0.0)
             & (z >= -1.0) & (z <= 1.0))
    return tuple(t.view(common.TILE_H, common.TILE_W)
                 for t in _winner(e0, e1, e2, z, valid))


def tc_pairs(coeff, visits, chunk):
    """The tc kernel's per-pair values as its plain version computes them:
    (e0, e1, e2, z, valid), each [visits*C, 2048], from the [visits*5C, 8]
    contraction rows."""
    px, py = common.tile_pixel_coords(coeff.device)
    pix = torch.stack([px, py, torch.ones_like(px)])  # [3, N]
    a_hi, a_lo = common.tf32_split(coeff.view(visits, 5 * chunk, 8)[..., :3])
    b_hi, b_lo = common.tf32_split(pix)
    out = a_hi @ b_hi + (a_hi @ b_lo + a_lo @ b_hi)  # [V, 5C, N]
    e0, e1, e2, num, den = (
        out[:, k * chunk:(k + 1) * chunk].reshape(visits * chunk, -1)
        for k in range(5))
    z = num / torch.where(den != 0.0, den, 1.0)
    valid = pixel_is_inside(e0, e1, e2) & (z >= -1.0) & (z <= 1.0)
    return e0, e1, e2, z, valid


def zbuffer_tc_torch(coeff, visits, chunk):
    """Plain version of the tc kernel: (z, id i32, we0, we1, we2), each
    [1, 2048], from the [visits*5C, 8] contraction rows."""
    return tuple(t.view(1, common.N_PIX)
                 for t in _winner(*tc_pairs(coeff, visits, chunk)))


def check_tc(kernel, pairs):
    """Hold a tc z-buffer (z, id, we0, we1, we2) against the plain
    version's pair values `pairs` (tc_pairs). At every pixel the z must lie
    within Z_TOL of the plain best z, and the edge values must lie within
    Z_TOL of the plain max |value| of the plain values of the pair it names.
    Where its id differs from the plain winner's, that pair must be valid in
    the plain version with a z within Z_TOL of the plain best: a winner may
    move only between two depths that lie within Z_TOL. Returns (pixels
    whose ids differ, max |z difference|, max |edge value difference|);
    raises AssertionError otherwise."""
    e0, e1, e2, z, valid = pairs
    z_p, id_p, *w_p = (t.reshape(-1) for t in _winner(*pairs))
    z_k, id_k, *w_k = (t.reshape(-1) for t in kernel)
    picked = (id_k >= 0) & (id_k < z.shape[0])
    row = torch.where(picked, id_k, 0).long()[None]
    picked = picked & valid.gather(0, row)[0]
    near = picked & ((z.gather(0, row)[0] - z_p).abs() <= Z_TOL)
    moved = id_k != id_p
    if bool((moved & ~near).any()):
        bad = int((moved & ~near).sum())
        raise AssertionError(
            f"tc vs plain: the id differs at {int(moved.sum())} pixels, at "
            f"{bad} of them naming no valid pair within {Z_TOL} of the plain"
            f" best z")
    z_gap = float((z_k - z_p).abs().max())
    w_gap = max(float((w - torch.where(picked, e.gather(0, row)[0],
                                       0.0)).abs().max())
                for w, e in zip(w_k, (e0, e1, e2)))
    w_scale = max(float(w.abs().max()) for w in w_p)
    if not (z_gap <= Z_TOL and w_gap <= Z_TOL * w_scale):
        raise AssertionError(
            f"tc vs plain: z gap {z_gap}, edge values {w_gap} of {w_scale};"
            f" tolerance {Z_TOL}")
    return int(moved.sum()), z_gap, w_gap


def tc_keeps(coeff, visits, chunk):
    """[TILE_H / 2, TILE_W / 16, visits * C] bool: the plain model of the
    tc kernel's cull, whether each triangle is kept for each warp region
    (2 rows x 16 columns; pixel (r, c) lies in region [r // 2, c // 16]).
    A triangle is dropped when one of its edges a x + b y + c, evaluated
    in f32 in the kernel's order at the region's four corner pixel
    centres, is below -CULL_MARGIN (|a| max|x| + |b| max|y| + |c|) at all
    four."""
    device = coeff.device
    f32 = dict(dtype=torch.float32, device=device)
    rows = coeff.view(visits, 5, chunk, 8)[:, :3, :, :3]  # [V, 3, C, 3]
    edges = rows.permute(1, 0, 2, 3).reshape(3, visits * chunk, 3)
    a, b, c = (edges[..., k][:, None, None, :] for k in range(3))
    scale = torch.tensor(common.PIXEL_SCALE, **f32)

    def ndc(index):
        return ((index.to(torch.float32) + 0.5) * scale - 1.0)

    x0 = torch.arange(0, common.TILE_W, REGION_W, device=device)
    y0 = torch.arange(0, common.TILE_H, REGION_H, device=device)
    x_lo, x_hi = (ndc(x)[None, :, None] for x in (x0, x0 + REGION_W - 1))
    y_lo, y_hi = (ndc(y)[:, None, None] for y in (y0, y0 + REGION_H - 1))
    one = torch.tensor(1.0, **f32)
    x_max = torch.fmax(one, torch.fmax(x_lo.abs(), x_hi.abs()))
    y_max = torch.fmax(one, torch.fmax(y_lo.abs(), y_hi.abs()))
    top = torch.fmax(torch.fmax(a * x_lo + b * y_lo + c, a * x_hi + b * y_lo
                                + c),
                     torch.fmax(a * x_lo + b * y_hi + c, a * x_hi + b * y_hi
                                + c))
    margin = torch.tensor(CULL_MARGIN, **f32) * (
        a.abs() * x_max + b.abs() * y_max + c.abs())
    return ~(top < -margin).any(0)


def tc_cull_counts(coeff, visits, chunk):
    """Where the tc kernel's work falls: {pairs (all visits * C * 2048),
    kept_pairs (the pairs of the triangles `tc_keeps` keeps for their
    region), group_pairs (those that its groups of 8 run through the
    products: per region and CTA stage of STAGE_TRIS triangles, the kept
    triangles rounded up to a multiple of 8), the two as fractions of
    pairs, and busiest_groups (the most groups of 8 one warp runs in one
    stage)}."""
    keeps = tc_keeps(coeff, visits, chunk)
    per_split = visits // common.visit_splits(visits) * chunk
    n_tri = visits * chunk
    # Each triangle's stage, named by its first triangle.
    tri = torch.arange(n_tri, device=coeff.device)
    stage = tri - tri % per_split + tri % per_split // STAGE_TRIS * STAGE_TRIS
    region_px = REGION_H * REGION_W
    per_stage = torch.zeros(keeps.shape[:2] + (n_tri,), dtype=torch.long,
                            device=coeff.device)
    per_stage.index_add_(2, stage, keeps.long())
    per_region_groups = (per_stage + 7) // 8
    groups = int(per_region_groups.sum())
    pairs = n_tri * common.N_PIX
    kept_pairs = int(keeps.sum()) * region_px
    group_pairs = groups * 8 * region_px
    return {"pairs": pairs, "kept_pairs": kept_pairs,
            "group_pairs": group_pairs,
            "kept_fraction": kept_pairs / pairs if pairs else 0.0,
            "group_fraction": group_pairs / pairs if pairs else 0.0,
            "busiest_groups": int(per_region_groups.max()) if n_tri else 0}


def pair_counts(data):
    """(pairs a cull must keep, pairs inside a live triangle) of the [T, 16]
    rows: what a bound counts. A cull must keep, per triangle, the pixels of
    the tile in the bounding box of the pixel centres the triangle covers
    (K1's and K3's bounds count the pairs in the triangles' bboxes in the
    same way); every other pair can be skipped unseen, by prod and tc
    alike."""
    px, py = common.tile_pixel_coords(data.device)
    inside = pixel_is_inside(*common.affine_values(data, px, py)[:3])
    covers = (inside & (data[:, 15, None] > 0.0)).view(
        -1, common.TILE_H, common.TILE_W)

    def extent(hit):  # [T, L] -> span of the hits along L
        index = torch.arange(hit.shape[1], device=hit.device)
        lo = torch.where(hit, index, hit.shape[1]).amin(1)
        hi = torch.where(hit, index, -1).amax(1)
        return (hi - lo + 1).clamp(min=0)

    boxed = extent(covers.any(2)) * extent(covers.any(1))
    return int(boxed.sum()), int(covers.sum())


def _outputs(device, shape):
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.empty(shape, **f32),
            torch.empty(shape, dtype=torch.int32, device=device),
            torch.empty((3,) + shape, **f32))


def _sms(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def prod_shape(visits, chunk, device):
    """prod's launch at `visits` on the card of `device`: {splits
    (prod_splits), group, split (CTAs per cluster, K3's rule), ctas,
    ctas_per_sm, sms, slots (resident CTAs of its group-1 kernel)}."""
    splits = prod_splits(visits, _sms(device))
    shape = (ctypes.c_int * 4)()
    lib = kernels.load_library()
    with torch.cuda.device(device):
        error = lib.mxu_full_prod_shape(visits, chunk, splits,
                                        ctypes.addressof(shape))
    kernels.check_cuda_error(lib, error, "mxu_full_prod_shape")
    group, split, sms, slots = shape
    blocks = -(-common.TILE_W // (16 * group)) * -(-common.TILE_H
                                                   // (16 * group))
    ctas = splits * blocks * split
    return {"splits": splits, "group": group, "split": split, "ctas": ctas,
            "ctas_per_sm": ctas / sms, "sms": sms, "slots": slots}


def launch_prod(data, visits, chunk, shape=None):
    """The prod kernel (csrc/mxu_full.cu) on CUDA [visits*C, 16] rows;
    zbuffer_prod_torch's contract. `shape` (visit splits, group, split)
    forces a launch, for measurement only; by default prod_splits and K3's
    rule choose it."""
    common.check_operands(data.device, [("data", data,
                                         (visits * chunk, 16))])
    splits, group, split = shape or (prod_splits(visits, _sms(data.device)),
                                     0, 0)
    if visits % splits:
        raise ValueError(f"{splits} splits do not divide {visits} visits")
    z, ids, w = out = _outputs(data.device, (common.TILE_H, common.TILE_W))
    # One split writes the outputs as its partials.
    part = (out if splits == 1
            else _outputs(data.device, (splits, common.N_PIX)))
    common.launch("mxu_full_prod", data.device, data.data_ptr(),
                  *(t.data_ptr() for t in part), z.data_ptr(),
                  ids.data_ptr(), w.data_ptr(), visits, chunk, splits, group,
                  split, common.PIXEL_SCALE)
    profiling.count("launches.mxu_full_prod")
    return z, ids, w[0], w[1], w[2]


def launch_tc(coeff, visits, chunk):
    """The tc kernel (csrc/mxu_full.cu) on CUDA [visits*5C, 8] rows;
    zbuffer_tc_torch's contract. C must be a multiple of 8: a tensor-core
    tile holds 8 triangles' five functions."""
    if chunk % 8:
        raise ValueError(f"the tc kernel needs a chunk that is a multiple of"
                         f" 8, got {chunk}")
    common.check_operands(coeff.device, [("table", coeff,
                                          (visits * 5 * chunk, 8))])
    splits = common.visit_splits(visits)
    part_z, part_id, part_w = _outputs(coeff.device, (splits, common.N_PIX))
    z, ids, w = _outputs(coeff.device, (1, common.N_PIX))
    common.launch("mxu_full_tc", coeff.device, coeff.data_ptr(),
                  part_z.data_ptr(), part_id.data_ptr(), part_w.data_ptr(),
                  z.data_ptr(), ids.data_ptr(), w.data_ptr(), visits, chunk,
                  splits, common.PIXEL_SCALE)
    profiling.count("launches.mxu_full_tc")
    return z, ids, w[0], w[1], w[2]


def zbuffer(variant, data, coeff, visits, chunk):
    """One variant's z-buffer: its kernel on CUDA tensors, its plain
    version on CPU tensors."""
    on_card = data.device.type == "cuda"
    if variant == "prod":
        return (launch_prod(data, visits, chunk) if on_card
                else zbuffer_prod_torch(data))
    if variant == "tc":
        return (launch_tc(coeff, visits, chunk) if on_card
                else zbuffer_tc_torch(coeff, visits, chunk))
    raise ValueError(f"unknown variant {variant!r}")


def run(visits=512, chunk=8, iters=30, device="cuda"):
    """Compute, compare and time both variants; returns the JSON dict."""
    dev = resolve_device(device)
    data, coeff = make_inputs(visits, chunk, dev)
    calls = {name: (lambda name=name: zbuffer(name, data, coeff, visits,
                                              chunk))
             for name in VARIANTS}
    res_p, res_t = calls["prod"](), calls["tc"]()
    id_p, id_t = res_p[1].reshape(-1), res_t[1].reshape(-1)
    results = {
        "covered_px": int((id_p >= 0).sum()),
        "id_mismatch_px": int((id_p != id_t).sum()),
        "max_abs_z_gap": float((res_p[0].reshape(-1)
                                - res_t[0].reshape(-1)).abs().max()),
    }
    for name, call in calls.items():
        results.update(common.times_us(name, call, dev, iters))
    cull = tc_cull_counts(coeff, visits, chunk)
    if dev.type == "cuda":
        results["prod_shape"] = prod_shape(visits, chunk, dev)
    results.update(chunk=chunk, visits=visits,
                   device=common.device_name(dev),
                   speedup=results["prod_us"] / results["tc_us"],
                   tc_kept_fraction=cull["kept_fraction"],
                   tc_group_fraction=cull["group_fraction"],
                   tc_busiest_groups=cull["busiest_groups"])
    return results


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--visits", type=int, default=512)
    parser.add_argument("--iters", type=int, default=30)
    parser.add_argument("--chunk", type=int, default=8)
    parser.add_argument("--device", default="cuda",
                        help="cuda: the kernels; cpu: the plain versions")
    args = parser.parse_args(argv)
    print(json.dumps(run(args.visits, args.chunk, args.iters, args.device)))


if __name__ == "__main__":
    main()
