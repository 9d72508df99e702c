"""The whole per-visit pipeline: production core vs a tensor-core core.

Port of scripts/mxu_full_microbench.py (S2), the integration question
behind mxu_edge: does a contraction on the matrix unit still win once the
whole per-visit pipeline (inside test, depth divide, valid test, winner
selection, carry merge) runs in the contraction's pixel-major frame? Both
variants produce the z-buffer of one 16x128 tile over `visits` visits of C
synthetic triangles: per pixel the smallest valid z, ties to the larger
triangle id, the winner's raw edge values (z = 2, id = -1 and zeros where
no triangle is valid).

  * `prod` (the script's `prod`): the production core unchanged,
    `rasterize_pixel` of csrc/rasterize_common.cuh (K1's and K3's loop, with
    its per-block cull), on the packed rows, with positional ids;
  * `tc` (`mxu`): per visit the 3xTF32 `mma.sync` contraction
    [5C, 3 -> 8] @ [8, 2048], then the same masking and winner on the
    products (mxu_full_microbench.py:131-152). Like the JAX kernel it
    omits the production live-column test: harmless here because the
    synthetic table sets column 15 to 1 everywhere, but it measures the
    tc side one compare per pair lighter than a faithful port.

Both kernels (csrc/mxu_full.cu) split the visits over the same blocks and
merge the partial winners in one shared second pass; they differ in how a
pair's five values are computed. Each sits beside a plain PyTorch version:
`zbuffer_prod_torch` computes what `rasterize_pixel` computes (bit for bit);
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
back-to-back calls by CUDA events) and `speedup` = prod / tc.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..ops.barycentric import pixel_is_inside
from . import common

VARIANTS = ("prod", "tc")

# Launches of each variant's kernel in this process; each wrapper adds one
# per launch (its two passes) and nothing else touches them.
LAUNCHES = {name: 0 for name in VARIANTS}

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


def _launch(entry, table, table_shape, visits, chunk, shape):
    common.check_operands(table.device, [("table", table, table_shape)])
    splits = common.visit_splits(visits)
    part_z, part_id, part_w = _outputs(table.device, (splits, common.N_PIX))
    z, ids, w = _outputs(table.device, shape)
    common.launch(entry, table.device, table.data_ptr(), part_z.data_ptr(),
                  part_id.data_ptr(), part_w.data_ptr(), z.data_ptr(),
                  ids.data_ptr(), w.data_ptr(), visits, chunk, splits,
                  common.PIXEL_SCALE)
    return z, ids, w[0], w[1], w[2]


def launch_prod(data, visits, chunk):
    """The prod kernel (csrc/mxu_full.cu) on CUDA [visits*C, 16] rows;
    zbuffer_prod_torch's contract."""
    out = _launch("mxu_full_prod", data, (visits * chunk, 16), visits, chunk,
                  (common.TILE_H, common.TILE_W))
    LAUNCHES["prod"] += 1
    return out


def launch_tc(coeff, visits, chunk):
    """The tc kernel (csrc/mxu_full.cu) on CUDA [visits*5C, 8] rows;
    zbuffer_tc_torch's contract. C must be a multiple of 8: a tensor-core
    tile holds 8 triangles' five functions."""
    if chunk % 8:
        raise ValueError(f"the tc kernel needs a chunk that is a multiple of"
                         f" 8, got {chunk}")
    out = _launch("mxu_full_tc", coeff, (visits * 5 * chunk, 8), visits,
                  chunk, (1, common.N_PIX))
    LAUNCHES["tc"] += 1
    return out


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
    dev = common.resolve_device(device)
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
    results.update(chunk=chunk, visits=visits,
                   device=common.device_name(dev),
                   speedup=results["prod_us"] / results["tc_us"])
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
