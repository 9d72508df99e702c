"""Per-triangle patches with a winner merge through device memory, against
the production forward.

Port of scripts/patch_scatter_microbench.py (S3). The production kernels
test every pixel of a block against every triangle that may cover it; most
(pixel, triangle) lanes are empty. The patch decomposition gives each
triangle its own PH x PW pixel windows (PH * PW = 128 lanes) anchored at
its bbox corner, evaluates (triangle, own pixel) lanes densely, and then
has to find each pixel's winner through device memory, because the lanes
of one pixel lie in different patches. Three stages, each timed:

  * A, the plan (`plan`, plain PyTorch, as it was XLA): per triangle, the
    NDC bbox (the `_bbox_live_cols` formula of the JAX package's
    binning.py:65-84: the port's 16-column rows carry no bbox), its patch
    count, and the compaction of all patch instances into a flat table of
    `budget = budget_factor * T` rows per image; triangles past `cap`
    instances or past the budget are dropped and counted;
  * B, the patch-eval kernel (`csrc/patch_eval.cu`, replaces the script's
    Pallas `kernel`): one thread per (instance, lane), the per-lane edge,
    depth and valid math of rasterize_common.cuh, no winner: z (2 where
    not valid) and the valid lane's raw edge values;
  * C, the winner merge (plain PyTorch, as it was XLA), two ways: a
    lexicographic sort by (pixel, z, -id) with two stable sorts, then the
    first lane of each pixel scattered to the image (`merge_sort`); or a
    scatter-min of z's monotone int key per pixel, a scatter-max of the id
    among the z-minimal lanes and a scatter of the winners
    (`merge_scatter`). Both give the production contract: ids, bc, z.

The baseline is the port's production forward on the same clip vertices:
K3 (`rasterize_barycentric_cuda`, packing included). The script's contract
is checked: both merges give K3's ids, with bc and z within 1e-6, and no
triangle is dropped.

    python -m pytorch_mesh_renderer_tpu_torch.microbench.patch_scatter \
        [--config headline|stress] [--batch 4] [--iters 20] [--windows 3]
        [--cap 32] [--patch 16x8] [--budget-factor 4] [--device cuda|cpu]

prints the script's JSON line. Times are medians over windows of
back-to-back calls, by CUDA events on a card (host enqueueing included)
and by the host clock on the CPU.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..ops import rasterize_barycentric_cuda as rb
from ..ops import rasterize_cuda as rc
from ..ops.barycentric import pixel_is_inside
from ..utils import scenes
from ..utils.device import resolve_device
from . import common

# Launches of the patch-eval kernel in this process; the wrapper adds one
# per launch and nothing else touches it.
LAUNCHES = {"patch_eval": 0}

LANES = 128
# Instance rows per budget quantum (the script's IC, an f32 sublane tile).
IC = 8
# The JAX package pads its packed triangle table to TRI_CHUNK = 16 rows
# (rasterize_pallas.py:125); the plan's budget and dead id follow it.
TRI_PAD = 16
# Instance row: the 16 packed columns of its triangle, then the patch
# origin (column, row) in pixels and two zeros: 80 bytes, five float4.
TABLE_COLS = 20

# fp32 operations of one live lane in the patch-eval body: the pixel
# centre (4), the edge functions (12), the inside test (6), num and den
# (10), the divide and its select (2), the valid tests (5) and the four
# outputs (4).
OPS_PER_LANE = 43

CONFIGS = {"headline": (256, None), "stress": (512, 72)}


def parse_patch(text):
    ph, pw = (int(x) for x in text.split("x"))
    if ph * pw != LANES:
        raise ValueError(f"patch {text} must flatten to {LANES} lanes")
    return ph, pw


def pack(clip, triangles):
    """(rows [B, T_pad, 16], bbox [B, T_pad, 4] = min_x, max_x, min_y,
    max_y in NDC): rasterize_cuda.pack_rows and binning._bbox_live_cols,
    padded with dead zero rows to a multiple of TRI_PAD."""
    rows, _ = rc.pack_rows(clip, triangles, False)
    tv = clip[:, triangles.long()]
    x, y, vw = tv[..., 0], tv[..., 1], tv[..., 3]
    eps = 1e-6
    safe_w = torch.where(vw.abs() > eps, vw, eps)
    ndc_x, ndc_y = x / safe_w, y / safe_w
    unbounded = (vw <= eps).any(-1)
    big = 4.0
    bbox = torch.stack([
        torch.where(unbounded, -big, ndc_x.amin(-1)),
        torch.where(unbounded, big, ndc_x.amax(-1)),
        torch.where(unbounded, -big, ndc_y.amin(-1)),
        torch.where(unbounded, big, ndc_y.amax(-1))], -1)
    pad = TRI_PAD if rows.shape[1] == 0 else -rows.shape[1] % TRI_PAD
    return (torch.nn.functional.pad(rows, (0, 0, 0, pad)).contiguous(),
            torch.nn.functional.pad(bbox, (0, 0, 0, pad)))


def plan(rows, bbox, size, patch, cap, budget_factor):
    """Stage A: the patch-instance table (patch_scatter_microbench.py:
    121-187).

    Returns (table [B, S, 20] f32, inst_tri [B, S] int64 source triangle
    per instance (T_pad for a dead slot), n_dropped [B]: eligible
    triangles lost to the cap or the budget). S = budget.
    """
    ph, pw = patch
    batch, t_pad, _ = rows.shape
    budget = -(-budget_factor * t_pad // IC) * IC
    device = rows.device
    live = rows[..., 15] > 0.0
    half = size / 2

    def bound(v, fn):
        return fn(v).clamp(0, size - 1).long()

    c_lo = bound((bbox[..., 0] + 1.0) * half - 0.5, torch.floor)
    c_hi = bound((bbox[..., 1] + 1.0) * half - 0.5, torch.ceil)
    r_lo = bound((bbox[..., 2] + 1.0) * half - 0.5, torch.floor)
    r_hi = bound((bbox[..., 3] + 1.0) * half - 0.5, torch.ceil)
    nx = (c_hi - c_lo + pw) // pw
    ny = (r_hi - r_lo + ph) // ph
    nspan = nx * ny
    eligible = live & (nspan > 0)
    keep = eligible & (nspan <= cap)
    counts = torch.where(keep, nspan, 0)
    starts = counts.cumsum(-1) - counts
    keep = keep & (starts + counts <= budget)

    k = torch.arange(cap, device=device)
    nx_safe = nx.clamp(min=1)[..., None]
    ox = c_lo[..., None] + (k % nx_safe) * pw  # [B, T, cap]
    oy = r_lo[..., None] + (k // nx_safe) * ph
    valid_k = keep[..., None] & (k < nspan[..., None])
    # Valid slots are distinct by construction; the rest go to slot
    # `budget`, which is dropped.
    dst = torch.where(valid_k, starts[..., None] + k, budget).view(batch, -1)
    src_tri = torch.arange(t_pad, device=device)[:, None].expand(
        t_pad, cap).reshape(1, -1).expand(batch, -1)

    def scatter(values, fill):
        out = torch.full((batch, budget + 1), fill, dtype=values.dtype,
                         device=device)
        return out.scatter_(1, dst, values.reshape(batch, -1))[:, :budget]

    inst_tri = scatter(src_tri, t_pad)
    inst_o = [scatter(o.float(), 0.0) for o in (ox, oy)]
    n_dropped = (eligible & ~keep).sum(-1)
    # Gather each instance's packed row; the sentinel row T_pad is dead.
    ext = torch.cat([rows, rows.new_zeros(batch, 1, rc.TRI_COLS)], 1)
    gathered = ext.gather(1, inst_tri[..., None].expand(-1, -1, rc.TRI_COLS))
    zeros = torch.zeros_like(inst_o[0])
    table = torch.cat([gathered] + [t[..., None] for t in (*inst_o, zeros,
                                                           zeros)], -1)
    return table.contiguous(), inst_tri, n_dropped


def patch_eval_torch(table, size, patch):
    """Plain version of the patch-eval kernel (patch_scatter_microbench.py:
    191-219): (z, we0, we1, we2), each [B, S, 128] f32."""
    _, pw = patch
    lane = torch.arange(LANES, device=table.device)
    fx = table[..., 16, None] + (lane % pw).float()  # pixel column
    fy = table[..., 17, None] + (lane // pw).float()  # row 0 at NDC -1
    scale = rc.pixel_scale(size)
    px = (fx + 0.5) * scale - 1.0
    py = (fy + 0.5) * scale - 1.0
    e0, e1, e2, num, den = common.affine_values(table, px, py)
    z = num / torch.where(den != 0.0, den, 1.0)
    valid = (pixel_is_inside(e0, e1, e2) & (table[..., 15, None] > 0.0)
             & (z >= -1.0) & (z <= 1.0) & (fx < size) & (fy < size))
    wf = valid.float()
    return torch.where(valid, z, 2.0), wf * e0, wf * e1, wf * e2


def launch_patch_eval(table, size, patch):
    """The patch-eval kernel on a CUDA [B, S, 20] table; patch_eval_torch's
    contract."""
    common.check_operands(table.device,
                          [("table", table, (None, None, TABLE_COLS))])
    n_inst = table.shape[0] * table.shape[1]
    if n_inst * LANES >= 2 ** 31:
        raise ValueError("the table exceeds the kernel's int32 extents")
    out = torch.empty((4,) + table.shape[:2] + (LANES,),
                      dtype=torch.float32, device=table.device)
    common.launch("patch_eval", table.device, table.data_ptr(),
                  out.data_ptr(), n_inst, size, patch[1],
                  rc.pixel_scale(size))
    LAUNCHES["patch_eval"] += 1
    return tuple(out)


def patch_eval(table, size, patch):
    """Stage B: the kernel on a CUDA table, its plain version on the CPU."""
    if table.device.type == "cuda":
        return launch_patch_eval(table, size, patch)
    return patch_eval_torch(table, size, patch)


def _lane_pixels(z, table, size, patch):
    """[B, S*128] pixel index of every lane, size*size where not valid."""
    ph, pw = patch
    lane = torch.arange(LANES, device=z.device)
    fx = table[..., 16].long()[..., None] + lane % pw
    fy = table[..., 17].long()[..., None] + lane // pw
    pid = torch.where(z < 2.0, fy * size + fx, size * size)
    return pid.reshape(z.shape[0], -1)


def _images(img, best_id_ok, size):
    """(ids, bc, z) images from per-pixel winner rows [B, HW, 5] = (id, we0,
    we1, we2, min(z, 1)) and the mask of pixels that have a winner."""
    batch = img.shape[0]
    wsum = img[..., 1] + img[..., 2] + img[..., 3]
    inv = 1.0 / torch.where(wsum != 0.0, wsum, 1.0)
    bc = img[..., 1:4] * inv[..., None]
    ids = torch.where(wsum != 0.0, img[..., 0].int(), 0)
    z = torch.where(best_id_ok, img[..., 4], 1.0)
    return (ids.view(batch, size, size), bc.view(batch, size, size, 3),
            z.view(batch, size, size))


def _monotone_key(z):
    """int64 keys in (-2^31, 2^31) in the order of the f32 values (-0 and
    +0 coincide)."""
    bits = z.view(torch.int32).long()
    return torch.where(bits >= 0, bits, -2 ** 31 - bits)


def merge_sort(z, w0, w1, w2, table, inst_tri, size, patch):
    """Stage C by sorting (patch_scatter_microbench.py:237-277): per pixel
    the smallest z, ties to the larger id -> (ids, bc, z) images."""
    batch = z.shape[0]
    hw = size * size
    pid = _lane_pixels(z, table, size, patch)
    tid = inst_tri[..., None].expand(z.shape).reshape(batch, -1)
    zf = z.reshape(batch, -1)
    # (pixel, z, -id) lexicographically: a stable sort by -id, then a
    # stable sort by the (pixel, z) key packed in one int64.
    order = torch.sort(-tid, dim=1, stable=True).indices
    key = (pid.gather(1, order) << 32) + (
        _monotone_key(zf.gather(1, order)) + 2 ** 31)
    order = order.gather(1, torch.sort(key, dim=1, stable=True).indices)
    pid_s = pid.gather(1, order)
    first = (pid_s < hw) & torch.cat([
        torch.ones_like(pid_s[:, :1], dtype=torch.bool),
        pid_s[:, 1:] != pid_s[:, :-1]], 1)
    dst = torch.where(first, pid_s, hw)  # row hw collects the rest
    vals = torch.stack([tid.gather(1, order).float()] + [
        t.reshape(batch, -1).gather(1, order) for t in (w0, w1, w2)]
        + [zf.gather(1, order).clamp(max=1.0)], -1)
    img = torch.zeros(batch, hw + 1, 5, device=z.device).scatter_(
        1, dst[..., None].expand(-1, -1, 5), vals)[:, :hw]
    has = torch.zeros(batch, hw + 1, dtype=torch.bool,
                      device=z.device).scatter_(1, dst, True)[:, :hw]
    return _images(img, has, size)


def merge_scatter(z, w0, w1, w2, table, inst_tri, size, patch):
    """Stage C by scatter-min (patch_scatter_microbench.py:279-333): the
    smallest z key per pixel, the largest id among the lanes at it, then
    the winners' values -> (ids, bc, z) images."""
    batch = z.shape[0]
    hw = size * size
    offset = torch.arange(batch, device=z.device)[:, None] * (hw + 1)
    gpid = (_lane_pixels(z, table, size, patch) + offset).reshape(-1)
    tid = inst_tri[..., None].expand(z.shape).reshape(-1)
    zf = z.reshape(-1)
    zkey = _monotone_key(zf)
    slots = batch * (hw + 1)
    dump = (gpid // (hw + 1)) * (hw + 1) + hw  # each image's row hw
    zmin = torch.full((slots,), 2 ** 62, dtype=torch.int64,
                      device=z.device).scatter_reduce_(0, gpid, zkey, "amin")
    at_min = (zkey == zmin[gpid]) & (gpid != dump)
    pid_min = torch.where(at_min, gpid, dump)
    idmax = torch.full((slots,), -1, dtype=torch.int64,
                       device=z.device).scatter_reduce_(0, pid_min, tid,
                                                        "amax")
    winner = at_min & (tid == idmax[pid_min])
    dst = torch.where(winner, gpid, dump)
    vals = torch.stack([tid.float(), w0.reshape(-1), w1.reshape(-1),
                        w2.reshape(-1), zf.clamp(max=1.0)], -1)
    img = torch.zeros(slots, 5, device=z.device).index_put_((dst,), vals)
    img = img.view(batch, hw + 1, 5)[:, :hw]
    has = (idmax >= 0).view(batch, hw + 1)[:, :hw]
    return _images(img, has, size)


def production(clip, triangles, size):
    """The baseline: K3 on a card, its plain version on the CPU."""
    fn = (rb.rasterize_barycentric_cuda if clip.device.type == "cuda"
          else rb.rasterize_barycentric_torch)
    return fn(clip, triangles, size, size)


def run(config="headline", batch=4, iters=20, windows=3, cap=32,
        patch="16x8", budget_factor=4, device="cuda"):
    """Build the scene, check both merges against the production forward
    and time every stage; returns (the JSON dict, the instance table that
    stage B evaluated)."""
    patch = parse_patch(patch)
    dev = resolve_device(device)
    size, sphere = CONFIGS[config]
    scene = scenes.build_scene(batch, dev, sphere)
    tris = scene["triangles"]
    clip = scenes.clip_vertices(scene, size)

    def patch_forward():
        rows, bbox = pack(clip, tris)
        table, inst_tri, n_dropped = plan(rows, bbox, size, patch, cap,
                                          budget_factor)
        outs = patch_eval(table, size, patch)
        return merge_sort(*outs, table, inst_tri, size, patch), n_dropped

    ids_r, bc_r, z_r = production(clip, tris, size)
    (ids_p, bc_p, z_p), n_dropped = patch_forward()
    rows, bbox = pack(clip, tris)
    table, inst_tri, _ = plan(rows, bbox, size, patch, cap, budget_factor)
    kouts = patch_eval(table, size, patch)
    ids_s, _, _ = merge_scatter(*kouts, table, inst_tri, size, patch)

    def timed(fn):
        return common.wall_ms(fn, dev, iters, windows, warmup=1)

    t_prod = timed(lambda: production(clip, tris, size))
    t_patch = timed(patch_forward)
    t_plan = timed(lambda: plan(rows, bbox, size, patch, cap, budget_factor))
    t_kernel = timed(lambda: patch_eval(table, size, patch))
    t_sort = timed(lambda: merge_sort(*kouts, table, inst_tri, size, patch))
    t_scatter = timed(lambda: merge_scatter(*kouts, table, inst_tri, size,
                                            patch))
    t_pad = rows.shape[1]
    return {
        "config": config, "size": size, "batch": batch,
        "mesh": scene["mesh_name"], "tris": scene["tri_count"],
        "patch": f"{patch[0]}x{patch[1]}", "cap": cap,
        "instances_live": int((inst_tri < t_pad).sum()),
        "instances_padded": int(table.shape[1] * batch),
        "capped_or_overflowed_triangles": int(n_dropped.sum()),
        "lane_evals_patch": int(table.shape[1] * LANES * batch),
        "id_mismatch_px": int((ids_p != ids_r).sum()),
        "bc_max_err": float((bc_p - bc_r).abs().max()),
        "z_max_err": float((z_p - z_r).abs().max()),
        "prod_fwd_ms": t_prod, "patch_fwd_ms": t_patch,
        "patch_plan_ms": t_plan, "patch_kernel_ms": t_kernel,
        "patch_merge_sort_ms": t_sort, "patch_merge_scatter_ms": t_scatter,
        "scatter_id_mismatch_px": int((ids_s != ids_r).sum()),
        "patch_vs_prod": t_prod / t_patch,
        "device": common.device_name(dev),
    }, table


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", choices=sorted(CONFIGS),
                        default="headline")
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--windows", type=int, default=3)
    parser.add_argument("--cap", type=int, default=32,
                        help="max patch instances per triangle; beyond it "
                             "the triangle is dropped (counted)")
    parser.add_argument("--patch", type=str, default="16x8",
                        help="PHxPW with PH*PW == 128")
    parser.add_argument("--budget-factor", type=int, default=4,
                        help="instance-table budget = factor * T_pad")
    parser.add_argument("--device", default="cuda",
                        help="cuda: the kernels; cpu: the plain versions")
    args = parser.parse_args(argv)
    print(json.dumps(run(args.config, args.batch, args.iters, args.windows,
                         args.cap, args.patch, args.budget_factor,
                         args.device)[0]))


if __name__ == "__main__":
    main()
