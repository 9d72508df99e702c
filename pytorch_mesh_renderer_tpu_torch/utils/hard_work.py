"""Where the hard kernels' work falls, and what it costs: the forward K1
(csrc/rasterize_fused_fwd.cu; the cull in csrc/rasterize_common.cuh), the
backward K2 (csrc/rasterize_fused_bwd.cu) and the barycentric-only pair
K3 / K4 (csrc/rasterize_bary_fwd.cu, csrc/rasterize_bary_bwd.cu).

    python -m pytorch_mesh_renderer_tpu_torch.utils.hard_work   # CUDA host
    python -m pytorch_mesh_renderer_tpu_torch.utils.hard_work --device cpu

`kept_counts` evaluates K1's per-block cull (`row_may_cover`: the row is
live and none of its three edge functions is below minus twice its
rounding margin at all four corner pixel centres of the 16x16 block) in
fp32 with the kernel's operation order, on any device, and counts per
image and pixel block the packed rows that pass it, per residue of the
row id modulo a split. `count_summary` turns them into the busy blocks,
the mean and largest kept rows of a block, and, at each split, the kept
rows of the busiest CTA when CTA s of a block takes the rows t = s (mod
split). `split_forward_torch` is the plain model of the split kernel: the
plain forward on each residue's rows, merged per pixel by the smaller z,
then the larger id.

`bwd_counts` counts the backward's work from the forward's ids and bc:
active pixels, their distinct winners (the table rows the backward reads
and writes), the warps that hold one (row-major warps of 32 pixels, the
layout of a one-thread-per-pixel row kernel, and the 8x4 pixel warps of
K2 and K4), the runs of equal winner in a row-major warp (one global
atomic per column each in such a kernel) and the distinct winners of an
8x4 warp (each takes 9 + 3A global atomics in K2, 9 in K4), and the
distinct (16x16 tile, winner) pairs. `warp_gradients_torch` is the plain
model of the reduction that K2 and K4 share: each pixel's terms summed
per (warp, winner), then per winner.

On the card, `main` prints each kernel's registers, spills and CTAs per
SM (`soft_work.kernel_report`) and its launch and device times: K1 at its
compiled split and at each split tried on the teapot at 256x256 batch 4
(the render and training step's shape) and the sphere72 stress mesh at
512x512 batch 4, and on its floor (the teapot's table moved off screen,
x += 100 w, so that every row fails the cull: the stream and the cull
alone); K2 with A = 9 on both scenes and on its floor (every pixel
inactive: ids 0, bc 0); K3 and K4 on both scenes for one image and for
four, K3 at its launcher's rule and at each group and split tried, K4
also on its floor (every pixel inactive); the device time of the hard training step and of the 4-image
`rasterize_barycentric` step; then the counts. On the CPU it prints the
counts only. To compare with an older commit, unpack it into
`.chipcheck/` (git-ignored), copy this file into it and run both in one
call: a launcher without a split is timed at its own.
"""

from __future__ import annotations

import inspect
import json

import torch

BLOCK = 16  # pixel block side (csrc/rasterize_common.cuh)
# The splits of a pixel block's rows tried (CTAs per block, one cluster).
SPLITS = (2, 4, 8)
# name -> (batch, image side, sphere resolution or None for the teapot).
SCENES = {"teapot 256": (4, 256, None), "sphere72 512": (4, 512, 72)}
GROUP = 2  # pixel blocks per side of a K1 cluster's group
# The groups of pixel blocks per side that K3's cluster may cover.
GROUPS = (1, 2)
KERNEL = "rasterize_fused_fwd_kernel"
# The kernels' names in the build log and the profiler.
KERNELS = {"k1": KERNEL, "k2": "rasterize_fused_bwd_kernel",
           "k3": "rasterize_bary_fwd_kernel", "k4": "rasterize_bary_bwd_kernel"}
TILE = 16  # the forward's pixel block, bwd_counts' tiles
WARP = 32
# The warp of K2 and K4: an 8 wide, 4 high pixel block
# (csrc/rasterize_bwd_common.cuh).
K2_WARP = (8, 4)
# step_profiles' label of the hard training step.
TRAIN_STEP = "hard training step"
# The attribute count of the render's rasterizer call (normals, positions,
# diffuse), at which K2 is timed.
RENDER_ATTRS = 9


def _f32(value, device):
    return torch.tensor(value, dtype=torch.float32, device=device)


def _pixel_ndc(index, scale):
    """(index + 0.5) * scale - 1 in f32, the kernels' pixel centre."""
    return (index.to(torch.float32) + 0.5) * scale - 1.0


def block_keeps(table, width, height, row_offset=0, full_height=None):
    """[B, ceil(H/16), ceil(W/16), T] bool: whether each row of `table`
    [B, T, 16] (rasterize_cuda.pack_rows) passes K1's cull for each image
    and pixel block."""
    from ..ops.rasterize_cuda import pixel_scale

    full_height = full_height or height
    device = table.device
    batch, n_tri = table.shape[:2]
    nbx, nby = -(-width // BLOCK), -(-height // BLOCK)
    scale_x = _f32(pixel_scale(width), device)
    scale_y = _f32(pixel_scale(full_height), device)
    x0 = torch.arange(nbx, device=device) * BLOCK
    y0 = torch.arange(nby, device=device) * BLOCK + row_offset
    px_lo = _pixel_ndc(x0, scale_x)
    px_hi = _pixel_ndc((x0 + BLOCK).clamp(max=width) - 1, scale_x)
    py_lo = _pixel_ndc(y0, scale_y)
    py_hi = _pixel_ndc((y0 - row_offset + BLOCK).clamp(max=height) - 1
                       + row_offset, scale_y)
    one = _f32(1.0, device)
    px_max = torch.fmax(one, torch.fmax(px_lo.abs(), px_hi.abs()))
    margin, tiny, two = (_f32(1e-6, device), _f32(1e-30, device),
                         _f32(2.0, device))
    live = table[..., 15] > 0.0  # [B, T]
    keeps = torch.zeros(batch, nby, nbx, n_tri, dtype=torch.bool,
                        device=device)
    # One row of blocks at a time: [B, nbx, T] temporaries.
    x_lo, x_hi, x_max = px_lo[:, None], px_hi[:, None], px_max[:, None]
    for by in range(nby):
        y_lo, y_hi = py_lo[by], py_hi[by]
        y_max = torch.fmax(one, torch.fmax(y_lo.abs(), y_hi.abs()))
        keep = live[:, None, :].expand(batch, nbx, n_tri)
        for edge in range(3):
            a, b, c = (table[:, None, :, 3 * edge + k] for k in range(3))
            corners = [a * x + b * y + c
                       for x in (x_lo, x_hi) for y in (y_lo, y_hi)]
            bound = margin * (a.abs() * x_max + b.abs() * y_max
                              + c.abs()) + tiny
            top = torch.fmax(torch.fmax(corners[0], corners[2]),
                             torch.fmax(corners[1], corners[3]))
            keep = keep & ~(top < -two * bound)
        keeps[:, by] = keep
    return keeps


def kept_counts(table, width, height, split=1, row_offset=0,
                full_height=None, keeps=None):
    """[B, ceil(H/16), ceil(W/16), split] int64: per image and pixel block,
    the rows t = s (mod split) of `table` that pass K1's cull
    (`block_keeps`, or `keeps` when given), for each residue s."""
    if keeps is None:
        keeps = block_keeps(table, width, height, row_offset, full_height)
    return _by_residue(keeps.long(), split)


def group_tests(keeps, split, group=GROUP):
    """[B, groups y, groups x, split] int64: per group of group x group
    pixel blocks (K1's cluster) and residue s, the per-pixel tests one
    thread of CTA s runs: the rows t = s (mod split) that K1's cull
    (`keeps`, block_keeps') keeps, counted once per block they may cover
    (a thread holds one pixel of each block)."""
    batch, nby, nbx, n_tri = keeps.shape
    blocks = torch.nn.functional.pad(
        keeps.long(), (0, 0, 0, -nbx % group, 0, -nby % group))
    per_row = blocks.unflatten(2, (-1, group)).unflatten(1, (-1, group))
    return _by_residue(per_row.sum((2, 4)), split)


def _by_residue(per_row, split):
    """Sums [..., T] over the rows of each residue modulo `split`."""
    per_row = torch.nn.functional.pad(per_row, (0, -per_row.shape[-1] % split))
    return per_row.unflatten(-1, (-1, split)).sum(-2)


def count_summary(table, width, height, splits=SPLITS):
    """{blocks, busy_blocks (>= 1 kept row), mean_kept, max_kept,
    kept_pairs, busiest_cta, busiest_group_cta} of K1's cull on `table` at
    width x height. busiest_cta: {split: most kept rows of one CTA} when
    split CTAs serve each pixel block; busiest_group_cta: {split: most
    per-pixel tests of one thread} when split CTAs serve each group of
    GROUP x GROUP blocks (the shipped design, `group_tests`)."""
    keeps = block_keeps(table, width, height)
    per_block = keeps.sum(-1)
    empty = per_block.numel() == 0 or table.shape[1] == 0
    return {
        "blocks": per_block.numel(),
        "busy_blocks": int((per_block > 0).sum()),
        "mean_kept": float(per_block.float().mean()),
        "max_kept": 0 if empty else int(per_block.max()),
        "kept_pairs": int(per_block.sum()),
        "busiest_cta": {split: 0 if empty else int(kept_counts(
            table, width, height, split, keeps=keeps).max())
            for split in splits},
        "busiest_group_cta": {split: 0 if empty else int(group_tests(
            keeps, split).max()) for split in splits},
    }


def split_forward_torch(clip_vertices, attributes, triangles, width, height,
                        split, **kwargs):
    """The plain model of K1 split over `split` CTAs: the plain forward
    (`rasterize_interpolate_torch`, with z) on the triangles t = s
    (mod split) for each s, ids mapped back, merged per pixel by the
    smaller z, on equal z the larger id; a part with no winner (all its bc
    0) holds the empty carry (z 1, id -1). Returns (ids, bc, attributes,
    z) as the plain forward with z."""
    from ..ops.rasterize_cuda import rasterize_interpolate_torch

    best = None
    for s in range(split):
        ids, bc, attrs, z = rasterize_interpolate_torch(
            clip_vertices, attributes, triangles[s::split], width, height,
            with_z=True, **kwargs)
        carry_id = torch.where(bc.sum(-1) > 0.0, ids.long() * split + s, -1)
        part = (carry_id, bc, attrs, z)
        if best is None:
            best = part
            continue
        better = (z < best[3]) | ((z == best[3]) & (carry_id > best[0]))
        best = tuple(torch.where(better.view(better.shape + (1,) * (
            new.dim() - better.dim())), new, old)
            for new, old in zip(part, best))
    ids, bc, attrs, z = best
    return ids.clamp(min=0).to(torch.int32), bc, attrs, z


def active_pixels(ids, bc):
    """[B, H, W] bool: the pixels whose terms the backward kernels sum
    (not id 0 with a barycentric sum below 0.9, in the kernels' f32
    order)."""
    from ..ops.barycentric import DEGENERATE_BARYCENTRIC_CUTOFF

    b0, b1, b2 = bc.unbind(-1)
    return ~((ids == 0) & (b0 + b1 + b2 < DEGENERATE_BARYCENTRIC_CUTOFF))


def _blocks(per_pixel, fill, width=TILE, height=TILE):
    """[B, H, W] -> [B, blocks, width * height]: each width x height block's
    pixels in row-major order (blocks row-major over the image), the image
    padded with `fill`."""
    batch, rows, cols = per_pixel.shape
    padded = torch.nn.functional.pad(
        per_pixel, (0, -cols % width, 0, -rows % height), value=fill)
    nby, nbx = padded.shape[1] // height, padded.shape[2] // width
    return padded.view(batch, nby, height, nbx, width).permute(
        0, 1, 3, 2, 4).reshape(batch, nby * nbx, height * width)


def _heads(lanes):
    """[..., n] winners per lane (-1 inactive) -> bool, the first lane of
    each run of equal winners that holds an active pixel."""
    head = torch.ones_like(lanes, dtype=torch.bool)
    head[..., 1:] = lanes[..., 1:] != lanes[..., :-1]
    return head & (lanes >= 0)


def bwd_counts(ids, bc):
    """Where the backward's work falls on the forward's ids [B, H, W] and
    bc [B, H, W, 3]: {"per_image": [{...}, ...], "total": {...}} with, per
    image, `pixels`, `active_pixels`, `winners` (the distinct winners of
    its active pixels: the table rows the backward writes and whose
    packed rows it reads); in row-major warps of 32 pixels (the layout
    of a one-thread-per-pixel row kernel) `row_warps`, `row_warps_active`
    and `row_runs`, the runs of equal winner among active lanes (one
    global atomic per column each in such a kernel); in the warps of K2
    and K4, 8x4 pixel blocks, `warps_active` and `warp_winners`, the
    distinct (warp, winner) pairs (one global atomic per column each); and
    per
    16x16 tile `tiles`, `tiles_active`, `tile_winners`, the distinct
    (tile, winner) pairs, and `busiest_tile_winners`."""
    batch = ids.shape[0]
    winner = torch.where(active_pixels(ids, bc), ids.long(), -1)
    rows = winner.reshape(batch, -1)
    rows = torch.nn.functional.pad(rows, (0, -rows.shape[1] % WARP),
                                   value=-1).view(batch, -1, WARP)
    tiles = _blocks(winner, -1)
    warps = _blocks(winner, -1, *K2_WARP)
    tile_distinct = _heads(tiles.sort(-1).values).sum(-1)  # [B, tiles]
    per_image = {
        "pixels": torch.full((batch,), winner[0].numel()),
        "active_pixels": (winner >= 0).sum((1, 2)),
        "winners": _heads(winner.reshape(batch, -1).sort(-1).values).sum(
            -1),
        "row_warps": torch.full((batch,), rows.shape[1]),
        "row_warps_active": (rows >= 0).any(-1).sum(-1),
        "row_runs": _heads(rows).sum((1, 2)),
        "warps_active": (warps >= 0).any(-1).sum(-1),
        "warp_winners": _heads(warps.sort(-1).values).sum((1, 2)),
        "tiles": torch.full((batch,), tiles.shape[1]),
        "tiles_active": (tiles >= 0).any(-1).sum(-1),
        "tile_winners": tile_distinct.sum(-1),
        "busiest_tile_winners": tile_distinct.amax(-1)
        if tile_distinct.numel() else torch.zeros(batch, dtype=torch.long),
    }
    images = [{key: int(value[b]) for key, value in per_image.items()}
              for b in range(batch)]
    total = {key: (max if key.startswith("busiest") else sum)(
        image[key] for image in images) for key in per_image}
    return {"per_image": images, "total": total}


def warp_gradients_torch(ids, bc, df_dbc, df_dattr, table, inv_abs_det,
                         corner):
    """The plain model of the reduction of K2 (and, at A = 0, of K4): each
    active pixel's terms (`rasterize_cuda.pixel_gradient_terms`) summed
    per (warp, winner), a warp an 8x4 pixel block, then each sum added to
    its winner's row. Arguments and result as
    `rasterize_cuda.triangle_gradients_torch`."""
    from ..ops import rasterize_cuda as rc

    batch, n_tri = table.shape[:2]
    width = 9 + 3 * corner.shape[-1]
    dtab = torch.zeros(batch * n_tri, width, dtype=torch.float32,
                       device=table.device)
    if n_tri == 0:
        return dtab.view(batch, 0, width)
    rows, vals = rc.pixel_gradient_terms(ids, bc, df_dbc, df_dattr, table,
                                         inv_abs_det, corner)
    keep = _blocks(active_pixels(ids, bc), False, *K2_WARP).reshape(-1)
    warp_rows = _blocks(rows, 0, *K2_WARP)
    warp = torch.arange(batch * warp_rows.shape[1], device=rows.device)
    key = torch.stack([warp[:, None].expand(-1, WARP).reshape(-1),
                       warp_rows.reshape(-1)], -1)
    pairs, pair = torch.unique(key[keep], dim=0, return_inverse=True)
    terms = torch.stack([_blocks(vals[..., c], 0.0, *K2_WARP)
                         for c in range(width)], -1).reshape(-1, width)[keep]
    sums = torch.zeros(len(pairs), width, dtype=torch.float32,
                       device=table.device).index_add(0, pair, terms)
    return dtab.index_add(0, pairs[:, 1], sums).view(batch, n_tri, width)


def scene_tables(name, device):
    """(clip [B, V, 4], attributes [B, V, 9], triangles, size) of a scene
    of SCENES: bench.py's scene (utils/scenes.py) with the attributes that
    `render` interpolates (normals, positions, diffuse)."""
    from . import scenes

    batch, size, sphere = SCENES[name]
    scene = scenes.build_scene(batch, device, sphere_resolution=sphere)
    attrs = torch.cat([scene["normals"], scene["vertices"],
                       scene["diffuse"]], dim=2)
    return (scenes.clip_vertices(scene, size), attrs, scene["triangles"],
            size)


def off_screen(clip):
    """The clip vertices moved by x += 100 w: every triangle lies far
    right of the image, so (on the teapot, by `kept_counts`) every row
    fails the cull. At x += 10 w, 238 (block, row) pairs of the teapot
    still pass: edges that point at a block from afar."""
    return clip + torch.stack([100.0 * clip[..., 3]] + [
        torch.zeros_like(clip[..., 0])] * 3, -1)


def takes_split(launcher="launch_fused_fwd", module="rasterize_cuda"):
    """Whether this tree's launcher takes a split."""
    import importlib

    ops = importlib.import_module(f"..ops.{module}", __package__)
    return "split" in inspect.signature(getattr(ops, launcher)).parameters


def report_names(log, key):
    """The names by which soft_work.kernel_report finds kernel `key` (of
    KERNELS) in the build log `log`: one per instance of K3's template
    (its mangled names end in ILi<group>E), else KERNELS[key]."""
    if key not in KERNELS:
        return []
    instances = [f"{KERNELS[key]}ILi{g}E" for g in GROUPS]
    found = [name for name in instances if name in log]
    return found or [KERNELS[key]]


def time_launch(run, kernel, device, iters=20):
    """(launch ms by CUDA events, device ms by torch.profiler of the
    kernels whose name holds `kernel`) of `run`. Where the profiler
    records no kernel, the device ms are those of the whole launch by CUDA
    events (common.device_profile)."""
    from ..microbench import common

    launch_ms = common.wall_ms(run, device, iters)
    by_name, total, _ = common.device_profile(run, iters=10)
    device_ms = (total if common.EVENTS_ONLY in by_name else
                 sum(t for name, t in by_name.items() if kernel in name))
    return launch_ms, device_ms


def time_k1(table, corner, size, split=0, iters=20):
    """time_launch of K1 at size x size; split 0 is the kernel's own."""
    from ..ops import rasterize_cuda as rc

    extra = {"split": split} if split else {}
    return time_launch(lambda: rc.launch_fused_fwd(
        table, corner, size, size, 0, size, False, **extra), KERNEL,
        table.device, iters)


def k1_times(device):
    """[{scene, triangles, launch_and_device_ms}] of K1 on each scene of
    SCENES and on the teapot's off-screen floor table, at its compiled
    split and at each split tried (time_k1's pair per split)."""
    from ..ops import rasterize_cuda as rc

    splits = (0,) + (SPLITS if takes_split() else ())
    lines = []
    for name in SCENES:
        clip, attrs, tris, size = scene_tables(name, device)
        cases = [(name, clip)]
        if name == "teapot 256":
            cases.append((name + " floor (off screen)", off_screen(clip)))
        for label, c in cases:
            table = rc.pack_rows(c, tris, False)[0]
            corner = rc.pack_corner_attributes(attrs, tris)
            times = {f"split {s or 'compiled'}": time_k1(table, corner,
                                                         size, s)
                     for s in splits}
            lines.append({"kernel": "rasterize_fused_fwd", "scene": label,
                          "triangles": table.shape[1],
                          "launch_and_device_ms": times})
    return lines


def bwd_operands(name, device, batch=None, seed=5):
    """K2's operands on a scene of SCENES (its first `batch` images): the
    forward's ids and bc (K1 on a card, the plain forward on the CPU: the
    same bits), cotangents df/dbc and df/dattr (A = RENDER_ATTRS) drawn
    from a seeded generator, and the packed tables. Returns (ids, bc,
    df_dbc, df_dattr, table, inv_abs_det, corner) and the image side."""
    from ..ops import rasterize_cuda as rc

    clip, attrs, tris, size = scene_tables(name, device)
    clip, attrs = clip[:batch], attrs[:batch]
    table, inv_abs_det = rc.pack_rows(clip, tris, True)
    corner = rc.pack_corner_attributes(attrs, tris)
    if device.type == "cuda":
        ids, bc, _ = rc.launch_fused_fwd(table, corner, size, size, 0, size,
                                         False)
    else:
        ids, bc, _ = rc.forward_torch_packed(table, corner, size, size, 0,
                                             size, False)
    rng = torch.Generator(device=device).manual_seed(seed)
    f32 = dict(dtype=torch.float32, device=device, generator=rng)
    df_dbc = torch.randn(tuple(bc.shape), **f32)
    df_dattr = torch.randn(tuple(ids.shape) + (attrs.shape[-1],), **f32)
    return (ids, bc, df_dbc, df_dattr, table, inv_abs_det, corner), size


def k2_times(device):
    """[{scene, ...}] of K2 with A = RENDER_ATTRS on each scene of SCENES:
    time_launch's pair on the forward's ids and bc, and on its floor, the
    same operands with every pixel inactive (ids 0, bc 0: reading ids and
    bc alone)."""
    from ..ops import rasterize_cuda as rc

    lines = []
    for name in SCENES:
        ops, _ = bwd_operands(name, device)
        floor = (torch.zeros_like(ops[0]), torch.zeros_like(ops[1])) + ops[2:]
        times = {label: time_launch(lambda o=o: rc.launch_fused_bwd(*o),
                                    KERNELS["k2"], device)
                 for label, o in (("active", ops),
                                  ("floor (every pixel inactive)", floor))}
        lines.append({"kernel": "rasterize_fused_bwd", "scene": name,
                      "attributes": ops[6].shape[-1],
                      "launch_and_device_ms": times})
    return lines


def k34_times(device):
    """[{kernel, scene, images, launch_and_device_ms}] of K3 and K4 on each
    scene of SCENES for one image and for all its images: K3 at its
    launcher's rule and, where the launcher takes them, at each group of
    GROUPS and split of SPLITS; K4 on K3's ids and bc with df/dbc from a
    seeded generator, and on its floor (ids 0, bc 0: every pixel
    inactive)."""
    configs = [(0, 0)]
    if takes_split("launch_bary_fwd", "rasterize_barycentric_cuda"):
        configs += [(g, s) for g in GROUPS for s in SPLITS]
    lines = []
    for name in SCENES:
        clip, _, tris, size = scene_tables(name, device)
        for batch in sorted({1, clip.shape[0]}):
            lines += _k34_lines(name, clip[:batch], tris, size, configs)
    return lines


def _k34_lines(name, clip, tris, size, configs):
    """k34_times' two lines for one scene and batch."""
    from ..ops import rasterize_barycentric_cuda as rb
    from ..ops import rasterize_cuda as rc

    device = clip.device
    batch = clip.shape[0]
    table, inv_abs_det = rc.pack_rows(clip, tris, True)
    times = {}
    for group, split in configs:
        extra = {"group": group, "split": split} if split else {}
        label = (f"group {group} split {split}" if split
                 else "launcher's rule")
        times[label] = time_launch(lambda e=extra: rb.launch_bary_fwd(
            table, size, size, 0, size, **e), KERNELS["k3"], device)
    ids, bc, _ = rb.launch_bary_fwd(table, size, size, 0, size)
    rng = torch.Generator(device=device).manual_seed(5)
    df_dbc = torch.randn(tuple(bc.shape), dtype=torch.float32,
                         device=device, generator=rng)
    bwd_times = {label: time_launch(
        lambda i=i, b=b: rb.launch_bary_bwd(i, b, df_dbc, table,
                                            inv_abs_det),
        KERNELS["k4"], device) for label, i, b in (
            ("active", ids, bc),
            ("floor (every pixel inactive)", torch.zeros_like(ids),
             torch.zeros_like(bc)))}
    return [{"kernel": "rasterize_bary_fwd", "scene": name, "images": batch,
             "launch_and_device_ms": times},
            {"kernel": "rasterize_bary_bwd", "scene": name, "images": batch,
             "launch_and_device_ms": bwd_times}]


def step_profiles(device, name="teapot 256"):
    """{step: (device ms per call, kernels per call, {kernel: ms})} by
    torch.profiler over 10 calls of the hard training step (render, loss
    mean(rgb^2), backward to the vertices: K1 and K2) and of the 4-image
    `rasterize_barycentric` step (one image a call, a seeded bc cotangent,
    backward: K3 and K4) on `name`."""
    from ..microbench import common
    from ..models import mesh_renderer
    from ..ops import rasterize as rasterize_ops
    from . import scenes

    batch, size, sphere = SCENES[name]
    scene = scenes.build_scene(batch, device, sphere_resolution=sphere)
    args = [scene[k] for k in ("triangles", "normals", "diffuse", "eye",
                               "center", "up", "lights", "intensities")]
    clip = scenes.clip_vertices(scene, size)
    rng = torch.Generator(device=device).manual_seed(5)
    weights = torch.randn((size, size, 3), dtype=torch.float32,
                          device=device, generator=rng)

    def train_step():
        vertices = scene["vertices"].detach().requires_grad_(True)
        images = mesh_renderer.render(vertices, *args, size, size)
        torch.mean(images[..., :3] ** 2).backward()

    def bary_step():
        c = clip.detach().clone().requires_grad_(True)
        out = [rasterize_ops.rasterize_barycentric(
            c[b], scene["triangles"], size, size) for b in range(batch)]
        sum((bc * weights).sum() for _, bc, _ in out).backward()

    profiles = {}
    for label, fn in ((TRAIN_STEP, train_step),
                      (f"rasterize_barycentric x {batch} images + backward",
                       bary_step)):
        by_name, total, count = common.device_profile(fn, iters=10)
        ours = {kernel: sum(t for n, t in by_name.items() if kernel in n)
                for kernel in KERNELS.values()}
        profiles[label] = (total, count, {k: t for k, t in ours.items()
                                          if t > 0.0})
    return profiles


def counts(device):
    """{scene: count_summary} for each scene of SCENES and the floor."""
    from ..ops import rasterize_cuda as rc

    out = {}
    for name in SCENES:
        clip, _, tris, size = scene_tables(name, device)
        out[name] = count_summary(rc.pack_rows(clip, tris, False)[0], size,
                                  size)
        if name == "teapot 256":
            out[name + " floor (off screen)"] = count_summary(
                rc.pack_rows(off_screen(clip), tris, False)[0], size, size)
    return out


def bwd_scene_counts(device):
    """{scene: bwd_counts} on the forward's ids and bc: the teapot 256x256
    batch 4, and on a card sphere72 512x512 batch 4 too (the plain forward
    takes minutes there on the CPU)."""
    names = SCENES if device.type == "cuda" else ["teapot 256"]
    return {name: bwd_counts(*bwd_operands(name, device)[0][:2])
            for name in names}


def main(argv=None):
    import argparse
    import subprocess

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="cuda: build, report and time the kernels, "
                        "then count; cpu: count only")
    parser.add_argument("--kernels", nargs="+", default=list(KERNELS) + [
        "steps"], choices=list(KERNELS) + ["steps"],
                        help="what to time on the card (k3 and k4 go "
                        "together)")
    args = parser.parse_args(argv)
    if args.device == "cpu":
        cpu = torch.device("cpu")
        for name, summary in counts(cpu).items():
            print(json.dumps({name: summary}), flush=True)
        for name, summary in bwd_scene_counts(cpu).items():
            print(json.dumps({name + " backward": summary}), flush=True)
        return
    if not torch.cuda.is_available():
        raise SystemExit("hard_work: needs a CUDA device (or --device cpu)")
    from . import kernels, soft_work

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    log = kernels.build().log
    for key in args.kernels:
        for name in report_names(log, key):
            print(json.dumps({name: soft_work.kernel_report(log, name)}),
                  flush=True)
    lines = []
    if "k1" in args.kernels:
        lines += k1_times(dev)
    if "k2" in args.kernels:
        lines += k2_times(dev)
    if "k3" in args.kernels or "k4" in args.kernels:
        lines += k34_times(dev)
    for line in lines:
        print(json.dumps(line), flush=True)
    if "steps" in args.kernels:
        for label, profile in step_profiles(dev).items():
            print(json.dumps({"step": label, "device_ms_kernels_and_ours":
                              profile}), flush=True)
    for name, summary in counts(dev).items():
        print(json.dumps({name: summary}), flush=True)
    for name, summary in bwd_scene_counts(dev).items():
        print(json.dumps({name + " backward": summary}), flush=True)
    print(card, flush=True)


if __name__ == "__main__":
    main()
