"""Where the hard forward kernel K1's work falls, and what it costs
(csrc/rasterize_fused_fwd.cu; the cull in csrc/rasterize_common.cuh).

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

On the card, `main` prints K1's registers, spills and CTAs per SM
(`soft_work.kernel_report`), its launch and device times at its compiled
split and at each split tried on the teapot at 256x256 batch 4 (the
render and training step's shape) and the sphere72 stress mesh at 512x512
batch 4, its floor (the teapot's table moved off screen, x += 100 w, so
that every row fails the cull: the stream and the cull alone), then the
counts. On the CPU it prints the counts only. To compare with an older
commit, unpack it into `.chipcheck/` (git-ignored), copy this file into it
and run both in one call: a launcher without a split is timed at its own.
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
KERNEL = "rasterize_fused_fwd_kernel"


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


def takes_split():
    """Whether this tree's `launch_fused_fwd` takes a split."""
    from ..ops import rasterize_cuda as rc

    return "split" in inspect.signature(rc.launch_fused_fwd).parameters


def time_k1(table, corner, size, split=0, iters=20):
    """(launch ms by CUDA events, K1's device ms by torch.profiler) at
    size x size; split 0 is the kernel's own. Where the profiler records
    no kernel, the device ms are those of the whole launch by CUDA events
    (common.device_profile)."""
    from ..microbench import common
    from ..ops import rasterize_cuda as rc

    extra = {"split": split} if split else {}

    def run():
        return rc.launch_fused_fwd(table, corner, size, size, 0, size, False,
                                   **extra)

    launch_ms = common.wall_ms(run, table.device, iters)
    by_name, total, _ = common.device_profile(run, iters=10)
    device = (total if common.EVENTS_ONLY in by_name else
              sum(t for name, t in by_name.items() if KERNEL in name))
    return launch_ms, device


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


def main(argv=None):
    import argparse
    import subprocess

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="cuda: build, report and time K1, then count; "
                        "cpu: count only")
    args = parser.parse_args(argv)
    if args.device == "cpu":
        for name, summary in counts(torch.device("cpu")).items():
            print(json.dumps({name: summary}), flush=True)
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
    print(json.dumps({KERNEL: soft_work.kernel_report(
        kernels.build().log, KERNEL)}), flush=True)
    for line in k1_times(dev):
        print(json.dumps(line), flush=True)
    for name, summary in counts(dev).items():
        print(json.dumps({name: summary}), flush=True)
    print(card, flush=True)


if __name__ == "__main__":
    main()
