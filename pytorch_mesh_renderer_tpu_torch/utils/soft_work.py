"""Where the split soft kernels' work falls, and what it costs: K6
(csrc/soft_sil_bwd.cu), K7 (csrc/soft_fwd.cu) and K8 (csrc/soft_bwd.cu).

    python -m pytorch_mesh_renderer_tpu_torch.utils.soft_work   # CUDA host

`pair_counts` counts, on any device, how a packed table's (pixel,
triangle) pairs fall on the kernels' 16x16 pixel blocks and their
16x2-pixel warps: which blocks hold a valid pair, how many (warp,
triangle) and (block, triangle) items there are, how many rows each block
stages, and the longest sequence one warp runs, before and after the
triangles of a block are split over CTAs by row id mod `split`
(csrc/soft_split.cuh). A pair is valid as in the kernels' geometry phase
without the depth test: the triangle is kept, the pixel centre lies in its
blur-inflated bbox, and inside the triangle or within the blur of its
nearest edge.

`teapot_table` packs the soft teapot of chip_smoke.py (bench.py's scene,
CCW, sigma 1e-5, gamma 1e-4, blur 0.01) at a square size, `fit_table` the
cow fit's first silhouette step (128x128, 4 views); `kernel_report` reads
a kernel's registers, spills and shared memory from the build log and its
resident CTAs per SM; `time_kernel` times one kernel (K6, K7 or K8) by
CUDA events and torch.profiler at a split. `main` prints, per kernel, its
report and its times at its compiled split and at each split tried (K6 at
the teapot 256x256 batch 4 and the fit's shape, K7 and K8 at the teapot
256x256 and 128x128 batch 4), then the counts; `--save-k7` and
`--check-k7` hold two builds of K7 to the same outputs bit for bit.
chip_smoke.py calls the same functions. To compare with an older commit,
unpack it into `.chipcheck/` (git-ignored), copy this file into it and run
both in one call: a launcher without a split is timed at its own.
"""

from __future__ import annotations

import inspect
import json
import re

import numpy as np
import torch

BLOCK = 16  # pixel block side (csrc/soft_common.cuh)
WARP_ROWS = 2  # a warp covers 16x2 pixels
WARPS = BLOCK // WARP_ROWS
BLUR = 0.01  # the soft renderer's default blur radius
SIGMA, GAMMA = 1e-5, 1e-4
FIT_SIGMA = 3e-5  # the cow fit's
# The splits of a pixel block's triangles tried per kernel (CTAs per
# block), each kernel's launcher, and the scenes it is timed on.
SPLITS = {"soft_sil_fwd": (4, 8), "soft_sil_bwd": (4, 8, 16),
          "soft_fwd": (4, 8), "soft_bwd": (4, 8, 16)}
LAUNCHERS = {"soft_sil_fwd": "launch_sil_fwd",
             "soft_sil_bwd": "launch_sil_bwd", "soft_fwd": "launch_soft_fwd",
             "soft_bwd": "launch_soft_bwd"}
SCENES = {"soft_sil_fwd": ("teapot 256", "teapot 256 floor", "fit 128"),
          "soft_sil_bwd": ("teapot 256", "fit 128"),
          "soft_fwd": ("teapot 256", "teapot 128"),
          "soft_bwd": ("teapot 256", "teapot 128")}


def pair_counts(table, width, height, sq_blur, split=8, row_offset=0,
                full_height=None, chunk=2048):
    """Work counts of K8 on `table` [B, T, 59] at width x height.

    Returns a dict of ints: `blocks` (B x pixel blocks), `busy_blocks`
    (with a valid pair), `staged` (block, triangle) pairs kept by the
    block cull, `block_items` and `warp_items` ((block, triangle) and
    (warp, triangle) pairs with a valid pair), `busiest_block` (most rows
    one block stages), `staging_ctas` (of B x blocks x `split` CTAs, those
    that stage a row), `busy_warps` (warps with a valid pair),
    `busiest_warp` (most valid triangles in one warp:
    its sequence when one CTA serves a block) and `busiest_split_warp`
    (most staged triangles of one warp when `split` CTAs serve a block,
    each taking the rows of one residue mod `split`, its 8 warps the
    staged rows in turn).
    """
    from ..ops.soft_rasterize_cuda import pixel_centers

    full_height = full_height or height
    device = table.device
    batch, n_tri = table.shape[:2]
    px, py = pixel_centers(width, height, row_offset, full_height, device)
    nbx, nby = -(-width // BLOCK), -(-height // BLOCK)
    staged = staged_rows(table, width, height, row_offset, full_height)
    parts = torch.stack([staged[..., s::split].sum(-1)
                         for s in range(split)], -1)
    warp_counts = torch.zeros(batch, nby, nbx, WARPS, dtype=torch.int64,
                              device=device)
    block_valid = torch.zeros(batch, nby, nbx, dtype=torch.bool,
                              device=device)
    block_items = 0
    offsets = torch.arange(BLOCK, device=device)
    candidates = staged.nonzero()
    for start in range(0, candidates.shape[0], chunk):
        b, by, bx, t = candidates[start:start + chunk].unbind(-1)
        xs = bx[:, None] * BLOCK + offsets  # [N, 16]
        ys = by[:, None] * BLOCK + offsets
        in_image = ((xs < width)[:, None, :] & (ys < height)[:, :, None])
        x = px[xs.clamp(max=width - 1)][:, None, :]  # [N, 1, 16]
        y = py[ys.clamp(max=height - 1)][:, :, None]  # [N, 16, 1]
        valid = in_image & _valid(table[b, t][:, None, None, :], x, y,
                                  sq_blur)  # [N, 16, 16]
        in_warp = valid.view(-1, WARPS, WARP_ROWS * BLOCK).any(-1)
        warp_counts.index_put_((b, by, bx), in_warp.long(), accumulate=True)
        has_pair = valid.flatten(1).any(-1)
        block_valid[b[has_pair], by[has_pair], bx[has_pair]] = True
        block_items += int(has_pair.sum())
    return {
        "blocks": batch * nby * nbx,
        "busy_blocks": int(block_valid.sum()),
        "staged": int(staged.sum()),
        "block_items": block_items,
        "busy_warps": int((warp_counts > 0).sum()),
        "warp_items": int(warp_counts.sum()),
        "staging_ctas": int((parts > 0).sum()),
        "busiest_block": int(staged.sum(-1).max()) if n_tri else 0,
        "busiest_warp": int(warp_counts.max()),
        "busiest_split_warp": int((-(-parts // WARPS)).max()) if n_tri else 0,
    }


def staged_rows(table, width, height, row_offset=0, full_height=None):
    """[B, ceil(H/16), ceil(W/16), T] bool: the rows of `table` [B, T, 59]
    that the soft kernels' block cull stages for each image and 16x16
    pixel block: kept, with the block's pixel-centre extent inside the
    row's blur-inflated bbox."""
    from ..ops.soft_rasterize_cuda import pixel_centers

    device = table.device
    px, py = pixel_centers(width, height, row_offset,
                           full_height or height, device)
    x0 = torch.arange(-(-width // BLOCK), device=device) * BLOCK
    y0 = torch.arange(-(-height // BLOCK), device=device) * BLOCK
    # The blocks' pixel-centre extents (py falls as the row grows).
    px_lo, px_hi = px[x0], px[(x0 + BLOCK).clamp(max=width) - 1]
    py_hi, py_lo = py[y0], py[(y0 + BLOCK).clamp(max=height) - 1]

    def col(k):
        return table[..., k][:, None, None, :]  # [B, 1, 1, T]

    return ((col(21) > 0.0) & (col(23) >= px_lo[None, None, :, None])
            & (col(22) <= px_hi[None, None, :, None])
            & (col(25) >= py_lo[None, :, None, None])
            & (col(24) <= py_hi[None, :, None, None]))


def _valid(r, px, py, sq_blur):
    """The geometry phase's validity without the depth test, for rows r
    [..., 59] against pixel centres px, py (broadcast)."""
    def c(k):
        return r[..., k]

    bc = [c(3 * i) * px + c(3 * i + 1) * py + c(3 * i + 2) for i in range(3)]
    inside = (bc[0] >= 0.0) & (bc[1] >= 0.0) & (bc[2] >= 0.0)

    def seg(a, b, inv_len2):
        ax, ay, bx, by = c(a), c(a + 1), c(b), c(b + 1)
        abx, aby = bx - ax, by - ay
        t = (((px - ax) * abx + (py - ay) * aby) * inv_len2).clamp(0.0, 1.0)
        nx, ny = ax + t * abx - px, ay + t * aby - py
        return nx * nx + ny * ny

    sq_dist = torch.minimum(torch.minimum(seg(9, 11, c(56)),
                                          seg(11, 13, c(57))),
                            seg(13, 9, c(58)))
    in_bbox = ((px >= c(22)) & (px <= c(23)) & (py >= c(24))
               & (py <= c(25)))
    return (c(21) > 0.0) & in_bbox & (inside | (sq_dist <= sq_blur))


def teapot_table(size, device, batch=4):
    """(table [B, T, 59], lights [B, 2, 4], params [4]) of chip_smoke.py's
    soft teapot at size x size."""
    from ..ops import mesh
    from ..ops import soft_rasterize_cuda as sc
    from . import scenes, test_utils

    scene = scenes.build_scene(batch, device)
    tris = scene["triangles"].flip(1).contiguous()  # CCW
    lights = torch.cat([scene["lights"], scene["intensities"][..., :1]],
                       -1).contiguous()
    normals = mesh.compute_vertex_normals(scene["vertices"], tris)
    table = sc.pack_triangle_data(
        test_utils.clip_from_eye(scene["vertices"], scene["eye"], size,
                                 size),
        tris, scene["vertices"], normals, scene["diffuse"], BLUR)
    return table, lights, sc.make_params(SIGMA, GAMMA, BLUR, 0, device)


def fit_table(device, size=128, views=4):
    """(table [views, 1152, 59], lights [views, 0, 4], params [4]) of the
    flagship cow fit's first step (chip_smoke.py's fit phase: a sphere of
    radius 0.5 at resolution 24 seen from `views` eyes around it at size x
    size, sigma 3e-5), the silhouette kernels' shape."""
    from ..models import shapes
    from ..ops import soft_rasterize_cuda as sc
    from . import test_utils

    vertices, tris, _ = shapes.sphere(0.5, resolution=24)
    phis = np.linspace(0.0, 2 * np.pi, views, endpoint=False)
    eyes = torch.tensor(np.stack([2.0 * np.sin(phis), 0.3 * np.ones(views),
                                  2.0 * np.cos(phis)], -1),
                        dtype=torch.float32, device=device)
    world = vertices.to(device)[None].expand(views, -1, -1)
    zeros = torch.zeros_like(world)
    table = sc.pack_triangle_data(
        test_utils.clip_from_eye(world, eyes, size, size), tris.to(device),
        zeros, zeros, zeros, BLUR)
    return (table, torch.zeros(views, 0, 4, device=device),
            sc.make_params(FIT_SIGMA, 1.0, BLUR, 0, device))


def ptxas_report(log, name):
    """{registers, stack, spill_stores, spill_loads, smem} of the kernel
    whose mangled name holds `name`, from an `nvcc -Xptxas -v` log; smem
    is 0 where ptxas reports none (a kernel without shared memory)."""
    report = {}
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and name in line:
            for follow in lines[i + 1:i + 6]:
                frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes "
                                  r"spill stores, (\d+) bytes spill loads",
                                  follow)
                used = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes "
                                 r"smem)?", follow)
                if frame:
                    report.update(stack=int(frame[1]),
                                  spill_stores=int(frame[2]),
                                  spill_loads=int(frame[3]))
                if used:
                    report.update(registers=int(used[1]),
                                  smem=int(used[2] or 0))
            break
    if "registers" not in report:
        raise RuntimeError(f"no ptxas report for {name} in the build log")
    return report


def kernel_report(log, name="soft_bwd_kernel"):
    """ptxas_report of the kernel whose mangled name holds `name`, and
    `blocks_per_sm`: cudaOccupancyMaxActiveBlocksPerMultiprocessor where
    the library exports `<kernel>_blocks_per_sm` (the name without
    `_kernel`), else Hopper's occupancy rule on the registers and shared
    memory (`occupancy_source` says which)."""
    from . import kernels

    report = ptxas_report(log, name)
    lib = kernels.load_library()
    entry = name.removesuffix("_kernel") + "_blocks_per_sm"
    if hasattr(lib, entry):
        report["blocks_per_sm"] = getattr(lib, entry)()
        report["occupancy_source"] = "cudaOccupancy"
    else:
        report["blocks_per_sm"] = occupancy_rule(report["registers"],
                                                 report["smem"])
        report["occupancy_source"] = "rule"
    return report


def occupancy_rule(registers, smem, threads=BLOCK * BLOCK):
    """Resident CTAs per Hopper SM: 65,536 registers allocated per warp in
    units of 256, 233,472 bytes of shared memory with 1 KB reserved per
    CTA, 64 warps and 32 CTAs."""
    warps = -(-threads // 32)
    per_warp = -(-registers * 32 // 256) * 256
    by_regs = (65536 // per_warp) // warps
    by_smem = 233472 // (smem + 1024)
    return min(by_regs, by_smem, 64 // warps, 32)


def forward_residuals(table, lights, params, size):
    """K7's (rgba, m, sum_w) and a seeded cotangent [B, H, W, 4]."""
    from ..ops import soft_rasterize_cuda as sc
    from . import test_utils

    k7 = sc.launch_soft_fwd(table, lights, params, size, size, size)
    d_rgba = test_utils.soft_cotangents(table.shape[0], size, size,
                                        table.device, seed=8)
    return k7, d_rgba


def kernel_launch(kernel, table, lights, params, size):
    """A function launch(**split) that launches `kernel` (a key of SPLITS)
    once on the scene at size x size; the residuals a backward kernel reads
    are made first (K7's for K8, K5's alpha for K6, seeded cotangents)."""
    from ..ops import soft_rasterize_cuda as sc

    if kernel == "soft_fwd":
        return lambda **split: sc.launch_soft_fwd(table, lights, params,
                                                  size, size, size, **split)
    if kernel == "soft_sil_fwd":
        return lambda **split: sc.launch_sil_fwd(table, params, size, size,
                                                 size, **split)
    (rgba, run_max, sum_w), d_rgba = forward_residuals(table, lights, params,
                                                       size)
    if kernel == "soft_bwd":
        return lambda **split: sc.launch_soft_bwd(
            table, lights, params, rgba, run_max, sum_w, d_rgba, size,
            **split)
    if kernel == "soft_sil_bwd":
        alpha = sc.launch_sil_fwd(table, params, size, size, size)
        d_alpha = d_rgba[..., 3].contiguous()
        return lambda **split: sc.launch_sil_bwd(table, params, alpha,
                                                 d_alpha, size, **split)
    raise ValueError(f"unknown kernel {kernel!r}")


def takes_split(kernel):
    """Whether this tree's launcher of `kernel` takes a split."""
    from ..ops import soft_rasterize_cuda as sc

    launcher = getattr(sc, LAUNCHERS[kernel])
    return "split" in inspect.signature(launcher).parameters


def time_kernel(kernel, table, lights, params, size, split=0, iters=20):
    """(launch ms by CUDA events, `<kernel>_kernel` device ms by
    torch.profiler) of `kernel` (a key of SPLITS) at size x size; split 0
    is the kernel's own. Where the profiler records no kernel, the device
    ms are those of the whole launch by CUDA events
    (common.device_profile)."""
    from ..microbench import common

    launch = kernel_launch(kernel, table, lights, params, size)
    extra = {"split": split} if split else {}

    def run():
        return launch(**extra)

    launch_ms = common.wall_ms(run, table.device, iters)
    by_name, total, _ = common.device_profile(run, iters=10)
    device = (total if common.EVENTS_ONLY in by_name else
              sum(t for name, t in by_name.items()
                  if f"{kernel}_kernel" in name))
    return launch_ms, device


def scene_table(scene, device):
    """(table, lights, params) of a scene of SCENES: "teapot <size>" (batch
    4), "fit 128", or "teapot 256 floor", the teapot's table with no row
    kept (the stream and the cull alone)."""
    if scene == "fit 128":
        return fit_table(device)
    if scene == "teapot 256 floor":
        table, lights, params = teapot_table(256, device)
        table = table.clone()
        table[..., 21] = 0.0  # no row is kept: the stream and cull alone
        return table, lights, params
    return teapot_table(int(scene.split()[-1]), device)


def kernel_times(kernel, device):
    """[{scene, batch, triangles, launch_and_device_ms}] of `kernel` on each
    of its SCENES, at its compiled split and at each split tried
    (time_kernel's pair per split)."""
    splits = (0,) + (SPLITS[kernel] if takes_split(kernel) else ())
    lines = []
    for scene in SCENES[kernel]:
        table, lights, params = scene_table(scene, device)
        size = int(re.search(r"\d+", scene)[0])
        times = {f"split {s or 'compiled'}": time_kernel(
            kernel, table, lights, params, size, s) for s in splits}
        lines.append({"kernel": kernel, "scene": scene,
                      "batch": table.shape[0], "triangles": table.shape[1],
                      "launch_and_device_ms": times})
    return lines


def k7_outputs(device):
    """K7's (rgba, m, sum_w) on the CPU for chip_smoke.py's phase 8 scenes
    (test_utils.SOFT_SCENES and SOFT_EDGE_SCENES) and the teapot at 256x256
    batch 4, the teapot packed on the CPU (on the card its vertex normals
    sum by atomics), keyed by scene name: what two builds of K7 must give
    bit for bit."""
    from ..ops import soft_rasterize_cuda as sc
    from . import test_utils

    scenes = {name: test_utils.soft_scene(name, device)[:5]
              for name in test_utils.SOFT_SCENES + test_utils.SOFT_EDGE_SCENES}
    scenes["teapot"] = tuple(x.to(device) for x in teapot_table(
        256, torch.device("cpu"))) + (256, 256)
    outputs = {}
    for name, (table, lights, params, width, height) in scenes.items():
        outputs[name] = [t.cpu() for t in sc.launch_soft_fwd(
            table, lights, params, width, height, height)]
    return outputs


def main(argv=None):
    import argparse
    import subprocess

    from . import kernels

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--kernels", nargs="+", default=list(SPLITS),
                        choices=list(SPLITS), help="kernels to time")
    parser.add_argument("--save-k7", metavar="FILE",
                        help="save K7's outputs (k7_outputs) to FILE")
    parser.add_argument("--check-k7", metavar="FILE",
                        help="fail unless K7's outputs equal FILE's bit "
                        "for bit")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("soft_work: needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    log = kernels.build().log
    if args.save_k7 or args.check_k7:
        outputs = k7_outputs(dev)
        if args.save_k7:
            torch.save(outputs, args.save_k7)
        if args.check_k7:
            want = torch.load(args.check_k7)
            equal = {name: all(torch.equal(a, b) for a, b in
                               zip(outputs[name], want[name]))
                     for name in want}
            print(json.dumps({"k7 outputs equal bit for bit": equal}),
                  flush=True)
            if not all(equal.values()):
                raise SystemExit("soft_work: K7's outputs differ")
    for kernel in args.kernels:
        print(json.dumps({f"{kernel}_kernel": kernel_report(
            log, f"{kernel}_kernel")}), flush=True)
        for line in kernel_times(kernel, dev):
            print(json.dumps(line), flush=True)
    for scene in ("teapot 256", "teapot 128", "fit 128"):
        table = scene_table(scene, dev)[0]
        size = int(scene.split()[-1])
        print(json.dumps({scene: pair_counts(
            table, size, size, float(np.float32(BLUR) ** 2))}), flush=True)
    print(card, flush=True)


if __name__ == "__main__":
    main()
