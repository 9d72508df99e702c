"""The port's benchmark: one JSON line per run, or per sweep point.

    python -m pytorch_mesh_renderer_tpu_torch.bench [--size N] [--batch N]
        [--iters N] [--soft [--silhouette]] [--pose [--steps N]] [--stress]
        [--sphere-resolution N] [--soft-sweep] [--profile DIR]
        [--device cuda|cpu]

The counterpart of the repository's `bench.py`, with its modes and
defaults, on one card (`--device cpu` runs the plain versions on the CPU;
without a card and without it the bench raises):

  * default: the hard training step on bench.py's teapot scene
    (`utils/scenes.py`), 256^2, batch 4: render, loss mean(rgb^2),
    backward to the vertices (bench.py:bench_hard, :257);
  * `--soft [--silhouette]`: the soft step, loss mean(alpha^2) of the
    render's alpha or of `render_silhouette` (bench_soft, :290);
  * `--pose --steps 500`: a cube's rotation recovered from its silhouette
    by soft IoU and Adam 5e-2 at 128^2, the steps in one call of
    `parallel.make_train_loop` (bench_pose, :524);
  * `--stress`: the hard step on sphere72 at 512^2, batch 64, at most 5
    iterations (:724-726);
  * `--soft-sweep`: the soft step on the cube at 128^2 over the 3x3
    sigma / gamma grid, each point's iterations in one call of a
    captured loop (bench_soft_sweep, :458);
  * `--profile DIR`: a torch.profiler trace of the timed steps
    (`utils/profiling.trace`).

Each step is `parallel.make_train_step` (on the card: captured into a
CUDA graph and replayed). The JAX bench times `value_and_grad`, whose
vertices stay fixed: here an SGD update at learning rate 0 stands in for
no update (the sweep's 1e-30, as bench.py's `vv + 1e-30 g`). Each line
holds bench.py's keys where they mean the same thing (`metric`, `value`,
`unit`, `ms_per_step`, `vs_baseline` against the CPU anchors of
bench.py:36-45, `model_flops_per_step` and `model_hbm_bytes_per_step`
from `utils/cost.py`, `achieved_tflops`, `achieved_hbm_gbps`), and:
`pct_h100_fp32_peak` and `pct_h100_hbm_bw` (the card's peaks, cost.py;
null off the card); `device` (nvidia-smi's name and power limit, or
`cpu`); `eager_ms_per_step` (the same step without capture); and
`device_ms_per_step` and `kernels_per_step` (torch.profiler,
`microbench/common.device_profile`; null off the card). Times are CUDA
events on the card (`common.wall_ms`), the host clock on the CPU. The
bench writes no file, except the trace that `--profile` asks for.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math

import numpy as np
import torch

from . import parallel
from .config import HARD_CONFIG
from .microbench import common
from .models import mesh_renderer, shapes, soft_mesh_renderer
from .ops import camera, losses, mesh
from .ops import rasterize_cuda as rc
from .ops import soft_rasterize_cuda as sc
from .ops.rasterize import select_backend
from .utils import cost, profiling, scenes
from .utils.soft_work import BLUR

# bench.py:36-45: the reference implementation's throughput on a CPU
# (renders/s), the anchors of `vs_baseline`. CPU numbers, not targets.
BASELINE_MEASURED = {
    "hard_teapot_256_fwdbwd_renders_per_sec": 0.1198,
    "soft_cube_128_fwdbwd_renders_per_sec": 0.0318,
}
PROFILE_ITERS = 10  # steps per device profile


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m pytorch_mesh_renderer_tpu_torch.bench",
        description=__doc__.split("\n\n")[0])
    parser.add_argument("--size", type=int, default=None,
                        help="image side (default 256; 128 for --pose and "
                             "--soft-sweep, which bench.py fixes at 128)")
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--iters", type=int, default=50)
    parser.add_argument("--soft", action="store_true")
    parser.add_argument("--silhouette", action="store_true",
                        help="with --soft: render_silhouette's step")
    parser.add_argument("--pose", action="store_true",
                        help="the Adam pose recovery, in one captured loop")
    parser.add_argument("--steps", type=int, default=500)
    parser.add_argument("--sphere-resolution", type=int, default=None,
                        help="a UV sphere in place of the teapot (72 gives "
                             "10,368 triangles)")
    parser.add_argument("--stress", action="store_true",
                        help="sphere72, 512^2, batch 64, at most 5 iters")
    parser.add_argument("--soft-sweep", action="store_true",
                        help="the sigma / gamma grid at 128^2, a line per "
                             "point")
    parser.add_argument("--profile", default=None, metavar="DIR",
                        help="write a torch.profiler trace of the timed "
                             "steps into DIR")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return parser.parse_args(argv)


def _record(metric, value, unit, ms, eager_ms, flops, hbm_bytes, device,
            card, profile=None, vs_baseline=None, **extra):
    """One JSON line's dict. `ms` and `eager_ms` are per step; `profile`
    is device_profile's (device ms, kernels) per step, on the card."""
    seconds = ms / 1e3
    on_card = device.type == "cuda"
    device_ms, kernels = profile if profile else (None, None)
    if kernels is not None and math.isnan(kernels):
        kernels = None  # the profiler recorded no kernel (CUDA events)
    return {
        "metric": metric, "value": value, "unit": unit, "ms_per_step": ms,
        "vs_baseline": vs_baseline, "model_flops_per_step": flops,
        "model_hbm_bytes_per_step": hbm_bytes,
        "achieved_tflops": flops / seconds / 1e12,
        "achieved_hbm_gbps": hbm_bytes / seconds / 1e9,
        "pct_h100_fp32_peak": (100.0 * flops / seconds
                               / cost.PEAK_FP32_PER_S if on_card else None),
        "pct_h100_hbm_bw": (100.0 * hbm_bytes / seconds
                            / cost.PEAK_BYTES_PER_S if on_card else None),
        "device": card, "eager_ms_per_step": eager_ms,
        "device_ms_per_step": device_ms, "kernels_per_step": kernels,
        **extra}


def _profile(fn, device):
    """(device ms, kernels) per call of `fn` (one step) on the card; None
    on the CPU."""
    if device.type != "cuda":
        return None
    return common.device_profile(fn, PROFILE_ITERS)[1:]


def _time_step(step, batch, device, iters, profile_dir=None):
    """(ms per step captured, ms per step eager, device profile) of a
    make_train_step step on `batch`: three windows of `iters` steps after
    two (the first captures the step)."""
    trace = (profiling.trace(profile_dir) if profile_dir
             else contextlib.nullcontext())
    with trace:
        ms = common.wall_ms(lambda: step(batch), device, iters, windows=3,
                            warmup=2)
    eager_ms = common.wall_ms(lambda: step.run_eager(batch), device, iters,
                              windows=3, warmup=1)
    return ms, eager_ms, _profile(lambda: step(batch), device)


def _hard_cost(scene, size):
    clip = scenes.clip_vertices(scene, size)
    attrs = torch.cat([scene["normals"], scene["vertices"],
                       scene["diffuse"]], dim=2)
    forward = (rc.rasterize_interpolate_cuda
               if select_backend(HARD_CONFIG, clip.device) == "cuda"
               else rc.rasterize_interpolate_torch)
    with torch.no_grad():
        ids, bc, _ = forward(clip, attrs, scene["triangles"], size, size)
        table = rc.pack_rows(clip, scene["triangles"], False)[0]
    return cost.hard_step_cost(table, ids, bc, attrs.shape[-1])[:2]


def _soft_table(vertices, triangles, diffuse, eye, size):
    """The soft step's packed table at its first step: bench.py's camera
    toward the origin, y up."""
    clip = scenes.clip_vertices(dict(
        vertices=vertices, eye=eye, center=torch.zeros_like(eye),
        up=torch.tensor([0.0, 1.0, 0.0], device=eye.device).expand_as(eye)),
        size)
    normals = mesh.compute_vertex_normals(vertices, triangles)
    return sc.pack_triangle_data(clip, triangles, vertices, normals, diffuse,
                                 BLUR)


def render_step_loss(scene, size, soft=False, silhouette=False):
    """loss_fn(params, batch) of the bench's hard or soft step on `scene`
    (`scenes.build_scene`'s), at a square `size` image, params[0] the
    vertices: mean(rgb^2) of the hard render, or mean(alpha^2) of the soft
    render or, with `silhouette`, of `render_silhouette`."""
    if not soft:
        rest = [scene[k] for k in ("triangles", "normals", "diffuse", "eye",
                                   "center", "up", "lights", "intensities")]

        def loss_fn(params, batch):
            images = mesh_renderer.render(params[0], *rest, size, size)
            return torch.mean(images[..., :3] ** 2)
        return loss_fn
    tris = scene["triangles"].flip(1).contiguous()  # soft wants CCW
    camera_args = [scene[k] for k in ("eye", "center", "up")]
    if silhouette:
        def loss_fn(params, batch):
            alpha = soft_mesh_renderer.render_silhouette(
                params[0], tris, *camera_args, size, size)
            return torch.mean(alpha ** 2)
        return loss_fn
    intensities = scene["intensities"][..., 0].contiguous()

    def loss_fn(params, batch):
        images = soft_mesh_renderer.render(
            params[0], tris, scene["diffuse"], *camera_args, scene["lights"],
            intensities, size, size)
        return torch.mean(images[..., 3] ** 2)
    return loss_fn


def bench_render_step(args, device, card):
    """The hard or soft training step (bench_hard, bench_soft)."""
    scene = scenes.build_scene(args.batch, device, args.sphere_resolution)
    size = args.size
    vertices = scene["vertices"].clone().requires_grad_(True)
    loss_fn = render_step_loss(scene, size, args.soft, args.silhouette)
    if args.soft:
        with torch.no_grad():
            flops, hbm_bytes, _ = cost.soft_step_cost(
                _soft_table(scene["vertices"],
                            scene["triangles"].flip(1).contiguous(),
                            scene["diffuse"], scene["eye"], size),
                scene["lights"].shape[1], size, size, args.silhouette)
        kind = "soft silhouette" if args.silhouette else "soft"
        baseline = (BASELINE_MEASURED["soft_cube_128_fwdbwd_renders_per_sec"]
                    if size == 128 else None)
    else:
        flops, hbm_bytes = _hard_cost(scene, size)
        kind = "hard"
        baseline = (BASELINE_MEASURED["hard_teapot_256_fwdbwd_renders_per_sec"]
                    if (size, args.batch, scene["mesh_name"])
                    == (256, 4, "teapot") else None)
    step = parallel.make_train_step(
        loss_fn, torch.optim.SGD([vertices], lr=0.0))
    ms, eager_ms, profile = _time_step(step, None, device, args.iters,
                                       args.profile)
    value = args.batch * 1e3 / ms
    return [_record(
        f"{kind} fwd+bwd renders/sec @ {size}^2 ({scene['mesh_name']}, "
        f"batch {args.batch}, {device.type})", value, "renders/sec", ms,
        eager_ms, flops, hbm_bytes, device, card, profile,
        vs_baseline=value / baseline if baseline else None)]


def _cube(device):
    verts, tris, _ = shapes.cube(2.0)
    return verts.to(device), tris.to(device)


def pose_problem(size, device):
    """bench_pose's problem at a square `size` image: (loss_fn, batch,
    scene). loss_fn(params, batch) is 1 - soft IoU of the cube's
    silhouette rotated by the Euler angles params[0] against
    batch["target"], the silhouette at bench.py's angles (-0.35, 0, 1.05);
    `scene` holds the cube's vertices [1, V, 3], its triangles and
    bench.py's camera (eye, center, up)."""
    verts, tris = _cube(device)
    f32 = dict(dtype=torch.float32, device=device)
    scene = dict(vertices=verts[None], triangles=tris,
                 eye=torch.tensor([[0.0, 0.0, 6.0]], **f32),
                 center=torch.zeros(1, 3, **f32),
                 up=torch.tensor([[0.0, 1.0, 0.0]], **f32))
    camera_args = [scene[k] for k in ("eye", "center", "up")]

    def render_alpha(angles):
        rot = camera.euler_matrices(angles[None])[0, :3, :3]
        return soft_mesh_renderer.render_silhouette(
            (verts @ rot.T)[None], tris, *camera_args, size, size,
            sigma_val=1e-4)[0]

    def loss_fn(params, batch):
        return 1.0 - losses.silhouette_iou(render_alpha(params[0]),
                                           batch["target"])

    with torch.no_grad():
        target = render_alpha(torch.tensor([-0.35, 0.0, 1.05], **f32))
    return loss_fn, {"target": target}, scene


def bench_pose(args, device, card):
    """The cube's rotation recovered from its silhouette (bench_pose)."""
    size = args.size
    loss_fn, batch, scene = pose_problem(size, device)
    angles = torch.zeros(3, dtype=torch.float32, device=device,
                         requires_grad=True)
    optimizer = torch.optim.Adam([angles], lr=5e-2,
                                 capturable=device.type == "cuda")
    loop = parallel.make_train_loop(loss_fn, optimizer, args.steps)
    final_loss = float(loop(batch)[-1])  # the first `steps` steps
    ms = common.wall_ms(lambda: loop(batch), device, 1, windows=5,
                        warmup=0) / args.steps
    eager_ms = common.wall_ms(lambda: loop.step.run_eager(batch), device,
                              min(args.steps, 20), windows=3, warmup=1)
    with torch.no_grad():
        zeros = torch.zeros_like(scene["vertices"])
        flops, hbm_bytes, _ = cost.soft_step_cost(
            sc.pack_triangle_data(scenes.clip_vertices(scene, size),
                                  scene["triangles"], zeros, zeros, zeros,
                                  BLUR), 0, size, size, silhouette=True)
    return [_record(
        f"soft pose-optimization steps/sec @{size}^2 ({args.steps} Adam "
        f"steps, {device.type}, captured loop)", 1e3 / ms, "steps/sec", ms,
        eager_ms, flops, hbm_bytes, device, card,
        _profile(lambda: loop.step(batch), device),
        final_iou_loss=final_loss)]


def bench_soft_sweep(args, device, card):
    """The soft step on the cube over the sigma / gamma grid
    (bench_soft_sweep): one captured loop of `iters` steps serves every
    point, sigma and gamma copied in as its batch."""
    size = args.size
    verts, tris = _cube(device)
    vertices = verts[None].repeat(args.batch, 1, 1).requires_grad_(True)
    colors = torch.ones_like(vertices)
    f32 = dict(dtype=torch.float32, device=device)
    eye = torch.tensor([[0.0, 0.0, 6.0]] * args.batch, **f32)
    center = torch.zeros(args.batch, 3, **f32)
    up = torch.tensor([[0.0, 1.0, 0.0]] * args.batch, **f32)
    lights = eye[:, None, :]
    intensities = torch.ones(args.batch, 1, **f32)

    def loss_fn(params, batch):
        images = soft_mesh_renderer.render(
            params[0], tris, colors, eye, center, up, lights, intensities,
            size, size, sigma_val=batch["sigma"], gamma_val=batch["gamma"])
        return torch.mean(images[..., 3] ** 2)

    loop = parallel.make_train_loop(
        loss_fn, torch.optim.SGD([vertices], lr=1e-30), args.iters)
    with torch.no_grad():
        flops, hbm_bytes, _ = cost.soft_step_cost(
            _soft_table(vertices, tris, colors, eye, size), 1, size, size)
    saturation_sigma = float(-(0.5 ** 2) / np.log(1e-3 / (1 - 1e-3)))
    records = []
    for sigma in (1e-5, 1e-4, saturation_sigma):
        for gamma in (1e-4, 1e-2, 1e-1):
            batch = {"sigma": torch.tensor(sigma, **f32),
                     "gamma": torch.tensor(gamma, **f32)}
            ms = common.wall_ms(lambda: loop(batch), device, 1, windows=1,
                                warmup=1) / args.iters
            eager_ms = common.wall_ms(lambda: loop.step.run_eager(batch),
                                      device, args.iters, windows=1,
                                      warmup=1)
            records.append(_record(
                f"soft fwd+bwd renders/sec @ {size}^2 (cube, batch "
                f"{args.batch}, sigma {sigma:.2e}, gamma {gamma:.2e}, "
                f"{device.type})", args.batch * 1e3 / ms, "renders/sec", ms,
                eager_ms, flops, hbm_bytes, device, card,
                _profile(lambda: loop.step(batch), device)))
    return records


def main(argv=None):
    """Runs the mode that `argv` names and prints its JSON lines; returns
    their dicts."""
    args = parse_args(argv)
    device = common.resolve_device(args.device)
    card = common.card_line() if device.type == "cuda" else "cpu"
    if args.size is None:
        args.size = 128 if args.pose or args.soft_sweep else 256
    if args.soft_sweep:
        records = bench_soft_sweep(args, device, card)
    elif args.pose:
        records = bench_pose(args, device, card)
    else:
        if args.stress:
            args.size, args.batch, args.sphere_resolution = 512, 64, 72
            args.iters = min(args.iters, 5)
        records = bench_render_step(args, device, card)
    for record in records:
        print(json.dumps(record), flush=True)
    return records


if __name__ == "__main__":
    main()
