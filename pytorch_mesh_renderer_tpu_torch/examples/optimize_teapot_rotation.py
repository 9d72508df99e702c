"""Teapot-rotation recovery with the hard or soft renderer.

Port of `examples/optimize_teapot_rotation.py`: recover the teapot's
Euler angles from a target render, starting `--perturbation` radians away
on each axis, by clipped SGD with momentum on an L1 pixel loss. Normals
are rotated by the inverse-transpose (for a rotation, the rotation
itself), kept explicit for parity. `--scan-chunk N` runs N steps per call
of `parallel.make_train_loop` (N replays of the captured step on the
card), the last chunk sized to the steps that remain.

    python -m pytorch_mesh_renderer_tpu_torch.examples.optimize_teapot_rotation \
        [--soft] [--scan-chunk 10] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import parallel
from ..models import mesh_renderer, soft_mesh_renderer
from ..ops import camera, losses
from . import common

TARGET_ANGLES = [0.0, 0.4, 0.0]
# The start's offset from the target on each axis (--perturbation).
PERTURBATION = 0.3


def make_render(obj, soft, size, device, config=None):
    """angles [3] -> the teapot's RGBA render [size, size, 4], through the
    rasterizer `config` (None: the default, by device)."""
    verts, tris, normals = (t.to(device) for t in common.load_teapot(obj))
    if not soft:
        tris = tris.flip(1)
    f32 = dict(dtype=torch.float32, device=device)
    eye = torch.tensor([[0.0, 3.0, 3.0]], **f32)
    center = torch.zeros(1, 3, **f32)
    up = torch.tensor([[0.0, 1.0, 0.0]], **f32)
    colors = torch.ones_like(verts)[None]
    soft_intensities = torch.ones(1, 1, **f32)
    hard_intensities = torch.ones(1, 1, 3, **f32)

    def render(angles):
        rot = camera.euler_matrices(angles[None])[0, :3, :3]
        v = (verts @ rot.T)[None]
        if soft:
            return soft_mesh_renderer.render(
                v, tris, colors, eye, center, up, eye[:, None, :],
                soft_intensities, size, size, config=config)[0]
        # The inverse-transpose of a rotation is the rotation; inv_ex
        # leaves its error code on the device (a capture cannot read it).
        n = (normals @ torch.linalg.inv_ex(rot).inverse)[None]
        return mesh_renderer.render(
            v, tris, n, colors, eye, center, up, eye[:, None, :],
            hard_intensities, size, size, config=config)[0]

    return render


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--obj", type=str, default=None)
    parser.add_argument("--soft", action="store_true")
    parser.add_argument("--steps", type=int, default=60)
    parser.add_argument("--size", type=int, default=128)
    parser.add_argument("--perturbation", type=float, default=PERTURBATION,
                        help="initial angle offset from the target (radians)")
    parser.add_argument("--out-video", type=str,
                        default="teapot_rotation.mp4")
    parser.add_argument("--out-plot", type=str,
                        default="teapot_rotation_loss.png")
    parser.add_argument("--scan-chunk", type=int, default=None,
                        help="run N optimizer steps per call of "
                             "parallel.make_train_loop (N replays of the "
                             "captured step on the card); one log line per "
                             "chunk")
    common.add_device_argument(parser)
    args = parser.parse_args(argv)
    device = common.resolve_device(args.device)

    render = make_render(args.obj, args.soft, args.size, device)
    target_angles = torch.tensor(TARGET_ANGLES, device=device)
    with torch.no_grad():
        target = render(target_angles)
    angles = (target_angles + args.perturbation).requires_grad_(True)

    def loss_fn(params, batch):
        return losses.image_l1_loss(render(params[0]), batch)

    optimizer = common.ClippedSGD([angles], lr=0.7, momentum=0.1)
    video = common.VideoWriter(args.out_video)
    history = []
    start, timed_steps = time.perf_counter(), 0
    if args.scan_chunk:
        # The tail chunk is sized to the remaining steps, so exactly
        # --steps steps run (at most two loop lengths are captured).
        loops = {}
        for i in range(0, args.steps, args.scan_chunk):
            k = min(args.scan_chunk, args.steps - i)
            if k not in loops:
                loops[k] = parallel.make_train_loop(loss_fn, optimizer, k)
            history.append(loops[k](target))
            if i == 0:  # the first chunk builds and captures: not timed
                common.synchronize(device)
                start = time.perf_counter()
            else:
                timed_steps += k
            print(f"step {i + k - 1}: loss {float(history[-1][-1]):.5f}")
        history = torch.cat(history).tolist()
    else:
        step = parallel.make_train_step(loss_fn, optimizer)
        for i in range(args.steps):
            history.append(step(target))
            if i == 0:
                common.synchronize(device)
                start = time.perf_counter()
            else:
                timed_steps += 1
            if i % 10 == 0:
                print(f"step {i}: loss {float(history[-1]):.5f}")
        history = torch.stack(history).tolist()
    steps_per_s = common.steps_per_second(start, timed_steps, device)
    video.close()
    common.save_loss_plot(args.out_plot, history)
    final = angles.detach().cpu().numpy()
    print(f"final angles {final.round(4)} "
          f"(target {np.asarray(TARGET_ANGLES, np.float32)})")
    print(f"final loss {history[-1]:.5f}; {steps_per_s:.1f} steps/s after "
          f"the first {'chunk' if args.scan_chunk else 'step'} "
          f"({device.type})")
    return {"losses": history, "angles": final, "steps_per_s": steps_per_s}


if __name__ == "__main__":
    main()
