"""Cube-rotation recovery with the hard or soft renderer.

Port of `examples/optimize_cube_rotation.py`: recover the Euler angles of
a cube with coloured vertices from a target image by SGD on an L1 pixel
loss, with the gradient clipped to global norm 1 (`common.ClippedSGD`).
The step (render, loss, backward, clip, momentum update) is
`parallel.make_train_step`'s, captured into a CUDA graph on the card.

    python -m pytorch_mesh_renderer_tpu_torch.examples.optimize_cube_rotation \
        [--soft] [--steps 50] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import parallel
from ..models import mesh_renderer, shapes, soft_mesh_renderer
from ..ops import camera, losses
from . import common

TARGET_ANGLES = [-0.35, 0.0, 1.05]
# Distinct vertex colours, so that the rotation is observable.
COLORS = [[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0], [1, 0, 1], [0, 1, 1],
          [1, 1, 1], [0.5, 0.5, 0.5]]


def make_render(soft, size, device, config=None):
    """angles [3] -> the cube's RGBA render [size, size, 4], through the
    rasterizer `config` (None: the default, by device)."""
    verts, tris, normals = (t.to(device) for t in shapes.cube(2.0))
    if not soft:
        tris = tris.flip(1)  # the hard renderer wants CW
    f32 = dict(dtype=torch.float32, device=device)
    colors = torch.tensor(COLORS, **f32)[None]
    eye = torch.tensor([[0.0, 0.0, 6.0]], **f32)
    center = torch.zeros(1, 3, **f32)
    up = torch.tensor([[0.0, 1.0, 0.0]], **f32)
    soft_intensities = torch.ones(1, 1, **f32)
    hard_intensities = torch.ones(1, 1, 3, **f32)

    def render(angles):
        rot = camera.euler_matrices(angles[None])[0, :3, :3]
        v = (verts @ rot.T)[None]
        if soft:
            return soft_mesh_renderer.render(
                v, tris, colors, eye, center, up, eye[:, None, :],
                soft_intensities, size, size, config=config)[0]
        n = (normals @ rot.T)[None]
        return mesh_renderer.render(
            v, tris, n, colors, eye, center, up, eye[:, None, :],
            hard_intensities, size, size, config=config)[0]

    return render


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--soft", action="store_true")
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--size", type=int, default=128)
    parser.add_argument("--out-video", type=str, default="cube_rotation.mp4")
    parser.add_argument("--out-plot", type=str,
                        default="cube_rotation_loss.png")
    common.add_device_argument(parser)
    args = parser.parse_args(argv)
    device = common.resolve_device(args.device)

    render = make_render(args.soft, args.size, device)
    target_angles = torch.tensor(TARGET_ANGLES, device=device)
    with torch.no_grad():
        target = render(target_angles)

    angles = torch.zeros(3, device=device, requires_grad=True)
    step = parallel.make_train_step(
        lambda params, batch: losses.image_l1_loss(render(params[0]), batch),
        common.ClippedSGD([angles], lr=0.7, momentum=0.1))

    video = common.VideoWriter(args.out_video)
    history = []
    start = time.perf_counter()
    for i in range(args.steps):
        history.append(step(target))
        if i == 0:  # the first step builds and captures: not timed
            common.synchronize(device)
            start = time.perf_counter()
        if i % 10 == 0:
            print(f"step {i}: loss {float(history[-1]):.5f} angles "
                  f"{angles.detach().cpu().numpy().round(3)}")
    steps_per_s = common.steps_per_second(start, args.steps - 1, device)
    video.close()
    history = torch.stack(history).tolist()
    common.save_loss_plot(args.out_plot, history)
    final = angles.detach().cpu().numpy()
    print(f"final angles: {final.round(4)} "
          f"(target {np.asarray(TARGET_ANGLES, np.float32)})")
    print(f"final loss {history[-1]:.5f}; {steps_per_s:.1f} steps/s after "
          f"the first step ({device.type})")
    return {"losses": history, "angles": final, "steps_per_s": steps_per_s}


if __name__ == "__main__":
    main()
