"""Camera-pose optimization against a target image (hard renderer).

Port of `examples/optimize_camera_pose.py`: optimize the camera's eye
position and the Euler angles of its look rotation with clipped SGD
with momentum (`common.ClippedSGD`, one global norm over both) on an L1
image loss. Like the reference's version, it does not converge reliably:
neither formulation is convex, and it demonstrates gradient quality.

    python -m pytorch_mesh_renderer_tpu_torch.examples.optimize_camera_pose \
        [--target example4_target.png] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from .. import parallel
from ..models import mesh_renderer
from ..ops import camera, losses
from . import common

# The camera the optimization starts from.
INITIAL_EYE = [0.0, 2.5, 3.5]
INITIAL_ANGLES = [-0.6, 0.0, 0.0]


def make_render(obj, width, height, device, config=None):
    """(eye [3], angles [3]) -> the teapot's RGBA render [height, width,
    4] from that camera, through the rasterizer `config` (None: the
    default, by device)."""
    vertices, triangles, normals = common.load_teapot(obj)
    triangles = triangles.flip(1).to(device)  # CW for the hard renderer
    vertices, normals = vertices[None].to(device), normals[None].to(device)
    f32 = dict(dtype=torch.float32, device=device)
    diffuse = torch.ones_like(vertices)
    lights = torch.tensor([[[0.0, 3.0, 3.0]]], **f32)
    intensities = torch.ones(1, 1, 3, **f32)
    forward = torch.tensor([0.0, 0.0, -1.0], **f32)
    upward = torch.tensor([0.0, 1.0, 0.0], **f32)

    def render(eye, angles):
        rot = camera.euler_matrices(angles[None])[0, :3, :3]
        eye = eye[None]
        # The look direction rotates with the Euler angles.
        center = (rot @ forward)[None] + eye
        up = (rot @ upward)[None]
        return mesh_renderer.render(
            vertices, triangles, normals, diffuse, eye, center, up, lights,
            intensities, width, height, config=config)[0]

    return render


def load_target(path, width, height):
    """The target PNG at [height, width] by nearest neighbour, with an
    opaque alpha channel added to an RGB file."""
    target = common.load_png(path)
    if target.shape[:2] != (height, width):
        print("[example] resizing target via nearest neighbor")
        ys = np.arange(height) * target.shape[0] // height
        xs = np.arange(width) * target.shape[1] // width
        target = target[ys][:, xs]
    if target.shape[-1] == 3:
        target = np.concatenate(
            [target, np.ones(target.shape[:2] + (1,), np.float32)], axis=-1)
    return torch.from_numpy(np.ascontiguousarray(target))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--obj", type=str, default=None)
    parser.add_argument("--target", type=str,
                        default=common.target_path("example4_target.png"))
    parser.add_argument("--out-video", type=str, default="camera_pose.mp4")
    parser.add_argument("--out-plot", type=str, default="camera_pose_loss.png")
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--width", type=int, default=320)
    parser.add_argument("--height", type=int, default=240)
    common.add_device_argument(parser)
    args = parser.parse_args(argv)
    device = common.resolve_device(args.device)
    f32 = dict(dtype=torch.float32, device=device)

    render = make_render(args.obj, args.width, args.height, device)
    if os.path.exists(args.target):
        target = load_target(args.target, args.width, args.height).to(device)
    else:
        print("[example] target image missing; rendering a synthetic target")
        with torch.no_grad():
            target = render(torch.tensor([0.0, 3.2, 2.8], **f32),
                            torch.tensor([-0.7, 0.1, 0.0], **f32))

    eye = torch.tensor(INITIAL_EYE, **f32, requires_grad=True)
    angles = torch.tensor(INITIAL_ANGLES, **f32, requires_grad=True)
    step = parallel.make_train_step(
        lambda params, batch: losses.image_l1_loss(render(*params), batch),
        common.ClippedSGD([eye, angles], lr=0.7, momentum=0.1))

    video = common.VideoWriter(args.out_video)
    history = []
    start = time.perf_counter()
    for i in range(args.steps):
        history.append(step(target))
        if i == 0:  # the first step builds and captures: not timed
            common.synchronize(device)
            start = time.perf_counter()
        if i % 5 == 0:
            print(f"step {i}: loss {float(history[-1]):.5f}")
    steps_per_s = common.steps_per_second(start, args.steps - 1, device)
    video.close()
    history = torch.stack(history).tolist()
    common.save_loss_plot(args.out_plot, history)
    final_eye = eye.detach().cpu().numpy()
    final_angles = angles.detach().cpu().numpy()
    print(f"final loss {history[-1]:.5f}, eye {final_eye.round(4)}, angles "
          f"{final_angles.round(4)}; {steps_per_s:.1f} steps/s after the "
          f"first step ({device.type})")
    return {"losses": history, "eye": final_eye, "angles": final_angles,
            "steps_per_s": steps_per_s}


if __name__ == "__main__":
    main()
