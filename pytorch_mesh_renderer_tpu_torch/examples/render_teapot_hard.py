"""Forward render a teapot with the hard renderer (Phong + tone mapping).

Port of `examples/render_teapot_hard.py`:

    python -m pytorch_mesh_renderer_tpu_torch.examples.render_teapot_hard \
        --out teapot_hard.png [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from ..models import mesh_renderer
from . import common


def render_teapot(obj, width, height, device, config=None):
    """The tone-mapped RGBA render [height, width, 4] of the teapot lit
    from its camera at (0, 3, 3)."""
    vertices, triangles, normals = common.load_teapot(obj)
    # The hard renderer expects CW winding toward the viewer (OBJ is CCW).
    triangles = triangles.flip(1).to(device)
    vertices, normals = vertices[None].to(device), normals[None].to(device)
    f32 = dict(dtype=torch.float32, device=device)
    eye = torch.tensor([[0.0, 3.0, 3.0]], **f32)
    images = mesh_renderer.render(
        vertices, triangles, normals, torch.ones_like(vertices), eye,
        torch.zeros(1, 3, **f32), torch.tensor([[0.0, 1.0, 0.0]], **f32),
        eye[:, None, :], torch.ones(1, 1, 3, **f32), width, height,
        config=config)
    rgb = mesh_renderer.tone_mapper(images[..., :3], 0.7)
    return torch.cat([rgb, images[..., 3:]], dim=-1)[0]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--obj", type=str, default=None)
    parser.add_argument("--out", type=str, default="teapot_hard.png")
    parser.add_argument("--width", type=int, default=640)
    parser.add_argument("--height", type=int, default=480)
    common.add_device_argument(parser)
    args = parser.parse_args(argv)
    device = common.resolve_device(args.device)
    image = render_teapot(args.obj, args.width, args.height, device)
    common.save_png(args.out, image)
    return image


if __name__ == "__main__":
    main()
