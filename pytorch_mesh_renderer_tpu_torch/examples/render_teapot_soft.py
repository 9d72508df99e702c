"""Forward render a teapot with the soft (SoftRas) renderer.

Port of `examples/render_teapot_soft.py`: a 100x100 soft render with the
alpha binarised at 0.5.

    python -m pytorch_mesh_renderer_tpu_torch.examples.render_teapot_soft \
        --out teapot_soft.png [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from ..models import soft_mesh_renderer
from . import common


def render_teapot(obj, size, sigma, gamma, device, config=None):
    """The soft RGBA render [size, size, 4] of the teapot, alpha
    binarised."""
    vertices, triangles, _ = common.load_teapot(obj)
    vertices, triangles = vertices[None].to(device), triangles.to(device)
    f32 = dict(dtype=torch.float32, device=device)
    eye = torch.tensor([[0.0, 3.0, 3.0]], **f32)
    images = soft_mesh_renderer.render(
        vertices, triangles, torch.ones_like(vertices), eye,
        torch.zeros(1, 3, **f32), torch.tensor([[0.0, 1.0, 0.0]], **f32),
        eye[:, None, :], torch.ones(1, 1, **f32), size, size,
        sigma_val=sigma, gamma_val=gamma, config=config)
    alpha = (images[..., 3:] > 0.5).to(torch.float32)
    return torch.cat([images[..., :3], alpha], dim=-1)[0]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--obj", type=str, default=None)
    parser.add_argument("--out", type=str, default="teapot_soft.png")
    parser.add_argument("--size", type=int, default=100)
    parser.add_argument("--sigma", type=float, default=1e-5)
    parser.add_argument("--gamma", type=float, default=1e-4)
    common.add_device_argument(parser)
    args = parser.parse_args(argv)
    device = common.resolve_device(args.device)
    image = render_teapot(args.obj, args.size, args.sigma, args.gamma,
                          device)
    common.save_png(args.out, image)
    return image


if __name__ == "__main__":
    main()
