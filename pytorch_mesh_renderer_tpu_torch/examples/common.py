"""Shared helpers for the example CLIs.

Port of `examples/common.py`: teapot loading, the optimization targets,
PNG output and the loss plot, plus the optimizer the rotation and camera
examples share. PNGs are read and written by `utils/test_utils`' stdlib
codec. The port depends on neither imageio nor matplotlib, so the video
and the loss plot are skipped with a message, as the JAX examples skip
them where those packages are missing.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from ..models import shapes
from ..utils import obj_io, test_utils
from ..utils.device import resolve_device

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_TEAPOT = os.path.join(_REPO, "assets", "teapot.obj")
# The reference's optimization targets (its example*_target*.png), vendored.
EXAMPLE_TARGETS = os.path.join(_REPO, "assets", "example_targets")

__all__ = ["DEFAULT_TEAPOT", "EXAMPLE_TARGETS", "ClippedSGD", "VideoWriter",
           "add_device_argument", "load_png", "load_teapot", "resolve_device",
           "save_loss_plot", "save_png", "steps_per_second", "synchronize",
           "target_path"]


def add_device_argument(parser):
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where to run (default cuda; without a card it "
                             "raises: cpu runs the kernels' plain versions)")


def target_path(name):
    """Path of a vendored example target PNG (assets/example_targets)."""
    return os.path.join(EXAMPLE_TARGETS, name)


def load_teapot(path=None, normalize=True):
    """Teapot OBJ (vendored asset) or a procedural sphere fallback, as CPU
    tensors (vertices, triangles CCW, normals)."""
    path = path or DEFAULT_TEAPOT
    if os.path.exists(path):
        return obj_io.load_obj(path, normalize=normalize)
    print(f"[examples] {path} not found; using a procedural sphere",
          file=sys.stderr)
    return shapes.sphere(1.0, resolution=24)


def _uint8(image):
    if torch.is_tensor(image):
        image = image.detach().cpu().numpy()
    image = np.clip(np.asarray(image, np.float64), 0.0, 1.0)
    return (image * 255.0).astype(np.uint8)


def save_png(path, image):
    """Writes an [H, W, C] float image in [0, 1] (tensor or array) as PNG,
    quantised as the JAX examples quantise it."""
    test_utils.write_png(path, _uint8(image))
    print(f"wrote {path}")


def load_png(path):
    """[H, W, C] float32 in [0, 1]."""
    return test_utils.read_png(path).astype(np.float32) / 255.0


class VideoWriter:
    """The JAX examples' mp4 writer. The port has no video encoder, so it
    says so once and writes nothing: the examples render no frames for it.
    """

    def __init__(self, path, fps=20):
        self.path = path
        print(f"[examples] no mp4 writer in the port (imageio is not a "
              f"dependency); skipping video {path}", file=sys.stderr)

    def append(self, image):
        pass

    def close(self):
        pass


def save_loss_plot(path, losses):
    print(f"[examples] matplotlib is not a dependency of the port; skipping "
          f"loss plot {path}", file=sys.stderr)


class ClippedSGD(torch.optim.SGD):
    """`optax.chain(optax.clip_by_global_norm(max_norm), optax.sgd(lr,
    momentum))` as a torch optimizer.

    The global norm covers every parameter's gradient; below `max_norm`
    the gradients pass as they are, else each is scaled by max_norm /
    norm (optax's rule: `clip_grad_norm_` adds 1e-6 to the norm and so
    differs). The clip sits in `step` and makes no host sync, so a step
    of `parallel.make_train_step` that holds it can be captured. SGD's
    momentum buffer (dampening 0) is optax's trace from the first step.
    """

    def __init__(self, params, lr, momentum=0.0, max_norm=1.0):
        super().__init__(params, lr=lr, momentum=momentum)
        self.max_norm = max_norm

    @torch.no_grad()
    def step(self, closure=None):
        grads = [p.grad for group in self.param_groups
                 for p in group["params"] if p.grad is not None]
        if grads:
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            for g in grads:
                g.copy_(torch.where(norm < self.max_norm, g,
                                    g / norm * self.max_norm))
        return super().step(closure)


def synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def steps_per_second(start, steps, device):
    """`steps` over the host time since `start` (time.perf_counter), after
    the device finished; nan for no steps."""
    synchronize(device)
    return steps / (time.perf_counter() - start) if steps else float("nan")
