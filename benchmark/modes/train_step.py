"""Training steps on the teapot's views: one captured
`parallel.make_train_step` call a step, no sync between steps.

The step renders the views (the hard Phong or the soft renderer), takes the
loss the traffic names, back-propagates to the vertices and lets
`torch.optim.SGD` update them. At lr 0 every step does the same work, so
the reference follows the first three steps from one evaluation; the
parameters must come out of the window unchanged.
"""

from __future__ import annotations

import time

import torch

from .. import compare, scene
from ..reference import hard, soft

KIND = "train"
FAULTS = ("half_batch", "altered")


def _loss(images, weights, renderer):
    total = 0.0
    for term, weight in weights.items():
        if term == "mean_rgb_sq":
            total = total + weight * torch.mean(images[..., :3] ** 2)
        elif term == "mean_alpha_sq":
            total = total + weight * torch.mean(images[..., 3] ** 2)
        else:
            raise ValueError(f"unknown loss term {term!r}")
    return total


class Cell:
    def __init__(self, env):
        self.env = env
        objective = env.traffic["objective"]
        self.weights = objective["loss"]
        self.optimizer_spec = objective["optimizer"]
        self.renderer = env.traffic["renderer"]
        self.views = env.traffic["views"]
        self.inputs = scene.teapot_views(env.config, self.views, env.seed,
                                         env.device)
        self.steps_per_unit = 1
        self.held = {}
        self.want = None
        self.start = self.inputs["vertices"][0].clone()

    def _render_program(self, vertices):
        port, s, sc, size = self.port, self.inputs, self.env.scene, \
            self.env.size
        if self.renderer == "hard":
            return port["mesh_renderer"].render(
                vertices, s["faces_cw"], s["normals"][0], s["diffuse"],
                s["eye"], s["center"], s["up"], s["lights"],
                s["intensities_rgb"], size, size, **self.env.camera_kwargs())
        return port["soft_mesh_renderer"].render(
            vertices, s["faces_ccw"], s["diffuse"], s["eye"], s["center"],
            s["up"], s["lights"], s["intensities"], size, size,
            sigma_val=sc["sigma"], gamma_val=sc["gamma"],
            blur_radius=sc["blur_radius"], **self.env.camera_kwargs())

    def build(self):
        """The program's step and its parameters."""
        self.port = self.env.port()
        self.params = self.start.clone().requires_grad_(True)

        def loss_fn(params, batch):
            images = self._render_program(params[0])
            self.held["images"] = images
            return _loss(images, self.weights, self.renderer)

        self.optimizer = self.env.optimizer(self.optimizer_spec,
                                            [self.params])
        self.step = self.port["parallel"].make_train_step(loss_fn,
                                                          self.optimizer)

    def warm(self):
        """Set-up: the first three steps through the step the window calls
        (the first captures it), read as the program's readings; then the
        warm-up steps."""
        losses = [self.step(None)]
        losses.append(self.step(None))
        grad = self.params.grad.detach().clone()
        images = self.held["images"].detach().clone()
        losses.append(self.step(None))
        self.readings = {"losses": [float(x) for x in losses],
                         "grad": grad, "images": images}
        for _ in range(self.env.traffic["warmup_calls"]):
            self.step(None)
        self.env.sync()

    def window(self, seconds):
        """Steps back to back for `seconds`, then a wait for the card. The
        steps' losses are not kept (a list of them would grow the
        allocated memory with the step count): `failed` counts the steps
        after the window whose loss or parameters are not finite."""
        host, n = 0.0, 0
        self.env.sync()
        t0 = time.perf_counter()
        end = t0 + seconds
        while True:
            a = time.perf_counter()
            loss = self.step(None)
            b = time.perf_counter()
            host += b - a
            n += 1
            if b >= end:
                break
        self.env.sync()
        elapsed = time.perf_counter() - t0
        finite = bool(torch.isfinite(loss)) and bool(
            torch.isfinite(self.params).all())
        return {"units": n, "steps": n, "seconds": elapsed,
                "failed": 0 if finite else n, "host_s": host,
                "metrics": {"train_images_per_s": n * self.views / elapsed}}

    def traced(self, count, span):
        for _ in range(count):
            with span("bench.step"):
                self.step(None)
        return count

    def finish(self):
        """After the window: what the reference checks, then the program's
        state freed."""
        self.readings["moved"] = float(
            (self.params.detach() - self.start).abs().max())
        del self.step, self.optimizer, self.params
        self.held.clear()

    def reference(self, tf32=False, fault=None):
        """The reference's readings: the loss of each of the three steps,
        the gradient and the images, at the start (lr 0 keeps it)."""
        s, sc, size = self.inputs, self.env.scene, self.env.size
        views = self.views // 2 if fault == "half_batch" else self.views
        v = self.start[:views].clone().requires_grad_(True)
        fov, near, far = self.env.ref_camera()
        if self.renderer == "hard":
            images = hard.render(
                v, s["faces_cw"], s["normals"][0][:views],
                s["diffuse"][:views], s["eye"][:views], s["center"][:views],
                s["up"][:views], s["lights"][:views],
                s["intensities_rgb"][:views], size, fov, near, far, tf32=tf32)
            loss = _loss(images, self.weights, self.renderer)
            loss.backward()
        else:
            n = views * size * size
            weight = self.weights["mean_alpha_sq"]

            def pixel_loss(alpha, _rgb, b, r, c):
                return weight * torch.sum(alpha ** 2) / n

            images = soft.render(
                v, s["faces_ccw"], s["diffuse"][:views], s["eye"][:views],
                s["center"][:views], s["up"][:views], s["lights"][:views],
                s["intensities"][:views], size, fov, near, far, sc["sigma"],
                sc["gamma"], sc["blur_radius"], tf32=tf32,
                pixel_loss=pixel_loss)
            loss = _loss(images, self.weights, self.renderer)
        images = images.detach()
        if fault == "altered":
            images = images.clone()
            images[0, size // 2, size // 2, 0] += 1.0
        grad = v.grad.detach()
        loss = float(loss.detach())
        return {"losses": [loss] * 3, "grad": grad, "images": images,
                "moved": 0.0}

    def numbers(self, got):
        """The numbers of the check: `got` (the program's readings, or the
        control's or a fault's) against the reference's."""
        if self.want is None:
            self.want = self.reference()
        want = self.want
        mean_gap, max_gap = compare.image_gaps(got["images"], want["images"])
        return {
            "loss_gap": max(compare.relative_gap(a, b) for a, b in
                            zip(got["losses"], want["losses"])),
            "grad_gap": compare.norm_gap(got["grad"], want["grad"]),
            "grad_gap_p99": compare.vertex_norm_gap(got["grad"],
                                                    want["grad"]),
            "image_mean_gap": mean_gap,
            "image_max_gap": max_gap,
            "params_moved": got["moved"],
        }

    def work_inputs(self):
        """(shapes, counts, 1) of one step for the roofline: the
        reference's pair counts at the start, which every step renders."""
        s, sc, size = self.inputs, self.env.scene, self.env.size
        fov, near, far = self.env.ref_camera()
        counts = {}
        with torch.no_grad():
            if self.renderer == "hard":
                hard.render(self.start, s["faces_cw"], s["normals"][0],
                            s["diffuse"], s["eye"], s["center"], s["up"],
                            s["lights"], s["intensities_rgb"], size, fov,
                            near, far, counts=counts)
            else:
                soft.render(self.start, s["faces_ccw"], s["diffuse"],
                            s["eye"], s["center"], s["up"], s["lights"],
                            s["intensities"], size, fov, near, far,
                            sc["sigma"], sc["gamma"], sc["blur_radius"],
                            counts=counts)
        return self.work_shape(), counts, 1

    def work_shape(self):
        s = self.inputs
        return dict(B=self.views, V=s["vertices"].shape[2],
                    T=s["faces_cw"].shape[0], H=self.env.size,
                    W=self.env.size, A=9, L=s["lights"].shape[1])
