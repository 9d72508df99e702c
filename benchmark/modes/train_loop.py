"""The multi-view silhouette fit: `parallel.make_train_loop` calls of a
fixed number of steps, Adam on the sphere's vertex offsets, fits of the
configuration's epochs back to back, each from the seed's start.

The set-up drives the loop's own step through the fit's first three steps:
the first captures it. The reference follows them (see `Cell.numbers`):
each step's loss, the first gradient as Adam holds it after one step (its
first moment over 1 - beta1), the parameters' change after three steps and
the silhouettes that the third step rendered.
"""

from __future__ import annotations

import time

import torch

from .. import compare, scene
from ..reference import fit as ref_fit
from ..reference import soft

KIND = "train"
FAULTS = ("state_unchanged", "half_batch", "altered")


class Cell:
    def __init__(self, env):
        self.env = env
        objective = env.traffic["objective"]
        if objective == "config":
            objective = env.config["fit"]
        self.fit = objective
        self.inputs = scene.fit_problem(env.config, env.traffic, env.seed,
                                        env.device)
        self.inputs["ref_edges"] = ref_fit.unique_edges(
            self.inputs["faces"])
        self.views = self.inputs["eye"].shape[0]
        self.steps_per_unit = env.traffic["steps_per_call"]
        self.calls_per_fit = max(1, objective["epochs"]
                                 // self.steps_per_unit)
        self.held = {}
        self.want = None

    def build(self):
        port = self.env.port()
        s, sc, size = self.inputs, self.env.scene, self.env.size
        losses = port["losses"]
        edges = port["mesh"].compute_edges_list(s["faces"])
        w = self.fit["loss"]
        cams = self.env.camera_kwargs()
        render = port["soft_mesh_renderer"].render_silhouette
        views = self.views

        def loss_fn(params, targets):
            vertices = s["vertices"] + params[0]
            alpha = render(vertices[None].expand(views, -1, -1), s["faces"],
                           s["eye"], s["center"], s["up"], size, size,
                           sigma_val=sc["sigma"],
                           blur_radius=sc["blur_radius"], **cams)
            self.held["alpha"] = alpha
            return (w["silhouette_mse"]
                    * losses.silhouette_mse_loss(alpha, targets)
                    + w["edge"] * losses.edge_loss(vertices, edges)
                    + w["laplacian"] * losses.laplacian_smoothing_loss(
                        vertices, edges))

        self.params = s["offsets"].clone().requires_grad_(True)
        self.optimizer = self.env.optimizer(self.fit["optimizer"],
                                            [self.params])
        self.loop = port["parallel"].make_train_loop(
            loss_fn, self.optimizer, self.steps_per_unit)

    def restart(self):
        """A new fit from the seed's start: the offsets and Adam's state
        set back in place, where the captured step reads them."""
        with torch.no_grad():
            self.params.copy_(self.inputs["offsets"])
            for value in self.optimizer.state[self.params].values():
                if torch.is_tensor(value):
                    value.zero_()

    def warm(self):
        """Set-up: the fit's first three steps through the loop's own step
        (the first captures it), read as the program's readings: each
        step's loss and parameters after it, the first gradient from Adam's
        first moment and the silhouettes the third step rendered; then the
        warm-up calls and a restart."""
        targets = self.inputs["targets"]
        step = self.loop.step
        losses, params, grad = [], [], None
        for k in range(3):
            losses.append(step(targets))
            if k == 0:
                beta1 = self.fit["optimizer"]["betas"][0]
                moment = self.optimizer.state[self.params].get("exp_avg")
                grad = (torch.zeros_like(self.params) if moment is None
                        else moment / (1.0 - beta1)).detach().clone()
            params.append(self.params.detach().clone())
        self.readings = {"losses": [float(x) for x in losses], "grad": grad,
                         "params": params,
                         "images": self.held["alpha"].detach().clone()}
        for _ in range(self.env.traffic["warmup_calls"]):
            self.loop(targets)
        self.restart()
        self.env.sync()

    def window(self, seconds):
        """Loop calls back to back for `seconds`, a restart before each
        fit, then a wait for the card. `failed` counts the last call's
        steps whose loss is not finite (all of the window's where the
        parameters are not)."""
        targets = self.inputs["targets"]
        host, calls = 0.0, 0
        self.env.sync()
        t0 = time.perf_counter()
        end = t0 + seconds
        while True:
            a = time.perf_counter()
            if calls and calls % self.calls_per_fit == 0:
                self.restart()
            losses = self.loop(targets)
            calls += 1
            b = time.perf_counter()
            host += b - a
            if b >= end:
                break
        self.env.sync()
        elapsed = time.perf_counter() - t0
        steps = calls * self.steps_per_unit
        failed = int((~torch.isfinite(losses)).sum())
        if not bool(torch.isfinite(self.params).all()):
            failed = steps
        return {"units": calls, "steps": steps, "seconds": elapsed,
                "failed": failed, "host_s": host,
                "metrics": {"train_images_per_s":
                            steps * self.views / elapsed}}

    def traced(self, count, span):
        """`count` loop calls from a fit's start; the offsets before and
        after are kept for the roofline's counts."""
        targets = self.inputs["targets"]
        self.restart()
        self.env.sync()
        self.trace_params = [self.params.detach().clone()]
        for _ in range(count):
            with span("bench.loop_call"):
                self.loop(targets)
        self.env.sync()
        self.trace_params.append(self.params.detach().clone())
        return count

    def finish(self):
        del self.loop, self.optimizer, self.params
        self.held.clear()

    def _evaluate(self, offsets, tf32=False, views=None):
        sc, size = self.env.scene, self.env.size
        fov, near, far = self.env.ref_camera()
        return ref_fit.fit_loss_and_grad(
            self.inputs, offsets, self.fit, size, fov, near, far,
            sc["sigma"], sc["blur_radius"], tf32=tf32, views=views)

    def reference(self, tf32=False, fault=None):
        """The reference put in the program's place: its readings over the
        fit's first three steps, as the program's."""
        views = (slice(0, self.views // 2) if fault == "half_batch"
                 else None)
        opt = self.fit["optimizer"]
        adam = ref_fit.Adam(opt["lr"], opt["betas"], opt["eps"])
        x = self.inputs["offsets"]
        losses, params, grad, images = [], [], None, None
        for k in range(3):
            loss, g, alpha = self._evaluate(x, tf32, views)
            losses.append(loss)
            grad = g if grad is None else grad
            images = alpha
            if fault != "state_unchanged":
                x = adam.step(x, g)
            params.append(x)
        if fault == "state_unchanged":
            grad = torch.zeros_like(grad)
        if fault == "altered":
            images = images.clone()
            images[0, self.env.size // 2, self.env.size // 2] += 1.0
        return {"losses": losses, "grad": grad, "params": params,
                "images": images}

    def numbers(self, got):
        """The numbers of the check. The reference follows the program's
        own state for what each step renders and loses: the loss of step k
        and the silhouettes of step 3 are the reference's at the
        parameters the program held before that step. The start (the first
        gradient, from the seed's offsets) and the optimizer's updates (the
        change after three steps) are held to the reference's own
        trajectory. The change is read per vertex at a high quantile
        (compare.vertex_norm_gap): Adam moves an element whose gradient is
        round-off by the sign of that round-off."""
        if self.want is None:
            self.want = self.reference()
        want, start = self.want, self.inputs["offsets"]
        follow = [want["losses"][0]]
        images = None
        for k, offsets in enumerate(got["params"][:2]):
            loss, _, alpha = self._evaluate(offsets)
            follow.append(loss)
            images = alpha
        mean_gap, max_gap = compare.image_gaps(got["images"], images)
        change = got["params"][2] - start
        want_change = want["params"][2] - start
        return {
            "loss_gap": max(compare.relative_gap(a, b) for a, b in
                            zip(got["losses"], follow)),
            "grad_gap": compare.norm_gap(got["grad"], want["grad"]),
            "change_gap": compare.vertex_norm_gap(change, want_change),
            "image_mean_gap": mean_gap,
            "image_max_gap": max_gap,
            "loss_gap_own_trajectory": max(
                compare.relative_gap(a, b) for a, b in
                zip(got["losses"], want["losses"])),
            "change_norm_gap": compare.norm_gap(change, want_change),
        }

    def work_inputs(self):
        """(shapes, counts of a step, steps a call) for the roofline: the
        reference's pair counts at the traced calls' first and last
        offsets, the smaller of the two."""
        sc, size = self.env.scene, self.env.size
        fov, near, far = self.env.ref_camera()
        s = self.inputs
        per = []
        for offsets in self.trace_params:
            counts = {}
            verts = (s["vertices"] + offsets)[None].expand(self.views, -1,
                                                          -1)
            with torch.no_grad():
                soft.render(verts, s["faces"], None, s["eye"], s["center"],
                            s["up"], None, None, size, fov, near, far,
                            sc["sigma"], 1.0, sc["blur_radius"],
                            shade=False, counts=counts)
            per.append(counts)
        counts = {k: min(c[k] for c in per) for k in per[0]}
        shape = dict(B=self.views, V=s["vertices"].shape[0],
                     T=s["faces"].shape[0], H=size, W=size, A=0, L=0)
        return shape, counts, self.steps_per_unit
