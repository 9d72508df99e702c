"""Forward renders in a closed loop of one caller: an eager
`mesh_renderer.render` under `torch.no_grad()` of a batch of views, then a
wait until its images are ready on the card, then the next call. The
batches of a pool are rendered in turn.

Each call's latency runs from the call to its images being ready. The
images of a sample of calls, drawn from the seed, are kept and compared
with the reference once the window has closed.
"""

from __future__ import annotations

import math
import random
import time

import torch

from .. import compare, scene
from ..reference import hard

KIND = "render"
FAULTS = ("half_batch", "altered")


class Cell:
    def __init__(self, env):
        self.env = env
        traffic = env.traffic
        self.views = traffic["views"]
        self.pool = traffic["pool"]
        self.inputs = scene.teapot_views(env.config, self.views, env.seed,
                                         env.device, batches=self.pool)
        self.steps_per_unit = 1
        # The sampled calls: distinct batches of the pool, among the first
        # two rounds of it.
        rng = random.Random(env.seed)
        self.sample = sorted(rng.sample(range(2 * self.pool),
                                        traffic["sample_calls"]))
        while len({k % self.pool for k in self.sample}) < len(self.sample):
            self.sample = sorted(rng.sample(range(2 * self.pool),
                                            traffic["sample_calls"]))
        self.want = None

    def build(self):
        self.render_fn = self.env.port()["mesh_renderer"].render

    def _call(self, k):
        s, size = self.inputs, self.env.size
        p = k % self.pool
        with torch.no_grad():
            return self.render_fn(
                s["vertices"][p], s["faces_cw"], s["normals"][p],
                s["diffuse"], s["eye"], s["center"], s["up"], s["lights"],
                s["intensities_rgb"], size, size, **self.env.camera_kwargs())

    def warm(self):
        for k in range(self.env.traffic["warmup_calls"]):
            self._call(k)
        self.env.sync()
        self.readings = {"images": {}}

    def window(self, seconds):
        latencies, host = [], []
        self.env.sync()
        t0 = time.perf_counter()
        end = t0 + seconds
        k = 0
        wanted = set(self.sample)
        while True:
            a = time.perf_counter()
            images = self._call(k)
            b = time.perf_counter()
            self.env.sync()
            c = time.perf_counter()
            latencies.append(c - a)
            host.append(b - a)
            if k in wanted:
                self.readings["images"][k] = images
            k += 1
            if c >= end:
                break
        elapsed = time.perf_counter() - t0
        ordered = sorted(latencies)
        p95 = ordered[max(0, math.ceil(0.95 * len(ordered)) - 1)]
        return {"units": k, "steps": k, "seconds": elapsed, "failed": 0,
                "host_s": sum(host),
                "metrics": {"render_images_per_s": k * self.views / elapsed,
                            "render_ms_p95": p95 * 1e3}}

    def traced(self, count, span):
        self.trace_batches = [k % self.pool for k in range(count)]
        for k in range(count):
            with span("bench.render_call"):
                self._call(k)
            with span("bench.wait"):
                self.env.sync()
        return count

    def finish(self):
        del self.render_fn

    def reference(self, tf32=False, fault=None):
        """The reference's images of the sampled calls."""
        s, size = self.inputs, self.env.size
        fov, near, far = self.env.ref_camera()
        out = {}
        for k in self.sample:
            p = k % self.pool
            views = self.views // 2 if fault == "half_batch" else self.views
            with torch.no_grad():
                images = hard.render(
                    s["vertices"][p][:views], s["faces_cw"],
                    s["normals"][p][:views], s["diffuse"][:views],
                    s["eye"][:views], s["center"][:views], s["up"][:views],
                    s["lights"][:views], s["intensities_rgb"][:views], size,
                    fov, near, far, tf32=tf32)
            if fault == "altered":
                images[0, size // 2, size // 2, 0] += 1.0
            out[k] = images
        return {"images": out}

    def numbers(self, got):
        """The sampled calls' images against the reference's."""
        if self.want is None:
            self.want = self.reference()
        gaps = [compare.image_gaps(got["images"].get(k),
                                   self.want["images"][k])
                for k in self.sample]
        return {"image_mean_gap": max(g[0] for g in gaps),
                "image_max_gap": max(g[1] for g in gaps)}

    def work_inputs(self):
        """(shapes, counts of a call, 1) for the roofline: the reference's
        pair counts over the traced calls' batches, a call's mean."""
        s, size = self.inputs, self.env.size
        fov, near, far = self.env.ref_camera()
        total = {}
        for p in set(self.trace_batches):
            counts = {}
            hard.count(s["vertices"][p], s["faces_cw"], s["eye"],
                       s["center"], s["up"], size, fov, near, far, counts)
            for key, value in counts.items():
                total[key] = (total.get(key, 0)
                              + value * self.trace_batches.count(p))
        counts = {k: v / len(self.trace_batches) for k, v in total.items()}
        shape = dict(B=self.views, V=s["vertices"].shape[2],
                     T=s["faces_cw"].shape[0], H=size, W=size, A=9,
                     L=s["lights"].shape[1])
        return shape, counts, 1
