"""What every mode of the benchmark shares: the cell's files, the device,
the program's modules and the size of the run."""

from __future__ import annotations

import json
import os

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark_file():
    return load_json(ROOT, "BENCHMARK.json")


def find_cell(name):
    """The `workloads` entry named `name` of BENCHMARK.json, with its
    configuration and traffic files (configs/<config>.json,
    traffic/<traffic>.json) and its limits (limits/<name>.json)."""
    bench = benchmark_file()
    cells = {c["name"]: c for c in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(cells)}")
    cell = cells[name]
    return (cell, load_json(HERE, "configs", cell["config"] + ".json"),
            load_json(HERE, "traffic", cell["traffic"] + ".json"),
            load_json(HERE, "limits", name + ".json"))


class Env:
    """One run's settings. `overrides` (tests only) replaces scene keys of
    the configuration, such as `image_size` or `mesh`, to run small on the
    CPU."""

    def __init__(self, name, config, traffic, seed, device,
                 overrides=None):
        self.name, self.seed = name, int(seed)
        self.config = json.loads(json.dumps(config))
        self.config["scene"].update(overrides or {})
        self.traffic = traffic
        self.device = torch.device(device)
        self.scene = self.config["scene"]
        self.size = int(self.scene["image_size"])

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def port(self):
        """The program's modules that a user of it calls."""
        from pytorch_mesh_renderer_tpu_torch import parallel
        from pytorch_mesh_renderer_tpu_torch.models import (
            mesh_renderer, soft_mesh_renderer)
        from pytorch_mesh_renderer_tpu_torch.ops import losses, mesh
        return dict(parallel=parallel, mesh_renderer=mesh_renderer,
                    soft_mesh_renderer=soft_mesh_renderer, losses=losses,
                    mesh=mesh)

    def optimizer(self, spec, params):
        if spec["name"] == "sgd":
            return torch.optim.SGD(params, lr=spec["lr"])
        if spec["name"] == "adam":
            return torch.optim.Adam(params, lr=spec["lr"],
                                    betas=tuple(spec["betas"]),
                                    eps=spec["eps"],
                                    capturable=self.device.type == "cuda")
        raise ValueError(f"unknown optimizer {spec['name']!r}")

    def camera_kwargs(self):
        return dict(fov_y=self.scene["fov_y"], near_clip=self.scene[
            "near_clip"], far_clip=self.scene["far_clip"])

    def ref_camera(self):
        return (self.scene["fov_y"], self.scene["near_clip"],
                self.scene["far_clip"])
