"""Runs of the small cells on the CPU: a sound run comes out correct; the
control (the reference computed with TF32 camera products in the
program's place) and a run with the timed path broken underneath come out
not correct; nothing the benchmark imports is JAX or the JAX package."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import compare, env, harness
from benchmark.tests import small

FORBIDDEN_TOP = {"jax", "jaxlib", "flax", "pytorch_mesh_renderer_tpu"}


@pytest.mark.parametrize("name", small.CELLS)
def test_a_sound_run_is_correct(name):
    result, lines = small.run_small(name)
    assert result["correct"], lines
    assert lines[-1] == "correct: true"
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) == set(env.find_cell(name)[3]["limits"])
    assert result["attempted"] > 0 and result["failed"] == 0
    assert "setup_s" in result["metrics"]


@pytest.mark.parametrize("name", small.CELLS)
def test_the_control_is_not_correct(name):
    cell, config, traffic, limits, overrides = small.cell_files(name)
    e = env.Env(name, config, traffic, 2147483647, "cpu", overrides)
    c = harness.load_mode(traffic).Cell(e)
    numbers = c.numbers(c.reference(tf32=True))
    correct, checks = compare.judge(numbers, limits["limits"])
    assert not correct, checks


def _half(fn, per_view):
    """`fn` with its per-view arguments (by position) cut to half the
    batch."""
    def wrapped(*args, **kwargs):
        args = list(args)
        for i in per_view:
            args[i] = args[i][: args[i].shape[0] // 2]
        return fn(*args, **kwargs)
    return wrapped


def _altered(fn):
    """`fn` with one value of its output changed where it is produced."""
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs).clone()
        index = (0, out.shape[1] // 2, out.shape[2] // 2)
        out[index + ((0,) if out.dim() == 4 else ())] += 1.0
        return out
    return wrapped


FAULTS = {
    "teapot_256.hard_train_b4": ("mesh_renderer", "render",
                                 (0, 2, 3, 4, 5, 6, 7, 8)),
    "teapot_256.soft_train_b4": ("soft_mesh_renderer", "render",
                                 (0, 2, 3, 4, 5, 6, 7)),
    "cow_fit_128.train": ("soft_mesh_renderer", "render_silhouette", None),
    "teapot_256.hard_render_b64": ("mesh_renderer", "render",
                                   (0, 2, 3, 4, 5, 6, 7, 8)),
}


def _fault_cases():
    for name in small.CELLS:
        mode = harness.load_mode(env.find_cell(name)[2])
        for fault in mode.FAULTS:
            yield name, fault


@pytest.mark.parametrize("name,fault", list(_fault_cases()))
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    from pytorch_mesh_renderer_tpu_torch.models import (mesh_renderer,
                                                        soft_mesh_renderer)
    from pytorch_mesh_renderer_tpu_torch.ops import losses
    modules = {"mesh_renderer": mesh_renderer,
               "soft_mesh_renderer": soft_mesh_renderer}
    module, attr, per_view = FAULTS[name]
    fn = getattr(modules[module], attr)
    if fault == "half_batch" and per_view is None:
        # The fit's loss: the MSE over the first half of the views only.
        mse = losses.silhouette_mse_loss
        monkeypatch.setattr(losses, "silhouette_mse_loss", lambda a, t: mse(
            a[: a.shape[0] // 2], t[: t.shape[0] // 2]))
    elif fault == "half_batch":
        monkeypatch.setattr(modules[module], attr, _half(fn, per_view))
    elif fault == "altered":
        monkeypatch.setattr(modules[module], attr, _altered(fn))
    elif fault == "state_unchanged":
        monkeypatch.setattr(torch.optim.Adam, "step",
                            lambda self, closure=None: None)
    result, lines = small.run_small(name)
    assert not result["correct"], lines
    assert lines[-1] == "correct: false"


def test_nothing_imports_jax_or_the_jax_package():
    """In a fresh interpreter: every module of the benchmark, a run of a
    small cell, and no top-level name of JAX or the JAX package loaded
    (names compared whole: the port's begins with the JAX package's); the
    reference loads nothing of the program."""
    code = """
import json, os, pkgutil, sys, importlib
sys.path.insert(0, os.getcwd())
import benchmark.reference.hard, benchmark.reference.soft
import benchmark.reference.fit, benchmark.reference.camera
ref_only = sorted({m.split('.')[0] for m in sys.modules})
import benchmark
for info in pkgutil.walk_packages(benchmark.__path__, 'benchmark.'):
    if '.tests' not in info.name:
        importlib.import_module(info.name)
from benchmark.tests import small
small.run_small('teapot_256.hard_train_b4')
print(json.dumps([ref_only, sorted({m.split('.')[0] for m in sys.modules})]))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=env.ROOT,
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, USE_FLAX="0"))
    assert out.returncode == 0, out.stderr[-2000:]
    ref_only, everything = json.loads(out.stdout.strip().splitlines()[-1])
    assert not FORBIDDEN_TOP & set(everything)
    assert "pytorch_mesh_renderer_tpu_torch" in everything
    assert "pytorch_mesh_renderer_tpu_torch" not in ref_only
    assert harness.forbidden_modules() == sorted(
        FORBIDDEN_TOP & {m.split(".")[0] for m in sys.modules})
