"""PyTorch port: its public API against the JAX package's, read with
`inspect` on both (the twin of tests/test_api_surface.py).

The port's package exports the JAX package's module names. In each of
those modules (and in the rasterizer entry points and test helpers that
tests/test_api_surface.py pins), every public function and class that the
JAX module defines exists in the port with the same parameter names, in
the same order, with the same defaults, except the differences listed
here with their reasons. The lists are held to the code both ways: a name
listed as not yet ported must be absent, and a listed signature must
still differ.
"""

import importlib
import inspect

import pytest

import pytorch_mesh_renderer_tpu as pmr
import pytorch_mesh_renderer_tpu_torch as pmt

# Module paths under each package, by the name the JAX package exports.
MODULES = {
    "config": "config", "parallel": "parallel",
    "mesh_renderer": "models.mesh_renderer",
    "soft_mesh_renderer": "models.soft_mesh_renderer",
    "shapes": "models.shapes", "camera": "ops.camera",
    "losses": "ops.losses", "mesh": "ops.mesh", "obj_io": "utils.obj_io",
    "checkpoint": "utils.checkpoint", "debug": "utils.debug",
    "profiling": "utils.profiling", "rasterize": "ops.rasterize",
    "soft_rasterize": "ops.soft_rasterize", "test_utils": "utils.test_utils",
}

# Every public name of the JAX package is ported (the device meshes and
# the sharded wrappers were the last).
NOT_YET_PORTED = set()
# TPU knobs the port does not carry over (ROADMAP, "Not carried over").
NOT_CARRIED_OVER = {("config", "resolve_dot_precision")}
# (module, name) -> the JAX parameters the port leaves out, and why.
DROPPED_PARAMETERS = {
    ("config", "HardRasterizerConfig"): (
        {"dot_precision", "spatial_sort", "binning", "interpret"},
        "TPU knobs: no port kernel has a binning, sort or precision mode"),
    ("config", "SoftRasterizerConfig"): (
        {"eps", "dot_precision", "binning", "interpret"},
        "TPU knobs and the XLA route's eps"),
    ("parallel", "make_train_step"): (
        {"donate"}, "the optimizer updates its tensors in place"),
    ("parallel", "make_train_loop"): (
        {"donate"}, "the optimizer updates its tensors in place"),
    ("test_utils", "expect_image_file_and_render_are_near"): (
        {"test_instance"}, "pytest asserts, not a unittest.TestCase"),
}
# (module, name) -> the keyword parameters the port adds after the JAX
# ones, and why.
ADDED_PARAMETERS = {
    ("parallel", "init_distributed"): (
        {"backend"}, "ranks that share one card take gloo, not NCCL"),
}


def _module(package, name):
    return importlib.import_module(f"{package.__name__}.{MODULES[name]}")


def _public(module):
    """The public functions and classes that `module` defines (a package:
    that its modules define)."""
    def defined_here(value):
        where = getattr(value, "__module__", "")
        return where == module.__name__ or (
            hasattr(module, "__path__")
            and where.startswith(module.__name__ + "."))

    return sorted(name for name, value in vars(module).items()
                  if not name.startswith("_")
                  and (inspect.isfunction(value) or inspect.isclass(value))
                  and defined_here(value))


def _parameters(fn):
    return [(p.name, p.default)
            for p in inspect.signature(fn).parameters.values()]


def test_package_exports_the_jax_packages_modules():
    assert pmt.__all__ == pmr.__all__
    for name in pmr.__all__:
        assert inspect.ismodule(getattr(pmt, name)), name


@pytest.mark.parametrize("name", sorted(MODULES))
def test_every_public_name_is_ported_or_listed(name):
    ours, theirs = _module(pmt, name), _module(pmr, name)
    assert _public(theirs), name
    for attr in _public(theirs):
        listed = (name, attr) in NOT_YET_PORTED | NOT_CARRIED_OVER
        assert hasattr(ours, attr) != listed, (name, attr)


@pytest.mark.parametrize("name", sorted(MODULES))
def test_signatures_and_defaults_match(name):
    ours, theirs = _module(pmt, name), _module(pmr, name)
    for attr in _public(theirs):
        if not hasattr(ours, attr):
            continue
        want = _parameters(getattr(theirs, attr))
        got = _parameters(getattr(ours, attr))
        dropped, _ = DROPPED_PARAMETERS.get((name, attr), (set(), ""))
        added, _ = ADDED_PARAMETERS.get((name, attr), (set(), ""))
        kept = [p for p in want if p[0] not in dropped]
        assert got[:len(kept)] == kept, (name, attr)
        assert {p[0] for p in got[len(kept):]} == added, (name, attr)
        assert dropped <= {p[0] for p in want}, (name, attr)
