"""PyTorch port: the flagship cow fit against the JAX package's, on the CPU.

`fit_shape_multiview` of the port (`main([..., "--device", "cpu"])`)
beside examples/fit_shape_multiview.py's `main()` (argv patched), at a
small size (32x32 views, sphere resolution 8, 3 epochs) with
`--scan-chunk 2` (a loop of 2 steps, then one of 1) on the vendored cow
targets: the final OBJs' vertices agree within 1e-4 of their max |v|,
and the port resumed through `--checkpoint` after 2 epochs writes the
same final OBJ as its straight run, byte for byte, also from a
checkpoint whose Adam state was saved capturable (as on the card).
Outputs go to `tmp_path`. (A file of its own, so that pytest-xdist runs
it beside tests/test_torch_examples.py.)
"""

import sys

import numpy as np
import pytest
import torch

from pytorch_mesh_renderer_tpu_torch.examples import fit_shape_multiview
from pytorch_mesh_renderer_tpu_torch.utils import obj_io

from conftest import ASSETS_DIR

sys.path.insert(0, f"{ASSETS_DIR}/../examples")
import fit_shape_multiview as jfit  # noqa: E402  (examples/)

ARGS = ["--size", "32", "--resolution", "8", "--scan-chunk", "2"]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes on one machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _port(tmp_path, prefix, epochs, checkpoint=None):
    argv = ARGS + ["--epochs", str(epochs), "--device", "cpu",
                   "--out-prefix", str(tmp_path / prefix)]
    if checkpoint:
        argv += ["--checkpoint", str(tmp_path / checkpoint)]
    return fit_shape_multiview.main(argv)


def test_fit_matches_jax_and_resumes_from_its_checkpoint(tmp_path,
                                                         monkeypatch):
    monkeypatch.setattr(sys, "argv", ["fit"] + ARGS + [
        "--epochs", "3", "--out-prefix", str(tmp_path / "jax")])
    jfit.main()
    straight = _port(tmp_path, "straight", 3)
    first = _port(tmp_path, "resumed", 2, "fit.ckpt")
    resumed = _port(tmp_path, "resumed", 3, "fit.ckpt")

    assert straight["targets_from_file"]
    assert [p["epoch"] for p in straight["previews"]] == [1, 2]
    assert [p["epoch"] for p in first["previews"]] == [1]
    assert [p["epoch"] for p in resumed["previews"]] == [2]
    theirs = obj_io.load_obj(str(tmp_path / "jax_final.obj"),
                             normalize=False)[0].numpy()
    ours = obj_io.load_obj(str(tmp_path / "straight_final.obj"),
                           normalize=False)[0].numpy()
    np.testing.assert_array_equal(ours, straight["vertices"])
    np.testing.assert_allclose(ours, theirs, rtol=0,
                               atol=1e-4 * np.abs(theirs).max())
    assert np.abs(ours - fit_shape_multiview.shapes.sphere(
        0.5, 8)[0].numpy()).max() > 1e-3  # the fit moved the vertices
    assert ((tmp_path / "resumed_final.obj").read_bytes()
            == (tmp_path / "straight_final.obj").read_bytes())
    assert straight["previews"][-1] == resumed["previews"][-1]


def test_a_checkpoint_saved_on_the_card_resumes_on_the_cpu(tmp_path):
    """The card saves Adam's state with capturable=True; resumed on the
    CPU (where Adam refuses that flag) the fit ends where a straight run
    ends, byte for byte."""
    _port(tmp_path, "resumed", 2, "fit.ckpt")
    state = torch.load(tmp_path / "fit.ckpt", weights_only=True)
    for group in state["opt_state"]["param_groups"]:
        group["capturable"] = True
    torch.save(state, tmp_path / "fit.ckpt")
    resumed = _port(tmp_path, "resumed", 3, "fit.ckpt")
    straight = _port(tmp_path, "straight", 3)
    assert [p["epoch"] for p in resumed["previews"]] == [2]
    assert ((tmp_path / "resumed_final.obj").read_bytes()
            == (tmp_path / "straight_final.obj").read_bytes())


def test_mesh_flag_parses_and_an_oversized_mesh_is_refused(tmp_path):
    """--mesh is ported (parallel.make_mesh over the devices of --device):
    the flag parses, and a mesh larger than the device list is refused as
    JAX's make_mesh refuses it (tests/test_torch_parallel.py runs the fit
    on a mesh)."""
    assert fit_shape_multiview.parse_args(["--mesh", "4,2"]).mesh == "4,2"
    with pytest.raises(ValueError, match="Mesh 4x2 needs 8 devices, have 1"):
        fit_shape_multiview.main(["--mesh", "4,2", "--device", "cpu",
                                  "--out-prefix", str(tmp_path / "fit")])
