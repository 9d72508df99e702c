"""PyTorch port: the host utilities against the JAX package's.

`obj_io.save_obj` (byte for byte the JAX package's file), `load_obj`
through the native parser and the Python parser (equal to each other and
to JAX's `native.parse_obj` / `load_obj`), `debug.debug_tensor` (the same
stdout) and `debug_warn_if`, the stdlib PNG writer (read back exactly by
the port's reader and by imageio) and `checkpoint` (a resumed run equals
a straight one bit for bit on the CPU). The inputs are made with numpy
from fixed seeds.
"""

import warnings

import imageio.v2 as imageio
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_mesh_renderer_tpu.utils import debug as jdebug
from pytorch_mesh_renderer_tpu.utils import native as jnative
from pytorch_mesh_renderer_tpu.utils import obj_io as jobj
from pytorch_mesh_renderer_tpu_torch import bench
from pytorch_mesh_renderer_tpu_torch.utils import (checkpoint, debug, native,
                                                   obj_io, test_utils)

from conftest import ASSETS_DIR

TEAPOT = f"{ASSETS_DIR}/teapot.obj"

# Quads (a face of four vertices: the fourth is dropped, with a warning),
# `f v//vn` records whose normals come before and after the faces, a
# vertex shared by faces with different normals and a vertex with none.
QUAD_OBJ = """\
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0.5 0.5 1
v 2 2 2
vn 0 0 1
vn 0 1 0
f 1//1 2//1 3//1 4//1
f 1//2 2//2 5//3
vn 1 0 0
f 3//1 4//2 5//3
f 6 1 2
"""
# No `vn` records: both parsers compute the normals.
PLAIN_OBJ = """\
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0.5
f 1 2 3
f 1 3 4
"""


def _mesh(seed=0, vertex_count=37, face_count=50):
    rng = np.random.RandomState(seed)
    vertices = rng.randn(vertex_count, 3).astype(np.float32)
    faces = rng.randint(0, vertex_count, (face_count, 3)).astype(np.int32)
    normals = rng.randn(vertex_count, 3).astype(np.float32)
    return vertices, faces, normals


@pytest.mark.parametrize("with_normals", [False, True])
@pytest.mark.parametrize("given", ["tensor", "numpy"])
def test_save_obj_writes_the_jax_packages_bytes(tmp_path, with_normals,
                                                given):
    vertices, faces, normals = _mesh()
    jax_path, port_path = tmp_path / "jax.obj", tmp_path / "port.obj"
    jobj.save_obj(str(jax_path), jnp.asarray(vertices), jnp.asarray(faces),
                  jnp.asarray(normals) if with_normals else None)
    convert = torch.from_numpy if given == "tensor" else np.asarray
    obj_io.save_obj(str(port_path), convert(vertices), convert(faces),
                    convert(normals) if with_normals else None)
    assert port_path.read_bytes() == jax_path.read_bytes()


def test_save_obj_refuses_wrong_shapes(tmp_path):
    vertices, faces, normals = _mesh()
    path = str(tmp_path / "bad.obj")
    with pytest.raises(ValueError, match="vertices"):
        obj_io.save_obj(path, vertices[:, :2], faces)
    with pytest.raises(ValueError, match="faces"):
        obj_io.save_obj(path, vertices, faces.ravel())
    with pytest.raises(ValueError, match="normals"):
        obj_io.save_obj(path, vertices, faces, normals[None])


@pytest.mark.parametrize("with_normals", [False, True])
def test_load_obj_reads_back_what_save_obj_wrote(tmp_path, with_normals):
    vertices, faces, normals = _mesh(seed=1)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    path = str(tmp_path / "mesh.obj")
    obj_io.save_obj(path, torch.from_numpy(vertices), torch.from_numpy(faces),
                    torch.from_numpy(normals) if with_normals else None)
    v, f, n = obj_io.load_obj(path, normalize=False)
    assert torch.equal(v, torch.from_numpy(vertices))
    assert torch.equal(f, torch.from_numpy(faces))
    if with_normals:
        np.testing.assert_allclose(n.numpy(), normals, rtol=0, atol=1e-6)


def _port_python_parser(monkeypatch, path, normalize=True):
    with monkeypatch.context() as patch:
        patch.setattr(native, "parse_obj", lambda _: None)
        return obj_io.load_obj(path, normalize=normalize)


@pytest.mark.parametrize("mesh", ["teapot", "quads", "plain"])
def test_native_and_python_parsers_agree_with_jax(tmp_path, monkeypatch,
                                                  mesh):
    if mesh == "teapot":
        path = TEAPOT
    else:
        path = str(tmp_path / f"{mesh}.obj")
        with open(path, "w") as f:
            f.write(QUAD_OBJ if mesh == "quads" else PLAIN_OBJ)
    assert native.load_library() is not None
    raw = native.parse_obj(path)
    jraw = jnative.parse_obj(path)
    with open(path) as f:
        by_lines = obj_io._parse_obj(f.readlines())
    for ours, theirs, python in zip(raw, jraw, by_lines):
        np.testing.assert_array_equal(ours, theirs)
        if ours is None:  # no vn records: the Python parser's are empty
            assert python.shape == (0, 3)
        else:
            np.testing.assert_array_equal(python, ours)
    for normalize in (True, False):
        by_native = obj_io.load_obj(path, normalize=normalize)
        by_python = _port_python_parser(monkeypatch, path, normalize)
        by_jax = jobj.load_obj(path, normalize=normalize)
        for ours, python, theirs in zip(by_native, by_python, by_jax):
            assert torch.equal(ours, python)
            np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


def test_load_obj_falls_back_to_the_python_parser(tmp_path, monkeypatch):
    """A failure of the native parser (here: it raises) leaves the Python
    parser to read the file, as in the JAX package."""
    def broken(_):
        raise IOError("native parser failed")

    monkeypatch.setattr(native, "parse_obj", broken)
    v, f, n = obj_io.load_obj(TEAPOT)
    jv, jf, jn = jobj.load_obj(TEAPOT)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))


@pytest.mark.parametrize("value", [
    np.arange(12, dtype=np.float32).reshape(3, 4) / 7.0,
    np.linspace(-1.0, 1.0, 500, dtype=np.float32).reshape(5, 100),
    np.array([[1, -2], [3, 4]], np.int32)])
def test_debug_tensor_prints_what_jax_prints(capsys, value):
    jdebug.debug_tensor(jnp.asarray(value), "weights")
    theirs = capsys.readouterr().out
    debug.debug_tensor(torch.from_numpy(value), "weights")
    assert capsys.readouterr().out == theirs
    assert theirs.startswith("[debug tensor] weights\n")


@pytest.mark.parametrize("bad,warns", [
    (torch.tensor([False, False]), False), (torch.tensor([False, True]), True),
    (torch.zeros(2, 3, dtype=torch.bool), False), (True, True),
    (np.array([0.0, 0.0]), False), (np.array([0.0, 2.0]), True)])
def test_debug_warn_if_warns_iff_any_element_is_true(bad, warns):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        debug.debug_warn_if(bad, "mesh too small")
    assert [str(w.message) for w in caught] == (
        ["[mesh_renderer debug] mesh too small"] if warns else [])
    assert all(w.category is RuntimeWarning for w in caught)


@pytest.mark.parametrize("channels", [None, 1, 3, 4])
def test_write_png_reads_back_exactly(tmp_path, channels):
    rng = np.random.RandomState(channels or 0)
    shape = (13, 17) if channels is None else (13, 17, channels)
    image = rng.randint(0, 256, shape).astype(np.uint8)
    path = str(tmp_path / "image.png")
    test_utils.write_png(path, image)
    ours = test_utils.read_png(path)
    theirs = imageio.imread(path)
    assert ours.shape == (13, 17, channels or 1)
    np.testing.assert_array_equal(ours.reshape(shape), image)
    np.testing.assert_array_equal(theirs.reshape(shape), image)


def test_write_png_refuses_what_it_cannot_write(tmp_path):
    path = str(tmp_path / "image.png")
    with pytest.raises(ValueError, match="uint8"):
        test_utils.write_png(path, np.zeros((4, 4, 3), np.float32))
    with pytest.raises(ValueError, match="pixels"):
        test_utils.write_png(path, np.zeros((4, 4, 5), np.uint8))


def _pose_run(steps, state_path=None, resume_from=None):
    """bench's pose fit at 16x16 on the CPU: Adam steps from angles 0 or
    from a checkpoint; saves one after the steps when `state_path` is
    given. Returns (losses, angles, optimizer state)."""
    loss_fn, batch, _ = bench.pose_problem(16, torch.device("cpu"))
    angles = torch.zeros(3, requires_grad=True)
    optimizer = torch.optim.Adam([angles], lr=5e-2)
    start = 0
    if resume_from:
        state = checkpoint.restore(
            resume_from, {"params": [angles],
                          "opt_state": optimizer.state_dict(), "step": 0})
        with torch.no_grad():
            angles.copy_(state["params"][0])
        optimizer.load_state_dict(state["opt_state"])
        start = state["step"]
    history = []
    for _ in range(steps):
        optimizer.zero_grad()
        loss = loss_fn([angles], batch)
        loss.backward()
        optimizer.step()
        history.append(loss.detach())
    if state_path:
        checkpoint.save(state_path, {"params": [angles.detach()],
                                     "opt_state": optimizer.state_dict(),
                                     "step": start + steps})
    return torch.stack(history), angles.detach(), optimizer.state_dict()


def test_checkpoint_round_trip(tmp_path):
    path = str(tmp_path / "state.pt")
    assert not checkpoint.exists(path)
    _, angles, opt_state = _pose_run(3, state_path=path)
    assert checkpoint.exists(path)
    fresh = torch.zeros(3, requires_grad=True)
    like = {"params": [fresh],
            "opt_state": torch.optim.Adam([fresh], lr=5e-2).state_dict(),
            "step": 0}
    state = checkpoint.restore(path, like)
    assert state["step"] == 3
    assert torch.equal(state["params"][0], angles)
    assert state["opt_state"]["param_groups"] == opt_state["param_groups"]
    for key in ("step", "exp_avg", "exp_avg_sq"):
        assert torch.equal(state["opt_state"]["state"][0][key],
                           opt_state["state"][0][key])


def test_checkpoint_resume_equals_a_straight_run_bit_for_bit(tmp_path):
    path = str(tmp_path / "state.pt")
    first, _, _ = _pose_run(3, state_path=path)
    second, resumed, _ = _pose_run(3, resume_from=path)
    straight, angles, _ = _pose_run(6)
    assert torch.equal(torch.cat([first, second]), straight)
    assert torch.equal(resumed, angles)
