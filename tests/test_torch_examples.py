"""PyTorch port: the example CLIs against the JAX package's, on the CPU.

Each port CLI's `main([..., "--device", "cpu"])` runs beside the JAX
example's `main()` (examples/, argv patched) with the same arguments, every
output in `tmp_path`. Compared:

  * the renders: the PNGs each writes, within 1 uint8 level;
  * the optimizations: every step's loss (the JAX example hands its full
    list to `common.save_loss_plot`) within 1e-4 relative, and the final
    parameters (the JAX step's last output, recorded by wrapping
    `jax.jit`) within 1e-4 relative plus 5e-5, half the last digit of the
    four decimals the CLIs print them with: the soft cube's angles after 3
    steps differ by 2e-5 (3e-4 relative), the soft gradients' agreement
    (1e-4 of their largest component, tests/test_torch_soft_renderer.py)
    carried through the clip to unit norm and three steps of 0.7.

The cube rotation starts at angles 0, where the cube's front face is
split by a diagonal that runs exactly through pixel centres. There the
JAX package on the CPU and the port pick different triangles: XLA fuses
the edge function's multiply-add (an FMA), which moves the edge value at
those pixels 4e-7 off 0, while the port (its plain versions, and its
kernels built with --fmad=false) evaluates it exactly as 0, so both
triangles cover the pixel and the depth tie goes to the larger id. The
two tests after the CLI comparisons pin that difference; the cube CLI
comparison runs on a cube turned by a fixed small rotation, in both
packages, so that no edge passes through a pixel centre.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_mesh_renderer_tpu import parallel as jparallel
from pytorch_mesh_renderer_tpu.models import mesh_renderer as jmr
from pytorch_mesh_renderer_tpu.models import shapes as jshapes
from pytorch_mesh_renderer_tpu.models import soft_mesh_renderer as jsoft
from pytorch_mesh_renderer_tpu.ops import camera as jcamera
from pytorch_mesh_renderer_tpu.ops import rasterize as jrasterize
from pytorch_mesh_renderer_tpu.ops.barycentric import (
    unnormalized_matrix_inverse)
from pytorch_mesh_renderer_tpu_torch.examples import (
    optimize_camera_pose, optimize_cube_rotation, optimize_teapot_rotation,
    render_teapot_hard, render_teapot_soft)
from pytorch_mesh_renderer_tpu_torch.models import shapes
from pytorch_mesh_renderer_tpu_torch.ops import rasterize
from pytorch_mesh_renderer_tpu_torch.utils import test_utils

from conftest import ASSETS_DIR

sys.path.insert(0, f"{ASSETS_DIR}/../examples")
import common as jcommon  # noqa: E402  (examples/common.py)

RTOL = 1e-4
PRINTED_ATOL = 5e-5  # half of the printed parameters' last decimal


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes on one machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


class _RecordingJax:
    """The `jax` module, whose `jit` keeps each jitted function's last
    output under the function's name."""

    def __init__(self):
        self.outputs = {}

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn, **kwargs):
        compiled = jax.jit(fn, **kwargs)

        def call(*args):
            out = compiled(*args)
            self.outputs[fn.__name__] = out
            return out

        return call


def _run_jax_example(monkeypatch, name, argv):
    """Runs examples/<name>.py's main() with `argv`; returns (the losses
    it plotted, the recording jax)."""
    module = __import__(name)
    recording = _RecordingJax()
    plotted = {}
    with monkeypatch.context() as patch:
        patch.setattr(module, "jax", recording)
        patch.setattr(jcommon, "save_loss_plot",
                      lambda path, losses: plotted.update(losses=losses))
        patch.setattr(sys, "argv", [name] + argv)
        module.main()
    return plotted.get("losses"), recording


def _outputs(tmp_path, tag):
    return ["--out-video", str(tmp_path / f"{tag}.mp4"),
            "--out-plot", str(tmp_path / f"{tag}_loss.png")]


@pytest.mark.parametrize("name,module,argv", [
    ("render_teapot_hard", render_teapot_hard,
     ["--width", "64", "--height", "48"]),
    ("render_teapot_soft", render_teapot_soft, ["--size", "32"])])
def test_render_pngs_match_jax(tmp_path, monkeypatch, name, module, argv):
    jax_png, port_png = tmp_path / "jax.png", tmp_path / "port.png"
    _run_jax_example(monkeypatch, name, argv + ["--out", str(jax_png)])
    module.main(argv + ["--out", str(port_png), "--device", "cpu"])
    theirs = test_utils.read_png(str(jax_png)).astype(np.int16)
    ours = test_utils.read_png(str(port_png)).astype(np.int16)
    assert ours.shape == theirs.shape
    assert np.abs(ours - theirs).max() <= 1
    assert (ours[..., 3] > 0).mean() > 0.05  # the teapot is in view


def _turn(vertices, normals):
    """A fixed rotation, so that no cube edge crosses a pixel centre."""
    c, s = np.cos(0.1), np.sin(0.1)
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]]) @ np.array(
        [[1, 0, 0], [0, c, -s], [0, s, c]])
    rot = rot.astype(np.float32)
    return vertices @ rot.T, normals @ rot.T


@pytest.mark.parametrize("soft", [False, True])
def test_cube_rotation_matches_jax(tmp_path, monkeypatch, soft):
    v, t, n = (np.asarray(x) for x in shapes.cube(2.0))
    v, n = _turn(v, n)
    monkeypatch.setattr(jshapes, "cube", lambda size: (
        jnp.asarray(v), jnp.asarray(t), jnp.asarray(n)))
    monkeypatch.setattr(shapes, "cube", lambda size: (
        torch.from_numpy(v), torch.from_numpy(t), torch.from_numpy(n)))
    argv = ["--size", "32", "--steps", "3"] + ["--soft"] * soft
    losses, recording = _run_jax_example(
        monkeypatch, "optimize_cube_rotation", argv + _outputs(tmp_path, "j"))
    ours = optimize_cube_rotation.main(
        argv + _outputs(tmp_path, "p") + ["--device", "cpu"])
    np.testing.assert_allclose(ours["losses"], losses, rtol=RTOL)
    np.testing.assert_allclose(
        ours["angles"], np.asarray(recording.outputs["step"][0]), rtol=RTOL,
        atol=PRINTED_ATOL)


def test_teapot_rotation_scan_chunks_match_jax(tmp_path, monkeypatch):
    """--scan-chunk 2 over 3 steps: a loop of 2 steps, then one of 1."""
    final = {}
    make_loop = jparallel.make_train_loop

    def recording_loop(*args, **kwargs):
        loop = make_loop(*args, **kwargs)

        def call(*loop_args):
            out = loop(*loop_args)
            final["angles"] = np.asarray(out[0])
            return out

        return call

    monkeypatch.setattr(jparallel, "make_train_loop", recording_loop)
    argv = ["--size", "32", "--steps", "3", "--scan-chunk", "2"]
    losses, _ = _run_jax_example(monkeypatch, "optimize_teapot_rotation",
                                 argv + _outputs(tmp_path, "j"))
    ours = optimize_teapot_rotation.main(
        argv + _outputs(tmp_path, "p") + ["--device", "cpu"])
    assert len(losses) == 3
    np.testing.assert_allclose(ours["losses"], losses, rtol=RTOL)
    np.testing.assert_allclose(ours["angles"], final["angles"], rtol=RTOL,
                               atol=PRINTED_ATOL)


def test_camera_pose_matches_jax(tmp_path, monkeypatch):
    argv = ["--width", "64", "--height", "48", "--steps", "3"]
    losses, recording = _run_jax_example(
        monkeypatch, "optimize_camera_pose", argv + _outputs(tmp_path, "j"))
    ours = optimize_camera_pose.main(
        argv + _outputs(tmp_path, "p") + ["--device", "cpu"])
    params = recording.outputs["step"][0]
    np.testing.assert_allclose(ours["losses"], losses, rtol=RTOL)
    np.testing.assert_allclose(ours["eye"], np.asarray(params["eye"]),
                               rtol=RTOL, atol=PRINTED_ATOL)
    np.testing.assert_allclose(ours["angles"], np.asarray(params["angles"]),
                               rtol=RTOL, atol=PRINTED_ATOL)


# The cube at angles 0 from the CLI's camera, at 32x32: the pixels whose
# centres lie on the front face's diagonal (rows r + columns c = 31 of the
# rendered image, which is flipped vertically against the rasterizer's).
SIZE = 32
DIAGONAL = np.eye(SIZE, dtype=bool)[::-1]


@pytest.mark.parametrize("soft", [False, True])
def test_cube_at_angles_zero_differs_from_jax_only_on_the_diagonal(soft):
    """The angle gradient of a seeded weighted sum of the render: off the
    diagonal pixels the port's equals the JAX package's within 1e-4 of its
    largest component; on them the XLA FMA moves JAX's (see the module
    docstring)."""
    verts, tris, normals = (np.asarray(x) for x in jshapes.cube(2.0))
    if not soft:
        tris = np.ascontiguousarray(tris[:, ::-1])
    colors = np.asarray(optimize_cube_rotation.COLORS, np.float32)[None]
    eye = np.float32([[0.0, 0.0, 6.0]])
    center, up = np.zeros([1, 3], np.float32), np.float32([[0.0, 1.0, 0.0]])

    def jax_render(angles):
        rot = jcamera.euler_matrices(angles[None])[0, :3, :3]
        v = (verts @ rot.T)[None]
        if soft:
            return jsoft.render(v, tris, colors, eye, center, up,
                                eye[:, None, :], jnp.ones([1, 1]), SIZE,
                                SIZE)[0]
        return jmr.render(v, tris, (normals @ rot.T)[None], colors, eye,
                          center, up, eye[:, None, :], jnp.ones([1, 1, 3]),
                          SIZE, SIZE)[0]

    weights = np.random.RandomState(0).randn(SIZE, SIZE, 4).astype(
        np.float32)
    port_render = optimize_cube_rotation.make_render(soft, SIZE,
                                                     torch.device("cpu"))
    angles = torch.zeros(3, requires_grad=True)
    image = port_render(angles)
    _, vjp = jax.vjp(jax_render, jnp.zeros(3))

    def both(mask):
        cotangent = weights * mask[..., None]
        (ours,) = torch.autograd.grad(image, angles,
                                      torch.from_numpy(cotangent),
                                      retain_graph=True)
        return ours.numpy(), np.asarray(vjp(jnp.asarray(cotangent))[0])

    ours, theirs = both(~DIAGONAL)
    np.testing.assert_allclose(ours, theirs, rtol=0,
                               atol=RTOL * np.abs(theirs).max())
    ours, theirs = both(DIAGONAL)
    assert np.abs(ours - theirs).max() > 0.1 * np.abs(theirs).max()


def test_cube_diagonal_edge_values_are_exact_zeros_without_fma():
    """At the diagonal's pixel centres both front triangles' edge value is
    exactly 0 in f32 arithmetic without fused multiply-adds: both cover
    the pixel at the same depth and the port gives it to the larger id
    (11), with that corner's barycentric exactly 0. The JAX package on the
    CPU gives it to 10, with the barycentric that one FMA in the edge
    function gives."""
    verts, tris, _ = (np.asarray(x) for x in jshapes.cube(2.0))
    tris = np.ascontiguousarray(tris[:, ::-1])
    clip = np.asarray(jcamera.transform_homogeneous(
        jcamera.clip_space_transforms(
            np.float32([[0.0, 0.0, 6.0]]), np.zeros([1, 3], np.float32),
            np.float32([[0.0, 1.0, 0.0]]), np.float32([40.0]),
            np.float32([0.01]), np.float32([10.0]), SIZE, SIZE),
        verts[None]))[0]
    ids, bc, _ = rasterize.rasterize_barycentric(
        torch.from_numpy(clip.copy()), torch.from_numpy(tris), SIZE, SIZE)
    jids, jbc, _ = (np.asarray(x) for x in jrasterize.rasterize_barycentric(
        clip, tris, SIZE, SIZE))
    ids, bc = ids.numpy(), bc.numpy()
    differ = np.argwhere(ids != jids)
    assert len(differ) > 0
    assert all(r == c for r, c in differ)  # the rasterizer's diagonal
    np.testing.assert_array_equal(ids[ids != jids], 11)
    np.testing.assert_array_equal(jids[ids != jids], 10)

    corners = clip[tris[[10, 11]]]  # [2, 3, 4]
    m_inv, _ = unnormalized_matrix_inverse(
        corners[..., 0], corners[..., 1], corners[..., 3])
    m_inv = np.asarray(m_inv)
    for r, _ in differ:
        p = np.float32((r + 0.5) / (SIZE / 2) - 1.0)  # px = py here
        a, b, c = m_inv[..., 0], m_inv[..., 1], m_inv[..., 2]
        plain = a * p + b * p + c  # f32, each product rounded
        fused = (a.astype(np.float64) * p
                 + (b * p + c).astype(np.float64)).astype(np.float32)
        assert (plain[:, 1] == 0.0).all()
        assert bc[r, r, 1] == 0.0
        assert fused[0, 1] > 0.0 > fused[1, 1]  # only 10 covers it
        np.testing.assert_allclose(jbc[r, r], fused[0] / fused[0].sum(),
                                   rtol=1e-6)
