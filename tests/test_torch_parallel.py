"""PyTorch port: device meshes and sharded rendering against the JAX
package (the twin of tests/test_parallel.py).

The port's meshes take an explicit device list that may repeat a device,
so a (data, space) mesh runs on the CPU over `cpu` repeated; JAX's run on
the conftest's 8 virtual CPU devices. The same numpy inputs go through
both: the port's sharded renders equal its unsharded renders bit for bit,
and JAX's sharded renders within JAX's own test tolerances (1e-5 hard,
1e-4 soft); gradients within rtol 1e-4 / atol 1e-6 (the silhouette's
2e-4 after scaling by max |grad|, as tests/test_parallel.py does).
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_mesh_renderer_tpu import parallel as jparallel
from pytorch_mesh_renderer_tpu_torch import parallel
from pytorch_mesh_renderer_tpu_torch.ops import camera, mesh as mesh_ops
from pytorch_mesh_renderer_tpu_torch.ops import rasterize as rasterize_ops
from pytorch_mesh_renderer_tpu_torch.ops import soft_rasterize
from pytorch_mesh_renderer_tpu_torch.utils import ranks

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _cpu_mesh(data, space):
    return parallel.make_mesh(data, space, devices=[CPU] * (data * space))


# tests/test_parallel.py's cube (16x16, batch 4) and sphere (16x16, batch
# 2) scenes, as numpy arrays; tests/test_torch_multiprocess.py's ranks
# render them too.
_cube_scene = ranks.cube_scene
_sphere_scene = ranks.sphere_scene


def _t(x, grad=False):
    return torch.tensor(np.asarray(x)).requires_grad_(grad)


def test_make_mesh_shapes_and_errors():
    mesh = _cpu_mesh(4, 2)
    assert mesh.shape == {"data": 4, "space": 2}
    assert mesh.axis_names == ("data", "space")
    assert mesh.devices.shape == (4, 2) and mesh.devices[3, 1] == CPU
    assert parallel.make_mesh(devices=["cpu"] * 8).shape == {"data": 8,
                                                            "space": 1}
    assert parallel.make_mesh(space=2, devices=[CPU] * 8).shape["data"] == 4
    single = parallel.single_device_mesh()
    assert single.shape == {"data": 1, "space": 1}
    assert single.devices[0, 0] == parallel.global_devices()[0]
    with pytest.raises(ValueError, match="not divisible by space=3"):
        parallel.make_mesh(space=3, devices=[CPU] * 8)
    with pytest.raises(ValueError, match="Mesh 4x1 needs 4 devices, have 1"):
        parallel.make_mesh(data=4, devices=[CPU])
    # The default list never repeats a device.
    default = parallel.global_devices()
    assert len(set(default)) == len(default)
    with pytest.raises(ValueError, match="needs"):
        parallel.make_mesh(data=len(default) + 1)


@pytest.mark.parametrize("data,space", [(4, 2), (2, 4), (8, 1)])
def test_sharded_rasterize_matches_unsharded_and_jax(data, space):
    verts, tris, attrs, cams = _cube_scene(batch=max(4, data))
    background = np.zeros([3], np.float32)
    mesh = _cpu_mesh(data, space)
    got = parallel.sharded_rasterize(mesh, _t(verts), _t(attrs), _t(tris),
                                     _t(cams), 16, 16, background)
    want = rasterize_ops.rasterize(_t(verts), _t(attrs), _t(tris), _t(cams),
                                   16, 16, background)
    assert torch.equal(got, want)
    jmesh = jparallel.make_mesh(data=data, space=space)
    theirs = jax.jit(lambda v, a, c: jparallel.sharded_rasterize(
        jmesh, v, a, tris, c, 16, 16, background))(verts, attrs, cams)
    np.testing.assert_allclose(got.numpy(), np.asarray(theirs), rtol=1e-5,
                               atol=1e-5)


def test_sharded_rasterize_gradients_match_unsharded_and_jax():
    verts, tris, attrs, cams = _cube_scene(batch=4)
    background = np.zeros([3], np.float32)
    mesh = _cpu_mesh(2, 4)

    def grad(render):
        v = _t(verts, grad=True)
        (render(v) ** 2).mean().backward()
        return v.grad.numpy()

    sharded = grad(lambda v: parallel.sharded_rasterize(
        mesh, v, _t(attrs), _t(tris), _t(cams), 16, 16, background))
    single = grad(lambda v: rasterize_ops.rasterize(
        v, _t(attrs), _t(tris), _t(cams), 16, 16, background))
    np.testing.assert_allclose(sharded, single, rtol=1e-4, atol=1e-6)
    jmesh = jparallel.make_mesh(data=2, space=4)
    theirs = jax.jit(jax.grad(lambda v: jnp.mean(jparallel.sharded_rasterize(
        jmesh, v, attrs, tris, cams, 16, 16, background) ** 2)))(verts)
    np.testing.assert_allclose(sharded, np.asarray(theirs), rtol=1e-4,
                               atol=1e-6)


def test_sharded_soft_rasterize_and_its_gradient_match():
    verts, tris, colors, lights, intensities, cams = _sphere_scene()
    mesh = _cpu_mesh(2, 4)
    jmesh = jparallel.make_mesh(data=2, space=4)
    from pytorch_mesh_renderer_tpu.ops import mesh as jmesh_ops

    def ours(render, v):
        normals = mesh_ops.compute_vertex_normals(v, _t(tris))
        return render(v, normals)

    sharded = lambda v, n: parallel.sharded_soft_rasterize(  # noqa: E731
        mesh, v, _t(tris), n, _t(colors), _t(lights), _t(intensities),
        _t(cams), 16, 16, 1e-4, 1e-4)
    single = lambda v, n: soft_rasterize.rasterize(  # noqa: E731
        v, _t(tris), n, _t(colors), _t(lights), _t(intensities), _t(cams),
        16, 16, 1e-4, 1e-4)
    got = ours(sharded, _t(verts))
    assert torch.equal(got, ours(single, _t(verts)))

    def jax_render(v):
        normals = jmesh_ops.compute_vertex_normals(v, tris)
        return jparallel.sharded_soft_rasterize(
            jmesh, v, tris, normals, colors, lights, intensities, cams, 16,
            16, 1e-4, 1e-4)

    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(jax.jit(jax_render)(verts)),
                               rtol=1e-4, atol=1e-5)
    grads = []
    for render in (sharded, single):
        v = _t(verts, grad=True)
        (ours(render, v)[..., 3] ** 2).mean().backward()
        grads.append(v.grad.numpy())
    np.testing.assert_allclose(grads[0], grads[1], rtol=1e-4, atol=1e-6)
    theirs = jax.jit(jax.grad(lambda v: jnp.mean(jax_render(v)[..., 3] ** 2)))(
        verts)
    np.testing.assert_allclose(grads[0], np.asarray(theirs), rtol=1e-4,
                               atol=1e-6)


def test_sharded_soft_silhouette_and_its_gradient_match():
    verts, tris, _, _, _, cams = _sphere_scene()
    mesh = _cpu_mesh(2, 4)
    jmesh = jparallel.make_mesh(data=2, space=4)
    sharded = lambda v: parallel.sharded_soft_silhouette(  # noqa: E731
        mesh, v, _t(tris), _t(cams), 16, 16, 1e-4)
    single = lambda v: (  # noqa: E731
        soft_rasterize.rasterize_silhouette_clip_space_batch(
            camera.transform_homogeneous(_t(cams), v), _t(tris), 16, 16,
            1e-4))
    got = sharded(_t(verts))
    assert torch.equal(got, single(_t(verts)))
    jax_alpha = lambda v: jparallel.sharded_soft_silhouette(  # noqa: E731
        jmesh, v, tris, cams, 16, 16, 1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax.jit(jax_alpha)(
        verts)), rtol=1e-4, atol=1e-5)
    grads = []
    for render in (sharded, single):
        v = _t(verts, grad=True)
        (render(v) ** 2).mean().backward()
        grads.append(v.grad.numpy())
    theirs = np.asarray(jax.jit(jax.grad(
        lambda v: jnp.mean(jax_alpha(v) ** 2)))(verts))
    scale = np.abs(grads[1]).max() + 1e-6
    for other in (grads[1], theirs):
        np.testing.assert_allclose(grads[0] / scale, other / scale,
                                   atol=2e-4)


def test_sharded_wrappers_check_their_inputs_and_place_the_batch():
    verts, tris, attrs, cams = _cube_scene(batch=4)
    mesh = _cpu_mesh(4, 2)
    with pytest.raises(ValueError, match="must divide over the space axis"):
        parallel.sharded_rasterize(mesh, _t(verts), _t(attrs), _t(tris),
                                   _t(cams), 16, 15, np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="must divide over the data axis"):
        parallel.sharded_soft_silhouette(_cpu_mesh(8, 1), _t(verts),
                                         _t(tris), _t(cams), 16, 16, 1e-4)
    batch = parallel.shard_batch(mesh, {"v": verts, "c": _t(cams)})
    assert torch.is_tensor(batch["v"]) and batch["v"].device == CPU
    with pytest.raises(ValueError, match="does not divide over the data"):
        parallel.shard_batch(mesh, {"v": verts[:3]})
    param = torch.zeros(3, requires_grad=True)
    assert parallel.replicate(mesh, {"p": param})["p"] is param


def test_train_loop_through_a_wrapper_equals_its_steps():
    """K steps of make_train_loop equal K calls of make_train_step, each
    rendering through sharded_rasterize (tests/test_parallel.py's
    test_spmd_train_loop_matches_steps)."""
    verts, tris, attrs, cams = _cube_scene(batch=4)
    background = np.zeros([3], np.float32)
    mesh = _cpu_mesh(4, 2)
    target = rasterize_ops.rasterize(_t(verts), _t(attrs), _t(tris),
                                     _t(cams), 16, 16, background)
    batch = parallel.shard_batch(mesh, {"verts": _t(verts), "cams": _t(cams),
                                        "target": target})

    def loss_fn(params, batch):
        img = parallel.sharded_rasterize(
            mesh, batch["verts"] + params[0], _t(attrs), _t(tris),
            batch["cams"], 16, 16, background)
        return torch.mean(torch.abs(img - batch["target"]))

    def fresh():
        (offset,) = parallel.replicate(
            mesh, [torch.full([1, 1, 3], 0.05, requires_grad=True)])
        return offset, torch.optim.Adam([offset], lr=5e-3)

    offset_a, opt_a = fresh()
    step = parallel.make_train_step(loss_fn, opt_a)
    step_losses = torch.stack([step(batch) for _ in range(5)])
    offset_b, opt_b = fresh()
    losses = parallel.make_train_loop(loss_fn, opt_b, 5)(batch)
    assert torch.equal(losses, step_losses)
    assert torch.equal(offset_a, offset_b)
    assert float(losses[-1]) < float(losses[0])


class _FakeDevice:
    """Stand-in with the attributes order_devices_for_dcn reads."""

    def __init__(self, process_index, dev_id):
        self.process_index = process_index
        self.id = dev_id


def test_device_order_keeps_space_within_a_process():
    devs = [_FakeDevice(p, i) for p in (1, 0) for i in (3, 1, 2, 0)]
    ordered = parallel.order_devices_for_dcn(devs, space=2)
    assert [(d.process_index, d.id) for d in ordered] == [
        (0, 0), (0, 1), (0, 2), (0, 3), (1, 0), (1, 1), (1, 2), (1, 3)]
    theirs = jparallel.order_devices_for_dcn(devs, space=2)
    assert [(d.process_index, d.id) for d in theirs] == [
        (d.process_index, d.id) for d in ordered]
    grid = np.asarray(ordered, dtype=object).reshape(4, 2)
    for row in grid:
        assert len({d.process_index for d in row}) == 1
    spanning = [_FakeDevice(0, 0), _FakeDevice(0, 1), _FakeDevice(0, 2),
                _FakeDevice(1, 0), _FakeDevice(1, 1), _FakeDevice(1, 2)]
    with pytest.raises(ValueError, match="space group would span DCN"):
        parallel.order_devices_for_dcn(spanning, space=4)


def test_multihost_mesh_from_an_explicit_subset():
    devs = [parallel.ProcessDevice(0, i, CPU) for i in range(4)]
    mesh = parallel.make_multihost_mesh(space=2, devices=devs)
    assert mesh.shape == {"data": 2, "space": 2}
    assert list(mesh.axis_names) == ["data", "space"]
    assert set(np.asarray(mesh.devices).ravel()) == set(devs)
    verts, tris, _, _, _, cams = _sphere_scene()
    got = parallel.sharded_soft_silhouette(mesh, _t(verts), _t(tris),
                                           _t(cams), 16, 16, 1e-4)
    want = parallel.sharded_soft_silhouette(_cpu_mesh(2, 2), _t(verts),
                                            _t(tris), _t(cams), 16, 16, 1e-4)
    assert torch.equal(got, want)


def test_a_mesh_with_another_process_device_raises():
    """Without a process group, a mesh entry of rank 1 names no live
    process: the wrappers, shard_batch and replicate raise ValueError
    (tests/test_torch_multiprocess.py runs such meshes over a group)."""
    verts, tris, _, _, _, cams = _sphere_scene()
    devs = [parallel.ProcessDevice(0, 0, CPU), parallel.ProcessDevice(1, 1,
                                                                      CPU)]
    mesh = parallel.make_multihost_mesh(space=1, devices=devs)
    with pytest.raises(ValueError, match="no process group"):
        parallel.sharded_soft_silhouette(mesh, _t(verts), _t(tris), _t(cams),
                                         16, 16, 1e-4)
    for place in (parallel.shard_batch, parallel.replicate):
        with pytest.raises(ValueError, match="a device of rank 1"):
            place(mesh, {"v": _t(verts)})


def test_init_distributed_in_one_process():
    """gloo, world 1, called twice; the global list is this process's
    devices, and a multihost mesh spans it. The coordinator takes a port
    that the system reports free, so that runs at the same time do not
    meet on one."""
    with socket.socket() as probe:
        probe.bind(("localhost", 0))
        port = probe.getsockname()[1]
    code = (
        "import torch\n"
        "from pytorch_mesh_renderer_tpu_torch import parallel\n"
        "for _ in range(2):\n"
        f"    parallel.init_distributed(coordinator_address='localhost:{port}',"
        " num_processes=1, process_id=0)\n"
        "assert torch.distributed.get_backend() == 'gloo'\n"
        "assert torch.distributed.get_world_size() == 1\n"
        "devs = parallel.global_devices()\n"
        "assert devs == [parallel.ProcessDevice(0, 0, torch.device('cpu'))]\n"
        "mesh = parallel.make_multihost_mesh(space=1)\n"
        "assert mesh.shape == {'data': 1, 'space': 1}, mesh.shape\n"
        "torch.distributed.destroy_process_group()\n"
        "print('DIST_OK')\n")
    env = dict(os.environ, PYTHONPATH=REPO_ROOT, CUDA_VISIBLE_DEVICES="")
    result = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                            env=env, capture_output=True, text=True,
                            timeout=120)
    assert result.returncode == 0, result.stdout + result.stderr
    assert "DIST_OK" in result.stdout


def test_fit_with_a_mesh_equals_the_unsharded_fit(tmp_path):
    from pytorch_mesh_renderer_tpu_torch.examples import fit_shape_multiview

    argv = ["--device", "cpu", "--size", "16", "--resolution", "8",
            "--epochs", "3", "--preview-every", "2", "--out-prefix",
            str(tmp_path / "fit")]
    single = fit_shape_multiview.main(argv)
    sharded = fit_shape_multiview.main(argv, mesh=_cpu_mesh(2, 2))
    np.testing.assert_allclose(sharded["losses"], single["losses"],
                               rtol=1e-4)
    scale = np.abs(single["vertices"]).max()
    assert np.abs(sharded["vertices"] - single["vertices"]).max() <= (
        1e-4 * scale)
    with pytest.raises(ValueError, match="needs 4 devices"):
        fit_shape_multiview.main(argv + ["--mesh", "2,2"])
