"""PyTorch port: scene math, mesh ops, shapes and OBJ loading vs the JAX
package and the vendored reference oracles.

The same numpy inputs (fixed seeds) go through each JAX function and its
port. Port vs JAX: rtol 1e-6 / atol 1e-6 (both fp32; the JAX camera
matmuls run at HIGHEST precision, the port's as ordered fp32 sums).
Port vs oracle: the JAX suite's own tolerances for the same oracle.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pytorch_mesh_renderer_tpu.models import shapes as jshapes
from pytorch_mesh_renderer_tpu.ops import barycentric as jbary
from pytorch_mesh_renderer_tpu.ops import camera as jcam
from pytorch_mesh_renderer_tpu.ops import math_utils as jmath
from pytorch_mesh_renderer_tpu.ops import mesh as jmesh
from pytorch_mesh_renderer_tpu.utils import obj_io as jobj
from pytorch_mesh_renderer_tpu_torch.models import shapes
from pytorch_mesh_renderer_tpu_torch.ops import barycentric, camera, mesh
from pytorch_mesh_renderer_tpu_torch.ops import math_utils
from pytorch_mesh_renderer_tpu_torch.utils import obj_io

from conftest import ASSETS_DIR, ORACLE_DIR

TOL = dict(rtol=1e-6, atol=1e-6)


def _oracle(name):
    # Read the vendored snapshot directly: conftest.oracle_snapshot would
    # rewrite it from a live reference checkout.
    with np.load(os.path.join(ORACLE_DIR, name + ".npz")) as data:
        return {k: data[k] for k in data.files}


def _t(array):
    return torch.from_numpy(np.array(array))


def _camera_inputs():
    """The inputs of tests/test_camera.py's oracle test (same seed)."""
    rng = np.random.RandomState(0)
    return dict(
        angles=rng.uniform(-np.pi, np.pi, size=[4, 3]).astype(np.float32),
        eye=rng.uniform(2, 4, size=[3, 3]).astype(np.float32),
        center=rng.uniform(-0.5, 0.5, size=[3, 3]).astype(np.float32),
        up=np.tile(np.array([[0.0, 1.0, 0.0]], np.float32), [3, 1]),
        fov=np.array([30.0, 40.0, 70.0], np.float32),
        near=np.array([0.01, 0.1, 1.0], np.float32),
        far=np.array([10.0, 20.0, 5.0], np.float32),
        mats=rng.uniform(-1, 1, size=[3, 4, 4]).astype(np.float32),
        verts=rng.uniform(-1, 1, size=[3, 17, 3]).astype(np.float32))


def _camera_port_and_jax(i):
    """(port result, JAX result) for each camera op, by name."""
    return {
        "euler": (camera.euler_matrices(_t(i["angles"])),
                  jcam.euler_matrices(jnp.asarray(i["angles"]))),
        "look_at": (camera.look_at(_t(i["eye"]), _t(i["center"]),
                                   _t(i["up"])),
                    jcam.look_at(i["eye"], i["center"], i["up"])),
        "perspective": (camera.perspective(640 / 480, _t(i["fov"]),
                                           _t(i["near"]), _t(i["far"])),
                        jcam.perspective(640 / 480, jnp.asarray(i["fov"]),
                                         jnp.asarray(i["near"]),
                                         jnp.asarray(i["far"]))),
        "transform": (camera.transform_homogeneous(_t(i["mats"]),
                                                   _t(i["verts"])),
                      jcam.transform_homogeneous(jnp.asarray(i["mats"]),
                                                 jnp.asarray(i["verts"]))),
        "clip_space": (camera.clip_space_transforms(
            _t(i["eye"]), _t(i["center"]), _t(i["up"]), _t(i["fov"]),
            _t(i["near"]), _t(i["far"]), 640, 480),
            jcam.clip_space_transforms(
                i["eye"], i["center"], i["up"], jnp.asarray(i["fov"]),
                jnp.asarray(i["near"]), jnp.asarray(i["far"]), 640, 480)),
    }


@pytest.mark.parametrize("op", ["euler", "look_at", "perspective",
                                "transform", "clip_space"])
def test_camera_matches_jax(op):
    ours, theirs = _camera_port_and_jax(_camera_inputs())[op]
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **TOL)


def test_camera_matches_reference_oracle():
    results = _camera_port_and_jax(_camera_inputs())
    ref = _oracle("camera_stack")
    for name in ("euler", "look_at", "perspective", "transform"):
        np.testing.assert_allclose(results[name][0].numpy(), ref[name],
                                   atol=1e-5, err_msg=name)


def test_look_at_degenerate_raises():
    with pytest.raises(AssertionError, match="eye and center"):
        camera.look_at(torch.zeros(1, 3), torch.zeros(1, 3),
                       torch.tensor([[0.0, 1.0, 0.0]]))
    with pytest.raises(AssertionError, match="up and gaze"):
        camera.look_at(torch.tensor([[0.0, 0.0, 1.0]]), torch.zeros(1, 3),
                       torch.tensor([[0.0, 0.0, 2.0]]))


def test_transform_homogeneous_validates_rank():
    with pytest.raises(ValueError):
        camera.transform_homogeneous(torch.eye(4), torch.zeros(1, 3, 3))
    with pytest.raises(ValueError):
        camera.transform_homogeneous(torch.eye(4)[None], torch.zeros(3, 3))


def test_math_and_barycentric_match_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(5, 7, 3).astype(np.float32)
    np.testing.assert_allclose(math_utils.normalize(_t(x)).numpy(),
                               np.asarray(jmath.normalize(jnp.asarray(x))),
                               **TOL)
    np.testing.assert_allclose(
        math_utils.dot_last(_t(x), _t(x[::-1])).numpy(),
        np.asarray(jmath.dot_last(jnp.asarray(x), jnp.asarray(x[::-1]))),
        **TOL)
    xyw = [rng.randn(11, 3).astype(np.float32) for _ in range(3)]
    m_inv, det = barycentric.unnormalized_matrix_inverse(
        *[_t(a) for a in xyw])
    jm_inv, jdet = jbary.unnormalized_matrix_inverse(
        *[jnp.asarray(a) for a in xyw])
    np.testing.assert_array_equal(m_inv.numpy(), np.asarray(jm_inv))
    np.testing.assert_array_equal(det.numpy(), np.asarray(jdet))
    e = [rng.choice([-1.0, 0.0, 1.0], size=64).astype(np.float32)
         for _ in range(3)]
    np.testing.assert_array_equal(
        barycentric.pixel_is_inside(*[_t(a) for a in e]).numpy(),
        np.asarray(jbary.pixel_is_inside(*[jnp.asarray(a) for a in e])))
    for ours, theirs in zip(barycentric.ndc_pixel_centers(13, 7),
                            jbary.ndc_pixel_centers(13, 7)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **TOL)


def test_vertex_normals_match_jax_and_oracle():
    rng = np.random.RandomState(1)  # tests/test_mesh_ops.py's inputs
    verts = rng.uniform(-1, 1, size=[2, 30, 3]).astype(np.float32)
    tris = rng.randint(0, 30, size=[40, 3]).astype(np.int32)
    ours = mesh.compute_vertex_normals(_t(verts), _t(tris)).numpy()
    theirs = np.asarray(jmesh.compute_vertex_normals(jnp.asarray(verts),
                                                     jnp.asarray(tris)))
    np.testing.assert_allclose(ours, theirs, **TOL)
    np.testing.assert_allclose(ours, _oracle("vertex_normals_random")[
        "normals"], atol=1e-5)


@pytest.mark.parametrize("shape", ["sphere3", "sphere7", "cube"])
def test_shapes_match_jax_and_oracle(shape):
    if shape == "cube":
        ours, theirs = shapes.cube(2.0), jshapes.cube(2.0)
    else:
        res = int(shape[len("sphere"):])
        ours = shapes.sphere(1.5, resolution=res)
        theirs = jshapes.sphere(1.5, resolution=res)
    ref = _oracle("shapes")
    assert ours[1].dtype == torch.int32
    for o, t, part in zip(ours, theirs, "vtn"):
        key = f"{shape}_{part}"
        if part == "t":
            np.testing.assert_array_equal(o.numpy(), np.asarray(t))
            np.testing.assert_array_equal(o.numpy(), ref[key])
        else:
            np.testing.assert_allclose(o.numpy(), np.asarray(t), **TOL)
            np.testing.assert_allclose(o.numpy(), ref[key], atol=1e-6)


def test_load_teapot_matches_jax_and_oracle():
    path = os.path.join(ASSETS_DIR, "teapot.obj")
    v, f, n = obj_io.load_obj(path)
    jv, jf, jn = jobj.load_obj(path)
    assert (v.shape, f.shape, f.dtype) == ((1292, 3), (2464, 3), torch.int32)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), **TOL)
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    np.testing.assert_allclose(n.numpy(), np.asarray(jn), **TOL)
    ref = _oracle("teapot_load")
    np.testing.assert_allclose(v.numpy(), ref["v"], atol=1e-5)
    np.testing.assert_array_equal(f.numpy(), ref["f"])
    np.testing.assert_allclose(n.numpy(), ref["n"], atol=1e-4)


def test_load_obj_without_normals_matches_jax(tmp_path):
    path = tmp_path / "tet.obj"
    path.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nv 0 0 1\n"
                    "f 1 3 2\nf 1 2 4\nf 1 4 3\nf 2 3 4\n")
    for ours, theirs in zip(obj_io.load_obj(str(path), normalize=False),
                            jobj.load_obj(str(path), normalize=False)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **TOL)
