"""The bench scenes: the teapot headline and the sphere72 stress mesh.

Port of `bench.py:187-234` (`load_mesh`, `build_scene`): the same mesh,
the same batch of rotations about y (0 to 1 radian), eye, centre, up,
lights, intensities and diffuse colour, with the triangles reversed to the
CW winding the hard renderer wants. The rotation is the port's
`camera.euler_matrices`, applied in numpy f32; the tensors are returned on
the device the caller names.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..models import shapes
from ..ops import camera
from . import obj_io
from .convert import scene_to_torch

TEAPOT_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "assets", "teapot.obj")


def load_mesh(sphere_resolution=None):
    """(vertices [V, 3], triangles [T, 3] CCW, normals [V, 3], name): the
    repository's teapot, or a UV sphere of radius 1 at `sphere_resolution`
    (72 gives the 10,368-triangle stress mesh)."""
    if sphere_resolution:
        v, t, n = shapes.sphere(1.0, resolution=sphere_resolution)
        return (v.numpy(), t.numpy(), n.numpy(),
                f"sphere{sphere_resolution} ({t.shape[0]} tris)")
    v, t, n = obj_io.load_obj(TEAPOT_PATH)
    return v.numpy(), t.numpy(), n.numpy(), "teapot"


def build_scene(batch, device, sphere_resolution=None):
    """bench.build_scene's scene as tensors on `device`.

    Returns a dict with the `convert.SCENE_KEYS` tensors (vertices and
    normals [B, V, 3], triangles [T, 3] int32 in CW winding, diffuse
    [B, V, 3], eye / center / up [B, 3], lights [B, 2, 3], intensities
    [B, 2, 3]) and `mesh_name`, `tri_count`.
    """
    v, t, n, mesh_name = load_mesh(sphere_resolution)
    rot = camera.euler_matrices(torch.stack([
        torch.zeros(batch), torch.linspace(0.0, 1.0, batch),
        torch.zeros(batch)], dim=-1))[:, :3, :3].numpy()
    vertices = np.einsum("bij,vj->bvi", rot, v)
    return scene_to_torch(dict(
        vertices=vertices,
        triangles=t[:, ::-1],  # the hard renderer wants CW
        normals=np.einsum("bij,vj->bvi", rot, n),
        diffuse=np.broadcast_to(np.array([0.8, 0.6, 0.4]), vertices.shape),
        eye=np.tile([[0.0, 1.0, 4.0]], [batch, 1]),
        center=np.zeros([batch, 3]),
        up=np.tile([[0.0, 1.0, 0.0]], [batch, 1]),
        lights=np.tile([[[-2.0, 2.0, 4.0], [3.0, -1.0, 4.0]]],
                       [batch, 1, 1]),
        intensities=np.ones([batch, 2, 3]),
        mesh_name=mesh_name, tri_count=int(t.shape[0])), device)


def clip_vertices(scene, size):
    """[B, V, 4] clip-space vertices of `scene` at a square `size` image,
    with bench.py's camera: fov 40, near 0.01, far 10."""
    ones = torch.ones(scene["eye"].shape[0], dtype=torch.float32,
                      device=scene["eye"].device)
    cams = camera.clip_space_transforms(
        scene["eye"], scene["center"], scene["up"], 40.0 * ones, 0.01 * ones,
        10.0 * ones, size, size)
    return camera.transform_homogeneous(cams, scene["vertices"])
