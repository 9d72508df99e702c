"""Procedural meshes (uv-sphere, icosphere, cube).

Port of `pytorch_mesh_renderer_tpu/models/shapes.py`, plus the closed
icosphere that the reconstruction network deforms (`examples/recon.py`),
which the JAX package does not have. Geometry is built on the host in
numpy and returned as CPU tensors (f32 positions and normals, int32
triangles); the sphere and cube have the same vertex order, indexing and
CCW winding as the JAX package. Move them with `.to(device)`.
"""

from __future__ import annotations

import numpy as np
import torch


def _as_tensors(vertices, triangles, normals):
    return (torch.from_numpy(np.asarray(vertices, np.float32)),
            torch.from_numpy(np.asarray(triangles, np.int32)),
            torch.from_numpy(np.asarray(normals, np.float32)))


def sphere(radius: float, resolution: int = 25):
    """UV-sphere with K=resolution latitude/longitude subdivisions.

    Returns:
      (vertices [K^2+2, 3] f32, triangles [2K(K-1)+2K, 3] int32,
       normals [K^2+2, 3] f32), CCW winding viewed from outside. The column
      index does not wrap at the phi seam (`j + 1`), as in the JAX package.
    """
    K = resolution
    theta_step = np.pi / (K + 1)
    num_vertices = K ** 2 + 2
    num_triangles = 2 * (K - 1) * K + 2 * K

    thetas = np.linspace(theta_step, np.pi - theta_step, K, endpoint=True)
    phis = np.linspace(0.0, 2.0 * np.pi, K, endpoint=False)
    tt, pp = np.meshgrid(thetas, phis, indexing="ij")
    vertices = np.zeros([num_vertices, 3], np.float32)
    vertices[:K * K, 0] = (radius * np.sin(tt) * np.sin(pp)).reshape(-1)
    vertices[:K * K, 1] = (radius * np.cos(tt)).reshape(-1)
    vertices[:K * K, 2] = (radius * np.sin(tt) * np.cos(pp)).reshape(-1)
    vertices[num_vertices - 2] = [0.0, 1.0, 0.0]
    vertices[num_vertices - 1] = [0.0, -1.0, 0.0]

    triangles = np.zeros([num_triangles, 3], np.int32)
    # Equatorial strips: two triangles per quad.
    ii, jj = np.meshgrid(np.arange(K - 1), np.arange(K), indexing="ij")
    top_left = (ii * K + jj).reshape(-1)
    top_right = (ii * K + jj + 1).reshape(-1)
    bottom_left = ((ii + 1) * K + jj).reshape(-1)
    bottom_right = ((ii + 1) * K + jj + 1).reshape(-1)
    quads = np.empty([(K - 1) * K, 2, 3], np.int32)
    quads[:, 0, 0] = top_left
    quads[:, 0, 1] = bottom_left
    quads[:, 0, 2] = top_right
    quads[:, 1, 0] = top_right
    quads[:, 1, 1] = bottom_left
    quads[:, 1, 2] = bottom_right
    triangles[:2 * (K - 1) * K] = quads.reshape(-1, 3)
    # Pole fans.
    i = np.arange(K)
    base = 2 * (K - 1) * K
    triangles[base:base + K, 0] = num_vertices - 2
    triangles[base:base + K, 1] = i
    triangles[base:base + K, 2] = i + 1
    base += K
    triangles[base:base + K, 0] = num_vertices - 1
    triangles[base:base + K, 1] = (K - 1) * K + i + 1
    triangles[base:base + K, 2] = (K - 1) * K + i

    norms = np.linalg.norm(vertices, axis=-1, keepdims=True)
    normals = vertices / np.maximum(norms, 1e-12)
    return _as_tensors(vertices, triangles, normals)


def icosphere(subdivisions: int = 3):
    """Unit icosphere: the icosahedron with each face split into four
    `subdivisions` times, new vertices pushed out to the unit sphere.

    Level n has 10 * 4^n + 2 vertices and 20 * 4^n triangles (level 3:
    642 and 1,280, the vertex and face counts of SoftRas's
    `sphere_642.obj`), and every edge borders exactly two triangles, so
    the mesh is closed. The twelve icosahedron vertices come first, then
    each level's edge midpoints in the order their edges are met.

    Returns:
      (vertices [V, 3] f32, triangles [T, 3] int32, normals [V, 3] f32),
      CCW winding viewed from outside; the normals equal the vertices.
    """
    if subdivisions < 0:
        raise ValueError("subdivisions must be >= 0")
    phi = (1.0 + 5.0 ** 0.5) / 2.0
    vertices = [[-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
                [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
                [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1]]
    vertices = [list(np.asarray(v, np.float64) / np.linalg.norm(v))
                for v in vertices]
    triangles = [[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
                 [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
                 [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
                 [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]]
    for _ in range(subdivisions):
        midpoints = {}

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in midpoints:
                m = (np.asarray(vertices[a]) + np.asarray(vertices[b])) / 2
                vertices.append(list(m / np.linalg.norm(m)))
                midpoints[key] = len(vertices) - 1
            return midpoints[key]

        finer = []
        for a, b, c in triangles:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            finer += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        triangles = finer
    vertices = np.asarray(vertices, np.float32)
    return _as_tensors(vertices, triangles, vertices)


def cube(size: float):
    """Axis-aligned cube with the given side length, centered at the origin.

    Returns:
      (vertices [8, 3] f32, triangles [12, 3] int32, normals [8, 3] f32),
      CCW winding viewed from outside.
    """
    vertices = 0.5 * size * np.array(
        [[-1, -1, 1], [-1, -1, -1], [-1, 1, -1], [-1, 1, 1], [1, -1, 1],
         [1, -1, -1], [1, 1, -1], [1, 1, 1]], np.float32)
    norms = np.linalg.norm(vertices, axis=-1, keepdims=True)
    normals = vertices / np.maximum(norms, 1e-12)
    triangles = np.array(
        [[2, 1, 0], [0, 3, 2], [6, 2, 3], [3, 7, 6], [5, 6, 7], [7, 4, 5],
         [1, 5, 4], [4, 0, 1], [2, 6, 5], [5, 1, 2], [0, 4, 7], [7, 3, 0]],
        np.int32)
    return _as_tensors(vertices, triangles, normals)
