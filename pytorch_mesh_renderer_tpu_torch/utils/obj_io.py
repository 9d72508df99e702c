"""Wavefront .obj loading (host-side IO).

Port of the Python parser path of `pytorch_mesh_renderer_tpu/utils/
obj_io.py:22-127`: v/vn/f records, `f v//vn` face-vertex normals averaged
to one normal per vertex, computed area-weighted normals for meshes
without `vn`, and the optional normalization into a +-1 cube. The JAX
package's native C++ parser binding (utils/native.py) is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.mesh import compute_vertex_normals


def _parse_obj(lines):
    vertices = []
    all_normals = []
    vertex_id_to_normals = {}
    faces = []
    for line in lines:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "v":
            vertices.append([float(v) for v in parts[1:4]])
        elif parts[0] == "vn":
            all_normals.append([float(v) for v in parts[1:4]])
        elif parts[0] == "f":
            face_vertices = parts[1:]
            if len(face_vertices) > 3:
                print("warning: encountered a face with more than 3 "
                      "vertices, extra vertices will be skipped")
            faces.append(
                [int(fv.split("/")[0]) for fv in face_vertices[:3]])
            if len(face_vertices[0].split("/")) > 2:
                for fv in face_vertices[:3]:
                    fv_parts = fv.split("/")
                    vertex_id = int(fv_parts[0]) - 1
                    normal_id = int(fv_parts[2]) - 1
                    vertex_id_to_normals.setdefault(vertex_id, []).append(
                        normal_id)
    return vertices, all_normals, vertex_id_to_normals, faces


def load_obj(filename: str, normalize: bool = True):
    """Load a Wavefront .obj file.

    Returns:
      (vertices [V, 3] f32, faces [T, 3] int32, normals [V, 3] f32) as CPU
      tensors. With normalize=True the vertices are rescaled into a unit
      cube centered near zero, in the JAX package's order of operations.
    """
    with open(filename) as f:
        lines = f.readlines()
    vertices, all_normals, vertex_id_to_normals, faces = _parse_obj(lines)

    vertices = np.array(vertices, np.float32).reshape(-1, 3)
    faces = np.array(faces, np.int32).reshape(-1, 3) - 1
    all_normals = np.array(all_normals, np.float32).reshape(-1, 3)

    if not vertex_id_to_normals:
        normals = compute_vertex_normals(
            torch.from_numpy(vertices)[None],
            torch.from_numpy(faces))[0].numpy()
    else:
        normals = np.zeros_like(vertices)
        for i in range(len(vertices)):
            ids = vertex_id_to_normals.get(i)
            if not ids:
                normals[i] = 1.0
                continue
            normals[i] = all_normals[ids].sum(axis=0) / len(ids)
        norm = np.linalg.norm(normals, axis=1, keepdims=True)
        normals = normals / np.maximum(norm, 1e-12)

    if normalize:
        # Shift to positive, scale by max-abs, double, recenter by half the
        # max: the JAX package's (and its reference's) order of operations.
        vertices -= vertices.min(0)[None, :]
        vertices /= np.abs(vertices).max()
        vertices *= 2
        vertices -= vertices.max(0)[None, :] / 2

    return (torch.from_numpy(vertices), torch.from_numpy(faces),
            torch.from_numpy(normals.astype(np.float32)))
