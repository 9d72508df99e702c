"""Wavefront .obj load and save (host-side IO).

Port of `pytorch_mesh_renderer_tpu/utils/obj_io.py`: v/vn/f records,
`f v//vn` face-vertex normals averaged to one normal per vertex, computed
area-weighted normals for meshes without `vn`, and the optional
normalization into a +-1 cube. Files are parsed by the native C++ parser
(`utils/native.py`) when its library builds and loads, else by the Python
parser, with the same outputs. `save_obj` writes the JAX package's bytes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.mesh import compute_vertex_normals
from . import native


def _parse_obj(lines):
    """The Python parser: the arrays `native.parse_obj` returns (vertices,
    normals, 0-based faces, face normal ids with -1 where a face vertex
    names none), by the JAX package's Python parser's rules: a face's
    normal ids are read when its first vertex has a `v//vn` or `v/vt/vn`
    form, and the normals are an array even when empty (a face naming a
    normal the file lacks then fails, as there)."""
    vertices = []
    all_normals = []
    faces = []
    fn_ids = []
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
                [int(fv.split("/")[0]) - 1 for fv in face_vertices[:3]])
            if len(face_vertices[0].split("/")) > 2:
                fn_ids.append([int(fv.split("/")[2]) - 1
                               for fv in face_vertices[:3]])
            else:
                fn_ids.append([-1, -1, -1])
    return (np.array(vertices, np.float32).reshape(-1, 3),
            np.array(all_normals, np.float32).reshape(-1, 3),
            np.array(faces, np.int32).reshape(-1, 3),
            np.array(fn_ids, np.int32).reshape(-1, 3))


def _vertex_normals(vertices, all_normals, faces, fn_ids):
    """Per-vertex normals: the mean of each vertex's face-vertex normals
    (1 where it has none), normalised; computed normals for a mesh
    without `vn` references (or, from the native parser, without `vn`
    records). The sums run in face order, as the JAX package's Python
    parser adds them."""
    has_vn = fn_ids >= 0
    if all_normals is None or not has_vn.any():
        return compute_vertex_normals(torch.from_numpy(vertices)[None],
                                      torch.from_numpy(faces))[0].numpy()
    acc = np.zeros_like(vertices)
    counts = np.zeros([len(vertices)], np.float32)
    vid = faces.ravel()[has_vn.ravel()]
    nid = fn_ids.ravel()[has_vn.ravel()]
    np.add.at(acc, vid, all_normals[nid])
    np.add.at(counts, vid, 1.0)
    normals = np.where(counts[:, None] > 0,
                       acc / np.maximum(counts[:, None], 1.0), 1.0)
    norm = np.linalg.norm(normals, axis=1, keepdims=True)
    return normals / np.maximum(norm, 1e-12)


def load_obj(filename: str, normalize: bool = True):
    """Load a Wavefront .obj file.

    Only v / vn / f records are read. The native parser reads the file
    when its library loads; where it is unavailable or fails, the Python
    parser reads it, as in the JAX package.

    Returns:
      (vertices [V, 3] f32, faces [T, 3] int32, normals [V, 3] f32) as CPU
      tensors. With normalize=True the vertices are rescaled into a unit
      cube centered near zero, in the JAX package's order of operations.
    """
    try:
        parsed = native.parse_obj(filename)
    except Exception:  # noqa: BLE001 - the Python parser stands behind it
        parsed = None

    if parsed is None:
        with open(filename) as f:
            parsed = _parse_obj(f.readlines())
    vertices, all_normals, faces, fn_ids = parsed
    vertices = vertices.astype(np.float32)
    faces = faces.astype(np.int32)
    normals = _vertex_normals(vertices, all_normals, faces, fn_ids)

    if normalize:
        # Shift to positive, scale by max-abs, double, recenter by half the
        # max: the JAX package's (and its reference's) order of operations.
        vertices -= vertices.min(0)[None, :]
        vertices /= np.abs(vertices).max()
        vertices *= 2
        vertices -= vertices.max(0)[None, :] / 2

    return (torch.from_numpy(vertices), torch.from_numpy(faces),
            torch.from_numpy(normals.astype(np.float32)))


def _host_array(value):
    """A tensor on any device, or an array, as a numpy array."""
    if torch.is_tensor(value):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def save_obj(filename: str, vertices, faces, normals=None) -> None:
    """Save a mesh to a Wavefront .obj file.

    Takes tensors on any device or numpy arrays. Vertices and normals are
    written one to one (`f v//v` when normals are given), the normals
    before the faces that name them; for the same float32 / int32 inputs
    the file is byte for byte the JAX package's (`obj_io.py:130-164`).
    """
    vertices = _host_array(vertices)
    faces = _host_array(faces)
    if vertices.ndim != 2 or vertices.shape[1] != 3:
        raise ValueError("vertices must have shape [vertex_count, 3]")
    if faces.ndim != 2 or faces.shape[1] != 3:
        raise ValueError("faces must have shape [triangle_count, 3]")
    if normals is not None:
        normals = _host_array(normals)
        if normals.ndim != 2 or normals.shape[1] != 3:
            raise ValueError("normals must have shape [vertex_count, 3]")
    with open(filename, "w") as f:
        for vertex in vertices:
            f.write("v {} {} {}\n".format(vertex[0], vertex[1], vertex[2]))
        if normals is not None:
            for normal in normals:
                f.write("vn {} {} {}\n".format(normal[0], normal[1],
                                               normal[2]))
        for face in faces:
            if normals is not None:
                f.write("f {}//{} {}//{} {}//{}\n".format(
                    face[0] + 1, face[0] + 1, face[1] + 1, face[1] + 1,
                    face[2] + 1, face[2] + 1))
            else:
                f.write("f {} {} {}\n".format(
                    face[0] + 1, face[1] + 1, face[2] + 1))
