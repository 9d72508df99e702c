"""ctypes binding of the native C++ OBJ parser (native/meshops.cpp).

Port of `pytorch_mesh_renderer_tpu/utils/native.py`, the port's own copy:
the library is built with `make -C native` into `native/build/` on first
use and loaded with ctypes (a plain C ABI, marshalled with numpy).
Callers handle `load_library() is None` (no compiler, or no `native/`
beside the package) with the Python parser.

Several processes (pytest-xdist workers) may build at once, and a `make`
that runs while another process loads the library can hand it a
half-written `.so`: the build and the load hold an exclusive `fcntl` lock
on `native/build/.lock`. The JAX package builds the same library without
that lock, so a load that fails is retried after a pause (LOAD_ATTEMPTS).
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import sys
import threading
import time

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_BUILD_DIR = os.path.join(_NATIVE_DIR, "build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libmeshops.so")

LOAD_ATTEMPTS = 3

_lock = threading.Lock()
_lib = None
_load_attempted = False


class _ObjMesh(ctypes.Structure):
    _fields_ = [
        ("vertices", ctypes.POINTER(ctypes.c_float)),
        ("vertex_count", ctypes.c_long),
        ("normals", ctypes.POINTER(ctypes.c_float)),
        ("normal_count", ctypes.c_long),
        ("faces", ctypes.POINTER(ctypes.c_int)),
        ("face_count", ctypes.c_long),
        ("face_normal_ids", ctypes.POINTER(ctypes.c_int)),
        ("skipped_face_vertices", ctypes.c_long),
        ("error", ctypes.c_char * 256),
    ]


def _build_and_load():
    """make (timestamp-incremental: a library built from an older source
    would be loaded against this struct layout otherwise), then dlopen,
    under the cross-process lock."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with open(os.path.join(_BUILD_DIR, ".lock"), "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        for attempt in range(LOAD_ATTEMPTS):
            if attempt:
                time.sleep(1.0)
            try:
                subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                               capture_output=True)
            except (subprocess.CalledProcessError, FileNotFoundError) as e:
                print(f"[native] build failed ({e}); using the Python "
                      "parser", file=sys.stderr)
                return None
            try:
                return ctypes.CDLL(_LIB_PATH)
            except OSError as e:
                error = e
        print(f"[native] load failed ({error}); using the Python parser",
              file=sys.stderr)
        return None


def load_library():
    """The loaded native library, built if needed, or None."""
    global _lib, _load_attempted
    with _lock:
        if _lib is not None or _load_attempted:
            return _lib
        _load_attempted = True
        if not os.path.exists(os.path.join(_NATIVE_DIR, "meshops.cpp")):
            return None
        lib = _build_and_load()
        if lib is None:
            return None
        lib.meshops_load_obj.restype = ctypes.POINTER(_ObjMesh)
        lib.meshops_load_obj.argtypes = [ctypes.c_char_p]
        lib.meshops_free.argtypes = [ctypes.POINTER(_ObjMesh)]
        _lib = lib
        return _lib


def parse_obj(path: str):
    """Parses an .obj with the native library.

    Returns (vertices [V, 3] f32, raw normals [N, 3] f32 or None, faces
    [T, 3] int32 (0-based), face normal ids [T, 3] int32 with -1 where a
    face vertex has none), or None when the library is unavailable.
    Raises IOError for a file the library cannot read.
    """
    lib = load_library()
    if lib is None:
        return None
    mesh_p = lib.meshops_load_obj(path.encode())
    if not mesh_p:  # calloc failure in the library
        return None
    try:
        mesh = mesh_p.contents
        err = bytes(mesh.error).split(b"\0", 1)[0]
        if err:
            raise IOError(err.decode())
        if mesh.skipped_face_vertices:
            print(f"warning: obj file has faces with more than 3 vertices; "
                  f"{mesh.skipped_face_vertices} face vertices were dropped",
                  file=sys.stderr)
        vertices = np.ctypeslib.as_array(
            mesh.vertices, shape=(mesh.vertex_count, 3)).copy()
        faces = np.ctypeslib.as_array(
            mesh.faces, shape=(mesh.face_count, 3)).copy()
        fn_ids = np.ctypeslib.as_array(
            mesh.face_normal_ids, shape=(mesh.face_count, 3)).copy()
        normals = None
        if mesh.normal_count:
            normals = np.ctypeslib.as_array(
                mesh.normals, shape=(mesh.normal_count, 3)).copy()
        return vertices, normals, faces, fn_ids
    finally:
        lib.meshops_free(mesh_p)
