"""Build and load the port's CUDA kernels.

The build-at-first-use pattern of `pytorch_mesh_renderer_tpu/utils/
native.py:42-80`, for CUDA: every `csrc/*.cu` is compiled by its own
`nvcc` process (all started together), and the objects are linked into
one shared library with a plain C interface, placed in `_build/` under a
name keyed by a hash of the sources (`*.cu` and the shared `*.cuh`) and
flags, and loaded with ctypes. Nothing is compiled or loaded when this
module is imported.

There is no fallback: a missing `nvcc` or a failed build raises, with the
compiler's output in the message.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")

# sm_90a: Hopper with its architecture-specific instructions. --fmad=false
# keeps a*b + c as a product and a sum, rounding as the plain PyTorch
# versions do. -Xptxas -v reports registers, shared memory and spills into
# the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC")


@dataclasses.dataclass(frozen=True)
class Build:
    """A built kernel library: its path and the compiler's output."""
    path: str
    log: str


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")) +
                  glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def _nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            candidates.append(os.path.join(root, "bin", "nvcc"))
    for path in candidates:
        if path and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (looked on PATH, $CUDA_HOME/bin and "
        "/usr/local/cuda/bin); the CUDA kernels cannot be built.")


def _source_hash(sources: list[str]) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources:
        digest.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            digest.update(f.read())
    return digest.hexdigest()[:16]


def build() -> Build:
    """Compile csrc/*.cu into _build/ unless that exact build exists."""
    sources = _sources()
    if not any(s.endswith(".cu") for s in sources):
        raise RuntimeError(f"no CUDA sources found in {CSRC_DIR}")
    stem = os.path.join(BUILD_DIR, "libmesh_kernels_" + _source_hash(sources))
    path, log_path = stem + ".so", stem + ".log"
    if os.path.exists(path) and os.path.exists(log_path):
        with open(log_path) as f:
            return Build(path, f.read())

    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp_path = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    units = [s for s in sources if s.endswith(".cu")]
    objects = [f"{tmp_path}.{i}.o" for i in range(len(units))]
    try:
        nvcc = _nvcc()
        compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
                    for src, obj in zip(units, objects)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in compiles]
        log = ""
        failed = []
        for cmd, proc in zip(compiles, procs):
            out, _ = proc.communicate()
            log += out
            if proc.returncode != 0:
                failed.append(f"nvcc failed (exit {proc.returncode}): "
                              f"{' '.join(cmd)}")
        if failed:
            raise RuntimeError("\n".join(failed) + "\n" + log)
        link = [nvcc, "-shared", "-o", tmp_path, *objects]
        proc = subprocess.run(link, capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed (exit {proc.returncode}): "
                f"{' '.join(link)}\n{log}")
        # Atomic renames, so a concurrent build never loads a partial
        # library.
        with open(tmp_path + ".log", "w") as f:
            f.write(log)
        os.replace(tmp_path + ".log", log_path)
        os.replace(tmp_path, path)
    finally:
        for leftover in (tmp_path, tmp_path + ".log", *objects):
            if os.path.exists(leftover):
                os.remove(leftover)
    return Build(path, log)


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C ABI."""
    lib = ctypes.CDLL(build().path)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rasterize_fused_fwd.argtypes = [ptr] * 6 + [i32] * 6 + [f32, f32,
                                                                i32, ptr]
    lib.rasterize_fused_bwd.argtypes = [ptr] * 8 + [i32] * 5 + [ptr]
    lib.rasterize_bary_fwd.argtypes = [ptr] * 4 + [i32] * 5 + [
        f32, f32, i32, i32, ptr]
    lib.rasterize_bary_bwd.argtypes = [ptr] * 6 + [i32] * 4 + [ptr]
    lib.soft_fwd.argtypes = [ptr] * 6 + [i32] * 7 + [ptr]
    lib.soft_bwd.argtypes = [ptr] * 10 + [i32] * 7 + [ptr]
    lib.soft_sil_fwd.argtypes = [ptr] * 3 + [i32] * 6 + [ptr]
    lib.soft_sil_bwd.argtypes = [ptr] * 7 + [ctypes.c_longlong] + [
        i32] * 6 + [ptr]
    lib.soft_sil_bwd_scratch_floats.argtypes = [i32] * 5
    lib.soft_sil_bwd_scratch_floats.restype = ctypes.c_longlong
    occupancy = (lib.rasterize_fused_fwd_blocks_per_sm,
                 lib.rasterize_fused_bwd_blocks_per_sm,
                 lib.rasterize_bary_bwd_blocks_per_sm,
                 lib.soft_bwd_blocks_per_sm, lib.soft_sil_bwd_blocks_per_sm,
                 lib.soft_fwd_blocks_per_sm, lib.soft_sil_fwd_blocks_per_sm)
    for entry in occupancy:
        entry.argtypes = []
    lib.mxu_edge_fma.argtypes = [ptr] * 2 + [i32] * 3 + [f32, ptr]
    lib.mxu_edge_tc.argtypes = [ptr] * 3 + [i32] * 4 + [ptr]
    lib.mxu_full_prod.argtypes = [ptr] * 7 + [i32] * 5 + [f32, ptr]
    lib.mxu_full_prod_shape.argtypes = [i32] * 3 + [ptr]
    lib.mxu_full_tc.argtypes = [ptr] * 7 + [i32] * 3 + [f32, ptr]
    lib.patch_eval.argtypes = [ptr] * 2 + [i32] * 3 + [f32, ptr]
    lib.phong_shade_fwd.argtypes = [ptr] * 5 + [i32] * 5 + [ptr]
    lib.phong_shade_bwd.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
    for entry in (lib.rasterize_fused_fwd, lib.rasterize_fused_bwd,
                  lib.rasterize_bary_fwd, lib.rasterize_bary_bwd,
                  lib.soft_fwd, lib.soft_bwd, lib.soft_sil_fwd,
                  lib.soft_sil_bwd, lib.mxu_edge_fma, lib.mxu_edge_tc,
                  lib.mxu_full_prod, lib.mxu_full_prod_shape,
                  lib.mxu_full_tc, lib.patch_eval, lib.phong_shade_fwd,
                  lib.phong_shade_bwd, *occupancy):
        entry.restype = i32
    lib.cuda_error_string.argtypes = [i32]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def check_cuda_error(lib: ctypes.CDLL, error: int, what: str) -> None:
    """Raise RuntimeError if a C entry point returned a CUDA error."""
    if error != 0:
        message = lib.cuda_error_string(error).decode()
        raise RuntimeError(f"{what} failed: CUDA error {error} ({message})")
