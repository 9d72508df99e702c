"""pytorch_mesh_renderer_tpu_torch — the PyTorch/CUDA port of the renderer.

A second package beside the JAX reference `pytorch_mesh_renderer_tpu`. It
imports torch and numpy and never jax. Module paths mirror the JAX
package's, so each port module sits where its counterpart does. Plain
tensor code is PyTorch; the rasterizer's hot loop is a CUDA C++ kernel
(`csrc/rasterize_fused_fwd.cu`) built for Hopper on first use.

The slice ported so far is the hard Phong renderer's forward path:

    import pytorch_mesh_renderer_tpu_torch as pmt
    images = pmt.mesh_renderer.render(vertices, triangles, normals, ...)

A CPU tensor renders through the plain PyTorch version of the kernel; a
CUDA tensor renders through the kernel.
"""

from . import config
from .models import mesh_renderer, shapes
from .ops import camera, mesh
from .utils import debug, obj_io

__all__ = ["config", "mesh_renderer", "shapes", "camera", "mesh", "obj_io",
           "debug"]
