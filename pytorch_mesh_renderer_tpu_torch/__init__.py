"""pytorch_mesh_renderer_tpu_torch — the PyTorch/CUDA port of the renderer.

A second package beside the JAX reference `pytorch_mesh_renderer_tpu`. It
imports torch and numpy and never jax. Module paths mirror the JAX
package's, so each port module sits where its counterpart does. Plain
tensor code is PyTorch; the rasterizers' hot loops are CUDA C++ kernels
(`csrc/*.cu`) built for Hopper on first use.

The slices ported so far are the hard Phong renderer and the soft (SoftRas)
renderer, forward and backward:

    import pytorch_mesh_renderer_tpu_torch as pmt
    images = pmt.mesh_renderer.render(vertices, triangles, normals, ...)
    rgba = pmt.soft_mesh_renderer.render(vertices, triangles, colors, ...)
    alpha = pmt.soft_mesh_renderer.render_silhouette(vertices, ...)

A CPU tensor renders through the plain PyTorch versions of the kernels; a
CUDA tensor renders through the kernels. `parallel` holds the device
meshes, the sharded renderers and the training step and loop, `utils`
the OBJ, checkpoint, debug and profiling helpers,
and `examples` the six example CLIs (`python -m
pytorch_mesh_renderer_tpu_torch.examples.<name>`).
"""

from . import config, parallel
from .models import mesh_renderer, shapes, soft_mesh_renderer
from .ops import camera, losses, mesh
from .utils import checkpoint, debug, obj_io, profiling

__all__ = ["config", "parallel", "mesh_renderer", "soft_mesh_renderer",
           "shapes", "camera", "losses", "mesh", "obj_io", "checkpoint",
           "debug", "profiling"]
