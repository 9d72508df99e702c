"""Scale-out: device meshes, sharded rendering, training steps and loops
(the port of the JAX package's `parallel`)."""

from .mesh import (DATA_AXIS, SPACE_AXIS, Mesh, ProcessDevice,
                   global_devices, init_distributed, make_mesh,
                   make_multihost_mesh, order_devices_for_dcn,
                   single_device_mesh)
from .sharded import (make_train_loop, make_train_step, replicate,
                      shard_batch, sharded_rasterize, sharded_soft_rasterize,
                      sharded_soft_silhouette)

__all__ = [
    "DATA_AXIS", "SPACE_AXIS", "Mesh", "ProcessDevice", "global_devices",
    "init_distributed", "make_mesh", "make_multihost_mesh",
    "order_devices_for_dcn", "single_device_mesh", "make_train_loop",
    "make_train_step", "replicate", "shard_batch", "sharded_rasterize",
    "sharded_soft_rasterize", "sharded_soft_silhouette",
]
