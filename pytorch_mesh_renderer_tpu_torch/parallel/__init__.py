"""Training on one device: the port of the JAX package's `parallel`
training step and loop (its meshes and sharded rasterizers are not
ported yet)."""

from .sharded import make_train_loop, make_train_step

__all__ = ["make_train_loop", "make_train_step"]
