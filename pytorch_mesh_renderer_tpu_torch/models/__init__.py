"""Model families: the hard and soft renderers and procedural shapes."""

from . import shapes  # noqa: F401
