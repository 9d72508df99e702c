"""Model families: the hard renderer and procedural shapes."""

from . import shapes  # noqa: F401
