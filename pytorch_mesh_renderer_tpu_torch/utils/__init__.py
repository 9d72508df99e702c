"""Host-side utilities: OBJ IO, checkpoints, checks, profiling, scene
conversion, kernel builds."""

from . import checkpoint, debug, obj_io, profiling  # noqa: F401
