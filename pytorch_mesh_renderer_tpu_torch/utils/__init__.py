"""Host-side utilities: OBJ IO, scene conversion, checks, kernel builds."""

from . import debug, obj_io  # noqa: F401
