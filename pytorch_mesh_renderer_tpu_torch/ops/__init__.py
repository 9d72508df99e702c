"""Compute ops: camera math, mesh ops, losses, the hard and soft rasterizers
and their kernels, shading."""

from . import (barycentric, camera, losses, math_utils, mesh,  # noqa: F401
               shading)
