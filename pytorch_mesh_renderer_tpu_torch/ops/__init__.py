"""Compute ops: camera math, mesh ops, the rasterizer and its kernel, shading."""

from . import barycentric, camera, math_utils, mesh, shading  # noqa: F401
