"""Renderer configuration.

Port of `pytorch_mesh_renderer_tpu/config.py` (HardRasterizerConfig,
SoftRasterizerConfig and the debug-checks flag). The TPU knobs of the JAX
configs (`dot_precision`, `spatial_sort`, `binning`, `interpret`) have no
counterpart here: the CUDA kernels compute in fp32 throughout and stream
every triangle, so there is nothing for them to select.
"""

from __future__ import annotations

import dataclasses
import os

BACKENDS = ("auto", "cuda", "torch")


@dataclasses.dataclass(frozen=True)
class _RasterizerConfig:
    """The fields both rasterizer configs share (documented on each)."""
    backend: str = "auto"
    triangle_chunk: int = 64

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(
                f"backend must be one of {BACKENDS}, got {self.backend!r}")
        if self.triangle_chunk < 1:
            raise ValueError("triangle_chunk must be >= 1")


class HardRasterizerConfig(_RasterizerConfig):
    """Configuration for the hard (Genova-style barycentric) rasterizer.

    Attributes:
      backend: 'auto' (the CUDA kernel for CUDA tensors, the plain PyTorch
        version for CPU tensors), 'cuda' (the kernel; a CPU tensor raises)
        or 'torch' (the plain version on any device — the reference that
        tests and chip_smoke.py hold the kernel against). The renderer's
        shading follows it: 'auto' shades diffuse and ambient light on a
        card with the shading kernels and takes the plain ops for specular
        shading or gradients into the lights, 'cuda' raises for those, and
        'torch' always takes the plain ops.
      triangle_chunk: triangles per step of the plain version's dense
        z-buffer; bounds its peak memory at B*H*W*chunk intermediates.
    """


class SoftRasterizerConfig(_RasterizerConfig):
    """Configuration for the soft (SoftRas-style) rasterizer.

    Attributes:
      backend: as HardRasterizerConfig.backend: 'auto' (the CUDA kernels
        K5-K8 for CUDA tensors, the plain PyTorch version for CPU tensors),
        'cuda' (the kernels; a CPU tensor raises) or 'torch' (the plain
        version on any device).
      triangle_chunk: triangles per step of the plain version's dense
        online aggregation (and per recomputed segment of its backward);
        bounds its peak memory at B*H*W*chunk intermediates.
    """


HARD_CONFIG = HardRasterizerConfig()
SOFT_CONFIG = SoftRasterizerConfig()

# Debug checks (MESH_RENDERER_DEBUG=1 or set_debug_checks(True)): render
# checks its output images for NaN/Inf and warns. PyTorch runs eagerly, so
# the check reads concrete values; it costs one device-to-host sync per
# render while enabled and nothing while disabled.
_DEBUG_CHECKS = os.environ.get("MESH_RENDERER_DEBUG", "0") not in (
    "0", "", "false", "False")


def set_debug_checks(enabled: bool) -> None:
    """Enable/disable the debug checks (see the module comment above)."""
    global _DEBUG_CHECKS
    _DEBUG_CHECKS = bool(enabled)


def debug_checks_enabled() -> bool:
    return _DEBUG_CHECKS
