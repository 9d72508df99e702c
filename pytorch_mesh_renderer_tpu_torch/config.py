"""Renderer configuration.

Port of `pytorch_mesh_renderer_tpu/config.py` (HardRasterizerConfig and the
debug-checks flag). The TPU knobs of the JAX config (`dot_precision`,
`spatial_sort`, `binning`, `interpret`) have no counterpart here: the CUDA
kernel computes in fp32 throughout and streams every triangle, so there is
nothing for them to select.
"""

from __future__ import annotations

import dataclasses
import os

BACKENDS = ("auto", "cuda", "torch")


@dataclasses.dataclass(frozen=True)
class HardRasterizerConfig:
    """Configuration for the hard (Genova-style barycentric) rasterizer.

    Attributes:
      backend: 'auto' (the CUDA kernel for CUDA tensors, the plain PyTorch
        version for CPU tensors), 'cuda' (the kernel; a CPU tensor raises)
        or 'torch' (the plain version on any device — the reference that
        tests and chip_smoke.py hold the kernel against).
      triangle_chunk: triangles per step of the plain version's dense
        z-buffer; bounds its peak memory at B*H*W*chunk intermediates.
    """
    backend: str = "auto"
    triangle_chunk: int = 64

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(
                f"backend must be one of {BACKENDS}, got {self.backend!r}")
        if self.triangle_chunk < 1:
            raise ValueError("triangle_chunk must be >= 1")


HARD_CONFIG = HardRasterizerConfig()

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
