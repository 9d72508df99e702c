"""NaN/Inf checks.

Port of `pytorch_mesh_renderer_tpu/utils/debug.py:16-61`. PyTorch runs
eagerly, so both checks read concrete values (a device-to-host sync for a
CUDA tensor); the JAX package's traced variants have no counterpart here.
"""

from __future__ import annotations

import warnings

import torch


def _has_non_finite(tensor: torch.Tensor) -> bool:
    return not bool(torch.isfinite(tensor).all())


def check_isnan_isinf(tensor: torch.Tensor, msg: str = "") -> None:
    """Raise ValueError if the tensor contains NaN or Inf."""
    if _has_non_finite(tensor):
        raise ValueError(msg)


def debug_check_finite(tensor: torch.Tensor, msg: str = "") -> None:
    """Warn (RuntimeWarning) if the tensor contains NaN or Inf.

    Warns rather than raises, like the JAX package's check, so a training
    loop with debug checks on keeps running.
    """
    if _has_non_finite(tensor):
        warnings.warn(f"[mesh_renderer debug] {msg}: NON-FINITE values "
                      "detected", RuntimeWarning, stacklevel=2)
