"""Printing and NaN/Inf checks.

Port of `pytorch_mesh_renderer_tpu/utils/debug.py:16-61`. PyTorch runs
eagerly, so every check reads concrete values on the host (a
device-to-host copy for a CUDA tensor). The JAX package's traced variants
print from compiled code; a CUDA graph cannot copy to the host while it
is captured, so here a check inside a capture (`utils/capture.capturing`)
raises rather than skip.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from .capture import capturing


def _refuse_capture(tensor: torch.Tensor, what: str) -> None:
    if capturing(tensor):
        raise RuntimeError(
            f"{what} reads its tensor on the host, which a CUDA-graph "
            "capture cannot do; call it outside the captured step")


def _any(value, what: str) -> bool:
    """Whether any element of `value` (a tensor, array or number) is
    true: reduced on the tensor's device, read on the host."""
    if torch.is_tensor(value):
        _refuse_capture(value, what)
        return bool(value.any())
    return bool(np.asarray(value).any())


def _non_finite(tensor, what: str) -> bool:
    if torch.is_tensor(tensor):
        return _any(~torch.isfinite(tensor), what)
    return not np.isfinite(np.asarray(tensor)).all()


def debug_tensor(tensor, msg: str = "") -> None:
    """Pretty-print a full tensor (host-side), as the JAX package does."""
    if torch.is_tensor(tensor):
        _refuse_capture(tensor, "debug_tensor")
        tensor = tensor.detach().cpu().numpy()
    with np.printoptions(threshold=np.inf, linewidth=200):
        print("[debug tensor] {}".format(msg))
        print(np.asarray(tensor))


def check_isnan_isinf(tensor, msg: str = "") -> None:
    """Raise ValueError if the tensor contains NaN or Inf."""
    if _non_finite(tensor, "check_isnan_isinf"):
        raise ValueError(msg)


def debug_warn_if(bad, msg: str = "") -> None:
    """Warn (RuntimeWarning) with `msg` if any element of `bad` is true.

    The eager counterpart of the JAX package's traced `debug_warn_if`:
    it warns rather than raises, so a training loop with debug checks on
    keeps running.
    """
    if _any(bad, "debug_warn_if"):
        warnings.warn(f"[mesh_renderer debug] {msg}", RuntimeWarning,
                      stacklevel=2)


def debug_check_finite(tensor, msg: str = "") -> None:
    """Warn (RuntimeWarning) if the tensor contains NaN or Inf."""
    if _non_finite(tensor, "debug_check_finite"):
        warnings.warn(f"[mesh_renderer debug] {msg}: NON-FINITE values "
                      "detected", RuntimeWarning, stacklevel=2)
