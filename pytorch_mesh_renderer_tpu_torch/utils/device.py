"""The device an entry point runs on."""

from __future__ import annotations

import torch


def resolve_device(name: str) -> torch.device:
    """`torch.device(name)`; `cuda` without a card raises: the entry
    points run on the card unless the caller asks for the CPU, and never
    fall back to it."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs an NVIDIA GPU; --device cpu "
                           "runs the plain versions")
    return device
