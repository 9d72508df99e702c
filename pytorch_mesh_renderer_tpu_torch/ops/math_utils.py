"""Small numeric helpers shared across the port.

Port of `pytorch_mesh_renderer_tpu/ops/math_utils.py`.
"""

from __future__ import annotations

import torch


def normalize(x: torch.Tensor, p: int = 2, dim: int = -1,
              eps: float = 1e-12) -> torch.Tensor:
    """Lp-normalize `x` along `dim`: x / max(||x||_p, eps).

    The semantics of torch.nn.functional.normalize, written out with the
    JAX package's operation order (sqrt of a sum of squares for p=2) so the
    two packages round alike.
    """
    if p == 2:
        norm = torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True))
    elif p == 1:
        norm = torch.sum(torch.abs(x), dim=dim, keepdim=True)
    else:
        norm = torch.sum(torch.abs(x) ** p, dim=dim,
                         keepdim=True) ** (1.0 / p)
    return x / torch.clamp(norm, min=eps)


def dot_last(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product along the last axis (no keepdim)."""
    return torch.sum(a * b, dim=-1)
