"""Checkpoint / resume of optimization state.

Port of `pytorch_mesh_renderer_tpu/utils/checkpoint.py:22-51`, written
with `torch.save` / `torch.load`: the state is a nest of dicts, lists and
tuples holding tensors, numbers and an optimizer's `state_dict()`, as

    checkpoint.save(path, {"params": [offsets],
                           "opt_state": optimizer.state_dict(), "step": 100})
    state = checkpoint.restore(path, {"params": [offsets],
                                      "opt_state": optimizer.state_dict(),
                                      "step": 0})
    offsets.copy_(state["params"][0])
    optimizer.load_state_dict(state["opt_state"])

A step captured into a CUDA graph (`parallel.make_train_step`) reads the
optimizer's state tensors where they lay at the capture, so restore
before the first call of the step or loop.
"""

from __future__ import annotations

import os

import torch


def save(path: str, state) -> None:
    """Saves `state` to the file `path`."""
    torch.save(state, path)


def _place(value, like):
    """`value` with each tensor moved to the device of its counterpart in
    `like` (same keys or positions); a tensor without one stays on the
    CPU, where `optimizer.load_state_dict` moves an optimizer's state to
    its parameters' device."""
    if torch.is_tensor(value):
        return value.to(like.device) if torch.is_tensor(like) else value
    if isinstance(value, dict):
        like = like if isinstance(like, dict) else {}
        return {k: _place(v, like.get(k)) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        like = like if isinstance(like, (list, tuple)) and len(like) == len(
            value) else [None] * len(value)
        return type(value)(_place(v, s) for v, s in zip(value, like))
    return value


def restore(path: str, like):
    """Restores a state saved by `save`. `like` has its structure; each
    tensor is placed on the device of its counterpart in `like`."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    return _place(state, like)


def exists(path: str) -> bool:
    return os.path.isdir(path) or os.path.isfile(path)
