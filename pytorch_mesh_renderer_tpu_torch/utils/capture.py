"""What a step needs to be captured into a CUDA graph.

Under `torch.cuda.graph` capture nothing may wait for the card or copy
from the host: `bool(tensor)` syncs, and `torch.tensor(values,
device="cuda")` copies host memory, which the capture refuses. The
renderers' entry points therefore build their constants from Python
values through `constant`, and skip their host-side checks while
`capturing()` (the JAX package's rule: no host assert under `jit`,
`pytorch_mesh_renderer_tpu/ops/camera.py:10-17`).
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch


def capturing(tensor: torch.Tensor) -> bool:
    """Whether `tensor` lies on a CUDA device whose current stream is
    capturing a CUDA graph (never on the CPU)."""
    return tensor.is_cuda and torch.cuda.is_current_stream_capturing()


_held = None  # the list of the innermost `hold` block, else None


@contextlib.contextmanager
def hold():
    """Collects into a list every array tensor that `constant` returns
    inside the block. A CUDA graph captured in the block reads those
    tensors at each replay, and `constant`'s cache may let them go, so
    the caller keeps the list as long as the graph:

        with capture.hold() as constants, torch.cuda.graph(graph):
            ...
    """
    global _held
    outer, _held = _held, []
    try:
        yield _held
    finally:
        _held = outer


def keep(*tensors):
    """Adds `tensors` to the innermost `hold` block's list, if any: for a
    cache other than `constant`'s whose tensors a captured graph reads."""
    if _held is not None:
        _held.extend(tensors)


@functools.lru_cache(maxsize=256)
def _cached(data: bytes, shape: tuple, dtype: str, device: torch.device):
    array = np.frombuffer(data, dtype=dtype).reshape(shape)
    return torch.from_numpy(array.copy()).to(device)


def constant(value, device, dtype=torch.float32) -> torch.Tensor:
    """`value` (a Python number, sequence or numpy array) as a `dtype`
    tensor on `device`, with the values `torch.as_tensor` gives.

    A number becomes a 0-D `torch.full`, a device fill that a capture
    records. An array is copied to the device once per (values, device)
    and the same tensor returned after that, so the copy happens in a
    step's eager warm-up and never under capture; inside a `hold` block
    it also goes into that block's list. Callers must not write to the
    tensor returned for an array.
    """
    device = torch.device(device)
    if isinstance(value, (bool, int, float, np.number)) or (
            isinstance(value, np.ndarray) and value.ndim == 0):
        return torch.full((), value.item() if isinstance(
            value, (np.number, np.ndarray)) else value, dtype=dtype,
            device=device)
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    array = np.ascontiguousarray(np.asarray(value, dtype=np_dtype))
    tensor = _cached(array.tobytes(), array.shape, array.dtype.str, device)
    if _held is not None:
        _held.append(tensor)
    return tensor
