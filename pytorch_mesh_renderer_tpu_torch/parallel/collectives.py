"""The collectives of multi-process sharding.

The port's counterpart of what XLA inserts around `shard_map` when a mesh
spans processes (`pytorch_mesh_renderer_tpu/parallel/sharded.py`). Every
rank runs the same program on the same global tensors; each renders only
its own cells of the mesh (`parallel/mesh.owner`), so:

  * `assemble` gathers the ranks' cells so that every rank holds the
    whole [B, H, W, ...] output in the mesh's row-major order, bit for bit
    the unsharded render (a gather copies; nothing is summed). Its
    backward hands each of this rank's cells its own slice of the
    incoming gradient and sums nothing over the ranks: every rank computes
    the same loss from the same assembled image, so a sum (what
    `torch.distributed.nn.functional.all_gather`'s backward does) would
    multiply each gradient by the world size;
  * `replicated` is the identity on the tensors that enter the cells, and
    its backward adds their partial gradients over the ranks (the
    `psum`s): each rank's cells saw only part of the image.

Both reduce in a fixed order: `replicated` gathers every rank's partial
gradient and adds them in rank order on every rank, so two runs repeat
bit for bit and the ranks' parameters stay bit-identical. Under gloo a
CUDA tensor is copied to host memory for the collective and back (gloo's
support for CUDA tensors differs by operation and version; gloo here only
ever sees CPU tensors), which serves ranks that share one card. Under
NCCL the collectives run on the card (unverified: it takes one card per
rank).

No collective is captured into a CUDA graph. A training step
(`parallel/sharded.py`) captures a step that gathers as a chain of
graphs cut at its gathers: while it captures, every gather goes through
`_cut`, which ends the graph after the copy of the gather's input into a
static buffer (pinned host memory under gloo) and begins the next with
the copy of the gathered parts out of one; its replays run each gather
between the graphs. A gather under any other capture raises. `gathers()`
lists the gathers a block meets, in order.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
import torch.distributed as dist

from ..utils import profiling


class Gather(NamedTuple):
    """A gather a step met: which collective, and its input's shape and
    dtype."""
    label: str  # "assemble" (the forward) or "replicated" (the backward)
    shape: tuple
    dtype: torch.dtype


_met = None  # the list of the innermost `gathers` block, else None
# While a training step captures: the callable every gather goes through
# instead of gathering (tensor -> the parts, in rank order).
_cut = None


@contextlib.contextmanager
def gathers():
    """Collects into a list the `Gather` of each gather met in the block,
    in order."""
    global _met
    outer, _met = _met, []
    try:
        yield _met
    finally:
        _met = outer


def through_host(device):
    """Whether a gather of tensors on `device` passes through host memory
    (a card under gloo)."""
    return torch.device(device).type == "cuda" and dist.get_backend() == "gloo"


def _all_gather(tensor, label):
    """Every rank's `tensor` (same shape and dtype on every rank), in rank
    order, on `tensor`'s device."""
    if _met is not None:
        _met.append(Gather(label, tuple(tensor.shape), tensor.dtype))
    if _cut is not None:
        return _cut(tensor)
    if tensor.is_cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "a gather across processes under a CUDA-graph capture that is "
            "not a training step's: capture the step through "
            "parallel.make_train_step, which cuts its graph at each gather")
    staged = through_host(tensor.device)
    if staged:
        profiling.count("host_syncs.gather")
    src = (tensor.detach().cpu() if staged
           else tensor.detach().contiguous())
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, src)
    return [p.to(tensor.device) for p in parts] if staged else parts


class _Assemble(torch.autograd.Function):

    @staticmethod
    def forward(ctx, owners, per, local_h, *own):
        rank = dist.get_rank()
        counts = [0] * dist.get_world_size()
        for row in owners:
            for r in row:
                counts[r] += 1
        padded = list(own) + [torch.zeros_like(own[0])] * (
            max(counts) - len(own))
        parts = _all_gather(torch.stack(padded), "assemble")
        taken = [0] * len(counts)
        slices, mine = [], []
        for i, row in enumerate(owners):
            strips = []
            for j, r in enumerate(row):
                strips.append(parts[r][taken[r]])
                taken[r] += 1
                if r == rank:
                    mine.append((slice(i * per, (i + 1) * per),
                                 slice(j * local_h, (j + 1) * local_h)))
            slices.append(torch.cat(strips, dim=1))
        ctx.mine = mine
        return torch.cat(slices, dim=0)

    @staticmethod
    def backward(ctx, grad):
        return (None, None, None) + tuple(
            grad[images, rows].contiguous() for images, rows in ctx.mine)


def assemble(owners, per, local_h, own):
    """The whole [B, H, ...] output on every rank.

    Args:
      owners: the rank of each cell, [data][space] (row-major).
      per, local_h: images per data slice, rows per space strip.
      own: this rank's cells, [per, local_h, ...] each on one device, in
        row-major order (at least one).
    """
    return _Assemble.apply(owners, per, local_h, *own)


class _Replicated(torch.autograd.Function):

    @staticmethod
    def forward(ctx, *tensors):
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        # One gather per (device, dtype), in order of first appearance,
        # which every rank shares.
        groups: dict = {}
        for k, g in enumerate(grads):
            groups.setdefault((g.device, g.dtype), []).append(k)
        out = [None] * len(grads)
        for ks in groups.values():
            flat = torch.cat([grads[k].reshape(-1) for k in ks])
            parts = _all_gather(flat, "replicated")
            total = parts[0].clone()
            for part in parts[1:]:
                total += part
            start = 0
            for k in ks:
                n = grads[k].numel()
                out[k] = total[start:start + n].view_as(grads[k])
                start += n
        return tuple(out)


def replicated(*values):
    """`values` as they are (tensors and anything else), the tensors that
    require a gradient routed through one node whose backward adds their
    gradients over the ranks."""
    keys = [k for k, v in enumerate(values)
            if torch.is_tensor(v) and v.requires_grad]
    if not keys or not torch.is_grad_enabled():
        return tuple(values)
    routed = _Replicated.apply(*(values[k] for k in keys))
    out = list(values)
    for k, v in zip(keys, routed):
        out[k] = v
    return tuple(out)
