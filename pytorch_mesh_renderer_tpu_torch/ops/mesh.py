"""Mesh geometry ops.

Port of `pytorch_mesh_renderer_tpu/ops/mesh.py`: area-weighted per-vertex
normals and the unique edge list of a mesh; and the port's deterministic
vertex gather and scatter, `gather` and `segment_sum`.

A scatter-add to vertices (`index_add_`, or the backward of an indexing
gather) adds with float atomics on a card, in an order that changes from
run to run, so a gradient's last bits do too and a fit that repeats them
through Adam does not repeat. `segment_sum` adds in a fixed order
instead: its plan, built once on the host from a constant index (the
triangles, the edges), lists for each vertex the positions of the index
that name it, in increasing order and padded to the largest degree, so
the scatter is a gather of the padded positions and a sum over the
padding axis, with no atomic, and a CUDA graph can capture it.
`gather(values, index)` is `values[..., index, :]` with `segment_sum` as
its backward, and `segment_sum`'s backward is the gather. Plans are
cached by the index tensor (its storage, shape, strides and version) as
long as that tensor lives, so a captured step finds the plan that its
eager warm-up call built (`vertex_plan` says what a capture does with an
index made per call); `int32_index` casts an index to int32 once per
tensor, so that the renderers' cast makes no new index per call.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import capture
from .math_utils import normalize

# Caches keyed by a tensor: (storage, shape, strides, dtype, device,
# extra) -> (version, value, finalizer). An entry goes when the tensor
# that made it is freed, so its storage is never reused under a live key.
_PLANS = {}  # extra: V -> VertexPlan
_INT32 = {}  # extra: None -> the int32 copy
# (shape, dtype, device, V) -> [(a copy of the index, its values on the
# host, plan), ...]: the distinct indices of that signature planned last,
# the newest last.
_BY_SIGNATURE = {}
_SIGNATURE_PLANS = 4


def _key(tensor, extra):
    return (tensor.data_ptr(), tuple(tensor.shape), tensor.stride(),
            tensor.dtype, tensor.device, extra)


def _cached(cache, tensor, extra):
    """The live value cached for `tensor`, else None."""
    hit = cache.get(_key(tensor, extra))
    return hit[1] if hit is not None and hit[0] == tensor._version else None


def _store(cache, tensor, extra, value):
    key = _key(tensor, extra)
    if key in cache:
        cache[key][2].detach()
    cache[key] = (tensor._version, value,
                  weakref.finalize(tensor, cache.pop, key, None))


class VertexPlan:
    """A scatter plan of an index tensor with N entries over V vertices:
    `slots` [V, D] int64 lists for each vertex the flat positions p of
    the index that name it, in increasing order, padded with N to D, the
    largest degree (at least 1); `degree` [V] f32 counts them. `check` is
    None, or a 0-D bool tensor that is False when the index a capture
    read equals none of those the plan was chosen from (`sum` then gives
    NaN)."""

    def __init__(self, slots, degree, check=None):
        self.slots, self.degree, self.check = slots, degree, check

    def sum(self, values):
        """values [..., N, C] -> [..., V, C], in the plan's order (plain
        ops, no autograd Function, so that a backward pass may call it,
        under `vmap` too)."""
        padded = F.pad(values, (0, 0, 0, 1))  # position N: a zero row
        picked = padded.index_select(-2, self.slots.reshape(-1))
        out = picked.reshape(picked.shape[:-2] + self.slots.shape
                             + picked.shape[-1:]).sum(-2)
        if self.check is not None:
            out = torch.where(self.check, out, out.new_full((), float("nan")))
        return out


def _build_plan(flat, vertex_count, device):
    n = flat.size
    counts = np.bincount(flat, minlength=vertex_count)
    order = np.argsort(flat, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(n) - starts[flat[order]]
    table = np.full((vertex_count, max(int(counts.max(initial=0)), 1)), n,
                    dtype=np.int64)
    table[flat[order], rank] = order
    return VertexPlan(
        torch.from_numpy(table).to(device),
        torch.from_numpy(counts.astype(np.float32)).to(device))


def _plan_on_host(index, vertex_count, signature):
    """Reads the index on the host; the plan of an index of the same
    signature and values planned before, else a new one."""
    flat = index.detach().reshape(-1).cpu().numpy().astype(np.int64)
    if flat.size and (flat.min() < 0 or flat.max() >= vertex_count):
        raise ValueError(f"index values must lie in [0, {vertex_count})")
    known = _BY_SIGNATURE.setdefault(signature, [])
    for i, (_, values, plan) in enumerate(known):
        if np.array_equal(values, flat):
            known.append(known.pop(i))
            return plan
    plan = _build_plan(flat, vertex_count, index.device)
    known.append((index.detach().clone(), flat, plan))
    del known[:-_SIGNATURE_PLANS]
    return plan


def _plan_under_capture(index, signature):
    """The plan whose index equals `index`, chosen on the device among
    those planned last for its signature (the host cannot read it)."""
    known = _BY_SIGNATURE.get(signature)
    if not known:
        raise RuntimeError(
            "no vertex plan was built for an index of this shape before "
            "the CUDA-graph capture; call the step once eagerly first")
    width = max(plan.slots.shape[1] for _, _, plan in known)
    n = index.numel()
    matches = torch.stack([torch.eq(index, values).all()
                           for values, _, _ in known])
    choice = matches.to(torch.int32).argmax().reshape(1)
    slots = torch.stack([F.pad(plan.slots, (0, width - plan.slots.shape[1]),
                               value=n) for _, _, plan in known])
    degree = torch.stack([plan.degree for _, _, plan in known])
    for values, _, plan in known:
        capture.keep(values, plan.slots, plan.degree)
    return VertexPlan(slots.index_select(0, choice)[0],
                      degree.index_select(0, choice)[0], matches.any())


def vertex_plan(index: torch.Tensor, vertex_count: int) -> VertexPlan:
    """The VertexPlan of an integer index tensor (any shape) over
    `vertex_count` vertices, on the index's device.

    Built on the host and cached by the index tensor while it lives (an
    in-place write to it looks the plan up anew); an index with the
    values of one planned last for its shape reuses that plan. A
    CUDA-graph capture cannot read an index on the host: it takes the
    plan of this tensor, else, for an index made per call (such as
    `t.flip(1).contiguous()` in a step), chooses on the card, at every
    replay, the plan of the last few indices of its shape, dtype, device
    and vertex count whose values equal it, which the step's eager
    warm-up call planned (a NaN sum if none does). Inside a
    `capture.hold` block the plan's tensors join the block's list.
    """
    extra = int(vertex_count)
    signature = (tuple(index.shape), index.dtype, index.device, extra)
    plan = _cached(_PLANS, index, extra)
    if plan is None:
        if capture.capturing(index):
            return _plan_under_capture(index, signature)
        plan = _plan_on_host(index, extra, signature)
        _store(_PLANS, index, extra, plan)
    capture.keep(plan.slots, plan.degree)
    return plan


def int32_index(index: torch.Tensor) -> torch.Tensor:
    """`index.to(torch.int32)`, cast once per index tensor while it lives
    (and while it is not written in place), so that an int64 constant
    keeps one int32 copy and one plan. Callers must not write to it."""
    if index.dtype == torch.int32:
        return index
    cast = _cached(_INT32, index, None)
    if cast is None:
        cast = index.to(torch.int32)
        if not capture.capturing(index):
            _store(_INT32, index, None, cast)
    capture.keep(cast)
    return cast


def _gather(values, index):
    """values [..., V, C] -> [..., *index.shape, C]."""
    picked = values.index_select(-2, index.reshape(-1).long())
    return picked.reshape(picked.shape[:-2] + index.shape
                          + picked.shape[-1:])


def _flat_index_axes(values, index):
    """values [..., *index.shape, C] -> [..., N, C]."""
    lead = values.shape[:values.dim() - index.dim() - 1]
    return values.reshape(lead + (index.numel(), values.shape[-1]))


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, index, vertex_count):
        ctx.save_for_backward(index)
        ctx.vertex_count = vertex_count
        return _gather(values, index)

    @staticmethod
    def backward(ctx, grad):
        (index,) = ctx.saved_tensors
        plan = vertex_plan(index, ctx.vertex_count)
        return plan.sum(_flat_index_axes(grad, index)), None, None


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, index, plan):
        ctx.save_for_backward(index)
        return plan.sum(_flat_index_axes(values, index))

    @staticmethod
    def backward(ctx, grad):
        (index,) = ctx.saved_tensors
        return _gather(grad, index), None, None


def gather(values: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """values[..., index, :]: [..., V, C] -> [..., *index.shape, C], whose
    backward is `segment_sum` (a fixed order of adds, no atomic).

    Args:
      values: [..., V, C] (V on the second-to-last axis).
      index: integer tensor of any shape, on the same device, with values
        in [0, V); a constant of the caller (its plan is cached by it).
    """
    return _Gather.apply(values, index, values.shape[-2])


def segment_sum(values: torch.Tensor, index: torch.Tensor,
                vertex_count: int) -> torch.Tensor:
    """The scatter-add of `values` [..., *index.shape, C] to [..., V, C]:
    out[..., v, :] sums values[..., p, :] over the positions p of `index`
    (flattened) that hold v, in increasing p, with no atomic; the same
    bits on every run. Its backward is `gather`.
    """
    return _SegmentSum.apply(values, index, vertex_plan(index, vertex_count))


def compute_vertex_normals(vertices: torch.Tensor,
                           triangles: torch.Tensor) -> torch.Tensor:
    """Area-weighted vertex normals from face geometry.

    Face normals (scaled by 2x face area) are accumulated onto each incident
    vertex (`segment_sum`: in (triangle, corner) order, the same bits on
    every run) and the result is L2-normalized.

    Args:
      vertices: [batch_size, vertex_count, 3] f32 world-space positions.
      triangles: [triangle_count, 3] int vertex indices on the same device.

    Returns:
      [batch_size, vertex_count, 3] f32 unit normal vectors.
    """
    vertices = vertices.to(torch.float32)
    face_vertices = gather(vertices, triangles)  # [B, T, 3(corner), 3(xyz)]
    v0 = face_vertices[:, :, 0]
    v1 = face_vertices[:, :, 1]
    v2 = face_vertices[:, :, 2]
    corner_normals = torch.stack(
        [torch.linalg.cross(v1 - v0, v2 - v0, dim=-1),
         torch.linalg.cross(v2 - v1, v0 - v1, dim=-1),
         torch.linalg.cross(v0 - v2, v1 - v2, dim=-1)], dim=2)
    normals = segment_sum(corner_normals, triangles, vertices.shape[1])
    return normalize(normals, p=2, dim=-1, eps=1e-6)


def compute_edges_list(triangles) -> torch.Tensor:
    """Unique undirected edges of a triangle mesh.

    The pairs (v0, v1), (v1, v2), (v0, v2) of every face, deduplicated as
    ordered pairs and sorted, as `pytorch_mesh_renderer_tpu/ops/mesh.py:50`
    does. Computed on the host: it waits for the card and copies the
    triangles there and back, so it belongs in a loss's setup, outside a
    step that `parallel.make_train_step` captures into a CUDA graph (such
    a capture raises on the copy).

    Args:
      triangles: [triangle_count, 3] int tensor or array.

    Returns:
      [edge_count, 2] int32 tensor of unique edges, on the device of
      `triangles` (the CPU for an array).
    """
    device = triangles.device if torch.is_tensor(triangles) else "cpu"
    tris = (triangles.cpu().numpy() if torch.is_tensor(triangles)
            else np.asarray(triangles))
    edges = np.concatenate(
        [tris[:, :2], tris[:, 1:], tris[:, ::2]], axis=0).reshape(-1, 2)
    edges = np.unique(edges, axis=0).astype(np.int32)
    return torch.from_numpy(edges).to(device)
