"""Sharded rendering, and training steps and loops.

Port of `pytorch_mesh_renderer_tpu/parallel/sharded.py`. The sharded
wrappers `sharded_rasterize`, `sharded_soft_rasterize` and
`sharded_soft_silhouette` (`sharded.py:73-210`) take a `parallel.Mesh`
(parallel/mesh.py) and the global tensors on this process's first mesh
device, split the batch into `data` slices and the rows into `space`
strips of H / s, run each cell's rasterizer on the cell's device
(`row_offset = j * H / s`, `full_height = H`; the backend follows the
device as everywhere in the port: the kernels on a card, with no
fallback) and concatenate the cells on that first device. Autograd
through those copies and concatenations adds the strips' partial vertex
gradients: the `psum`s that JAX inserts through `shard_map`. Shading,
losses and the optimizer run on the assembled tensors, as they stay
outside `shard_map` in JAX; so the specular shader's normalisation over
all pixels needs no all-reduce. `shard_batch` and `replicate` place a
pytree on this process's first mesh device, where the caller's global
tensors live (`shard_batch` checks that axis 0 divides over `data`).

On a mesh that spans processes (after `init_distributed`; every rank
runs the same program on the same global tensors) each rank renders only
its own cells (`mesh.owner`): the tensors that enter the cells pass
through `collectives.replicated`, whose backward adds their gradients over
the ranks, and `collectives.assemble` gathers every rank's cells so that
each rank holds the whole output, bit for bit the unsharded render. Every
rank must own a cell of the mesh. On a mesh of one process nothing of this
runs.

A captured training step (below) may call a wrapper on a mesh over one
card, repeated or 1x1. A capture of a wrapper on a mesh over several
distinct devices raises (ROADMAP.md Queue 1, "multi-card capture"), and
so does one on a mesh that spans processes, whose collectives cannot be
captured: such a step runs eagerly, called as `step.run_eager(batch)`.

`make_train_step` and `make_train_loop` port `sharded.py:212-285` in
PyTorch's idiom: the parameters are tensors that a `torch.optim` optimizer holds;
a step takes the gradient of `loss_fn(params, batch)` and lets the
optimizer update them in place. On a card the step is the counterpart of
`jax.jit`: its first call runs eagerly on a side stream (the warm-up: the
kernels' build and load, the optimizer's state) and then captures the
gradient and the update once into a `torch.cuda.CUDAGraph` (PyTorch's
whole-network capture); every later call copies its batch into the
graph's static inputs and replays it. The loop replays that graph K
times, the counterpart of `lax.scan` over K steps, which in JAX exists to
amortise the host's dispatch floor (`sharded.py:250-256`): a replay
launches the step's hundreds of kernels in one call. On the CPU both run
eagerly, the same function.

Nothing is donated (the JAX functions' `donate`): the updates happen in
place, on the tensors the optimizer holds.

What a captured step may do: everything on the card, with shapes fixed
at the capture. Host syncs, copies from the host and allocations of a
size that depends on values raise in the capture (the renderers avoid
them, `utils/capture.py`); such setup, as `ops/mesh.compute_edges_list`,
belongs outside `loss_fn`. A capture that fails raises: the step never
falls back to eager execution on the card. An optimizer with a
`capturable` flag must be built with `capturable=True` on the card
(`torch.optim.Adam(params, lr, capturable=True)`) and without it on the
CPU, which refuses it. The kernels' launch counters
(`ops/rasterize_cuda.LAUNCHES` and the others) count the launches made
while capturing, once, and none of the replays.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from ..ops import camera
from ..ops import rasterize as rasterize_lib
from ..ops import soft_rasterize as soft_rasterize_lib
from ..utils import capture
from . import collectives
from .mesh import DATA_AXIS, SPACE_AXIS, local_device, owner, process_index


def _first_device(mesh):
    """This process's first device of the mesh, in row-major order, after
    checking every entry's rank."""
    rank = process_index()
    mine = [d for d in mesh.devices.flat if owner(d) == rank]
    if not mine:
        raise ValueError(f"no device of {mesh} belongs to process {rank}: "
                         "every rank must own a cell of the mesh")
    return local_device(mine[0])


def _place(x, device):
    """A tensor or numpy array on `device` (a leaf that requires a
    gradient stays one); other leaves as they are."""
    if isinstance(x, np.ndarray):
        return torch.as_tensor(x, device=device)
    if not torch.is_tensor(x) or x.device == device:
        return x
    if x.is_leaf and x.requires_grad:
        return x.detach().to(device).requires_grad_(True)
    return x.to(device)


def shard_batch(mesh, tree):
    """Places a pytree of batched tensors (axis 0 the batch) for a mesh:
    on this process's first mesh device, after checking that axis 0
    divides over "data"."""
    n_data = mesh.shape[DATA_AXIS]
    for leaf in tree_flatten(tree)[0]:
        if (torch.is_tensor(leaf) or isinstance(leaf, np.ndarray)) and (
                leaf.ndim == 0 or leaf.shape[0] % n_data != 0):
            raise ValueError(
                f"a leaf of shape {tuple(leaf.shape)} does not divide over "
                f"the data axis ({n_data}) on its axis 0")
    device = _first_device(mesh)
    return tree_map(lambda x: _place(x, device), tree)


def replicate(mesh, tree):
    """Places a pytree (e.g. trainable params) for a mesh: on this
    process's first mesh device, from which its cells read it."""
    device = _first_device(mesh)
    return tree_map(lambda x: _place(x, device), tree)


def _check_cells(mesh, height, batch):
    """(rows per strip, images per slice), after JAX's checks."""
    n_space = mesh.shape[SPACE_AXIS]
    n_data = mesh.shape[DATA_AXIS]
    if height % n_space != 0:
        raise ValueError(
            f"image_height={height} must divide over the space axis "
            f"({n_space}).")
    if batch % n_data != 0:
        raise ValueError(
            f"batch={batch} must divide over the data axis ({n_data}).")
    return height // n_space, batch // n_data


def _run_cells(mesh, height, batch, capturing, inputs, render):
    """render(device, images, row_offset, local_height, *inputs) per cell
    of this process, on the cell's device; the cells concatenated on this
    process's first mesh device, strips along axis 1 in order, slices
    along axis 0 (`collectives.assemble` on a mesh that spans
    processes, the inputs then passed through `collectives.replicated`)."""
    local_h, per = _check_cells(mesh, height, batch)
    first = _first_device(mesh)
    rank = process_index()
    owners = [[owner(d) for d in row] for row in mesh.devices]
    devices = [[local_device(d) for d in row] for row in mesh.devices]
    spans = any(r != rank for row in owners for r in row)
    if capturing and spans:
        raise RuntimeError(
            f"a CUDA-graph capture of a sharded render on a mesh that spans "
            f"processes ({mesh}) is not supported: its collectives cannot "
            "be captured; run the step eagerly, step.run_eager(batch)")
    if capturing and len({d for row in devices for d in row}) > 1:
        raise RuntimeError(
            f"a CUDA-graph capture of a sharded render on a mesh over "
            f"several devices ({mesh}) is not supported (ROADMAP.md Queue "
            "1, \"multi-card capture\"); run the step eagerly, "
            "step.run_eager(batch), or on a mesh over one card")

    if spans:
        inputs = collectives.replicated(*inputs)

    def cell(i, j):
        return render(devices[i][j], slice(i * per, (i + 1) * per),
                      j * local_h, local_h, *inputs).to(first)

    if spans:
        own = [cell(i, j) for i, row in enumerate(owners)
               for j, r in enumerate(row) if r == rank]
        return collectives.assemble(owners, per, local_h, own)
    return torch.cat([torch.cat([cell(i, j) for j in range(len(row))],
                                dim=1) for i, row in enumerate(devices)],
                     dim=0)


def _on(x, device, images=None):
    """x (a tensor, else as it is) on `device`, its axis 0 cut to
    `images`."""
    if not torch.is_tensor(x):
        return x
    return (x if images is None else x[images]).to(device)


def _triangles_on(triangles, device):
    if torch.is_tensor(triangles):
        return triangles.to(device)
    return capture.constant(np.ascontiguousarray(triangles), device,
                            torch.int32)


def sharded_rasterize(mesh, world_space_vertices, attributes, triangles,
                      camera_matrices, image_width, image_height,
                      background_value, config=None):
    """`ops.rasterize.rasterize` distributed over a (data, space) mesh.

    The batch shards over "data"; pixel rows shard over "space", each cell
    rasterizing rows [j*H/s, (j+1)*H/s) of the kernel's bottom-up row
    order. Returns the assembled [batch, H, W, A] attribute image on the
    mesh's first device, bit for bit the unsharded op's.
    """
    clip = camera.transform_homogeneous(camera_matrices,
                                        world_space_vertices)

    def render(device, images, row_offset, local_h, clip, attributes,
               background_value):
        return rasterize_lib.rasterize_clip_space(
            _on(clip, device, images), _on(attributes, device, images),
            _triangles_on(triangles, device), image_width, local_h,
            _on(background_value, device), config=config,
            row_offset=row_offset, full_height=image_height)

    return _run_cells(mesh, image_height, world_space_vertices.shape[0],
                      capture.capturing(clip),
                      (clip, attributes, background_value), render)


def sharded_soft_rasterize(mesh, world_space_vertices, triangles, normals,
                           diffuse_colors, light_positions,
                           light_intensities, camera_matrices, image_width,
                           image_height, sigma_val, gamma_val,
                           blur_radius=0.01, config=None):
    """`ops.soft_rasterize.rasterize` distributed over a (data, space) mesh.

    Same layout as `sharded_rasterize`; the soft kernels' rows are
    top-down, so strip j covers top-down rows [j*H/s, (j+1)*H/s) and the
    assembled output equals the unsharded render bit for bit.
    """
    clip = camera.transform_homogeneous(camera_matrices,
                                        world_space_vertices)

    def render(device, images, row_offset, local_h, clip, *rest):
        *batched, sigma, gamma = rest
        return soft_rasterize_lib.rasterize_clip_space_batch(
            _on(clip, device, images), _triangles_on(triangles, device),
            *(_on(x, device, images) for x in batched), image_width,
            local_h, _on(sigma, device), _on(gamma, device),
            blur_radius=blur_radius, config=config, row_offset=row_offset,
            full_height=image_height)

    return _run_cells(mesh, image_height, world_space_vertices.shape[0],
                      capture.capturing(clip),
                      (clip, world_space_vertices, normals, diffuse_colors,
                       light_positions, light_intensities, sigma_val,
                       gamma_val), render)


def sharded_soft_silhouette(mesh, world_space_vertices, triangles,
                            camera_matrices, image_width, image_height,
                            sigma_val, blur_radius=0.01, config=None):
    """Silhouette-only soft render distributed over a (data, space) mesh.

    The sharded counterpart of `soft_mesh_renderer.render_silhouette`
    (K5 and K6 on a card): each space-axis strip renders top-down rows
    [j*H/s, (j+1)*H/s) of the [B, H, W] alpha image; the assembled output
    equals the unsharded silhouette bit for bit.
    """
    clip = camera.transform_homogeneous(camera_matrices,
                                        world_space_vertices)

    def render(device, images, row_offset, local_h, clip, sigma):
        return soft_rasterize_lib.rasterize_silhouette_clip_space_batch(
            _on(clip, device, images), _triangles_on(triangles, device),
            image_width, local_h, _on(sigma, device),
            blur_radius=blur_radius, config=config, row_offset=row_offset,
            full_height=image_height)

    return _run_cells(mesh, image_height, world_space_vertices.shape[0],
                      capture.capturing(clip), (clip, sigma_val), render)


def _params(optimizer):
    return [p for group in optimizer.param_groups for p in group["params"]]


def _hyperparameters(optimizer):
    """Each param group's entries that a capture fixes: all but the
    parameters and the tensors (which the graph reads at each replay)."""
    def fixed(value):
        items = value if isinstance(value, (tuple, list)) else (value,)
        return not any(torch.is_tensor(v) for v in items)
    return [{k: v for k, v in group.items() if k != "params" and fixed(v)}
            for group in optimizer.param_groups]


def _same_leaf(leaf, static):
    """Whether a batch leaf may stand where the capture had `static`: a
    tensor of its shape and dtype, or an equal constant."""
    if torch.is_tensor(static):
        return torch.is_tensor(leaf) and (
            (leaf.shape, leaf.dtype) == (static.shape, static.dtype))
    return not torch.is_tensor(leaf) and leaf == static


_MISSING = object()


class TrainStep:
    """`step(batch) -> loss` (0-D, on the parameters' device); see
    make_train_step."""

    def __init__(self, loss_fn, optimizer):
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.params = _params(optimizer)
        devices = {p.device for p in self.params}
        if len(devices) != 1:
            raise ValueError(f"the optimizer's parameters lie on {devices}; "
                             "a step runs on one device")
        (self.device,) = devices
        self.graph = None
        self.static = None  # (leaves, spec): the batch the graph reads
        self.static_loss = None
        self.constants = None  # capture.constant's arrays the graph reads
        self.hyperparameters = None  # _hyperparameters at the capture

    def run_eager(self, batch):
        """One step without capture, on the current stream: the function
        that the graph captures. Returns the loss, detached."""
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss_fn(self.params, batch)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def __call__(self, batch):
        if self.device.type != "cuda":
            return self.run_eager(batch)
        if self.graph is None:
            return self._warm_up_and_capture(batch)
        self._load(batch)
        self.graph.replay()
        return self.static_loss.clone()

    def _load(self, batch):
        """Copy `batch`'s tensors into the static inputs, after checking
        that the batch and the optimizer's hyperparameters are as at the
        capture."""
        leaves, spec = tree_flatten(batch)
        static, static_spec = self.static
        if spec != static_spec or not all(
                _same_leaf(t, s) for t, s in zip(leaves, static)):
            raise ValueError(
                "the batch differs from the captured one in its structure, "
                "its constants or a tensor's shape or dtype; build a new "
                "step for it")
        now = _hyperparameters(self.optimizer)
        if len(now) != len(self.hyperparameters):
            raise ValueError("the optimizer's param groups changed since "
                             "the capture; build a new step")
        for group, then in zip(now, self.hyperparameters):
            for key in sorted(group.keys() | then.keys()):
                if group.get(key, _MISSING) != then.get(key, _MISSING):
                    raise ValueError(
                        f"the optimizer's {key!r} changed since the capture, "
                        "which fixed it; to change it between steps give it "
                        "as a tensor (Adam(lr=torch.tensor(...), "
                        "capturable=True)), or build a new step")
        for t, s in zip(leaves, static):
            if torch.is_tensor(t) and t.data_ptr() != s.data_ptr():
                s.copy_(t)

    def _warm_up_and_capture(self, batch):
        if any(group.get("capturable") is False
               for group in self.optimizer.param_groups):
            raise ValueError(
                f"{type(self.optimizer).__name__} has capturable=False; "
                "build it with capturable=True to capture its step")
        leaves, spec = tree_flatten(batch)
        self.static = ([t.detach().to(self.device, copy=True)
                        if torch.is_tensor(t) else t for t in leaves], spec)
        static_batch = tree_unflatten(self.static[0], spec)
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            loss = self.run_eager(static_batch)
        current.wait_stream(side)
        # The graph's backward allocates the gradients from its own pool.
        self.optimizer.zero_grad(set_to_none=True)
        graph = torch.cuda.CUDAGraph()
        with capture.hold() as constants, torch.cuda.graph(graph):
            static_loss = self.loss_fn(self.params, static_batch)
            static_loss.backward()
            self.optimizer.step()
        self.graph, self.static_loss = graph, static_loss.detach()
        self.constants = constants
        self.hyperparameters = _hyperparameters(self.optimizer)
        return loss


class TrainLoop:
    """`loop(batch) -> losses` ([steps_per_call], in order); see
    make_train_loop."""

    def __init__(self, loss_fn, optimizer, steps_per_call):
        self.step = TrainStep(loss_fn, optimizer)
        self.steps_per_call = steps_per_call

    def __call__(self, batch):
        step, k = self.step, self.steps_per_call
        losses = torch.empty(k, dtype=torch.float32, device=step.device)
        first = 0
        if step.device.type == "cuda" and step.graph is not None:
            step._load(batch)
        else:
            losses[0] = step(batch)
            first = 1
        for i in range(first, k):
            if step.graph is None:
                losses[i] = step.run_eager(batch)
            else:
                step.graph.replay()
                losses[i].copy_(step.static_loss)
        return losses


def make_train_step(loss_fn, optimizer):
    """Builds a training step: gradient, then the optimizer's update.

    Args:
      loss_fn: (params, batch) -> scalar loss tensor. `params` is the list
        of the optimizer's parameters, in the order of its param groups.
      optimizer: a torch.optim optimizer over tensors on one device
        (`capturable=True` on a card where it has the flag; see the module
        docstring).

    Returns:
      step(batch) -> loss, a 0-D tensor on the parameters' device: the loss
      at the parameters before the update, which the step makes in place.
      `batch` is a tensor or a dict, list or tuple of them (nested, with
      constants). On a card the first call runs eagerly and captures the
      step; later calls copy the batch's tensors into the captured inputs
      (their shapes, dtypes and the constants must stay) and replay it.
      The capture also fixes the optimizer's hyperparameters that are not
      tensors (a float `lr`, `betas`, `weight_decay`): a call after one of
      them changed raises. A learning-rate schedule on a card therefore
      needs a tensor `lr`, which the scheduler fills in place
      (`Adam(params, lr=torch.tensor(1e-2, device="cuda"),
      capturable=True)`). `step.run_eager(batch)` runs one step without
      the graph.
    """
    if optimizer is None:
        raise ValueError("optimizer is required (e.g. torch.optim.Adam).")
    return TrainStep(loss_fn, optimizer)


def make_train_loop(loss_fn, optimizer, steps_per_call):
    """Like `make_train_step`, but `steps_per_call` steps in one call: on a
    card, replays of the captured step (the first call's first step runs
    eagerly and captures it), the batch copied in once.

    Returns:
      loop(batch) -> losses, a [steps_per_call] f32 tensor on the
      parameters' device, one loss per step in order: exactly
      `steps_per_call` applications of make_train_step's step with a fixed
      batch. Call it in chunks and read the losses between them.
    """
    if optimizer is None:
        raise ValueError("optimizer is required (e.g. torch.optim.Adam).")
    if steps_per_call < 1:
        raise ValueError("steps_per_call must be >= 1")
    return TrainLoop(loss_fn, optimizer, steps_per_call)
