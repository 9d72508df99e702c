"""Training steps and loops on one device.

Port of `make_train_step` and `make_train_loop` of
`pytorch_mesh_renderer_tpu/parallel/sharded.py:212-285`, in PyTorch's
idiom: the parameters are tensors that a `torch.optim` optimizer holds;
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

`mesh.py` and the `sharded_*` wrappers of the JAX module are not ported
yet.
"""

from __future__ import annotations

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from ..utils import capture


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
