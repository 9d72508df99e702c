"""Device meshes for sharded rendering.

Port of `pytorch_mesh_renderer_tpu/parallel/mesh.py`: a 2D logical mesh
over devices, with two axes:

  * "data"  shards the batch of meshes (data parallelism). Rendering is
    batch-independent, so the forward pass needs no collective;
  * "space" shards the pixel rows of each image (spatial parallelism).
    Both rasterizers take `row_offset`/`full_height`, so each cell renders
    only its strip; the vertex gradients of the strips are partial sums.

The design is single-controller, as JAX's `shard_map` is: one process
holds the mesh and the caller's global tensors on the mesh's first device,
and `parallel.sharded_*` run every cell on its own device and assemble
the cells there, autograd adding the strips' gradients (the `psum`s that
JAX inserts). A `Mesh` carries what the JAX code reads of
`jax.sharding.Mesh`: `devices` (a numpy object array of shape (data,
space)), `axis_names` and `shape`.

Its devices are `torch.device`s. An explicit device list may name one
device more than once: the counterpart of the JAX tests' virtual host
devices, so a 4x2 mesh runs on the CPU and a 2x2 mesh on one card. The
default list (`make_mesh`'s, `single_device_mesh`'s) never repeats one:
every CUDA device, else the CPU.

Several processes: `init_distributed` wraps
`torch.distributed.init_process_group` and gathers every rank's local
devices into a global list of `ProcessDevice`s, which the default lists
then are and which `order_devices_for_dcn` orders so that "space" stays
within a process. Every rank then runs the same program on the same
global tensors, as every JAX process does. Each cell of a mesh is either
this rank's (an entry of this process: a `torch.device`, or a
`ProcessDevice` of this rank) or another rank's (`owner`), and the
sharded wrappers render this rank's cells only: `parallel/collectives.py`
assembles every rank's cells on every rank and adds the ranks' partial
gradients, the collectives that XLA inserts. A mesh whose entries all
belong to this process runs every cell here, as before, with no
collective. An entry that names a rank outside the group (or, with no
group, any rank but 0) raises `ValueError`.

Ranks that share one card take `backend="gloo"` (NCCL refuses two ranks
on one card, and `init_distributed` then raises, naming gloo); NCCL takes
one rank per card. `utils/ranks.py` starts N ranks of a job.
"""

from __future__ import annotations

import dataclasses
import os
import socket

import numpy as np
import torch

DATA_AXIS = "data"
SPACE_AXIS = "space"

# The global device list after init_distributed (None before).
_GLOBAL_DEVICES = None


@dataclasses.dataclass(frozen=True)
class ProcessDevice:
    """A device of the global list: the rank of the process that owns it,
    its id in the list, and its `torch.device` on that process."""
    process_index: int
    id: int
    device: torch.device


class Mesh:
    """A (data, space) grid of devices, the port's `jax.sharding.Mesh`."""

    def __init__(self, devices, axis_names=(DATA_AXIS, SPACE_AXIS)):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"devices of shape {self.devices.shape} for "
                             f"axes {self.axis_names}")

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self):
        return self.devices.size

    def __repr__(self):
        return f"Mesh({self.shape}, devices={self.devices.ravel().tolist()})"


def process_index() -> int:
    """This process's rank (0 without init_distributed)."""
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank()
    return 0


def _local_devices():
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def global_devices():
    """Every process's devices after init_distributed (`ProcessDevice`s),
    else this process's: every CUDA device, else the CPU."""
    return list(_GLOBAL_DEVICES) if _GLOBAL_DEVICES else _local_devices()


def _as_device(entry):
    return torch.device(entry) if isinstance(entry, str) else entry


def make_mesh(data: int | None = None, space: int = 1, devices=None) -> Mesh:
    """Builds a (data, space) logical mesh over the available devices.

    Args:
      data: size of the batch-sharding axis. Defaults to
        n_devices // space.
      space: size of the image-row-sharding axis.
      devices: optional explicit device list (defaults to
        `global_devices()`); it may repeat a device.

    Returns:
      a Mesh with axes ("data", "space").
    """
    if devices is None:
        devices = global_devices()
    devices = [_as_device(d) for d in devices]
    n = len(devices)
    if data is None:
        if n % space != 0:
            raise ValueError(
                f"{n} devices are not divisible by space={space}.")
        data = n // space
    if data * space > n:
        raise ValueError(
            f"Mesh {data}x{space} needs {data * space} devices, have {n}.")
    grid = np.empty(data * space, dtype=object)
    grid[:] = devices[:data * space]
    return Mesh(grid.reshape(data, space), (DATA_AXIS, SPACE_AXIS))


def single_device_mesh() -> Mesh:
    """A trivial 1x1 mesh (so the sharded API also runs on one device)."""
    return make_mesh(data=1, space=1, devices=global_devices()[:1])


def _card(device):
    """What names a card across processes: its UUID where torch reports
    one, else its index (None for the CPU)."""
    if device.type != "cuda":
        return None
    uuid = getattr(torch.cuda.get_device_properties(device), "uuid", None)
    return str(uuid) if uuid is not None else f"cuda:{device.index}"


def shared_cards(gathered):
    """{(host, card): [ranks]} of the cards that more than one rank holds,
    from each rank's (host, [(device name, card), ...]) in rank order."""
    holders: dict = {}
    for rank, (host, devices) in enumerate(gathered):
        for _, card in devices:
            if card is not None:
                holders.setdefault((host, card), []).append(rank)
    return {key: ranks for key, ranks in holders.items() if len(ranks) > 1}


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     local_device_ids=None, backend: str | None = None
                     ) -> None:
    """Opt-in multi-process initialization.

    Wraps `torch.distributed.init_process_group`: call it once per process
    at program start, with the coordinator's "host:port" (else the
    `MASTER_ADDR`/`MASTER_PORT` environment, `env://`), the world size
    (else `WORLD_SIZE`, default 1) and this process's rank (else `RANK`,
    default 0). The process's devices are the CUDA devices of
    `local_device_ids` (default: every CUDA device), else the CPU.
    `backend` None takes NCCL for CUDA devices and gloo for the CPU;
    "gloo" may also serve CUDA devices, for ranks that share one card
    (the collectives then pass through host memory). Then every rank's
    devices are gathered once (`all_gather_object`, over gloo), so
    `global_devices()`, `make_mesh` and `make_multihost_mesh` span every
    process. Under NCCL, two ranks that hold one card raise
    `RuntimeError` (naming `backend="gloo"`) after the group is torn
    down: nothing switches transport by itself.

    Safe to call when already initialized (a no-op) and in a
    single-process run (num_processes=1).
    """
    global _GLOBAL_DEVICES
    if torch.distributed.is_initialized():
        return
    if local_device_ids is not None:
        local = [torch.device("cuda", int(i)) for i in local_device_ids]
    else:
        local = _local_devices()
    cuda = local[0].type == "cuda"
    if backend is None:
        backend = "nccl" if cuda else "gloo"
    if cuda:
        torch.cuda.set_device(local[0])
    init_method = (f"tcp://{coordinator_address}" if coordinator_address
                   else "env://")
    world = (num_processes if num_processes is not None
             else int(os.environ.get("WORLD_SIZE", "1")))
    rank = (process_id if process_id is not None
            else int(os.environ.get("RANK", "0")))
    torch.distributed.init_process_group(
        backend, init_method=init_method, world_size=world, rank=rank)
    # Gathered over gloo: an NCCL collective would fail on a shared card
    # before the check below could name it.
    group = (None if torch.distributed.get_backend() == "gloo"
             else torch.distributed.new_group(backend="gloo"))
    gathered = [None] * world
    torch.distributed.all_gather_object(
        gathered, (socket.gethostname(), [(str(d), _card(d)) for d in local]),
        group=group)
    shared = shared_cards(gathered)
    if shared and torch.distributed.get_backend() == "nccl":
        torch.distributed.destroy_process_group()
        (host, card), ranks = next(iter(shared.items()))
        raise RuntimeError(
            f"ranks {ranks} hold one card ({card} on {host}), which NCCL "
            "refuses; give each rank its own card (local_device_ids), or "
            "call init_distributed(..., backend=\"gloo\") for ranks that "
            "share a card")
    _GLOBAL_DEVICES = [
        ProcessDevice(proc, i, torch.device(name)) for i, (proc, name) in
        enumerate((p, name) for p, (_, devices) in enumerate(gathered)
                  for name, _ in devices)]


def _process_of(device):
    return getattr(device, "process_index", process_index())


def _id_of(device):
    if hasattr(device, "id"):
        return device.id
    return device.index or 0


def order_devices_for_dcn(devices, space: int):
    """Orders devices so `space` stays within a process and `data` spans
    processes.

    The (data, space) grid is filled row-major, so consecutive devices
    share a data row (the `space` axis), whose strips' gradients are added
    on every step. This sorts devices by (process_index, id) (a
    `torch.device`: this process, its index) and checks that each process
    contributes a multiple of `space` devices, so that no space group
    straddles a process boundary.
    """
    devs = sorted(devices, key=lambda d: (_process_of(d), _id_of(d)))
    counts: dict[int, int] = {}
    for d in devs:
        counts[_process_of(d)] = counts.get(_process_of(d), 0) + 1
    for proc, count in counts.items():
        if count % space != 0:
            raise ValueError(
                f"space={space} does not divide process {proc}'s "
                f"{count} local devices; a space group would span DCN. "
                "Choose space to divide the per-host device count.")
    return devs


def make_multihost_mesh(space: int = 1, devices=None) -> Mesh:
    """A (data, space) mesh over ALL processes' devices.

    Call `init_distributed()` first in each process. The `space` axis is
    kept within a process, the `data` axis spans processes (see
    order_devices_for_dcn).
    """
    if devices is None:
        devices = global_devices()
    devs = order_devices_for_dcn(devices, space)
    return make_mesh(space=space, devices=devs)


def owner(mesh_device) -> int:
    """The rank whose cell a mesh entry is: a `ProcessDevice`'s
    process_index, which must name a rank of the group (0 when there is
    none); this process's for a `torch.device`."""
    if not isinstance(mesh_device, ProcessDevice):
        return process_index()
    rank = mesh_device.process_index
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        world = torch.distributed.get_world_size()
        if not 0 <= rank < world:
            raise ValueError(
                f"the mesh holds {mesh_device}, a device of rank {rank}, "
                f"outside the group of {world} ranks")
    elif rank != 0:
        raise ValueError(
            f"the mesh holds {mesh_device}, a device of rank {rank}, and "
            "there is no process group: call init_distributed first")
    return rank


def local_device(mesh_device) -> torch.device:
    """The `torch.device` of a mesh entry on the process that owns it
    (`owner`, which checks the entry's rank)."""
    owner(mesh_device)
    if isinstance(mesh_device, ProcessDevice):
        return mesh_device.device
    return mesh_device
