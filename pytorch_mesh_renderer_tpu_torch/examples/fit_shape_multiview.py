"""Multi-view silhouette shape fitting (soft renderer): the flagship.

Port of `examples/fit_shape_multiview.py`: deform a UV sphere to match
four silhouette views of a cow (the vendored
assets/example_targets/example7b_target[1-4].png), minimizing silhouette
MSE plus edge-length and uniform-Laplacian regularizers with Adam, with
previews (the IoU line, a PNG of view 0, an OBJ) every `--preview-every`
epochs and a `--checkpoint` to save and resume. The four views render as
one batch through the silhouette path (K5 forward, K6 backward).
`--scan-chunk N` runs N steps per call of `parallel.make_train_loop` (N
replays of the captured step on the card) and previews between chunks.
`--mesh DATA,SPACE` renders through `parallel.sharded_soft_silhouette` on
a (data, space) mesh of the devices of `--device`: views over "data",
pixel rows over "space"; its output equals the unsharded render bit for
bit.

    python -m pytorch_mesh_renderer_tpu_torch.examples.fit_shape_multiview \
        --epochs 2000 --size 128 --resolution 24 --scan-chunk 100 \
        --preview-every 100 [--device cpu] [--mesh 2,2]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from .. import parallel
from ..models import shapes, soft_mesh_renderer
from ..ops import camera, losses
from ..ops import mesh as mesh_ops
from ..parallel.mesh import local_device
from ..utils import checkpoint, obj_io
from . import common

N_VIEWS = 4


def load_targets(size):
    """The four cow silhouettes [4, size, size] by nearest neighbour, or
    (None, False) when a file is missing."""
    paths = [common.target_path(f"example7b_target{i}.png")
             for i in range(1, N_VIEWS + 1)]
    if not all(os.path.exists(p) for p in paths):
        return None, False
    alphas = []
    for path in paths:
        img = common.load_png(path)
        alpha = img[..., 3] if img.shape[-1] == 4 else img.mean(-1)
        ys = np.arange(size) * alpha.shape[0] // size
        xs = np.arange(size) * alpha.shape[1] // size
        alphas.append(alpha[ys][:, xs])
    return torch.from_numpy(np.stack(alphas)), True


def cameras(device):
    """Four eyes on a horizontal ring looking at the origin: (eyes,
    centers, ups), each [4, 3]."""
    phis = np.linspace(0.0, 2 * np.pi, N_VIEWS, endpoint=False)
    eyes = np.stack([2.0 * np.sin(phis), 0.3 * np.ones(N_VIEWS),
                     2.0 * np.cos(phis)], -1).astype(np.float32)
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.tensor(eyes, **f32), torch.zeros(N_VIEWS, 3, **f32),
            torch.tensor([[0.0, 1.0, 0.0]] * N_VIEWS, **f32))


def mean_iou(alphas, targets):
    """Mean over views of the binarized IoU (threshold 0.5 on both)."""
    got = alphas > 0.5
    want = targets > 0.5
    inter = (got & want).sum(axis=(1, 2))
    union = np.maximum((got | want).sum(axis=(1, 2)), 1)
    return float(np.mean(inter / union))


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--epochs", type=int, default=250)
    parser.add_argument("--size", type=int, default=64)
    parser.add_argument("--resolution", type=int, default=20)
    parser.add_argument("--lr", type=float, default=1e-2)
    parser.add_argument("--edge-weight", type=float, default=0.3)
    parser.add_argument("--laplacian-weight", type=float, default=0.1)
    parser.add_argument("--sigma", type=float, default=3e-5)
    parser.add_argument("--gamma", type=float, default=1e-4)
    parser.add_argument("--preview-every", type=int, default=50)
    parser.add_argument("--out-prefix", type=str, default="fit_shape")
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="path to save/resume optimization state")
    parser.add_argument("--mesh", type=str, default=None, metavar="DATA,SPACE",
                        help="shard over a (data, space) device mesh, e.g. "
                             "'4,2': views over 'data', pixel rows over "
                             "'space' (views %% data == 0, size %% space == 0)")
    parser.add_argument("--scan-chunk", type=int, default=None,
                        help="run N optimizer steps per call of "
                             "parallel.make_train_loop (N replays of the "
                             "captured step on the card); previews and "
                             "checkpoints happen between chunks")
    common.add_device_argument(parser)
    return parser.parse_args(argv)


class Problem:
    """The fit's sphere, cameras, targets and loss at `args`' settings on
    `device`, rendered through the soft rasterizer `config` (None: the
    default, by device), and through `parallel.sharded_soft_silhouette`
    on `mesh` when one is given (its first device is `device`). Host-side
    setup (`compute_edges_list`, the mesh's camera matrices) happens here,
    outside the captured step."""

    def __init__(self, args, device, config=None, mesh=None):
        self.args, self.config, self.mesh = args, config, mesh
        verts0, tris, _ = shapes.sphere(0.5, resolution=args.resolution)
        self.verts0, self.tris = verts0.to(device), tris.to(device)
        self.edges = mesh_ops.compute_edges_list(self.tris)
        self.cameras = cameras(device)
        if mesh is not None:  # render_silhouette's matrices, made once
            f32 = dict(dtype=torch.float32, device=device)
            self.camera_matrices = camera.clip_space_transforms(
                *self.cameras, torch.full([N_VIEWS], 40.0, **f32),
                torch.full([N_VIEWS], 0.01, **f32),
                torch.full([N_VIEWS], 10.0, **f32), args.size, args.size)
        targets, self.from_file = load_targets(args.size)
        if self.from_file:
            self.targets = targets.to(device)
        else:
            print("[example] target silhouettes missing; fitting to a "
                  "stretched ellipsoid target")
            with torch.no_grad():
                self.targets = self.render_alphas(self.verts0 * torch.tensor(
                    [1.4, 0.7, 0.9], device=device))

    def render_alphas(self, vertices):
        # The silhouette path: the full render's alpha channel, bit for bit.
        views = vertices[None].expand(N_VIEWS, -1, -1)
        if self.mesh is not None:
            # Views shard over "data", pixel rows over "space"; the output
            # equals the unsharded render bit for bit.
            return parallel.sharded_soft_silhouette(
                self.mesh, views, self.tris, self.camera_matrices,
                self.args.size, self.args.size, sigma_val=self.args.sigma,
                config=self.config)
        return soft_mesh_renderer.render_silhouette(
            views, self.tris, *self.cameras, self.args.size, self.args.size,
            sigma_val=self.args.sigma, config=self.config)

    def loss_terms(self, offsets, target_alphas):
        """(silhouette MSE, edge loss, Laplacian loss) at verts0 +
        offsets."""
        vertices = self.verts0 + offsets
        return (losses.silhouette_mse_loss(self.render_alphas(vertices),
                                           target_alphas),
                losses.edge_loss(vertices, self.edges),
                losses.laplacian_smoothing_loss(vertices, self.edges))

    def loss(self, params, target_alphas):
        """The training loss of `parallel.make_train_step`: params is
        [offsets]."""
        sil, edge, lap = self.loss_terms(params[0], target_alphas)
        return (sil + self.args.edge_weight * edge
                + self.args.laplacian_weight * lap)


def main(argv=None, config=None, mesh=None):
    """Runs the fit; `config` is the soft rasterizer's (None: the default,
    by device; a plain-route config runs the reference on the card), and
    `mesh` a `parallel.Mesh` that takes the place of `--mesh` (one that
    repeats a device, which the flag's default device list never does)."""
    args = parse_args(argv)
    device = common.resolve_device(args.device)
    if mesh is None and args.mesh:
        data, space = (int(x) for x in args.mesh.split(","))
        mesh = parallel.make_mesh(
            data=data, space=space,
            devices=None if device.type == "cuda" else [device])
    if mesh is not None:
        device = local_device(mesh.devices.flat[0])
    problem = Problem(args, device, config, mesh)
    verts0, tris, targets = problem.verts0, problem.tris, problem.targets
    render_alphas, loss_terms = problem.render_alphas, problem.loss_terms
    loss_fn = problem.loss

    offsets = torch.zeros_like(verts0, requires_grad=True)
    if mesh is not None:
        (offsets,) = parallel.replicate(mesh, [offsets])
        targets = parallel.shard_batch(mesh, targets)
    optimizer = torch.optim.Adam([offsets], lr=args.lr,
                                 capturable=device.type == "cuda")
    start = 0
    if args.checkpoint and checkpoint.exists(args.checkpoint):
        # Before the first step: a captured step reads the optimizer's
        # state tensors where they lay at its capture.
        state = checkpoint.restore(
            args.checkpoint, {"params": [offsets],
                              "opt_state": optimizer.state_dict(),
                              "step": 0})
        with torch.no_grad():
            offsets.copy_(state["params"][0])
        # Adam is capturable on the card and not on the CPU, whichever
        # device saved the state; load_state_dict places its step counts
        # by the flag it reads.
        for group in state["opt_state"]["param_groups"]:
            group["capturable"] = device.type == "cuda"
        optimizer.load_state_dict(state["opt_state"])
        start = int(state["step"])
        print(f"[example] resumed from step {start}")

    previews = []

    def preview(epoch, loss, terms):
        with torch.no_grad():
            vertices = verts0 + offsets
            alphas = render_alphas(vertices).cpu().numpy()
        iou = mean_iou(alphas, targets.cpu().numpy())
        sil, edge, lap = (float(t) for t in terms)
        print(f"epoch {epoch}: loss {float(loss):.5f} (sil {sil:.5f} edge "
              f"{edge:.5f} lap {lap:.5f}) IoU {iou:.4f}")
        previews.append({"epoch": epoch, "loss": float(loss), "sil": sil,
                         "edge": edge, "lap": lap, "iou": iou})
        common.save_png(f"{args.out_prefix}_view0_{epoch:04d}.png",
                        alphas[0][..., None].repeat(3, -1))
        obj_io.save_obj(f"{args.out_prefix}_{epoch:04d}.obj", vertices, tris)
        if args.checkpoint:
            checkpoint.save(args.checkpoint,
                            {"params": [offsets.detach()],
                             "opt_state": optimizer.state_dict(),
                             "step": epoch + 1})

    history = []  # the losses of the steps run, one tensor a call
    clock = None  # (host time, epoch) once the first call has finished

    def first_call_done(epoch):
        nonlocal clock
        if clock is None:  # the first call builds and captures: not timed
            common.synchronize(device)
            clock = (time.perf_counter(), epoch)

    if args.scan_chunk:
        # K steps per call; the loss terms are evaluated again (one
        # forward) only at chunk ends, for the log. The last chunk is
        # sized to the remaining steps, so exactly --epochs steps run and
        # the checkpoint's step stays true; at most two loop lengths are
        # captured.
        loops = {}
        epoch = start
        while epoch < args.epochs:
            k = min(args.scan_chunk, args.epochs - epoch)
            if k not in loops:
                loops[k] = parallel.make_train_loop(loss_fn, optimizer, k)
            chunk_losses = loops[k](targets)
            history.append(chunk_losses)
            epoch += k
            first_call_done(epoch)
            with torch.no_grad():
                terms = loss_terms(offsets, targets)
            preview(epoch - 1, chunk_losses[-1], terms)
    else:
        step = parallel.make_train_step(loss_fn, optimizer)
        for epoch in range(start, args.epochs):
            logged = (epoch % args.preview_every == 0
                      or epoch == args.epochs - 1)
            if logged:  # the terms at the step's parameters, as JAX logs
                with torch.no_grad():
                    terms = loss_terms(offsets, targets)
            loss = step(targets)
            history.append(loss[None])
            first_call_done(epoch + 1)
            if logged:
                preview(epoch, loss, terms)

    history = torch.cat(history).tolist() if history else []
    vertices = (verts0 + offsets).detach()
    obj_io.save_obj(f"{args.out_prefix}_final.obj", vertices, tris)
    print(f"wrote {args.out_prefix}_final.obj")
    steps_per_s = (common.steps_per_second(
        clock[0], args.epochs - clock[1], device) if clock else float("nan"))
    print(f"{steps_per_s:.1f} steps/s after the first call, previews "
          f"included ({device.type})")
    return {"previews": previews, "vertices": vertices.cpu().numpy(),
            "targets_from_file": problem.from_file, "losses": history,
            "steps_per_s": steps_per_s}


if __name__ == "__main__":
    main()
