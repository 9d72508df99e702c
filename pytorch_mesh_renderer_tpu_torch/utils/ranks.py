"""Start N ranks of one program, and the job that holds multi-process
sharding to the unsharded renders.

Every rank runs the same program on the same global inputs (made from
fixed seeds), joins the group with `parallel.init_distributed` and renders
its own cells of each mesh (`parallel/sharded.py`). `run` starts the
ranks as subprocesses on this host, each with a timeout of its own, and
fails if one fails or hangs (the others are then stopped). On the CPU the
ranks take gloo; on one card they share it, which NCCL refuses, so they
take gloo too (`--backend gloo`); NCCL takes one rank per card
(`--backend nccl`, rank r on card r).

    # from the repository root: 2 ranks on the CPU, the small job
    python -m pytorch_mesh_renderer_tpu_torch.utils.ranks --world 2 \\
        --device cpu --out /tmp/ranks
    # 2 ranks sharing one card (gloo), the full-width job
    python -m pytorch_mesh_renderer_tpu_torch.utils.ranks --world 2 \\
        --device cuda --job full --out /tmp/ranks

Each rank writes `rank<r>.pt` (the cases' outputs, gradients, parameters,
whether two runs gave the same output bits (`repeat`; for the steps the
same losses and parameters) and the largest difference of their
gradients or parameters (`spread`: K2 and K8 add with float atomics, so
on a card their gradients' last bits vary from run to run), and the
kernels' launches in this rank) and `rank<r>.log` into `--out`;
the caller holds them to its own unsharded run (`case_fns` builds the
same renders without a mesh): `tests/test_torch_multiprocess.py` on the
CPU, `chip_smoke.py` phase 17 on the card.

The job ("small": `tests/test_torch_parallel.py`'s cube at 16x16 batch 4
and sphere at 16x16, the cow fit at 16x16 and sphere resolution 8;
"full": the teapot at 256x256 batch 4 hard and 128x128 batch 4 soft, the
cow fit at 128x128, 4 views, resolution 24) runs each case of `PLAN` on
each of its meshes (`make_mesh`), twice: "hard" (the hard rasterizer, or
render), "soft" (the soft rasterizer, or render) and "silhouette", each
output with the vertex gradient of mean(out^2), and "steps" (eager Adam
steps of the cow fit through `step.run_eager`). On a card it also shows that a captured step on the
mesh raises, and times the eager fit step.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

from . import capture

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MODULE = "pytorch_mesh_renderer_tpu_torch.utils.ranks"

# (job, world) -> {case: [mesh names]}.
PLAN = {
    ("small", 2): {"hard": ["2x1", "2x2list"], "soft": ["2x1", "2x2list"],
                   "silhouette": ["2x1"], "steps": ["2x1"]},
    ("small", 4): {"hard": ["4x1"], "soft": ["4x1"], "silhouette": ["4x1"],
                   "steps": ["4x1"]},
    ("full", 2): {"hard": ["2x1", "2x2list"], "soft": ["2x1"],
                  "steps": ["2x1"]},
    ("full", 4): {"hard": ["4x1"]},
}
STEPS = {"small": 3, "full": 5}
FIT_ARGS = {"small": ["--size", "16", "--resolution", "8"],
            "full": ["--size", "128", "--resolution", "24"]}
# The eager fit step's timing on a card: calls per window.
TIMED_STEPS = 10


def make_mesh(name, devices=None):
    """A mesh by name over `devices` (default: `parallel.global_devices()`,
    one entry per rank after init_distributed): "DxS" the first D * S
    devices; "2x2list" the explicit list [d0, d0, d1, d1], each of the
    first two devices holding one data row of two strips."""
    from .. import parallel

    devices = parallel.global_devices() if devices is None else devices
    if name == "2x2list":
        return parallel.make_mesh(2, 2, devices=[devices[0], devices[0],
                                                 devices[1], devices[1]])
    data, space = (int(n) for n in name.split("x"))
    return parallel.make_mesh(data, space, devices=devices[:data * space])


def cube_scene(batch=4, size=16):
    """tests/test_parallel.py's cube scene, as numpy arrays: (vertices,
    triangles, attributes, camera matrices)."""
    from ..models import shapes
    from ..ops import camera

    verts, tris, _ = shapes.cube(2.0)
    verts = verts[None].repeat(batch, 1, 1)
    angles = torch.stack([torch.linspace(0.1, 0.5, batch),
                          torch.linspace(-0.3, 0.4, batch),
                          torch.zeros(batch)], dim=-1)
    rot = camera.euler_matrices(angles)[:, :3, :3]
    verts = torch.einsum("bij,bvj->bvi", rot, verts)
    cams = camera.clip_space_transforms(
        torch.tensor([[0.0, 0.0, 6.0]]).repeat(batch, 1),
        torch.zeros(batch, 3),
        torch.tensor([[0.0, 1.0, 0.0]]).repeat(batch, 1),
        torch.full([batch], 40.0), torch.full([batch], 0.01),
        torch.full([batch], 10.0), size, size)
    attrs = torch.linspace(0.0, 1.0, verts.shape[1] * 3).reshape(
        1, verts.shape[1], 3).repeat(batch, 1, 1)
    return verts.numpy(), tris.numpy(), attrs.numpy(), cams.numpy()


def sphere_scene(batch=2, size=16):
    """tests/test_parallel.py's sphere scene: (vertices, triangles,
    colours, lights, intensities, camera matrices), numpy arrays."""
    from ..models import shapes
    from ..ops import camera

    verts, tris, _ = shapes.sphere(1.0, resolution=6)
    verts = verts[None].repeat(batch, 1, 1)
    cams = camera.clip_space_transforms(
        torch.tensor([[0.0, 0.0, 4.0]]).repeat(batch, 1),
        torch.zeros(batch, 3),
        torch.tensor([[0.0, 1.0, 0.0]]).repeat(batch, 1),
        torch.full([batch], 40.0), torch.full([batch], 0.01),
        torch.full([batch], 10.0), size, size)
    return (verts.numpy(), tris.numpy(),
            np.full(verts.shape, 0.7, np.float32),
            np.tile(np.float32([[[0.0, 3.0, 3.0]]]), [batch, 1, 1]),
            np.ones([batch, 1], np.float32), cams.numpy())


def _small_cases(device, world):
    """{case: (start vertices, render(vertices, mesh))} of the small job;
    the sphere's batch is the data axis's size when that exceeds 2."""
    from .. import parallel
    from ..ops import camera, mesh as mesh_ops
    from ..ops import rasterize as rasterize_ops
    from ..ops import soft_rasterize

    def on(x):
        return torch.as_tensor(x, device=device)

    verts, tris, attrs, cams = (on(x) for x in cube_scene())
    background = on(np.zeros([3], np.float32))

    def hard(v, mesh):
        if mesh is None:
            return rasterize_ops.rasterize(v, attrs, tris, cams, 16, 16,
                                           background)
        return parallel.sharded_rasterize(mesh, v, attrs, tris, cams, 16, 16,
                                          background)

    s_verts, s_tris, colors, lights, intensities, s_cams = (
        on(x) for x in sphere_scene(batch=max(2, world)))

    def soft(v, mesh):
        normals = mesh_ops.compute_vertex_normals(v, s_tris)
        if mesh is None:
            return soft_rasterize.rasterize(
                v, s_tris, normals, colors, lights, intensities, s_cams, 16,
                16, 1e-4, 1e-4)
        return parallel.sharded_soft_rasterize(
            mesh, v, s_tris, normals, colors, lights, intensities, s_cams,
            16, 16, 1e-4, 1e-4)

    def silhouette(v, mesh):
        if mesh is None:
            return soft_rasterize.rasterize_silhouette_clip_space_batch(
                camera.transform_homogeneous(s_cams, v), s_tris, 16, 16,
                1e-4)
        return parallel.sharded_soft_silhouette(mesh, v, s_tris, s_cams, 16,
                                                16, 1e-4)

    return {"hard": (verts, hard), "soft": (s_verts, soft),
            "silhouette": (s_verts, silhouette)}


def _full_cases(device):
    """{case: (start vertices, render(vertices, mesh))} of the full job:
    `mesh_renderer.render` on the bench's teapot at 256x256 batch 4, its
    rasterizer sharded on the mesh, and `soft_mesh_renderer.render` on it
    at 128x128 (CCW), its rasterizer sharded."""
    import contextlib
    import functools
    from unittest import mock

    from .. import parallel
    from ..models import mesh_renderer, soft_mesh_renderer
    from . import scenes

    teapot = scenes.build_scene(4, device)

    def through(mesh, module, name, wrapper):
        if mesh is None:
            return contextlib.nullcontext()
        return mock.patch.object(module, name,
                                 functools.partial(wrapper, mesh))

    def hard(v, mesh):
        rest = [teapot[k] for k in ("triangles", "normals", "diffuse", "eye",
                                    "center", "up", "lights", "intensities")]
        with through(mesh, mesh_renderer, "rasterize",
                     parallel.sharded_rasterize):
            return mesh_renderer.render(v, *rest, 256, 256)

    soft_tris = teapot["triangles"].flip(1).contiguous()

    def soft(v, mesh):
        with through(mesh, soft_mesh_renderer, "rasterize",
                     parallel.sharded_soft_rasterize):
            return soft_mesh_renderer.render(
                v, soft_tris, teapot["diffuse"], teapot["eye"],
                teapot["center"], teapot["up"], teapot["lights"],
                teapot["intensities"][..., 0].contiguous(), 128, 128)

    return {"hard": (teapot["vertices"], hard),
            "soft": (teapot["vertices"], soft)}


def case_fns(job, device, world):
    """{case: (start vertices, render(vertices, mesh or None))}."""
    return (_small_cases(device, world) if job == "small"
            else _full_cases(device))


def output_and_grad(start, render, mesh, case):
    """(output, vertex gradient of mean(output^2)), detached."""
    v = start.detach().clone().requires_grad_(True)
    out = render(v, mesh)
    (grad,) = torch.autograd.grad(torch.mean(out ** 2), v)
    return out.detach(), grad


def fit_problem(job, device, mesh):
    """The cow fit's Problem at the job's size, on `mesh` (None: the
    unsharded render)."""
    from ..examples import fit_shape_multiview

    args = fit_shape_multiview.parse_args(FIT_ARGS[job])
    return fit_shape_multiview.Problem(args, device, mesh=mesh)


def fit_step(problem, device):
    """(offsets, step) of the fit: Adam at the fit's learning rate
    (capturable on a card)."""
    from .. import parallel

    offsets = torch.zeros_like(problem.verts0, requires_grad=True)
    extra = {"capturable": True} if device.type == "cuda" else {}
    optimizer = torch.optim.Adam([offsets], lr=problem.args.lr, **extra)
    return offsets, parallel.make_train_step(problem.loss, optimizer)


def eager_steps(problem, device, steps):
    """(losses [steps], offsets) after `steps` eager Adam steps."""
    offsets, step = fit_step(problem, device)
    losses = torch.stack([step.run_eager(problem.targets)
                          for _ in range(steps)])
    return losses.detach(), offsets.detach()


def capture_error(problem, device):
    """The message of the RuntimeError that capturing the fit step on its
    mesh raises, None if none: on a card the step's first call (its eager
    warm-up, then the capture); on the CPU, which captures nothing, the
    loss with the wrappers told that a capture is under way."""
    from unittest import mock

    try:
        if device.type == "cuda":
            fit_step(problem, device)[1](problem.targets)
        else:
            with mock.patch.object(capture, "capturing", return_value=True):
                problem.loss([torch.zeros_like(problem.verts0)],
                             problem.targets)
    except RuntimeError as e:
        return str(e)
    return None


def launch_counts():
    """The kernels' launch counters in this process, by kernel name."""
    from ..ops import rasterize_cuda as rc
    from ..ops import soft_rasterize_cuda as sc

    return {"rasterize_fused_fwd": rc.LAUNCHES,
            "rasterize_fused_bwd": rc.BWD_LAUNCHES,
            "soft_sil_fwd": sc.SIL_FWD_LAUNCHES,
            "soft_sil_bwd": sc.SIL_BWD_LAUNCHES,
            "soft_fwd": sc.FWD_LAUNCHES, "soft_bwd": sc.BWD_LAUNCHES}


def _rank_main(args):
    from .. import parallel
    from ..microbench import common

    device = torch.device("cpu" if args.device == "cpu" else "cuda:0")
    if device.type == "cpu":
        torch.set_num_threads(1)
    parallel.init_distributed(
        f"localhost:{args.port}", num_processes=args.world,
        process_id=args.rank, backend=args.backend,
        local_device_ids=None if device.type == "cpu" else (
            [args.rank] if args.backend == "nccl" else [0]))
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    plan = PLAN[(args.job, args.world)]
    cases = case_fns(args.job, device, args.world)
    # A mesh entry of a rank outside the group raises.
    outside = parallel.make_mesh(1, 1, devices=[parallel.ProcessDevice(
        args.world, args.world, device)])
    try:
        parallel.shard_batch(outside, {"x": torch.zeros(1)})
        results = {"outside_group": None}
    except ValueError as e:
        results = {"outside_group": str(e)}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for case, mesh_names in plan.items():
        if case == "steps":
            continue
        start, render = cases[case]
        for name in mesh_names:
            mesh = make_mesh(name)
            before = launch_counts()
            runs = [output_and_grad(start, render, mesh, case)
                    for _ in range(2)]
            sync()
            results[f"{case}/{name}"] = dict(
                out=runs[0][0].cpu(), grad=runs[0][1].cpu(),
                repeat=torch.equal(runs[0][0], runs[1][0]),
                spread=float((runs[0][1] - runs[1][1]).abs().max()),
                launches={k: n - before[k]
                          for k, n in launch_counts().items()})
    for name in plan.get("steps", []):
        problem = fit_problem(args.job, device, make_mesh(name))
        before = launch_counts()
        runs = [eager_steps(problem, device, STEPS[args.job])
                for _ in range(2)]
        sync()
        entry = dict(losses=runs[0][0].cpu(), offsets=runs[0][1].cpu(),
                     repeat=all(torch.equal(a, b) for a, b in zip(*runs)),
                     spread=float((runs[0][1] - runs[1][1]).abs().max()),
                     launches={k: n - before[k]
                               for k, n in launch_counts().items()})
        entry["capture_error"] = capture_error(problem, device)
        if device.type == "cuda":
            _, step = fit_step(problem, device)
            entry["eager_ms"] = common.wall_ms(
                lambda: step.run_eager(problem.targets), device,
                TIMED_STEPS)
        results[f"steps/{name}"] = entry
    torch.save(results, os.path.join(args.out, f"rank{args.rank}.pt"))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print(f"rank {args.rank} of {args.world}: done", flush=True)


def free_port():
    """A TCP port on localhost that the system reports free."""
    with socket.socket() as probe:
        probe.bind(("localhost", 0))
        return probe.getsockname()[1]


def run(world, out, device="cpu", job="small", backend="gloo",
        timeout=300.0):
    """Starts `world` ranks of the job and waits for them; each must exit
    0 within `timeout` seconds of its start. On a failure or a hang the
    others are stopped and RuntimeError carries every rank's log. Returns
    each rank's results ({case/mesh: {...}}), in rank order."""
    os.makedirs(out, exist_ok=True)
    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get(
        "PYTHONPATH", ""))
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    logs = [os.path.join(out, f"rank{r}.log") for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", MODULE, "--rank", str(r),
                 "--world", str(world), "--port", str(port), "--device",
                 device, "--job", job, "--backend", backend, "--out", out],
                cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while True:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited with code {codes[bad[0]]}"
                break
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                late = [r for r, c in enumerate(codes) if c is None]
                failed = f"ranks {late} did not end within {timeout} s"
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    if failed is not None:
        text = []
        for r, path in enumerate(logs):
            with open(path) as log:
                text.append(f"--- rank {r} ---\n{log.read()[-4000:]}")
        raise RuntimeError(failed + "\n" + "\n".join(text))
    return [torch.load(os.path.join(out, f"rank{r}.pt"))
            for r in range(world)]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--world", type=int, default=2)
    parser.add_argument("--rank", type=int, default=None,
                        help="run as this rank (set by `run`)")
    parser.add_argument("--port", type=int, default=None)
    parser.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    parser.add_argument("--job", choices=("small", "full"), default="small")
    parser.add_argument("--backend", choices=("gloo", "nccl"),
                        default="gloo")
    parser.add_argument("--out", required=True)
    parser.add_argument("--timeout", type=float, default=300.0)
    args = parser.parse_args(argv)
    if args.rank is not None:
        _rank_main(args)
        return 0
    results = run(args.world, args.out, args.device, args.job, args.backend,
                  args.timeout)
    for key in (k for k in results[0] if "/" in k):
        same = all(all(torch.equal(a, b) for a, b in
                       ((results[0][key][k], r[key][k])
                        for k in results[0][key]
                        if torch.is_tensor(results[0][key][k])))
                   for r in results[1:])
        print(f"{key}: ranks bit for bit equal {same}; two runs' outputs "
              f"equal {[r[key]['repeat'] for r in results]}, their "
              f"gradients' spread {[r[key]['spread'] for r in results]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
