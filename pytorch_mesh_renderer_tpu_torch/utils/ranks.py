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
same renders without a mesh, `run_steps` of `fit_setup` and `hard_setup`
the same steps): `tests/test_torch_multiprocess.py` on the CPU, `chip_smoke.py`
phase 17 and `tests/test_torch_cuda.py` on the card.

The job ("small": `tests/test_torch_parallel.py`'s cube at 16x16 batch 4
and sphere at 16x16, the cow fit at 16x16 and sphere resolution 8;
"full": the teapot at 256x256 batch 4 hard and 128x128 batch 4 soft, the
cow fit at 128x128, 4 views, resolution 24) runs each case of `PLAN` on
each of its meshes (`make_mesh`), twice: "hard" (the hard rasterizer, or
render), "soft" (the soft rasterizer, or render) and "silhouette", each
output with the vertex gradient of mean(out^2); "steps" (Adam steps of
the cow fit) and "hard_steps" (SGD steps on the vertices of mean(out^2)
of the hard case), eager through `step.run_eager`. Each step case also
lists the gathers its step meets (on the CPU, `eager_gathers`: an eager
step with the wrappers told that a capture is under way) and, on a card,
takes the same steps captured (a chain of CUDA graphs cut at the
gathers, `parallel/sharded.py`) through the step and through
`make_train_loop`, and times the eager and the captured step, with the
host's wait at the gathers.
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

from . import capture, profiling

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MODULE = "pytorch_mesh_renderer_tpu_torch.utils.ranks"

# (job, world) -> {case: [mesh names]}.
PLAN = {
    ("small", 2): {"hard": ["2x1", "2x2list"], "soft": ["2x1", "2x2list"],
                   "silhouette": ["2x1"], "steps": ["2x1"],
                   "hard_steps": ["2x1"]},
    ("small", 4): {"hard": ["4x1"], "soft": ["4x1"], "silhouette": ["4x1"],
                   "steps": ["4x1"], "hard_steps": ["4x1"]},
    ("full", 2): {"hard": ["2x1", "2x2list"], "soft": ["2x1"],
                  "steps": ["2x1"], "hard_steps": ["2x1"]},
    ("full", 4): {"hard": ["4x1"], "steps": ["4x1"], "hard_steps": ["4x1"]},
}
STEP_CASES = ("steps", "hard_steps")
STEPS = {"small": 3, "full": 5}
FIT_ARGS = {"small": ["--size", "16", "--resolution", "8"],
            "full": ["--size", "128", "--resolution", "24"]}
# The hard steps' SGD learning rate on the vertices.
HARD_LR = 5.0
# The steps' timing on a card: calls per window, windows, warm-up calls.
TIMED_STEPS, TIMED_WINDOWS, TIMED_WARMUP = 10, 5, 3


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


def fit_setup(problem, device):
    """(loss_fn, offsets, optimizer, batch) of the fit: Adam at the fit's
    learning rate (capturable on a card) on offsets from zero."""
    offsets = torch.zeros_like(problem.verts0, requires_grad=True)
    extra = {"capturable": True} if device.type == "cuda" else {}
    optimizer = torch.optim.Adam([offsets], lr=problem.args.lr, **extra)
    return problem.loss, offsets, optimizer, problem.targets


def hard_setup(case, mesh):
    """(loss_fn, vertices, optimizer, batch) of the hard step on the hard
    case (`case_fns`' (start, render)): SGD at HARD_LR on the vertices of
    mean(render(vertices, mesh)^2)."""
    start, render = case
    vertices = start.detach().clone().requires_grad_(True)

    def loss_fn(params, batch):
        return torch.mean(render(params[0], mesh) ** 2)

    return loss_fn, vertices, torch.optim.SGD([vertices], lr=HARD_LR), None


def run_steps(setup, steps, how="eager"):
    """(losses [steps], the parameter after them, the step's chain of
    graphs or None): `steps` steps of `setup` (fit_setup's or hard_setup's
    tuple), each an eager step (`how` "eager": step.run_eager), a call of
    make_train_step's step ("step": on a card the first call runs eagerly
    and captures, the others replay) or all in one call of
    make_train_loop(steps) ("loop")."""
    from .. import parallel

    loss_fn, param, optimizer, batch = setup
    if how == "loop":
        loop = parallel.make_train_loop(loss_fn, optimizer, steps)
        losses, step = loop(batch), loop.step
    else:
        step = parallel.make_train_step(loss_fn, optimizer)
        call = step.run_eager if how == "eager" else step
        losses = torch.stack([call(batch) for _ in range(steps)])
    return losses.detach(), param.detach(), step.graph


def eager_gathers(run):
    """The gathers that `run()` meets with the wrappers told that a
    capture is under way (on the CPU, which captures nothing, an eager
    step stands in for the capture), as `listed` gives them."""
    from unittest import mock

    from ..parallel import collectives

    with mock.patch.object(capture, "capturing", return_value=True), \
            collectives.gathers() as met:
        run()
    return listed(met)


def listed(gathers):
    """`collectives.Gather`s as (label, shape, dtype name) tuples."""
    return [(g.label, g.shape, str(g.dtype)) for g in gathers]


LAUNCHED = ("rasterize_fused_fwd", "rasterize_fused_bwd", "soft_sil_fwd",
            "soft_sil_bwd", "soft_fwd", "soft_bwd")


def launch_counts():
    """The kernels' launch counters in this process, by kernel name."""
    counts = profiling.counters()
    return {name: counts.get("launches." + name, 0) for name in LAUNCHED}


def _step_entry(job, device, case, hard_case, mesh):
    """A step case's results in this rank: the eager steps twice, the
    gathers a step meets and, on a card, the captured steps (through the
    step and through the loop) and the times of the eager and the captured
    step (CUDA events), with the host's ms a captured step waits for a
    graph to end (`wait_ms`) and gathers (`gather_ms`), from the chain's
    spans over as many steps again under a profile, and the ms of its
    gathers alone, without the card (`gloo_ms`)."""
    from .. import parallel
    from ..microbench import common

    if case == "steps":
        problem = fit_problem(job, device, mesh)

        def setup():
            return fit_setup(problem, device)
    else:
        def setup():
            return hard_setup(hard_case, mesh)

    steps = STEPS[job]
    before = launch_counts()
    runs = [run_steps(setup(), steps) for _ in range(2)]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    entry = dict(losses=runs[0][0].cpu(), offsets=runs[0][1].cpu(),
                 repeat=all(torch.equal(a, b)
                            for a, b in zip(runs[0][:2], runs[1][:2])),
                 spread=float((runs[0][1] - runs[1][1]).abs().max()),
                 launches={k: n - before[k]
                           for k, n in launch_counts().items()})
    if device.type != "cuda":
        entry["gathers"] = eager_gathers(lambda: run_steps(setup(), 1))
        return entry
    for how in ("step", "loop"):
        losses, param, chain = run_steps(setup(), steps, how)
        entry[how] = dict(losses=losses.cpu(), offsets=param.cpu())
    entry["gathers"] = listed(chain.gathers)
    entry["graphs"] = len(chain.graphs)
    loss_fn, _, optimizer, batch = setup()
    step = parallel.make_train_step(loss_fn, optimizer)
    timed = dict(iters=TIMED_STEPS, windows=TIMED_WINDOWS,
                 warmup=TIMED_WARMUP)
    entry["eager_ms"] = common.wall_ms(lambda: step.run_eager(batch), device,
                                       **timed)
    step(batch)  # the warm-up and the capture
    entry["captured_ms"] = common.wall_ms(lambda: step(batch), device,
                                          **timed)
    calls = TIMED_WARMUP + TIMED_WINDOWS * TIMED_STEPS
    # The host's wait for a graph and its gathers: the chain's spans, read
    # over as many steps again under a profile of the host.
    before = profiling.span_table()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(calls):
            step(batch)
    torch.cuda.synchronize(device)
    after = profiling.span_table()
    for key, span in (("wait_ms", "mr.step.gather_wait"),
                      ("gather_ms", "mr.step.gather")):
        seconds = after.get(span, (0, 0.0, 0.0))[1] - before.get(
            span, (0, 0.0, 0.0))[1]
        entry[key] = seconds * 1e3 / calls
    # The step's gathers alone, on the host, as many times.
    t0 = time.perf_counter()
    for _ in range(calls):
        for k in range(len(step.graph.gathers)):
            step.graph.gather(k)
    entry["gloo_ms"] = (time.perf_counter() - t0) * 1e3 / calls
    if case == "steps":
        entry["capture_errors"] = capture_errors(setup)
    return entry


def capture_errors(setup):
    """On a card, the messages of the RuntimeErrors that two captures of a
    chain raise, None where one does not raise: a step whose loss meets
    its gathers in the warm-up only ("mismatch"), and one whose loss waits
    for the card after the first gather ("sync"). Every rank's capture
    fails alike, and a capture runs no collective, so no rank waits."""
    from .. import parallel

    def fails(wrap):
        loss_fn, _, optimizer, batch = setup()
        step = parallel.make_train_step(wrap(loss_fn), optimizer)
        try:
            step(batch)
        except RuntimeError as e:
            return str(e)
        return None

    def mismatch(loss_fn):
        calls = []

        def first_only(params, batch):
            calls.append(None)
            if len(calls) == 1:
                return loss_fn(params, batch)
            return (params[0] ** 2).sum()
        return first_only

    def sync(loss_fn):
        def syncs(params, batch):
            loss = loss_fn(params, batch)
            if float(loss) < 0.0:  # the host waits for the card
                raise AssertionError("a negative loss")
            return loss
        return syncs

    return {"mismatch": fails(mismatch), "sync": fails(sync)}


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
        if case in STEP_CASES:
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
    for case in STEP_CASES:
        for name in plan.get(case, []):
            results[f"{case}/{name}"] = _step_entry(
                args.job, device, case, cases.get("hard"), make_mesh(name))
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
        entry = results[0][key]
        if "gathers" in entry:
            print(f"{key}: gathers {entry['gathers']}")
        if "step" in entry:
            captured = all(
                torch.equal(r[key][how][k], r[key][k]) for r in results
                for how in ("step", "loop") for k in ("losses", "offsets"))
            print(f"{key}: {entry['graphs']} graphs a step; captured step "
                  f"and loop equal the eager steps bit for bit {captured}; "
                  "ms a step (eager, captured, wait, gather, gathers alone) "
                  "by rank " + "; ".join(
                      ", ".join(f"{r[key][k]:.4f}" for k in (
                          "eager_ms", "captured_ms", "wait_ms", "gather_ms",
                          "gloo_ms")) for r in results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
