#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, on a CUDA host

The quickest proof that the port still starts on the card. It imports
torch, numpy and the port (`pytorch_mesh_renderer_tpu_torch`), never JAX,
and runs these phases, printing one line or more per phase:

  1. device  — needs CUDA; prints `nvidia-smi`'s name and power limit;
               checks that fp32 matmuls do not run in TF32.
  2. build   — builds every CUDA kernel from csrc/ with nvcc.
  3. kernel  — the fused rasterizer kernel vs its plain PyTorch version, on
               the card: the 64x48 cube (also against the reference
               kernel's oracle), random scenes with 3/9/16 attributes, two
               row strips against the full image, and the 256x256 batch-4
               teapot. ids must be equal; bc, z and attributes within 1e-6.
  4. main    — `mesh_renderer.render` on the teapot at 256x256 batch 4 with
               the default backend, counting kernel launches; the same call
               through the plain version; the four cube goldens at 640x480.
  5. times   — CUDA-event medians: kernel vs plain version, full render.

Then it prints the kernel summary as one JSON line and, last, the device
line `{"ok": true, "device": {...}}`. Any failed phase raises and the exit
code is non-zero; without a CUDA device it exits non-zero before printing
any result.
"""

import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
KERNEL_SOURCE = "pytorch_mesh_renderer_tpu_torch/csrc/rasterize_fused_fwd.cu"
KERNEL_REPLACES = "pytorch_mesh_renderer_tpu/ops/rasterize_pallas.py:1059"
# Kernel vs plain version: both run the same fp32 operations in the same
# order (the kernel is built with --fmad=false), so they should agree to
# the last bit; 1e-6 leaves room for nothing but that.
KERNEL_ATOL = 1e-6
TEAPOT_SIZE, TEAPOT_BATCH = 256, 4

CUBE_VERTICES = [[-1, -1, 1], [-1, -1, -1], [-1, 1, -1], [-1, 1, 1],
                 [1, -1, 1], [1, -1, -1], [1, 1, -1], [1, 1, 1]]
CUBE_TRIANGLES = [[0, 1, 2], [2, 3, 0], [3, 2, 6], [6, 7, 3], [7, 6, 5],
                  [5, 4, 7], [4, 5, 1], [1, 0, 4], [5, 6, 2], [2, 1, 5],
                  [7, 4, 0], [0, 3, 7]]


def log(phase, message):
    print(f"[{phase}] {message}", flush=True)


def gpu_name_and_power_limit():
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return proc.stdout.strip().splitlines()[0].strip()


def cuda_time_ms(fn, iters, windows=5, warmup=3):
    """Median over `windows` of the mean per-call time, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / iters)
    return statistics.median(per_call)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU.", file=sys.stderr)
        return 2

    import numpy as np

    sys.path.insert(0, REPO)
    from pytorch_mesh_renderer_tpu_torch import config as config_lib
    from pytorch_mesh_renderer_tpu_torch.models import mesh_renderer
    from pytorch_mesh_renderer_tpu_torch.ops import camera
    from pytorch_mesh_renderer_tpu_torch.ops import rasterize_cuda as rc
    from pytorch_mesh_renderer_tpu_torch.utils import kernels, obj_io
    from pytorch_mesh_renderer_tpu_torch.utils import test_utils
    from pytorch_mesh_renderer_tpu_torch.utils.convert import scene_to_torch

    golden_dir = os.path.join(REPO, "tests", "golden")
    oracle_path = os.path.join(REPO, "tests", "oracle",
                               "hard_kernel_cube_64x48.npz")
    teapot_path = os.path.join(REPO, "assets", "teapot.obj")
    dev = torch.device("cuda", 0)
    f32 = dict(dtype=torch.float32, device=dev)

    # 1. Device.
    card = gpu_name_and_power_limit()
    log("device", f"{torch.cuda.get_device_name(0)}; count "
        f"{torch.cuda.device_count()}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    print(card, flush=True)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("torch.backends.cuda.matmul.allow_tf32 is True")

    # 2. Build.
    t0 = time.perf_counter()
    build = kernels.build()
    kernels.load_library()
    log("build", f"{time.perf_counter() - t0:.1f} s -> "
        f"{os.path.relpath(build.path, REPO)}")
    for line in build.log.splitlines():
        if "registers" in line or "spill" in line:
            log("build", line.strip())

    # 3. Kernel vs plain version on the card.
    max_err = 0.0

    def compare(name, clip, attrs, tris, width, height, **kwargs):
        nonlocal max_err
        kernel = rc.rasterize_interpolate_cuda(clip, attrs, tris, width,
                                               height, with_z=True, **kwargs)
        plain = rc.rasterize_interpolate_torch(clip, attrs, tris, width,
                                               height, with_z=True, **kwargs)
        torch.cuda.synchronize()
        if not torch.equal(kernel[0], plain[0]):
            bad = int((kernel[0] != plain[0]).sum())
            raise AssertionError(f"{name}: ids differ at {bad} pixels")
        errs = [float((k - p).abs().max()) if k.numel() else 0.0
                for k, p in zip(kernel[1:], plain[1:])]
        for label, err in zip(("bc", "attrs", "z"), errs):
            if not err <= KERNEL_ATOL:
                raise AssertionError(
                    f"{name}: {label} max abs {err} > {KERNEL_ATOL}")
        max_err = max(max_err, *errs)
        covered = float((kernel[1].sum(-1) > 0).float().mean())
        log("kernel", f"{name}: ids equal; max abs bc {errs[0]:.3g}, attrs "
            f"{errs[1]:.3g}, z {errs[2]:.3g}; covered {covered:.3f}")
        return kernel

    # The cube of tests/test_rasterize_pallas.py: eye (2, 3, 6), 64x48.
    cube = torch.tensor([CUBE_VERTICES], **f32)
    cube_tris = torch.tensor(CUBE_TRIANGLES, dtype=torch.int32, device=dev)
    cube_cam = camera.clip_space_transforms(
        torch.tensor([[2.0, 3.0, 6.0]], **f32), torch.zeros(1, 3, **f32),
        torch.tensor([[0.0, 1.0, 0.0]], **f32), torch.tensor([40.0], **f32),
        torch.tensor([0.01], **f32), torch.tensor([10.0], **f32), 64, 48)
    ids, bc = compare("cube 64x48", camera.transform_homogeneous(
        cube_cam, cube), cube * 0.5 + 0.5, cube_tris, 64, 48)[:2]
    with np.load(oracle_path) as ref:
        covered = ref["bc"].sum(-1) > 0.5
        ids0, bc0 = ids[0].cpu().numpy(), bc[0].cpu().numpy()
        if not np.array_equal(ids0[covered], ref["ids"][covered]):
            raise AssertionError("cube 64x48: ids differ from the oracle")
        oracle_err = float(np.abs(bc0 - ref["bc"]).max())
        if not oracle_err <= 1e-4:
            raise AssertionError(f"cube 64x48: bc vs oracle {oracle_err}")
    log("kernel", f"cube 64x48 vs reference oracle: covered ids equal, bc "
        f"max abs {oracle_err:.3g} (gate 1e-4)")

    def random_scene(attr_count, batch=2, vertex_count=24, tri_count=30,
                     width=48, height=40):
        rng = np.random.RandomState(0)
        verts = (rng.randn(batch, vertex_count, 3) * 0.5).astype(np.float32)
        tris = rng.randint(0, vertex_count, (tri_count, 3)).astype(np.int32)
        attrs = rng.randn(batch, vertex_count, attr_count).astype(np.float32)
        cam = camera.clip_space_transforms(
            torch.tensor([[0.0, 0.0, 3.0]] * batch, **f32),
            torch.zeros(batch, 3, **f32),
            torch.tensor([[0.0, 1.0, 0.0]] * batch, **f32),
            torch.full((batch,), 40.0, **f32),
            torch.full((batch,), 0.01, **f32),
            torch.full((batch,), 10.0, **f32), width, height)
        clip = camera.transform_homogeneous(cam, torch.from_numpy(verts).to(
            dev))
        return clip, torch.from_numpy(attrs).to(dev), torch.from_numpy(
            tris).to(dev)

    for attr_count in (3, 9, 16):
        compare(f"random A={attr_count} 48x40", *random_scene(attr_count),
                48, 40)
    scene = random_scene(9)
    full = rc.rasterize_interpolate_cuda(*scene, 48, 40, with_z=True)
    for i in range(2):
        strip = compare(f"row strip {i} 48x20", *scene, 48, 20,
                        row_offset=20 * i, full_height=40)
        for s, f in zip(strip, full):
            if not torch.equal(s, f[:, 20 * i:20 * (i + 1)]):
                raise AssertionError(f"row strip {i} differs from the full "
                                     "image")
    log("kernel", "row strips reassemble the full image exactly")

    # The headline scene: bench.py's teapot parameters, built in numpy.
    v, t, n = obj_io.load_obj(teapot_path)
    rot = camera.euler_matrices(torch.stack([
        torch.zeros(TEAPOT_BATCH), torch.linspace(0.0, 1.0, TEAPOT_BATCH),
        torch.zeros(TEAPOT_BATCH)], dim=-1))[:, :3, :3].numpy()
    vertices = np.einsum("bij,vj->bvi", rot, v.numpy())
    teapot = scene_to_torch(dict(
        vertices=vertices,
        triangles=t.numpy()[:, ::-1],  # the hard renderer wants CW
        normals=np.einsum("bij,vj->bvi", rot, n.numpy()),
        diffuse=np.broadcast_to(np.array([0.8, 0.6, 0.4]), vertices.shape),
        eye=np.tile([[0.0, 1.0, 4.0]], [TEAPOT_BATCH, 1]),
        center=np.zeros([TEAPOT_BATCH, 3]),
        up=np.tile([[0.0, 1.0, 0.0]], [TEAPOT_BATCH, 1]),
        lights=np.tile([[[-2.0, 2.0, 4.0], [3.0, -1.0, 4.0]]],
                       [TEAPOT_BATCH, 1, 1]),
        intensities=np.ones([TEAPOT_BATCH, 2, 3])), dev)
    scene_args = [teapot[k] for k in (
        "vertices", "triangles", "normals", "diffuse", "eye", "center", "up",
        "lights", "intensities")]
    # The rasterizer's inputs exactly as render builds them (A = 9).
    ones = torch.ones(TEAPOT_BATCH, **f32)
    teapot_cam = camera.clip_space_transforms(
        teapot["eye"], teapot["center"], teapot["up"], 40.0 * ones,
        0.01 * ones, 10.0 * ones, TEAPOT_SIZE, TEAPOT_SIZE)
    teapot_clip = camera.transform_homogeneous(teapot_cam,
                                               teapot["vertices"])
    teapot_attrs = torch.cat([teapot["normals"], teapot["vertices"],
                              teapot["diffuse"]], dim=2)
    teapot_raster = (teapot_clip, teapot_attrs, teapot["triangles"])
    compare(f"teapot {TEAPOT_SIZE}^2 batch {TEAPOT_BATCH} A=9",
            *teapot_raster, TEAPOT_SIZE, TEAPOT_SIZE)

    # 4. The main path.
    rc.LAUNCHES = 0
    images = mesh_renderer.render(*scene_args, TEAPOT_SIZE, TEAPOT_SIZE)
    torch.cuda.synchronize()
    main_launches = rc.LAUNCHES
    if main_launches < 1:
        raise AssertionError("render did not launch the CUDA kernel")
    if tuple(images.shape) != (TEAPOT_BATCH, TEAPOT_SIZE, TEAPOT_SIZE, 4):
        raise AssertionError(f"render returned shape {tuple(images.shape)}")
    if not bool(torch.isfinite(images).all()):
        raise AssertionError("render output is not finite")
    coverage = [float(c) for c in (images[..., 3] > 0.5).float().mean((1, 2))]
    if not all(0.05 < c < 0.9 for c in coverage):
        raise AssertionError(f"implausible teapot coverage {coverage}")
    log("main", f"render teapot {TEAPOT_SIZE}^2 batch {TEAPOT_BATCH}: "
        f"kernel launches {main_launches}; finite; coverage "
        f"{', '.join(f'{c:.3f}' for c in coverage)}")

    plain_cfg = config_lib.HardRasterizerConfig(backend="torch")
    plain_images = mesh_renderer.render(*scene_args, TEAPOT_SIZE,
                                        TEAPOT_SIZE, config=plain_cfg)
    for i in range(TEAPOT_BATCH):
        matched, fraction = test_utils.images_are_near(plain_images[i],
                                                       images[i])
        if not matched:
            raise AssertionError(
                f"teapot image {i}: kernel vs plain render {fraction} "
                "outliers")
    render_err = float((plain_images - images).abs().max())
    log("main", f"render via kernel vs plain version: images near (0.1% at "
        f"0.01), max abs {render_err:.3g}")

    model = camera.euler_matrices(torch.tensor(
        [[-20.0, 0.0, 60.0], [45.0, 60.0, 0.0]], **f32))[:, :3, :3]
    cube_v = torch.einsum("bij,vj->bvi", model, cube[0])
    cube_n = torch.einsum("bij,vj->bvi", model, cube[0] / torch.linalg.norm(
        cube[0], dim=1, keepdim=True))
    gray = mesh_renderer.render(
        cube_v, cube_tris, cube_n, torch.ones_like(cube_v),
        torch.tensor([0.0, 0.0, 6.0], **f32), torch.zeros(2, 3, **f32),
        torch.tensor([0.0, 1.0, 0.0], **f32),
        torch.tensor([[[0.0, 0.0, 6.0]]] * 2, **f32),
        torch.ones(2, 1, 3, **f32), 640, 480)
    colored = mesh_renderer.render(
        cube_v, cube_tris, cube_n, torch.tensor([[
            [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0],
            [1.0, 1.0, 1.0], [1.0, 1.0, 0.0], [1.0, 0.0, 1.0],
            [0.0, 1.0, 1.0], [0.5, 0.5, 0.5]]] * 2, **f32),
        torch.tensor([[0.0, 0.0, 6.0], [0.0, 0.2, 18.0]], **f32),
        torch.tensor([[0.0, 0.0, 0.0], [0.1, -0.1, 0.1]], **f32),
        torch.tensor([[0.0, 1.0, 0.0], [0.1, 1.0, 0.15]], **f32),
        torch.tensor([[[0.0, 0.0, 6.0], [1.0, 2.0, 6.0]],
                      [[0.0, -2.0, 4.0], [1.0, 3.0, 4.0]]], **f32),
        torch.tensor([[[1.0, 1.0, 1.0], [1.0, 1.0, 1.0]],
                      [[2.0, 0.0, 1.0], [0.0, 2.0, 1.0]]], **f32), 640, 480,
        specular_colors=torch.tensor([[
            [0.0, 1.0, 0.0], [0.0, 0.0, 1.0], [1.0, 1.0, 1.0],
            [1.0, 1.0, 0.0], [1.0, 0.0, 1.0], [0.0, 1.0, 1.0],
            [0.5, 0.5, 0.5], [1.0, 0.0, 0.0]]] * 2, **f32),
        shininess_coefficients=6.0 * torch.ones(2, 8, **f32),
        ambient_color=torch.tensor([[0.0, 0.0, 0.0], [0.1, 0.1, 0.2]], **f32),
        fov_y=torch.tensor([40.0, 13.3], **f32), near_clip=0.1,
        far_clip=25.0)
    colored = torch.cat([mesh_renderer.tone_mapper(colored[..., :3], 0.7),
                         colored[..., 3:4]], dim=3)
    for name, batch_images in (("Gray_Cube", gray), ("Colored_Cube",
                                                     colored)):
        for i in range(2):
            fraction = test_utils.expect_image_file_and_render_are_near(
                os.path.join(golden_dir, f"{name}_{i}.png"), batch_images[i])
            log("main", f"golden {name}_{i}.png via the kernel: {fraction:.5f}"
                " of pixels outliers (gate 0.001)")

    # 5. Times at the headline size (CUDA events, median of 5 windows).
    kernel_ms = cuda_time_ms(lambda: rc.rasterize_interpolate_cuda(
        *teapot_raster, TEAPOT_SIZE, TEAPOT_SIZE), iters=20)
    plain_ms = cuda_time_ms(lambda: rc.rasterize_interpolate_torch(
        *teapot_raster, TEAPOT_SIZE, TEAPOT_SIZE), iters=3)
    table = rc.pack_triangles(teapot_clip, teapot["triangles"])
    corner = rc.pack_corner_attributes(teapot_attrs, teapot["triangles"])
    launch_ms = cuda_time_ms(lambda: rc.launch_fused_fwd(
        table, corner, TEAPOT_SIZE, TEAPOT_SIZE, 0, TEAPOT_SIZE, False),
        iters=20)
    render_ms = cuda_time_ms(lambda: mesh_renderer.render(
        *scene_args, TEAPOT_SIZE, TEAPOT_SIZE), iters=20)
    log("times", f"{card} | fused rasterize, teapot {TEAPOT_SIZE}^2 batch "
        f"{TEAPOT_BATCH}, A=9: kernel wrapper {kernel_ms:.4f} ms (kernel "
        f"launch alone {launch_ms:.4f} ms), plain version {plain_ms:.4f} ms")
    log("times", f"{card} | render forward, teapot {TEAPOT_SIZE}^2 batch "
        f"{TEAPOT_BATCH}: {render_ms:.4f} ms, "
        f"{TEAPOT_BATCH * 1000.0 / render_ms:.2f} renders/s")

    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "rasterize_fused_fwd", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
        "launches": main_launches, "max_abs_err": max_err,
        "ms": kernel_ms, "plain_ms": plain_ms}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
