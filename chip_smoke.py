#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, on a CUDA host

The quickest proof that the port still starts on the card. It imports
torch, numpy and the port (`pytorch_mesh_renderer_tpu_torch`), never JAX,
and runs these phases, printing one line or more per phase:

  1. device  — needs CUDA; prints `nvidia-smi`'s name and power limit;
               checks that fp32 matmuls do not run in TF32.
  2. build   — builds every CUDA kernel from csrc/ with nvcc.
  3. kernel  — each kernel vs its plain PyTorch version, on the card: the
               64x48 cube (K1 also against the reference kernel's oracle),
               random scenes with 3/9/16 attributes, a scene snapped to
               pixel centres, two row strips against the full image, the
               zero-triangle mesh and the 256x256 batch-4 teapot. Forward
               kernels (K1 fused, K3 barycentric-only): ids equal; bc, z
               and attributes within 1e-6. Backward kernels (K2 fused, K4
               barycentric-only), under cotangents from a seeded generator:
               each gradient within 1e-5 of the plain tensor's max |value|.
  4. main    — `mesh_renderer.render` on the teapot at 256x256 batch 4 with
               the default backend, counting kernel launches; the same call
               through the plain version; the four cube goldens at 640x480.
  5. train   — the headline training step (bench.py's `bench_hard`: loss
               mean(rgb^2), `.backward()` to the vertices) through the
               kernels, counting K1 and K2 launches, against the same step
               through the plain versions; then the 35-step cube-rotation
               recovery of tests/test_mesh_renderer.py at 640x480, gated by
               Gray_Cube_0.png at 1% / 0.04.
  6. bary    — `ops.rasterize.rasterize_barycentric` (the reference
               kernel's contract) on each teapot image with a backward,
               counting K3 and K4 launches; its ids and bc equal the fused
               path's.
  7. times   — CUDA-event medians: each kernel vs its plain version, the
               forward render, and the training step.

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
CSRC = "pytorch_mesh_renderer_tpu_torch/csrc/"
PALLAS = "pytorch_mesh_renderer_tpu/ops/rasterize_pallas.py:"
# name -> (source, the TPU kernel it replaces).
KERNELS = {
    "rasterize_fused_fwd": (CSRC + "rasterize_fused_fwd.cu", PALLAS + "1059"),
    "rasterize_fused_bwd": (CSRC + "rasterize_fused_bwd.cu", PALLAS + "1282"),
    "rasterize_bary_fwd": (CSRC + "rasterize_bary_fwd.cu", PALLAS + "348"),
    "rasterize_bary_bwd": (CSRC + "rasterize_bary_bwd.cu", PALLAS + "676"),
}
# Forward kernels vs plain versions: both run the same fp32 operations in
# the same order (the kernels are built with --fmad=false), so they should
# agree to the last bit; 1e-6 leaves room for nothing but that.
KERNEL_ATOL = 1e-6
# Backward kernels vs plain versions, relative to the plain tensor's max
# |value|: atomic adds sum per-pixel terms in an order that changes from
# run to run. The JAX suite's CPU gate between its two backward backends.
GRAD_RTOL = 1e-5
# The training step through the kernels vs through the plain versions,
# relative to the plain gradient's max |value|.
TRAIN_RTOL = 1e-4
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
    from pytorch_mesh_renderer_tpu_torch.ops import rasterize as rasterize_ops
    from pytorch_mesh_renderer_tpu_torch.ops import (
        rasterize_barycentric_cuda as rb)
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

    def snapped_scene(batch=2, vertex_count=300, tri_count=2000, width=80,
                      height=56):
        """tests/test_torch_cuda.py's scene: many small overlapping
        triangles whose vertices project onto pixel centres, so edges run
        through pixel centres and along the kernels' block borders."""
        rng = np.random.RandomState(1)
        cols = rng.randint(0, width, (batch, vertex_count))
        rows = rng.randint(0, height, (batch, vertex_count))
        ndc = np.stack([(cols + 0.5) * np.float32(2.0 / width) - 1.0,
                        (rows + 0.5) * np.float32(2.0 / height) - 1.0,
                        rng.uniform(-0.9, 0.9, (batch, vertex_count))], -1)
        first = rng.randint(0, vertex_count - 8, tri_count)
        tris = np.stack([first, first + rng.randint(1, 4, tri_count),
                         first + rng.randint(4, 8, tri_count)], -1)
        clip = np.concatenate([ndc, np.ones((batch, vertex_count, 1))], -1)
        attrs = rng.randn(batch, vertex_count, 5)
        return (torch.tensor(clip, **f32), torch.tensor(attrs, **f32),
                torch.tensor(tris, dtype=torch.int32, device=dev))

    for attr_count in (3, 9, 16):
        compare(f"random A={attr_count} 48x40", *random_scene(attr_count),
                48, 40)
    snapped = snapped_scene()
    compare("snapped 80x56", *snapped, 80, 56)
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

    # K2, K3, K4 vs their plain versions on the same scenes.
    errors = {name: 0.0 for name in KERNELS}
    errors["rasterize_fused_fwd"] = max_err
    cotangent_rng = torch.Generator(device=dev).manual_seed(5)

    def cotangents(shape):
        return torch.randn(shape, generator=cotangent_rng, **f32)

    def grad_error(name, label, kernel, plain):
        """Max abs error of a backward kernel; fails above GRAD_RTOL."""
        torch.cuda.synchronize()
        if kernel.shape != plain.shape:
            raise AssertionError(f"{name}: {label} shape {kernel.shape} vs "
                                 f"{plain.shape}")
        if not bool(torch.isfinite(kernel).all()):
            raise AssertionError(f"{name}: {label} is not finite")
        err = float((kernel - plain).abs().max()) if plain.numel() else 0.0
        scale = float(plain.abs().max()) if plain.numel() else 0.0
        if not err <= GRAD_RTOL * scale:
            raise AssertionError(f"{name}: {label} max abs {err} > "
                                 f"{GRAD_RTOL} x {scale}")
        return err, scale

    def compare_backward(name, clip, attrs, tris, width, height,
                         row_offset=0, full_height=None, full_cotangents=None):
        """K2 and K4 vs their plain versions on one scene, K3 vs its plain
        version. The cotangents are drawn, or are rows [row_offset,
        row_offset + height) of the given full-image (df/dbc, df/dattr).
        Returns the kernels' vertex gradients."""
        full_height = full_height or height
        table, inv_abs_det = rc.pack_rows(clip, tris, True)
        corner = rc.pack_corner_attributes(attrs, tris)
        ids, bc, _ = rc.launch_fused_fwd(table, corner, width, height,
                                         row_offset, full_height, False)
        if full_cotangents is None:
            g_bc = cotangents(tuple(bc.shape))
            g_attr = cotangents(tuple(ids.shape) + (attrs.shape[-1],))
        else:
            g_bc, g_attr = (g[:, row_offset:row_offset + height].contiguous()
                            for g in full_cotangents)
        fused = (ids, bc, g_bc, g_attr, table, inv_abs_det, corner)
        bary = (ids, bc, g_bc, table, inv_abs_det)
        report = []
        kernel_grads = []
        for kernel_name, kernel_tab, plain_tab, kernel_vert, plain_vert in (
                ("rasterize_fused_bwd", rc.launch_fused_bwd(*fused),
                 rc.triangle_gradients_torch(*fused),
                 rc.rasterize_interpolate_backward_cuda(
                     *fused, tris, clip.shape[1]),
                 rc.rasterize_interpolate_backward_torch(
                     *fused, tris, clip.shape[1])),
                ("rasterize_bary_bwd", rb.launch_bary_bwd(*bary),
                 rb.triangle_gradients_bary_torch(*bary),
                 (rb.rasterize_barycentric_backward_cuda(
                     *bary, tris, clip.shape[1]),),
                 (rb.rasterize_barycentric_backward_torch(
                     *bary, tris, clip.shape[1]),))):
            pairs = [("table", kernel_tab, plain_tab)] + list(zip(
                ("dclip", "dattr"), kernel_vert, plain_vert))
            worst = 0.0
            for label, k, p in pairs:
                err, scale = grad_error(f"{name} {kernel_name}", label, k, p)
                worst = max(worst, err)
                report.append(f"{kernel_name} {label} {err:.3g} "
                              f"(scale {scale:.3g})")
            errors[kernel_name] = max(errors[kernel_name], worst)
            kernel_grads.append(kernel_vert)
        # K3 holds K1's z-buffer exactly.
        k3 = rb.launch_bary_fwd(table, width, height, row_offset,
                                full_height)
        p3 = rb.rasterize_barycentric_torch(clip, tris, width, height,
                                            row_offset=row_offset,
                                            full_height=full_height)
        torch.cuda.synchronize()
        if not (torch.equal(k3[0], p3[0]) and torch.equal(k3[0], ids)):
            raise AssertionError(f"{name}: rasterize_bary_fwd ids differ")
        k3_err = max(float((k - p).abs().max()) if k.numel() else 0.0
                     for k, p in zip(k3[1:], p3[1:]))
        if not k3_err <= KERNEL_ATOL:
            raise AssertionError(f"{name}: rasterize_bary_fwd bc/z max abs "
                                 f"{k3_err} > {KERNEL_ATOL}")
        errors["rasterize_bary_fwd"] = max(errors["rasterize_bary_fwd"],
                                           k3_err)
        log("kernel", f"{name}: rasterize_bary_fwd ids equal, bc/z "
            f"{k3_err:.3g}; max abs " + ", ".join(report))
        return kernel_grads

    compare_backward("cube 64x48", camera.transform_homogeneous(
        cube_cam, cube), cube * 0.5 + 0.5, cube_tris, 64, 48)
    for attr_count in (3, 9, 16):
        compare_backward(f"random A={attr_count} 48x40",
                         *random_scene(attr_count), 48, 40)
    compare_backward("snapped 80x56", *snapped, 80, 56)
    strip_cotangents = (cotangents((2, 40, 48, 3)),
                        cotangents((2, 40, 48, 9)))
    full = compare_backward("row strips: full 48x40", *scene, 48, 40,
                            full_cotangents=strip_cotangents)
    strips = [compare_backward(f"row strip {i} 48x20", *scene, 48, 20,
                               row_offset=20 * i, full_height=40,
                               full_cotangents=strip_cotangents)
              for i in range(2)]
    for kernel_name, full_grads, *strip_grads in zip(
            ("rasterize_fused_bwd", "rasterize_bary_bwd"), full, *strips):
        for label, whole, *parts in zip(("dclip", "dattr"), full_grads,
                                        *strip_grads):
            grad_error(f"row strips {kernel_name}", label, sum(parts), whole)
    log("kernel", "row strips: the two strips' gradients sum to the full "
        f"image's within {GRAD_RTOL} of its max |value|")
    empty = compare_backward("zero-triangle mesh 48x40", *scene[:2],
                             scene[2][:0], 48, 40)
    if any(float(g.abs().max()) != 0.0 for grads in empty for g in grads):
        raise AssertionError("zero-triangle mesh: gradients are not zero")
    compare_backward(f"teapot {TEAPOT_SIZE}^2 batch {TEAPOT_BATCH} A=9",
                     *teapot_raster, TEAPOT_SIZE, TEAPOT_SIZE)

    def reset_launch_counts():
        rc.LAUNCHES = rc.BWD_LAUNCHES = 0
        rb.FWD_LAUNCHES = rb.BWD_LAUNCHES = 0

    def launch_counts():
        return {"rasterize_fused_fwd": rc.LAUNCHES,
                "rasterize_fused_bwd": rc.BWD_LAUNCHES,
                "rasterize_bary_fwd": rb.FWD_LAUNCHES,
                "rasterize_bary_bwd": rb.BWD_LAUNCHES}

    # 4. The main path.
    reset_launch_counts()
    images = mesh_renderer.render(*scene_args, TEAPOT_SIZE, TEAPOT_SIZE)
    torch.cuda.synchronize()
    main_launches = launch_counts()
    if main_launches["rasterize_fused_fwd"] < 1:
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

    # 5. Train: the headline training step through the kernels.
    teapot_vertices = teapot["vertices"]

    def train_step(config=None):
        vertices = teapot_vertices.detach().requires_grad_(True)
        rendered = mesh_renderer.render(vertices, *scene_args[1:],
                                        TEAPOT_SIZE, TEAPOT_SIZE,
                                        config=config)
        loss = torch.mean(rendered[..., :3] ** 2)
        loss.backward()
        return loss, vertices.grad

    reset_launch_counts()
    loss, grad = train_step()
    torch.cuda.synchronize()
    train_launches = launch_counts()
    for name in ("rasterize_fused_fwd", "rasterize_fused_bwd"):
        if train_launches[name] < 1:
            raise AssertionError(f"the training step did not launch {name}")
    if not (bool(torch.isfinite(grad).all()) and bool(torch.isfinite(loss))):
        raise AssertionError("the training step's loss or gradient is not "
                             "finite")
    grad_scale = float(grad.abs().max())
    if not grad_scale > 0.0:
        raise AssertionError("the training step's gradient is zero")
    plain_loss, plain_grad = train_step(plain_cfg)
    train_err = float((grad - plain_grad).abs().max())
    plain_scale = float(plain_grad.abs().max())
    if not train_err <= TRAIN_RTOL * plain_scale:
        raise AssertionError(f"training step: kernel vs plain gradient max "
                             f"abs {train_err} > {TRAIN_RTOL} x {plain_scale}")
    log("train", f"teapot {TEAPOT_SIZE}^2 batch {TEAPOT_BATCH}, loss "
        f"mean(rgb^2) = {loss.item():.6f} (plain {plain_loss.item():.6f}); "
        f"launches {train_launches}; d loss/d vertices finite, max |.| "
        f"{grad_scale:.4g}; vs the plain step max abs {train_err:.3g} "
        f"(gate {TRAIN_RTOL} x {plain_scale:.4g})")

    # The 35-step cube-rotation recovery of tests/test_mesh_renderer.py:
    # clip_grad_norm_(1.0) + SGD(0.7, momentum 0.1) is
    # optax.chain(clip_by_global_norm(1.0), sgd(0.7, momentum=0.1)).
    cube_normals = cube[0] / torch.linalg.norm(cube[0], dim=1, keepdim=True)

    def render_with_rotation(angles):
        rot = camera.euler_matrices(angles)[0, :3, :3]
        eye = torch.tensor([[0.0, 0.0, 6.0]], **f32)
        return mesh_renderer.render(
            (cube[0] @ rot.T)[None], cube_tris, (cube_normals @ rot.T)[None],
            torch.ones(1, 8, 3, **f32), eye, torch.zeros(1, 3, **f32),
            torch.tensor([[0.0, 1.0, 0.0]], **f32), eye[:, None, :],
            torch.ones(1, 1, 3, **f32), 640, 480)[0]

    desired = render_with_rotation(torch.tensor([[-20.0, 0.0, 60.0]], **f32))
    angles = torch.zeros(1, 3, requires_grad=True, **f32)
    optimizer = torch.optim.SGD([angles], lr=0.7, momentum=0.1)
    reset_launch_counts()
    for _ in range(35):
        optimizer.zero_grad()
        loss = torch.mean(torch.abs(render_with_rotation(angles) - desired))
        loss.backward()
        torch.nn.utils.clip_grad_norm_([angles], 1.0)
        optimizer.step()
    with torch.no_grad():
        final = render_with_rotation(angles)
    torch.cuda.synchronize()
    rotation_launches = launch_counts()
    if rotation_launches["rasterize_fused_bwd"] < 35:
        raise AssertionError(f"cube rotation: launches {rotation_launches}")
    golden = os.path.join(golden_dir, "Gray_Cube_0.png")
    test_utils.expect_image_file_and_render_are_near(golden, desired)
    fraction = test_utils.expect_image_file_and_render_are_near(
        golden, final, max_outlier_fraction=0.01, pixel_error_threshold=0.04)
    log("train", f"cube rotation 640x480, 35 SGD steps from angles 0: "
        f"angles {[round(float(a), 4) for a in angles.detach()[0]]}, last "
        f"loss "
        f"{loss.item():.5f}; Gray_Cube_0.png {fraction:.5f} of "
        f"pixels outliers (gate 0.01 at 0.04); launches {rotation_launches}")

    # 6. The barycentric-only entry point, one teapot image at a time (it
    # is unbatched), with a backward.
    weights = cotangents((TEAPOT_SIZE, TEAPOT_SIZE, 3))
    reset_launch_counts()
    bary_clip = teapot_clip.detach().clone().requires_grad_(True)
    bary_out = [rasterize_ops.rasterize_barycentric(
        bary_clip[b], teapot["triangles"], TEAPOT_SIZE, TEAPOT_SIZE)
        for b in range(TEAPOT_BATCH)]
    sum((bc * weights).sum() for _, bc, _ in bary_out).backward()
    torch.cuda.synchronize()
    bary_launches = launch_counts()
    for name in ("rasterize_bary_fwd", "rasterize_bary_bwd"):
        if bary_launches[name] < 1:
            raise AssertionError(f"rasterize_barycentric did not launch "
                                 f"{name}")
    fused_ids, fused_bc = rc.rasterize_interpolate_cuda(
        *teapot_raster, TEAPOT_SIZE, TEAPOT_SIZE)[:2]
    for b, (ids_b, bc_b, z_b) in enumerate(bary_out):
        if not (torch.equal(ids_b, fused_ids[b])
                and torch.equal(bc_b.detach(), fused_bc[b])):
            raise AssertionError(f"rasterize_barycentric image {b} differs "
                                 "from the fused path")
        if not bool(((z_b >= -1.0) & (z_b <= 1.0)).all()):
            raise AssertionError(f"rasterize_barycentric image {b}: z out of "
                                 "[-1, 1]")
    bary_grad = bary_clip.grad
    if not (bool(torch.isfinite(bary_grad).all())
            and float(bary_grad.abs().max()) > 0.0
            and bool((bary_grad[..., 2] == 0.0).all())):
        raise AssertionError("rasterize_barycentric: the clip gradient is "
                             "not finite, zero, or has a z component")
    log("bary", f"rasterize_barycentric teapot {TEAPOT_SIZE}^2 x "
        f"{TEAPOT_BATCH} images + backward: launches {bary_launches}; ids "
        "and bc equal the fused path's; gradient finite, non-zero, no z")

    # 7. Times at the headline size (CUDA events, median of 5 windows).
    kernel_ms = cuda_time_ms(lambda: rc.rasterize_interpolate_cuda(
        *teapot_raster, TEAPOT_SIZE, TEAPOT_SIZE), iters=20)
    plain_ms = cuda_time_ms(lambda: rc.rasterize_interpolate_torch(
        *teapot_raster, TEAPOT_SIZE, TEAPOT_SIZE), iters=3)
    table, inv_abs_det = rc.pack_rows(teapot_clip, teapot["triangles"], True)
    corner = rc.pack_corner_attributes(teapot_attrs, teapot["triangles"])
    launch_ms = cuda_time_ms(lambda: rc.launch_fused_fwd(
        table, corner, TEAPOT_SIZE, TEAPOT_SIZE, 0, TEAPOT_SIZE, False),
        iters=20)
    ids, bc, _ = rc.launch_fused_fwd(table, corner, TEAPOT_SIZE, TEAPOT_SIZE,
                                     0, TEAPOT_SIZE, False)
    g_bc = cotangents(tuple(bc.shape))
    g_attr = cotangents(tuple(ids.shape) + (teapot_attrs.shape[-1],))
    fused = (ids, bc, g_bc, g_attr, table, inv_abs_det, corner)
    bary = (ids, bc, g_bc, table, inv_abs_det)
    no_attrs = torch.zeros(TEAPOT_BATCH, table.shape[1], 3, 0, **f32)
    ms = {
        "rasterize_fused_fwd": (kernel_ms, plain_ms),
        "rasterize_fused_bwd": (
            cuda_time_ms(lambda: rc.launch_fused_bwd(*fused), iters=20),
            cuda_time_ms(lambda: rc.triangle_gradients_torch(*fused),
                         iters=5)),
        "rasterize_bary_fwd": (
            cuda_time_ms(lambda: rb.launch_bary_fwd(
                table, TEAPOT_SIZE, TEAPOT_SIZE, 0, TEAPOT_SIZE), iters=20),
            cuda_time_ms(lambda: rc.forward_torch_packed(
                table, no_attrs, TEAPOT_SIZE, TEAPOT_SIZE, 0, TEAPOT_SIZE,
                True), iters=3)),
        "rasterize_bary_bwd": (
            cuda_time_ms(lambda: rb.launch_bary_bwd(*bary), iters=20),
            cuda_time_ms(lambda: rb.triangle_gradients_bary_torch(*bary),
                         iters=5)),
    }
    backward_ms = cuda_time_ms(lambda: rc.rasterize_interpolate_backward_cuda(
        *fused, teapot["triangles"], teapot_clip.shape[1]), iters=20)
    plain_backward_ms = cuda_time_ms(
        lambda: rc.rasterize_interpolate_backward_torch(
            *fused, teapot["triangles"], teapot_clip.shape[1]), iters=5)
    render_ms = cuda_time_ms(lambda: mesh_renderer.render(
        *scene_args, TEAPOT_SIZE, TEAPOT_SIZE), iters=20)
    train_ms = cuda_time_ms(train_step, iters=20)
    log("times", f"{card} | fused rasterize, teapot {TEAPOT_SIZE}^2 batch "
        f"{TEAPOT_BATCH}, A=9: kernel wrapper {kernel_ms:.4f} ms (kernel "
        f"launch alone {launch_ms:.4f} ms), plain version {plain_ms:.4f} ms")
    for name in ("rasterize_fused_bwd", "rasterize_bary_fwd",
                 "rasterize_bary_bwd"):
        log("times", f"{card} | {name}, teapot {TEAPOT_SIZE}^2 batch "
            f"{TEAPOT_BATCH}: kernel launch {ms[name][0]:.4f} ms, plain "
            f"version {ms[name][1]:.4f} ms")
    log("times", f"{card} | fused backward with the vertex scatter: via "
        f"the kernel {backward_ms:.4f} ms, plain {plain_backward_ms:.4f} ms")
    log("times", f"{card} | render forward, teapot {TEAPOT_SIZE}^2 batch "
        f"{TEAPOT_BATCH}: {render_ms:.4f} ms, "
        f"{TEAPOT_BATCH * 1000.0 / render_ms:.2f} renders/s")
    log("times", f"{card} | training step (render + mean(rgb^2) + backward "
        f"to the vertices), teapot {TEAPOT_SIZE}^2 batch {TEAPOT_BATCH}: "
        f"{train_ms:.4f} ms, {TEAPOT_BATCH * 1000.0 / train_ms:.2f} "
        "renders/s")

    # Each kernel's launches on the path that runs it: K1 on the forward
    # render, K2 on the training step, K3 and K4 on rasterize_barycentric.
    launches = {"rasterize_fused_fwd": main_launches["rasterize_fused_fwd"],
                "rasterize_fused_bwd": train_launches["rasterize_fused_bwd"],
                "rasterize_bary_fwd": bary_launches["rasterize_bary_fwd"],
                "rasterize_bary_bwd": bary_launches["rasterize_bary_bwd"]}
    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches[name],
        "max_abs_err": errors[name], "ms": ms[name][0],
        "plain_ms": ms[name][1]}
        for name, (source, replaces) in KERNELS.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
