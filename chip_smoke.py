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
               and attributes within 1e-6. K1 also at each split tried
               (clusters of 2, 4 and 8 CTAs per group of pixel blocks):
               every split bit for bit the compiled one's, and its ids, bc
               and z bit for bit K3's at its launcher's rule and at each
               group and split tried (also on a scene of exact depth ties,
               one image and two). Backward kernels (K2 fused, K4
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
               forward render, and the training step. Then K1-K4 alone
               (utils/hard_work.py): their registers, spills and CTAs per
               SM; K1's launch and device times at its compiled split and
               at each split tried on the teapot, on the teapot's floor
               (its table moved off screen, so that no row passes the
               cull) and on sphere72 at 512x512 batch 4; K2's with A = 9
               on the teapot and sphere72 and on its floor (every pixel
               inactive); K3's and K4's on the teapot and sphere72 for one
               image and for four, K3 at its launcher's rule and at each
               group and split, K4 also on its floor; the K1 cull's counts
               and where K2's work falls.

The soft (SoftRas) renderer's phases follow:

  8. soft-kernel — K5-K8 vs their plain versions: the 16x16 two-triangle
               scene, the cube, random scenes with 1 and 3 lights, the
               edge scenes (65 and 0 lights, a quad of two triangles
               filling a 256x256 frame, a batch whose second image holds no
               valid pair, whose gradients must be exactly 0, and a sphere
               at 45x31 whose edges run through pixel centres, where a
               corner weight is exactly 0: test_utils.on_edges_arrays), two
               row strips against the full image, the zero-triangle mesh, the
               256x256 batch-4 teapot and a sphere of 49,298 triangles at
               64x64 in one launch per kernel and split. K7 and K5 run at
               their compiled split and at each split tried (clusters of 4
               and 8 CTAs per pixel block), K6 at each of 4, 8 and 16 too.
               Forward: rgb within 2e-5 abs + 1e-4 rel, alpha within 1e-6,
               K7's outputs equal at every split and K5's alpha at every
               split equal to K7's, bit for bit. Backward, under seeded
               cotangents with rgb and alpha parts: within 1e-4 of each
               plain tensor's max |value|, the table gradient's per group
               of columns that come from one input of the packing (clip,
               world, normals, colours).
  9. soft-main — `soft_mesh_renderer.render` on the teapot at 256x256 batch
               4 with 2 lights, counting K7 launches, against the plain
               route.
 10. soft-train — bench.py's soft step (render, loss mean(alpha^2),
               backward to the vertices) at 128x128 and 256x256 batch 4,
               counting K7/K8, and its silhouette step, counting K5/K6;
               each against the plain step (1e-4 of max |grad|).
 11. fit     — the flagship cow fit (examples/fit_shape_multiview.py at
               docs/flagship/README.md's settings, 128x128, 4 views, sphere
               resolution 24): 100 Adam steps through K5/K6, whose loss
               must fall; 10 steps with both routes in lockstep (losses
               within 1e-4 relative, gradients within 1e-4 of max |grad|);
               10 separate plain steps, their drift reported.
 12. soft-times — CUDA-event medians of each soft kernel vs its plain
               version, the soft render, the soft steps, the silhouette
               step and the fit step, and device time by kernel from
               torch.profiler. Then K5, K6, K7 and K8 alone
               (utils/soft_work.py): each one's registers, spills, shared
               memory and CTAs per SM, and its launch and device times at
               its compiled split and at each split of a pixel block's
               triangles tried (K5 clusters of 4 and 8 at the teapot
               256x256, its floor and the fit's shape; K6 4, 8, 16 CTAs at
               the teapot 256x256 and the fit's shape; K7 clusters of 4 and
               8 at the teapot 256x256 and 128x128; K8 4, 8, 16 at both
               teapot sizes); the counts of where their work falls.

The design microbenchmarks of scripts/ (S1-S3), ported in
pytorch_mesh_renderer_tpu_torch/microbench/, follow:

 13. microbench — each module's run as `python -m` runs it (mxu_edge and
               mxu_full at 512 visits of 8 triangles, patch_scatter at
               the headline and the stress config), counting launches and
               printing each JSON line; both patch merges must give K3's
               ids with bc and z within 1e-6 and drop no triangle. Then
               each kernel vs its plain version at those shapes: fma,
               prod and patch_eval bit for bit (prod also on a table of
               exact depth ties across its splits), the tensor-core
               variants within their modules' tolerances (TC_RTOL,
               check_tc; tc also on a table whose edges pass through its
               cull regions' corner pixel centres); each kernel's launch
               shape (CTAs per SM) and device time (torch.profiler), its
               plain version's and, for mxu_edge, torch.matmul + sum's;
               for patch_eval its bound over every slot it writes, and
               beside it the bound over the live instances alone.

The training step and loop, and the bench, follow:

 14. loop    — `parallel.make_train_step` and `make_train_loop` on the
               card (each captures its step into a CUDA graph): for the
               hard step, the soft step at 128x128, the silhouette step and
               bench.py's pose fit, 3 steps of the loop, 3 calls of the
               step and 3 eager steps from one start agree in losses and
               parameters (bit for bit where four eager runs do, else within
               1e-4, the eager spread printed beside it); then the bench's
               hard, soft 128^2, silhouette 128^2 and pose modes
               (`python -m pytorch_mesh_renderer_tpu_torch.bench`) in
               process with fewer iterations, each JSON line printed.

The example CLIs follow:

 15. examples — each CLI of pytorch_mesh_renderer_tpu_torch/examples/
               run in process by its `main` at its default `--device cuda`,
               into a temporary directory, counting launches: the hard
               teapot at 640x480 (K1) and the soft at 100x100 (K7), each
               PNG read back within 1 uint8 level of the plain route's
               render; the cube rotation hard (K1, K2) and --soft (K7, K8),
               50 steps, and the teapot rotation hard with --scan-chunk 10
               and --soft, 60 steps, each final loss finite and below its
               first; the camera pose, 100 steps, its losses finite. Before
               each optimization its first-step gradient (the angles, and
               the eye of the camera pose) through the kernels is held
               against the plain route's on its own render, start and
               target (GRAD_RTOL hard, SOFT_GRAD_RTOL soft). K6 called
               twice on the teapot 256x256 batch 4, the cow fit's shape and
               the pose_tie scene gives the same bits. The flagship cow
               fit at docs/flagship/README.md's command (K5, K6) on the
               vendored targets, its epoch-99 and epoch-1999 lines within
               FLAGSHIP_BANDS of docs/flagship/trajectory.log, and its
               seconds per 1,000 epochs; 200 epochs with --checkpoint as
               two invocations of 100: the checkpoint holds the first's end
               state, the second starts from it and saves Adam at step 200,
               and ends within RESUME_RTOL of two invocations of 200, which
               must equal each other bit for bit (K6 and the vertex
               scatters sum in a fixed order); the native OBJ parser's
               teapot against the Python parser's, and both parsers' times.

The sharded wrappers follow:

 16. shard   — `parallel.sharded_rasterize`, `sharded_soft_rasterize` and
               `sharded_soft_silhouette` on meshes of 2x2, 4x1 and 1x4 cells
               over the one card (SHARD_MESHES: the card repeated), each
               cell launching the kernels (K1 and K2, K7 and K8, K5 and K6
               once per cell, counted): the teapot 256x256 batch 4 rendered
               and shaded as `mesh_renderer.render` does, the soft teapot
               at 128x128 batch 4 and the cow fit's silhouettes (128x128, 4
               views) equal the unsharded renders bit for bit, and their
               vertex gradients (of mean(out^2)) lie within GRAD_RTOL (hard)
               and TRAIN_RTOL (soft) of max |unsharded|, the silhouette's
               also within SHARD_SIL_SCALED_ATOL after scaling; the fit step
               through the 2x2 mesh, captured, equals its eager steps and
               itself bit for bit; the flagship at its README command on
               the 2x2 mesh lands in FLAGSHIP_BANDS at epoch 1999 and
               repeats bit for bit; the captured and eager hard teapot step
               and fit step by CUDA events, unsharded and on each mesh (the
               sharded-vs-unsharded overhead on one card).
 17. multiprocess — the same wrappers across processes
               (`utils/ranks.py`, after the build of phase 2): 2 ranks,
               then 4, each a subprocess on the one card over gloo with
               its own timeout (RANK_TIMEOUT), rendering its own cells
               (`parallel/collectives.py`): the teapot 256x256 batch 4
               hard on the 2x1 mesh, the explicit 2x2 list (each rank
               holding the card twice) and 4x1, the soft teapot at 128x128
               batch 4 on 2x1, each output bit for bit the unsharded render
               on the kernels and its gradient within GRAD_RTOL (hard) or
               TRAIN_RTOL (soft), the ranks bit for bit equal, two runs in
               each rank with equal outputs and gradients within the same
               gate (K2 and K8 add with atomics), the kernels launched in
               every rank; 5 eager Adam steps of the cow fit (128x128, 4
               views) on 2 ranks, within TRAIN_RTOL of 5 unsharded steps,
               the ranks' parameters bit for bit equal, two runs bit for
               bit equal, and a capture on the mesh
               raises naming step.run_eager; the eager fit step's ms on 2
               ranks, in one process on the 2x1 mesh and unsharded. NCCL
               (one rank per card) is not exercised on one card.

Then it prints the kernel summary as one JSON line (with each kernel's
bound: the larger of its bytes over 3.35 TB/s and its operations over the
card's peak for their type, fp32 at 67 TFLOP/s and tensor-core TF32 at 495
or bf16 at 989, counted from this run's inputs) and, last, the device line
`{"ok": true, "device": {...}}`. Any failed phase raises and the exit
code is non-zero; without a CUDA device it exits non-zero before printing
any result.
"""

import json
import os
import re
import sys
import time


REPO = os.path.dirname(os.path.abspath(__file__))
CSRC = "pytorch_mesh_renderer_tpu_torch/csrc/"
PALLAS = "pytorch_mesh_renderer_tpu/ops/rasterize_pallas.py:"
SOFT_PALLAS = "pytorch_mesh_renderer_tpu/ops/soft_rasterize_pallas.py:"
# name -> (source, the TPU kernel it replaces).
KERNELS = {
    "rasterize_fused_fwd": (CSRC + "rasterize_fused_fwd.cu", PALLAS + "1059"),
    "rasterize_fused_bwd": (CSRC + "rasterize_fused_bwd.cu", PALLAS + "1282"),
    "rasterize_bary_fwd": (CSRC + "rasterize_bary_fwd.cu", PALLAS + "348"),
    "rasterize_bary_bwd": (CSRC + "rasterize_bary_bwd.cu", PALLAS + "676"),
    "soft_sil_fwd": (CSRC + "soft_sil_fwd.cu", SOFT_PALLAS + "835"),
    "soft_sil_bwd": (CSRC + "soft_sil_bwd.cu", SOFT_PALLAS + "881"),
    "soft_fwd": (CSRC + "soft_fwd.cu", SOFT_PALLAS + "422"),
    "soft_bwd": (CSRC + "soft_bwd.cu", SOFT_PALLAS + "496"),
    "mxu_edge_fma": (CSRC + "mxu_edge.cu",
                     "scripts/mxu_edge_microbench.py:117"),
    "mxu_edge_tc_bf16": (CSRC + "mxu_edge.cu",
                         "scripts/mxu_edge_microbench.py:144"),
    "mxu_edge_tc_tf32x3": (CSRC + "mxu_edge.cu",
                           "scripts/mxu_edge_microbench.py:144"),
    "mxu_full_prod": (CSRC + "mxu_full.cu",
                      "scripts/mxu_full_microbench.py:85"),
    "mxu_full_tc": (CSRC + "mxu_full.cu",
                    "scripts/mxu_full_microbench.py:113"),
    "patch_eval": (CSRC + "patch_eval.cu",
                   "scripts/patch_scatter_microbench.py:191"),
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
# Eager runs of each phase-14 step that must agree bit for bit before its
# captured runs are held to them bit for bit.
EAGER_RUNS = 4
TEAPOT_SIZE, TEAPOT_BATCH = 256, 4
# Table columns each soft kernel reads (csrc/soft_common.cuh): K5 and K6
# the geometry phase's 29 (0-17, 21-25, 53-58), K7 and K8 all but the clip
# w (18-20). K6 and K8 write the whole [B, T, 59] gradient table. The soft
# kernels' gates against their plain versions are utils/test_utils'
# (SOFT_RGB_ATOL, SOFT_ALPHA_ATOL, SOFT_GRAD_RTOL, ...).
SOFT_COLS_READ = {"soft_fwd": 56, "soft_bwd": 56, "soft_sil_fwd": 29,
                  "soft_sil_bwd": 29}
# The flagship fit's log at epoch 99 (docs/flagship/trajectory.log:3),
# printed beside this run's numbers, not gated: the TPU run reduced its
# gradients at bf16 precision.
FLAGSHIP_EPOCH_99 = {"loss": 0.05465, "iou": 0.7842}
# Phase 15 holds the port's flagship run to trajectory.log's lines at
# epochs 99 and 1999 (docs/flagship/trajectory.log:3, :41), a quality
# reference (its seconds are a TPU's and are not quoted): (loss relative,
# IoU absolute) bands. At epoch 99 the card's runs lie around the log,
# within its +-2% / +-0.01; at epoch 1999 the port fits better than the
# TPU's bf16 run did, on the kernels and on the plain route alike (-5.9%
# to +0.2% in loss over runs whose gradients' last bits differed,
# `utils/fit_spread.py`, PERF.md §6), so the band there is one-sided: a
# run may fit better than the log, not worse.
FLAGSHIP_LOG = {99: {"loss": 0.05465, "iou": 0.7842},
                1999: {"loss": 0.05328, "iou": 0.7853}}
FLAGSHIP_BANDS = {99: ((-0.02, 0.02), (-0.01, 0.01)),
                  1999: ((-0.10, 0.02), (-0.01, 0.03))}
FLAGSHIP_ARGS = ["--size", "128", "--resolution", "24", "--scan-chunk", "100",
                 "--preview-every", "100"]
# The resumed invocation's first loss against the loss at the saved state.
RESUME_START_RTOL = 1e-6
# 100 + 100 epochs through --checkpoint against 200 straight on the
# kernels (K6 and the vertex scatters sum in a fixed order, so the fit
# repeats): loss relative, vertices of max |v|.
RESUME_RTOL = 1e-4
# Phase 16's meshes over the one card, (data, space).
SHARD_MESHES = ((2, 2), (4, 1), (1, 4))
# The silhouette gradient, sharded vs unsharded, after scaling by max
# |unsharded| (tests/test_parallel.py's gate).
SHARD_SIL_SCALED_ATOL = 2e-4
# load_obj calls timed per parser on the teapot.
LOAD_OBJ_RUNS = 5
# Phase 17: each rank's seconds to start, run its job and exit.
RANK_TIMEOUT = 300.0

CUBE_VERTICES = [[-1, -1, 1], [-1, -1, -1], [-1, 1, -1], [-1, 1, 1],
                 [1, -1, 1], [1, -1, -1], [1, 1, -1], [1, 1, 1]]
CUBE_TRIANGLES = [[0, 1, 2], [2, 3, 0], [3, 2, 6], [6, 7, 3], [7, 6, 5],
                  [5, 4, 7], [4, 5, 1], [1, 0, 4], [5, 6, 2], [2, 1, 5],
                  [7, 4, 0], [0, 3, 7]]


def log(phase, message):
    print(f"[{phase}] {message}", flush=True)


def cuda_time_ms(fn, iters, windows=5, warmup=3):
    """Median over `windows` of the mean per-call time, by CUDA events
    (microbench.common.wall_ms on the card)."""
    import torch

    from pytorch_mesh_renderer_tpu_torch.microbench import common

    return common.wall_ms(fn, torch.device("cuda"), iters, windows, warmup)


def grad_error(name, label, kernel, plain, rtol):
    """(max abs error, max |plain|) of a backward kernel's tensor against
    its plain version's; fails above rtol x max |plain| or if not finite."""
    import torch

    torch.cuda.synchronize()
    if kernel.shape != plain.shape:
        raise AssertionError(f"{name}: {label} shape {kernel.shape} vs "
                             f"{plain.shape}")
    if not bool(torch.isfinite(kernel).all()):
        raise AssertionError(f"{name}: {label} is not finite")
    err = float((kernel - plain).abs().max()) if plain.numel() else 0.0
    scale = float(plain.abs().max()) if plain.numel() else 0.0
    if not err <= rtol * scale:
        raise AssertionError(f"{name}: {label} max abs {err} > {rtol} x "
                             f"{scale}")
    return err, scale


# The repository's kernels by their __global__ names in csrc/.
KERNEL_NAME = re.compile(r"(rasterize|soft)\w*_kernel")


def kernel_device_ms(by_name):
    """'name ms, ...' of the repository's kernels in a device_profile's
    breakdown."""
    from pytorch_mesh_renderer_tpu_torch.microbench.common import EVENTS_ONLY

    if EVENTS_ONLY in by_name:
        return EVENTS_ONLY
    return ", ".join(
        f"{match.group(0)} {t:.4f} ms" for name, t in by_name.items()
        for match in [KERNEL_NAME.search(name)] if match)


def reset_hard_launch_counts():
    from pytorch_mesh_renderer_tpu_torch.ops import (
        rasterize_barycentric_cuda as rb)
    from pytorch_mesh_renderer_tpu_torch.ops import rasterize_cuda as rc

    rc.LAUNCHES = rc.BWD_LAUNCHES = 0
    rb.FWD_LAUNCHES = rb.BWD_LAUNCHES = 0


def hard_launch_counts():
    from pytorch_mesh_renderer_tpu_torch.ops import (
        rasterize_barycentric_cuda as rb)
    from pytorch_mesh_renderer_tpu_torch.ops import rasterize_cuda as rc

    return {"rasterize_fused_fwd": rc.LAUNCHES,
            "rasterize_fused_bwd": rc.BWD_LAUNCHES,
            "rasterize_bary_fwd": rb.FWD_LAUNCHES,
            "rasterize_bary_bwd": rb.BWD_LAUNCHES}


def reset_soft_launch_counts():
    from pytorch_mesh_renderer_tpu_torch.ops import soft_rasterize_cuda as sc

    sc.FWD_LAUNCHES = sc.BWD_LAUNCHES = 0
    sc.SIL_FWD_LAUNCHES = sc.SIL_BWD_LAUNCHES = 0


def soft_launch_counts():
    from pytorch_mesh_renderer_tpu_torch.ops import soft_rasterize_cuda as sc

    return {"soft_sil_fwd": sc.SIL_FWD_LAUNCHES,
            "soft_sil_bwd": sc.SIL_BWD_LAUNCHES,
            "soft_fwd": sc.FWD_LAUNCHES, "soft_bwd": sc.BWD_LAUNCHES}


def fit_phase(dev, card):
    """Phase 11: the flagship multi-view cow silhouette fit
    (examples/fit_shape_multiview.py at docs/flagship/README.md's settings)
    through K5/K6, against the plain route; then its kernels' and its
    step's times and device profile. Returns the fit's launch counts."""
    import numpy as np
    import torch

    from pytorch_mesh_renderer_tpu_torch import config as config_lib
    from pytorch_mesh_renderer_tpu_torch.microbench.common import (
        device_profile)
    from pytorch_mesh_renderer_tpu_torch.models import (shapes,
                                                        soft_mesh_renderer)
    from pytorch_mesh_renderer_tpu_torch.ops import losses, mesh
    from pytorch_mesh_renderer_tpu_torch.ops import soft_rasterize_cuda as sc
    from pytorch_mesh_renderer_tpu_torch.utils import test_utils
    from pytorch_mesh_renderer_tpu_torch.utils.cost import pixel_pairs

    f32 = dict(dtype=torch.float32, device=dev)
    plain_cfg = config_lib.SoftRasterizerConfig(backend="torch")

    fit_size, n_views = 128, 4
    verts0, fit_tris, _ = shapes.sphere(0.5, resolution=24)
    verts0, fit_tris = verts0.to(dev), fit_tris.to(dev)
    edges = mesh.compute_edges_list(fit_tris)
    phis = np.linspace(0.0, 2 * np.pi, n_views, endpoint=False)
    eyes = torch.tensor(np.stack([2.0 * np.sin(phis), 0.3 * np.ones(n_views),
                                  2.0 * np.cos(phis)], -1), **f32)
    centers = torch.zeros(n_views, 3, **f32)
    ups = torch.tensor([[0.0, 1.0, 0.0]] * n_views, **f32)
    targets = []
    for i in range(1, n_views + 1):
        img = test_utils.read_png(os.path.join(
            REPO, "assets", "example_targets", f"example7b_target{i}.png"))
        alpha = img[..., 3].astype(np.float32) / 255.0
        ys = np.arange(fit_size) * alpha.shape[0] // fit_size
        xs = np.arange(fit_size) * alpha.shape[1] // fit_size
        targets.append(alpha[ys][:, xs])
    targets = torch.tensor(np.stack(targets), **f32)

    def alphas(vertices, config=None):
        return soft_mesh_renderer.render_silhouette(
            vertices[None].expand(n_views, -1, -1), fit_tris, eyes, centers,
            ups, fit_size, fit_size, sigma_val=3e-5, config=config)

    def fit_loss(offsets, config=None):
        vertices = verts0 + offsets
        return (losses.silhouette_mse_loss(alphas(vertices, config), targets)
                + 0.3 * losses.edge_loss(vertices, edges)
                + 0.1 * losses.laplacian_smoothing_loss(vertices, edges))

    def fit_stepper(config=None):
        """(one Adam step of the fit from offsets 0, returning its loss;
        the offsets)."""
        offsets = torch.zeros_like(verts0, requires_grad=True)
        opt = torch.optim.Adam([offsets], lr=1e-2)

        def step():
            opt.zero_grad()
            loss = fit_loss(offsets, config)
            loss.backward()
            opt.step()
            return loss.detach()

        return step, offsets

    def fit(steps, config=None):
        """(losses per step, final mean binarized IoU, ms per step)."""
        step, offsets = fit_stepper(config)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        history = [step() for _ in range(steps)]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / steps
        with torch.no_grad():
            got = alphas(verts0 + offsets) > 0.5
        want = targets > 0.5
        iou = float(((got & want).sum((1, 2)) / (got | want).sum(
            (1, 2)).clamp(min=1)).mean())
        return [float(x) for x in history], iou, ms

    reset_soft_launch_counts()
    fit_losses, fit_iou, _ = fit(100)
    fit_launches = soft_launch_counts()
    if fit_launches["soft_sil_fwd"] < 100 or fit_launches["soft_sil_bwd"] \
            < 100:
        raise AssertionError(f"fit: launches {fit_launches}")
    if not fit_losses[-1] < fit_losses[0]:
        raise AssertionError(f"fit: the loss did not fall ({fit_losses[0]}"
                             f" -> {fit_losses[-1]})")
    # The first 10 steps through both routes in lockstep: at each step both
    # take the loss and its gradient at the same offsets, and Adam steps
    # with the kernels' gradient. Two separate trajectories are compared
    # too, but not gated: Adam moves each offset by about lr * sign(g), so
    # the routes' last-bit differences in a gradient component near zero
    # can flip a whole step of that offset, and the two runs drift apart.
    step_errors = []
    offsets = torch.zeros_like(verts0, requires_grad=True)
    opt = torch.optim.Adam([offsets], lr=1e-2)
    for _ in range(10):
        plain_loss = fit_loss(offsets, plain_cfg)
        (plain_grad,) = torch.autograd.grad(plain_loss, offsets)
        opt.zero_grad()
        loss = fit_loss(offsets)
        loss.backward()
        step_errors.append((
            abs(loss.item() - plain_loss.item()) / abs(plain_loss.item()),
            grad_error("fit lockstep", "d loss/d offsets", offsets.grad,
                       plain_grad, TRAIN_RTOL)))
        opt.step()
    lockstep_err = max(err for err, _ in step_errors)
    if not lockstep_err <= 1e-4:
        raise AssertionError(f"fit: kernel vs plain losses differ by "
                             f"{lockstep_err} relative")
    grad_err = max(err / scale for _, (err, scale) in step_errors)
    plain_losses, _, _ = fit(10, plain_cfg)
    drift = max(abs(a - b) / abs(b) for a, b in zip(fit_losses,
                                                    plain_losses))
    log("fit", f"cow fit {fit_size}^2 x {n_views} views, sphere "
        f"{fit_tris.shape[0]} triangles, Adam 1e-2, sigma 3e-5: loss "
        f"{fit_losses[0]:.5f} -> {fit_losses[-1]:.5f} at step 99, mean IoU "
        f"{fit_iou:.4f} after 100 steps (the TPU log at epoch 99: loss "
        f"{FLAGSHIP_EPOCH_99['loss']}, IoU {FLAGSHIP_EPOCH_99['iou']}; "
        f"differences {fit_losses[-1] - FLAGSHIP_EPOCH_99['loss']:+.5f}, "
        f"{fit_iou - FLAGSHIP_EPOCH_99['iou']:+.4f}, not gated); launches "
        f"{fit_launches}; 10 steps in lockstep with the plain route: loss "
        f"max rel {lockstep_err:.3g} (gate 1e-4), gradient max "
        f"{grad_err:.3g} of max |grad| (gate {TRAIN_RTOL}); 10 separate "
        f"plain steps drift from the kernels' by {drift:.3g} relative "
        "(not gated)")

    # The silhouette kernels at the fit's shape (128^2 x 4 views).
    fit_clip = test_utils.clip_from_eye(
        verts0[None].expand(n_views, -1, -1), eyes, fit_size, fit_size)
    zeros = torch.zeros(n_views, verts0.shape[0], 3, **f32)
    fit_table = sc.pack_triangle_data(fit_clip, fit_tris, zeros, zeros, zeros,
                                      0.01)
    fit_params = sc.make_params(3e-5, 1.0, 0.01, 0, dev)
    fit_alpha = sc.launch_sil_fwd(fit_table, fit_params, fit_size, fit_size,
                                  fit_size)
    fit_d_alpha = torch.randn(
        tuple(fit_alpha.shape),
        generator=torch.Generator(device=dev).manual_seed(9), **f32)
    fit_pairs = pixel_pairs(fit_table[..., 22], fit_table[..., 23],
                            fit_table[..., 24], fit_table[..., 25],
                            fit_table[..., 21] > 0, fit_size, fit_size)
    fit_sil_ms = (
        cuda_time_ms(lambda: sc.launch_sil_fwd(
            fit_table, fit_params, fit_size, fit_size, fit_size), iters=20),
        cuda_time_ms(lambda: sc.launch_sil_bwd(
            fit_table, fit_params, fit_alpha, fit_d_alpha, fit_size),
            iters=20))
    log("soft-times", f"{card} | fit shape {fit_size}^2 x {n_views} views, "
        f"{fit_tris.shape[0]} triangles ({fit_pairs} pairs): soft_sil_fwd "
        f"launch {fit_sil_ms[0]:.4f} ms, soft_sil_bwd launch "
        f"{fit_sil_ms[1]:.4f} ms")

    _, _, fit_step_ms = fit(50)
    log("soft-times", f"{card} | fit step ({fit_size}^2 x {n_views} views, "
        f"render_silhouette + losses + backward + Adam): {fit_step_ms:.4f} "
        "ms per step (host clock over 50 steps)")
    by_name, device_ms, n_kernels = device_profile(fit_stepper()[0],
                                                   iters=10)
    log("soft-times", f"{card} | profile fit step: device kernel time "
        f"{device_ms:.4f} ms per step in {n_kernels:.0f} kernels; idle "
        f"share {1.0 - device_ms / fit_step_ms:.3f} of the unprofiled "
        f"{fit_step_ms:.4f} ms; {kernel_device_ms(by_name)}")
    return fit_launches


def soft_phases(dev, card, teapot):
    """Phases 8-12: the soft renderer's kernels K5-K8 on the card.

    `teapot` is the headline scene dict of main() (CW triangles, RGB
    intensities); the soft path takes its triangles reversed (CCW) and one
    intensity per light, as bench.py:bench_soft does. Returns
    (errors, relative errors, launches, ms, bounds), each keyed by kernel
    name.
    """
    import torch

    from pytorch_mesh_renderer_tpu_torch import config as config_lib
    from pytorch_mesh_renderer_tpu_torch.microbench.common import (
        device_profile)
    from pytorch_mesh_renderer_tpu_torch.models import soft_mesh_renderer
    from pytorch_mesh_renderer_tpu_torch.ops import soft_rasterize_cuda as sc
    from pytorch_mesh_renderer_tpu_torch.utils import kernels, soft_work
    from pytorch_mesh_renderer_tpu_torch.utils import test_utils
    from pytorch_mesh_renderer_tpu_torch.utils.cost import (
        SOFT_OPS_PER_PAIR, bound_ms, pixel_pairs)

    names = ("soft_sil_fwd", "soft_sil_bwd", "soft_fwd", "soft_bwd")
    errors = {name: 0.0 for name in names}
    plain_cfg = config_lib.SoftRasterizerConfig(backend="torch")

    # 8. soft-kernel: K5-K8 vs their plain versions, on test_utils' scenes
    # and under its gates (shared with tests/test_torch_cuda.py).
    worst = {}  # (kernel, tensor) -> max abs error / max |plain value|

    sil_splits = test_utils.soft_splits("soft_sil_bwd")
    fwd_splits = test_utils.soft_splits("soft_fwd")
    sil_fwd_splits = test_utils.soft_splits("soft_sil_fwd")

    def compare_soft(name, scene, row_offset=0, full_height=None,
                     d_rgba=None):
        """The four soft kernels vs their plain versions on one scene, K7,
        K5 and K6 at each split tried. Returns K7's outputs, K5's alpha and
        K8's and K6's dtables."""
        k7, alpha, found = test_utils.compare_soft_forward(
            scene, row_offset, full_height, fwd_splits, sil_fwd_splits)
        if d_rgba is None:
            d_rgba = test_utils.soft_cotangents(
                scene.table.shape[0], scene.height, scene.width, dev)
        dtable, sil_dtable, bwd_found = test_utils.compare_soft_backward(
            scene, k7, alpha, d_rgba, row_offset, full_height, sil_splits)
        found.update(bwd_found)
        report = []
        for kernel_name, entries in found.items():
            for label, err, scale in entries:
                errors[kernel_name] = max(errors[kernel_name], err)
                if scale > 0.0:
                    key = (kernel_name, label)
                    worst[key] = max(worst.get(key, 0.0), err / scale)
                    report.append(f"{kernel_name} {label} {err:.3g} of "
                                  f"{scale:.3g}")
        log("soft-kernel", f"{name}: alpha of soft_sil_fwd at splits "
            f"{sil_fwd_splits} == soft_fwd; "
            "max abs error of max |plain| (parts whose plain value is 0 "
            "are 0 in the kernel too): " + ", ".join(report))
        return k7, alpha, dtable, sil_dtable

    for name in test_utils.SOFT_SCENES:
        compare_soft(name, test_utils.soft_scene(name, dev))
    for name in test_utils.SOFT_EDGE_SCENES:
        k7, _, dtable, sil_dtable = compare_soft(
            name, test_utils.soft_scene(name, dev))
        if name == "empty_image" and not (
                torch.equal(k7[0][1], torch.zeros_like(k7[0][1]))
                and torch.equal(dtable[1], torch.zeros_like(dtable[1]))
                and torch.equal(sil_dtable[1],
                                torch.zeros_like(sil_dtable[1]))):
            raise AssertionError("empty_image: the second image is not "
                                 "background with a zero table gradient")

    # Row strips: forward rows equal the full image's; the strips' table
    # gradients sum to the full image's.
    scene = test_utils.soft_scene("random3", dev)
    full_d = test_utils.soft_cotangents(2, 40, 48, dev, seed=7)
    full = compare_soft("row strips: full random3", scene, d_rgba=full_d)
    strips = []
    for i in range(2):
        rows = slice(20 * i, 20 * (i + 1))
        strip = compare_soft(
            f"row strip {i} random3", scene._replace(
                height=20, params=sc.make_params(
                    test_utils.SOFT_SIGMA, test_utils.SOFT_GAMMA,
                    test_utils.SOFT_BLUR, 20 * i, dev)),
            20 * i, 40, full_d[:, rows].contiguous())
        if not (all(torch.equal(s, f[:, rows])
                    for s, f in zip(strip[0], full[0]))
                and torch.equal(strip[1], full[1][:, rows])):
            raise AssertionError(f"row strip {i} differs from the full "
                                 "image")
        strips.append(strip)
    for k, label in ((2, "soft_bwd"), (3, "soft_sil_bwd")):
        test_utils.grad_errors(f"row strips {label} dtable",
                               strips[0][k] + strips[1][k], full[k],
                               test_utils.SOFT_GRAD_RTOL,
                               test_utils.SOFT_DTABLE_GROUPS)
    log("soft-kernel", "row strips reassemble the full image exactly; "
        "their table gradients sum to the full image's within "
        f"{test_utils.SOFT_GRAD_RTOL} of each input group's max |value|")

    empty = compare_soft("zero-triangle mesh random3", scene._replace(
        table=scene.table[:, :0].contiguous()))
    if not torch.equal(empty[0][0], torch.zeros_like(empty[0][0])):
        raise AssertionError("zero-triangle mesh: not background")

    # The teapot: bench.py:290-311's soft scene at the renderer's defaults.
    soft_tris = teapot["triangles"].flip(1).contiguous()  # CCW
    soft_intensities = teapot["intensities"][..., 0].contiguous()
    teapot_soft = test_utils.SoftScene(
        *soft_work.teapot_table(TEAPOT_SIZE, dev, TEAPOT_BATCH), TEAPOT_SIZE,
        TEAPOT_SIZE)
    teapot_lights = teapot_soft.lights
    compare_soft(f"teapot {TEAPOT_SIZE}^2 batch {TEAPOT_BATCH}", teapot_soft)

    # Above the JAX package's per-pass cap of 49,152 triangles: one launch
    # per kernel.
    sphere = test_utils.soft_scene("sphere", dev)
    reset_soft_launch_counts()
    compare_soft(f"sphere {sphere.table.shape[1]} triangles 64x64", sphere)
    if soft_launch_counts() != {**{name: 1 for name in names},
                                "soft_fwd": len(fwd_splits),
                                "soft_sil_fwd": len(sil_fwd_splits),
                                "soft_sil_bwd": len(sil_splits)}:
        raise AssertionError(f"sphere: launches {soft_launch_counts()}")
    log("soft-kernel", f"sphere of {sphere.table.shape[1]} triangles: one "
        f"launch per kernel and split {soft_launch_counts()}")
    log("soft-kernel", "worst max abs error of max |plain| per tensor over "
        "the scenes: " + ", ".join(f"{k} {label} {rel:.3g}" for (k, label),
                                   rel in worst.items()))
    rel_errors = {name: max(rel for (k, _), rel in worst.items() if k == name)
                  for name in names}

    # 9. soft-main: the soft render through the kernels and plain.
    scene_args = (teapot["vertices"], soft_tris, teapot["diffuse"],
                  teapot["eye"], teapot["center"], teapot["up"],
                  teapot["lights"], soft_intensities)
    reset_soft_launch_counts()
    images = soft_mesh_renderer.render(*scene_args, TEAPOT_SIZE,
                                       TEAPOT_SIZE)
    torch.cuda.synchronize()
    main_launches = soft_launch_counts()
    if main_launches["soft_fwd"] < 1:
        raise AssertionError("soft render did not launch soft_fwd")
    if tuple(images.shape) != (TEAPOT_BATCH, TEAPOT_SIZE, TEAPOT_SIZE, 4):
        raise AssertionError(f"soft render shape {tuple(images.shape)}")
    if not bool(torch.isfinite(images).all()):
        raise AssertionError("soft render output is not finite")
    coverage = [float(c) for c in (images[..., 3] > 0.5).float().mean((1, 2))]
    if not all(0.05 < c < 0.9 for c in coverage):
        raise AssertionError(f"implausible soft teapot coverage {coverage}")
    plain_images = soft_mesh_renderer.render(*scene_args, TEAPOT_SIZE,
                                             TEAPOT_SIZE, config=plain_cfg)
    rgb_err = float((images[..., :3] - plain_images[..., :3]).abs().max())
    rgb_excess = float(((images[..., :3] - plain_images[..., :3]).abs()
                        - test_utils.SOFT_RGB_RTOL
                        * plain_images[..., :3].abs()).max())
    alpha_err = float((images[..., 3] - plain_images[..., 3]).abs().max())
    if not (rgb_excess <= test_utils.SOFT_RGB_ATOL
            and alpha_err <= test_utils.SOFT_ALPHA_ATOL):
        raise AssertionError(f"soft render vs plain: rgb {rgb_err}, alpha "
                             f"{alpha_err}")
    log("soft-main", f"soft render teapot {TEAPOT_SIZE}^2 batch "
        f"{TEAPOT_BATCH}, 2 lights: launches {main_launches}; finite; "
        f"coverage {', '.join(f'{c:.3f}' for c in coverage)}; vs the plain "
        f"route rgb max abs {rgb_err:.3g}, alpha {alpha_err:.3g}")

    # 10. soft-train: bench.py:bench_soft's steps, full and silhouette.
    def soft_step(size, silhouette=False, config=None):
        vertices = teapot["vertices"].detach().requires_grad_(True)
        if silhouette:
            alpha = soft_mesh_renderer.render_silhouette(
                vertices, soft_tris, teapot["eye"], teapot["center"],
                teapot["up"], size, size, config=config)
        else:
            alpha = soft_mesh_renderer.render(
                vertices, *scene_args[1:], size, size, config=config)[..., 3]
        loss = torch.mean(alpha ** 2)
        loss.backward()
        return loss, vertices.grad

    step_launches = {}
    for size, silhouette in ((128, False), (TEAPOT_SIZE, False),
                             (TEAPOT_SIZE, True)):
        label = f"{'silhouette' if silhouette else 'soft'} step {size}^2"
        reset_soft_launch_counts()
        loss, grad = soft_step(size, silhouette)
        torch.cuda.synchronize()
        step_launches[label] = soft_launch_counts()
        wanted = (("soft_sil_fwd", "soft_sil_bwd") if silhouette
                  else ("soft_fwd", "soft_bwd"))
        for name in wanted:
            if step_launches[label][name] < 1:
                raise AssertionError(f"{label} did not launch {name}")
        plain_loss, plain_grad = soft_step(size, silhouette, plain_cfg)
        err = float((grad - plain_grad).abs().max())
        scale = float(plain_grad.abs().max())
        if not (scale > 0.0 and err <= TRAIN_RTOL * scale
                and bool(torch.isfinite(grad).all())):
            raise AssertionError(f"{label}: kernel vs plain gradient max abs "
                                 f"{err} vs {TRAIN_RTOL} x {scale}")
        log("soft-train", f"{label} batch {TEAPOT_BATCH}, loss "
            f"mean(alpha^2) = {loss.item():.6f} (plain "
            f"{plain_loss.item():.6f}); launches {step_launches[label]}; "
            f"vs the plain step max abs {err:.3g} (gate {TRAIN_RTOL} x "
            f"{scale:.4g})")
    sil_label = f"silhouette step {TEAPOT_SIZE}^2"
    soft_label = f"soft step {TEAPOT_SIZE}^2"

    # 11. fit.
    fit_phase(dev, card)

    # 12. soft-times at the teapot 256^2 batch 4.
    table, params = teapot_soft.table, teapot_soft.params
    rgba, run_max, sum_w = sc.launch_soft_fwd(table, teapot_lights, params,
                                              TEAPOT_SIZE, TEAPOT_SIZE,
                                              TEAPOT_SIZE)
    alpha = rgba[..., 3].contiguous()
    d_rgba = test_utils.soft_cotangents(TEAPOT_BATCH, TEAPOT_SIZE,
                                        TEAPOT_SIZE, dev, seed=8)
    d_alpha = d_rgba[..., 3].contiguous()
    plain_args = (table, teapot_lights, params[0], params[1], params[2],
                  TEAPOT_SIZE, TEAPOT_SIZE, 0, TEAPOT_SIZE)
    sil_args = (table, params[0], params[2], TEAPOT_SIZE, TEAPOT_SIZE, 0,
                TEAPOT_SIZE)
    ms = {
        "soft_fwd": (
            cuda_time_ms(lambda: sc.launch_soft_fwd(
                table, teapot_lights, params, TEAPOT_SIZE, TEAPOT_SIZE,
                TEAPOT_SIZE), iters=20),
            cuda_time_ms(lambda: sc.soft_forward_torch_packed(
                *plain_args, False), iters=2, windows=3, warmup=1)),
        "soft_bwd": (
            cuda_time_ms(lambda: sc.launch_soft_bwd(
                table, teapot_lights, params, rgba, run_max, sum_w, d_rgba,
                TEAPOT_SIZE), iters=20),
            cuda_time_ms(lambda: sc.soft_backward_torch_packed(
                *plain_args, d_rgba), iters=1, windows=3, warmup=1)),
        "soft_sil_fwd": (
            cuda_time_ms(lambda: sc.launch_sil_fwd(
                table, params, TEAPOT_SIZE, TEAPOT_SIZE, TEAPOT_SIZE),
                iters=20),
            cuda_time_ms(lambda: sc.soft_forward_torch_packed(
                *plain_args, True), iters=2, windows=3, warmup=1)),
        "soft_sil_bwd": (
            cuda_time_ms(lambda: sc.launch_sil_bwd(
                table, params, alpha, d_alpha, TEAPOT_SIZE), iters=20),
            cuda_time_ms(lambda: sc.soft_silhouette_backward_torch_packed(
                *sil_args, d_alpha), iters=1, windows=3, warmup=1)),
    }
    pairs = pixel_pairs(table[..., 22], table[..., 23], table[..., 24],
                        table[..., 25], table[..., 21] > 0, TEAPOT_SIZE,
                        TEAPOT_SIZE)
    n_lights = teapot_lights.shape[1]
    table_bytes = table.numel() * 4
    lights_bytes = teapot_lights.numel() * 4
    pixels = TEAPOT_BATCH * TEAPOT_SIZE ** 2
    # Bytes besides the table columns read (SOFT_COLS_READ): the params
    # (16), the lights, per-pixel images read and written (K7 writes rgba,
    # m, sum_w; K8 reads them and d_rgba; K5 writes alpha; K6 reads alpha
    # and d_alpha) and the gradient tables written.
    other_bytes = {
        "soft_fwd": 16 + lights_bytes + pixels * 24,
        "soft_bwd": 16 + 2 * lights_bytes + pixels * 40 + table_bytes
        + TEAPOT_BATCH * 8,
        "soft_sil_fwd": 16 + pixels * 4,
        "soft_sil_bwd": 16 + pixels * 8 + table_bytes + TEAPOT_BATCH * 4,
    }
    bounds = {}
    for name in names:
        base, per_light = SOFT_OPS_PER_PAIR[name]
        bounds[name] = bound_ms(
            table_bytes * SOFT_COLS_READ[name] // sc.COLS + other_bytes[name],
            pairs * (base + per_light * n_lights))
    log("soft-times", f"{card} | teapot {TEAPOT_SIZE}^2 batch "
        f"{TEAPOT_BATCH}, {table.shape[1]} triangles, {n_lights} lights: "
        f"{pairs} (pixel, triangle) pairs inside the blur-inflated bboxes "
        f"({pairs / pixels:.2f} per pixel)")
    for name in names:
        log("soft-times", f"{card} | {name}: kernel launch "
            f"{ms[name][0]:.4f} ms, plain version {ms[name][1]:.4f} ms, "
            f"bound {bounds[name][0]:.4f} ms ({bounds[name][1]})")

    render_ms = cuda_time_ms(lambda: soft_mesh_renderer.render(
        *scene_args, TEAPOT_SIZE, TEAPOT_SIZE), iters=20)
    log("soft-times", f"{card} | soft render forward, teapot "
        f"{TEAPOT_SIZE}^2 batch {TEAPOT_BATCH}: {render_ms:.4f} ms, "
        f"{TEAPOT_BATCH * 1000.0 / render_ms:.2f} renders/s")
    step_ms = {}
    for size, silhouette in ((128, False), (TEAPOT_SIZE, False),
                             (TEAPOT_SIZE, True)):
        label = f"{'silhouette' if silhouette else 'soft'} step {size}^2"
        step_ms[label] = cuda_time_ms(
            lambda: soft_step(size, silhouette), iters=20)
        log("soft-times", f"{card} | {label} batch {TEAPOT_BATCH} (render "
            f"+ mean(alpha^2) + backward to the vertices): "
            f"{step_ms[label]:.4f} ms, "
            f"{TEAPOT_BATCH * 1000.0 / step_ms[label]:.2f} renders/s")

    # K5, K6, K7 and K8 alone (utils/soft_work.py): each one's build, and
    # its times at its compiled split and at each split tried (K5 also on
    # its floor, the teapot with no row kept); where their work falls.
    for kernel in soft_work.SPLITS:
        log("soft-times", f"{card} | {kernel}_kernel: " + json.dumps(
            soft_work.kernel_report(kernels.build().log, f"{kernel}_kernel")))
        for line in soft_work.kernel_times(kernel, dev):
            log("soft-times", f"{card} | " + json.dumps(line))
    for scene in ("teapot 256", "teapot 128", "fit 128"):
        split_table = soft_work.scene_table(scene, dev)
        size = int(scene.split()[-1])
        log("soft-times", f"{scene}: counts " + json.dumps(
            soft_work.pair_counts(split_table[0], size, size,
                                  float(split_table[2][2]))))

    # Device time by kernel (torch.profiler) and the device's idle share.
    for label, fn, wall_ms in (
            (f"soft render {TEAPOT_SIZE}^2", lambda: soft_mesh_renderer.render(
                *scene_args, TEAPOT_SIZE, TEAPOT_SIZE), render_ms),
            (soft_label, lambda: soft_step(TEAPOT_SIZE), step_ms[soft_label]),
            (sil_label, lambda: soft_step(TEAPOT_SIZE, True),
             step_ms[sil_label])):
        by_name, device_ms, n_kernels = device_profile(fn, iters=10)
        log("soft-times", f"{card} | profile {label}: device kernel time "
            f"{device_ms:.4f} ms per call in {n_kernels:.0f} kernels; idle "
            f"share {1.0 - device_ms / wall_ms:.3f} of the unprofiled "
            f"{wall_ms:.4f} ms; {kernel_device_ms(by_name)}")

    launches = {"soft_fwd": main_launches["soft_fwd"],
                "soft_bwd": step_launches[soft_label]["soft_bwd"],
                "soft_sil_fwd": step_launches[sil_label]["soft_sil_fwd"],
                "soft_sil_bwd": step_launches[sil_label]["soft_sil_bwd"]}
    return errors, rel_errors, launches, ms, bounds


def microbench_phase(dev, card):
    """Phase 13: the microbenchmark kernels (S1-S3) on the card. Returns
    (errors, relative errors, launches, ms, plain ms, library ms, bounds),
    each keyed by kernel name."""
    import torch

    from pytorch_mesh_renderer_tpu_torch.microbench import common
    from pytorch_mesh_renderer_tpu_torch.utils.cost import (
        PEAK_BF16_PER_S, PEAK_BYTES_PER_S, PEAK_TF32_PER_S, bound_ms)
    from pytorch_mesh_renderer_tpu_torch.microbench import mxu_edge as me
    from pytorch_mesh_renderer_tpu_torch.microbench import mxu_full as mf
    from pytorch_mesh_renderer_tpu_torch.microbench import (
        patch_scatter as ps)

    counters = ((me.LAUNCHES, "mxu_edge_"), (mf.LAUNCHES, "mxu_full_"),
                (ps.LAUNCHES, ""))
    visits, chunk = 512, 8
    patch = ps.parse_patch("16x8")

    # The main path: each module's run, its launches counted from 0.
    for counts, _ in counters:
        counts.update((key, 0) for key in counts)
    edge = me.run(visits, chunk, 30, dev.type)
    log("microbench", "mxu_edge " + json.dumps(edge))
    full = mf.run(visits, chunk, 30, dev.type)
    log("microbench", "mxu_full " + json.dumps(full))
    # config -> (the JSON dict, the instance table its stage B evaluated)
    patch_runs = {config: ps.run(config, TEAPOT_BATCH, 20, 3, 32, "16x8", 4,
                                 dev.type)
                  for config in ("headline", "stress")}
    for config, (result, _) in patch_runs.items():
        log("microbench", f"patch_scatter {config} " + json.dumps(result))
    torch.cuda.synchronize()
    launches = {prefix + key: n for counts, prefix in counters
                for key, n in counts.items()}
    if min(launches.values()) < 1:
        raise AssertionError(f"microbench: launches {launches}")
    if not full["covered_px"] > 0:
        raise AssertionError("mxu_full: no pixel covered")
    for config, (result, _) in patch_runs.items():
        if not (result["id_mismatch_px"] == 0
                and result["scatter_id_mismatch_px"] == 0
                and result["bc_max_err"] <= KERNEL_ATOL
                and result["z_max_err"] <= KERNEL_ATOL
                and result["capped_or_overflowed_triangles"] == 0):
            raise AssertionError(f"patch_scatter {config}: the merges differ "
                                 f"from K3 or dropped triangles: {result}")
    log("microbench", f"launches {launches}; both patch merges give K3's ids "
        "at both configs, bc and z within 1e-6, no triangle dropped")

    # Each kernel vs its plain version at the main path's shapes.
    errors, rel_errors, ms, plain_ms, library_ms, bounds = ({}, {}, {}, {},
                                                            {}, {})

    def exact(name, kernel, plain):
        torch.cuda.synchronize()
        for k, p in zip(kernel, plain):
            if not torch.equal(k, p):
                raise AssertionError(
                    f"{name}: differs from its plain version at "
                    f"{int((k != p).sum())} of {k.numel()} values")
        errors[name] = rel_errors[name] = 0.0

    def timed(name, kernel_fn, plain_fn, library_fn=None):
        """Device time of the kernel (and the library call) by
        torch.profiler; the plain version by CUDA events."""
        ms[name] = common.device_ms(kernel_fn, dev, 30)
        plain_ms[name] = cuda_time_ms(plain_fn, iters=5, windows=3, warmup=1)
        library_ms[name] = (common.device_ms(library_fn, dev, 30)
                            if library_fn else None)

    data, coeff, pix = me.make_inputs(visits, chunk, dev)
    exact("mxu_edge_fma", [me.launch_fma(data, visits, chunk)],
          [me.fold_fma_torch(data, visits, chunk)])
    pairs = visits * chunk * common.N_PIX
    out_bytes = common.N_PIX * 4
    timed("mxu_edge_fma", lambda: me.launch_fma(data, visits, chunk),
          lambda: me.fold_fma_torch(data, visits, chunk),
          lambda: torch.matmul(coeff, pix).sum(0))
    bounds["mxu_edge_fma"] = bound_ms(data.numel() * 4 + out_bytes,
                                      pairs * me.FMA_OPS_PER_PAIR)
    # The contraction as the script defines it: [visits * 5C, 8] @
    # [8, 2048], 2 M K N operations per product (three for 3xTF32), and
    # one fp32 add per product value for the fold.
    contraction = 2 * coeff.shape[0] * 8 * common.N_PIX
    fold_ops = coeff.shape[0] * common.N_PIX
    tc_bytes = (coeff.numel() + pix.numel()) * 4 + out_bytes
    coeff_bf16, pix_bf16 = coeff.bfloat16(), pix.bfloat16()
    for name, variant, tensor_ops, peak, library in (
            ("mxu_edge_tc_bf16", "tc_bf16", contraction, PEAK_BF16_PER_S,
             lambda: torch.matmul(coeff_bf16, pix_bf16).sum(0)),
            # Two products for 3xTF32: the pixel centres are TF32-exact,
            # so B's lo part is zero and the hi*lo product adds nothing
            # (the kernel drops it).
            ("mxu_edge_tc_tf32x3", "tc_tf32x3", 2 * contraction,
             PEAK_TF32_PER_S, lambda: torch.matmul(coeff, pix).sum(0))):
        kernel = me.launch_tc(coeff, pix, visits, chunk, variant)
        plain = me.fold_tc_torch(coeff, pix, variant)
        torch.cuda.synchronize()
        errors[name] = float((kernel - plain).abs().max())
        rel_errors[name] = errors[name] / float(plain.abs().max())
        if not rel_errors[name] <= me.TC_RTOL:
            raise AssertionError(f"{name}: {rel_errors[name]} of max |plain| "
                                 f"> {me.TC_RTOL}")
        timed(name, lambda v=variant: me.launch_tc(coeff, pix, visits, chunk,
                                                   v),
              lambda v=variant: me.fold_tc_torch(coeff, pix, v), library)
        bounds[name] = bound_ms(tc_bytes, fold_ops, tensor_ops, peak)
    splits = me.edge_splits(visits)
    cluster = me.edge_cluster(splits)
    ctas = common.N_PIX // me.GROUP_PIX * cluster
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    log("microbench", f"mxu_edge launch: {splits} splits of the visits in "
        f"clusters of {cluster} CTAs of {me.WARPS} warps, {ctas} CTAs, "
        f"{ctas / sms:.2f} per SM of {sms}; fma {me.PIX_PER_LANE} pixels a "
        f"lane, tc {me.TILES} n8 tiles a warp; fma's ceiling under "
        f"--fmad=false (no product fused): 50% of its bound")
    log("microbench", "mxu_edge kernels vs plain: fma bit for bit; "
        f"tc_bf16 {rel_errors['mxu_edge_tc_bf16']:.3g}, tc_tf32x3 "
        f"{rel_errors['mxu_edge_tc_tf32x3']:.3g} of max |plain| (gate "
        f"{me.TC_RTOL})")

    data, coeff = mf.make_inputs(visits, chunk, dev)
    exact("mxu_full_prod", mf.launch_prod(data, visits, chunk),
          mf.zbuffer_prod_torch(data))
    tie_data, _, tie_visits, tie_chunk = mf.make_depth_tie_inputs(dev)
    exact("mxu_full_prod", mf.launch_prod(tie_data, tie_visits, tie_chunk),
          mf.zbuffer_prod_torch(tie_data))
    log("microbench", f"mxu_full prod launch: {full['prod_shape']}; equal "
        "to its plain version on the depth-tie table too")
    # Both variants compute one function: their bounds count the pairs a
    # cull must keep (each triangle's box of covered pixels), not all
    # visits * C * 2048, and the pairs inside a triangle.
    n_boxed, n_inside = mf.pair_counts(data)
    outputs = 5 * common.N_PIX * 4
    timed("mxu_full_prod", lambda: mf.launch_prod(data, visits, chunk),
          lambda: mf.zbuffer_prod_torch(data))
    bounds["mxu_full_prod"] = bound_ms(
        data.numel() * 4 + outputs,
        n_boxed * (mf.EDGE_OPS + mf.INSIDE_OPS)
        + n_inside * (mf.DEPTH_OPS + mf.TAIL_OPS))
    tc_kernel = mf.launch_tc(coeff, visits, chunk)
    tc_pairs = mf.tc_pairs(coeff, visits, chunk)
    torch.cuda.synchronize()
    id_diff, z_gap, w_gap = mf.check_tc(tc_kernel, tc_pairs)
    errors["mxu_full_tc"] = max(z_gap, w_gap)
    rel_errors["mxu_full_tc"] = max(z_gap, w_gap / max(
        float(e.abs().max()) for e in tc_pairs[:3]))
    del tc_pairs
    # The tc cull at knife edges: edges through its regions' corner pixel
    # centres, where a cull without its margin drops pairs.
    _, knife_coeff, knife_visits, knife_chunk = mf.make_knife_edge_inputs(dev)
    knife = mf.check_tc(mf.launch_tc(knife_coeff, knife_visits, knife_chunk),
                        mf.tc_pairs(knife_coeff, knife_visits, knife_chunk))
    timed("mxu_full_tc", lambda: mf.launch_tc(coeff, visits, chunk),
          lambda: mf.zbuffer_tc_torch(coeff, visits, chunk))
    # Five functions of three terms (x, y, 1) per boxed pair, two products
    # for 3xTF32: the pixel centres are TF32-exact, so B's lo part is zero
    # and the hi*lo product adds nothing.
    bounds["mxu_full_tc"] = bound_ms(
        coeff.numel() * 4 + outputs,
        n_boxed * mf.INSIDE_OPS + n_inside * mf.TAIL_OPS,
        2 * 2 * 5 * 3 * n_boxed, PEAK_TF32_PER_S)
    log("microbench", f"mxu_full kernels vs plain: prod bit for bit; tc ids "
        f"differ at {id_diff} pixels (each between depths within "
        f"{mf.Z_TOL}), z gap {z_gap:.3g}, edge values {w_gap:.3g} (gate "
        f"{mf.Z_TOL}); {n_boxed} boxed pairs of "
        f"{visits * chunk * common.N_PIX}, {n_inside} inside; knife-edge "
        f"table: ids differ at {knife[0]} pixels, z gap {knife[1]:.3g}, edge "
        f"values {knife[2]:.3g}")

    name = "patch_eval"
    errors[name] = rel_errors[name] = 0.0
    eval_ms, eval_plain_ms, eval_bounds = [], [], []
    for config, (result, table) in patch_runs.items():
        size = ps.CONFIGS[config][0]
        exact(name, ps.launch_patch_eval(table, size, patch),
              ps.patch_eval_torch(table, size, patch))
        timed(name, lambda: ps.launch_patch_eval(table, size, patch),
              lambda: ps.patch_eval_torch(table, size, patch))
        eval_ms.append(ms[name])
        eval_plain_ms.append(plain_ms[name])
        # The kernel's output is every slot's four planes, dead slots too
        # (it evaluates and writes them all, and the merges read them):
        # every slot's row read once and its outputs written once. Beside
        # it, the bound over the live instances alone.
        live = result["instances_live"]
        slots = table.numel() // ps.TABLE_COLS
        all_bytes = slots * (ps.TABLE_COLS * 4 + 4 * ps.LANES * 4)
        eval_bounds.append(bound_ms(all_bytes,
                                    slots * ps.LANES * ps.OPS_PER_LANE))
        live_bound = bound_ms(
            live * ps.TABLE_COLS * 4 + 4 * live * ps.LANES * 4,
            live * ps.LANES * ps.OPS_PER_LANE)
        rate = all_bytes / (ms[name] * 1e-3)
        log("microbench", f"{card} | patch_eval {config}: bit for bit; "
            f"{table.shape[1]} instances per image ({live} live of {slots} "
            f"slots in the batch): device {ms[name]:.4f} ms, plain "
            f"{plain_ms[name]:.4f} ms, bound {eval_bounds[-1][0]:.4f} ms "
            f"({eval_bounds[-1][1]}: every slot's {all_bytes / 1e6:.1f} MB, "
            f"at {rate / 1e12:.3f} TB/s, {rate / PEAK_BYTES_PER_S:.1%} of "
            f"the memory rate); over the live instances alone "
            f"{live_bound[0]:.4f} ms "
            f"({live_bound[0] / ms[name]:.1%} of the device time)")
    # The kernels line reports the headline config.
    ms[name], plain_ms[name], bounds[name] = (eval_ms[0], eval_plain_ms[0],
                                             eval_bounds[0])
    for name in ms:
        library = ("none" if library_ms[name] is None
                   else f"{library_ms[name]:.5f} ms")
        log("microbench", f"{card} | {name}: device {ms[name]:.5f} ms, plain "
            f"{plain_ms[name]:.4f} ms, library {library}, bound "
            f"{bounds[name][0]:.5f} ms ({bounds[name][1]})")
    return errors, rel_errors, launches, ms, plain_ms, library_ms, bounds


def examples_phase(dev, card):
    """Phase 15: every example CLI's `main` on the card, in process, at its
    default device, into a temporary directory (see the module docstring).
    """
    import tempfile
    from unittest import mock

    import numpy as np
    import torch

    from pytorch_mesh_renderer_tpu_torch import config as config_lib
    from pytorch_mesh_renderer_tpu_torch.examples import (
        common, fit_shape_multiview, optimize_camera_pose,
        optimize_cube_rotation, optimize_teapot_rotation, render_teapot_hard,
        render_teapot_soft)
    from pytorch_mesh_renderer_tpu_torch.ops import losses
    from pytorch_mesh_renderer_tpu_torch.ops import soft_rasterize_cuda as sc
    from pytorch_mesh_renderer_tpu_torch.utils import (checkpoint, native,
                                                       obj_io, soft_work,
                                                       test_utils)

    f32 = dict(dtype=torch.float32, device=dev)
    plain_hard = config_lib.HardRasterizerConfig(backend="torch")
    plain_soft = config_lib.SoftRasterizerConfig(backend="torch")

    def run(label, module, argv, kernels, **options):
        """(main's result, seconds) after checking that each of `kernels`
        launched in the call."""
        reset_hard_launch_counts()
        reset_soft_launch_counts()
        t0 = time.perf_counter()
        result = module.main(argv, **options)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {**hard_launch_counts(), **soft_launch_counts()}
        launched = {name: counts[name] for name in kernels}
        # No kernels named: the plain route, which launches none.
        if not (all(launched.values()) if kernels
                else not any(counts.values())):
            raise AssertionError(f"examples: {label} launched {counts}")
        log("examples", f"{label}: {seconds:.2f} s, launches {launched}")
        return result, seconds

    def render_check(label, module, argv, kernel, plain):
        path = os.path.join(tmp, f"{label}.png")
        run(label, module, argv + ["--out", path], [kernel])
        with torch.no_grad():
            want = plain().clamp(0.0, 1.0).cpu().double().numpy()
        want = (want * 255.0).astype(np.uint8).astype(np.int16)
        got = test_utils.read_png(path).astype(np.int16)
        err = int(np.abs(got - want).max())
        if got.shape != want.shape or err > 1:
            raise AssertionError(f"examples: {label} PNG {got.shape} vs the "
                                 f"plain route's {want.shape}, max {err} "
                                 "uint8 levels (gate 1)")
        log("examples", f"{label}: PNG {got.shape} within {err} uint8 level "
            "of the plain route's render (gate 1)")

    def gradient_check(label, make_render, params, target, soft):
        """The CLI's first-step gradient (d loss / d each of its
        parameters) through the kernels against the plain route's, on
        the CLI's own render, start and target: within GRAD_RTOL (hard)
        or SOFT_GRAD_RTOL (soft) of the plain gradient's max |value|."""
        def gradients(config):
            render = make_render(config)
            leaves = [p.clone().requires_grad_(True) for p in params]
            loss = losses.image_l1_loss(render(*leaves), target)
            return torch.autograd.grad(loss, leaves)

        backward = "soft_bwd" if soft else "rasterize_fused_bwd"
        reset_hard_launch_counts()
        reset_soft_launch_counts()
        by_kernel = gradients(None)
        launched = {**hard_launch_counts(), **soft_launch_counts()}[backward]
        by_plain = gradients(plain_soft if soft else plain_hard)
        scale = max(float(g.abs().max()) for g in by_plain)
        err = max(float((k - p).abs().max())
                  for k, p in zip(by_kernel, by_plain)) / scale
        rtol = test_utils.SOFT_GRAD_RTOL if soft else GRAD_RTOL
        shown = "; ".join(
            f"{np.asarray(k.cpu()).round(8)} vs {np.asarray(p.cpu()).round(8)}"
            for k, p in zip(by_kernel, by_plain))
        log("examples", f"{label} first-step gradient, kernels vs plain: "
            f"{shown}; {err:.3g} of max |plain| (gate {rtol}), "
            f"{backward} launched {launched}")
        if not launched or not err <= rtol:
            raise AssertionError(f"examples: {label} gradient through the "
                                 "kernels off the plain route's")

    def rotation_check(label, module, make_render, start, soft):
        with torch.no_grad():  # the target as the CLI renders it
            target = make_render(None)(torch.tensor(module.TARGET_ANGLES,
                                                    **f32))
        gradient_check(label, make_render, [torch.tensor(start, **f32)],
                       target, soft)

    def optimization(label, module, argv, kernels, converges=True):
        result, _ = run(label, module, argv, kernels)
        history = result["losses"]
        if not np.isfinite(history).all():
            raise AssertionError(f"examples: {label} losses not finite")
        if converges and not history[-1] < history[0]:
            raise AssertionError(f"examples: {label} loss did not fall "
                                 f"({history[0]} -> {history[-1]})")
        finals = ", ".join(f"{key} {np.asarray(value).round(4)}"
                           for key, value in result.items()
                           if key in ("angles", "eye"))
        log("examples", f"{card} | {label}: loss {history[0]:.5f} -> "
            f"{history[-1]:.5f} in {len(history)} steps, {finals}; "
            f"{result['steps_per_s']:.1f} steps/s after the first step")

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        render_check(
            "render_teapot_hard 640x480", render_teapot_hard, [],
            "rasterize_fused_fwd", lambda: render_teapot_hard.render_teapot(
                None, 640, 480, dev,
                config_lib.HardRasterizerConfig(backend="torch")))
        render_check(
            "render_teapot_soft 100x100", render_teapot_soft, [], "soft_fwd",
            lambda: render_teapot_soft.render_teapot(
                None, 100, 1e-5, 1e-4, dev,
                config_lib.SoftRasterizerConfig(backend="torch")))
        hard = ["rasterize_fused_fwd", "rasterize_fused_bwd"]
        soft = ["soft_fwd", "soft_bwd"]
        # Each optimization at its defaults: first its gradient at its
        # start, kernels vs plain route (launches not counted), then the
        # CLI's own run.
        for is_soft, flags, kernels in ((False, [], hard),
                                        (True, ["--soft"], soft)):
            label = " ".join(["optimize_cube_rotation"] + flags + ["128^2"])
            rotation_check(
                label, optimize_cube_rotation,
                lambda config, s=is_soft: optimize_cube_rotation.make_render(
                    s, 128, dev, config), [0.0, 0.0, 0.0], is_soft)
            optimization(label, optimize_cube_rotation, flags, kernels)
        start = [a + optimize_teapot_rotation.PERTURBATION
                 for a in optimize_teapot_rotation.TARGET_ANGLES]
        for is_soft, flags, kernels in (
                (False, ["--scan-chunk", "10"], hard),
                (True, ["--soft"], soft)):
            label = " ".join(["optimize_teapot_rotation"] + flags + ["128^2"])
            rotation_check(
                label, optimize_teapot_rotation,
                lambda config, s=is_soft: optimize_teapot_rotation.make_render(
                    None, s, 128, dev, config), start, is_soft)
            optimization(label, optimize_teapot_rotation, flags, kernels)
        gradient_check(
            "optimize_camera_pose 320x240",
            lambda config: optimize_camera_pose.make_render(
                None, 320, 240, dev, config),
            [torch.tensor(optimize_camera_pose.INITIAL_EYE, **f32),
             torch.tensor(optimize_camera_pose.INITIAL_ANGLES, **f32)],
            optimize_camera_pose.load_target(
                common.target_path("example4_target.png"), 320, 240).to(dev),
            soft=False)
        optimization("optimize_camera_pose 320x240", optimize_camera_pose, [],
                     hard, converges=False)

        # K6 sums in a fixed order: two calls give the same bits.
        for scene in ("teapot 256", "fit 128", "pose_tie"):
            if scene == "pose_tie":
                tie = test_utils.soft_scene(scene, dev)
                table, params, size = tie.table, tie.params, tie.height
            else:
                table, _, params = soft_work.scene_table(scene, dev)
                size = int(scene.split()[-1])
            alpha = sc.launch_sil_fwd(table, params, size, size, size)
            d_alpha = test_utils.soft_cotangents(
                table.shape[0], size, size, dev)[..., 3].contiguous()
            calls = [sc.launch_sil_bwd(table, params, alpha, d_alpha, size)
                     for _ in range(2)]
            same = all(torch.equal(a, b) for a, b in zip(*calls))
            log("examples", f"K6 twice on {scene} ({table.shape[0]} images, "
                f"{table.shape[1]} triangles): dtable and dsigma bit for "
                f"bit equal: {same} (gate)")
            if not same:
                raise AssertionError(f"examples: K6 differs between two "
                                     f"calls on {scene}")

        # The flagship at docs/flagship/README.md's command.
        sil = ["soft_sil_fwd", "soft_sil_bwd"]
        fit, seconds = run("fit_shape_multiview 2000 epochs",
                           fit_shape_multiview,
                           ["--epochs", "2000", "--out-prefix",
                            os.path.join(tmp, "cow")] + FLAGSHIP_ARGS, sil)
        if not fit["targets_from_file"]:
            raise AssertionError("examples: the fit did not read the "
                                 "vendored targets")
        lines = {p["epoch"]: p for p in fit["previews"]}
        for epoch, want in FLAGSHIP_LOG.items():
            got = lines[epoch]
            loss_err = (got["loss"] - want["loss"]) / want["loss"]
            iou_err = got["iou"] - want["iou"]
            (loss_lo, loss_hi), (iou_lo, iou_hi) = FLAGSHIP_BANDS[epoch]
            log("examples", f"flagship epoch {epoch}: loss {got['loss']:.5f} "
                f"IoU {got['iou']:.4f}; trajectory.log loss {want['loss']} "
                f"IoU {want['iou']}: loss {loss_err:+.4f} relative (band "
                f"{loss_lo:+} to {loss_hi:+}), IoU {iou_err:+.4f} (band "
                f"{iou_lo:+} to {iou_hi:+})")
            if not (loss_lo <= loss_err <= loss_hi
                    and iou_lo <= iou_err <= iou_hi):
                raise AssertionError(f"examples: flagship epoch {epoch} off "
                                     "trajectory.log")
        log("examples", f"{card} | flagship: {seconds / 2:.3f} s per 1,000 "
            f"epochs (the whole run of 2,000 epochs with its 20 previews: "
            f"{seconds:.2f} s); {fit['steps_per_s']:.1f} steps/s after the "
            "first chunk, previews included")

        # Resume: 100 + 100 epochs through --checkpoint, beside 200, on
        # the kernels; and two straight runs of 200.
        def fit_run(epochs, prefix, ckpt=None):
            argv = ["--epochs", str(epochs), "--out-prefix",
                    os.path.join(tmp, prefix)] + FLAGSHIP_ARGS
            if ckpt:
                argv += ["--checkpoint", ckpt]
            label = (f"fit_shape_multiview {epochs} epochs"
                     + (" --checkpoint" if ckpt else ""))
            return run(label, fit_shape_multiview, argv, sil)[0]

        ckpt = os.path.join(tmp, "fit.ckpt")
        straight = fit_run(200, "straight")
        again = fit_run(200, "again")
        first = fit_run(100, "resumed", ckpt)
        problem = fit_shape_multiview.Problem(
            fit_shape_multiview.parse_args(FLAGSHIP_ARGS), dev)

        def saved_state(step, vertices):
            """The checkpoint's offsets, after checking that it holds
            `step` steps (its own count and Adam's) and the `vertices` the
            invocation ended with, bit for bit."""
            state = checkpoint.restore(
                ckpt, {"params": [torch.zeros_like(problem.verts0)],
                       "step": 0})
            saved = state["params"][0]
            if not (state["step"] == step and float(
                    state["opt_state"]["state"][0]["step"]) == float(step)
                    and np.array_equal(
                        (problem.verts0 + saved).cpu().numpy(), vertices)):
                raise AssertionError(f"examples: the checkpoint does not hold "
                                     f"the state of step {step}")
            return saved

        saved = saved_state(100, first["vertices"])
        with torch.no_grad():
            saved_loss = float(problem.loss([saved], problem.targets))
        resumed = fit_run(200, "resumed", ckpt)
        start_err = abs(resumed["losses"][0] - saved_loss) / saved_loss
        if ([p["epoch"] for p in resumed["previews"]] != [199]
                or len(resumed["losses"]) != 100
                or not start_err <= RESUME_START_RTOL):
            raise AssertionError(
                f"examples: the second invocation did not resume from the "
                f"checkpoint (its first loss {resumed['losses'][0]} vs "
                f"{saved_loss} at the saved state)")
        # Adam went on from the restored state: its count reached 200.
        saved_state(200, resumed["vertices"])
        loss_a = straight["previews"][-1]["loss"]
        loss_b = resumed["previews"][-1]["loss"]
        loss_err = abs(loss_b - loss_a) / abs(loss_a)
        scale = np.abs(straight["vertices"]).max()
        v_err = float(np.abs(resumed["vertices"]
                             - straight["vertices"]).max() / scale)
        repeats = (again["losses"] == straight["losses"]
                   and np.array_equal(again["vertices"],
                                      straight["vertices"]))
        resumed_equal = (np.array_equal(resumed["vertices"],
                                        straight["vertices"])
                         and resumed["losses"] == straight["losses"][100:])
        log("examples", f"resume on the kernels: the checkpoint holds the "
            f"first invocation's end state (offsets bit for bit, Adam at "
            f"step 100); the second invocation's first loss is "
            f"{start_err:.3g} relative off the saved state's (gate "
            f"{RESUME_START_RTOL}), and it saves Adam at step 200; at epoch "
            f"199 100 + 100 epochs give loss {loss_b:.6f}, 200 straight "
            f"{loss_a:.6f} ({loss_err:.3g} relative), vertices {v_err:.3g} "
            f"of max |v| apart (gate {RESUME_RTOL} on both; bit for bit: "
            f"{resumed_equal}); a second straight run of 200 epochs equals "
            f"the first bit for bit: {repeats} (gate)")
        if not (loss_err <= RESUME_RTOL and v_err <= RESUME_RTOL):
            raise AssertionError("examples: the resumed fit is off its "
                                 "straight run")
        if not repeats:
            raise AssertionError("examples: two straight runs of the fit "
                                 "differ")

    # The native OBJ parser on this host.
    if native.load_library() is None:
        raise AssertionError("examples: the native OBJ parser did not build "
                             "or load")
    teapot_path = os.path.join(REPO, "assets", "teapot.obj")

    def load_teapot():
        """(load_obj's result, the median host seconds of LOAD_OBJ_RUNS
        calls)."""
        seconds = []
        for _ in range(LOAD_OBJ_RUNS):
            t0 = time.perf_counter()
            mesh = obj_io.load_obj(teapot_path)
            seconds.append(time.perf_counter() - t0)
        return mesh, float(np.median(seconds))

    by_native, native_s = load_teapot()
    with mock.patch.object(native, "parse_obj", lambda path: None):
        by_python, python_s = load_teapot()
    if not all(torch.equal(a, b) for a, b in zip(by_native, by_python)):
        raise AssertionError("examples: the native and Python OBJ parsers "
                             "differ on the teapot")
    log("examples", f"native OBJ parser: the teapot's {by_native[0].shape[0]} "
        f"vertices, {by_native[1].shape[0]} triangles and normals equal the "
        f"Python parser's; load_obj {native_s * 1e3:.3f} ms native, "
        f"{python_s * 1e3:.3f} ms Python (host, median of {LOAD_OBJ_RUNS}); "
        f"phase 15 took {time.perf_counter() - t_phase:.1f} s")


def shard_phase(dev, card, teapot):
    """Phase 16: the sharded wrappers (`parallel.sharded_*`) on meshes over
    the one card (the card repeated: SHARD_MESHES), each cell launching the
    kernels (see the module docstring). Returns the phase's launch
    counts."""
    import contextlib
    import functools
    import tempfile
    from unittest import mock

    import numpy as np
    import torch

    from pytorch_mesh_renderer_tpu_torch import parallel
    from pytorch_mesh_renderer_tpu_torch.examples import fit_shape_multiview
    from pytorch_mesh_renderer_tpu_torch.models import (mesh_renderer,
                                                        soft_mesh_renderer)

    t_phase = time.perf_counter()
    meshes = {f"{d}x{s}": parallel.make_mesh(d, s, devices=[dev] * (d * s))
              for d, s in SHARD_MESHES}
    fit_args = fit_shape_multiview.parse_args(FLAGSHIP_ARGS)

    def through(mesh, module, name, wrapper):
        """A context in which `module.name` renders through `wrapper` on
        `mesh` (nothing changes without a mesh)."""
        if mesh is None:
            return contextlib.nullcontext()
        return mock.patch.object(module, name,
                                 functools.partial(wrapper, mesh))

    def hard_render(vertices, mesh=None):
        """mesh_renderer.render on the teapot 256^2 b4, its rasterizer
        sharded_rasterize on `mesh`: the render's shading runs on the
        assembled image."""
        rest = [teapot[k] for k in ("triangles", "normals", "diffuse", "eye",
                                    "center", "up", "lights", "intensities")]
        with through(mesh, mesh_renderer, "rasterize",
                     parallel.sharded_rasterize):
            return mesh_renderer.render(vertices, *rest, TEAPOT_SIZE,
                                        TEAPOT_SIZE)

    soft_tris = teapot["triangles"].flip(1).contiguous()  # CCW

    def soft_render(vertices, mesh=None):
        """soft_mesh_renderer.render on the teapot 128^2 b4 (bench --soft),
        its rasterizer sharded_soft_rasterize on `mesh`."""
        with through(mesh, soft_mesh_renderer, "rasterize",
                     parallel.sharded_soft_rasterize):
            return soft_mesh_renderer.render(
                vertices, soft_tris, teapot["diffuse"], teapot["eye"],
                teapot["center"], teapot["up"], teapot["lights"],
                teapot["intensities"][..., 0].contiguous(), 128, 128)

    problems = {None: fit_shape_multiview.Problem(fit_args, dev)}
    problems.update({name: fit_shape_multiview.Problem(fit_args, dev,
                                                       mesh=mesh)
                     for name, mesh in meshes.items()})
    fit_start = problems[None].verts0

    def sil_render(vertices, name=None):
        """The cow fit's silhouettes (128^2 x 4 views),
        sharded_soft_silhouette on mesh `name`."""
        return problems[name].render_alphas(vertices)

    def output_and_grad(render, start, mesh):
        v = start.detach().clone().requires_grad_(True)
        out = render(v, mesh)
        (grad,) = torch.autograd.grad(torch.mean(out ** 2), v)
        torch.cuda.synchronize()
        return out.detach(), grad

    reset_hard_launch_counts()
    reset_soft_launch_counts()
    cases = (("hard", hard_render, teapot["vertices"], GRAD_RTOL,
              ("rasterize_fused_fwd", "rasterize_fused_bwd")),
             ("soft", soft_render, teapot["vertices"], TRAIN_RTOL,
              ("soft_fwd", "soft_bwd")),
             ("silhouette", sil_render, fit_start, TRAIN_RTOL,
              ("soft_sil_fwd", "soft_sil_bwd")))
    for label, render, start, rtol, kernels in cases:
        want, want_grad = output_and_grad(render, start, None)
        scale = float(want_grad.abs().max())
        for name, mesh in meshes.items():
            before = {**hard_launch_counts(), **soft_launch_counts()}
            got, got_grad = output_and_grad(
                render, start, mesh if label != "silhouette" else name)
            after = {**hard_launch_counts(), **soft_launch_counts()}
            cells = mesh.size
            launched = {k: after[k] - before[k] for k in kernels}
            err = float((got_grad - want_grad).abs().max())
            scaled = err / (scale + 1e-6)
            log("shard", f"{label} {name}: output bit for bit equal to the "
                f"unsharded: {torch.equal(got, want)}; gradient max abs "
                f"{err:.3g} of max |unsharded| {scale:.4g} (gate {rtol}"
                + (f"; scaled {scaled:.3g}, gate {SHARD_SIL_SCALED_ATOL}"
                   if label == "silhouette" else "")
                + f"); launches {launched} (want {cells} each)")
            if not (torch.equal(got, want) and err <= rtol * scale
                    and all(n == cells for n in launched.values())
                    and scaled <= SHARD_SIL_SCALED_ATOL):
                raise AssertionError(f"shard: {label} on {name} differs from "
                                     "the unsharded render")

    # Captured steps: the fit step on the 2x2 mesh, captured, equals its
    # eager steps and itself bit for bit.
    def fit_steps(name, captured, steps=6):
        problem = problems[name]
        offsets = torch.zeros_like(problem.verts0, requires_grad=True)
        step = parallel.make_train_step(problem.loss, torch.optim.Adam(
            [offsets], lr=fit_args.lr, capturable=True))
        call = step if captured else step.run_eager
        losses = torch.stack([call(problem.targets) for _ in range(steps)])
        torch.cuda.synchronize()
        return losses, offsets.detach()

    runs = [fit_steps("2x2", True), fit_steps("2x2", True),
            fit_steps("2x2", False)]
    same = [torch.equal(runs[0][0], r[0]) and torch.equal(runs[0][1], r[1])
            for r in runs[1:]]
    log("shard", f"captured fit step on the 2x2 mesh, 6 steps: two captured "
        f"runs bit for bit equal: {same[0]}; captured == eager bit for bit: "
        f"{same[1]} (gates)")
    if not all(same):
        raise AssertionError("shard: the captured sharded fit step does not "
                             "repeat or differs from its eager steps")

    # The flagship at its README command on the 2x2 mesh, twice.
    with tempfile.TemporaryDirectory() as tmp:
        fits = []
        for i in range(2):
            t0 = time.perf_counter()
            fits.append(fit_shape_multiview.main(
                ["--epochs", "2000", "--out-prefix",
                 os.path.join(tmp, f"cow{i}")] + FLAGSHIP_ARGS,
                mesh=meshes["2x2"]))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        got = {p["epoch"]: p for p in fits[0]["previews"]}[1999]
        want = FLAGSHIP_LOG[1999]
        loss_err = (got["loss"] - want["loss"]) / want["loss"]
        iou_err = got["iou"] - want["iou"]
        (loss_lo, loss_hi), (iou_lo, iou_hi) = FLAGSHIP_BANDS[1999]
        repeats = (fits[0]["losses"] == fits[1]["losses"]
                   and np.array_equal(fits[0]["vertices"],
                                      fits[1]["vertices"]))
        log("shard", f"{card} | flagship on the 2x2 mesh: epoch 1999 loss "
            f"{got['loss']:.5f} IoU {got['iou']:.4f} ({loss_err:+.4f} "
            f"relative, IoU {iou_err:+.4f} off trajectory.log; bands "
            f"{loss_lo:+} to {loss_hi:+}, {iou_lo:+} to {iou_hi:+}); two runs "
            f"bit for bit equal: {repeats}; {seconds / 2:.3f} s per 1,000 "
            f"epochs, previews included")
        if not (loss_lo <= loss_err <= loss_hi and iou_lo <= iou_err <= iou_hi
                and repeats):
            raise AssertionError("shard: the flagship on the 2x2 mesh is "
                                 "off trajectory.log or does not repeat")
    torch.cuda.synchronize()
    launches = {**hard_launch_counts(), **soft_launch_counts()}
    for name in ("rasterize_fused_fwd", "rasterize_fused_bwd", "soft_fwd",
                 "soft_bwd", "soft_sil_fwd", "soft_sil_bwd"):
        if launches[name] < 1:
            raise AssertionError(f"shard phase: {name} was not launched")

    # The sharded-vs-unsharded overhead on one card: the captured hard
    # teapot step (SGD at learning rate 0, as the bench's) and the fit
    # step (Adam), by CUDA events.
    def hard_loss(mesh):
        def loss_fn(params, batch):
            return torch.mean(hard_render(params[0], mesh)[..., :3] ** 2)
        return loss_fn

    def step_ms(loss_fn, start, batch, adam):
        param = start.detach().clone().requires_grad_(True)
        optimizer = (torch.optim.Adam([param], lr=fit_args.lr,
                                      capturable=True) if adam
                     else torch.optim.SGD([param], lr=0.0))
        step = parallel.make_train_step(loss_fn, optimizer)
        step(batch)  # the warm-up and the capture
        return (cuda_time_ms(lambda: step(batch), iters=50),
                cuda_time_ms(lambda: step.run_eager(batch), iters=10))

    times = {}
    for name in (None, "2x2", "4x1", "1x4"):
        mesh = meshes.get(name)
        times[("hard", name)] = step_ms(hard_loss(mesh), teapot["vertices"],
                                        None, False)
        times[("fit", name)] = step_ms(problems[name].loss,
                                       torch.zeros_like(fit_start),
                                       problems[name].targets, True)
    for kind in ("hard", "fit"):
        base = times[(kind, None)]
        what = ("hard step, teapot 256^2 b4" if kind == "hard"
                else "fit step, cow 128^2 x 4 views")
        log("shard", f"{card} | {what}: captured {base[0]:.4f} ms, eager "
            f"{base[1]:.4f} ms unsharded; " + "; ".join(
                f"{name} captured {times[(kind, name)][0]:.4f} ms "
                f"({times[(kind, name)][0] / base[0]:.2f}x), eager "
                f"{times[(kind, name)][1]:.4f} ms "
                f"({times[(kind, name)][1] / base[1]:.2f}x)"
                for name in meshes))
    log("shard", f"launches {launches}; phase 16 took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches


def multiprocess_phase(dev, card):
    """Phase 17: the sharded wrappers and the fit step across processes
    (`utils/ranks.py`): 2 ranks, then 4, each a subprocess on the one card
    over gloo (NCCL refuses two ranks on one card), each with its own
    timeout, rendering its own cells; this process holds what they return
    to its own unsharded runs on the kernels and times the eager fit
    step."""
    import tempfile

    import torch

    from pytorch_mesh_renderer_tpu_torch import parallel
    from pytorch_mesh_renderer_tpu_torch.microbench import common
    from pytorch_mesh_renderer_tpu_torch.utils import kernels, ranks

    t_phase = time.perf_counter()
    kernels.build()  # before the ranks, which load it
    with tempfile.TemporaryDirectory() as tmp:
        runs = {}
        for world in (2, 4):
            t0 = time.perf_counter()
            runs[world] = ranks.run(world, os.path.join(tmp, str(world)),
                                    "cuda", "full", "gloo", RANK_TIMEOUT)
            log("multiprocess", f"{world} ranks over gloo on the card: "
                f"{time.perf_counter() - t0:.1f} s")
    cases = ranks.case_fns("full", dev, 1)
    launched_by = {"hard": ("rasterize_fused_fwd", "rasterize_fused_bwd"),
               "soft": ("soft_fwd", "soft_bwd"),
               "steps": ("soft_sil_fwd", "soft_sil_bwd")}
    for world, results in runs.items():
        for key in (k for k in results[0] if "/" in k):
            case, name = key.split("/")
            per_rank = [r[key] for r in results]
            tensors = [k for k, v in per_rank[0].items() if torch.is_tensor(v)]
            same = all(torch.equal(r[k], per_rank[0][k])
                       for r in per_rank for k in tensors)
            repeat = all(r["repeat"] for r in per_rank)
            spread = max(r["spread"] for r in per_rank)
            launched = all(r["launches"][k] > 0 for r in per_rank
                           for k in launched_by[case])
            if case == "steps":
                continue
            start, render = cases[case]
            want, want_grad = ranks.output_and_grad(start, render, None,
                                                    case)
            torch.cuda.synchronize()
            got, got_grad = per_rank[0]["out"], per_rank[0]["grad"]
            equal = torch.equal(got, want.cpu())
            err = float((got_grad - want_grad.cpu()).abs().max())
            scale = float(want_grad.abs().max())
            rtol = GRAD_RTOL if case == "hard" else TRAIN_RTOL
            log("multiprocess", f"{case} {name} on {world} ranks: output bit "
                f"for bit the unsharded render's: {equal}; gradient max abs "
                f"{err:.3g} of max |unsharded| {scale:.4g} (gate {rtol}); "
                f"ranks bit for bit equal: {same}; two runs' outputs equal: "
                f"{repeat}, gradients {spread:.3g} apart (K2 and K8 add with "
                f"atomics; gate {rtol}); each rank launched "
                f"{launched_by[case]}: {launched}")
            if not (equal and err <= rtol * scale and same and repeat
                    and spread <= rtol * scale and launched):
                raise AssertionError(f"multiprocess: {case} on {name} over "
                                     f"{world} ranks")

    # The fit step on 2 ranks: 5 eager Adam steps, against 5 unsharded.
    steps = ranks.STEPS["full"]
    per_rank = [r["steps/2x1"] for r in runs[2]]
    unsharded = ranks.fit_problem("full", dev, None)
    losses, offsets = ranks.eager_steps(unsharded, dev, steps)
    torch.cuda.synchronize()
    same = all(torch.equal(r["offsets"], per_rank[0]["offsets"])
               and torch.equal(r["losses"], per_rank[0]["losses"])
               for r in per_rank)
    repeat = all(r["repeat"] and r["spread"] == 0.0 for r in per_rank)
    scale = float(offsets.abs().max())
    err = float((per_rank[0]["offsets"] - offsets.cpu()).abs().max())
    loss_err = float(((per_rank[0]["losses"] - losses.cpu()).abs()
                      / losses.cpu().abs()).max())
    raised = all("step.run_eager" in (r["capture_error"] or "")
                 for r in per_rank)
    launched = all(r["launches"][k] > 0 for r in per_rank
                   for k in launched_by["steps"])
    log("multiprocess", f"fit step, cow 128^2 x 4 views, {steps} eager Adam "
        f"steps on 2 ranks (2x1): offsets max abs {err:.3g} of max "
        f"|unsharded| {scale:.4g} (gate {TRAIN_RTOL}), losses {loss_err:.3g} "
        f"relative; ranks bit for bit equal: {same}; two runs equal: "
        f"{repeat}; a capture on the mesh raises naming step.run_eager: "
        f"{raised}; K5, K6 launched in each rank: {launched}")
    if not (err <= TRAIN_RTOL * scale and loss_err <= TRAIN_RTOL and same
            and repeat and raised and launched):
        raise AssertionError("multiprocess: the fit steps on 2 ranks")

    # Eager ms per fit step: 2 ranks (each rank's own CUDA events), one
    # process on the 2x1 mesh over the card, unsharded.
    def eager_ms(mesh):
        problem = ranks.fit_problem("full", dev, mesh)
        _, step = ranks.fit_step(problem, dev)
        return common.wall_ms(lambda: step.run_eager(problem.targets), dev,
                              ranks.TIMED_STEPS)

    one = eager_ms(parallel.make_mesh(2, 1, devices=[dev, dev]))
    alone = eager_ms(None)
    two = [r["eager_ms"] for r in per_rank]
    log("multiprocess", f"{card} | eager fit step, cow 128^2 x 4 views, "
        f"CUDA events: 2 ranks (gloo, one card) "
        + ", ".join(f"{ms:.4f}" for ms in two)
        + f" ms (rank 0, rank 1); one process on the 2x1 mesh {one:.4f} ms; "
        f"unsharded {alone:.4f} ms")
    log("multiprocess", "NCCL not exercised: it takes one rank per card "
        "and this host has one card (init_distributed raises, naming "
        "backend=\"gloo\", when two ranks hold one card under NCCL)")
    log("multiprocess", f"phase 17 took {time.perf_counter() - t_phase:.1f} "
        "s")


def loop_phase(dev, card, teapot):
    """Phase 14: the captured training step and loop
    (`parallel.make_train_step`, `make_train_loop`) and the bench.

    Equality: for the hard step, the soft step at 128^2, the silhouette
    step (teapot, batch 4, SGD on the vertices) and the pose fit (bench.py's
    cube, Adam 5e-2), with the bench's losses (`bench.render_step_loss`,
    `bench.pose_problem`), K steps of the loop, K calls of the step and K eager
    steps from the same start, in losses and parameters. EAGER_RUNS eager
    runs are compared first: where they all agree bit for bit, the
    captured runs must too; where the backward's atomics make them differ,
    the captured runs are held to TRAIN_RTOL (losses relative, the
    parameters' change relative to its max |value|) and the eager spread
    is printed beside it. Then the bench's hard, soft 128^2, silhouette
    128^2 and pose modes in-process with fewer iterations, each JSON line
    printed. The kernels' launch counters count the launches of each
    step's eager warm-up and of its capture, none of the replays: phase 14
    requires each mode's kernels at least once. Returns its launch counts."""
    import torch

    from pytorch_mesh_renderer_tpu_torch import bench, parallel

    steps = 3
    pose_loss, pose_batch, _ = bench.pose_problem(128, dev)
    fits = {
        "hard step": (bench.render_step_loss(teapot, TEAPOT_SIZE),
                      teapot["vertices"], None, 1.0),
        "soft step 128^2": (bench.render_step_loss(teapot, 128, soft=True),
                            teapot["vertices"], None, 1.0),
        f"silhouette step {TEAPOT_SIZE}^2": (
            bench.render_step_loss(teapot, TEAPOT_SIZE, soft=True,
                                   silhouette=True),
            teapot["vertices"], None, 1.0),
        "pose fit": (pose_loss, torch.zeros(3, dtype=torch.float32,
                                            device=dev), pose_batch, None),
    }

    def run(kind, loss_fn, start, batch, sgd_lr):
        """(K losses, the parameter after K steps) of one run from
        `start`: eager steps, make_train_step or make_train_loop."""
        param = start.detach().clone().requires_grad_(True)
        optimizer = (torch.optim.SGD([param], lr=sgd_lr) if sgd_lr else
                     torch.optim.Adam([param], lr=5e-2, capturable=True))
        if kind == "loop":
            run_losses = parallel.make_train_loop(loss_fn, optimizer,
                                                  steps)(batch)
        elif kind == "step":
            step = parallel.make_train_step(loss_fn, optimizer)
            run_losses = torch.stack([step(batch) for _ in range(steps)])
        else:
            run_losses = []
            for _ in range(steps):
                optimizer.zero_grad(set_to_none=True)
                loss = loss_fn([param], batch)
                loss.backward()
                optimizer.step()
                run_losses.append(loss.detach())
            run_losses = torch.stack(run_losses)
        torch.cuda.synchronize()
        return run_losses, param.detach()

    def gaps(a, b, start):
        """(max relative loss gap, max gap of the parameters' change over
        its max |value|) between two runs."""
        change = (a[1] - start).abs().max()
        return (float(((a[0] - b[0]) / b[0]).abs().max()),
                float((a[1] - b[1]).abs().max() / change))

    reset_hard_launch_counts()
    reset_soft_launch_counts()
    for label, (loss_fn, start, batch, sgd_lr) in fits.items():
        eager = run("eager", loss_fn, start, batch, sgd_lr)
        # The backward kernels sum with atomics, so two eager runs agree
        # bit for bit now and then by chance (the pose fit: 13-14 distinct
        # results in 16 runs on an H100); EAGER_RUNS agreeing is taken as
        # a deterministic step.
        spreads = [gaps(run("eager", loss_fn, start, batch, sgd_lr), eager,
                        start) for _ in range(EAGER_RUNS - 1)]
        spread = tuple(max(g[i] for g in spreads) for i in range(2))
        bitwise = spread == (0.0, 0.0)
        found = []
        for kind in ("step", "loop"):
            got = run(kind, loss_fn, start, batch, sgd_lr)
            if bitwise and not (torch.equal(got[0], eager[0])
                                and torch.equal(got[1], eager[1])):
                raise AssertionError(f"{label}: {kind} differs from the "
                                     "eager steps, which repeat bit for bit")
            found.append(gaps(got, eager, start))
            if not max(found[-1]) <= TRAIN_RTOL:
                raise AssertionError(f"{label}: {kind} vs eager {found[-1]} "
                                     f"> {TRAIN_RTOL}")
        gate = "bit for bit" if bitwise else f"gate {TRAIN_RTOL}"
        log("loop", f"{label}: {steps} steps of make_train_loop == "
            f"make_train_step == eager ({gate}): loss and parameter-change "
            f"gaps step {found[0][0]:.3g} / {found[0][1]:.3g}, loop "
            f"{found[1][0]:.3g} / {found[1][1]:.3g}; "
            f"{EAGER_RUNS} eager runs "
            f"{spread[0]:.3g} / {spread[1]:.3g}; losses "
            f"{[round(float(x), 6) for x in eager[0]]}")

    # The bench's modes, at their default sizes with fewer iterations.
    for argv in (["--iters", "5"], ["--soft", "--size", "128", "--iters", "5"],
                 ["--soft", "--silhouette", "--size", "128", "--iters", "5"],
                 ["--pose", "--steps", "100"]):
        for record in bench.main(argv):
            if not (record["value"] > 0 and record["device_ms_per_step"]
                    and record["eager_ms_per_step"] > 0):
                raise AssertionError(f"bench {argv}: {record}")
            log("loop", f"{card} | bench {' '.join(argv)}: "
                + json.dumps(record))
    torch.cuda.synchronize()
    launches = {**hard_launch_counts(), **soft_launch_counts()}
    for name in ("rasterize_fused_fwd", "rasterize_fused_bwd", "soft_fwd",
                 "soft_bwd", "soft_sil_fwd", "soft_sil_bwd"):
        if launches[name] < 1:
            raise AssertionError(f"loop phase: {name} was not launched")
    log("loop", f"launches (eager warm-ups and captures; replays are not "
        f"counted) {launches}")
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU.", file=sys.stderr)
        return 2
    started = time.perf_counter()

    import numpy as np

    sys.path.insert(0, REPO)
    from pytorch_mesh_renderer_tpu_torch import config as config_lib
    from pytorch_mesh_renderer_tpu_torch.microbench import common
    from pytorch_mesh_renderer_tpu_torch.models import mesh_renderer
    from pytorch_mesh_renderer_tpu_torch.ops import camera
    from pytorch_mesh_renderer_tpu_torch.ops import rasterize as rasterize_ops
    from pytorch_mesh_renderer_tpu_torch.ops import (
        rasterize_barycentric_cuda as rb)
    from pytorch_mesh_renderer_tpu_torch.ops import rasterize_cuda as rc
    from pytorch_mesh_renderer_tpu_torch.utils import (hard_work, kernels,
                                                       scenes, soft_work)
    from pytorch_mesh_renderer_tpu_torch.utils import test_utils
    from pytorch_mesh_renderer_tpu_torch.utils.cost import (
        HARD_OPS_PER_PAIR, bound_ms, pixel_pairs)

    golden_dir = os.path.join(REPO, "tests", "golden")
    oracle_path = os.path.join(REPO, "tests", "oracle",
                               "hard_kernel_cube_64x48.npz")
    dev = torch.device("cuda", 0)
    f32 = dict(dtype=torch.float32, device=dev)

    # 1. Device.
    card = common.card_line()
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
    # Each kernel's worst max abs error over max |plain value|, per tensor.
    rel_errors = {name: 0.0 for name in KERNELS}

    def relative(name, err, scale):
        if scale > 0.0:
            rel_errors[name] = max(rel_errors[name], err / scale)

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
        for err, p in zip(errs, plain[1:]):
            if p.numel():
                relative("rasterize_fused_fwd", err, float(p.abs().max()))
        covered = float((kernel[1].sum(-1) > 0).float().mean())
        # K1 at each split tried: bit for bit the compiled split's, and
        # ids, bc and z bit for bit K3's.
        row_offset = kwargs.get("row_offset", 0)
        splits = test_utils.compare_k1_splits(
            rc.pack_rows(clip, tris, False)[0],
            rc.pack_corner_attributes(attrs, tris), width, height,
            row_offset, kwargs.get("full_height"), hard_splits, bary_shapes)
        if not all(torch.equal(a, b) for a, b in zip(splits, kernel)):
            raise AssertionError(f"{name}: the launcher differs from the "
                                 "wrapper")
        log("kernel", f"{name}: ids equal; max abs bc {errs[0]:.3g}, attrs "
            f"{errs[1]:.3g}, z {errs[2]:.3g}; covered {covered:.3f}; "
            f"rasterize_fused_fwd at splits {hard_splits} bit for bit equal "
            "and equal to rasterize_bary_fwd's ids, bc and z at (group, "
            f"split) {bary_shapes}")
        return kernel

    hard_splits = test_utils.hard_splits()
    bary_shapes = test_utils.bary_shapes()

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
    compare("zero-triangle mesh 48x40", *scene[:2], scene[2][:0], 48, 40)
    ties = test_utils.ties_scene()
    ties = [torch.tensor(a, device=dev) for a in ties[:3]] + list(ties[3:])
    compare("ties 40x36", ties[0], ties[2], ties[1], *ties[3:])
    compare("ties 40x36, one image", ties[0][:1], ties[2][:1], ties[1],
            *ties[3:])

    # The headline scene: bench.py's teapot parameters (utils/scenes.py).
    teapot = scenes.build_scene(TEAPOT_BATCH, dev)
    scene_args = [teapot[k] for k in (
        "vertices", "triangles", "normals", "diffuse", "eye", "center", "up",
        "lights", "intensities")]
    # The rasterizer's inputs exactly as render builds them (A = 9).
    teapot_clip = scenes.clip_vertices(teapot, TEAPOT_SIZE)
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
                err, scale = grad_error(f"{name} {kernel_name}", label, k, p,
                                        GRAD_RTOL)
                worst = max(worst, err)
                relative(kernel_name, err, scale)
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
        for k, p in zip(k3[1:], p3[1:]):
            if k.numel():
                relative("rasterize_bary_fwd", float((k - p).abs().max()),
                         float(p.abs().max()))
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
    for attr_count in (0, 3, 9, 16, 40):
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
            grad_error(f"row strips {kernel_name}", label, sum(parts), whole,
                       GRAD_RTOL)
    log("kernel", "row strips: the two strips' gradients sum to the full "
        f"image's within {GRAD_RTOL} of its max |value|")
    empty = compare_backward("zero-triangle mesh 48x40", *scene[:2],
                             scene[2][:0], 48, 40)
    if any(float(g.abs().max()) != 0.0 for grads in empty for g in grads):
        raise AssertionError("zero-triangle mesh: gradients are not zero")
    compare_backward(f"teapot {TEAPOT_SIZE}^2 batch {TEAPOT_BATCH} A=9",
                     *teapot_raster, TEAPOT_SIZE, TEAPOT_SIZE)

    # 4. The main path.
    reset_hard_launch_counts()
    images = mesh_renderer.render(*scene_args, TEAPOT_SIZE, TEAPOT_SIZE)
    torch.cuda.synchronize()
    main_launches = hard_launch_counts()
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

    reset_hard_launch_counts()
    loss, grad = train_step()
    torch.cuda.synchronize()
    train_launches = hard_launch_counts()
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
    reset_hard_launch_counts()
    for _ in range(35):
        optimizer.zero_grad()
        loss = torch.mean(torch.abs(render_with_rotation(angles) - desired))
        loss.backward()
        torch.nn.utils.clip_grad_norm_([angles], 1.0)
        optimizer.step()
    with torch.no_grad():
        final = render_with_rotation(angles)
    torch.cuda.synchronize()
    rotation_launches = hard_launch_counts()
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
    reset_hard_launch_counts()
    bary_clip = teapot_clip.detach().clone().requires_grad_(True)
    bary_out = [rasterize_ops.rasterize_barycentric(
        bary_clip[b], teapot["triangles"], TEAPOT_SIZE, TEAPOT_SIZE)
        for b in range(TEAPOT_BATCH)]
    sum((bc * weights).sum() for _, bc, _ in bary_out).backward()
    torch.cuda.synchronize()
    bary_launches = hard_launch_counts()
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
    # K3 and K4 at the shape their path gives them: `rasterize_barycentric`
    # renders one image a launch (the teapot's first).
    bary = tuple(t[:1] for t in (ids, bc, g_bc, table, inv_abs_det))
    no_attrs = torch.zeros(1, table.shape[1], 3, 0, **f32)
    ms = {
        "rasterize_fused_fwd": (launch_ms, plain_ms),
        "rasterize_fused_bwd": (
            cuda_time_ms(lambda: rc.launch_fused_bwd(*fused), iters=20),
            cuda_time_ms(lambda: rc.triangle_gradients_torch(*fused),
                         iters=5)),
        "rasterize_bary_fwd": (
            cuda_time_ms(lambda: rb.launch_bary_fwd(
                bary[3], TEAPOT_SIZE, TEAPOT_SIZE, 0, TEAPOT_SIZE), iters=20),
            cuda_time_ms(lambda: rc.forward_torch_packed(
                bary[3], no_attrs, TEAPOT_SIZE, TEAPOT_SIZE, 0, TEAPOT_SIZE,
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
    for name, images in (("rasterize_fused_bwd", f"batch {TEAPOT_BATCH}"),
                         ("rasterize_bary_fwd", "one image"),
                         ("rasterize_bary_bwd", "one image")):
        log("times", f"{card} | {name}, teapot {TEAPOT_SIZE}^2 {images}: "
            f"kernel launch {ms[name][0]:.4f} ms, plain version "
            f"{ms[name][1]:.4f} ms")
    log("times", f"{card} | fused backward with the vertex scatter: via "
        f"the kernel {backward_ms:.4f} ms, plain {plain_backward_ms:.4f} ms")
    log("times", f"{card} | render forward, teapot {TEAPOT_SIZE}^2 batch "
        f"{TEAPOT_BATCH}: {render_ms:.4f} ms, "
        f"{TEAPOT_BATCH * 1000.0 / render_ms:.2f} renders/s")
    log("times", f"{card} | training step (render + mean(rgb^2) + backward "
        f"to the vertices), teapot {TEAPOT_SIZE}^2 batch {TEAPOT_BATCH}: "
        f"{train_ms:.4f} ms, {TEAPOT_BATCH * 1000.0 / train_ms:.2f} "
        "renders/s")

    # K1-K4 alone (utils/hard_work.py): their builds. K1's times at its
    # compiled split and at each split tried, on the teapot, its floor (the
    # table moved off screen: the stream and the cull alone) and sphere72
    # 512x512 batch 4; K2's with A = 9 on the teapot and sphere72 and on
    # its floor (every pixel inactive); K3's and K4's on the teapot and
    # sphere72 for one image and for four, K3 at its launcher's rule and at
    # each group and split, K4 also on its floor.
    # Where K1's and K2's work falls.
    for key in hard_work.KERNELS:
        for kernel_name in hard_work.report_names(build.log, key):
            log("times", f"{card} | {kernel_name}: " + json.dumps(
                soft_work.kernel_report(build.log, kernel_name)))
    for line in (hard_work.k1_times(dev) + hard_work.k2_times(dev)
                 + hard_work.k34_times(dev)):
        log("times", f"{card} | " + json.dumps(line))
    for scene_name, summary in hard_work.counts(dev).items():
        log("times", f"{scene_name}: K1 cull counts " + json.dumps(summary))
    for scene_name, summary in hard_work.bwd_scene_counts(dev).items():
        log("times", f"{scene_name}: K2 work counts " + json.dumps(
            summary["total"]))

    # The device time of the hard training step and of the 4-image
    # rasterize_barycentric step (utils/hard_work.py `step_profiles`), the
    # training step's idle share against its unprofiled wall time.
    for label, (device_ms, n_kernels, ours) in hard_work.step_profiles(
            dev).items():
        idle = (f"; idle share {1.0 - device_ms / train_ms:.3f} of the "
                f"unprofiled {train_ms:.4f} ms"
                if label == hard_work.TRAIN_STEP else "")
        log("times", f"{card} | profile {label}: device kernel time "
            f"{device_ms:.4f} ms per call in {n_kernels:.0f} kernels{idle}; "
            + (", ".join(f"{name} {t:.4f} ms" for name, t in ours.items())
               or "no kernel recorded (CUDA events)"))

    # Each hard kernel's bound at the shape it was timed at (bytes read
    # once and written once; the pairs of pixel centres inside each
    # triangle's screen bbox times HARD_OPS_PER_PAIR, plus the per-pixel
    # epilogue): K1 and K2 the teapot batch, K3 and K4 its first image.
    # The backwards read ids and bc of every pixel but the cotangents of
    # the active pixels only (the rest contribute nothing), and do their
    # arithmetic for those alone; of the table they read and write the rows
    # of the distinct (image, winner) pairs only (the caller zeroes it):
    # the 9-float adjugate, 1/|det|, K2's corner attributes, the 9 + 3A
    # output columns.
    n_attr = teapot_attrs.shape[-1]
    corners = teapot_clip[:, teapot["triangles"].long()]
    ndc = corners[..., :2] / corners[..., 3:4]
    image_pixels = TEAPOT_SIZE ** 2

    def work(images):
        """(pixels, (pixel, triangle) pairs, table rows, active pixels,
        distinct (image, winner) pairs) of the teapot's first `images`
        images."""
        lo, hi = ndc[:images].amin(-2), ndc[:images].amax(-2)
        counts = hard_work.bwd_counts(ids[:images], bc[:images])["total"]
        return (images * image_pixels,
                pixel_pairs(lo[..., 0], hi[..., 0], lo[..., 1], hi[..., 1],
                            torch.ones(lo.shape[:2], **f32), TEAPOT_SIZE,
                            TEAPOT_SIZE),
                images * table.shape[1], counts["active_pixels"],
                counts["winners"])

    pixels, pairs, rows, active, winners = work(TEAPOT_BATCH)
    pixels1, pairs1, rows1, active1, winners1 = work(1)
    bounds = {
        "rasterize_fused_fwd": bound_ms(
            rows * (64 + 12 * n_attr) + pixels * (4 + 12 + 4 * n_attr),
            pairs * HARD_OPS_PER_PAIR + pixels * 6 * n_attr),
        "rasterize_fused_bwd": bound_ms(
            pixels * (4 + 12) + active * (12 + 4 * n_attr)
            + winners * (36 + 4 + 12 * n_attr + (9 + 3 * n_attr) * 4),
            active * (9 + 3 * n_attr) * 4),
        "rasterize_bary_fwd": bound_ms(rows1 * 64 + pixels1 * (4 + 12 + 4),
                                       pairs1 * HARD_OPS_PER_PAIR),
        "rasterize_bary_bwd": bound_ms(
            pixels1 * (4 + 12) + active1 * 12 + winners1 * (36 + 4 + 9 * 4),
            active1 * 9 * 4),
    }
    log("times", f"{card} | teapot {TEAPOT_SIZE}^2 batch {TEAPOT_BATCH}: "
        f"{pairs} (pixel, triangle) pairs inside the triangles' bboxes, "
        f"{active} of {pixels} pixels active with {winners} distinct "
        f"(image, winner) pairs ({pairs1}, {active1} and {winners1} in its "
        "first image); bounds " + ", ".join(
            f"{name} {ms_:.4f} ms ({by})"
            for name, (ms_, by) in bounds.items()))

    # Each kernel's launches on the path that runs it: K1 on the forward
    # render, K2 on the training step, K3 and K4 on rasterize_barycentric.
    launches = {"rasterize_fused_fwd": main_launches["rasterize_fused_fwd"],
                "rasterize_fused_bwd": train_launches["rasterize_fused_bwd"],
                "rasterize_bary_fwd": bary_launches["rasterize_bary_fwd"],
                "rasterize_bary_bwd": bary_launches["rasterize_bary_bwd"]}

    # 8-12. The soft renderer: K7 on the soft render, K8 on the soft step,
    # K5 and K6 on the silhouette step.
    soft_errors, soft_rel, soft_launches, soft_ms, soft_bounds = soft_phases(
        dev, card, teapot)
    errors.update(soft_errors)
    rel_errors.update(soft_rel)
    launches.update(soft_launches)
    ms.update(soft_ms)
    bounds.update(soft_bounds)

    # 13. The microbenchmark kernels: each launched on its module's run.
    (mb_errors, mb_rel, mb_launches, mb_ms, mb_plain_ms, library_ms,
     mb_bounds) = microbench_phase(dev, card)
    errors.update(mb_errors)
    rel_errors.update(mb_rel)
    launches.update(mb_launches)
    ms.update({name: (mb_ms[name], mb_plain_ms[name]) for name in mb_ms})
    bounds.update(mb_bounds)

    # 14. The captured training step and loop, and the bench.
    t0 = time.perf_counter()
    loop_phase(dev, card, teapot)
    log("loop", f"phase 14 took {time.perf_counter() - t0:.1f} s")

    # 15. The example CLIs, the flagship fit and the native OBJ parser.
    examples_phase(dev, card)

    # 16. The sharded wrappers on meshes over the card.
    shard_phase(dev, card, teapot)

    # 17. The sharded wrappers and the fit step across processes.
    multiprocess_phase(dev, card)
    log("examples", f"the script took {time.perf_counter() - started:.1f} s")

    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches[name],
        "max_abs_err": errors[name], "max_rel_err": rel_errors[name],
        "ms": ms[name][0],
        "plain_ms": ms[name][1], "bound_ms": bounds[name][0],
        "bound_by": bounds[name][1], "library_ms": library_ms.get(name)}
        for name, (source, replaces) in KERNELS.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
