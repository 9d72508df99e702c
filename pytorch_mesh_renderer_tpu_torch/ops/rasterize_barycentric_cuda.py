"""Barycentric-only hard rasterization (the reference kernel's contract:
ids, barycentrics, z): kernels and plain versions, forward and backward.

Port of K3 and K4, the JAX package's barycentric-only Pallas pair:

  * `rasterize_barycentric_torch`, the plain forward: K1's plain version
    (`rasterize_cuda.forward_torch_packed`) with no attribute columns;
  * `rasterize_barycentric_cuda`, the wrapper of the CUDA kernel
    `csrc/rasterize_bary_fwd.cu`, which replaces `_kernel`
    (`rasterize_pallas.py:348-412`);
  * `rasterize_barycentric_backward_torch`, the plain analytic backward,
    and `rasterize_barycentric_backward_cuda`, whose per-triangle
    reduction is the CUDA kernel `csrc/rasterize_bary_bwd.cu`, which
    replaces `_bwd_kernel` (`rasterize_pallas.py:676-752`). Both reduce to
    the coordinate-major [B, T, 9] table and scatter it to [B, V, 4]
    (`_scatter_corner_grads`, `rasterize_pallas.py:755-767`).

The forwards take [B, V, 4] clip vertices and return (ids [B, H, W] i32,
barycentrics [B, H, W, 3] f32, z [B, H, W] f32); uncovered pixels have
id 0, bc 0 and z 1. Gradients reach the clip vertices through the
barycentrics only, by the analytic VJP (no vertex-z gradient, the 0.9
cutoff); ids and z take no cotangent. The backward runs the route the
forward ran.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from ..utils import kernels
from . import rasterize_cuda as rc

# Launches of the forward (K3) and backward (K4) kernels in this process;
# each wrapper adds one per launch and nothing else touches them.
FWD_LAUNCHES = 0
BWD_LAUNCHES = 0


def launch_bary_fwd(table, image_width, image_height, row_offset,
                    full_height, group=0, split=0):
    """Launch the barycentric-only forward kernel (K3) on packed rows.

    Args:
      table: [B, T, 16] f32 packed triangle rows (rasterize_cuda.
        pack_rows), CUDA, contiguous, 16-byte aligned.
      group, split: pixel blocks per side of a cluster's group (1 or 2) and
        CTAs per cluster (1, 2, 4 or 8); both 0, the default, take the
        launcher's rule (csrc/rasterize_bary_fwd.cu `choose_launch`).
        Other values serve only to
        measure that choice (chip_smoke.py, utils/hard_work.py). The
        outputs depend on neither.

    Returns:
      (ids, barycentrics, z) as rasterize_barycentric_cuda.
    """
    global FWD_LAUNCHES
    rc.check_kernel_operands(table.device, [("table", table, torch.float32)])
    batch, n_tri = table.shape[:2]
    if table.shape != (batch, n_tri, rc.TRI_COLS):
        raise ValueError(f"table has shape {tuple(table.shape)}; want "
                         f"[B, T, {rc.TRI_COLS}]")
    if table.data_ptr() % 16:
        raise ValueError("the packed triangle table must be 16-byte aligned")
    if max(batch, n_tri * rc.TRI_COLS) >= 2 ** 31:
        raise ValueError("the table exceeds the kernel's int32 extents")
    shape = (batch, image_height, image_width)
    ids = torch.empty(shape, dtype=torch.int32, device=table.device)
    bc = torch.empty(shape + (3,), dtype=torch.float32, device=table.device)
    z = torch.empty(shape, dtype=torch.float32, device=table.device)
    lib = kernels.load_library()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        error = lib.rasterize_bary_fwd(
            table.data_ptr(), ids.data_ptr(), bc.data_ptr(), z.data_ptr(),
            batch, n_tri, image_width, image_height, row_offset,
            rc.pixel_scale(image_width), rc.pixel_scale(full_height),
            int(group), int(split), stream)
    kernels.check_cuda_error(lib, error, "rasterize_bary_fwd launch")
    FWD_LAUNCHES += 1
    return ids, bc, z


def launch_bary_bwd(ids, bc, df_dbc, table, inv_abs_det):
    """Launch the barycentric-only backward kernel (K4); returns its
    coordinate-major per-triangle table [B, T, 9].

    Every operand must be a contiguous CUDA tensor on one device: ids
    [B, H, W] i32, bc and df_dbc [B, H, W, 3] f32, table [B, T, 16] f32,
    inv_abs_det [B, T] f32. H is a row strip's height where the forward
    rendered a strip; the kernel runs K2's grid of 8x8-pixel CTAs over
    W x H.
    """
    global BWD_LAUNCHES
    f32 = torch.float32
    rc.check_kernel_operands(ids.device, [
        ("ids", ids, torch.int32), ("bc", bc, f32), ("df_dbc", df_dbc, f32),
        ("table", table, f32), ("inv_abs_det", inv_abs_det, f32)])
    rc.check_backward_shapes(ids, bc, df_dbc, table, inv_abs_det)
    batch, n_tri = table.shape[:2]
    dtab = torch.zeros(batch, n_tri, 9, dtype=f32, device=ids.device)
    lib = kernels.load_library()
    with torch.cuda.device(ids.device):
        stream = torch.cuda.current_stream(ids.device).cuda_stream
        error = lib.rasterize_bary_bwd(
            ids.data_ptr(), bc.data_ptr(), df_dbc.data_ptr(),
            table.data_ptr(), inv_abs_det.data_ptr(), dtab.data_ptr(),
            batch, n_tri, ids.shape[2], ids.shape[1], stream)
    kernels.check_cuda_error(lib, error, "rasterize_bary_bwd launch")
    BWD_LAUNCHES += 1
    return dtab


def _no_attributes(table):
    """Corner attributes [B, T, 3, 0]: K1's plain versions with A = 0 are
    K3's and K4's."""
    return torch.zeros(table.shape[:2] + (3, 0), dtype=torch.float32,
                       device=table.device)


def triangle_gradients_bary_torch(ids, bc, df_dbc, table, inv_abs_det):
    """Plain version of K4: the [B, T, 9] table, as launch_bary_bwd."""
    df_dattr = torch.zeros(ids.shape + (0,), dtype=torch.float32,
                           device=ids.device)
    return rc.triangle_gradients_torch(ids, bc, df_dbc, df_dattr, table,
                                       inv_abs_det, _no_attributes(table))


def rasterize_barycentric_backward_torch(ids, bc, df_dbc, table,
                                         inv_abs_det, triangles,
                                         vertex_count):
    """Plain analytic backward: -> df/dclip [B, V, 4] (zero z column)."""
    return rc.scatter_triangle_gradients(
        triangle_gradients_bary_torch(ids, bc, df_dbc, table, inv_abs_det),
        triangles, vertex_count)[0]


def rasterize_barycentric_backward_cuda(ids, bc, df_dbc, table, inv_abs_det,
                                        triangles, vertex_count):
    """The analytic backward through K4; the plain version's contract.
    Raises on what the kernel does not take."""
    return rc.scatter_triangle_gradients(
        launch_bary_bwd(ids, bc, df_dbc, table, inv_abs_det), triangles,
        vertex_count)[0]


class _RasterizeBarycentric(torch.autograd.Function):
    """K3 or its plain version forward; K4 or its plain version backward."""

    @staticmethod
    def forward(ctx, clip_vertices, triangles, image_width, image_height,
                row_offset, full_height, triangle_chunk, use_kernel):
        needs_grad = ctx.needs_input_grad[0]
        table, inv_abs_det = rc.pack_rows(clip_vertices, triangles,
                                          needs_grad)
        if use_kernel:
            ids, bc, z = launch_bary_fwd(table, image_width, image_height,
                                         row_offset, full_height)
        else:
            ids, bc, _, z = rc.forward_torch_packed(
                table, _no_attributes(table), image_width, image_height,
                row_offset, full_height, True, triangle_chunk)
        ctx.mark_non_differentiable(ids, z)
        if needs_grad:
            ctx.save_for_backward(ids, bc, table, inv_abs_det, triangles)
            ctx.vertex_count = clip_vertices.shape[1]
            ctx.use_kernel = use_kernel
        return ids, bc, z

    @staticmethod
    @once_differentiable
    def backward(ctx, _d_ids, d_bc, _d_z):
        backward = (rasterize_barycentric_backward_cuda if ctx.use_kernel
                    else rasterize_barycentric_backward_torch)
        ids, bc, table, inv_abs_det, triangles = ctx.saved_tensors
        d_clip = backward(ids, bc, d_bc.contiguous(), table, inv_abs_det,
                          triangles, ctx.vertex_count)
        return (d_clip,) + (None,) * 7


def rasterize_barycentric_torch(clip_vertices, triangles, image_width,
                                image_height, row_offset=0, full_height=None,
                                triangle_chunk=64):
    """Plain PyTorch version of the barycentric-only kernels, any device.

    Args:
      clip_vertices: [B, V, 4] f32 clip-space positions.
      triangles: [T, 3] int32 vertex indices, on the same device.
      image_width, image_height, row_offset, full_height, triangle_chunk:
        as rasterize_cuda.rasterize_interpolate_torch.

    Returns:
      (ids [B, H, W] i32, barycentrics [B, H, W, 3] f32, z [B, H, W] f32).
    """
    row_offset, full_height = rc.resolve_rows(image_height, row_offset,
                                          full_height)
    rc.check_inputs(clip_vertices, None, triangles, image_width,
                    image_height, row_offset, full_height)
    if triangle_chunk < 1:
        raise ValueError("triangle_chunk must be >= 1")
    return _RasterizeBarycentric.apply(
        clip_vertices, triangles, int(image_width), int(image_height),
        row_offset, full_height, int(triangle_chunk), False)


def rasterize_barycentric_cuda(clip_vertices, triangles, image_width,
                               image_height, row_offset=0, full_height=None):
    """The barycentric-only CUDA kernels; rasterize_barycentric_torch's
    contract. The forward launches K3, the backward K4; anything the
    kernels do not take raises."""
    row_offset, full_height = rc.resolve_rows(image_height, row_offset,
                                          full_height)
    rc.check_inputs(clip_vertices, None, triangles, image_width,
                    image_height, row_offset, full_height)
    if clip_vertices.device.type != "cuda":
        raise ValueError("rasterize_barycentric_cuda needs CUDA tensors, got "
                         f"a tensor on {clip_vertices.device}")
    return _RasterizeBarycentric.apply(
        clip_vertices, triangles, int(image_width), int(image_height),
        row_offset, full_height, 64, True)
