"""Fused hard rasterization + attribute interpolation: kernels and plain
versions, forward and analytic backward.

Port of K1 and K2, the JAX package's fused forward rasterizer and its
fused backward:

  * triangle packing (`rasterize_pallas.py:217-246`, `binning.py:65-84`) and
    corner-attribute packing (`rasterize_pallas.py:1050-1056`), plain
    PyTorch here as they are plain XLA there;
  * `rasterize_interpolate_torch`, the plain forward: a dense z-buffer over
    triangle chunks (the shape of `rasterize_xla.py:47-146`) that computes
    exactly what the kernel computes, in the same operation order. It is
    the semantic spec, the CPU path, and what the kernel is held against;
  * `rasterize_interpolate_cuda`, the wrapper of the hand-written CUDA
    kernel `csrc/rasterize_fused_fwd.cu`, which replaces `_kernel_fused` /
    `_kernel_fused_body` (`rasterize_pallas.py:1059-1196`);
  * `rasterize_interpolate_backward_torch`, the plain analytic backward
    (the closed form of `rasterize_xla.py:149-190` plus the interpolation
    VJP of `rasterize_pallas.py:1344-1377`), and
    `rasterize_interpolate_backward_cuda`, whose per-triangle reduction is
    the CUDA kernel `csrc/rasterize_fused_bwd.cu`, which replaces
    `_bwd_kernel_fused` (`rasterize_pallas.py:1282-1402`). Both reduce to a
    per-triangle table [B, T, 9 + 3A] and scatter it to vertices with
    `scatter_triangle_gradients` (`_scatter_corner_grads` and the attribute
    scatter, `rasterize_pallas.py:755-767, 1495-1506`).

The forwards return (ids [B,H,W] i32, barycentrics [B,H,W,3] f32,
attributes [B,H,W,A] f32), plus z [B,H,W] f32 when `with_z`. Pixel centres
follow the Pallas kernel: px = (col + 0.5) * (2/W) - 1 and
py = (row + row_offset + 0.5) * (2/full_height) - 1, with the scales
rounded to f32 once on the host.

Gradients flow to the clip vertices and the attributes through an
autograd Function whose backward is the analytic VJP of the JAX package,
not autograd through the plain ops: vertex z gets no gradient, pixels with
id 0 and a barycentric sum below 0.9 contribute nothing, and the ids and z
outputs take no cotangent. The backward runs the route the forward ran:
the kernel after the kernel, the plain version after the plain version.

The forward's packing is an `mr.rasterize.pack` span and K1's launch an
`mr.rasterize.launch` span (`utils/profiling.annotate`); each launch of
K1 or K2 counts one `launches.rasterize_fused_fwd` or
`launches.rasterize_fused_bwd` (`utils/profiling.count`), once at a
CUDA graph's capture and never at its replays.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ..utils import kernels, profiling
from .barycentric import (DEGENERATE_BARYCENTRIC_CUTOFF, pixel_is_inside,
                          unnormalized_matrix_inverse)
from .mesh import vertex_plan

# Packed triangle row: 9 edge coefficients (a, b, c per edge), 3 clip z,
# 3 clip w, liveness. 16 f32 = 64 bytes, four 16-byte loads in the kernel.
TRI_COLS = 16


def pack_rows(clip_vertices: torch.Tensor, triangles: torch.Tensor,
              with_inv_abs_det: bool):
    """[B, V, 4] clip vertices, [T, 3] triangles -> ([B, T, 16] rows,
    [B, T] 1/|det| or None).

    Row columns 0-8: the sign-corrected adjugate rows (edge coefficients),
    9-11: clip z, 12-14: clip w, 15: liveness (0 when all three w < 0).
    1/|det| is `where(|det| > 0, 1 / max(|det|, 1e-30), 0)`, column 20 of
    the JAX package's packing (`rasterize_pallas.py:230-233`); only the
    backward reads it, so it stays out of the kernel's 64-byte row.
    """
    tv = clip_vertices[:, triangles.long()]  # [B, T, 3, 4]
    x, y, vz, vw = tv.unbind(-1)
    m_inv, det = unnormalized_matrix_inverse(x, y, vw)
    live = (~torch.all(vw < 0.0, dim=-1)).to(torch.float32)
    batch, n_tri = tv.shape[:2]
    table = torch.cat([m_inv.reshape(batch, n_tri, 9), vz, vw,
                       live[..., None]], dim=-1).contiguous()
    if not with_inv_abs_det:
        return table, None
    abs_det = det.abs()
    inv_abs_det = torch.where(abs_det > 0.0,
                              1.0 / torch.clamp(abs_det, min=1e-30), 0.0)
    return table, inv_abs_det.contiguous()


def pack_corner_attributes(attributes: torch.Tensor,
                           triangles: torch.Tensor) -> torch.Tensor:
    """[B, V, A] -> [B, T, 3, A] per-triangle corner attributes."""
    return attributes[:, triangles.long()].contiguous()


def pixel_scale(extent: int) -> float:
    """2/extent rounded to f32: the NDC step between pixel centres."""
    return float(np.float32(2.0 / extent))


def forward_torch_packed(table, corner, image_width, image_height,
                         row_offset, full_height, with_z, triangle_chunk=64):
    """The plain forward on packed tables; launch_fused_fwd's counterpart.

    Returns (ids, barycentrics, attributes[, z]) as
    rasterize_interpolate_torch.
    """
    batch, n_tri, _ = table.shape
    device = table.device
    shape = (batch, image_height, image_width)

    cols = torch.arange(image_width, dtype=torch.float32, device=device)
    rows = torch.arange(image_height, dtype=torch.float32,
                        device=device) + float(row_offset)
    px = ((cols + 0.5) * pixel_scale(image_width) - 1.0).view(
        1, 1, image_width, 1)
    py = ((rows + 0.5) * pixel_scale(full_height) - 1.0).view(
        1, image_height, 1, 1)

    best_z = torch.ones(shape, dtype=torch.float32, device=device)
    best_id = torch.full(shape, -1, dtype=torch.int64, device=device)
    best_we = [torch.zeros(shape, dtype=torch.float32, device=device)
               for _ in range(3)]
    for start in range(0, n_tri, triangle_chunk):
        blk = table[:, start:start + triangle_chunk][:, None, None]

        def col(k):  # [B, 1, 1, C], broadcast against px / py
            return blk[..., k]

        e = [col(3 * i) * px + col(3 * i + 1) * py + col(3 * i + 2)
             for i in range(3)]  # 3 x [B, H, W, C]
        inside = pixel_is_inside(*e)
        num = e[0] * col(9) + e[1] * col(10) + e[2] * col(11)
        den = e[0] * col(12) + e[1] * col(13) + e[2] * col(14)
        z = num / torch.where(den != 0.0, den, 1.0)
        valid = inside & (col(15) > 0.0) & (z >= -1.0) & (z <= 1.0)

        # Chunk winner: smallest z, ties to the larger id.
        z_masked = torch.where(valid, z, torch.inf)
        chunk_z = torch.amin(z_masked, dim=-1)
        ids_c = torch.arange(start, start + z.shape[-1], device=device)
        at_min = valid & (z_masked == chunk_z[..., None])
        chunk_id = torch.amax(torch.where(at_min, ids_c, -1), dim=-1)
        local = (chunk_id - start).clamp(min=0)[..., None]

        better = (chunk_z < best_z) | ((chunk_z == best_z) &
                                       (chunk_id > best_id))
        best_z = torch.where(better, chunk_z, best_z)
        best_id = torch.where(better, chunk_id, best_id)
        best_we = [torch.where(better, ek.gather(-1, local)[..., 0], wk)
                   for ek, wk in zip(e, best_we)]

    sum_e = best_we[0] + best_we[1] + best_we[2]
    inv_sum = torch.reciprocal(torch.where(sum_e != 0.0, sum_e, 1.0))
    bc = [wk * inv_sum for wk in best_we]
    covered = best_id >= 0
    ids = best_id.clamp(min=0)
    if n_tri:
        winner_corners = corner[torch.arange(batch, device=device)[
            :, None, None], ids]  # [B, H, W, 3, A]
        attrs = (winner_corners[..., 0, :] * bc[0][..., None]
                 + winner_corners[..., 1, :] * bc[1][..., None]
                 + winner_corners[..., 2, :] * bc[2][..., None])
        attrs = torch.where(covered[..., None], attrs, 0.0)
    else:
        attrs = torch.zeros(shape + (corner.shape[-1],),
                            dtype=torch.float32, device=device)
    out = (ids.to(torch.int32), torch.stack(bc, dim=-1), attrs)
    return out + (best_z,) if with_z else out


def check_inputs(clip_vertices, attributes, triangles, image_width,
                 image_height, row_offset, full_height):
    """Validate a forward call's arguments; `attributes` may be None."""
    if clip_vertices.dim() != 3 or clip_vertices.shape[-1] != 4:
        raise ValueError("clip_vertices must have shape [batch, V, 4], got "
                         f"{tuple(clip_vertices.shape)}")
    if attributes is not None and (
            attributes.dim() != 3 or
            attributes.shape[:2] != clip_vertices.shape[:2]):
        raise ValueError("attributes must have shape [batch, V, A] matching "
                         f"clip_vertices, got {tuple(attributes.shape)}")
    if triangles.dim() != 2 or triangles.shape[-1] != 3:
        raise ValueError("triangles must have shape [T, 3], got "
                         f"{tuple(triangles.shape)}")
    if clip_vertices.dtype != torch.float32:
        raise TypeError(f"clip_vertices must be float32, got "
                        f"{clip_vertices.dtype}")
    if attributes is not None and attributes.dtype != torch.float32:
        raise TypeError(f"attributes must be float32, got {attributes.dtype}")
    if triangles.dtype != torch.int32:
        raise TypeError(f"triangles must be int32, got {triangles.dtype}")
    devices = {clip_vertices.device, triangles.device}
    if attributes is not None:
        devices.add(attributes.device)
    if len(devices) != 1:
        raise ValueError(f"inputs lie on different devices: {devices}")
    if image_width < 1 or image_height < 1:
        raise ValueError("image_width and image_height must be >= 1")
    if row_offset < 0 or full_height < 1:
        raise ValueError("row_offset must be >= 0 and full_height >= 1")
    if clip_vertices.shape[0] < 1:
        raise ValueError("batch must be >= 1")


def launch_fused_fwd(table, corner, image_width, image_height, row_offset,
                     full_height, with_z, split=0):
    """Launch the CUDA kernel on packed tables; returns its outputs.

    Args:
      table: [B, T, 16] f32 packed triangle rows (pack_rows), CUDA,
        contiguous, 16-byte aligned.
      corner: [B, T, 3, A] f32 corner attributes (pack_corner_attributes),
        contiguous, on the same device.
      split: CTAs per group of 2x2 pixel blocks, one thread-block cluster
        (1, 2, 4 or 8); 0, the default, takes the kernel's compiled kSplit.
        Other values serve only to measure that choice (chip_smoke.py,
        utils/hard_work.py). The outputs do not depend on it.

    Returns:
      (ids, barycentrics, attributes[, z]) as rasterize_interpolate_cuda.
    """
    if table.device.type != "cuda" or corner.device != table.device:
        raise ValueError("the packed tables must lie on one CUDA device")
    if table.dtype != torch.float32 or corner.dtype != torch.float32:
        raise TypeError("the packed tables must be float32")
    batch, n_tri = table.shape[:2]
    if (table.shape != (batch, n_tri, TRI_COLS) or corner.dim() != 4
            or corner.shape[:3] != (batch, n_tri, 3)):
        raise ValueError(
            f"packed tables have shapes {tuple(table.shape)} and "
            f"{tuple(corner.shape)}; want [B, T, {TRI_COLS}] and "
            "[B, T, 3, A]")
    if not (table.is_contiguous() and corner.is_contiguous()):
        raise ValueError("the packed tables must be contiguous")
    if table.data_ptr() % 16:
        raise ValueError("the packed triangle table must be 16-byte aligned")
    n_attr = corner.shape[-1]
    if max(batch, n_tri * TRI_COLS, n_attr * 3) >= 2 ** 31:
        raise ValueError("tables exceed the kernel's int32 extents")

    device = table.device
    shape = (batch, image_height, image_width)
    ids = torch.empty(shape, dtype=torch.int32, device=device)
    bc = torch.empty(shape + (3,), dtype=torch.float32, device=device)
    z = (torch.empty(shape, dtype=torch.float32, device=device)
         if with_z else None)
    attrs = torch.empty(shape + (n_attr,), dtype=torch.float32,
                        device=device)

    lib = kernels.load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        error = lib.rasterize_fused_fwd(
            table.data_ptr(), corner.data_ptr(), ids.data_ptr(),
            bc.data_ptr(), z.data_ptr() if with_z else None,
            attrs.data_ptr(), batch, n_tri, n_attr, image_width,
            image_height, row_offset, pixel_scale(image_width),
            pixel_scale(full_height), int(split), stream)
    kernels.check_cuda_error(lib, error, "rasterize_fused_fwd launch")
    profiling.count("launches.rasterize_fused_fwd")
    out = (ids, bc, attrs)
    return out + (z,) if with_z else out


def check_kernel_operands(device, operands):
    """Raise unless `device` is a CUDA device and every (name, tensor,
    dtype) of `operands` lies on it, has that dtype and is contiguous."""
    if device.type != "cuda":
        raise ValueError(f"the kernel needs CUDA tensors, got {device}")
    for name, tensor, dtype in operands:
        if tensor.device != device:
            raise ValueError(f"{name} lies on {tensor.device}; the kernel's "
                             f"operands must all lie on {device}")
        if tensor.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {tensor.dtype}")
        if not tensor.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def check_backward_shapes(ids, bc, df_dbc, table, inv_abs_det):
    """Shapes shared by the two backward kernels' operands."""
    batch, n_tri = table.shape[:2]
    if (ids.dim() != 3 or ids.shape[0] != batch
            or bc.shape != ids.shape + (3,) or df_dbc.shape != bc.shape
            or table.shape != (batch, n_tri, TRI_COLS)
            or inv_abs_det.shape != (batch, n_tri)):
        raise ValueError(
            f"backward operands have shapes ids {tuple(ids.shape)}, bc "
            f"{tuple(bc.shape)}, df_dbc {tuple(df_dbc.shape)}, table "
            f"{tuple(table.shape)}, inv_abs_det {tuple(inv_abs_det.shape)};"
            f" want [B, H, W], [B, H, W, 3] twice, [B, T, {TRI_COLS}], "
            "[B, T]")
    if table.data_ptr() % 16:
        raise ValueError("the packed triangle table must be 16-byte aligned")
    if batch > 65535 or ids[0].numel() >= 2 ** 31:
        raise ValueError("the image batch exceeds the kernel's grid")


def triangle_gradients_torch(ids, bc, df_dbc, df_dattr, table, inv_abs_det,
                             corner):
    """Plain version of the backward kernels: the per-triangle table.

    Args:
      ids, bc: [B, H, W] i32 and [B, H, W, 3] f32 forward outputs.
      df_dbc, df_dattr: [B, H, W, 3] and [B, H, W, A] f32 cotangents of the
        barycentrics and the interpolated attributes (A may be 0).
      table, inv_abs_det: [B, T, 16] packed rows and [B, T] 1/|det|.
      corner: [B, T, 3, A] f32 corner attributes.

    Returns:
      [B, T, 9 + 3A] f32: column c*3 + k is corner k's coordinate-c clip
      gradient (c in x, y, w), column 9 + k*A + a corner k's attribute-a
      gradient. Each pixel adds its values (`pixel_gradient_terms`) to its
      winner's row.
    """
    batch, n_tri = table.shape[:2]
    n_attr = corner.shape[-1]
    # Out-of-place index_add throughout, so that the backward also runs
    # under torch.func.vmap (batched Jacobians in the tests).
    dtab = torch.zeros(batch * n_tri, 9 + 3 * n_attr, dtype=torch.float32,
                       device=table.device)
    if n_tri == 0:
        return dtab.view(batch, 0, 9 + 3 * n_attr)
    flat, vals = pixel_gradient_terms(ids, bc, df_dbc, df_dattr, table,
                                      inv_abs_det, corner)
    dtab = dtab.index_add(0, flat.reshape(-1),
                          vals.reshape(-1, vals.shape[-1]))
    return dtab.view(batch, n_tri, -1)


def pixel_gradient_terms(ids, bc, df_dbc, df_dattr, table, inv_abs_det,
                         corner):
    """Each pixel's contribution to its winner's row of the per-triangle
    table, in the operation order of the kernels
    (csrc/rasterize_bwd_common.cuh). Arguments as triangle_gradients_torch
    (T >= 1).

    Returns:
      (rows [B, H, W] i64: the winner's row b*T + id of the flattened
      table; values [B, H, W, 9 + 3A] f32, zero at inactive pixels).
    """
    n_tri = table.shape[1]
    n_attr = corner.shape[-1]
    b0, b1, b2 = bc.unbind(-1)
    active = ~((ids == 0) & (b0 + b1 + b2 < DEGENERATE_BARYCENTRIC_CUTOFF))
    flat = (torch.arange(ids.shape[0], device=ids.device)[:, None, None]
            * n_tri + ids.long())  # [B, H, W] rows of the flattened table
    m = table.reshape(-1, TRI_COLS)[flat].unbind(-1)  # m[i*3 + c]
    inv = inv_abs_det.reshape(-1)[flat]
    g0, g1, g2 = df_dbc.unbind(-1)
    if n_attr:
        corners = corner.reshape(-1, 3, n_attr)[flat]  # [B, H, W, 3, A]
        d0, d1, d2 = (df_dattr[..., None, :] * corners).sum(-1).unbind(-1)
        g0, g1, g2 = g0 + d0, g1 + d1, g2 + d2
    gb = g0 * b0 + g1 * b1 + g2 * b2
    t = [(m[c] + m[3 + c] + m[6 + c]) * gb
         - (g0 * m[c] + g1 * m[3 + c] + g2 * m[6 + c]) for c in range(3)]
    t = [tc * inv for tc in t]
    bk = (b0, b1, b2)
    vals = [torch.stack([bk[k] * t[c] for c in range(3) for k in range(3)],
                        dim=-1)]
    vals += [bk[k][..., None] * df_dattr for k in range(3)] if n_attr else []
    return flat, torch.where(active[..., None], torch.cat(vals, dim=-1), 0.0)


def scatter_triangle_gradients(dtab, triangles, vertex_count):
    """[B, T, 9 + 3A] per-triangle table -> (df/dclip [B, V, 4] with a
    zero z column, df/dattributes [B, V, A]).

    The T-sized scatter of `_scatter_corner_grads` and the attribute
    scatter (`rasterize_pallas.py:755-767, 1498-1505`), plain PyTorch as it
    is plain XLA there, through `mesh.segment_sum`'s plan of the triangles:
    each vertex adds its corners in (triangle, corner) order, with no
    atomic.
    """
    batch, n_tri, width = dtab.shape
    n_attr = (width - 9) // 3
    xyw, d_corner = dtab.split([9, 3 * n_attr], dim=-1)
    xyw = xyw.reshape(batch, n_tri, 3, 3).transpose(2, 3)
    clip_updates = torch.cat([xyw[..., :2], torch.zeros(
        batch, n_tri, 3, 1, dtype=torch.float32, device=dtab.device),
        xyw[..., 2:]], dim=-1)  # [B, T, k, 4]
    plan = vertex_plan(triangles, vertex_count)
    d_clip = plan.sum(clip_updates.reshape(batch, n_tri * 3, 4))
    d_attr = plan.sum(d_corner.reshape(batch, n_tri * 3, n_attr))
    return d_clip, d_attr


def launch_fused_bwd(ids, bc, df_dbc, df_dattr, table, inv_abs_det, corner):
    """Launch the fused backward kernel (K2); returns its per-triangle
    table [B, T, 9 + 3A], as triangle_gradients_torch.

    Every operand must be a contiguous CUDA tensor on one device: ids i32,
    the rest f32, shaped as triangle_gradients_torch's arguments.
    """
    f32 = torch.float32
    check_kernel_operands(ids.device, [
        ("ids", ids, torch.int32), ("bc", bc, f32), ("df_dbc", df_dbc, f32),
        ("df_dattr", df_dattr, f32), ("table", table, f32),
        ("inv_abs_det", inv_abs_det, f32), ("corner", corner, f32)])
    check_backward_shapes(ids, bc, df_dbc, table, inv_abs_det)
    batch, n_tri = table.shape[:2]
    n_attr = corner.shape[-1]
    if (corner.shape != (batch, n_tri, 3, n_attr)
            or df_dattr.shape != ids.shape + (n_attr,)):
        raise ValueError(
            f"corner {tuple(corner.shape)} and df_dattr "
            f"{tuple(df_dattr.shape)} want [B, T, 3, A] and [B, H, W, A]")
    dtab = torch.zeros(batch, n_tri, 9 + 3 * n_attr, dtype=f32,
                       device=ids.device)
    lib = kernels.load_library()
    with torch.cuda.device(ids.device):
        stream = torch.cuda.current_stream(ids.device).cuda_stream
        error = lib.rasterize_fused_bwd(
            ids.data_ptr(), bc.data_ptr(), df_dbc.data_ptr(),
            df_dattr.data_ptr(), table.data_ptr(), inv_abs_det.data_ptr(),
            corner.data_ptr(), dtab.data_ptr(), batch, n_tri, n_attr,
            ids.shape[2], ids.shape[1], stream)
    kernels.check_cuda_error(lib, error, "rasterize_fused_bwd launch")
    profiling.count("launches.rasterize_fused_bwd")
    return dtab


def rasterize_interpolate_backward_torch(ids, bc, df_dbc, df_dattr, table,
                                         inv_abs_det, corner, triangles,
                                         vertex_count):
    """Plain analytic backward: -> (df/dclip [B, V, 4], df/dattr [B, V, A]).

    Arguments as triangle_gradients_torch, plus the [T, 3] triangles and
    the vertex count V.
    """
    return scatter_triangle_gradients(
        triangle_gradients_torch(ids, bc, df_dbc, df_dattr, table,
                                 inv_abs_det, corner), triangles,
        vertex_count)


def rasterize_interpolate_backward_cuda(ids, bc, df_dbc, df_dattr, table,
                                        inv_abs_det, corner, triangles,
                                        vertex_count):
    """The analytic backward through K2; rasterize_interpolate_backward_torch's
    contract. Raises on what the kernel does not take."""
    return scatter_triangle_gradients(
        launch_fused_bwd(ids, bc, df_dbc, df_dattr, table, inv_abs_det,
                         corner), triangles, vertex_count)


class _RasterizeInterpolate(torch.autograd.Function):
    """K1 or its plain version forward; K2 or its plain version backward."""

    @staticmethod
    def forward(ctx, clip_vertices, attributes, triangles, image_width,
                image_height, row_offset, full_height, with_z,
                triangle_chunk, use_kernel):
        needs_grad = any(ctx.needs_input_grad[:2])
        with profiling.annotate("mr.rasterize.pack"):
            table, inv_abs_det = pack_rows(clip_vertices, triangles,
                                           needs_grad)
            corner = pack_corner_attributes(attributes, triangles)
        if use_kernel:
            with profiling.annotate("mr.rasterize.launch"):
                outs = launch_fused_fwd(table, corner, image_width,
                                        image_height, row_offset,
                                        full_height, with_z)
        else:
            outs = forward_torch_packed(table, corner, image_width,
                                        image_height, row_offset,
                                        full_height, with_z, triangle_chunk)
        # ids, and z when present: the JAX VJP gives neither a gradient.
        ctx.mark_non_differentiable(outs[0], *outs[3:])
        if needs_grad:
            ctx.save_for_backward(outs[0], outs[1], table, inv_abs_det,
                                  corner, triangles)
            ctx.vertex_count = clip_vertices.shape[1]
            ctx.use_kernel = use_kernel
        return outs

    @staticmethod
    @once_differentiable
    def backward(ctx, _d_ids, d_bc, d_attrs, *_d_z):
        backward = (rasterize_interpolate_backward_cuda if ctx.use_kernel
                    else rasterize_interpolate_backward_torch)
        ids, bc, table, inv_abs_det, corner, triangles = ctx.saved_tensors
        d_clip, d_attr = backward(ids, bc, d_bc.contiguous(),
                                  d_attrs.contiguous(), table, inv_abs_det,
                                  corner, triangles, ctx.vertex_count)
        return (d_clip if ctx.needs_input_grad[0] else None,
                d_attr if ctx.needs_input_grad[1] else None) + (None,) * 8


def resolve_rows(image_height, row_offset, full_height):
    full_height = image_height if full_height is None else int(full_height)
    return int(row_offset), full_height


def rasterize_interpolate_torch(clip_vertices, attributes, triangles,
                                image_width, image_height, row_offset=0,
                                full_height=None, with_z=False,
                                triangle_chunk=64):
    """Plain PyTorch version of the fused kernels, on any device.

    Args:
      clip_vertices: [B, V, 4] f32 clip-space positions.
      attributes: [B, V, A] f32 per-vertex attributes.
      triangles: [T, 3] int32 vertex indices, on the same device.
      image_width, image_height: the image (or row strip) size.
      row_offset, full_height: render rows [row_offset, row_offset + H) of
        a full_height-row image (full_height defaults to image_height).
      with_z: also return the z-buffer.
      triangle_chunk: triangles per dense step; bounds peak memory.

    Returns:
      (ids, barycentrics, attributes[, z]); see the module docstring.
      Gradients reach clip_vertices and attributes through the plain
      analytic backward.
    """
    row_offset, full_height = resolve_rows(image_height, row_offset,
                                           full_height)
    check_inputs(clip_vertices, attributes, triangles, image_width,
                 image_height, row_offset, full_height)
    if triangle_chunk < 1:
        raise ValueError("triangle_chunk must be >= 1")
    return _RasterizeInterpolate.apply(
        clip_vertices, attributes, triangles, int(image_width),
        int(image_height), row_offset, full_height, bool(with_z),
        int(triangle_chunk), False)


def rasterize_interpolate_cuda(clip_vertices, attributes, triangles,
                               image_width, image_height, row_offset=0,
                               full_height=None, with_z=False):
    """The fused CUDA kernels; same contract as rasterize_interpolate_torch.

    The forward launches K1, the backward K2. Raises on anything the
    kernels do not take: tensors off the card or on different devices,
    wrong types or shapes. A CUDA launch error raises with its message.
    Counts each launch (`utils/profiling.count`): one
    `launches.rasterize_fused_fwd` per forward, one
    `launches.rasterize_fused_bwd` per backward.
    """
    row_offset, full_height = resolve_rows(image_height, row_offset,
                                           full_height)
    check_inputs(clip_vertices, attributes, triangles, image_width,
                 image_height, row_offset, full_height)
    if clip_vertices.device.type != "cuda":
        raise ValueError("rasterize_interpolate_cuda needs CUDA tensors, got "
                         f"a tensor on {clip_vertices.device}")
    return _RasterizeInterpolate.apply(
        clip_vertices, attributes, triangles, int(image_width),
        int(image_height), row_offset, full_height, bool(with_z), 64, True)
