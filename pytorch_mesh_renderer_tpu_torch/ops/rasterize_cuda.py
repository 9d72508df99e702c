"""Fused hard rasterization + attribute interpolation: kernel and plain version.

Port of K1, the JAX package's fused forward rasterizer:

  * triangle packing (`rasterize_pallas.py:217-246`, `binning.py:65-84`) and
    corner-attribute packing (`rasterize_pallas.py:1050-1056`), plain
    PyTorch here as they are plain XLA there;
  * `rasterize_interpolate_torch`, the plain version: a dense z-buffer over
    triangle chunks (the shape of `rasterize_xla.py:47-146`) that computes
    exactly what the kernel computes, in the same operation order. It is
    the semantic spec, the CPU path, and what the kernel is held against;
  * `rasterize_interpolate_cuda`, the wrapper of the hand-written CUDA
    kernel `csrc/rasterize_fused_fwd.cu`, which replaces `_kernel_fused` /
    `_kernel_fused_body` (`rasterize_pallas.py:1059-1196`).

Both return (ids [B,H,W] i32, barycentrics [B,H,W,3] f32, attributes
[B,H,W,A] f32), plus z [B,H,W] f32 when `with_z`. Pixel centres follow the
Pallas kernel: px = (col + 0.5) * (2/W) - 1 and
py = (row + row_offset + 0.5) * (2/full_height) - 1, with the scales
rounded to f32 once on the host.

Gradients are not ported yet: both functions are forward-only autograd
Functions whose backward raises NotImplementedError. Letting autograd run
through the plain ops would give gradients that differ from the JAX
package's analytic VJP (no vertex-z gradient, a degenerate-pixel cutoff).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import kernels
from .barycentric import pixel_is_inside, unnormalized_matrix_inverse

# Packed triangle row: 9 edge coefficients (a, b, c per edge), 3 clip z,
# 3 clip w, liveness. 16 f32 = 64 bytes, four 16-byte loads in the kernel.
TRI_COLS = 16

# Launches of the CUDA kernel in this process; the wrapper adds one per
# launch and nothing else touches it. chip_smoke.py resets and reads it to
# show that a run went through the kernel.
LAUNCHES = 0

_BACKWARD_MESSAGE = (
    "The hard rasterizer's gradient is not ported yet: its analytic "
    "backward (K2, rasterize_pallas._bwd_kernel_fused) is ported next. "
    "Autograd through the plain ops would not match the JAX package's "
    "custom VJP.")


def pack_triangles(clip_vertices: torch.Tensor,
                   triangles: torch.Tensor) -> torch.Tensor:
    """[B, V, 4] clip vertices, [T, 3] triangles -> [B, T, 16] rows.

    Columns 0-8: the sign-corrected adjugate rows (edge coefficients),
    9-11: clip z, 12-14: clip w, 15: liveness (0 when all three w < 0).
    """
    tv = clip_vertices[:, triangles.long()]  # [B, T, 3, 4]
    x, y, vz, vw = tv.unbind(-1)
    m_inv, _ = unnormalized_matrix_inverse(x, y, vw)
    live = (~torch.all(vw < 0.0, dim=-1)).to(torch.float32)
    batch, n_tri = tv.shape[:2]
    return torch.cat([m_inv.reshape(batch, n_tri, 9), vz, vw,
                      live[..., None]], dim=-1).contiguous()


def pack_corner_attributes(attributes: torch.Tensor,
                           triangles: torch.Tensor) -> torch.Tensor:
    """[B, V, A] -> [B, T, 3, A] per-triangle corner attributes."""
    return attributes[:, triangles.long()].contiguous()


def pixel_scale(extent: int) -> float:
    """2/extent rounded to f32: the NDC step between pixel centres."""
    return float(np.float32(2.0 / extent))


def _forward_torch(clip_vertices, attributes, triangles, image_width,
                   image_height, row_offset, full_height, with_z,
                   triangle_chunk):
    table = pack_triangles(clip_vertices, triangles)
    corner = pack_corner_attributes(attributes, triangles)
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
        attrs = torch.zeros(shape + (attributes.shape[-1],),
                            dtype=torch.float32, device=device)
    out = (ids.to(torch.int32), torch.stack(bc, dim=-1), attrs)
    return out + (best_z,) if with_z else out


def _check_inputs(clip_vertices, attributes, triangles, image_width,
                  image_height, row_offset, full_height):
    if clip_vertices.dim() != 3 or clip_vertices.shape[-1] != 4:
        raise ValueError("clip_vertices must have shape [batch, V, 4], got "
                         f"{tuple(clip_vertices.shape)}")
    if (attributes.dim() != 3 or
            attributes.shape[:2] != clip_vertices.shape[:2]):
        raise ValueError("attributes must have shape [batch, V, A] matching "
                         f"clip_vertices, got {tuple(attributes.shape)}")
    if triangles.dim() != 2 or triangles.shape[-1] != 3:
        raise ValueError("triangles must have shape [T, 3], got "
                         f"{tuple(triangles.shape)}")
    if clip_vertices.dtype != torch.float32:
        raise TypeError(f"clip_vertices must be float32, got "
                        f"{clip_vertices.dtype}")
    if attributes.dtype != torch.float32:
        raise TypeError(f"attributes must be float32, got {attributes.dtype}")
    if triangles.dtype != torch.int32:
        raise TypeError(f"triangles must be int32, got {triangles.dtype}")
    devices = {clip_vertices.device, attributes.device, triangles.device}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on different devices: {devices}")
    if image_width < 1 or image_height < 1:
        raise ValueError("image_width and image_height must be >= 1")
    if row_offset < 0 or full_height < 1:
        raise ValueError("row_offset must be >= 0 and full_height >= 1")
    if clip_vertices.shape[0] < 1:
        raise ValueError("batch must be >= 1")


def launch_fused_fwd(table, corner, image_width, image_height, row_offset,
                     full_height, with_z):
    """Launch the CUDA kernel on packed tables; returns its outputs.

    Args:
      table: [B, T, 16] f32 packed triangle rows (pack_triangles), CUDA,
        contiguous, 16-byte aligned.
      corner: [B, T, 3, A] f32 corner attributes (pack_corner_attributes),
        contiguous, on the same device.

    Returns:
      (ids, barycentrics, attributes[, z]) as rasterize_interpolate_cuda.
    """
    global LAUNCHES
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
            pixel_scale(full_height), stream)
    kernels.check_cuda_error(lib, error, "rasterize_fused_fwd launch")
    LAUNCHES += 1
    out = (ids, bc, attrs)
    return out + (z,) if with_z else out


def _forward_cuda(clip_vertices, attributes, triangles, image_width,
                  image_height, row_offset, full_height, with_z):
    return launch_fused_fwd(pack_triangles(clip_vertices, triangles),
                            pack_corner_attributes(attributes, triangles),
                            image_width, image_height, row_offset,
                            full_height, with_z)


class _ForwardOnly(torch.autograd.Function):
    """Runs a forward implementation; its backward is not ported yet."""

    @staticmethod
    def forward(ctx, impl, clip_vertices, attributes, *args):
        outs = impl(clip_vertices, attributes, *args)
        # ids, and z when present: the JAX VJP gives neither a gradient.
        ctx.mark_non_differentiable(outs[0], *outs[3:])
        return outs

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(_BACKWARD_MESSAGE)


def _resolve(image_height, row_offset, full_height):
    full_height = image_height if full_height is None else int(full_height)
    return int(row_offset), full_height


def rasterize_interpolate_torch(clip_vertices, attributes, triangles,
                                image_width, image_height, row_offset=0,
                                full_height=None, with_z=False,
                                triangle_chunk=64):
    """Plain PyTorch version of the fused kernel, on any device.

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
    """
    row_offset, full_height = _resolve(image_height, row_offset, full_height)
    _check_inputs(clip_vertices, attributes, triangles, image_width,
                  image_height, row_offset, full_height)
    if triangle_chunk < 1:
        raise ValueError("triangle_chunk must be >= 1")
    return _ForwardOnly.apply(
        _forward_torch, clip_vertices, attributes, triangles,
        int(image_width), int(image_height), row_offset, full_height,
        bool(with_z), int(triangle_chunk))


def rasterize_interpolate_cuda(clip_vertices, attributes, triangles,
                               image_width, image_height, row_offset=0,
                               full_height=None, with_z=False):
    """The fused CUDA kernel; same contract as rasterize_interpolate_torch.

    Raises on anything the kernel does not take: tensors off the card or on
    different devices, wrong types or shapes. A CUDA launch error raises
    with its message. Adds one to LAUNCHES per launch.
    """
    row_offset, full_height = _resolve(image_height, row_offset, full_height)
    _check_inputs(clip_vertices, attributes, triangles, image_width,
                  image_height, row_offset, full_height)
    if clip_vertices.device.type != "cuda":
        raise ValueError("rasterize_interpolate_cuda needs CUDA tensors, got "
                         f"a tensor on {clip_vertices.device}")
    return _ForwardOnly.apply(
        _forward_cuda, clip_vertices, attributes, triangles,
        int(image_width), int(image_height), row_offset, full_height,
        bool(with_z))
