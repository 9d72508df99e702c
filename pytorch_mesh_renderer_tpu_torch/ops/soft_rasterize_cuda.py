"""Soft (SoftRas) rasterization: kernels and plain versions, forward and
analytic backward.

Port of K5-K8, the four kernels of the JAX package's
`ops/soft_rasterize_pallas.py`, and of the glue around them:

  * `pack_triangle_data`, the batched twin of `_pack_triangle_data`
    (:133-213): the per-triangle table [B, T, 59] with the same column
    layout, plain differentiable PyTorch as it is plain XLA there (no
    chunk padding: the kernels take any T, zero included);
  * `make_params`, the twin of `_make_params` (:1265): sigma, gamma,
    blur^2 and the row offset as 4 f32 on the device;
  * `soft_forward_torch_packed`, the plain forward: a dense loop over
    triangle chunks of [C, B, H, W] tensors that mirrors `_chunk_forward`
    (:318-419) and the online-softmax merge of `_fwd_kernel` (:449-462). It
    multiplies the silhouette product triangle by triangle, in index order,
    as the kernels do, so that alpha can agree with theirs to the last bit;
  * `soft_backward_torch_packed`, the plain backward: autograd of the plain
    forward (recomputed chunk by chunk under `torch.utils.checkpoint`, so
    its memory stays at one chunk's graph);
  * the launchers of the CUDA kernels `csrc/soft_fwd.cu` (K7),
    `csrc/soft_bwd.cu` (K8), `csrc/soft_sil_fwd.cu` (K5) and
    `csrc/soft_sil_bwd.cu` (K6), each counting its launches
    (`launches.soft_fwd`, `.soft_bwd`, `.soft_sil_fwd`, `.soft_sil_bwd`
    in `utils/profiling.counters()`; a launch recorded into a CUDA graph
    counts once, at the capture);
  * two autograd Functions, the twins of `_soft_pallas_core` (:1278-1359)
    and `_soft_sil_core` (:1058-1109). Each takes the packed table (and
    the lights [B, L, 4]) and sigma/gamma and returns their cotangents;
    autograd carries the table's through the plain packing to the clip
    vertices, world positions, normals and colours, which is what `jax.vjp`
    of the pack does in `_bwd`.

The plain forward is written so that autograd reproduces the kernels'
hand-derived chain (the module docstring of the Pallas file, :31-39):
the running max m and the background weight are detached (m cancels); the
t and ndl clips pass gradient only strictly inside (0, 1); the squared
distance is the min of the three edges' (its gradient split evenly among
tied edges, as jnp.min's in the JAX XLA route) while the edge barycentrics
take the first nearest edge; 1/|edge|^2 is recomputed from cols 9-14 with
the pack's expression, so cols 56-58 take no gradient while the kernels
fold their chain into the edge gradients; square roots of zero take a
finite gradient. The kernels give cols 18-25 and 56-58 no gradient, and
neither does autograd of this forward.

Pixel centres: px = 2 (col + 0.5) / W - 1 and
py = -2 (row + row_offset + 0.5) / full_height + 1, rows top-down, computed
in numpy float32 here and with IEEE divisions in the kernels.

The port has no multi-pass merge and no per-pass triangle cap: the kernels
stream the table from device memory and accumulate its gradient there.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable
from torch.utils.checkpoint import checkpoint

from ..utils import kernels, profiling
from .math_utils import clip
from .mesh import gather
from .rasterize_cuda import check_kernel_operands

COLS = 59
EPS = 1e-10  # background-probability floor
NEG_BIG = -1e30


def _edge_len2(xs, ys):
    """Squared edge lengths (01, 12, 20) of the NDC corners (x0, x1, x2),
    (y0, y1, y2)."""
    def sq(a, b):
        dx = xs[b] - xs[a]
        dy = ys[b] - ys[a]
        return dx * dx + dy * dy
    return sq(0, 1), sq(1, 2), sq(2, 0)


def _inv_len2(l2):
    return 1.0 / torch.clamp(l2, min=1e-24)


def pack_triangle_data(clip_vertices, triangles, world_vertices, normals,
                       diffuse_colors, blur_radius):
    """Per-triangle table [B, T, 59] (differentiable).

    Args:
      clip_vertices: [B, V, 4] f32; world_vertices, normals and
        diffuse_colors [B, V, 3] f32; triangles [T, 3] int.
      blur_radius: Python float.

    Columns: 0-8 normalized 2D-inverse rows (screen barycentric
    coefficients), 9-14 NDC corner xy (x0, y0, x1, y1, x2, y2), 15-17 NDC
    corner z, 18-20 clip w, 21 keep (front-facing CCW and non-degenerate),
    22-25 blur-inflated NDC bbox, 26-34 world corner xyz, 35-43 corner
    normals, 44-52 corner diffuse rgb, 53-55 reciprocal clip w (guarded),
    56-58 reciprocal squared edge lengths (edges 01, 12, 20). The
    corners are gathered by `mesh.gather`, whose backward adds to the
    vertices in a fixed order.
    """
    batch, n_tri = clip_vertices.shape[0], triangles.shape[0]
    tv = gather(clip_vertices, triangles)  # [B, T, 3, 4]
    w = tv[..., 3]
    safe_w = torch.where(w != 0.0, w, 1.0)
    ndc = tv[..., :3] / safe_w[..., None]
    vx, vy, vz = ndc.unbind(-1)  # [B, T, 3] each
    x0, x1, x2 = vx.unbind(-1)
    y0, y1, y2 = vy.unbind(-1)

    area = (x0 - x1) * (y2 - y1) - (y0 - y1) * (x2 - x1)
    det = x0 * (y1 - y2) - x1 * (y0 - y2) + x2 * (y0 - y1)
    keep = ((area < 0.0) & (det != 0.0)).to(torch.float32)
    safe_det = torch.where(det != 0.0, det, 1.0)
    inv_det = torch.where(det != 0.0, 1.0 / safe_det, 0.0)
    adj = torch.stack([
        y1 - y2, x2 - x1, x1 * y2 - x2 * y1,
        y2 - y0, x0 - x2, x2 * y0 - x0 * y2,
        y0 - y1, x1 - x0, x0 * y1 - x1 * y0], dim=-1)
    m2_inv = adj * inv_det[..., None]

    bbox = torch.stack([
        torch.amin(vx, dim=-1) - blur_radius,
        torch.amax(vx, dim=-1) + blur_radius,
        torch.amin(vy, dim=-1) - blur_radius,
        torch.amax(vy, dim=-1) + blur_radius], dim=-1)
    vxy = torch.stack([x0, y0, x1, y1, x2, y2], dim=-1)
    inv_w = 1.0 / safe_w
    inv_len2 = _inv_len2(torch.stack(_edge_len2((x0, x1, x2),
                                                (y0, y1, y2)), dim=-1))

    def corners(values):
        return gather(values, triangles).reshape(batch, n_tri, 9)

    return torch.cat([
        m2_inv, vxy, vz, w, keep[..., None], bbox, corners(world_vertices),
        corners(normals), corners(diffuse_colors), inv_w, inv_len2],
        dim=-1).contiguous()


def _as_scalar(value, device, name):
    """A Python float or a 0-D (or one-element) tensor on `device`."""
    device = torch.device(device)
    if torch.is_tensor(value):
        if value.device != device:
            raise ValueError(f"{name} lies on {value.device}; move it to "
                             f"{device}")
        if value.numel() != 1:
            raise ValueError(f"{name} must be a scalar, got shape "
                             f"{tuple(value.shape)}")
        return value.to(torch.float32).reshape(())
    return torch.full((), float(value), dtype=torch.float32, device=device)


def make_params(sigma, gamma, blur_radius, row_offset, device):
    """[4] f32 (sigma, gamma, blur^2, row offset) on `device`.

    sigma and gamma may be Python floats or 0-D tensors on `device` (that
    may require a gradient); blur^2 is the f32 blur squared in f32.
    """
    blur = _as_scalar(blur_radius, device, "blur_radius")
    return torch.stack([_as_scalar(sigma, device, "sigma"),
                        _as_scalar(gamma, device, "gamma"), blur * blur,
                        _as_scalar(row_offset, device, "row_offset")])


def pixel_centers(image_width, image_height, row_offset, full_height,
                  device):
    """(px [W], py [H]) f32 NDC pixel centres, computed in float32 on
    `device` (IEEE divisions, as the kernels; no copy from the host, so a
    step that renders through the plain version can be captured), rows
    top-down."""
    f32 = dict(dtype=torch.float32, device=device)
    cols = torch.arange(image_width, **f32)
    rows = torch.arange(image_height, **f32) + float(row_offset)
    # Divided by tensors: on CUDA a division by a Python number multiplies
    # by its rounded reciprocal, which is not the IEEE quotient.
    width = torch.full((), float(image_width), **f32)
    height = torch.full((), float(full_height), **f32)
    px = 2.0 * (cols + 0.5) / width - 1.0
    py = -2.0 * (rows + 0.5) / height + 1.0
    return px, py


def _safe_sqrt(x):
    """sqrt(x) whose gradient at x = 0 is 0, not inf (same values)."""
    positive = x > 0.0
    return torch.where(positive, torch.sqrt(torch.where(positive, x, 1.0)),
                       0.0)


def _segment_sq_dist(px, py, ax, ay, bx, by, inv_len2):
    abx = bx - ax
    aby = by - ay
    t = clip(((px - ax) * abx + (py - ay) * aby) * inv_len2, 0.0, 1.0)
    nx = ax + t * abx - px
    ny = ay + t * aby - py
    return nx * nx + ny * ny, t


def _chunk_quantities(blk, px, py, lights, sigma, gamma, sq_blur, shade):
    """Forward quantities of a chunk: `_chunk_forward` on [C, B, H, W].

    blk: [C, B, 59] rows; px [W], py [H]; lights [B, L, 4].
    Returns (coverage, logit, (shade_r, shade_g, shade_b)) or, without
    shading, (coverage, None, None).
    """
    px = px.view(1, 1, 1, -1)
    py = py.view(1, 1, -1, 1)

    def col(k):
        return blk[..., k, None, None]  # [C, B, 1, 1]

    bc = [col(3 * i) * px + col(3 * i + 1) * py + col(3 * i + 2)
          for i in range(3)]
    inside = (bc[0] >= 0.0) & (bc[1] >= 0.0) & (bc[2] >= 0.0)
    x0, y0, x1, y1, x2, y2 = (col(k) for k in range(9, 15))
    # 1/|edge|^2 recomputed from cols 9-14 (see the module docstring).
    l01, l12, l20 = _edge_len2((x0, x1, x2), (y0, y1, y2))
    d01, t01 = _segment_sq_dist(px, py, x0, y0, x1, y1, _inv_len2(l01))
    d12, t12 = _segment_sq_dist(px, py, x1, y1, x2, y2, _inv_len2(l12))
    d20, t20 = _segment_sq_dist(px, py, x2, y2, x0, y0, _inv_len2(l20))
    # torch.amin splits the gradient evenly among tied distances, as
    # jnp.min does; the edge barycentrics take the first nearest edge
    # (jnp.argmin, which carries no gradient).
    sq_dist = torch.amin(torch.stack([d01, d12, d20]), dim=0)
    pick01 = (d01 <= d12) & (d01 <= d20)
    pick12 = ~pick01 & (d12 <= d20)
    zero = torch.zeros((), dtype=torch.float32, device=blk.device)
    eb = [torch.where(pick01, 1.0 - t01, torch.where(pick12, zero, t20)),
          torch.where(pick01, t01, torch.where(pick12, 1.0 - t12, zero)),
          torch.where(pick01, zero, torch.where(pick12, t12, 1.0 - t20))]
    cb = [torch.where(inside, b, e) for b, e in zip(bc, eb)]
    ow = [cb[k] * col(53 + k) for k in range(3)]
    # |ow| with d|ow|/dow = +1 at ow = 0, the derivative jnp.abs takes
    # (torch.abs takes 0 there, which breaks sum(sb) = 1 in the chain rule
    # at pixel centres on an edge, where a corner's ow is exactly 0).
    abs_ow = [torch.where(o >= 0.0, o, -o) for o in ow]
    denom = abs_ow[0] + abs_ow[1] + abs_ow[2]
    inv_denom = 1.0 / torch.clamp(denom, min=1e-12)
    sb = [o * inv_denom for o in ow]
    z_ndc = sb[0] * col(15) + sb[1] * col(16) + sb[2] * col(17)
    z = 0.5 - z_ndc * 0.5
    z_ok = (z >= 0.0) & (z <= 1.0)
    in_bbox = ((px >= col(22)) & (px <= col(23)) &
               (py >= col(24)) & (py <= col(25)))
    valid = ((col(21) > 0.0) & in_bbox & (inside | (sq_dist <= sq_blur))
             & z_ok)
    sgn = torch.where(inside, 1.0, -1.0)
    coverage = torch.where(valid, torch.sigmoid(sgn * sq_dist / sigma),
                           zero)
    if not shade:
        return coverage, None, None

    def interp(first):  # corner-major columns first + 3k + c
        return [sb[0] * col(first + c) + sb[1] * col(first + 3 + c)
                + sb[2] * col(first + 6 + c) for c in range(3)]

    p3 = interp(26)
    u = interp(35)
    n_inv = 1.0 / torch.clamp(
        _safe_sqrt(u[0] * u[0] + u[1] * u[1] + u[2] * u[2]), min=1e-12)
    n = [uc * n_inv for uc in u]
    color = interp(44)
    light_sum = torch.zeros_like(p3[0])
    for l in range(lights.shape[1]):
        def light(k):
            return lights[:, l, k].view(1, -1, 1, 1)
        d = [light(c) - p3[c] for c in range(3)]
        d_inv = 1.0 / torch.clamp(
            _safe_sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]), min=1e-12)
        ct = (d[0] * n[0] + d[1] * n[1] + d[2] * n[2]) * d_inv
        light_sum = light_sum + clip(ct, 0.0, 1.0) * light(3)
    logit = torch.where(valid, z / gamma, NEG_BIG)
    return coverage, logit, tuple(c * light_sum for c in color)


def _chunk_step(carry, blk, px, py, lights, sigma, gamma, sq_blur, shade):
    """One chunk of the online aggregation; carry is (sil,) or
    (run_max, sum_w, sum_r, sum_g, sum_b, sil), each [B, H, W]."""
    coverage, logit, shades = _chunk_quantities(blk, px, py, lights, sigma,
                                                gamma, sq_blur, shade)
    sil = carry[-1]
    one_minus = 1.0 - coverage
    for k in range(one_minus.shape[0]):  # triangle order, as the kernels
        sil = sil * one_minus[k]
    if not shade:
        return (sil,)
    run_max, *sums = carry[:-1]
    new_max = torch.maximum(run_max, torch.amax(logit.detach(), dim=0))
    scale = torch.exp(run_max - new_max)
    expw = coverage * torch.exp(logit - new_max)
    sums = [s * scale + torch.sum(v, dim=0)
            for s, v in zip(sums, (expw,) + tuple(expw * c for c in shades))]
    return (new_max, *sums, sil)


def soft_forward_torch_packed(table, lights, sigma, gamma, sq_blur,
                              image_height, image_width, row_offset,
                              full_height, silhouette_only,
                              triangle_chunk=64):
    """The plain forward on the packed table; K7's (and K5's) counterpart.

    Args:
      table: [B, T, 59] f32 (pack_triangle_data).
      lights: [B, L, 4] f32 (xyz, intensity); unused when silhouette_only.
      sigma, gamma, sq_blur: 0-D f32 tensors on the table's device.
      row_offset, full_height: render rows [row_offset, row_offset + H) of
        a full_height-row image.
      silhouette_only: compute alpha only (K5's function).
      triangle_chunk: triangles per dense step.

    Returns:
      alpha [B, H, W] when silhouette_only, else (rgb [B, H, W, 3],
      alpha [B, H, W], running max m [B, H, W], weight sum [B, H, W]).
      Under autograd each chunk is recomputed in the backward
      (torch.utils.checkpoint), so memory stays at one chunk's graph.
    """
    device = table.device
    batch, n_tri, _ = table.shape
    shape = (batch, image_height, image_width)
    px, py = pixel_centers(image_width, image_height, row_offset,
                           full_height, device)
    shade = not silhouette_only
    sil = torch.ones(shape, dtype=torch.float32, device=device)
    if shade:
        eps_over_gamma = (torch.full((), EPS, dtype=torch.float32,
                                     device=device) / gamma).detach()
        zeros = torch.zeros(shape, dtype=torch.float32, device=device)
        carry = (eps_over_gamma.expand(shape), zeros, zeros, zeros, zeros,
                 sil)
    else:
        carry = (sil,)
    blocks = table.transpose(0, 1)  # [T, B, 59]
    recompute = torch.is_grad_enabled() and any(
        torch.is_tensor(v) and v.requires_grad
        for v in (table, lights, sigma, gamma))
    for start in range(0, n_tri, triangle_chunk):
        blk = blocks[start:start + triangle_chunk]
        args = (blk, px, py, lights, sigma, gamma, sq_blur, shade)
        if recompute:
            carry = checkpoint(_chunk_step, carry, *args,
                               use_reentrant=False)
        else:
            carry = _chunk_step(carry, *args)
    alpha = 1.0 - carry[-1]
    if silhouette_only:
        return alpha
    run_max, sum_w, sum_r, sum_g, sum_b, _ = carry
    bg = torch.clamp(torch.exp(eps_over_gamma - run_max), min=EPS)
    inv_total = 1.0 / (sum_w + bg)
    rgb = torch.stack([sum_r * inv_total, sum_g * inv_total,
                       sum_b * inv_total], dim=-1)
    return rgb, alpha, run_max, sum_w


def _grads(output, inputs, cotangent):
    """d<output, cotangent>/d inputs, zeros where an input does not reach
    the output (a mesh without triangles reaches none)."""
    grads = ((None,) * len(inputs) if not output.requires_grad else
             torch.autograd.grad(output, inputs, cotangent,
                                 allow_unused=True))
    return tuple(torch.zeros_like(v) if g is None else g
                 for v, g in zip(inputs, grads))


def soft_backward_torch_packed(table, lights, sigma, gamma, sq_blur,
                               image_height, image_width, row_offset,
                               full_height, d_rgba, triangle_chunk=64):
    """Plain backward of the full forward; K8's counterpart.

    d_rgba: [B, H, W, 4] cotangent. Returns (dtable [B, T, 59],
    dlights [B, L, 4], dsigma, dgamma), by autograd of
    soft_forward_torch_packed.
    """
    with torch.enable_grad():
        inputs = [v.detach().requires_grad_(True)
                  for v in (table, lights, sigma, gamma)]
        rgb, alpha, _, _ = soft_forward_torch_packed(
            *inputs, sq_blur, image_height, image_width, row_offset,
            full_height, False, triangle_chunk)
        rgba = torch.cat([rgb, alpha[..., None]], dim=-1)
        return _grads(rgba, inputs, d_rgba)


def soft_silhouette_backward_torch_packed(table, sigma, sq_blur,
                                          image_height, image_width,
                                          row_offset, full_height, d_alpha,
                                          triangle_chunk=64):
    """Plain backward of the silhouette forward; K6's counterpart.

    d_alpha: [B, H, W]. Returns (dtable [B, T, 59], dsigma).
    """
    with torch.enable_grad():
        inputs = [v.detach().requires_grad_(True) for v in (table, sigma)]
        no_lights = table.new_zeros(table.shape[0], 0, 4)
        alpha = soft_forward_torch_packed(
            inputs[0], no_lights, inputs[1], inputs[1], sq_blur,
            image_height, image_width, row_offset, full_height, True,
            triangle_chunk)
        return _grads(alpha, inputs, d_alpha)


def _check_table(table, params, device):
    f32 = torch.float32
    check_kernel_operands(device, [("table", table, f32),
                                   ("params", params, f32)])
    if table.dim() != 3 or table.shape[-1] != COLS:
        raise ValueError(f"table has shape {tuple(table.shape)}; want "
                         f"[B, T, {COLS}]")
    if params.shape != (4,):
        raise ValueError(f"params has shape {tuple(params.shape)}; want [4]")
    batch, n_tri = table.shape[:2]
    if batch > 65535 or batch * n_tri * COLS >= 2 ** 31:
        raise ValueError("the table exceeds the kernels' grid or int32 "
                         "extents")


def _check_lights(lights, table):
    if (lights.dim() != 3 or lights.shape[0] != table.shape[0]
            or lights.shape[-1] != 4):
        raise ValueError(f"lights have shape {tuple(lights.shape)}; want "
                         "[B, L, 4]")


def _check_aligned(**tensors):
    """The kernels read these as float4: 16-byte aligned."""
    for name, tensor in tensors.items():
        if tensor.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def launch_soft_fwd(table, lights, params, image_width, image_height,
                    full_height, split=0):
    """Launch K7; returns (rgba [B, H, W, 4], m [B, H, W], sum_w [B, H, W]).

    table [B, T, 59], lights [B, L, 4] (16-byte aligned) and params [4]
    (make_params): contiguous f32 tensors on one CUDA device. split: CTAs
    per pixel block, one thread-block cluster (1, 2, 4 or 8); 0, the
    default, takes the kernel's compiled kSplit. Other values serve only to
    measure that choice (chip_smoke.py, utils/soft_work.py). The outputs do
    not depend on it.
    """
    device = table.device
    _check_table(table, params, device)
    check_kernel_operands(device, [("lights", lights, torch.float32)])
    _check_lights(lights, table)
    _check_aligned(lights=lights)
    batch, n_tri = table.shape[:2]
    shape = (batch, image_height, image_width)
    rgba = torch.empty(shape + (4,), dtype=torch.float32, device=device)
    run_max = torch.empty(shape, dtype=torch.float32, device=device)
    sum_w = torch.empty(shape, dtype=torch.float32, device=device)
    lib = kernels.load_library()
    with torch.cuda.device(device):
        error = lib.soft_fwd(
            table.data_ptr(), lights.data_ptr(), params.data_ptr(),
            rgba.data_ptr(), run_max.data_ptr(), sum_w.data_ptr(), batch,
            n_tri, lights.shape[1], image_width, image_height, full_height,
            int(split), _stream(device))
    kernels.check_cuda_error(lib, error, "soft_fwd launch")
    profiling.count("launches.soft_fwd")
    return rgba, run_max, sum_w


def launch_soft_bwd(table, lights, params, rgba, run_max, sum_w, d_rgba,
                    full_height, split=0):
    """Launch K8; returns (dtable [B, T, 59], dlights [B, L, 4],
    dparams [B, 2] = per-image (dsigma, dgamma)).

    rgba, run_max and sum_w are K7's outputs, d_rgba [B, H, W, 4] the
    cotangent; every operand a contiguous f32 tensor on one CUDA device.
    split: CTAs per pixel block; 0, the default, takes the kernel's
    compiled kSplit. Other values serve only to measure that choice
    (chip_smoke.py).
    """
    device = table.device
    f32 = torch.float32
    _check_table(table, params, device)
    check_kernel_operands(device, [
        ("lights", lights, f32), ("rgba", rgba, f32),
        ("run_max", run_max, f32), ("sum_w", sum_w, f32),
        ("d_rgba", d_rgba, f32)])
    _check_lights(lights, table)
    batch, n_tri = table.shape[:2]
    if (rgba.dim() != 4 or rgba.shape[0] != batch or rgba.shape[-1] != 4
            or d_rgba.shape != rgba.shape
            or run_max.shape != rgba.shape[:3]
            or sum_w.shape != rgba.shape[:3]):
        raise ValueError(
            f"backward operands have shapes rgba {tuple(rgba.shape)}, "
            f"d_rgba {tuple(d_rgba.shape)}, run_max {tuple(run_max.shape)},"
            f" sum_w {tuple(sum_w.shape)}; want [B, H, W, 4] twice and "
            "[B, H, W] twice")
    _check_aligned(lights=lights, rgba=rgba, d_rgba=d_rgba)
    height, width = rgba.shape[1:3]
    n_lights = lights.shape[1]
    dtable = torch.zeros_like(table)
    dlights = torch.zeros_like(lights)
    dparams = torch.zeros(batch, 2, dtype=f32, device=device)
    lib = kernels.load_library()
    with torch.cuda.device(device):
        error = lib.soft_bwd(
            table.data_ptr(), lights.data_ptr(), params.data_ptr(),
            rgba.data_ptr(), run_max.data_ptr(), sum_w.data_ptr(),
            d_rgba.data_ptr(), dtable.data_ptr(), dlights.data_ptr(),
            dparams.data_ptr(), batch, n_tri, n_lights, width, height,
            full_height, int(split), _stream(device))
    kernels.check_cuda_error(lib, error, "soft_bwd launch")
    profiling.count("launches.soft_bwd")
    return dtable, dlights, dparams


def launch_sil_fwd(table, params, image_width, image_height, full_height,
                   split=0):
    """Launch K5; returns alpha [B, H, W]. Operands and split as
    launch_soft_fwd's; alpha does not depend on the split and equals K7's
    bit for bit."""
    device = table.device
    _check_table(table, params, device)
    batch, n_tri = table.shape[:2]
    alpha = torch.empty(batch, image_height, image_width,
                        dtype=torch.float32, device=device)
    lib = kernels.load_library()
    with torch.cuda.device(device):
        error = lib.soft_sil_fwd(
            table.data_ptr(), params.data_ptr(), alpha.data_ptr(), batch,
            n_tri, image_width, image_height, full_height, int(split),
            _stream(device))
    kernels.check_cuda_error(lib, error, "soft_sil_fwd launch")
    profiling.count("launches.soft_sil_fwd")
    return alpha


def launch_sil_bwd(table, params, alpha, d_alpha, full_height, split=0,
                   scratch=None):
    """Launch K6 and its reduce pass; returns (dtable [B, T, 59], dsigma
    [B] per image).

    alpha is K5's output and d_alpha [B, H, W] its cotangent; every operand
    a contiguous f32 tensor on one CUDA device. split: CTAs per pixel
    block, as launch_soft_bwd's. The sums run in a fixed order: two calls
    on the same inputs give the same bits. The kernels take 24 bytes of
    scratch per (image, table row, 16x16 pixel block), up to 256 MB: past
    that the rows run in chunks, a K6 and a reduce launch each (one launch
    count for the call). scratch: None to allocate that, or a contiguous
    f32 tensor on the device to use instead; the rows then run in as few
    chunks as it holds, and a buffer too small for one row raises.
    """
    device = table.device
    f32 = torch.float32
    _check_table(table, params, device)
    check_kernel_operands(device, [("alpha", alpha, f32),
                                   ("d_alpha", d_alpha, f32)])
    batch, n_tri = table.shape[:2]
    if (alpha.dim() != 3 or alpha.shape[0] != batch
            or d_alpha.shape != alpha.shape):
        raise ValueError(f"alpha {tuple(alpha.shape)} and d_alpha "
                         f"{tuple(d_alpha.shape)} want [B, H, W]")
    height, width = alpha.shape[1:]
    lib = kernels.load_library()
    dtable = torch.zeros_like(table)
    dsigma = torch.empty(batch, dtype=f32, device=device)
    if scratch is None:
        scratch = torch.empty(lib.soft_sil_bwd_scratch_floats(
            batch, n_tri, width, height, int(split)), dtype=f32,
            device=device)
    check_kernel_operands(device, [("scratch", scratch, f32)])
    with torch.cuda.device(device):
        error = lib.soft_sil_bwd(
            table.data_ptr(), params.data_ptr(), alpha.data_ptr(),
            d_alpha.data_ptr(), dtable.data_ptr(), dsigma.data_ptr(),
            scratch.data_ptr(), scratch.numel(), batch, n_tri, width, height,
            full_height, int(split), _stream(device))
    kernels.check_cuda_error(lib, error, "soft_sil_bwd launch")
    profiling.count("launches.soft_sil_bwd")
    return dtable, dsigma


class _SoftRasterize(torch.autograd.Function):
    """K7 or the plain forward; K8 or the plain backward (the forward's
    route). Inputs: table [B, T, 59], lights [B, L, 4], 0-D sigma and
    gamma. Output: rgba [B, H, W, 4]."""

    @staticmethod
    def forward(ctx, table, lights, sigma, gamma, blur_radius, image_width,
                image_height, row_offset, full_height, triangle_chunk,
                use_kernel):
        params = make_params(sigma, gamma, blur_radius, row_offset,
                             table.device)
        if use_kernel:
            rgba, run_max, sum_w = launch_soft_fwd(
                table, lights, params, image_width, image_height,
                full_height)
        else:
            rgb, alpha, run_max, sum_w = soft_forward_torch_packed(
                table, lights, params[0], params[1], params[2],
                image_height, image_width, row_offset, full_height, False,
                triangle_chunk)
            rgba = torch.cat([rgb, alpha[..., None]], dim=-1)
        ctx.save_for_backward(table, lights, params, rgba, run_max, sum_w)
        ctx.rows = (image_height, image_width, row_offset, full_height)
        ctx.triangle_chunk = triangle_chunk
        ctx.use_kernel = use_kernel
        return rgba

    @staticmethod
    @once_differentiable
    def backward(ctx, d_rgba):
        table, lights, params, rgba, run_max, sum_w = ctx.saved_tensors
        d_rgba = d_rgba.contiguous()
        if d_rgba.data_ptr() % 16:  # K8 reads it as float4
            d_rgba = d_rgba.clone()
        if ctx.use_kernel:
            dtable, dlights, dparams = launch_soft_bwd(
                table, lights, params, rgba, run_max, sum_w, d_rgba,
                ctx.rows[3])
            dsigma, dgamma = dparams.sum(0).unbind()
        else:
            dtable, dlights, dsigma, dgamma = soft_backward_torch_packed(
                table, lights, params[0], params[1], params[2], *ctx.rows,
                d_rgba, ctx.triangle_chunk)
        needs = ctx.needs_input_grad
        return ((dtable if needs[0] else None,
                 dlights if needs[1] else None,
                 dsigma if needs[2] else None,
                 dgamma if needs[3] else None) + (None,) * 7)


class _SoftSilhouette(torch.autograd.Function):
    """K5 or the plain silhouette forward; K6 or the plain backward.
    Inputs: table [B, T, 59], 0-D sigma. Output: alpha [B, H, W]."""

    @staticmethod
    def forward(ctx, table, sigma, blur_radius, image_width, image_height,
                row_offset, full_height, triangle_chunk, use_kernel):
        # gamma does not enter the silhouette; 1.0 fills its slot.
        params = make_params(sigma, 1.0, blur_radius, row_offset,
                             table.device)
        if use_kernel:
            alpha = launch_sil_fwd(table, params, image_width, image_height,
                                   full_height)
        else:
            alpha = soft_forward_torch_packed(
                table, None, params[0], params[1], params[2], image_height,
                image_width, row_offset, full_height, True, triangle_chunk)
        ctx.save_for_backward(table, params, alpha)
        ctx.rows = (image_height, image_width, row_offset, full_height)
        ctx.triangle_chunk = triangle_chunk
        ctx.use_kernel = use_kernel
        return alpha

    @staticmethod
    @once_differentiable
    def backward(ctx, d_alpha):
        table, params, alpha = ctx.saved_tensors
        d_alpha = d_alpha.contiguous()
        if ctx.use_kernel:
            dtable, dsigma = launch_sil_bwd(table, params, alpha, d_alpha,
                                            ctx.rows[3])
            dsigma = dsigma.sum()
        else:
            dtable, dsigma = soft_silhouette_backward_torch_packed(
                table, params[0], params[2], *ctx.rows, d_alpha,
                ctx.triangle_chunk)
        needs = ctx.needs_input_grad
        return ((dtable if needs[0] else None,
                 dsigma if needs[1] else None) + (None,) * 7)


def _check_blur(blur_radius):
    if torch.is_tensor(blur_radius):
        raise TypeError(
            "blur_radius must be a Python float (it shapes the packed "
            "triangle bboxes); sigma and gamma may be tensors.")
    return float(blur_radius)


def soft_rasterize(clip_vertices, triangles, world_vertices, normals,
                   diffuse_colors, lights, sigma, gamma, blur_radius,
                   image_width, image_height, row_offset, full_height,
                   use_kernel, triangle_chunk=64):
    """Pack, then K7/K8 (use_kernel) or the plain versions: [B, H, W, 4].

    lights: [B, L, 4] (xyz, intensity). Gradients reach every tensor input
    (clip, world, normals, colours, lights, sigma, gamma).
    """
    device = clip_vertices.device
    blur = _check_blur(blur_radius)
    table = pack_triangle_data(clip_vertices, triangles, world_vertices,
                               normals, diffuse_colors, blur)
    return _SoftRasterize.apply(
        table, lights.contiguous(), _as_scalar(sigma, device, "sigma"),
        _as_scalar(gamma, device, "gamma"), blur, int(image_width),
        int(image_height), int(row_offset), int(full_height),
        int(triangle_chunk), bool(use_kernel))


def soft_rasterize_silhouette(clip_vertices, triangles, sigma, blur_radius,
                              image_width, image_height, row_offset,
                              full_height, use_kernel, triangle_chunk=64):
    """Pack, then K5/K6 (use_kernel) or the plain versions: [B, H, W]."""
    device = clip_vertices.device
    blur = _check_blur(blur_radius)
    zeros = torch.zeros(clip_vertices.shape[:2] + (3,), dtype=torch.float32,
                        device=device)
    table = pack_triangle_data(clip_vertices, triangles, zeros, zeros, zeros,
                               blur)
    return _SoftSilhouette.apply(
        table, _as_scalar(sigma, device, "sigma"), blur, int(image_width),
        int(image_height), int(row_offset), int(full_height),
        int(triangle_chunk), bool(use_kernel))
