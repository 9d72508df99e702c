"""Golden-image comparison, Jacobian checks and a stdlib PNG reader and
writer.

Port of `pytorch_mesh_renderer_tpu/utils/test_utils.py:21-140`
(`images_are_near`, `expect_image_file_and_render_are_near`: the same
0.1%-of-pixels outlier budget at a 0.01 channel threshold; the analytical
and central-difference Jacobians and their outlier comparator). PNGs are read
with `read_png` and written with `write_png`, built on zlib and struct
alone, so golden images can be checked and renders saved where imageio is
not installed. The soft kernels' scenes and
their gates against the plain versions (`soft_scene`,
`compare_soft_forward`, `compare_soft_backward`) serve chip_smoke.py and
the card tests alike.
"""

from __future__ import annotations

import struct
import zlib
from typing import NamedTuple

import numpy as np
import torch

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Channels per 8-bit PNG colour type: gray, RGB, gray+alpha, RGBA.
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> bytes:
    """Undo the per-row PNG filters (types 0-4) of 8-bit image data."""
    out = bytearray()
    prev = bytearray(stride)
    for y in range(height):
        start = y * (stride + 1)
        kind = raw[start]
        line = bytearray(raw[start + 1:start + 1 + stride])
        if kind == 1:  # Sub: a running sum per channel, modulo 256
            sums = np.cumsum(np.frombuffer(line, np.uint8).reshape(-1, bpp),
                             axis=0, dtype=np.uint64)
            line = bytearray((sums & 0xFF).astype(np.uint8).tobytes())
        elif kind == 2:  # Up
            line = bytearray((np.frombuffer(line, np.uint8)
                              + np.frombuffer(prev, np.uint8)).tobytes())
        elif kind == 3:  # Average: depends on decoded left bytes
            for x in range(stride):
                left = line[x - bpp] if x >= bpp else 0
                line[x] = (line[x] + ((left + prev[x]) >> 1)) & 0xFF
        elif kind == 4:  # Paeth: depends on decoded left bytes
            for x in range(stride):
                a = line[x - bpp] if x >= bpp else 0
                b = prev[x]
                c = prev[x - bpp] if x >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                line[x] = (line[x] + pred) & 0xFF
        elif kind != 0:
            raise ValueError(f"unknown PNG filter type {kind}")
        out += line
        prev = line
    return bytes(out)


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit, non-interlaced gray/RGB/gray+alpha/RGBA PNG.

    Returns:
      [H, W, C] uint8 array (C = 1, 3, 2 or 4, the file's own channels).
    """
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path} is not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path} has no IHDR chunk")
    width, height, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"{path}: unsupported PNG (bit depth {depth}, colour type "
            f"{color}, interlace {interlace}); only 8-bit non-interlaced "
            "gray/RGB/gray+alpha/RGBA is read")
    channels = _CHANNELS[color]
    raw = zlib.decompress(b"".join(idat))
    pixels = _unfilter(raw, height, width * channels, channels)
    return np.frombuffer(pixels, np.uint8).reshape(height, width, channels)


def write_png(path: str, image) -> None:
    """Write an [H, W] or [H, W, C] uint8 image (C = 1 gray, 2 gray+alpha,
    3 RGB, 4 RGBA) as an 8-bit, non-interlaced PNG, every row unfiltered."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8 pixels, not {image.dtype}")
    if image.ndim == 2:
        image = image[..., None]
    color = {c: kind for kind, c in _CHANNELS.items()}.get(
        image.shape[-1] if image.ndim == 3 else None)
    if color is None:
        raise ValueError(f"write_png takes [H, W] or [H, W, 1-4] pixels, "
                         f"not {image.shape}")
    height, width, _ = image.shape
    rows = np.zeros((height, 1 + image[0].size), np.uint8)  # filter 0
    rows[:, 1:] = image.reshape(height, -1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE
                + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8,
                                             color, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes()))
                + chunk(b"IEND", b""))


def images_are_near(baseline_image, result_image,
                    max_outlier_fraction=0.001,
                    pixel_error_threshold=0.01):
    """Soft image comparison.

    Images match when at most `max_outlier_fraction` of pixels have any
    channel differing by more than `pixel_error_threshold`. Returns
    (matched: bool, outlier_fraction: float).
    """
    if torch.is_tensor(baseline_image):
        baseline_image = baseline_image.detach().cpu().numpy()
    if torch.is_tensor(result_image):
        result_image = result_image.detach().cpu().numpy()
    baseline_image = np.asarray(baseline_image, np.float64)
    result_image = np.asarray(result_image, np.float64)
    if baseline_image.shape != result_image.shape:
        raise ValueError("Image shapes {} and {} do not match.".format(
            baseline_image.shape, result_image.shape))
    outlier_pixels = np.any(
        np.abs(baseline_image - result_image) > pixel_error_threshold,
        axis=-1)
    outlier_fraction = (
        np.count_nonzero(outlier_pixels) / np.prod(baseline_image.shape[:2]))
    return outlier_fraction <= max_outlier_fraction, outlier_fraction


def expect_image_file_and_render_are_near(baseline_path, result_image,
                                          max_outlier_fraction=0.001,
                                          pixel_error_threshold=0.01):
    """Compare a render to a PNG on disk; raise AssertionError on mismatch.

    The render is clipped to [0, 1] before comparison. Returns the outlier
    fraction.
    """
    baseline_image = read_png(baseline_path).astype(np.float64) / 255.0
    if torch.is_tensor(result_image):
        result_image = result_image.detach().cpu().numpy()
    result_image = np.clip(np.asarray(result_image, np.float64), 0.0, 1.0)
    matched, outlier_fraction = images_are_near(
        baseline_image, result_image, max_outlier_fraction,
        pixel_error_threshold)
    if not matched:
        raise AssertionError(
            f"{baseline_path} does not match. ({outlier_fraction} of pixels "
            f"are outliers, {max_outlier_fraction} is allowed.)")
    return outlier_fraction


# One-hot cotangents per batched backward pass of get_analytical_jacobian:
# bounds the vmapped backward's memory on the largest Jacobian tested
# (4,704 outputs).
_JACOBIAN_ROWS_PER_PASS = 512


def get_analytical_jacobian(fn, x):
    """Jacobian of fn at x by reverse mode, laid out [x.size, out.size].

    Port of `pytorch_mesh_renderer_tpu/utils/test_utils.py:82-90`. The
    output's one-hot cotangents go through autograd a block at a time
    (`is_grads_batched`, which vmaps the backward).
    """
    x = x.detach().to(torch.float32).requires_grad_(True)
    out = fn(x).reshape(-1)
    rows = []
    for start in range(0, out.numel(), _JACOBIAN_ROWS_PER_PASS):
        stop = min(start + _JACOBIAN_ROWS_PER_PASS, out.numel())
        onehot = torch.zeros(stop - start, out.numel(), dtype=out.dtype)
        onehot[torch.arange(stop - start), torch.arange(start, stop)] = 1.0
        (grad,) = torch.autograd.grad(out, x, onehot, retain_graph=True,
                                      is_grads_batched=True)
        rows.append(grad.reshape(stop - start, -1))
    return torch.cat(rows).T.numpy()


def get_numerical_jacobian(fn, x, eps=1e-3):
    """Central-difference Jacobian, laid out [x.size, out.size].

    Port of `pytorch_mesh_renderer_tpu/utils/test_utils.py:93-112`: x is
    perturbed in float64 and handed to fn as float32.
    """
    x = np.array(torch.as_tensor(x).detach(), np.float64)
    flat = x.reshape(-1)

    def evaluate():
        with torch.no_grad():
            out = fn(torch.from_numpy(x.astype(np.float32)))
        return out.numpy().astype(np.float64).reshape(-1)

    jacobian = np.zeros([x.size, evaluate().size], np.float64)
    for i in range(flat.size):
        orig = flat[i]
        flat[i] = orig - eps
        outa = evaluate()
        flat[i] = orig + eps
        outb = evaluate()
        flat[i] = orig
        jacobian[i] = (outb - outa) / (2 * eps)
    return jacobian


def check_jacobians_are_nearly_equal(theoretical, numerical,
                                     outlier_relative_error_threshold,
                                     max_outlier_fraction):
    """Compare Jacobians allowing a fraction of relative-error outliers.

    Port of `pytorch_mesh_renderer_tpu/utils/test_utils.py:115-138`, with
    its comparator: the relative error divides by |numerical|, so entries
    where the numerical Jacobian is zero and the analytical one is not
    count as outliers. Returns (matched: bool, message: str).
    """
    theoretical = np.asarray(theoretical, np.float64)
    numerical = np.asarray(numerical, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = np.abs(numerical - theoretical) / np.abs(numerical)
    outliers = rel > outlier_relative_error_threshold
    outlier_fraction = (
        np.count_nonzero(outliers) / np.prod(numerical.shape[:2]))
    matched = outlier_fraction <= max_outlier_fraction
    message = ("%f of gradients are relative outliers, max allowed %f" %
               (outlier_fraction, max_outlier_fraction))
    return matched, message


# The soft (SoftRas) kernels K5-K8 against their plain versions: the scenes
# and the gates that chip_smoke.py and tests/test_torch_cuda.py share.

SOFT_SIGMA, SOFT_GAMMA, SOFT_BLUR = 1e-3, 1e-2, 0.08
SOFT_SCENES = ("two_triangle", "cube", "random1", "random3")
# Scenes at K8's edges: 65 and 0 lights (the kernels cap none), a quad of
# two triangles filling a 256x256 frame (one triangle covers every pixel
# block, so every CTA of a block's split walks all its row pairs), a
# batch whose second image holds no valid pair, and a sphere whose edges
# run through pixel centres (`on_edges_arrays`: a corner weight exactly 0,
# where d|ow|/dow must be +1), and the pose fit's cube at angles 0, whose
# pixel centres lie at exactly equal distance from two edges of a triangle
# (the backward splits the squared distance's gradient between them), and
# one triangle whose clips meet their bounds (`t_bound_arrays`: an edge
# offset t of exactly 0 and of exactly 1, light cosines of exactly 1 and
# 0, where the derivative of the clip is 1/2), and a triangle beside
# degenerate ones (`zero_edge_arrays`: a zero-length edge, whose packed
# reciprocal squared length is 1e24, a collinear triangle and a duplicate).
SOFT_EDGE_SCENES = ("random65", "random0", "quad", "empty_image", "on_edges",
                    "pose_tie", "t_bound", "zero_edge")
# The on_edges scene's image and soft parameters.
ON_EDGES_SIZE = (45, 31)
ON_EDGES_SIGMA, ON_EDGES_GAMMA, ON_EDGES_BLUR = 1e-4, 1e-3, 0.05
# Forward gates (tests/test_soft_pallas.py:62, the JAX suite's gate between
# its two soft backends). The kernels aggregate the softmax per triangle,
# the plain version per chunk of triangles, so rgb differs in the last
# bits; the silhouette product runs in the same order in both.
SOFT_RGB_ATOL, SOFT_RGB_RTOL = 2e-5, 1e-4
SOFT_ALPHA_ATOL = 1e-6
# Backward gate, relative to each plain tensor's max |value| and, for the
# table gradient, to each column group's (the JAX suite's CPU gate between
# its soft backward backends, tests/test_soft_pallas.py:81-89). The
# kernels sum per-pixel terms with warp shuffles in another order than
# the plain version, and K8 with atomic adds whose order changes from run
# to run (K6's order is fixed).
SOFT_GRAD_RTOL = 1e-4
# d/dgamma's gate, the JAX suite's own (tests/test_soft_pallas.py:183-184).
# It sums per-pixel terms W (shade - rgb) z / gamma^2 that cancel: at the
# teapot's gamma of 1e-4 the sum's rounding reached 1.8e-3 of its value on
# an H100.
SOFT_DGAMMA_RTOL = 1e-2
# Column groups of the [B, T, 59] table gradient by the input of the
# packing that each column comes from, each held against its own max
# |value| as the JAX suite holds the clip, world, normal and colour
# gradients apart: the clip group's edge corners (~1/sigma) would hide an
# error in the others. The clip group is not split further: its barycentric
# and z columns sum per-pixel terms scaled by 1/gamma that cancel, so their
# rounding is set by the edge corners' scale (the teapot at gamma 1e-4: a
# bary error of 1.9e-4 of the bary columns' own max, 1.4e-7 of the clip
# group's). The last group takes no gradient on either route.
SOFT_Z_COLUMNS = [15, 16, 17]
SOFT_DTABLE_GROUPS = (
    ("clip", list(range(0, 18)) + [53, 54, 55]),
    ("world", list(range(26, 35))), ("normals", list(range(35, 44))),
    ("colours", list(range(44, 53))),
    ("none", list(range(18, 26)) + [56, 57, 58]))


class SoftScene(NamedTuple):
    """A packed soft scene and how to compare its kernels.

    depth_matters is False where no pixel blends two depths (every
    triangle lies at one depth, or a pixel sees one triangle): the render
    then does not depend on gamma or z, and both routes return f32
    cancellation noise for d/dgamma and the z columns (per-pixel terms
    W (shade - rgb) z / gamma^2 that cancel), which are not compared.
    """
    table: torch.Tensor  # [B, T, 59]
    lights: torch.Tensor  # [B, L, 4]
    params: torch.Tensor  # [4]: sigma, gamma, blur^2, row offset
    width: int
    height: int
    depth_matters: bool = True
    triangle_chunk: int = 64  # the plain version's


def clip_from_eye(world, eye, width, height):
    """Clip-space vertices [B, V, 4] of world [B, V, 3] seen from `eye` (a
    3-list or a [B, 3] tensor) toward the origin, y up, fov_y 40, near
    0.01, far 10."""
    from ..ops import camera

    batch = world.shape[0]
    f32 = dict(dtype=torch.float32, device=world.device)
    eye = eye if torch.is_tensor(eye) else torch.tensor([eye] * batch, **f32)
    cam = camera.clip_space_transforms(
        eye, torch.zeros(batch, 3, **f32),
        torch.tensor([[0.0, 1.0, 0.0]] * batch, **f32),
        torch.full((batch,), 40.0, **f32), torch.full((batch,), 0.01, **f32),
        torch.full((batch,), 10.0, **f32), width, height)
    return camera.transform_homogeneous(cam, world)


def on_edges_arrays():
    """The soft scene whose pixel centres lie on triangle edges, as numpy
    arrays (the soft renderer's arguments, CCW): the sphere of radius 1 at
    resolution 9, at batch 2 (the second image scaled by 0.8 and shifted by
    0.1), seen from (0.3, 0.5, 4) toward the origin at 45x31, where column
    22's pixel centres (x = 0) lie on the edges through the poles; seeded
    diffuse colours, three lights and their scalar intensities."""
    from ..models import shapes

    v, t, _ = shapes.sphere(1.0, 9)
    v = v.numpy()
    rng = np.random.RandomState(0)
    vertices = np.stack([v, v * np.float32(0.8) + np.float32(0.1)])
    lights = rng.uniform(-3.0, 3.0, (2, 3, 3)).astype(np.float32)
    lights[..., 2] = np.abs(lights[..., 2]) + 2.0
    return dict(
        vertices=vertices, triangles=t.numpy(),
        diffuse=rng.uniform(0.2, 1.0, vertices.shape).astype(np.float32),
        eye=np.float32([[0.3, 0.5, 4.0]] * 2),
        center=np.zeros((2, 3), np.float32),
        up=np.float32([[0.0, 1.0, 0.0]] * 2), lights=lights,
        intensities=rng.uniform(0.5, 1.5, (2, 3)).astype(np.float32))


# The t_bound scene's image, soft parameters, and its pixels (row, column,
# top-down) where the clips meet their bounds: t of edge v0v1 is exactly 0
# and exactly 1 (the centres 0.005 below v0 and v1), the second light's
# cosine is exactly 1 (the light stands on the triangle's normal through
# the centre's surface point; the cosine is at its maximum there, so its
# derivative is 0 but for rounding), and the third light's is exactly 0
# at every pixel (it lies in the triangle's plane): "ndl0" names a pixel
# inside the triangle.
T_BOUND_SIZE = 8
T_BOUND_SIGMA, T_BOUND_GAMMA, T_BOUND_BLUR = 3e-2, 1e-2, 0.01
T_BOUND_PIXELS = {"t0": (3, 4), "t1": (3, 6), "ndl1": (2, 5),
                  "ndl0": (2, 4)}


def t_bound_arrays():
    """One triangle in clip space (z 0.5, w 1) at whose pixel centres the
    soft renderer's clips meet their bounds, as numpy arrays (the
    arguments of `rasterize_clip_space_batch`, batch 1): NDC corners
    (0.125, 0.13), (0.625, 0.13), (0.125, 0.625) on an 8x8 image, world
    corners (0, 0, 0), (1, 0, 0), (0, 1, 0) with normals (0, 0, 1), seeded
    colours, a light at (0.3, 0.2, 4), one at (0.5, 0.495, 4) (above
    pixel T_BOUND_PIXELS["ndl1"]) and one at (2, 1, 0) (in the triangle's
    plane), intensities 1, and a seeded loss weight
    [1, 8, 8, 4] (`weights`) drawn after the colours."""
    rng = np.random.default_rng(0)
    corners = np.float32([[0.125, 0.13], [0.625, 0.13], [0.125, 0.625]])
    clip = np.concatenate([corners, np.full((3, 1), 0.5, np.float32),
                           np.ones((3, 1), np.float32)], axis=1)
    colors = rng.uniform(0.2, 1.0, (1, 3, 3)).astype(np.float32)
    weights = rng.uniform(-1.0, 1.0, (1, T_BOUND_SIZE, T_BOUND_SIZE, 4))
    return dict(
        clip=clip[None], triangles=np.int32([[0, 1, 2]]),
        world=np.float32([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]]),
        normals=np.float32([[[0, 0, 1]] * 3]), colors=colors,
        lights=np.float32([[[0.3, 0.2, 4.0], [0.5, 0.495, 4.0],
                             [2.0, 1.0, 0.0]]]),
        intensities=np.ones((1, 3), np.float32),
        weights=weights.astype(np.float32))


# The zero_edge scene's image and soft parameters.
ZERO_EDGE_SIZE = 12
ZERO_EDGE_SIGMA, ZERO_EDGE_GAMMA, ZERO_EDGE_BLUR = 3e-3, 1e-2, 0.01


def zero_edge_arrays():
    """A triangle and three degenerate ones in clip space (w 1, so the NDC
    corners are the clip corners exactly), as numpy arrays (the arguments
    of `rasterize_clip_space_batch`, batch 1, CCW): triangle (0, 1, 2)
    with NDC corners (-0.5, -0.5), (0.5, -0.5), (0, 0.6) at depths 0.2,
    0.4, 0.3; (0, 1, 3) with v3 = v1, whose edge 1-3 has length 0;
    (0, 4, 1) with v4 = (0, -0.5) on edge 0-1, collinear; and a duplicate
    of (0, 1, 2). Seeded world corners, normals and colours, two lights,
    their intensities and a seeded loss weight [1, 12, 12, 4]
    (`weights`)."""
    rng = np.random.default_rng(3)
    clip = np.float32([[-0.5, -0.5, 0.2, 1.0], [0.5, -0.5, 0.4, 1.0],
                       [0.0, 0.6, 0.3, 1.0], [0.5, -0.5, 0.4, 1.0],
                       [0.0, -0.5, 0.3, 1.0]])
    normals = rng.normal(size=(1, 5, 3)) + np.float32([0.0, 0.0, 2.0])
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    size = ZERO_EDGE_SIZE
    return dict(
        clip=clip[None], triangles=np.int32([[0, 1, 2], [0, 1, 3],
                                             [0, 4, 1], [0, 1, 2]]),
        world=rng.uniform(-1.0, 1.0, (1, 5, 3)).astype(np.float32),
        normals=normals.astype(np.float32),
        colors=rng.uniform(0.2, 1.0, (1, 5, 3)).astype(np.float32),
        lights=np.float32([[[0.5, 1.0, 3.0], [-1.0, 0.5, 2.0]]]),
        intensities=np.float32([[1.3, 0.7]]),
        weights=rng.uniform(-1.0, 1.0, (1, size, size, 4)).astype(
            np.float32))


def soft_scene(name, device):
    """A SoftScene by name: 'two_triangle' (tests/test_soft_pallas.py:20-41,
    16x16), 'cube' (64x48), 'random<L>' (the JAX suite's multi-tile scene
    with L lights, 48x40: L = 1 and 3 as there, 0 and 65 at the kernels'
    edges), 'empty_image' (random3 with its second image moved out of the
    frame), 'quad' (two triangles filling a 256x256 frame at four depths),
    'on_edges' (`on_edges_arrays`, at its own sigma, gamma and blur),
    'pose_tie' (bench.py's pose cube at angles 0 from (0, 0, 6) at 32x32,
    sigma 1e-4, blur 0.01: render_silhouette's camera and defaults),
    't_bound' (`t_bound_arrays`, at its own sigma, gamma and blur),
    'zero_edge' (`zero_edge_arrays`, at its own sigma, gamma and blur) or
    'sphere' (2 * 157^2 = 49,298 triangles, above the JAX package's
    per-pass cap of 49,152, at 64x64). Inputs come from seeded numpy
    generators."""
    from ..models import shapes
    from ..ops import soft_rasterize_cuda as sc

    f32 = dict(dtype=torch.float32, device=device)
    sigma, gamma, blur = SOFT_SIGMA, SOFT_GAMMA, SOFT_BLUR
    depth_matters, chunk = True, 64
    if name == "two_triangle":
        rng = np.random.RandomState(0)
        world = np.float32([[-0.6, -0.5, 0.1], [0.7, -0.4, -0.2],
                            [0.0, 0.8, 0.0], [0.9, 0.6, 0.4]])
        tris = np.int32([[0, 1, 2], [1, 3, 2]])
        normals = np.tile(np.float32([[0.0, 0.3, 1.0]]), [4, 1])
        normals /= np.linalg.norm(normals, axis=1, keepdims=True)
        colors = rng.uniform(0.2, 1.0, [4, 3])
        lights = np.float32([[0.5, 1.0, 3.0, 1.3], [-1.0, 0.5, 2.0, 0.7]])
        w = np.float32([1.0, 1.3, 0.9, 1.1])
        clip = np.concatenate([world * w[:, None], 0.25 * w[:, None],
                               w[:, None]], axis=1)
        clip, world, normals, colors, lights = (
            torch.tensor(a[None], **f32) for a in (clip, world, normals,
                                                   colors, lights))
        width = height = 16
        depth_matters = False  # every triangle at NDC z 0.25
    elif name == "quad":
        rng = np.random.RandomState(5)
        ndc = np.float32([[-1.05, -1.05], [1.05, -1.05], [1.05, 1.05],
                          [-1.05, 1.05]])
        z = np.float32([[0.1], [0.3], [0.2], [0.4]])
        w = np.float32([[1.0], [1.2], [0.9], [1.1]])
        tris = np.int32([[0, 1, 2], [0, 2, 3]])  # CCW
        world = np.concatenate([ndc, z], axis=1)
        normals = np.float32([0.0, 0.0, 1.0]) + rng.uniform(-0.3, 0.3,
                                                            [4, 3])
        normals /= np.linalg.norm(normals, axis=1, keepdims=True)
        colors = rng.uniform(0.2, 1.0, [4, 3])
        lights = np.float32([[0.5, 1.0, 3.0, 1.3], [-1.0, 0.5, 2.0, 0.7]])
        clip = np.concatenate([ndc * w, z * w, w], axis=1)
        clip, world, normals, colors, lights = (
            torch.tensor(a[None], **f32) for a in (clip, world, normals,
                                                   colors, lights))
        width = height = 256
        # At gamma 1e-2 one triangle per pixel puts the background weight
        # on its 1e-10 floor, so rgb equals shade to the last bits and
        # d/dgamma sums f32 rounding (K7's rgb and the plain version's
        # differ there); gamma 1 keeps it a real gradient.
        gamma = 1.0
    elif name == "on_edges":
        from ..ops import mesh

        arrays = on_edges_arrays()
        world, tris = torch.tensor(arrays["vertices"], **f32), torch.tensor(
            arrays["triangles"], device=device)
        normals = mesh.compute_vertex_normals(world, tris)
        colors = torch.tensor(arrays["diffuse"], **f32)
        lights = torch.tensor(np.concatenate([
            arrays["lights"], arrays["intensities"][..., None]], -1), **f32)
        width, height = ON_EDGES_SIZE
        clip = clip_from_eye(world, torch.tensor(arrays["eye"], **f32),
                             width, height)
        sigma, gamma, blur = ON_EDGES_SIGMA, ON_EDGES_GAMMA, ON_EDGES_BLUR
    elif name == "pose_tie":
        from ..ops import mesh

        v, tris, _ = shapes.cube(2.0)
        world = v[None].to(device)
        normals = mesh.compute_vertex_normals(world, tris.to(device))
        colors = torch.tensor(np.random.RandomState(7).uniform(
            0.2, 1.0, (1, 8, 3)), **f32)
        lights = torch.tensor([[[0.5, 1.0, 3.0, 1.3],
                                [-1.0, 0.5, 2.0, 0.7]]], **f32)
        width = height = 32
        clip = clip_from_eye(world, [0.0, 0.0, 6.0], width, height)
        sigma, blur = 1e-4, 0.01
    elif name == "t_bound":
        arrays = t_bound_arrays()
        clip, world, normals, colors = (
            torch.tensor(arrays[k], **f32)
            for k in ("clip", "world", "normals", "colors"))
        tris = arrays["triangles"]
        lights = torch.tensor(np.concatenate([
            arrays["lights"], arrays["intensities"][..., None]], -1), **f32)
        width = height = T_BOUND_SIZE
        sigma, gamma, blur = T_BOUND_SIGMA, T_BOUND_GAMMA, T_BOUND_BLUR
        # One triangle at one depth: the background weight sits on its
        # floor, so d/dgamma and the z columns are f32 noise.
        depth_matters = False
    elif name == "zero_edge":
        arrays = zero_edge_arrays()
        clip, world, normals, colors = (
            torch.tensor(arrays[k], **f32)
            for k in ("clip", "world", "normals", "colors"))
        tris = arrays["triangles"]
        lights = torch.tensor(np.concatenate([
            arrays["lights"], arrays["intensities"][..., None]], -1), **f32)
        width = height = ZERO_EDGE_SIZE
        sigma, gamma, blur = ZERO_EDGE_SIGMA, ZERO_EDGE_GAMMA, ZERO_EDGE_BLUR
        # A pixel sees triangle 0 and its duplicate, one shade at one
        # depth (the degenerate triangles are not kept): the plain route's
        # d/dgamma is -4.5e-3 in f32 and -1.6e-6 in f64, its z columns
        # 1.8e-5 and 1.0e-8, noise beside the clip columns' 2.5.
        depth_matters = False
    elif name == "sphere":
        v, tris, _ = shapes.sphere(1.0, resolution=157)
        world = v[None].to(device)
        normals, colors = world, torch.ones_like(world)
        width = height = 64
        clip = clip_from_eye(world, [0.0, 0.5, 3.0], width, height)
        lights = torch.tensor([[[0.0, 2.0, 4.0, 1.0]]], **f32)
        sigma, gamma, blur, chunk = 1e-4, 1e-3, 0.01, 512
    else:
        n_lights = (1 if name == "cube" else 3 if name == "empty_image"
                    else int(name[6:]))
        if name == "cube":
            batch = 1
            world = torch.tensor([[-1, -1, 1], [-1, -1, -1], [-1, 1, -1],
                                  [-1, 1, 1], [1, -1, 1], [1, -1, -1],
                                  [1, 1, -1], [1, 1, 1]], **f32)[None]
            tris = torch.tensor([[2, 1, 0], [0, 3, 2], [6, 2, 3], [3, 7, 6],
                                 [5, 6, 7], [7, 4, 5], [1, 5, 4], [4, 0, 1],
                                 [2, 6, 5], [5, 1, 2], [0, 4, 7], [7, 3, 0]])
            normals = world / torch.linalg.norm(world, dim=-1, keepdim=True)
            colors = world * 0.5 + 0.5
            eye, (width, height) = [2.0, 3.0, 6.0], (64, 48)
        elif name == "empty_image" or name[:6] == "random":
            rng = np.random.RandomState(n_lights)
            batch, width, height = 2, 48, 40
            world = torch.tensor(rng.randn(batch, 24, 3) * 0.5, **f32)
            tris = rng.randint(0, 24, (30, 3))
            normals = torch.tensor(rng.randn(batch, 24, 3), **f32)
            normals = normals / torch.linalg.norm(normals, dim=-1,
                                                  keepdim=True)
            colors = torch.tensor(rng.uniform(0.2, 1.0, (batch, 24, 3)),
                                  **f32)
            eye = [0.0, 0.0, 3.0]
            if name == "empty_image":
                world[1, :, 0] += 50.0  # out of the frame
        else:
            raise ValueError(f"unknown soft scene {name!r}")
        rng = np.random.RandomState(10 + n_lights)
        lights = torch.tensor(np.concatenate([
            rng.randn(batch, n_lights, 3) * 2.0,
            rng.uniform(0.5, 1.5, (batch, n_lights, 1))], -1), **f32)
        clip = clip_from_eye(world, eye, width, height)
    tris = torch.as_tensor(tris, dtype=torch.int32, device=device)
    table = sc.pack_triangle_data(clip, tris, world, normals, colors, blur)
    params = sc.make_params(sigma, gamma, blur, 0, device)
    return SoftScene(table, lights.contiguous(), params, width, height,
                     depth_matters, chunk)


def soft_cotangents(batch, height, width, device, seed=6):
    """A seeded [B, H, W, 4] cotangent with nonzero rgb and alpha parts."""
    rng = np.random.RandomState(seed)
    return torch.tensor(rng.randn(batch, height, width, 4),
                        dtype=torch.float32, device=device)


def grad_errors(label, kernel, plain, rtol, groups=None):
    """[(label, max abs error, max |plain|)] of a backward kernel's tensor
    against its plain version's, one entry per column group (`groups`,
    e.g. SOFT_DTABLE_GROUPS) or one for the whole tensor. Raises
    AssertionError if the tensor is not finite or an error exceeds rtol x
    the plain part's max |value|."""
    if kernel.shape != plain.shape:
        raise AssertionError(f"{label}: shape {tuple(kernel.shape)} vs "
                             f"{tuple(plain.shape)}")
    if not bool(torch.isfinite(kernel).all()):
        raise AssertionError(f"{label} is not finite")
    parts = ([(f"{label} {name}", kernel[..., cols], plain[..., cols])
              for name, cols in groups] if groups else
             [(label, kernel, plain)])
    out = []
    for part, k, p in parts:
        err = float((k - p).abs().max()) if p.numel() else 0.0
        scale = float(p.abs().max()) if p.numel() else 0.0
        if not err <= rtol * scale:
            raise AssertionError(f"{part}: max abs {err} > {rtol} x {scale}")
        out.append((part, err, scale))
    return out


def soft_splits(kernel):
    """0 (the compiled split) and each split of a pixel block that
    utils/soft_work.py tries for `kernel` (a key of its SPLITS)."""
    from . import soft_work

    return (0,) + soft_work.SPLITS[kernel]


def hard_splits():
    """0 (K1's compiled split) and each split of a pixel block that
    utils/hard_work.py tries."""
    from . import hard_work

    return (0,) + hard_work.SPLITS


def bary_shapes():
    """(0, 0) (K3's launcher rule) and each (group, split) of its cluster
    that utils/hard_work.py tries."""
    from . import hard_work

    return ((0, 0),) + tuple((group, split) for group in hard_work.GROUPS
                             for split in hard_work.SPLITS)


def _split(split):
    """A launcher's split keyword: none for 0, the kernel's own."""
    return {"split": split} if split else {}


def same_bits(a, b):
    """Equal shapes and bits (-0.0 and 0.0 differ)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def compare_k1_splits(table, corner, width, height, row_offset=0,
                      full_height=None, splits=(0,), bary=((0, 0),)):
    """K1 on packed tables (CUDA tensors) at each of `splits` (clusters of
    CTAs per group of pixel blocks; 0 is its compiled one): every split
    must give the first's (ids, bc, attributes, z) bit for bit, and K3 at
    each (group, split) of `bary` ((0, 0) is its launcher's rule) must give
    K1's ids, bc and z bit for bit: one cluster body, with and without
    attributes. Raises AssertionError otherwise; returns K1's outputs at
    splits[0]."""
    from ..ops import rasterize_barycentric_cuda as rb
    from ..ops import rasterize_cuda as rc

    full_height = full_height or height
    k1 = rc.launch_fused_fwd(table, corner, width, height, row_offset,
                             full_height, True, **_split(splits[0]))
    for split in splits[1:]:
        other = rc.launch_fused_fwd(table, corner, width, height, row_offset,
                                    full_height, True, **_split(split))
        if not all(same_bits(a, b) for a, b in zip(other, k1)):
            raise AssertionError(f"rasterize_fused_fwd at split {split} "
                                 f"differs from split {splits[0]}")
    for group, split in bary:
        k3 = rb.launch_bary_fwd(table, width, height, row_offset,
                                full_height, group, split)
        if not all(same_bits(a, b) for a, b in zip(k3, (k1[0], k1[1],
                                                         k1[3]))):
            raise AssertionError(
                "rasterize_fused_fwd's ids, bc or z differ from "
                f"rasterize_bary_fwd's at group {group}, split {split}")
    return k1


def ties_scene(seed=3, batch=2, tri_count=160, width=40, height=36):
    """Small triangles with their own corners on pixel centres, each at one
    depth of {0.5, 0.25, 0.0, -0.0, -0.5} (w = 1), so that many pixels
    see equal z from several triangles: exact ties, +0.0 against -0.0 too.
    The image is not a whole number of 16x16 blocks. Returns numpy arrays
    (clip [B, 3T, 4], triangles [T, 3] i32, attributes [B, 3T, 4]) and
    width, height."""
    f32 = np.float32
    rng = np.random.RandomState(seed)
    first = np.stack([rng.randint(0, width, (batch, tri_count)),
                      rng.randint(0, height, (batch, tri_count))], -1)
    corners = first[:, :, None, :] + rng.randint(-7, 8, (batch, tri_count,
                                                        3, 2))
    corners[:, :, 0] = first
    scale = np.array([f32(2.0 / width), f32(2.0 / height)], f32)
    ndc = ((corners + 0.5) * scale - 1.0).astype(f32)
    depth = np.array([0.5, 0.25, 0.0, -0.0, -0.5], f32)[
        rng.randint(0, 5, (batch, tri_count))]
    clip = np.concatenate([
        ndc, np.broadcast_to(depth[:, :, None, None], ndc.shape[:3] + (1,)),
        np.ones(ndc.shape[:3] + (1,), f32)], -1)
    clip = clip.reshape(batch, 3 * tri_count, 4)
    tris = np.arange(3 * tri_count, dtype=np.int32).reshape(tri_count, 3)
    attrs = rng.randn(batch, 3 * tri_count, 4).astype(f32)
    return clip, tris, attrs, width, height


def compare_soft_forward(scene, row_offset=0, full_height=None, splits=(0,),
                         sil_splits=(0,)):
    """K7 and K5 against the plain forward on one scene (CUDA tensors).

    Rows [row_offset, row_offset + scene.height) of a full_height-row image.
    K7 runs at each of `splits` and K5 at each of `sil_splits` (clusters of
    CTAs per pixel block; 0 is a kernel's compiled one), and every split
    must give the first's outputs bit for bit. Raises AssertionError past a
    gate or if K5's alpha at any split differs from K7's in any bit.
    Returns ((rgba, run_max, sum_w) of K7 at splits[0], alpha of K5 at
    sil_splits[0], errors): errors maps a kernel name to [(label, max abs
    error, max |plain|)].
    """
    from ..ops import soft_rasterize_cuda as sc

    table, lights, params, width, height = scene[:5]
    full_height = full_height or height
    k7 = sc.launch_soft_fwd(table, lights, params, width, height,
                            full_height, **_split(splits[0]))
    for split in splits[1:]:
        other = sc.launch_soft_fwd(table, lights, params, width, height,
                                   full_height, **_split(split))
        if not all(torch.equal(a, b) for a, b in zip(other, k7)):
            raise AssertionError(f"soft_fwd at split {split} differs from "
                                 f"split {splits[0]}")
    alphas = [sc.launch_sil_fwd(table, params, width, height, full_height,
                                **_split(split)) for split in sil_splits]
    alpha = alphas[0]
    rgb, plain_alpha, _, _ = sc.soft_forward_torch_packed(
        table, lights, params[0], params[1], params[2], height, width,
        row_offset, full_height, False, scene.triangle_chunk)
    torch.cuda.synchronize()
    rgba = k7[0]

    def error(k, p):
        return ((float((k - p).abs().max()), float(p.abs().max()))
                if p.numel() else (0.0, 0.0))

    rgb_err, alpha_err = error(rgba[..., :3], rgb), error(rgba[..., 3],
                                                          plain_alpha)
    if rgb.numel() and not bool(((rgba[..., :3] - rgb).abs() <= SOFT_RGB_ATOL
                                 + SOFT_RGB_RTOL * rgb.abs()).all()):
        raise AssertionError(f"soft_fwd rgb max abs {rgb_err[0]} beyond "
                             f"{SOFT_RGB_ATOL} + {SOFT_RGB_RTOL} x |rgb|")
    if not alpha_err[0] <= SOFT_ALPHA_ATOL:
        raise AssertionError(f"soft_fwd alpha max abs {alpha_err[0]} > "
                             f"{SOFT_ALPHA_ATOL}")
    for split, other in zip(sil_splits, alphas):
        if not torch.equal(other, rgba[..., 3]):
            raise AssertionError(f"soft_sil_fwd alpha at split {split} "
                                 "differs from soft_fwd alpha")
    errors = {"soft_fwd": [("rgb", *rgb_err), ("alpha", *alpha_err)],
              "soft_sil_fwd": [("alpha", *error(alpha, plain_alpha))]}
    return k7, alpha, errors


def compare_soft_backward(scene, k7, alpha, d_rgba, row_offset=0,
                          full_height=None, sil_splits=(0,)):
    """K8 and K6 against the plain backward on one scene, under the
    cotangent d_rgba [B, H, W, 4] (K6 takes its alpha part); k7 and alpha
    are compare_soft_forward's. K6 runs at each of `sil_splits` (CTAs per
    pixel block; 0 is its compiled one). Every tensor is gated within
    SOFT_GRAD_RTOL of its max |value| (d/dgamma within SOFT_DGAMMA_RTOL),
    the table gradients per SOFT_DTABLE_GROUPS group. Returns (dtable of
    K8, dtable of K6 at sil_splits[0], errors) with errors as
    compare_soft_forward's."""
    from ..ops import soft_rasterize_cuda as sc

    table, lights, params, width, height = scene[:5]
    full_height = full_height or height
    d_alpha = d_rgba[..., 3].contiguous()
    dtable, dlights, dparams = sc.launch_soft_bwd(table, lights, params,
                                                  *k7, d_rgba, full_height)
    sil_grads = [sc.launch_sil_bwd(table, params, alpha, d_alpha,
                                   full_height, **_split(split))
                 for split in sil_splits]
    plain = sc.soft_backward_torch_packed(
        table, lights, params[0], params[1], params[2], height, width,
        row_offset, full_height, d_rgba, scene.triangle_chunk)
    plain_sil = sc.soft_silhouette_backward_torch_packed(
        table, params[0], params[2], height, width, row_offset, full_height,
        d_alpha, scene.triangle_chunk)
    torch.cuda.synchronize()
    groups = SOFT_DTABLE_GROUPS
    if not scene.depth_matters:
        groups = [(label, [c for c in cols if c not in SOFT_Z_COLUMNS]
                   if label == "clip" else cols) for label, cols in groups]
    rtol = SOFT_GRAD_RTOL
    bwd = (grad_errors("dtable", dtable, plain[0], rtol, groups)
           + grad_errors("dlights", dlights, plain[1], rtol)
           + grad_errors("dsigma", dparams[:, 0].sum(), plain[2], rtol))
    if scene.depth_matters:
        bwd += grad_errors("dgamma", dparams[:, 1].sum(), plain[3],
                           SOFT_DGAMMA_RTOL)
    sil = []
    for split, (sil_dtable, sil_dsigma) in zip(sil_splits, sil_grads):
        label = f" split {split}" if len(sil_splits) > 1 else ""
        sil += (grad_errors("dtable" + label, sil_dtable, plain_sil[0], rtol,
                            SOFT_DTABLE_GROUPS)
                + grad_errors("dsigma" + label, sil_dsigma.sum(),
                              plain_sil[1], rtol))
    return dtable, sil_grads[0][0], {"soft_bwd": bwd, "soft_sil_bwd": sil}


# The hard renderer's diffuse shading (`ops/shading.phong_shade_cuda`, its
# backward `phong_diffuse_backward_torch`) against autograd through the
# plain ops. "random": A = 12 columns (three beyond the shaded nine) and a
# background row; "ties": axis-aligned normals at the origin under lights
# on the axes, so n.l is exactly 0 or exactly 1 (clip's 1/2 derivative);
# "zero_normals": normals of length 0 and 1e-14 (below normalize's eps),
# on covered and background pixels.
SHADING_SCENES = ("random", "ties", "zero_normals")
SHADING_AXIS_LIGHTS = ((0.0, 0.0, 2.0), (3.0, 0.0, 0.0), (0.0, -4.0, 0.0))
# Images: the kernel repeats the plain ops' operations in their order.
SHADING_IMAGE_ATOL = 1e-6
# Gradients: per pixel, of the plain gradient's largest |value| there
# (a pixel with a normal below eps has gradients of ~1e12).
SHADING_GRAD_RTOL = 1e-5


def shading_scene(name, lights, ambient, device, batch=2, height=12,
                  width=10):
    """(pixel_attributes [B, H, W, A], light_positions [B, L, 3],
    light_intensities [B, L, 3], ambient_color [B, 3] or None) of one of
    SHADING_SCENES, seeded."""
    rng = np.random.RandomState(SHADING_SCENES.index(name))
    n_attr = 12 if name == "random" else 9
    x = rng.randn(batch, height, width, n_attr)
    x[:, 0] = -1.0  # a background row, as the rasterizer composites it
    light_pos = rng.randn(batch, lights, 3) * 3.0
    if name == "ties":
        covered = (batch, height - 1, width)
        pick = rng.randint(0, 6, covered)  # +x, -x, +y, -y, +z, -z
        length = rng.choice([0.5, 1.0, 2.0, 3.0], covered)  # exact norms
        x[:, 1:, :, 0:3] = np.eye(3)[pick // 2] * (
            np.where(pick % 2, -1.0, 1.0) * length)[..., None]
        x[:, 1:, :, 3:6] = 0.0
        x[:, 1:, :, 6:9] = np.abs(x[:, 1:, :, 6:9])
        light_pos = np.tile(np.array(SHADING_AXIS_LIGHTS[:lights]),
                            [batch, 1, 1])
    elif name == "zero_normals":
        x[:, :, ::3, 0:3] = 0.0
        x[:, :, 1::3, 0:3] *= 1e-14
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.tensor(x, **f32), torch.tensor(light_pos, **f32),
            torch.tensor(rng.uniform(0.2, 1.5, (batch, lights, 3)), **f32),
            torch.tensor(rng.uniform(0.0, 0.3, (batch, 3)), **f32)
            if ambient else None)


def shading_gradient_gap(got, want):
    """The largest gap of `got` from `want` ([..., A] attribute gradients)
    per pixel, over the largest |want| at that pixel. Raises
    AssertionError unless both are NaN at the same places."""
    nan = torch.isnan(want)
    if not torch.equal(torch.isnan(got), nan):
        raise AssertionError("the gradients are NaN at different places")
    got, want = torch.nan_to_num(got), torch.nan_to_num(want)
    scale = want.abs().amax(-1, keepdim=True).clamp(min=1e-30)
    return float(((got - want).abs() / scale).max())
