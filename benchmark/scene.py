"""The general generator: a cell's inputs from its configuration, its
traffic mix and the seed.

Everything here is the benchmark's own: the OBJ parser, the PNG decoder
and the UV sphere are written out again, so that the program under test
and the reference receive the same generated tensors and neither takes
anything the other made. The random draws come from one `torch.Generator`
on the run's device, seeded with `--seed`, in a few large calls.
"""

from __future__ import annotations

import math
import os
import struct
import zlib

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def data_path(name):
    """A path of the configuration files, relative to the benchmark."""
    return os.path.join(HERE, name)


def read_obj(path, normalize=True):
    """(vertices [V, 3] f32, faces [T, 3] int64 as written, normals [V, 3]
    f32) of a Wavefront file's v / vn / f records. A vertex's normal is the
    mean of the `vn` its face corners name, normalised; with `normalize`
    the vertices are moved into the +-1 cube as the mesh renderers' loaders
    do (shift to positive, scale by the largest value, double, centre)."""
    vertices, normals, faces, face_normals = [], [], [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                vertices.append([float(v) for v in parts[1:4]])
            elif parts[0] == "vn":
                normals.append([float(v) for v in parts[1:4]])
            elif parts[0] == "f":
                corners = [c.split("/") for c in parts[1:4]]
                faces.append([int(c[0]) - 1 for c in corners])
                face_normals.append([int(c[2]) - 1 if len(c) > 2 and c[2]
                                     else -1 for c in corners])
    v = np.asarray(vertices, np.float32)
    t = np.asarray(faces, np.int64)
    fn = np.asarray(face_normals, np.int64)
    vn = np.asarray(normals, np.float32).reshape(-1, 3)
    acc = np.zeros_like(v)
    count = np.zeros([len(v)], np.float32)
    has = fn >= 0
    np.add.at(acc, t[has], vn[fn[has]])
    np.add.at(count, t[has], 1.0)
    n = np.where(count[:, None] > 0, acc / np.maximum(count[:, None], 1.0),
                 1.0)
    n = n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)
    if normalize:
        v -= v.min(0)[None, :]
        v /= np.abs(v).max()
        v *= 2
        v -= v.max(0)[None, :] / 2
    return v, t, n.astype(np.float32)


def uv_sphere(radius, resolution):
    """(vertices [K^2 + 2, 3] f32, faces [T, 3] int64 CCW from outside) of
    the examples' UV sphere: K rings of K vertices at radius `radius`, the
    two pole vertices at y = +-1 whatever the radius, and a seam that does
    not wrap (as the examples' sphere)."""
    k = resolution
    thetas = np.linspace(np.pi / (k + 1), np.pi - np.pi / (k + 1), k)
    phis = np.linspace(0.0, 2.0 * np.pi, k, endpoint=False)
    tt, pp = np.meshgrid(thetas, phis, indexing="ij")
    v = np.zeros([k * k + 2, 3], np.float32)
    v[:k * k, 0] = (radius * np.sin(tt) * np.sin(pp)).reshape(-1)
    v[:k * k, 1] = (radius * np.cos(tt)).reshape(-1)
    v[:k * k, 2] = (radius * np.sin(tt) * np.cos(pp)).reshape(-1)
    v[k * k] = [0.0, 1.0, 0.0]
    v[k * k + 1] = [0.0, -1.0, 0.0]
    ii, jj = np.meshgrid(np.arange(k - 1), np.arange(k), indexing="ij")
    tl = (ii * k + jj).reshape(-1)
    tr = (ii * k + jj + 1).reshape(-1)
    bl = ((ii + 1) * k + jj).reshape(-1)
    br = ((ii + 1) * k + jj + 1).reshape(-1)
    quads = np.stack([np.stack([tl, bl, tr], -1),
                      np.stack([tr, bl, br], -1)], 1).reshape(-1, 3)
    i = np.arange(k)
    top = np.stack([np.full(k, k * k), i, i + 1], -1)
    bottom = np.stack([np.full(k, k * k + 1), (k - 1) * k + i + 1,
                       (k - 1) * k + i], -1)
    return v, np.concatenate([quads, top, bottom]).astype(np.int64)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def read_png(path):
    """[H, W, C] uint8 of an 8-bit non-interlaced gray, gray+alpha, RGB or
    RGBA PNG."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path} is not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    width, height, depth, color, _, _, interlace = header
    channels = {0: 1, 2: 3, 4: 2, 6: 4}.get(color)
    if depth != 8 or channels is None or interlace:
        raise ValueError(f"{path}: only 8-bit non-interlaced PNGs are read")
    raw = zlib.decompress(b"".join(idat))
    stride = width * channels
    out = bytearray(height * stride)
    prev = bytearray(stride)
    for y in range(height):
        kind = raw[y * (stride + 1)]
        line = bytearray(raw[y * (stride + 1) + 1:(y + 1) * (stride + 1)])
        for x in range(stride):
            a = line[x - channels] if x >= channels else 0
            b = prev[x]
            c = prev[x - channels] if x >= channels else 0
            add = (0, a, b, (a + b) // 2, _paeth(a, b, c))[kind]
            line[x] = (line[x] + add) & 0xFF
        out[y * stride:(y + 1) * stride] = line
        prev = line
    return np.frombuffer(bytes(out), np.uint8).reshape(height, width,
                                                       channels)


def yaw_matrices(yaws):
    """[N, 3, 3] rotations about y by `yaws` [N] (x toward -z for a positive
    angle), the Euler rotation (0, yaw, 0) of the renderers' camera
    module."""
    c, s = torch.cos(yaws), torch.sin(yaws)
    zero, one = torch.zeros_like(yaws), torch.ones_like(yaws)
    return torch.stack([torch.stack([c, zero, s], -1),
                        torch.stack([zero, one, zero], -1),
                        torch.stack([-s, zero, c], -1)], -2)


def spread_yaws(generator, count, device):
    """[count] yaws 2 pi (k + u) / count, u uniform in [0, 1) from the
    seed: each yaw is uniform over [0, 2 pi), and every seed turns the
    mesh through the same spread of sides."""
    u = torch.rand((), generator=generator, device=device,
                   dtype=torch.float64)
    k = torch.arange(count, device=device, dtype=torch.float64)
    return (2.0 * math.pi * (k + u) / count).to(torch.float32)


def generator(seed, device):
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def teapot_views(config, views, seed, device, batches=1):
    """The teapot scene of `views` views a batch, `batches` batches, on
    `device`: a dict of vertices and normals [batches, views, V, 3] (the
    mesh turned by each view's yaw), faces CCW and CW [T, 3] int32, and
    per-view camera, lights and colours."""
    scene = config["scene"]
    mesh = scene["mesh"]
    if mesh["kind"] == "obj":
        v, t, n = read_obj(data_path(mesh["file"]), mesh.get("normalize",
                                                             True))
    else:  # a small stand-in mesh, for tests
        v, t = uv_sphere(mesh["radius"], mesh["resolution"])
        n = v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-12)
    f32 = dict(dtype=torch.float32, device=device)
    g = generator(seed, device)
    yaws = spread_yaws(g, views * batches, device)
    order = torch.arange(views * batches, device=device)
    # Batch b takes views b, b + batches, ...: each batch spans the circle.
    order = order.reshape(views, batches).T.reshape(-1)
    rot = yaw_matrices(yaws[order])  # [batches * views, 3, 3]
    v_t = torch.as_tensor(v, **f32)
    n_t = torch.as_tensor(n, **f32)
    vertices = torch.einsum("bij,vj->bvi", rot, v_t)
    normals = torch.einsum("bij,vj->bvi", rot, n_t)
    shape = (batches, views) + tuple(v_t.shape)
    lights = torch.tensor(scene["lights"], **f32)
    n_lights = lights.shape[0]
    faces = torch.as_tensor(t, dtype=torch.int32, device=device)

    def per_view(value):
        return torch.tensor(value, **f32).expand(views, -1).contiguous()

    return {
        "vertices": vertices.reshape(shape).contiguous(),
        "normals": normals.reshape(shape).contiguous(),
        "faces_ccw": faces.contiguous(),
        "faces_cw": faces.flip(1).contiguous(),
        "diffuse": torch.tensor(scene["diffuse"], **f32).expand(
            views, v_t.shape[0], 3).contiguous(),
        "eye": per_view(scene["eye"]),
        "center": per_view(scene["center"]),
        "up": per_view(scene["up"]),
        "lights": lights.expand(views, n_lights, 3).contiguous(),
        "intensities_rgb": torch.full((views, n_lights, 3),
                                      scene["light_intensity"], **f32),
        "intensities": torch.full((views, n_lights),
                                  scene["light_intensity"], **f32),
    }


def targets(config, size, device):
    """[views, size, size] f32 silhouettes in [0, 1]: each file's alpha (or
    mean of its channels) resized by nearest neighbour."""
    out = []
    for name in config["scene"]["targets"]:
        img = read_png(data_path(name)).astype(np.float32) / 255.0
        alpha = img[..., 3] if img.shape[-1] == 4 else img.mean(-1)
        ys = np.arange(size) * alpha.shape[0] // size
        xs = np.arange(size) * alpha.shape[1] // size
        out.append(alpha[ys][:, xs])
    return torch.as_tensor(np.stack(out), device=device)


def fit_problem(config, traffic, seed, device):
    """The multi-view fit's inputs on `device`: the sphere's vertices
    [V, 3] and faces [T, 3] int32 (CCW), the ring of cameras (eye, center,
    up [views, 3]), the target silhouettes [views, S, S] and the start
    offsets [V, 3] drawn from the seed."""
    scene = config["scene"]
    mesh = scene["mesh"]
    v, t = uv_sphere(mesh["radius"], mesh["resolution"])
    ring = scene["ring"]
    views = ring["views"]
    phis = np.linspace(0.0, 2 * np.pi, views, endpoint=False)
    eyes = np.stack([ring["radius"] * np.sin(phis),
                     ring["height"] * np.ones(views),
                     ring["radius"] * np.cos(phis)], -1).astype(np.float32)
    f32 = dict(dtype=torch.float32, device=device)
    g = generator(seed, device)
    offsets = traffic["offset_noise_std"] * torch.randn(
        v.shape, generator=g, **f32)
    return {
        "vertices": torch.as_tensor(v, **f32),
        "faces": torch.as_tensor(t, dtype=torch.int32, device=device),
        "eye": torch.as_tensor(eyes, **f32),
        "center": torch.zeros(views, 3, **f32),
        "up": torch.tensor(scene["up"], **f32).expand(views, 3).contiguous(),
        "targets": targets(config, scene["image_size"], device),
        "offsets": offsets,
    }
