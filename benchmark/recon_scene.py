"""The generator of the reconstruction cells' inputs: the template sphere,
the data set of RGBA renders, the viewpoints, the network's weights and
the loader's draws, all from the configuration and the seed.

The data set stands in for ShapeNet's renders (which the benchmark cannot
download): the teapot, the cube and an icosphere, each object with a
random anisotropic scale, rotation and radial bumps drawn from the seed,
moved into [-0.5, 0.5]^3 as ShapeNet's objects are, and rendered by the
plain hard renderer (`reference/hard.py`, one light at the camera) from
the configuration's viewpoints into RGBA uint8, rows top-down.

Everything here is the benchmark's own: the icosphere, the viewpoints and
the weights are written out again, so that the program and the reference
receive the same tensors and neither takes anything the other made.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from . import scene
from .reference import hard, soft

RENDER_CHUNK = 768  # images a call of the hard reference renders


def icosphere(level):
    """(vertices [V, 3] f32, faces [T, 3] int64, CCW from outside): the
    icosahedron split `level` times, midpoints on the unit sphere, its
    twelve vertices first, then each level's midpoints in the order their
    edges are met (the port's `shapes.icosphere` order)."""
    phi = (1.0 + 5.0 ** 0.5) / 2.0
    v = [np.asarray(p, np.float64) for p in (
        [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
        [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
        [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1])]
    v = [p / np.linalg.norm(p) for p in v]
    faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
             (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
             (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
             (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    for _ in range(level):
        mids = {}

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in mids:
                m = (v[a] + v[b]) / 2
                v.append(m / np.linalg.norm(m))
                mids[key] = len(v) - 1
            return mids[key]

        finer = []
        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            finer += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = finer
    return (torch.as_tensor(np.asarray(v, np.float32)),
            torch.as_tensor(np.asarray(faces, np.int64)))


def viewpoints(scene_cfg, device):
    """[views, 3] camera positions: view k at the configuration's distance
    and elevation, azimuth -k times its step (SoftRas's
    get_points_from_angles)."""
    d, el = scene_cfg["distance"], math.radians(scene_cfg["elevation"])
    out = []
    for k in range(scene_cfg["views"]):
        az = math.radians(-k * scene_cfg["azimuth_step"])
        out.append([d * math.cos(el) * math.sin(az), d * math.sin(el),
                    -d * math.cos(el) * math.cos(az)])
    return torch.tensor(out, dtype=torch.float32, device=device)


def _cube():
    v = np.array([[-1, -1, 1], [-1, -1, -1], [-1, 1, -1], [-1, 1, 1],
                  [1, -1, 1], [1, -1, -1], [1, 1, -1], [1, 1, 1]],
                 np.float32)
    t = np.array([[2, 1, 0], [0, 3, 2], [6, 2, 3], [3, 7, 6], [5, 6, 7],
                  [7, 4, 5], [1, 5, 4], [4, 0, 1], [2, 6, 5], [5, 1, 2],
                  [0, 4, 7], [7, 3, 0]], np.int64)
    return torch.as_tensor(v), torch.as_tensor(t)


def base_meshes(dataset):
    """[(vertices [V, 3], faces [T, 3] CCW)] of the data set's kinds."""
    out = []
    for kind in dataset["meshes"]:
        if kind == "cube":
            out.append(_cube())
        elif kind.startswith("icosphere"):
            out.append(icosphere(int(kind.split("_")[1])))
        else:
            v, t, _ = scene.read_obj(scene.data_path(kind))
            out.append((torch.as_tensor(v), torch.as_tensor(t)))
    return out


def _rotations(g, n, device):
    """[n, 3, 3] rotations from unit quaternions, uniform over SO(3)."""
    q = torch.randn(n, 4, generator=g, device=device)
    q = q / q.norm(dim=1, keepdim=True)
    w, x, y, z = q.unbind(1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], 1)


def shaped_objects(base, count, g, dataset, device):
    """[count, V, 3]: `base` bumped, scaled, turned and normalised."""
    v = base.to(device)
    v = v - (v.amax(0) + v.amin(0)) / 2
    u = v / v.norm(dim=1, keepdim=True).clamp(min=1e-12)
    bumps = dataset["bumps"]
    f32 = dict(device=device, dtype=torch.float32)
    dirs = torch.randn(count, bumps, 3, generator=g, **f32)
    dirs = dirs / dirs.norm(dim=2, keepdim=True)
    lo, hi = dataset["bump_amplitude"]
    amp = lo + (hi - lo) * torch.rand(count, bumps, 1, generator=g, **f32)
    lo, hi = dataset["bump_width"]
    width = lo + (hi - lo) * torch.rand(count, bumps, 1, generator=g, **f32)
    cosine = torch.einsum("nbk,vk->nbv", dirs, u)
    radial = 1 + (amp * torch.exp((cosine - 1) / width)).sum(1)
    lo, hi = dataset["scale"]
    scale = lo + (hi - lo) * torch.rand(count, 1, 3, generator=g, **f32)
    out = (v[None] * radial[..., None] * scale) @ _rotations(
        g, count, device).transpose(1, 2)
    centre = (out.amax(1, keepdim=True) + out.amin(1, keepdim=True)) / 2
    extent = (out.amax(1) - out.amin(1)).amax(1)
    return (out - centre) / extent[:, None, None]


@contextlib.contextmanager
def _deterministic():
    """PyTorch's deterministic algorithms for the block: on a card,
    `index_add` (the reference's vertex normals) otherwise sums in the
    order its atomic adds land, which moves a normal's last bits, and so a
    few of the data set's uint8 values, from one process to the next."""
    enabled = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(enabled, warn_only=warn_only)


def render_dataset(config, seed, device):
    """[N, views, 4, S, S] uint8 RGBA of the data set's N objects, on
    `device`: object i is of kind i mod (number of kinds). The same seed
    gives the same bytes in every process."""
    sc, ds = config["scene"], config["dataset"]
    size, n = sc["image_size"], ds["objects"]
    g = scene.generator(seed, device)
    eyes = viewpoints(sc, device)
    views = eyes.shape[0]
    out = torch.empty(n, views, size, size, 4, dtype=torch.uint8,
                      device=device)
    kinds = base_meshes(ds)
    f32 = dict(device=device, dtype=torch.float32)
    for k, (base, faces) in enumerate(kinds):
        which = torch.arange(k, n, len(kinds), device=device)
        objects = shaped_objects(base, which.numel(), g, ds, device)
        colours = 0.3 + 0.7 * torch.rand(which.numel(), 1, 3, generator=g,
                                         **f32)
        faces = faces.to(device)
        with _deterministic():
            normals = soft.vertex_normals(objects, faces)
        per = max(1, RENDER_CHUNK // views)
        for start in range(0, which.numel(), per):
            sel = slice(start, start + per)
            m = objects[sel].shape[0]

            def flat(x):
                return x[:, None].expand(m, views, *x.shape[1:]).reshape(
                    m * views, *x.shape[1:])

            cam = eyes.repeat(m, 1)
            with torch.no_grad():
                rgba = hard.render(
                    flat(objects[sel]), faces.flip(1), flat(normals[sel]),
                    flat(colours[sel].expand(-1, base.shape[0], 3)), cam,
                    torch.zeros_like(cam),
                    torch.tensor([0.0, 1.0, 0.0], **f32).expand_as(cam),
                    cam[:, None], torch.ones(m * views, 1, 3, **f32), size,
                    sc["fov_y"], sc["near_clip"], sc["far_clip"])
            out[which[sel]] = (rgba.clamp(0, 1) * 255).round().to(
                torch.uint8).reshape(m, views, size, size, 4)
    return out.permute(0, 1, 4, 2, 3).contiguous()


def weights(network, template_count, image_size, seed, device):
    """{name: tensor}: the network's parameters as PyTorch initialises
    them (each weight and bias of a layer uniform in +-1/sqrt(fan_in),
    BatchNorm's scale 1 and shift 0), drawn from the seed. Names as the
    port's module names them."""
    enc, dec = network["encoder"], network["decoder"]
    g = scene.generator(seed + 1, device)
    c = [enc["dim_in"], enc["dim1"], 2 * enc["dim1"], 4 * enc["dim1"]]
    k = enc["kernel"]
    cells = math.ceil(image_size / 8) ** 2
    layers = {}
    for i in range(3):
        layers[f"encoder.conv{i + 1}"] = ((c[i + 1], c[i], k, k), c[i] * k * k)
    widths = [c[3] * cells, enc["dim2"], enc["dim2"], enc["dim_out"]]
    for i in range(3):
        layers[f"encoder.fc{i + 1}"] = ((widths[i + 1], widths[i]), widths[i])
    h = [dec["dim_in"]] + list(dec["dim_hidden"])
    layers["decoder.fc1"] = ((h[1], h[0]), h[0])
    layers["decoder.fc2"] = ((h[2], h[1]), h[1])
    layers["decoder.fc_centroid"] = ((3, h[2]), h[2])
    layers["decoder.fc_bias"] = ((3 * template_count, h[2]), h[2])
    out = {}
    f32 = dict(device=device, dtype=torch.float32)
    for name, (shape, fan_in) in layers.items():
        bound = 1.0 / math.sqrt(fan_in)
        for part, s in (("weight", shape), ("bias", shape[:1])):
            out[f"{name}.{part}"] = (torch.rand(s, generator=g, **f32) * 2
                                     - 1) * bound
    for i in range(3):
        out[f"encoder.bn{i + 1}.weight"] = torch.ones(c[i + 1], **f32)
        out[f"encoder.bn{i + 1}.bias"] = torch.zeros(c[i + 1], **f32)
    return out


def draws(objects, views, batch, seed, count):
    """The loader's first `count` draws by its rule (a CPU generator seeded
    with the loader's seed: randint(objects, [batch]), then randint(views,
    [batch, 2])): [(object ids [batch], view ids [batch, 2])]."""
    g = torch.Generator()
    g.manual_seed(int(seed))
    out = []
    for _ in range(count):
        ids = torch.randint(objects, (batch,), generator=g)
        out.append((ids, torch.randint(views, (batch, 2), generator=g)))
    return out


def gather_batch(images, eyes, ids, views, device):
    """The batch of the draw (ids, views) as the port's loader hands it:
    {"images": [2 B, 4, S, S] uint8, "eyes": [2 B, 3]}, viewpoint a's
    first."""
    v = views.T.reshape(-1).to(images.device)
    i = ids.repeat(2).to(images.device)
    return {"images": images[i, v].to(device),
            "eyes": eyes.to(device)[v.to(device)]}
