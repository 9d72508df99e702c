"""Single-view mesh reconstruction trained through the soft silhouette
renderer: SoftRas's `examples/recon` (Liu et al. 2019, "Soft Rasterizer",
ICCV, section 5.1; `examples/recon/models.py` and `train.py`) on the
port's normal path.

An encoder reads a 4x64x64 RGBA image into 512 features; a decoder turns
them into a deformation of a template sphere. A training step takes B
objects, each seen from two viewpoints a and b, encodes both images of
each object (2B meshes) and renders each mesh from both viewpoints with
`soft_mesh_renderer.render_silhouette`, in the order mesh_a at a, mesh_b
at a, mesh_a at b, mesh_b at b (4B silhouettes, on a card through K5 and
K6). The loss is the mean of the four groups' IoU losses against the
alpha of their viewpoint's image, plus the squared Laplacian and the
flatten loss of the 2B meshes (`ops/losses.py`); Adam updates the
network. `Reconstruction` builds that step with
`parallel.make_train_step`: on a card its first call runs eagerly and
captures the step, with cuDNN's convolutions, BatchNorm's updates of its
running statistics and Adam, into a CUDA graph that later calls replay.
`Loader` draws the batches from a data set held in pinned host memory and
hands them to the card without waiting for it.

The equations are SoftRas's. Where the port departs from its code:

  * the cameras are the port's gluLookAt and gluPerspective (right-handed,
    looking down -z), not SoftRas's look-at and perspective transform, so
    an image may be mirrored against SoftRas's; `viewing_angle` 15 is
    SoftRas's half angle, so fov_y is 30 degrees;
  * the renderer gates a pair by the squared distance's cutoff
    `blur_radius` = sqrt(sigma ln(1 / dist_eps - 1)), with SoftRas's
    dist_eps 1e-10, and by near and far planes SoftRas does not have;
  * the template is `models/shapes.icosphere(3)` (642 vertices, 1,280
    triangles, as `sphere_642.obj`, in another vertex order);
  * the flatten loss runs over every edge; SoftRas's edge list takes the
    pairs (0, 1) and (1, 2) of each face and so skips an edge that both
    its faces hold as (2, 0).

Nothing here reads a device value on the host once the loader and the
step are built: a step's `recon.steps` and `recon.silhouettes` counters
count on the host, and the step opens the spans `mr.recon.encode`,
`mr.recon.decode` and `mr.recon.losses` (where the eager step and the
capture run them) and the loader `mr.recon.batch`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .. import parallel
from ..models import shapes, soft_mesh_renderer
from ..ops import losses, mesh
from ..utils import profiling

IMAGE_SIZE = 64
VIEWS = 24  # viewpoints a data set object is rendered from
DISTANCE = 2.732
ELEVATION = 30.0  # degrees
AZIMUTH_STEP = 15.0  # degrees: viewpoint k is at azimuth -15 k
FOV_Y = 30.0  # SoftRas's viewing_angle 15 is the half angle
NEAR_CLIP = 0.1
FAR_CLIP = 10.0
SIGMA = 1e-4
# SoftRas drops a pair whose squared distance d^2 has
# sigmoid(-d^2 / sigma) < dist_eps = 1e-10: d^2 > sigma ln(1e10 - 1).
BLUR_RADIUS = 0.048
LAMBDA_LAPLACIAN = 5e-3
LAMBDA_FLATTEN = 5e-4
LEARNING_RATE = 1e-4
ADAM_BETAS = (0.9, 0.999)  # PyTorch's defaults, as SoftRas's train.py
ADAM_EPS = 1e-8


def viewpoints(count=VIEWS, distance=DISTANCE, elevation=ELEVATION,
               azimuth_step=AZIMUTH_STEP):
    """[count, 3] f32 camera positions looking at the origin: viewpoint k
    at `distance`, `elevation` degrees and azimuth -k `azimuth_step`
    degrees, placed as SoftRas's `get_points_from_angles`."""
    el = math.radians(elevation)
    out = []
    for k in range(count):
        az = math.radians(-k * azimuth_step)
        out.append([distance * math.cos(el) * math.sin(az),
                    distance * math.sin(el),
                    -distance * math.cos(el) * math.cos(az)])
    return torch.tensor(out, dtype=torch.float32)


class Encoder(nn.Module):
    """Three 5x5 stride-2 convolutions (dim1, 2 dim1, 4 dim1 channels),
    each with BatchNorm and ReLU, then three linear layers with ReLU
    (dim2, dim2, dim_out)."""

    def __init__(self, dim_in=4, dim_out=512, dim1=64, dim2=1024,
                 image_size=IMAGE_SIZE):
        super().__init__()
        channels = [dim_in, dim1, dim1 * 2, dim1 * 4]
        for i in range(3):
            setattr(self, f"conv{i + 1}", nn.Conv2d(
                channels[i], channels[i + 1], 5, stride=2, padding=2))
            setattr(self, f"bn{i + 1}", nn.BatchNorm2d(channels[i + 1]))
        cells = math.ceil(image_size / 8) ** 2
        self.fc1 = nn.Linear(channels[3] * cells, dim2)
        self.fc2 = nn.Linear(dim2, dim2)
        self.fc3 = nn.Linear(dim2, dim_out)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = F.relu(self.bn3(self.conv3(x)))
        x = x.flatten(1)
        x = F.relu(self.fc1(x))
        x = F.relu(self.fc2(x))
        return F.relu(self.fc3(x))


class Decoder(nn.Module):
    """Features [N, dim_in] -> vertices [N, V, 3]: the template, scaled by
    `obj_scale`, moved per coordinate through a sigmoid by a bias from the
    features, then squeezed toward a centroid in (-1, 1)^3 and halved.

    h = ReLU(fc2(ReLU(fc1(x)))); c = tanh(centroid_scale fc_centroid(h));
    b = bias_scale fc_bias(h); base = obj_scale template;
    v = sigmoid(log(|base| / (1 - |base|)) + b) sign(base);
    v = (ReLU(v) (1 - c) - ReLU(-v) (c + 1) + c) / 2,
    in SoftRas's order of operations. A template coordinate of 0 stays 0
    (its logit is -inf).
    """

    def __init__(self, template_vertices, dim_in=512, dim_hidden=(1024, 2048),
                 centroid_scale=0.1, bias_scale=1.0, obj_scale=0.5):
        super().__init__()
        self.register_buffer("template", torch.as_tensor(
            template_vertices, dtype=torch.float32).clone())
        self.vertex_count = self.template.shape[0]
        self.centroid_scale = centroid_scale
        self.bias_scale = bias_scale
        self.obj_scale = obj_scale
        self.fc1 = nn.Linear(dim_in, dim_hidden[0])
        self.fc2 = nn.Linear(dim_hidden[0], dim_hidden[1])
        self.fc_centroid = nn.Linear(dim_hidden[1], 3)
        self.fc_bias = nn.Linear(dim_hidden[1], self.vertex_count * 3)

    def forward(self, x):
        h = F.relu(self.fc2(F.relu(self.fc1(x))))
        centroid = self.fc_centroid(h) * self.centroid_scale
        bias = (self.fc_bias(h) * self.bias_scale).view(
            -1, self.vertex_count, 3)
        base = self.template * self.obj_scale
        sign = torch.sign(base)
        base = torch.abs(base)
        base = torch.log(base / (1 - base))
        centroid = torch.tanh(centroid[:, None, :])
        v = torch.sigmoid(base + bias) * sign
        v = F.relu(v) * (1 - centroid) - F.relu(-v) * (centroid + 1)
        return (v + centroid) * 0.5


class ReconstructionNet(nn.Module):
    """SoftRas's recon model: `encoder` and `decoder` around a template
    mesh (default: the level-3 icosphere), whose triangles `faces` [T, 3]
    int32 (CCW from outside) every decoded mesh shares."""

    def __init__(self, template=None, image_size=IMAGE_SIZE, dim1=64,
                 dim2=1024, dim_features=512, dim_hidden=(1024, 2048)):
        super().__init__()
        if template is None:
            vertices, faces, _ = shapes.icosphere(3)
        else:
            vertices, faces = template
        self.encoder = Encoder(4, dim_features, dim1, dim2, image_size)
        self.decoder = Decoder(vertices, dim_features, dim_hidden)
        self.register_buffer("faces", torch.as_tensor(faces,
                                                      dtype=torch.int32))

    def forward(self, images):
        return self.decoder(self.encoder(images))


class Loader:
    """Random batches of a data set of RGBA images kept in host memory, as
    SoftRas's `get_random_batch` keeps it in host RAM.

    `images` [N, views, 4, S, S] uint8 holds each object's renders from the
    `eyes` [views, 3] viewpoints. A call draws `objects` object ids and,
    for each, two view ids, independently, from `generator` (a CPU
    torch.Generator seeded with `seed`): torch.randint(N, [objects]), then
    torch.randint(views, [objects, 2]). It gathers their images and
    viewpoints into fresh pinned buffers and copies them to `device`
    without blocking; the pinned allocator reuses a buffer only once its
    copy has ended, so the host never waits for the card. Returns
    {"images": [2 objects, 4, S, S] uint8, "eyes": [2 objects, 3] f32} on
    `device`, viewpoint a's images first, then b's.
    """

    def __init__(self, images, eyes, objects, seed, device):
        self.device = torch.device(device)
        self.pinned = self.device.type == "cuda"
        if images.dim() != 5 or images.dtype != torch.uint8:
            raise ValueError("images must be a [N, views, 4, S, S] uint8 "
                             "tensor")
        if tuple(eyes.shape) != (images.shape[1], 3):
            raise ValueError("eyes must have shape [views, 3]")
        self.object_count, self.view_count = images.shape[:2]
        images = images.reshape((-1,) + tuple(images.shape[2:]))
        if self.pinned and not images.is_pinned():
            images = images.pin_memory()
        self.images = images
        self.eyes = eyes.to(torch.float32).cpu()
        self.objects = int(objects)
        self.generator = torch.Generator()
        self.generator.manual_seed(int(seed))

    def draw(self):
        """(flat image ids [2 objects], view ids [2 objects]), a's first."""
        ids = torch.randint(self.object_count, (self.objects,),
                            generator=self.generator)
        views = torch.randint(self.view_count, (self.objects, 2),
                              generator=self.generator)
        views = views.T.reshape(-1)
        return ids.repeat(2) * self.view_count + views, views

    def __call__(self):
        with profiling.annotate("mr.recon.batch"):
            flat, views = self.draw()
            images = torch.empty((flat.shape[0],) + self.images.shape[1:],
                                 dtype=torch.uint8, pin_memory=self.pinned)
            torch.index_select(self.images, 0, flat, out=images)
            eyes = torch.empty((flat.shape[0], 3), dtype=torch.float32,
                               pin_memory=self.pinned)
            torch.index_select(self.eyes, 0, views, out=eyes)
            return {"images": images.to(self.device, non_blocking=True),
                    "eyes": eyes.to(self.device, non_blocking=True)}


class Reconstruction:
    """The training step of SoftRas's recon at this module's settings:
    `step(batch) -> loss` takes a `Loader` batch, renders 4 B silhouettes
    of S x S and lets Adam (capturable on a card) update `model` in place.
    `silhouettes` holds the last step's [4 B, S, S] renders (on a card, the
    captured step's output, which each replay rewrites)."""

    def __init__(self, model):
        self.model = model
        device = model.faces.device
        self.render_kwargs = dict(sigma_val=SIGMA, blur_radius=BLUR_RADIUS,
                                  fov_y=FOV_Y, near_clip=NEAR_CLIP,
                                  far_clip=FAR_CLIP)
        self.center = torch.zeros(3, device=device)
        self.up = torch.tensor([0.0, 1.0, 0.0], device=device)
        # Host-side plans, built once outside the step.
        self.wings = mesh.compute_edge_wings(model.faces)
        self.edges = self.wings[:, :2].contiguous()
        self.optimizer = torch.optim.Adam(
            model.parameters(), lr=LEARNING_RATE, betas=ADAM_BETAS,
            eps=ADAM_EPS, capturable=device.type == "cuda")
        self.step = parallel.make_train_step(self.loss, self.optimizer)
        self.silhouettes = None

    def loss(self, params, batch):
        """The step's loss (`params` are the model's own parameters)."""
        images = batch["images"].to(torch.float32) / 255.0
        size = images.shape[-1]
        with profiling.annotate("mr.recon.encode"):
            features = self.model.encoder(images)
        with profiling.annotate("mr.recon.decode"):
            vertices = self.model.decoder(features)
        n = vertices.shape[0] // 2
        mesh_a, mesh_b = vertices[:n], vertices[n:]
        eye_a, eye_b = batch["eyes"][:n], batch["eyes"][n:]
        alpha = soft_mesh_renderer.render_silhouette(
            torch.cat([mesh_a, mesh_b, mesh_a, mesh_b]), self.model.faces,
            torch.cat([eye_a, eye_a, eye_b, eye_b]), self.center, self.up,
            size, size, **self.render_kwargs)
        self.silhouettes = alpha
        with profiling.annotate("mr.recon.losses"):
            target_a, target_b = images[:n, 3], images[n:, 3]
            target = torch.cat([target_a, target_a, target_b, target_b])
            return (losses.iou_loss(alpha, target)
                    + LAMBDA_LAPLACIAN * losses.squared_laplacian_loss(
                        vertices, self.edges)
                    + LAMBDA_FLATTEN * losses.flatten_loss(vertices,
                                                           self.wings))

    def __call__(self, batch):
        profiling.count("recon.steps")
        profiling.count("recon.silhouettes", 2 * batch["eyes"].shape[0])
        return self.step(batch)
