"""PyTorch port on the card: the CUDA kernels vs their plain PyTorch
versions.

Every test here is marked `cuda` and skips without an NVIDIA GPU. The
machine with the card has no JAX, and tests/conftest.py imports it, so run
them there without the conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The forward kernels (K1, K3) and their plain versions run the same fp32
operations in the same order (the kernels are built with --fmad=false):
ids must be equal and bc, z and attributes agree to 1e-6. The backward
kernels (K2, K4) sum per-pixel terms into per-triangle rows with atomic
adds in an order that changes from run to run: their gradients agree with
the plain versions' to 1e-5 of the plain tensor's max |value|, per tensor,
the JAX suite's CPU gate between its two backward backends; K4 (K2's
body without attributes) also at ragged sizes, on row strips, the empty
mesh and every pixel inactive, under its own kernel name; K2 at A = 0,
1, 2, 9, 12, 13 and 40 (one to four rounds of its registers, float, float2
and float4 loads), on the teapot and sphere72, on row strips, the empty
mesh and every pixel inactive (an exactly zero table). K1 runs as a
cluster of CTAs per group of pixel blocks whose partial winners merge in
any order: at each split tried its outputs are bit for bit the same. K3
is the same cluster body without attributes: at its launcher's rule and
at every group and split, for one image and four, its ids, bc and z equal
K1's bit for bit and the plain version's.

The soft kernels (K5-K8) against their plain versions: forward rgb within
2e-5 abs and 1e-4 rel (the JAX suite's Pallas-vs-XLA gate) and alpha within
1e-6 (the kernels aggregate the softmax triangle by triangle, the plain
version chunk by chunk; the silhouette product runs in the same order in
both); K5's alpha equals K7's bit for bit at every split (one cluster
body, with and without shading); the
backward kernels (K6, K8) within `test_utils.SOFT_GRAD_RTOL` of each plain
tensor's max |value|, the table gradient's per group of columns that come
from one input of the packing: clip, world, normals, colours
(`test_utils.SOFT_DTABLE_GROUPS`; K8's atomic adds again, K6 sums in a
fixed order and repeats bit for bit on the teapot, the cow fit's shape and
the pose_tie scene). d/dgamma and the z columns are compared only where a
pixel blends two depths: on the two-triangle scene every triangle lies at
NDC z 0.25, and on the zero_edge scene a pixel sees one triangle and its
duplicate, so the render does not depend on gamma at all and both routes
return f32 cancellation noise (per-pixel terms W (shade - rgb) z /
gamma^2 of ~4e2 that cancel). The zero_edge scene holds a zero-length
edge, whose packed reciprocal squared length is 1e24: the kernels stay
finite and within their gates there. The soft scenes and gates are
`utils/test_utils`'s, shared with chip_smoke.py.

The training step of `parallel.make_train_step` captures its gradient
and update into a CUDA graph on the card: the captured hard and
silhouette steps agree with eager steps within the training step's 1e-4
(the hard backward kernels' atomics), a new batch is copied into the
captured inputs, and a step that cannot be captured raises; the captured
cow-fit step repeats bit for bit. The sharded wrappers on 2x2, 4x1 and
1x4 meshes over the card equal the unsharded renders bit for bit, and a
sharded step captures on one card and refuses a mesh over two devices.
On 2 and 4 gloo ranks sharing the card (`utils/ranks.py`) the steps
capture as chains of three graphs cut at their two gathers: the cow
fit's captured steps and loop equal its eager steps and the unsharded
captured steps bit for bit, the hard step's within 1e-5.

The hard renderer's diffuse shading (`csrc/phong_shade.cu`, through
`ops/shading.phong_shade_cuda`) against the plain ops it replaces, on
`test_utils.SHADING_SCENES`, lights shared by the batch and the teapot's
rasterized attributes at 256x256 batch 4, at 1, 2 and 3 lights, with and
without ambient: images within 1e-6 (the kernel runs the plain ops'
operations in their order), attribute gradients within 1e-5 per pixel of
autograd's through the plain ops and of `phong_diffuse_backward_torch`
(NaN where autograd's is, at zero-length normals). A captured hard step
launches each shading kernel once, at its capture; under the default
backend specular shading and gradients into the lights take the plain ops
and count `shade.unfused`; backend 'torch' never launches the pair and
'cuda' raises for those calls.

SoftRas's reconstruction step (`examples/recon.py`: a network trained
through the silhouette kernels, a distinct mesh in each image) captures
cuDNN's convolutions, BatchNorm and Adam with K5 and K6 into one graph:
with cuDNN deterministic, its replays equal eager steps bit for bit, and
its loader and replays read nothing on the host.

The microbenchmark kernels (S1-S3, `microbench/`): fma, prod and
patch_eval equal their plain versions bit for bit; the tensor-core
variants are held at their modules' tolerances (`mxu_edge.TC_RTOL`,
`mxu_full.check_tc`, also on a table whose edges pass through the tc
cull's region corners); both patch merges give K3's ids.
"""

import numpy as np
import pytest
import torch

from pytorch_mesh_renderer_tpu_torch import config as config_lib
from pytorch_mesh_renderer_tpu_torch import parallel
from pytorch_mesh_renderer_tpu_torch.microbench import common
from pytorch_mesh_renderer_tpu_torch.microbench import mxu_edge as me
from pytorch_mesh_renderer_tpu_torch.microbench import mxu_full as mf
from pytorch_mesh_renderer_tpu_torch.microbench import patch_scatter as ps
from pytorch_mesh_renderer_tpu_torch.models import (mesh_renderer, shapes,
                                                    soft_mesh_renderer)
from pytorch_mesh_renderer_tpu_torch.ops import camera
from pytorch_mesh_renderer_tpu_torch.ops import mesh as mesh_ops
from pytorch_mesh_renderer_tpu_torch.ops import rasterize as rasterize_ops
from pytorch_mesh_renderer_tpu_torch.ops import rasterize_barycentric_cuda as rb
from pytorch_mesh_renderer_tpu_torch.ops import rasterize_cuda as rc
from pytorch_mesh_renderer_tpu_torch.ops import soft_rasterize_cuda as sc
from pytorch_mesh_renderer_tpu_torch.utils import (capture, hard_work, kernels,
                                                   profiling, scenes,
                                                   soft_work, test_utils)

pytestmark = pytest.mark.cuda

CUBE_VERTICES = [[-1, -1, 1], [-1, -1, -1], [-1, 1, -1], [-1, 1, 1],
                 [1, -1, 1], [1, -1, -1], [1, 1, -1], [1, 1, 1]]
CUBE_TRIANGLES = [[0, 1, 2], [2, 3, 0], [3, 2, 6], [6, 7, 3], [7, 6, 5],
                  [5, 4, 7], [4, 5, 1], [1, 0, 4], [5, 6, 2], [2, 1, 5],
                  [7, 4, 0], [0, 3, 7]]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _launches(*kernels):
    """Each kernel's launches so far in this process
    (`launches.<kernel>` in `profiling.counters()`), in order."""
    counts = profiling.counters()
    return tuple(counts.get("launches." + k, 0) for k in kernels)


def _snapped_scene(dev, batch=2, vertex_count=300, tri_count=2000,
                   width=80, height=56):
    """Many overlapping triangles whose vertices project exactly onto pixel
    centres, so edges run through pixel centres (edge value 0) and along
    the kernel's block boundaries: the hardest case for the block cull."""
    rng = np.random.RandomState(1)
    cols = rng.randint(0, width, (batch, vertex_count))
    rows = rng.randint(0, height, (batch, vertex_count))
    ndc = np.stack([(cols + 0.5) * np.float32(2.0 / width) - 1.0,
                    (rows + 0.5) * np.float32(2.0 / height) - 1.0,
                    rng.uniform(-0.9, 0.9, (batch, vertex_count))], -1)
    # Small triangles: each picks three vertices that are close in index.
    first = rng.randint(0, vertex_count - 8, tri_count)
    tris = np.stack([first, first + rng.randint(1, 4, tri_count),
                     first + rng.randint(4, 8, tri_count)], -1)
    clip = np.concatenate([ndc, np.ones((batch, vertex_count, 1))], -1)
    attrs = rng.randn(batch, vertex_count, 5)
    return (torch.tensor(clip, dtype=torch.float32, device=dev),
            torch.tensor(attrs, dtype=torch.float32, device=dev),
            torch.tensor(tris, dtype=torch.int32, device=dev), width, height)


def _scene(name, dev, size=None):
    """(clip [B, V, 4], attributes [B, V, A], triangles, width, height);
    `size` (width, height) replaces a random scene's 48x40."""
    f32 = dict(dtype=torch.float32, device=dev)
    if name == "snapped":
        return _snapped_scene(dev)
    if name == "cube":
        batch, verts = 1, torch.tensor([CUBE_VERTICES], **f32)
        tris = torch.tensor(CUBE_TRIANGLES, dtype=torch.int32, device=dev)
        attrs, eye, (width, height) = verts * 0.5 + 0.5, [2.0, 3.0, 6.0], (
            64, 48)
    else:  # random<A>: tests/test_rasterize_pallas.py's random scene
        batch, (width, height) = 2, size or (48, 40)
        rng = np.random.RandomState(0)
        verts = torch.tensor(rng.randn(batch, 24, 3) * 0.5, **f32)
        tris = torch.tensor(rng.randint(0, 24, (30, 3)), dtype=torch.int32,
                            device=dev)
        attrs = torch.tensor(rng.randn(batch, 24, int(name[6:])), **f32)
        eye = [0.0, 0.0, 3.0]
    cam = camera.clip_space_transforms(
        torch.tensor([eye] * batch, **f32), torch.zeros(batch, 3, **f32),
        torch.tensor([[0.0, 1.0, 0.0]] * batch, **f32),
        torch.full((batch,), 40.0, **f32), torch.full((batch,), 0.01, **f32),
        torch.full((batch,), 10.0, **f32), width, height)
    return (camera.transform_homogeneous(cam, verts), attrs, tris, width,
            height)


def _assert_same(kernel, plain):
    torch.cuda.synchronize()
    assert len(kernel) == len(plain)
    assert torch.equal(kernel[0], plain[0])
    for k, p in zip(kernel[1:], plain[1:]):
        assert k.shape == p.shape and k.dtype == p.dtype
        if k.numel():
            assert float((k - p).abs().max()) <= 1e-6


@pytest.mark.parametrize("scene", ["cube", "random3", "random9", "random16",
                                   "snapped"])
@pytest.mark.parametrize("with_z", [True, False])
def test_kernel_matches_plain_version(dev, scene, with_z):
    clip, attrs, tris, width, height = _scene(scene, dev)
    (before,) = _launches("rasterize_fused_fwd")
    kernel = rc.rasterize_interpolate_cuda(clip, attrs, tris, width, height,
                                           with_z=with_z)
    assert _launches("rasterize_fused_fwd") == (before + 1,)
    plain = rc.rasterize_interpolate_torch(clip, attrs, tris, width, height,
                                           with_z=with_z)
    _assert_same(kernel, plain)


def test_row_strips_and_empty_mesh(dev):
    clip, attrs, tris, _, _ = _scene("random9", dev)
    full = rc.rasterize_interpolate_cuda(clip, attrs, tris, 48, 40,
                                         with_z=True)
    for i in range(2):
        strip = rc.rasterize_interpolate_cuda(
            clip, attrs, tris, 48, 20, row_offset=20 * i, full_height=40,
            with_z=True)
        for s, f in zip(strip, full):
            assert torch.equal(s, f[:, 20 * i:20 * (i + 1)])
    empty = tris[:0]
    _assert_same(
        rc.rasterize_interpolate_cuda(clip, attrs, empty, 48, 40, with_z=True),
        rc.rasterize_interpolate_torch(clip, attrs, empty, 48, 40,
                                       with_z=True))


@pytest.mark.parametrize("scene", ["cube", "random3", "random9", "random16",
                                   "snapped", "teapot"])
def test_k1_at_every_split_equals_the_plain_version_and_k3(dev, scene):
    """K1 is a cluster of kSplit CTAs per pixel block whose partial
    winners merge in any order: at its compiled split and at each split
    tried (utils/hard_work.SPLITS) its outputs are bit for bit the same,
    its ids, bc and z equal K3's (the one-CTA-per-block design) bit for
    bit, and they hold the plain version's gates."""
    if scene == "teapot":
        clip, attrs, tris, size = hard_work.scene_tables("teapot 256", dev)
        width = height = size
    else:
        clip, attrs, tris, width, height = _scene(scene, dev)
    table = rc.pack_rows(clip, tris, False)[0]
    corner = rc.pack_corner_attributes(attrs, tris)
    splits, shapes = test_utils.hard_splits(), test_utils.bary_shapes()
    before = _launches("rasterize_fused_fwd", "rasterize_bary_fwd")
    k1 = test_utils.compare_k1_splits(table, corner, width, height,
                                      splits=splits, bary=shapes)
    assert _launches("rasterize_fused_fwd", "rasterize_bary_fwd") == (
        before[0] + len(splits), before[1] + len(shapes))
    _assert_same(k1, rc.forward_torch_packed(table, corner, width, height,
                                             0, height, True))
    assert bool((k1[0] > 0).any())


def test_k1_splits_on_row_strips_and_the_empty_mesh(dev):
    clip, attrs, tris, _, _ = _scene("random9", dev)
    corner = rc.pack_corner_attributes(attrs, tris)
    table = rc.pack_rows(clip, tris, False)[0]
    splits, shapes = test_utils.hard_splits(), test_utils.bary_shapes()
    full = test_utils.compare_k1_splits(table, corner, 48, 40, splits=splits,
                                        bary=shapes)
    for i in range(2):
        strip = test_utils.compare_k1_splits(table, corner, 48, 20, 20 * i,
                                             40, splits, shapes)
        for s, f in zip(strip, full):
            assert torch.equal(s, f[:, 20 * i:20 * (i + 1)])
    empty = test_utils.compare_k1_splits(table[:, :0].contiguous(),
                                         corner[:, :0].contiguous(), 48, 40,
                                         splits=splits, bary=shapes)
    assert not bool(empty[0].any()) and bool((empty[3] == 1.0).all())


def _hard_scene(name, dev):
    """_scene's scenes, plus "ties" (test_utils.ties_scene: exact depth
    ties, +0.0 against -0.0) and "teapot" (256x256, batch 4, A = 9)."""
    if name == "teapot":
        clip, attrs, tris, size = hard_work.scene_tables("teapot 256", dev)
        return clip, attrs, tris, size, size
    if name == "ties":
        clip, tris, attrs, width, height = test_utils.ties_scene()
        return (torch.tensor(clip, device=dev), torch.tensor(attrs, device=dev),
                torch.tensor(tris, device=dev), width, height)
    return _scene(name, dev)


@pytest.mark.parametrize("scene", ["cube", "random9", "snapped", "ties",
                                   "teapot"])
@pytest.mark.parametrize("images", [1, 4])
def test_k3_at_every_group_and_split_equals_k1_and_the_plain_version(
        dev, scene, images):
    """K3 is K1's cluster body without attributes: at its launcher's rule
    and at each group and split tried, for one image and for a batch
    (the scene's images repeated up to `images`), its ids, bc and z equal
    K1's bit for bit and the plain version's."""
    clip, attrs, tris, width, height = _hard_scene(scene, dev)
    reps = -(-images // clip.shape[0])
    clip = clip.repeat(reps, 1, 1)[:images].contiguous()
    attrs = attrs.repeat(reps, 1, 1)[:images].contiguous()
    table = rc.pack_rows(clip, tris, False)[0]
    corner = rc.pack_corner_attributes(attrs, tris)
    shapes = test_utils.bary_shapes()
    (before,) = _launches("rasterize_bary_fwd")
    k1 = test_utils.compare_k1_splits(table, corner, width, height,
                                      bary=shapes)
    assert _launches("rasterize_bary_fwd") == (before + len(shapes),)
    plain = rb.rasterize_barycentric_torch(clip, tris, width, height)
    for k, p in zip((k1[0], k1[1], k1[3]), plain):
        assert torch.equal(k, p)
    assert bool((k1[0] > 0).any())


def test_render_backward_launches_kernel_once(dev):
    _, _, tris, width, height = _scene("cube", dev)
    vertices = torch.tensor([CUBE_VERTICES], dtype=torch.float32,
                            device=dev)
    args = (tris.flip(1).contiguous(), vertices, torch.ones_like(vertices),
            torch.tensor([2.0, 3.0, 6.0], device=dev),
            torch.zeros(3, device=dev),
            torch.tensor([0.0, 1.0, 0.0], device=dev),
            torch.tensor([[[0.0, 0.0, 6.0]]], device=dev),
            torch.ones(1, 1, 3, device=dev), width, height)
    grads = []
    for config in (None, config_lib.HardRasterizerConfig(backend="torch")):
        v = vertices.clone().requires_grad_(True)
        images = mesh_renderer.render(v, *args, config=config)
        before = _launches("rasterize_fused_fwd", "rasterize_fused_bwd")
        (images[..., :3] ** 2).mean().backward()
        torch.cuda.synchronize()
        grads.append(v.grad)
        if config is None:  # 'auto' on a CUDA tensor: the kernels
            assert _launches("rasterize_fused_fwd",
                             "rasterize_fused_bwd") == (before[0],
                                                        before[1] + 1)
    scale = float(grads[1].abs().max())
    assert scale > 0.0 and bool(torch.isfinite(grads[0]).all())
    assert float((grads[0] - grads[1]).abs().max()) <= 1e-5 * scale


def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    clip, attrs, tris, width, height = _scene("cube", dev)
    with pytest.raises(TypeError):
        rc.rasterize_interpolate_cuda(clip.double(), attrs, tris, width,
                                      height)
    with pytest.raises(ValueError, match="different devices"):
        rc.rasterize_interpolate_cuda(clip, attrs.cpu(), tris, width, height)
    with pytest.raises(ValueError, match="CUDA"):
        rc.launch_fused_fwd(rc.pack_rows(clip, tris, False)[0].cpu(),
                            rc.pack_corner_attributes(attrs, tris).cpu(),
                            width, height, 0, height, False)


def _assert_grads_close(kernel, plain, rtol=1e-5):
    """Per tensor: finite, and within rtol of the plain tensor's max
    |value|."""
    torch.cuda.synchronize()
    assert len(kernel) == len(plain)
    for k, p in zip(kernel, plain):
        assert k.shape == p.shape and k.dtype == p.dtype
        assert bool(torch.isfinite(k).all())
        if p.numel():
            scale = float(p.abs().max())
            assert float((k - p).abs().max()) <= rtol * scale


def _cotangents(ids, n_attr, seed=5):
    rng = np.random.RandomState(seed)
    f32 = dict(dtype=torch.float32, device=ids.device)
    return (torch.tensor(rng.randn(*ids.shape, 3), **f32),
            torch.tensor(rng.randn(*ids.shape, n_attr), **f32))


@pytest.mark.parametrize("scene", ["cube", "random3", "random9", "random16",
                                   "snapped"])
def test_fused_backward_kernel_matches_plain_version(dev, scene):
    clip, attrs, tris, width, height = _scene(scene, dev)
    table, inv_abs_det = rc.pack_rows(clip, tris, True)
    corner = rc.pack_corner_attributes(attrs, tris)
    ids, bc, _ = rc.launch_fused_fwd(table, corner, width, height, 0, height,
                                     False)
    g_bc, g_attr = _cotangents(ids, attrs.shape[-1])
    operands = (ids, bc, g_bc, g_attr, table, inv_abs_det, corner)
    (before,) = _launches("rasterize_fused_bwd")
    kernel_table = rc.launch_fused_bwd(*operands)
    assert _launches("rasterize_fused_bwd") == (before + 1,)
    plain_table = rc.triangle_gradients_torch(*operands)
    assert float(plain_table.abs().max()) > 0.0
    _assert_grads_close([kernel_table], [plain_table])
    _assert_grads_close(
        rc.rasterize_interpolate_backward_cuda(*operands, tris,
                                               clip.shape[1]),
        rc.rasterize_interpolate_backward_torch(*operands, tris,
                                                clip.shape[1]))


@pytest.mark.parametrize("attr_count", [0, 1, 2, 9, 12, 13, 40])
def test_fused_backward_at_every_attribute_count(dev, attr_count):
    """K2 reduces kAttrChunk (12) attributes a round: A = 13 and 40 take
    two and four rounds of kAttrChunk attributes held in registers;
    A = 40 and 12
    load the cotangents as float4, A = 2 as float2, the rest one float a
    load."""
    clip, _, tris, width, height = _scene("random9", dev)
    attrs = torch.tensor(np.random.RandomState(attr_count).randn(
        2, 24, attr_count), dtype=torch.float32, device=dev)
    table, inv_abs_det = rc.pack_rows(clip, tris, True)
    corner = rc.pack_corner_attributes(attrs, tris)
    ids, bc, _ = rc.launch_fused_fwd(table, corner, width, height, 0, height,
                                     False)
    operands = (ids, bc, *_cotangents(ids, attr_count), table, inv_abs_det,
                corner)
    kernel_table = rc.launch_fused_bwd(*operands)
    plain_table = rc.triangle_gradients_torch(*operands)
    assert kernel_table.shape == (2, 30, 9 + 3 * attr_count)
    assert float(plain_table.abs().max()) > 0.0
    _assert_grads_close([kernel_table], [plain_table])


@pytest.mark.parametrize("scene", ["teapot 256", "sphere72 512"])
def test_fused_backward_on_the_timed_scenes(dev, scene):
    """K2 at A = 9 on the scenes utils/hard_work.py times, and on their
    floor: every pixel inactive (ids 0, bc 0) gives an exactly zero
    table."""
    operands, _ = hard_work.bwd_operands(scene, dev)
    _assert_grads_close([rc.launch_fused_bwd(*operands)],
                        [rc.triangle_gradients_torch(*operands)])
    floor = (torch.zeros_like(operands[0]), torch.zeros_like(operands[1]))
    table = rc.launch_fused_bwd(*floor, *operands[2:])
    torch.cuda.synchronize()
    assert not bool(table.any())


def test_fused_backward_tables_on_row_strips_and_the_empty_mesh(dev):
    """K2's tables of two row strips sum to the full image's, and a
    zero-triangle mesh gives an empty table."""
    clip, attrs, tris, width, height = _scene("random9", dev)
    table, inv_abs_det = rc.pack_rows(clip, tris, True)
    corner = rc.pack_corner_attributes(attrs, tris)
    ids, bc, _ = rc.launch_fused_fwd(table, corner, width, height, 0, height,
                                     False)
    g_bc, g_attr = _cotangents(ids, 9)
    full = rc.launch_fused_bwd(ids, bc, g_bc, g_attr, table, inv_abs_det,
                               corner)
    strips = [rc.launch_fused_bwd(*(t[:, rows].contiguous() for t in (
        ids, bc, g_bc, g_attr)), table, inv_abs_det, corner)
        for rows in (slice(0, 20), slice(20, 40))]
    _assert_grads_close([strips[0] + strips[1]], [full])
    empty = rc.launch_fused_bwd(ids, bc, g_bc, g_attr,
                                *(t[:, :0].contiguous() for t in (
                                    table, inv_abs_det, corner)))
    torch.cuda.synchronize()
    assert empty.shape == (2, 0, 36)


@pytest.mark.parametrize("scene", ["cube", "random3", "random9", "random16",
                                   "snapped"])
def test_barycentric_kernels_match_plain_versions(dev, scene):
    clip, _, tris, width, height = _scene(scene, dev)
    grads = []
    outs = []
    for kernel in (True, False):
        c = clip.clone().requires_grad_(True)
        before = _launches("rasterize_bary_fwd", "rasterize_bary_bwd")
        fn = (rb.rasterize_barycentric_cuda if kernel
              else rb.rasterize_barycentric_torch)
        ids, bc, z = fn(c, tris, width, height)
        g_bc, _ = _cotangents(ids, 0)
        (bc * g_bc).sum().backward()
        after = _launches("rasterize_bary_fwd", "rasterize_bary_bwd")
        assert after == ((before[0] + 1, before[1] + 1) if kernel
                         else before)
        outs.append((ids, bc.detach(), z))
        grads.append(c.grad)
    _assert_same(*outs)
    assert float(grads[1].abs().max()) > 0.0
    _assert_grads_close([grads[0]], [grads[1]])
    assert bool((grads[0][..., 2] == 0.0).all())


def test_backward_row_strips_and_empty_mesh(dev):
    clip, attrs, tris, _, _ = _scene("random9", dev)
    g_bc, g_attr = _cotangents(torch.zeros(2, 40, 48, device=dev), 9)

    def grads(triangles, strip_height, row_offset):
        c = clip.clone().requires_grad_(True)
        a = attrs.clone().requires_grad_(True)
        _, bc, attr_img = rc.rasterize_interpolate_cuda(
            c, a, triangles, 48, strip_height, row_offset=row_offset,
            full_height=40)
        rows = slice(row_offset, row_offset + strip_height)
        ((bc * g_bc[:, rows]).sum()
         + (attr_img * g_attr[:, rows]).sum()).backward()
        return c.grad, a.grad

    full = grads(tris, 40, 0)
    strips = [grads(tris, 20, 20 * i) for i in range(2)]
    _assert_grads_close([s + t for s, t in zip(*strips)], full)
    for g in grads(tris[:0], 40, 0):
        assert torch.equal(g, torch.zeros_like(g))
    c = clip[0].clone().requires_grad_(True)
    _, bc, _ = rasterize_ops.rasterize_barycentric(c, tris[:0], 48, 40)
    bc.sum().backward()
    assert torch.equal(c.grad, torch.zeros_like(c))


# K4 on K2's warp grid (8x8-pixel CTAs): ragged sizes mask x >= W and
# y >= H; a row strip launches on the strip's height.
K4_CASES = ["random 37x23", "random 129x17", "teapot 256 b4",
            "strip rows 20-39 of 40", "strip rows 13-29 of 40", "empty",
            "every pixel inactive"]


def _k4_operands(case, dev):
    """(ids, bc, df/dbc, table, inv_abs_det) of a K4 case: K3's forward on
    the case's scene (or strip), a seeded bc cotangent."""
    row_offset, full_height = 0, None
    if case == "teapot 256 b4":
        clip, _, tris, width = hard_work.scene_tables("teapot 256", dev)
        height = width
    else:
        size = tuple(int(n) for n in case.split()[1].split("x")) if (
            case.startswith("random")) else None
        clip, _, tris, width, height = _scene("random9", dev, size)
    if case.startswith("strip"):
        first, last = (int(n) for n in case.split()[2].split("-"))
        row_offset, full_height, height = first, height, last - first + 1
    if case == "empty":
        tris = tris[:0]
    table, inv_abs_det = rc.pack_rows(clip, tris, True)
    ids, bc, _ = rb.launch_bary_fwd(table, width, height, row_offset,
                                    full_height or height)
    if case == "every pixel inactive":
        ids, bc = torch.zeros_like(ids), torch.zeros_like(bc)
    g_bc, _ = _cotangents(ids, 0)
    return ids, bc, g_bc, table, inv_abs_det


@pytest.mark.parametrize("case", K4_CASES)
def test_k4_matches_its_plain_version(dev, case):
    operands = _k4_operands(case, dev)
    (before,) = _launches("rasterize_bary_bwd")
    kernel = rb.launch_bary_bwd(*operands)
    assert _launches("rasterize_bary_bwd") == (before + 1,)
    plain = rb.triangle_gradients_bary_torch(*operands)
    torch.cuda.synchronize()
    assert kernel.shape == plain.shape == operands[3].shape[:2] + (9,)
    if case in ("empty", "every pixel inactive"):
        assert torch.equal(kernel, torch.zeros_like(kernel))
        return
    assert float(plain.abs().max()) > 0.0
    _assert_grads_close([kernel], [plain])


def test_k4_keeps_its_own_kernel_name(dev):
    """K4 runs K2's body under its own symbol, which the profiler and the
    build report name (utils/hard_work.py finds kernels by name)."""
    operands = _k4_operands("random 37x23", dev)
    rb.launch_bary_bwd(*operands)  # built and warm
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        rb.launch_bary_bwd(*operands)
        torch.cuda.synchronize()
    names = [event.key for event in prof.key_averages()]
    assert any(hard_work.KERNELS["k4"] in name for name in names), names
    assert not any(hard_work.KERNELS["k2"] in name for name in names)
    log = kernels.build().log
    assert hard_work.report_names(log, "k4") == [hard_work.KERNELS["k4"]]
    report = soft_work.kernel_report(log, hard_work.KERNELS["k4"])
    assert report["registers"] > 0 and report["blocks_per_sm"] > 0
    assert report["occupancy_source"] == "cudaOccupancy"


def test_backward_launchers_reject_what_the_kernels_do_not_take(dev):
    clip, attrs, tris, width, height = _scene("cube", dev)
    table, inv_abs_det = rc.pack_rows(clip, tris, True)
    corner = rc.pack_corner_attributes(attrs, tris)
    ids, bc, _ = rc.launch_fused_fwd(table, corner, width, height, 0, height,
                                     False)
    g_bc, g_attr = _cotangents(ids, 3)
    operands = [ids, bc, g_bc, g_attr, table, inv_abs_det, corner]
    with pytest.raises(ValueError, match="CUDA"):
        rc.launch_fused_bwd(*[t.cpu() for t in operands])
    with pytest.raises(TypeError, match="float32"):
        rc.launch_fused_bwd(*operands[:2], g_bc.double(), *operands[3:])
    with pytest.raises(ValueError, match="contiguous"):
        rc.launch_fused_bwd(*operands[:2], g_bc.transpose(1, 2).contiguous()
                            .transpose(1, 2), *operands[3:])
    with pytest.raises(ValueError, match="shapes"):
        rc.launch_fused_bwd(*operands[:4], table[:, :5], *operands[5:])
    bary = [ids, bc, g_bc, table, inv_abs_det]
    with pytest.raises(ValueError, match="CUDA"):
        rb.launch_bary_bwd(*[t.cpu() for t in bary])
    with pytest.raises(TypeError, match="int32"):
        rb.launch_bary_bwd(ids.long(), *bary[1:])
    with pytest.raises(ValueError, match="contiguous"):
        rb.launch_bary_bwd(ids, bc, g_bc[:, ::2], table, inv_abs_det)


SOFT_SCENES = test_utils.SOFT_SCENES
SOFT_GRAD_RTOL = test_utils.SOFT_GRAD_RTOL


def _soft_launches():
    return _launches("soft_fwd", "soft_sil_fwd", "soft_bwd", "soft_sil_bwd")


@pytest.mark.parametrize("scene", SOFT_SCENES)
def test_soft_forward_kernels_match_plain_versions(dev, scene):
    soft_scene = test_utils.soft_scene(scene, dev)
    before = _soft_launches()
    (rgba, _, _), _, _ = test_utils.compare_soft_forward(soft_scene)
    assert _soft_launches() == (before[0] + 1, before[1] + 1) + before[2:]
    assert float(rgba[..., 3].max()) > 0.5


@pytest.mark.parametrize("scene", SOFT_SCENES)
def test_soft_backward_kernels_match_plain_versions(dev, scene):
    soft_scene = test_utils.soft_scene(scene, dev)
    k7, alpha, _ = test_utils.compare_soft_forward(soft_scene)
    d_rgba = test_utils.soft_cotangents(soft_scene.table.shape[0],
                                        soft_scene.height, soft_scene.width,
                                        dev)
    before = _soft_launches()
    _, sil_dtable, errors = test_utils.compare_soft_backward(
        soft_scene, k7, alpha, d_rgba)
    assert _soft_launches() == before[:2] + (before[2] + 1, before[3] + 1)
    # Every compared part of K8's gradient is exercised (nonzero) but the
    # columns that take none.
    assert all(scale > 0.0 for label, _, scale in errors["soft_bwd"]
               if "none" not in label)
    # K6 writes only the edge columns.
    assert torch.equal(sil_dtable[..., :9], torch.zeros_like(
        sil_dtable[..., :9]))
    assert torch.equal(sil_dtable[..., 15:], torch.zeros_like(
        sil_dtable[..., 15:]))


def test_soft_row_strips_and_empty_mesh(dev):
    """Row strips reassemble the full image exactly and their table
    gradients sum to the full image's; a mesh without triangles renders
    background and has zero gradients."""
    full = test_utils.soft_scene("random3", dev)
    k7, alpha, _ = test_utils.compare_soft_forward(full)
    d_rgba = test_utils.soft_cotangents(2, full.height, full.width, dev)
    full_grads = test_utils.compare_soft_backward(full, k7, alpha, d_rgba)
    strip_grads = []
    for i in range(2):
        rows = slice(20 * i, 20 * (i + 1))
        strip = full._replace(height=20, params=sc.make_params(
            test_utils.SOFT_SIGMA, test_utils.SOFT_GAMMA,
            test_utils.SOFT_BLUR, 20 * i, dev))
        strip_k7, strip_alpha, _ = test_utils.compare_soft_forward(
            strip, 20 * i, 40)
        for s, f in zip(strip_k7, k7):
            assert torch.equal(s, f[:, rows])
        assert torch.equal(strip_alpha, alpha[:, rows])
        strip_grads.append(test_utils.compare_soft_backward(
            strip, strip_k7, strip_alpha, d_rgba[:, rows].contiguous(),
            20 * i, 40))
    for k in range(2):
        test_utils.grad_errors("the strips' dtable", strip_grads[0][k]
                               + strip_grads[1][k], full_grads[k],
                               SOFT_GRAD_RTOL, test_utils.SOFT_DTABLE_GROUPS)
    empty = full._replace(table=full.table[:, :0].contiguous())
    k7, alpha, _ = test_utils.compare_soft_forward(empty)
    assert torch.equal(k7[0], torch.zeros_like(k7[0]))
    dtable, _, errors = test_utils.compare_soft_backward(empty, k7, alpha,
                                                         d_rgba)
    assert dtable.shape == empty.table.shape
    # dlights, dsigma and dgamma: zero on both routes.
    assert all(err == scale == 0.0 for _, err, scale in errors["soft_bwd"])


@pytest.mark.parametrize("scene", test_utils.SOFT_EDGE_SCENES)
def test_soft_kernels_match_plain_versions_at_k8_edges(dev, scene):
    """K7, K5, K8 and K6 against their plain versions at 65 and at 0
    lights, on a quad of two triangles filling a 256x256 frame, on a
    sphere whose edges run through pixel centres, and on a batch whose
    second image holds no valid pair: that image is background
    and its table gradient exactly 0. K7 and K6 run at each split of a
    pixel block tried, each held to the gates; K7 gives the same outputs
    at every split, and its alpha equals K5's bit for bit."""
    soft_scene = test_utils.soft_scene(scene, dev)
    n_lights = {"random65": 65, "random0": 0}
    assert soft_scene.lights.shape[1] == n_lights.get(
        scene, 3 if scene in ("empty_image", "on_edges", "t_bound") else 2)
    sil_splits = test_utils.soft_splits("soft_sil_bwd")
    fwd_splits = test_utils.soft_splits("soft_fwd")
    before = _soft_launches()
    k7, alpha, _ = test_utils.compare_soft_forward(soft_scene,
                                                   splits=fwd_splits)
    d_rgba = test_utils.soft_cotangents(soft_scene.table.shape[0],
                                        soft_scene.height, soft_scene.width,
                                        dev)
    dtable, _, errors = test_utils.compare_soft_backward(
        soft_scene, k7, alpha, d_rgba, sil_splits=sil_splits)
    assert _soft_launches() == (before[0] + len(fwd_splits), before[1] + 1,
                                before[2] + 1, before[3] + len(sil_splits))
    assert float(alpha[0].max()) > 0.5
    assert any(scale > 0.0 for label, _, scale in errors["soft_bwd"]
               if "dtable" in label)
    if scene == "empty_image":
        assert torch.equal(k7[0][1], torch.zeros_like(k7[0][1]))
        assert torch.equal(dtable[1], torch.zeros_like(dtable[1]))
        d_alpha = d_rgba[..., 3].contiguous()
        for split in sil_splits:
            sil_dtable, _ = sc.launch_sil_bwd(
                soft_scene.table, soft_scene.params, alpha, d_alpha,
                soft_scene.height, split=split)
            assert torch.equal(sil_dtable[1], torch.zeros_like(sil_dtable[1]))
            assert bool(sil_dtable[0].abs().sum() > 0.0)


@pytest.mark.parametrize("scene", SOFT_SCENES + test_utils.SOFT_EDGE_SCENES
                         + ("sphere",))
def test_k5_at_every_split_equals_k7_alpha(dev, scene):
    """K5 runs K7's cluster body without shading: at its compiled split and
    at each split tried its alpha equals K7's bit for bit (the sphere of
    49,298 triangles in one launch per split too), within the plain
    version's gate."""
    soft_scene = test_utils.soft_scene(scene, dev)
    sil_splits = test_utils.soft_splits("soft_sil_fwd")
    before = _soft_launches()
    _, alpha, errors = test_utils.compare_soft_forward(
        soft_scene, sil_splits=sil_splits)
    assert _soft_launches() == (before[0] + 1, before[1] + len(sil_splits),
                                *before[2:])
    assert all(err <= test_utils.SOFT_ALPHA_ATOL
               for _, err, _ in errors["soft_sil_fwd"])
    assert float(alpha.max()) > 0.5


def test_soft_backward_row_strips_on_the_full_frame_quad(dev):
    """K8 and K6 (at each split tried) on row strips whose offsets (100,
    164) cut pixel blocks, each strip against the plain version at its row
    offset; the strips' forward rows (K7 at each split tried) equal the
    full frame's and their table gradients sum to its."""
    sil_splits = test_utils.soft_splits("soft_sil_bwd")
    fwd_splits = test_utils.soft_splits("soft_fwd")
    full = test_utils.soft_scene("quad", dev)
    k7, alpha, _ = test_utils.compare_soft_forward(full, splits=fwd_splits)
    d_rgba = test_utils.soft_cotangents(1, 256, 256, dev, seed=9)
    full_dtable, full_sil_dtable, _ = test_utils.compare_soft_backward(
        full, k7, alpha, d_rgba, sil_splits=sil_splits)
    dtables, sil_dtables = [], []
    for lo, hi in ((0, 100), (100, 164), (164, 256)):
        strip = full._replace(height=hi - lo, params=sc.make_params(
            full.params[0], full.params[1], test_utils.SOFT_BLUR, lo, dev))
        strip_k7, strip_alpha, _ = test_utils.compare_soft_forward(
            strip, lo, 256, fwd_splits)
        for s, f in zip(strip_k7, k7):
            assert torch.equal(s, f[:, lo:hi])
        dtable, sil_dtable, _ = test_utils.compare_soft_backward(
            strip, strip_k7, strip_alpha, d_rgba[:, lo:hi].contiguous(), lo,
            256, sil_splits=sil_splits)
        dtables.append(dtable)
        sil_dtables.append(sil_dtable)
    test_utils.grad_errors("the strips' dtable", sum(dtables), full_dtable,
                           SOFT_GRAD_RTOL, test_utils.SOFT_DTABLE_GROUPS)
    test_utils.grad_errors("the strips' K6 dtable", sum(sil_dtables),
                           full_sil_dtable, SOFT_GRAD_RTOL,
                           test_utils.SOFT_DTABLE_GROUPS)


def _soft_render_args(dev):
    v, t, _ = shapes.cube(2.0)
    f32 = dict(dtype=torch.float32, device=dev)
    return (v[None].to(dev), t.to(dev), torch.ones(1, 8, 3, **f32),
            torch.tensor([2.0, 3.0, 6.0], **f32), torch.zeros(3, **f32),
            torch.tensor([0.0, 1.0, 0.0], **f32),
            torch.tensor([[[0.0, 2.0, 6.0]]], **f32), torch.ones(1, 1, **f32),
            32, 32)


def test_soft_render_launch_counters_and_no_plain_route(dev, monkeypatch):
    """render and render_silhouette on a CUDA tensor launch K7/K8 and K5/K6
    and never reach the plain versions, under 'auto' and 'cuda'."""
    def refuse(*args, **kwargs):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(sc, "soft_forward_torch_packed", refuse)
    monkeypatch.setattr(sc, "soft_backward_torch_packed", refuse)
    monkeypatch.setattr(sc, "soft_silhouette_backward_torch_packed", refuse)
    args = _soft_render_args(dev)
    for config in (None, config_lib.SoftRasterizerConfig(backend="cuda")):
        v = args[0].clone().requires_grad_(True)
        before = _soft_launches()
        images = soft_mesh_renderer.render(v, *args[1:], config=config)
        alpha = soft_mesh_renderer.render_silhouette(
            v, args[1], *args[3:6], 32, 32, config=config)
        (images.square().mean() + alpha.square().mean()).backward()
        torch.cuda.synchronize()
        after = _soft_launches()
        assert after == tuple(b + 1 for b in before)
        assert torch.equal(alpha, images[..., 3].detach())
        assert bool(torch.isfinite(v.grad).all())
        assert float(v.grad.abs().max()) > 0.0


def test_soft_render_gradients_match_plain_route(dev):
    args = _soft_render_args(dev)
    plain_cfg = config_lib.SoftRasterizerConfig(backend="torch")
    grads = []
    for config in (None, plain_cfg):
        v = args[0].clone().requires_grad_(True)
        sigma = torch.tensor(1e-4, device=dev, requires_grad=True)
        images = soft_mesh_renderer.render(v, *args[1:], sigma_val=sigma,
                                           gamma_val=1e-2, config=config)
        images.square().mean().backward()
        grads.append((v.grad, sigma.grad))
    _assert_grads_close(grads[0], grads[1], SOFT_GRAD_RTOL)


def test_soft_large_mesh_renders_in_one_launch(dev):
    """A sphere of 2 * 157^2 = 49,298 triangles, above the JAX package's
    per-pass cap of 49,152, renders in one launch per kernel at 64x64."""
    sphere = test_utils.soft_scene("sphere", dev)
    assert sphere.table.shape[1] == 49298
    before = _soft_launches()
    k7, alpha, _ = test_utils.compare_soft_forward(sphere)
    test_utils.compare_soft_backward(
        sphere, k7, alpha, test_utils.soft_cotangents(1, 64, 64, dev))
    assert _soft_launches() == tuple(b + 1 for b in before)
    assert 0.2 < float((alpha > 0.5).float().mean()) < 0.9


# Visits that no power of two divides (uneven splits above 64 visits, a
# cluster of 12 CTAs at 45) and chunks 1, 3, 8 and 16 (partial m16 tiles
# and stages).
@pytest.mark.parametrize("visits,chunk", [(4, 8), (7, 4), (512, 8), (45, 1),
                                          (135, 3), (73, 8), (45, 16)])
def test_mxu_edge_kernels_match_plain_versions(dev, visits, chunk):
    data, coeff, pix = me.make_inputs(visits, chunk, dev)
    names = ["mxu_edge_" + v for v in me.VARIANTS]
    before = _launches(*names)
    assert torch.equal(me.launch_fma(data, visits, chunk),
                       me.fold_fma_torch(data, visits, chunk))
    for variant in ("tc_bf16", "tc_tf32x3"):
        kernel = me.launch_tc(coeff, pix, visits, chunk, variant)
        plain = me.fold_tc_torch(coeff, pix, variant)
        torch.cuda.synchronize()
        assert kernel.shape == plain.shape == (1, 2048)
        assert (float((kernel - plain).abs().max())
                <= me.TC_RTOL * float(plain.abs().max()))
    assert _launches(*names) == tuple(n + 1 for n in before)


# (37, 8): one split of 296 triangles, three of the tc kernel's stages of
# 128, the last partial.
@pytest.mark.parametrize("visits,chunk", [
    (64, 8), (512, 8), (12, 16), (37, 8),
    pytest.param(None, 8, id="knife-edge"),
    pytest.param(None, 0, id="depth-ties")])
def test_mxu_full_kernels_match_plain_versions(dev, visits, chunk):
    if visits is None and chunk:  # edges through the tc cull's corners
        data, coeff, visits, chunk = mf.make_knife_edge_inputs(dev)
    elif visits is None:  # copies of each triangle in other splits
        data, coeff, visits, chunk = mf.make_depth_tie_inputs(dev)
    else:
        data, coeff = mf.make_inputs(visits, chunk, dev)
    names = ["mxu_full_" + v for v in mf.VARIANTS]
    before = _launches(*names)
    prod = mf.launch_prod(data, visits, chunk)
    for k, p in zip(prod, mf.zbuffer_prod_torch(data)):
        assert torch.equal(k, p)
    assert int((prod[1] >= 0).sum()) > 0
    mf.check_tc(mf.launch_tc(coeff, visits, chunk),
                mf.tc_pairs(coeff, visits, chunk))
    assert _launches(*names) == tuple(n + 1 for n in before)
    # prod at every visit split that divides the visits, up to 8, and each
    # group and split of K3's cluster: the same outputs.
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    shape = mf.prod_shape(visits, chunk, dev)
    assert shape["splits"] == mf.prod_splits(visits, sms)
    assert (shape["group"], shape["split"]) == rb.launch_rule(
        shape["splits"], visits // shape["splits"] * chunk, 128, 16, sms,
        shape["slots"])
    for splits in (d for d in range(1, 9) if visits % d == 0):
        for group, split in test_utils.bary_shapes()[1:]:
            forced = mf.launch_prod(data, visits, chunk,
                                    (splits, group, split))
            for k, p in zip(forced, prod):
                assert torch.equal(k, p)
    with pytest.raises(ValueError, match="multiple of 8"):
        mf.launch_tc(coeff[:visits * 5 * 4], visits, 4)


@pytest.mark.parametrize("size", [64, 256])
def test_patch_eval_kernel_matches_plain_version(dev, size):
    scene = scenes.build_scene(2, dev)
    rows, bbox = ps.pack(scenes.clip_vertices(scene, size),
                         scene["triangles"])
    table, _, n_dropped = ps.plan(rows, bbox, size, (16, 8), 32, 4)
    assert int(n_dropped.sum()) == 0
    (before,) = _launches("patch_eval")
    kernel = ps.launch_patch_eval(table, size, (16, 8))
    assert _launches("patch_eval") == (before + 1,)
    plain = ps.patch_eval_torch(table, size, (16, 8))
    for k, p in zip(kernel, plain):
        assert torch.equal(k, p)
    assert int((kernel[0] < 2.0).sum()) > 0


@pytest.mark.parametrize("config", ["headline", "stress"])
def test_patch_scatter_merges_equal_the_production_forward(dev, config):
    result, table = ps.run(config, batch=1, iters=1, windows=1,
                           device="cuda")
    assert table.is_cuda and table.shape[-1] == ps.TABLE_COLS
    assert result["capped_or_overflowed_triangles"] == 0
    assert result["id_mismatch_px"] == result["scatter_id_mismatch_px"] == 0
    assert result["bc_max_err"] <= 1e-6 and result["z_max_err"] <= 1e-6


def test_microbench_wrappers_reject_what_the_kernels_do_not_take(
        dev, monkeypatch):
    data, coeff, pix = me.make_inputs(4, 8, dev)
    with pytest.raises(ValueError, match="CUDA"):
        me.launch_fma(data.cpu(), 4, 8)
    with pytest.raises(ValueError, match="shape"):
        me.launch_fma(data, 5, 8)
    with pytest.raises(TypeError, match="float32"):
        me.launch_tc(coeff.double(), pix, 4, 8, "tc_tf32x3")
    with pytest.raises(ValueError, match="tensor-core"):
        me.launch_tc(coeff, pix, 4, 8, "fma")
    with pytest.raises(ValueError, match="CUDA"):
        ps.launch_patch_eval(torch.zeros(1, 8, 20), 64, (16, 8))
    # S2's tc computes at its own pixel scale, whose centres are TF32-exact,
    # and refuses any other.
    full_coeff = mf.make_inputs(8, 8, dev)[1]
    monkeypatch.setattr(common, "PIXEL_SCALE", 2.0 / 500)
    with pytest.raises(RuntimeError, match="mxu_full_tc launch"):
        mf.launch_tc(full_coeff, 8, 8)


def test_device_profile_falls_back_to_cuda_events(dev):
    # The microbenchmark kernel fma at its headline shape, twice a call,
    # profiled and, as when the profiler records no kernel, by held CUDA
    # events. The profiler now and then drops a kernel of a long session,
    # so a call of one kernel could count 0.9 kernels a call over 20.
    data = me.make_inputs(512, 8, dev)[0]

    def fn():
        me.launch_fma(data, 512, 8)
        return me.launch_fma(data, 512, 8)

    by_name, total, count = common.device_profile(fn, iters=20)
    assert common.EVENTS_ONLY not in by_name and count >= 1 and total > 0
    by_name, events, count = common.device_profile(fn, iters=20, attempts=0)
    assert by_name == {common.EVENTS_ONLY: events} and count != count
    # The events also count the gaps between back-to-back kernels.
    assert 0.9 * total <= events <= 1.5 * total + 0.01


def _cube_fit(dev, silhouette):
    """(loss_fn, start vertices, batch) of a 32x32 cube fit to a target
    render of the cube moved by (0.05, -0.04, 0.03)."""
    f32 = dict(dtype=torch.float32, device=dev)
    v, t, n = (a.to(dev) for a in shapes.cube(2.0))
    eye, center, up = (torch.tensor([[2.0, 3.0, 6.0]], **f32),
                       torch.zeros(1, 3, **f32),
                       torch.tensor([[0.0, 1.0, 0.0]], **f32))

    def render(vertices):
        if silhouette:
            return soft_mesh_renderer.render_silhouette(
                vertices, t, eye, center, up, 32, 32, sigma_val=1e-4)
        return mesh_renderer.render(
            vertices, t.flip(1).contiguous(), n[None],
            torch.ones_like(vertices), eye, center, up, eye[:, None],
            torch.ones(1, 1, 3, **f32), 32, 32)

    def loss_fn(params, batch):
        return torch.mean((render(params[0]) - batch["target"]) ** 2)

    with torch.no_grad():
        target = render(v[None] + torch.tensor([0.05, -0.04, 0.03], **f32))
    return loss_fn, v[None], {"target": target}


@pytest.mark.parametrize("silhouette", [False, True])
def test_captured_train_step_and_loop_match_eager_steps(dev, silhouette):
    loss_fn, start, batch = _cube_fit(dev, silhouette)

    def fresh():
        param = start.clone().requires_grad_(True)
        return param, torch.optim.Adam([param], lr=1e-2, capturable=True)

    param, optimizer = fresh()
    eager = []
    for _ in range(4):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn([param], batch)
        loss.backward()
        optimizer.step()
        eager.append(loss.detach())
    eager = torch.stack(eager)
    param_step, optimizer = fresh()
    step = parallel.make_train_step(loss_fn, optimizer)
    stepped = torch.stack([step(batch) for _ in range(4)])
    assert step.graph is not None
    param_loop, optimizer = fresh()
    looped = parallel.make_train_loop(loss_fn, optimizer, 4)(batch)
    for losses, p in ((stepped, param_step), (looped, param_loop)):
        torch.testing.assert_close(losses, eager, rtol=1e-4, atol=0)
        change = float((param - start).abs().max())
        assert change > 0
        assert float((p - param).abs().max()) <= 1e-4 * change
    # Another batch of the same shapes is copied into the captured inputs;
    # a constant in place of a tensor is refused.
    other = {"target": torch.zeros_like(batch["target"])}
    with torch.no_grad():
        want = float(loss_fn([param_step], other))
    assert float(step(other)) == pytest.approx(want, rel=1e-4)
    with pytest.raises(ValueError, match="differs"):
        step({"target": 0.0})


def test_captured_step_and_loop_record_a_replay_span_per_step(dev):
    """Under a profile a captured step call records one `mr.step.replay`
    and a loop call of K steps K, inside one `mr.step` or `mr.loop` each;
    the replays' host seconds and the rest of the calls' add up to the
    calls' (the arithmetic of `replay_host_ms` and `step_prep_host_ms`)."""
    from torch.profiler import ProfilerActivity, profile

    target = torch.linspace(0.0, 1.0, 64, device=dev)

    def loss_fn(params, batch):
        return ((params[0].sin() - batch) ** 2).mean()

    def fresh():
        param = torch.zeros(64, device=dev, requires_grad=True)
        return torch.optim.Adam([param], lr=1e-2, capturable=True)

    step = parallel.make_train_step(loss_fn, fresh())
    loop = parallel.make_train_loop(loss_fn, fresh(), 5)
    step(target), loop(target)  # the warm-ups and captures
    torch.cuda.synchronize()
    for call, span, calls, replays in ((step, "mr.step", 7, 7),
                                       (loop, "mr.loop", 3, 15)):
        profiling.reset()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(calls):
                call(target)
            torch.cuda.synchronize()
        table = profiling.span_table()
        assert table[span][0] == calls
        assert table["mr.step.replay"][0] == replays
        assert table["mr.step.load"][0] == calls
        names = [e.name for e in prof.events()]
        assert names.count("mr.step.replay") == replays
        replay_s = table["mr.step.replay"][1]
        prep_s = table[span][1] - replay_s
        assert 0.0 < replay_s and 0.0 < prep_s
        assert table[span][2] == pytest.approx(
            table[span][1] - replay_s - table["mr.step.load"][1], abs=1e-9)


def test_a_step_that_cannot_be_captured_raises(dev):
    param = torch.zeros(3, device=dev, requires_grad=True)

    def syncs(params, batch):
        if float(params[0].sum()) > 1e9:  # a host sync under capture
            pass
        return (params[0] ** 2).sum()

    step = parallel.make_train_step(
        syncs, torch.optim.Adam([param], lr=0.1, capturable=True))
    with pytest.raises(RuntimeError):
        step(None)
    step = parallel.make_train_step(
        lambda params, batch: (params[0] ** 2).sum(),
        torch.optim.Adam([param], lr=0.1))
    with pytest.raises(ValueError, match="capturable"):
        step(None)


@pytest.mark.parametrize("check", ["debug_tensor", "debug_warn_if",
                                   "debug_check_finite"])
def test_debug_checks_refuse_a_captured_step(dev, check):
    """The host-side checks raise inside a capture; they never skip."""
    from pytorch_mesh_renderer_tpu_torch.utils import debug

    param = torch.zeros(3, device=dev, requires_grad=True)

    def checked(params, batch):
        getattr(debug, check)(params[0], "in the step")
        return (params[0] ** 2).sum()

    step = parallel.make_train_step(
        checked, torch.optim.Adam([param], lr=0.1, capturable=True))
    with pytest.raises(RuntimeError, match="CUDA-graph capture"):
        step(None)


def test_a_replay_keeps_its_constants_after_the_cache_lets_them_go(dev):
    """A captured step reads the tensor that `capture.constant` made for an
    array; the step holds it, so replays stay right after 300 other
    constants pushed it out of the cache and new tensors took the freed
    memory."""
    offset = np.array([0.5, -0.25, 2.0])
    param = torch.zeros(3, device=dev, requires_grad=True)

    def loss_fn(params, batch):
        return ((params[0] - capture.constant(offset, dev)) ** 2).sum()

    step = parallel.make_train_step(loss_fn,
                                    torch.optim.SGD([param], lr=0.1))
    step(None)  # warm-up (one SGD step) and capture
    assert step.graph is not None and len(step.constants) == 1
    for i in range(300):
        capture.constant(np.full(3, 1e3 + i), dev)
    junk = [torch.full((3,), 7e6, device=dev) for _ in range(64)]
    # Each step scales params - offset by 1 - 2 x 0.1.
    want = [0.8 ** (2 * k) * float((offset ** 2).sum()) for k in (1, 2, 3)]
    got = [float(step(None)) for _ in range(3)]
    assert got == pytest.approx(want, rel=1e-5)
    del junk


def test_a_schedule_needs_a_tensor_learning_rate(dev):
    """The capture fixes a float lr: a step after a scheduler changed it
    raises, naming the key. A tensor lr, which the scheduler fills in
    place, follows the schedule in the replays as in eager steps."""
    target = torch.tensor([1.0, -2.0, 0.5], device=dev)

    def loss_fn(params, batch):
        return ((params[0] - batch) ** 2).sum()

    def build(lr):
        param = torch.zeros(3, device=dev, requires_grad=True)
        optimizer = torch.optim.Adam([param], lr=lr, capturable=True)
        schedule = torch.optim.lr_scheduler.StepLR(optimizer, 1, gamma=0.5)
        return param, parallel.make_train_step(loss_fn, optimizer), schedule

    _, step, schedule = build(0.1)
    step(target)
    step(target)  # a replay at the captured lr
    schedule.step()
    with pytest.raises(ValueError, match="'lr' changed"):
        step(target)
    runs = []
    for captured in (False, True):
        param, step, schedule = build(torch.tensor(0.1, device=dev))
        run_losses = []
        for _ in range(4):
            run_losses.append(step(target) if captured
                              else step.run_eager(target))
            schedule.step()
        assert captured == (step.graph is not None)
        runs.append((torch.stack(run_losses), param.detach()))
    torch.testing.assert_close(runs[1], runs[0], rtol=1e-6, atol=0)


def test_examples_run_through_the_kernels(dev, tmp_path):
    """The flagship fit (20 epochs at 64x64) and the cube rotation (5
    steps) with `--device cuda`: finite results, and each launched its
    kernels (K5/K6; K1/K2)."""
    from pytorch_mesh_renderer_tpu_torch.examples import (
        fit_shape_multiview, optimize_cube_rotation)

    before = _launches("soft_sil_fwd", "soft_sil_bwd")
    fit = fit_shape_multiview.main([
        "--epochs", "20", "--size", "64", "--resolution", "12",
        "--preview-every", "10", "--out-prefix", str(tmp_path / "fit"),
        "--device", "cuda"])
    after = _launches("soft_sil_fwd", "soft_sil_bwd")
    assert after[0] > before[0] and after[1] > before[1]
    assert fit["targets_from_file"]
    assert [p["epoch"] for p in fit["previews"]] == [0, 10, 19]
    assert np.isfinite(fit["vertices"]).all()
    assert (tmp_path / "fit_final.obj").exists()

    before = _launches("rasterize_fused_fwd", "rasterize_fused_bwd")
    cube = optimize_cube_rotation.main([
        "--steps", "5", "--size", "64",
        "--out-video", str(tmp_path / "cube.mp4"),
        "--out-plot", str(tmp_path / "cube.png"), "--device", "cuda"])
    after = _launches("rasterize_fused_fwd", "rasterize_fused_bwd")
    assert after[0] > before[0] and after[1] > before[1]
    assert np.isfinite(cube["losses"]).all() and len(cube["losses"]) == 5


HARD_EXAMPLES = {
    "render_teapot_hard": ["--width", "64", "--height", "48", "--out",
                           "teapot.png"],
    "optimize_cube_rotation": ["--steps", "3", "--size", "32",
                               "--out-video", "cube.mp4", "--out-plot",
                               "cube.png"],
    "optimize_teapot_rotation": ["--steps", "3", "--size", "32",
                                 "--out-video", "teapot.mp4", "--out-plot",
                                 "teapot.png"],
    "optimize_camera_pose": ["--steps", "3", "--width", "32", "--height",
                             "24", "--target", "no_target.png",
                             "--out-video", "pose.mp4", "--out-plot",
                             "pose.png"]}


@pytest.mark.parametrize("example", sorted(HARD_EXAMPLES))
def test_the_hard_examples_shade_through_the_kernels(dev, tmp_path,
                                                     monkeypatch, example):
    """Every example of the hard renderer shades through the kernel pair
    on the card and never through the plain ops."""
    import importlib

    module = importlib.import_module(
        "pytorch_mesh_renderer_tpu_torch.examples." + example)
    monkeypatch.chdir(tmp_path)
    unfused = profiling.counters().get("shade.unfused", 0)
    (before,) = _launches("phong_shade_fwd")
    module.main(HARD_EXAMPLES[example] + ["--device", "cuda"])
    torch.cuda.synchronize()
    assert _launches("phong_shade_fwd")[0] > before
    assert profiling.counters().get("shade.unfused", 0) == unfused


def test_fit_checkpoint_moves_between_cpu_and_card(dev, tmp_path):
    """A checkpoint saved on the CPU (Adam not capturable) resumes on the
    card through the captured loop, and the card's (capturable) resumes
    on the CPU: each invocation runs its epochs from the saved step."""
    from pytorch_mesh_renderer_tpu_torch.examples import fit_shape_multiview

    def fit(epochs, device):
        return fit_shape_multiview.main([
            "--epochs", str(epochs), "--size", "32", "--resolution", "8",
            "--scan-chunk", "2", "--checkpoint", str(tmp_path / "fit.ckpt"),
            "--out-prefix", str(tmp_path / device), "--device", device])

    fit(2, "cpu")
    before = _launches("soft_sil_fwd", "soft_sil_bwd")
    on_card = fit(4, "cuda")
    after = _launches("soft_sil_fwd", "soft_sil_bwd")
    assert after[0] > before[0] and after[1] > before[1]
    back = fit(6, "cpu")
    for result in (on_card, back):
        assert len(result["losses"]) == 2
        assert np.isfinite(result["losses"]).all()
        assert np.isfinite(result["vertices"]).all()
    assert [p["epoch"] for p in back["previews"]] == [5]


def test_pixel_centers_on_the_card_are_ieee_quotients(dev):
    """On CUDA a division by a Python number multiplies by its reciprocal;
    the plain soft version's pixel centres, made on the card, must still
    be the float32 IEEE quotients its kernels compute."""
    f = np.float32
    for width, height, row_offset, full_height in [
            (128, 128, 0, 128), (100, 100, 0, 100), (640, 17, 231, 480)]:
        px, py = sc.pixel_centers(width, height, row_offset, full_height, dev)
        cols = np.arange(width, dtype=f)
        rows = np.arange(height, dtype=f) + f(row_offset)
        np.testing.assert_array_equal(
            px.cpu().numpy(), f(2.0) * (cols + f(0.5)) / f(width) - f(1.0))
        np.testing.assert_array_equal(
            py.cpu().numpy(),
            f(-2.0) * (rows + f(0.5)) / f(full_height) + f(1.0))


# K6 and the silhouette fit's gradient sum in a fixed order: the same bits
# on every call. The scenes: the teapot 256x256 batch 4, the cow fit's
# shape (128x128, 4 views) and the pose cube at its nearest-edge ties.
K6_SCENES = ("teapot 256", "fit 128", "pose_tie")


def _k6_scene(name, dev):
    """(table, params, width, height) of a K6_SCENES scene."""
    if name == "pose_tie":
        scene = test_utils.soft_scene(name, dev)
        return scene.table, scene.params, scene.width, scene.height
    size = int(name.split()[-1])
    table, _, params = soft_work.scene_table(name, dev)
    return table, params, size, size


@pytest.mark.parametrize("scene", K6_SCENES)
def test_k6_repeats_bit_for_bit_and_matches_its_plain_version(dev, scene):
    table, params, width, height = _k6_scene(scene, dev)
    alpha = sc.launch_sil_fwd(table, params, width, height, height)
    d_alpha = test_utils.soft_cotangents(table.shape[0], height, width,
                                         dev)[..., 3].contiguous()
    runs = [sc.launch_sil_bwd(table, params, alpha, d_alpha, height)
            for _ in range(3)]
    for dtable, dsigma in runs[1:]:
        assert torch.equal(dtable, runs[0][0])
        assert torch.equal(dsigma, runs[0][1])
    plain = sc.soft_silhouette_backward_torch_packed(
        table, params[0], params[2], height, width, 0, height, d_alpha)
    test_utils.grad_errors("dtable", runs[0][0], plain[0], SOFT_GRAD_RTOL,
                           test_utils.SOFT_DTABLE_GROUPS)
    test_utils.grad_errors("dsigma", runs[0][1].sum(), plain[1],
                           SOFT_GRAD_RTOL)
    assert float(runs[0][0][..., 9:15].abs().max()) > 0.0
    untouched = torch.cat([runs[0][0][..., :9], runs[0][0][..., 15:]], -1)
    assert torch.equal(untouched, torch.zeros_like(untouched))


def test_k6_in_row_chunks_matches_its_plain_version(dev):
    """Past its scratch K6 runs the rows in chunks, a K6 and a reduce
    launch each: given an eighth of the scratch that holds the teapot's
    rows in one launch, the gradients still match the plain version,
    repeat bit for bit, and take one launch count; a scratch too small
    for one row raises."""
    table, params, width, height = _k6_scene("teapot 256", dev)
    alpha = sc.launch_sil_fwd(table, params, width, height, height)
    d_alpha = test_utils.soft_cotangents(table.shape[0], height, width,
                                         dev)[..., 3].contiguous()
    whole = kernels.load_library().soft_sil_bwd_scratch_floats(
        table.shape[0], table.shape[1], width, height, 0)
    (before,) = _launches("soft_sil_bwd")
    runs = [sc.launch_sil_bwd(table, params, alpha, d_alpha, height,
                              scratch=torch.empty(whole // 8, device=dev))
            for _ in range(2)]
    assert _launches("soft_sil_bwd") == (before + 2,)
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    plain = sc.soft_silhouette_backward_torch_packed(
        table, params[0], params[2], height, width, 0, height, d_alpha)
    test_utils.grad_errors("dtable", runs[0][0], plain[0], SOFT_GRAD_RTOL,
                           test_utils.SOFT_DTABLE_GROUPS)
    test_utils.grad_errors("dsigma", runs[0][1].sum(), plain[1],
                           SOFT_GRAD_RTOL)
    with pytest.raises(RuntimeError):
        sc.launch_sil_bwd(table, params, alpha, d_alpha, height,
                          scratch=torch.empty(8, device=dev))


def test_captured_fit_step_repeats_bit_for_bit(dev):
    """Two captured silhouette fits (the flagship's step at its shape) from
    one start end bit for bit equal, and equal an eager run."""
    from pytorch_mesh_renderer_tpu_torch.examples import fit_shape_multiview

    problem = fit_shape_multiview.Problem(fit_shape_multiview.parse_args(
        ["--size", "128", "--resolution", "24"]), dev)

    def run(captured):
        offsets = torch.zeros_like(problem.verts0, requires_grad=True)
        optimizer = torch.optim.Adam([offsets], lr=1e-2, capturable=True)
        step = parallel.make_train_step(problem.loss, optimizer)
        call = step if captured else step.run_eager
        losses = torch.stack([call(problem.targets) for _ in range(6)])
        return losses, offsets.detach()

    first, second, eager = run(True), run(True), run(False)
    for other in (second, eager):
        assert torch.equal(first[0], other[0])
        assert torch.equal(first[1], other[1])
    assert float(first[1].abs().max()) > 0.0


def test_a_captured_step_plans_each_per_call_index(dev):
    """A step that makes two indices of the same shape per call (the
    teapot's triangles flipped two ways) captures: at every replay each
    index's gather takes its own plan in the backward, so the captured
    losses and parameters equal the eager ones bit for bit."""
    scene = scenes.build_scene(1, dev)
    tris = scene["triangles"]
    start = scene["vertices"][0].detach()
    weights = torch.linspace(-1.0, 1.0, tris.numel() * 3,
                             device=dev).reshape(*tris.shape, 3)
    batch = torch.zeros(1, device=dev)

    def loss_fn(params, batch):
        first = mesh_ops.gather(params[0], tris.flip(1).contiguous())
        second = mesh_ops.gather(params[0], tris.flip(0).contiguous())
        return ((first * weights).sum() + (second * weights) ** 2).mean()

    def run(captured):
        x = start.clone().requires_grad_(True)
        optimizer = torch.optim.Adam([x], lr=1e-2, capturable=True)
        step = parallel.make_train_step(loss_fn, optimizer)
        call = step if captured else step.run_eager
        losses = torch.stack([call(batch) for _ in range(4)])
        return losses, x.detach()

    captured, eager = run(True), run(False)
    assert bool(torch.isfinite(captured[1]).all())
    assert torch.equal(captured[0], eager[0])
    assert torch.equal(captured[1], eager[1])


def _sharded_scenes(dev):
    """The cube scene of tests/test_parallel.py at 32x32, batch 4:
    (vertices, triangles CW, attributes, camera matrices, normals)."""
    f32 = dict(dtype=torch.float32, device=dev)
    v, t, n = (a.to(dev) for a in shapes.cube(2.0))
    batch = 4
    angles = torch.stack([torch.linspace(0.1, 0.5, batch),
                          torch.linspace(-0.3, 0.4, batch),
                          torch.zeros(batch)], -1).to(dev)
    rot = camera.euler_matrices(angles)[:, :3, :3]
    verts = torch.einsum("bij,vj->bvi", rot, v)
    normals = torch.einsum("bij,vj->bvi", rot, n)
    cams = camera.clip_space_transforms(
        torch.tensor([[0.0, 0.0, 6.0]] * batch, **f32),
        torch.zeros(batch, 3, **f32),
        torch.tensor([[0.0, 1.0, 0.0]] * batch, **f32),
        torch.full((batch,), 40.0, **f32), torch.full((batch,), 0.01, **f32),
        torch.full((batch,), 10.0, **f32), 32, 32)
    attrs = torch.linspace(0.0, 1.0, v.shape[0] * 3, **f32).reshape(
        1, -1, 3).expand(batch, -1, -1).contiguous()
    return verts, t, attrs, cams, normals


@pytest.mark.parametrize("data,space", [(2, 2), (4, 1), (1, 4)])
def test_sharded_wrappers_on_one_card_equal_the_unsharded_renders(
        dev, data, space):
    """Each cell launches its kernels on the card; the assembled outputs
    equal the unsharded renders bit for bit and the vertex gradients agree
    within the backward gates (the strips' sums add in another order)."""
    from pytorch_mesh_renderer_tpu_torch.ops import soft_rasterize as sr

    verts, t, attrs, cams, normals = _sharded_scenes(dev)
    mesh = parallel.make_mesh(data, space, devices=[dev] * 4)
    background = torch.zeros(3, device=dev)
    colors = torch.full_like(verts, 0.7)
    lights = torch.tensor([[[0.0, 3.0, 3.0]]] * 4, device=dev)
    intensities = torch.ones(4, 1, device=dev)
    cw = t.flip(1).contiguous()
    renders = {
        "hard": (lambda v: rasterize_ops.rasterize(
            v, attrs, cw, cams, 32, 32, background),
                 lambda v: parallel.sharded_rasterize(
            mesh, v, attrs, cw, cams, 32, 32, background), 1e-5),
        "soft": (lambda v: sr.rasterize(
            v, t, normals, colors, lights, intensities, cams, 32, 32, 1e-4,
            1e-4), lambda v: parallel.sharded_soft_rasterize(
            mesh, v, t, normals, colors, lights, intensities, cams, 32, 32,
            1e-4, 1e-4), SOFT_GRAD_RTOL),
        "silhouette": (lambda v: sr.rasterize_silhouette_clip_space_batch(
            camera.transform_homogeneous(cams, v), t, 32, 32, 1e-4),
                       lambda v: parallel.sharded_soft_silhouette(
            mesh, v, t, cams, 32, 32, 1e-4), SOFT_GRAD_RTOL)}
    for name, (single, sharded, rtol) in renders.items():
        grads = []
        kernel = {"hard": "rasterize_fused_fwd", "soft": "soft_fwd",
                  "silhouette": "soft_sil_fwd"}[name]
        for render in (single, sharded):
            v = verts.clone().requires_grad_(True)
            (before,) = _launches(kernel)
            out = render(v)
            grads.append((out, torch.autograd.grad((out ** 2).mean(),
                                                   v)[0]))
        assert _launches(kernel) == (before + data * space,), name
        assert torch.equal(grads[0][0], grads[1][0]), name
        test_utils.grad_errors(name, grads[1][1], grads[0][1], rtol)


def test_a_sharded_step_captures_on_one_card_and_refuses_two_devices(dev):
    """The captured step of a fit through sharded_soft_silhouette on a 2x2
    mesh over the card equals its eager step bit for bit; a capture on a
    mesh over the card and the CPU raises and names the ROADMAP item."""
    verts, t, _, cams, _ = _sharded_scenes(dev)
    with torch.no_grad():
        target = parallel.sharded_soft_silhouette(
            parallel.single_device_mesh(), verts + 0.05, t, cams, 32, 32,
            1e-4)

    def run(mesh, captured):
        param = verts.clone().requires_grad_(True)
        step = parallel.make_train_step(
            lambda params, batch: torch.mean((parallel.sharded_soft_silhouette(
                mesh, params[0], t, cams, 32, 32, 1e-4) - batch) ** 2),
            torch.optim.Adam([param], lr=1e-2, capturable=True))
        call = step if captured else step.run_eager
        return torch.stack([call(target) for _ in range(4)]), param.detach()

    mesh = parallel.make_mesh(2, 2, devices=[dev] * 4)
    captured, eager = run(mesh, True), run(mesh, False)
    assert torch.equal(captured[0], eager[0])
    assert torch.equal(captured[1], eager[1])
    with pytest.raises(RuntimeError, match="multi-card capture"):
        run(parallel.make_mesh(2, 1, devices=[dev, torch.device("cpu")]),
            True)


@pytest.mark.parametrize("world", [2, 4])
def test_captured_steps_across_ranks_equal_eager_and_unsharded_steps(
        dev, world, tmp_path):
    """`utils/ranks.py`'s small job on `world` gloo ranks sharing the card:
    in each rank the step captures as a chain of three graphs cut at the
    two gathers (the image's assemble, then the gradients' replicated).
    For the cow fit, 3 captured steps and one make_train_loop call of 3
    equal 3 run_eager steps bit for bit, the ranks are equal, and they
    equal 3 unsharded captured steps bit for bit; a capture that meets
    other gathers than its warm-up, or waits for the card, raises in every
    rank. The hard step (K2 adds with atomics): the ranks bit for bit
    equal, the captured steps within 1e-5 of the vertices' max change of
    the unsharded captured steps."""
    from pytorch_mesh_renderer_tpu_torch.utils import ranks

    kernels.build()  # before the ranks, which load it
    results = ranks.run(world, str(tmp_path), device="cuda", timeout=240.0)
    steps = ranks.STEPS["small"]
    cases = ranks.case_fns("small", dev, world)
    for case in ranks.STEP_CASES:
        (mesh,) = ranks.PLAN[("small", world)][case]
        per_rank = [r[f"{case}/{mesh}"] for r in results]
        first = per_rank[0]
        for entry in per_rank:
            assert entry["graphs"] == 3
            assert [g[0] for g in entry["gathers"]] == ["assemble",
                                                         "replicated"]
            assert entry["gathers"] == first["gathers"]
            for how in ("step", "loop"):
                for key in ("losses", "offsets"):
                    assert torch.equal(entry[how][key], first[how][key])
                    if case == "steps":
                        assert torch.equal(entry[how][key], entry[key])
            assert entry["captured_ms"] > 0.0 and entry["wait_ms"] >= 0.0
            if case == "steps":
                # A capture that fails raises in every rank; none hangs.
                errors = entry["capture_errors"]
                assert "where the warm-up met 2" in errors["mismatch"]
                assert errors["sync"] is not None
        if case == "steps":
            setup = ranks.fit_setup(ranks.fit_problem("small", dev, None),
                                    dev)
        else:
            setup = ranks.hard_setup(cases["hard"], None)
        start = setup[1].detach().clone()
        losses, params, chain = ranks.run_steps(setup, steps, "step")
        assert len(chain.graphs) == 1 and chain.gathers == ()
        got_losses, got = first["step"]["losses"], first["step"]["offsets"]
        if case == "steps":
            assert torch.equal(got_losses, losses.cpu())
            assert torch.equal(got, params.cpu())
        else:
            change = float((params - start).abs().max())
            assert change > 0.0
            assert float((got - params.cpu()).abs().max()) <= 1e-5 * change
            torch.testing.assert_close(got_losses, losses.cpu(), rtol=1e-5,
                                       atol=0)


def test_backward_kernels_run_to_run_spread_is_recorded(dev):
    """K8, K2 and K4 keep their float atomics (ROADMAP Queue 3, known
    nondeterministic reductions): their run-to-run spread, max |a - b|
    over max |a| between two calls on the teapot, is printed, not
    gated."""
    teapot = scenes.build_scene(4, dev)
    table, lights, params = soft_work.teapot_table(256, dev)
    (rgba, run_max, sum_w), d_rgba = soft_work.forward_residuals(
        table, lights, params, 256)
    clip = scenes.clip_vertices(teapot, 256)
    rows, inv_abs_det = rc.pack_rows(clip, teapot["triangles"], True)
    corner = rc.pack_corner_attributes(
        torch.cat([teapot["normals"], teapot["diffuse"],
                   teapot["vertices"]], -1), teapot["triangles"])
    ids, bc, _ = rc.launch_fused_fwd(rows, corner, 256, 256, 0, 256, False)
    g_bc, g_attr = _cotangents(ids, corner.shape[-1])
    calls = {
        "soft_bwd": lambda: sc.launch_soft_bwd(
            table, lights, params, rgba, run_max, sum_w, d_rgba, 256)[0],
        "rasterize_fused_bwd": lambda: rc.launch_fused_bwd(
            ids, bc, g_bc, g_attr, rows, inv_abs_det, corner),
        "rasterize_bary_bwd": lambda: rb.launch_bary_bwd(
            ids[:1], bc[:1], g_bc[:1], rows[:1], inv_abs_det[:1])}
    for name, call in calls.items():
        a, b = call(), call()
        torch.cuda.synchronize()
        assert bool(torch.isfinite(a).all()) and float(a.abs().max()) > 0
        spread = float((a - b).abs().max() / a.abs().max())
        print(f"{name}: run-to-run spread {spread:.3g} of max |value|")


TEAPOT_LIGHTS = ((-2.0, 2.0, 4.0), (3.0, -1.0, 4.0), (0.0, 3.0, 2.0))


def _shading_operands(scene, lights, ambient, dev):
    """`test_utils.shading_scene`'s operands; on "shared_lights" those of
    "random" with lights of shape [1, L, 3] shared by the batch, which the
    plain ops broadcast; on "teapot" the bench teapot's rasterized
    [4, 256, 256, 9] attributes (normal, position, diffuse over background
    -1, as `mesh_renderer.render` rasterizes them) under the first
    `lights` of TEAPOT_LIGHTS."""
    if scene == "shared_lights":
        attrs, light_pos, light_int, amb = test_utils.shading_scene(
            "random", lights, ambient, dev)
        return attrs, light_pos[:1], light_int[:1], amb
    if scene != "teapot":
        return test_utils.shading_scene(scene, lights, ambient, dev)
    teapot = scenes.build_scene(4, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    ones = torch.ones(4, **f32)
    cams = camera.clip_space_transforms(
        teapot["eye"], teapot["center"], teapot["up"], 40.0 * ones,
        0.01 * ones, 10.0 * ones, 256, 256)
    attrs = rasterize_ops.rasterize(
        teapot["vertices"], torch.cat([teapot["normals"], teapot["vertices"],
                                       teapot["diffuse"]], 2),
        teapot["triangles"], cams, 256, 256, torch.full((9,), -1.0, **f32))
    light_pos = torch.tensor([TEAPOT_LIGHTS[:lights]] * 4, **f32)
    amb = torch.tensor([[0.1, 0.2, 0.05]] * 4, **f32) if ambient else None
    return attrs, light_pos, torch.full((4, lights, 3), 0.8, **f32), amb


@pytest.mark.parametrize("ambient", [False, True])
@pytest.mark.parametrize("lights", [1, 2, 3])
@pytest.mark.parametrize("scene", test_utils.SHADING_SCENES
                         + ("shared_lights", "teapot"))
def test_shading_kernels_match_the_plain_ops(dev, scene, lights, ambient):
    """The fused forward against `_shade_torch` (max abs 1e-6; the count of
    elements whose bits differ is printed), the fused backward against
    autograd through it and against `phong_diffuse_backward_torch` (per
    pixel 1e-5, NaN at the same places), one launch each way."""
    from pytorch_mesh_renderer_tpu_torch.ops import shading

    attrs, light_pos, light_int, amb = _shading_operands(scene, lights,
                                                         ambient, dev)
    d_images = test_utils.soft_cotangents(*attrs.shape[:3], dev)
    plain_x = attrs.clone().requires_grad_(True)
    plain = mesh_renderer._shade_torch(plain_x, light_pos, light_int, None,
                                       None, None, amb)
    (plain * d_images).sum().backward()
    before = _launches("phong_shade_fwd", "phong_shade_bwd")
    fused_x = attrs.clone().requires_grad_(True)
    fused = shading.phong_shade_cuda(fused_x, light_pos, light_int, amb)
    (fused * d_images).sum().backward()
    torch.cuda.synchronize()
    assert _launches("phong_shade_fwd", "phong_shade_bwd") == (
        before[0] + 1, before[1] + 1)
    assert fused.shape == plain.shape
    assert float((fused - plain).abs().max()) <= test_utils.SHADING_IMAGE_ATOL
    print(f"{scene} L={lights} ambient={ambient}: "
          f"{int((fused != plain).sum())} of {fused.numel()} image values "
          "differ in their bits")
    written_out = shading.phong_diffuse_backward_torch(
        attrs, light_pos, light_int, amb, d_images)
    for want in (plain_x.grad, written_out):
        assert test_utils.shading_gradient_gap(
            fused_x.grad, want) <= test_utils.SHADING_GRAD_RTOL
    assert bool((fused_x.grad[..., 9:] == 0.0).all())


def test_a_captured_hard_step_shades_through_the_kernels(dev):
    """The captured hard step launches each shading kernel once at its
    capture and never at a replay, takes no plain shading, and equals its
    eager steps within the hard backward's 1e-4 (K2's atomics)."""
    loss_fn, start, batch = _cube_fit(dev, silhouette=False)
    param = start.clone().requires_grad_(True)
    optimizer = torch.optim.SGD([param], lr=0.1)
    eager = []
    for _ in range(4):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn([param], batch)
        loss.backward()
        optimizer.step()
        eager.append(loss.detach())
    names = ("phong_shade_fwd", "phong_shade_bwd")
    unfused = profiling.counters().get("shade.unfused", 0)
    captured = start.clone().requires_grad_(True)
    step = parallel.make_train_step(loss_fn,
                                    torch.optim.SGD([captured], lr=0.1))
    before = _launches(*names)
    losses = [step(batch)]  # an eager step, then the capture
    assert step.graph is not None
    assert _launches(*names) == (before[0] + 2, before[1] + 2)
    losses += [step(batch) for _ in range(3)]
    torch.cuda.synchronize()
    assert _launches(*names) == (before[0] + 2, before[1] + 2)
    assert profiling.counters().get("shade.unfused", 0) == unfused
    torch.testing.assert_close(torch.stack(losses), torch.stack(eager),
                               rtol=1e-4, atol=0)
    change = float((param - start).abs().max())
    assert change > 0.0
    assert float((captured - param).abs().max()) <= 1e-4 * change


def test_shade_unfused_counts_specular_and_light_gradient_calls(dev):
    """Specular shading and gradients wanted for the lights or the ambient
    colour take the plain ops and count one `shade.unfused` a call; a light
    that requires a gradient under `no_grad` wants none and takes the
    kernels."""
    f32 = dict(dtype=torch.float32, device=dev)
    v, t, n = (a.to(dev) for a in shapes.cube(2.0))
    lights = torch.tensor([[[0.0, 0.0, 6.0]]], **f32)
    intensities = torch.ones(1, 1, 3, **f32)
    ambient = torch.full((1, 3), 0.1, **f32)

    def render(**kwargs):
        scene = dict(light_positions=lights, light_intensities=intensities,
                     ambient_color=ambient)
        scene.update(kwargs)
        return mesh_renderer.render(
            v[None], t.flip(1).contiguous(), n[None], torch.ones_like(v[None]),
            torch.tensor([2.0, 3.0, 6.0], **f32), torch.zeros(3, **f32),
            torch.tensor([0.0, 1.0, 0.0], **f32), image_width=32,
            image_height=24, **scene)

    def counts():
        c = profiling.counters()
        return (c.get("shade.unfused", 0), c.get("launches.phong_shade_fwd",
                                                 0))

    cases = [dict(specular_colors=torch.ones_like(v[None]),
                  shininess_coefficients=torch.full((1,), 4.0, **f32))]
    for name in ("light_positions", "light_intensities", "ambient_color"):
        wanting = {"light_positions": lights, "light_intensities": intensities,
                   "ambient_color": ambient}[name].clone().requires_grad_(True)
        cases.append({name: wanting})
    for kwargs in cases:
        before = counts()
        image = render(**kwargs)
        assert counts() == (before[0] + 1, before[1])
        wanting = [x for x in kwargs.values() if x.requires_grad]
        if wanting:
            image[..., :3].sum().backward()
            assert bool(torch.isfinite(wanting[0].grad).all())
            assert float(wanting[0].grad.abs().max()) > 0.0
    before = counts()
    with torch.no_grad():
        fused = render(light_positions=lights.clone().requires_grad_(True))
    assert counts() == (before[0], before[1] + 1)
    assert torch.equal(fused, render())


def test_the_shading_follows_the_backend(dev):
    """backend='torch' shades through the plain ops, forward and backward,
    launching no shading kernel and counting one `shade.unfused` a call;
    backend='cuda' launches the pair. (That 'cuda' raises for what the
    pair does not shade is tests/test_torch_shading.py's.)"""
    f32 = dict(dtype=torch.float32, device=dev)
    v, t, n = (a.to(dev) for a in shapes.cube(2.0))
    lights = torch.tensor([[[0.0, 0.0, 6.0]]], **f32)
    intensities = torch.ones(1, 1, 3, **f32)
    ambient = torch.full((1, 3), 0.1, **f32)
    names = ("phong_shade_fwd", "phong_shade_bwd")

    grads = {}
    for backend in ("torch", "cuda"):
        vertices = v[None].clone().requires_grad_(True)
        unfused = profiling.counters().get("shade.unfused", 0)
        before = _launches(*names)
        image = mesh_renderer.render(
            vertices, t.flip(1).contiguous(), n[None],
            torch.ones_like(v[None]), torch.tensor([2.0, 3.0, 6.0], **f32),
            torch.zeros(3, **f32), torch.tensor([0.0, 1.0, 0.0], **f32),
            lights, intensities, 32, 24, ambient_color=ambient,
            config=config_lib.HardRasterizerConfig(backend=backend))
        (image[..., :3] ** 2).mean().backward()
        torch.cuda.synchronize()
        launched = tuple(a - b for a, b in zip(_launches(*names), before))
        assert launched == ((0, 0) if backend == "torch" else (1, 1))
        assert profiling.counters().get("shade.unfused", 0) == unfused + (
            backend == "torch")
        grads[backend] = vertices.grad
    scale = float(grads["torch"].abs().max())
    assert scale > 0.0
    assert float((grads["cuda"] - grads["torch"]).abs().max()) <= (
        1e-5 * scale)


def _recon_images(objects, size):
    """[objects, 24, 4, S, S] uint8: random colours, alpha a disc."""
    g = torch.Generator().manual_seed(7)
    rgb = torch.rand(objects, 24, 3, size, size, generator=g)
    centre = torch.rand(objects, 24, 2, 1, 1, generator=g) * 0.4 - 0.2
    radius = torch.rand(objects, 24, 1, 1, generator=g) * 0.3 + 0.3
    c = (torch.arange(size) + 0.5) * 2 / size - 1
    d2 = ((c[None, None, :, None] - centre[:, :, 0]) ** 2
          + (c[None, None, None, :] - centre[:, :, 1]) ** 2)
    alpha = (d2 < radius ** 2).to(torch.float32)[:, :, None]
    return (torch.cat([rgb, alpha], 2) * 255).round().to(torch.uint8)


def test_captured_recon_step_equals_eager_steps_and_never_syncs(dev):
    """SoftRas's reconstruction step (`examples/recon.py`) at the
    published widths, 8 objects a batch (32 silhouettes of 64^2), cuDNN
    deterministic and TF32 off: the warm-up step and three captured
    replays equal four `step.run_eager` calls on the same batches bit for
    bit (losses, parameters, BatchNorm's statistics), and ten more loader
    draws and replays add no `host_syncs.*` count."""
    from pytorch_mesh_renderer_tpu_torch.examples import recon

    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cuda.matmul.allow_tf32 = False
    images = _recon_images(6, 64)
    try:
        def run(captured):
            torch.manual_seed(0)
            net = recon.ReconstructionNet().to(dev)
            loader = recon.Loader(images, recon.viewpoints(), 8, 5, dev)
            trainer = recon.Reconstruction(net)
            call = trainer if captured else trainer.step.run_eager
            losses = torch.stack([call(loader()) for _ in range(4)])
            torch.cuda.synchronize()
            return (losses, {k: v.detach().clone()
                             for k, v in net.state_dict().items()},
                    trainer, loader)

        captured, eager = run(True), run(False)
        assert torch.equal(captured[0], eager[0])
        for name, value in captured[1].items():
            assert torch.equal(value, eager[1][name]), name
        trainer, loader = captured[2], captured[3]
        assert trainer.step.graph is not None
        syncs = {k: n for k, n in profiling.counters().items()
                 if k.startswith("host_syncs.")}
        for _ in range(10):
            loss = trainer(loader())
        torch.cuda.synchronize()
        assert bool(torch.isfinite(loss))
        assert {k: n for k, n in profiling.counters().items()
                if k.startswith("host_syncs.")} == syncs
    finally:
        (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic,
         torch.backends.cuda.matmul.allow_tf32) = saved
