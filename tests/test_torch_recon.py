"""SoftRas's single-view reconstruction on the port
(`examples/recon.py`): the closed icosphere, the edge-wing plan, the
batched losses and the training step, on the CPU, against the plain
reference `tests/recon_reference.py` (SoftRas's own forms) and against
values worked out by hand.

Tolerances, with their reasons:
  * the losses vs SoftRas's forms and the hand values: rtol 1e-5 (float32
    sums in another order; the tetrahedron's flatten loss moves by the
    eps of 1e-6 that SoftRas adds to each length and angle);
  * the gradients of the losses: `torch.autograd.gradcheck` in float64 at
    its defaults;
  * the step vs the reference, loss at each of three steps: rtol 1e-5. The
    silhouettes differ only by the order of float32 operations (the
    reference multiplies the coverage chunk by chunk, the port triangle by
    triangle; its camera is a matrix product, the port's a sum in order);
  * each parameter's gradient at step 1: |g - g_ref| within 1e-4 of
    |g_ref| plus 1e-6 of the whole gradient's norm. The measured gaps are
    1.1e-6-9.6e-6 relative at 16^2 and narrow widths, 9.8e-6-3.0e-5 at
    64^2 and the published widths (a float32 network of 26 M parameters;
    64^2 gives fc1 the published 256 x 8 x 8 = 16,384 inputs). The
    convolutions' biases ahead of BatchNorm have a gradient that is 0 in
    exact arithmetic (BatchNorm takes the batch's mean out): the
    reference reads norms of 7.6e-11-9.7e-10 there, round-off, which the
    second term covers;
  * the change of each parameter over three Adam steps: its norm gap
    within 1e-2 of the reference change's norm (measured: up to 1.9e-5 at
    16^2, 1.3e-5 to 1.0e-3 at 64^2; Adam moves an element whose gradient
    is near 0 by the sign of its
    round-off, up to lr a step, and a few elements in a small leaf such as
    a BatchNorm bias set its gap). The convolutions' biases, whose
    gradients are round-off, are held to Adam's bound: each element within
    2 x 3 steps x lr of the reference.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import recon_reference as ref
from pytorch_mesh_renderer_tpu_torch.examples import recon
from pytorch_mesh_renderer_tpu_torch.models import shapes
from pytorch_mesh_renderer_tpu_torch.ops import losses, mesh
from pytorch_mesh_renderer_tpu_torch.utils import profiling

SETTINGS = dict(fov_y=recon.FOV_Y, near=recon.NEAR_CLIP, far=recon.FAR_CLIP,
                sigma=recon.SIGMA, blur=recon.BLUR_RADIUS,
                lambda_laplacian=recon.LAMBDA_LAPLACIAN,
                lambda_flatten=recon.LAMBDA_FLATTEN)
NARROW = dict(dim1=4, dim2=32, dim_features=16, dim_hidden=(32, 64))
BN_BIASES = ("encoder.conv1.bias", "encoder.conv2.bias",
             "encoder.conv3.bias")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes on one machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _images(objects, size, seed, views=recon.VIEWS):
    """[objects, views, 4, S, S] uint8: random colours, alpha a disc."""
    g = torch.Generator().manual_seed(seed)
    rgb = torch.rand(objects, views, 3, size, size, generator=g)
    centre = torch.rand(objects, views, 2, 1, 1, generator=g) * 0.4 - 0.2
    radius = torch.rand(objects, views, 1, 1, generator=g) * 0.3 + 0.3
    c = (torch.arange(size) + 0.5) * 2 / size - 1
    d2 = ((c[None, None, :, None] - centre[:, :, 0]) ** 2
          + (c[None, None, None, :] - centre[:, :, 1]) ** 2)
    alpha = (d2 < radius ** 2).to(torch.float32)[:, :, None]
    return (torch.cat([rgb, alpha], 2) * 255).round().to(torch.uint8)


def _random_meshes(level, batch, seed):
    v, t, _ = shapes.icosphere(level)
    g = torch.Generator().manual_seed(seed)
    scale = 0.5 + 0.1 * torch.randn(batch, v.shape[0], 1, generator=g)
    return v[None] * scale, t


# ---- the icosphere and the edge-wing plan ---------------------------------


@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_icosphere_is_a_closed_unit_sphere_wound_outward(level):
    v, t, n = shapes.icosphere(level)
    assert v.shape == (10 * 4 ** level + 2, 3)
    assert t.shape == (20 * 4 ** level, 3) and t.dtype == torch.int32
    assert torch.equal(v, n)
    assert float((v.norm(dim=1) - 1).abs().max()) < 1e-6
    corners = v[t.long()]
    normal = torch.linalg.cross(corners[:, 1] - corners[:, 0],
                                corners[:, 2] - corners[:, 0])
    assert bool(((normal * corners.mean(1)).sum(1) > 0).all())
    wings = mesh.compute_edge_wings(t)
    assert wings.shape == (30 * 4 ** level, 4)
    assert v.shape[0] - wings.shape[0] + t.shape[0] == 2  # a sphere
    if level == 3:
        assert (v.shape[0], t.shape[0], wings.shape[0]) == (642, 1280, 1920)


def test_edge_wings_name_both_faces_of_every_edge():
    _, t, _ = shapes.icosphere(2)
    wings = mesh.compute_edge_wings(t)
    assert torch.equal(wings.long(), ref.edge_wings(t))
    faces = {tuple(sorted(f)) for f in t.tolist()}
    for a, b, c, d in wings.tolist():
        assert a < b and c != d
        assert tuple(sorted((a, b, c))) in faces
        assert tuple(sorted((a, b, d))) in faces
    # Each edge borders exactly two faces: 3 T = 2 E.
    assert 3 * t.shape[0] == 2 * wings.shape[0]


def test_edge_wings_refuse_an_open_or_non_manifold_mesh():
    _, open_sphere, _ = shapes.sphere(1.0, 8)  # its seam does not wrap
    with pytest.raises(ValueError, match="borders 1 triangles"):
        mesh.compute_edge_wings(open_sphere)
    fin = [[0, 1, 2], [1, 0, 3], [0, 1, 4]]  # edge (0, 1) in three faces
    with pytest.raises(ValueError, match="borders 3 triangles"):
        mesh.compute_edge_wings(np.asarray(fin))
    _, cube, _ = shapes.cube(2.0)
    assert mesh.compute_edge_wings(cube).shape == (18, 4)


# ---- the batched losses ----------------------------------------------------


def test_flatten_loss_is_zero_on_a_planar_strip():
    """A strip of four triangles in the plane z = 1 (any two share an
    edge flat): each interior edge's (cos + 1)^2 is 0 up to SoftRas's
    eps."""
    xy = torch.tensor([[0.0, 0.0], [1.0, 0.0], [2.0, 0.0], [0.0, 1.0],
                       [1.0, 1.0], [2.0, 1.3]])
    v = torch.cat([xy, torch.ones(6, 1)], 1)[None]
    # Triangles (0, 1, 4), (0, 4, 3), (1, 2, 5), (1, 5, 4): interior
    # edges (0, 4), (1, 4) and (1, 5).
    wings = torch.tensor([[0, 4, 1, 3], [1, 4, 0, 5], [1, 5, 2, 4]])
    assert float(losses.flatten_loss(v, wings)) < 1e-5
    folded = v.clone()
    folded[0, 3, 2] = 2.0  # lift a corner: the strip folds along (0, 4)
    assert float(losses.flatten_loss(folded, wings)) > 1e-2


def test_flatten_loss_of_a_regular_tetrahedron_by_hand():
    """Every dihedral angle of a regular tetrahedron has cosine 1/3: six
    edges of (1/3 + 1)^2 = 16/9 each, 32/3 in all."""
    v = torch.tensor([[1.0, 1.0, 1.0], [1.0, -1.0, -1.0], [-1.0, 1.0, -1.0],
                      [-1.0, -1.0, 1.0]])
    t = torch.tensor([[0, 1, 2], [0, 3, 1], [0, 2, 3], [1, 3, 2]])
    wings = mesh.compute_edge_wings(t)
    assert wings.shape == (6, 4)
    got = losses.flatten_loss(v[None], wings)
    assert float(got) == pytest.approx(32.0 / 3.0, rel=1e-5)
    assert float(ref.flatten_loss(v[None], wings.long())) == pytest.approx(
        float(got), rel=1e-6)


def test_batched_laplacian_is_the_per_mesh_sum_of_squares():
    v, t = _random_meshes(1, 3, 0)
    edges = mesh.compute_edge_wings(t)[:, :2]
    neighbours = [set() for _ in range(v.shape[1])]
    for a, b in edges.tolist():
        neighbours[a].add(b)
        neighbours[b].add(a)
    by_hand = []
    for m in v:
        total = 0.0
        for i, ns in enumerate(neighbours):
            d = m[i] - m[sorted(ns)].mean(0)
            total += float((d * d).sum())
        by_hand.append(total)
    got = losses.squared_laplacian_loss(v, edges)
    assert float(got) == pytest.approx(np.mean(by_hand), rel=1e-5)
    lap = ref.laplacian_matrix(t, v.shape[1])
    assert float(got) == pytest.approx(float(ref.laplacian_loss(v, lap)),
                                       rel=1e-5)


def test_flatten_loss_matches_softras_form_on_a_batch():
    v, t = _random_meshes(2, 4, 1)
    got = losses.flatten_loss(v, mesh.compute_edge_wings(t))
    want = ref.flatten_loss(v, ref.edge_wings(t))
    assert float(got) == pytest.approx(float(want), rel=1e-5)


def test_iou_loss_matches_softras_formula():
    g = torch.Generator().manual_seed(2)
    p = torch.rand(8, 12, 12, generator=g)
    target = (torch.rand(8, 12, 12, generator=g) > 0.5).to(torch.float32)
    got = losses.iou_loss(p, target)
    groups = p.split(2)
    want = ref.multiview_iou_loss(groups, target[:2], target[4:6])
    # The four groups against their own targets: build them as SoftRas
    # pairs them (a, a, b, b).
    t4 = torch.cat([target[:2], target[:2], target[4:6], target[4:6]])
    assert float(losses.iou_loss(p, t4)) == pytest.approx(float(want),
                                                         rel=1e-6)
    by_hand = 1 - np.mean([
        float((p[i] * target[i]).sum())
        / (float((p[i] + target[i] - p[i] * target[i]).sum()) + 1e-6)
        for i in range(8)])
    assert float(got) == pytest.approx(by_hand, rel=1e-5)


def _gradcheck_cases():
    g = torch.Generator().manual_seed(4)
    v, t = _random_meshes(1, 2, 3)
    v = v.double()
    wings = mesh.compute_edge_wings(t)
    p = torch.rand(3, 5, 5, generator=g, dtype=torch.float64) * 0.8 + 0.1
    target = torch.rand(3, 5, 5, generator=g, dtype=torch.float64)
    return {
        "iou": (lambda x: losses.iou_loss(x, target), p),
        "laplacian": (lambda x: losses.squared_laplacian_loss(
            x, wings[:, :2].contiguous()), v),
        "flatten": (lambda x: losses.flatten_loss(x, wings), v),
    }


@pytest.mark.parametrize("name", ["iou", "laplacian", "flatten"])
def test_loss_gradients_pass_gradcheck(name):
    fn, x = _gradcheck_cases()[name]
    assert torch.autograd.gradcheck(fn, (x.clone().requires_grad_(True),))


# ---- the loader ------------------------------------------------------------


def test_the_loader_draws_by_its_rule_and_never_syncs():
    images = _images(5, 8, 0)
    eyes = recon.viewpoints()
    loader = recon.Loader(images, eyes, 3, 77, "cpu")
    g = torch.Generator().manual_seed(77)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            ids = torch.randint(5, (3,), generator=g)
            views = torch.randint(recon.VIEWS, (3, 2), generator=g)
            batch = loader()
            for side in (0, 1):
                got = batch["images"][3 * side:3 * side + 3]
                assert torch.equal(got, images[ids, views[:, side]])
                assert torch.equal(batch["eyes"][3 * side:3 * side + 3],
                                   eyes[views[:, side]])
    assert profiling.span_table()["mr.recon.batch"][0] == 2
    assert not [k for k in profiling.counters() if k.startswith(
        "host_syncs.")]
    profiling.reset()
    assert torch.allclose(eyes.norm(dim=1), torch.full((24,), 2.732))
    assert torch.allclose(eyes[:, 1], torch.full((24,), 2.732 * 0.5))
    with pytest.raises(ValueError):
        recon.Loader(images.float(), eyes, 3, 0, "cpu")


# ---- the step --------------------------------------------------------------


def _port_and_reference(level, size, widths, objects=2, seed=0):
    torch.manual_seed(seed)
    v, t, _ = shapes.icosphere(level)
    net = recon.ReconstructionNet((v, t), image_size=size, **widths)
    start = {k: x.detach().clone() for k, x in net.named_parameters()}
    loader = recon.Loader(_images(3, size, seed + 5), recon.viewpoints(),
                          objects, seed + 11, "cpu")
    batches = [loader() for _ in range(3)]
    step = recon.Reconstruction(net)
    got_losses, got_grad = [], None
    for k, batch in enumerate(batches):
        got_losses.append(float(step(batch)))
        if k == 0:
            got_grad = {n: x.grad.clone() for n, x in net.named_parameters()}
    got_params = {n: x.detach() for n, x in net.named_parameters()}
    adam = ref.Adam(recon.LEARNING_RATE)
    params, want_losses, want_grad = dict(start), [], None
    for k, batch in enumerate(batches):
        leaf = {n: x.clone().requires_grad_(True) for n, x in params.items()}
        loss, _ = ref.step_loss(leaf, batch, v, t, dict(SETTINGS, size=size))
        loss.backward()
        grads = {n: x.grad for n, x in leaf.items()}
        want_grad = grads if k == 0 else want_grad
        want_losses.append(float(loss))
        params = adam.step(params, grads)
    return (start, got_losses, got_grad, got_params, want_losses, want_grad,
            params)


@pytest.mark.parametrize("case", ["narrow_16px_level1",
                                  "published_widths_64px_level3"])
def test_the_step_matches_the_reference(case):
    if case.startswith("narrow"):
        out = _port_and_reference(1, 16, NARROW)
    else:
        out = _port_and_reference(3, 64, {})
    start, got_losses, got_grad, got_params, want_losses, want_grad, \
        want_params = out
    assert got_losses == pytest.approx(want_losses, rel=1e-5)
    total = math.sqrt(sum(float((g * g).sum()) for g in want_grad.values()))
    for name, want in want_grad.items():
        gap = float((got_grad[name] - want).norm())
        assert gap <= 1e-4 * float(want.norm()) + 1e-6 * total, name
    lr = recon.LEARNING_RATE
    for name, want in want_params.items():
        got_change = got_params[name] - start[name]
        want_change = want - start[name]
        if name in BN_BIASES:
            assert float((got_change - want_change).abs().max()) <= 6 * lr
            continue
        gap = float((got_change - want_change).norm())
        assert gap <= 1e-2 * float(want_change.norm()), name


def test_the_step_counts_and_opens_its_spans():
    v, t, _ = shapes.icosphere(1)
    net = recon.ReconstructionNet((v, t), image_size=8, **NARROW)
    loader = recon.Loader(_images(2, 8, 1), recon.viewpoints(), 2, 3, "cpu")
    step = recon.Reconstruction(net)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            loss = step(loader())
    table, counts = profiling.span_table(), profiling.counters()
    profiling.reset()
    for name in ("mr.recon.batch", "mr.recon.encode", "mr.recon.decode",
                 "mr.recon.losses", "mr.step"):
        assert table[name][0] == 2, name
    assert counts["recon.steps"] == 2
    assert counts["recon.silhouettes"] == 2 * 8
    assert step.silhouettes.shape == (8, 8, 8)
    assert bool(torch.isfinite(loss))
