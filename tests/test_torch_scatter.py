"""PyTorch port: the deterministic vertex gather and scatter of
`ops/mesh.py` (`gather`, `segment_sum`, `vertex_plan`).

On the teapot's triangles the scatter equals `index_add` within 1e-6 of
the result's max |value| (another order of the same adds), its gradient
is the gather and the gather's gradient the scatter, the plan of an index
tensor is built once (an int64 index is cast once), and a capture that
meets an index made per call chooses, on the device, the plan of the
same-shaped index whose values it holds.
"""

import numpy as np
import pytest
import torch

from pytorch_mesh_renderer_tpu_torch.ops import losses, mesh
from pytorch_mesh_renderer_tpu_torch.utils import capture, scenes


@pytest.fixture(scope="module")
def teapot():
    """(triangles [T, 3] int32, vertex count, seeded values [2, T, 3, 4])."""
    scene = scenes.build_scene(1, "cpu")
    tris = scene["triangles"]
    rng = np.random.RandomState(3)
    values = torch.tensor(rng.randn(2, tris.shape[0], 3, 4),
                          dtype=torch.float32)
    return tris, scene["vertices"].shape[1], values


def test_segment_sum_equals_index_add_on_the_teapot(teapot):
    tris, n_verts, values = teapot
    got = mesh.segment_sum(values, tris, n_verts)
    want = torch.zeros(2, n_verts, 4).index_add(
        1, tris.long().reshape(-1), values.reshape(2, -1, 4))
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
    # Every vertex that no triangle names sums to exactly 0.
    named = torch.zeros(n_verts, dtype=torch.bool)
    named[tris.long().reshape(-1)] = True
    assert torch.equal(got[:, ~named], torch.zeros_like(got[:, ~named]))


def test_gather_and_segment_sum_are_each_others_gradient(teapot):
    tris, n_verts, values = teapot
    x = torch.randn(2, n_verts, 4, dtype=torch.float64, requires_grad=True)
    weights = values.double()
    (by_gather,) = torch.autograd.grad(
        (mesh.gather(x, tris) * weights).sum(), x)
    (by_indexing,) = torch.autograd.grad(
        (x[:, tris.long()] * weights).sum(), x)
    torch.testing.assert_close(by_gather, by_indexing, rtol=1e-12,
                               atol=1e-12)
    v = weights.clone().requires_grad_(True)
    (by_scatter,) = torch.autograd.grad(
        (mesh.segment_sum(v, tris, n_verts) * x.detach()).sum(), v)
    assert torch.equal(by_scatter, mesh.gather(x.detach(), tris))


def test_a_plan_is_built_once_per_index_tensor(teapot, monkeypatch):
    tris, n_verts, values = teapot
    built = []
    plan_on_host = mesh._plan_on_host
    monkeypatch.setattr(mesh, "_plan_on_host",
                        lambda *args: built.append(1) or plan_on_host(*args))
    tris = tris.clone()  # an index no earlier test planned
    first = mesh.segment_sum(values, tris, n_verts)
    for _ in range(3):
        assert torch.equal(mesh.segment_sum(values, tris, n_verts), first)
        mesh.gather(values[..., 0, :1].contiguous(), tris)
    assert len(built) == 1
    plan = mesh.vertex_plan(tris, n_verts)
    assert plan.slots.shape[0] == n_verts and plan.check is None
    counts = torch.bincount(tris.long().reshape(-1), minlength=n_verts)
    assert torch.equal(plan.degree, counts.float())
    tris.add_(0)  # an in-place write: the index is read anew
    mesh.segment_sum(values, tris, n_verts)
    assert len(built) == 2
    with pytest.raises(ValueError, match="must lie in"):
        mesh.vertex_plan(tris, 3)


def test_an_int64_index_is_cast_and_planned_once(teapot, monkeypatch):
    """The renderers cast triangles with `int32_index`: an int64 index
    keeps one int32 copy and one plan while it lives, and both go when it
    is freed (nothing holds the index alive)."""
    tris, n_verts, values = teapot
    built = []
    build = mesh._build_plan
    monkeypatch.setattr(mesh, "_build_plan",
                        lambda *args: built.append(1) or build(*args))
    wide = tris.long().flip(0)  # values no earlier test planned
    cast = mesh.int32_index(wide)
    assert cast.dtype == torch.int32 and torch.equal(cast.long(), wide)
    assert mesh.int32_index(cast) is cast
    for _ in range(3):
        assert mesh.int32_index(wide) is cast
        mesh.segment_sum(values, mesh.int32_index(wide), n_verts)
    assert len(built) == 1
    cached = len(mesh._INT32), len(mesh._PLANS)
    del wide, cast
    assert (len(mesh._INT32), len(mesh._PLANS)) == (cached[0] - 1,
                                                    cached[1] - 1)


def test_a_capture_checks_an_index_made_per_call(teapot, monkeypatch):
    """Under a capture an index tensor without a plan of its own takes a
    plan of its signature chosen on the device by its values: equal values
    sum as before, values never planned give NaN, and a signature never
    planned raises."""
    tris, n_verts, values = teapot
    want = mesh.segment_sum(values, tris, n_verts)
    monkeypatch.setattr(capture, "capturing", lambda tensor: True)
    assert torch.equal(mesh.segment_sum(values, tris.clone(), n_verts), want)
    shuffle = torch.randperm(tris.shape[0],
                             generator=torch.Generator().manual_seed(11))
    other = tris[shuffle]  # rows in an order no step planned
    assert bool(torch.isnan(mesh.segment_sum(values, other, n_verts)).all())
    with pytest.raises(RuntimeError, match="no vertex plan"):
        mesh.segment_sum(values[:, :5], tris[:5].clone(), n_verts)


def test_a_capture_takes_the_plan_of_each_per_call_index(teapot,
                                                         monkeypatch):
    """A step that makes two indices of the same shape per call (the
    triangles flipped and reversed): its eager warm-up plans both, and a
    capture of the step chooses, on the device, each index's own plan, so
    the captured sums equal the eager ones bit for bit."""
    tris, n_verts, values = teapot

    def step():
        first = tris.flip(1).contiguous()
        second = tris.flip(0).contiguous()
        return (mesh.segment_sum(values, first, n_verts),
                mesh.segment_sum(values, second, n_verts))

    eager = step()
    assert not torch.equal(eager[0], eager[1])
    monkeypatch.setattr(capture, "capturing", lambda tensor: True)
    captured = step()
    assert torch.equal(captured[0], eager[0])
    assert torch.equal(captured[1], eager[1])


def test_losses_and_normals_repeat_bit_for_bit(teapot):
    """The Laplacian and edge losses and the vertex normals, and their
    gradients, give the same bits on every call (they used index_add)."""
    tris, n_verts, _ = teapot
    edges = mesh.compute_edges_list(tris)
    rng = np.random.RandomState(5)
    start = torch.tensor(rng.randn(n_verts, 3), dtype=torch.float32)
    runs = []
    for _ in range(2):
        v = start.clone().requires_grad_(True)
        value = (losses.laplacian_smoothing_loss(v, edges)
                 + losses.edge_loss(v, edges)
                 + mesh.compute_vertex_normals(v[None], tris).sum())
        value.backward()
        runs.append((value.detach(), v.grad))
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
