"""The plain reference against renders worked out by hand: one triangle
facing the camera, lit from far along the view axis, so that its inside
pixels take the diffuse colour and its outside pixels none."""

from __future__ import annotations

import torch

from benchmark.reference import camera, fit, hard, soft

FAR_LIGHT = torch.tensor([[[0.0, 0.0, 1e4]]])


def _scene():
    v = torch.tensor([[[-0.9, -0.9, 0.0], [0.83, -0.9, 0.0],
                       [-0.9, 0.77, 0.0]]])
    ccw = torch.tensor([[0, 1, 2]])
    cam = (torch.tensor([[0.0, 0.0, 4.0]]), torch.zeros(1, 3),
           torch.tensor([[0.0, 1.0, 0.0]]))
    return v, ccw, cam


def _inside_mask(v, cam, size):
    """[S, S] pixels (rows top-down) whose centre is inside the projected
    triangle, by half-plane tests on its NDC corners."""
    m = camera.clip_transforms(*cam, 40.0, 0.01, 10.0, size, size)
    clip = camera.to_clip(m, v)[0]
    ndc = clip[:, :2] / clip[:, 3:]
    mask = torch.zeros(size, size, dtype=torch.bool)
    for row in range(size):
        for col in range(size):
            p = ((col + 0.5) * 2 / size - 1, 1 - (row + 0.5) * 2 / size)
            s = [(ndc[(i + 1) % 3, 0] - ndc[i, 0]) * (p[1] - ndc[i, 1])
                 - (ndc[(i + 1) % 3, 1] - ndc[i, 1]) * (p[0] - ndc[i, 0])
                 for i in range(3)]
            mask[row, col] = all(x > 0 for x in s) or all(x < 0 for x in s)
    return mask


def test_hard_render_of_one_triangle():
    v, ccw, cam = _scene()
    size = 16
    diffuse = torch.tensor([[[0.2, 0.5, 0.8]] * 3])
    normals = torch.tensor([[[0.0, 0.0, 1.0]] * 3])
    img = hard.render(v, ccw.flip(1), normals, diffuse, *cam, FAR_LIGHT,
                      torch.ones(1, 1, 3), size, 40.0, 0.01, 10.0)[0]
    mask = _inside_mask(v, cam, size)
    assert mask.sum() > 20
    assert torch.equal(img[..., 3] > 0.5, mask)
    assert torch.allclose(img[mask][:, :3], diffuse[0, 0].expand(
        int(mask.sum()), 3), atol=1e-6)
    assert torch.all(img[~mask] == 0.0)


def test_hard_gradient_moves_the_edge_toward_the_loss():
    """Darkening the image's sum: the gradient pulls the free corner in."""
    v, ccw, cam = _scene()
    v = v.clone().requires_grad_(True)
    img = hard.render(v, ccw.flip(1), torch.tensor([[[0.0, 0.0, 1.0]] * 3]),
                      torch.ones(1, 3, 3), *cam, FAR_LIGHT,
                      torch.ones(1, 1, 3), 16, 40.0, 0.01, 10.0)
    img[..., :3].sum().backward()
    # Moving corner 1 outward along x covers more lit pixels.
    assert v.grad[0, 1, 0] > 0


def test_soft_render_of_one_triangle():
    v, ccw, cam = _scene()
    size = 16
    colors = torch.tensor([[[0.2, 0.5, 0.8]] * 3])
    img = soft.render(v, ccw, colors, *cam, FAR_LIGHT, torch.ones(1, 1),
                      size, 40.0, 0.01, 10.0, 1e-6, 1e-4, 0.01)[0]
    mask = _inside_mask(v, cam, size)
    inside = img[mask]
    assert torch.all(inside[:, 3] > 0.99)
    assert torch.allclose(inside[:, :3], colors[0, 0].expand_as(
        inside[:, :3]), atol=1e-3)
    sil = soft.render(v, ccw, None, *cam, None, None, size, 40.0, 0.01,
                      10.0, 1e-6, 1.0, 0.01, shade=False)[0]
    assert torch.equal(sil, img[..., 3])
    assert torch.all(sil[~mask] < 0.5)


def test_fit_terms_by_hand():
    """A unit right triangle: edges (0,1), (0,2), (1,2) of lengths 1, 1,
    sqrt 2; each vertex's neighbour mean lies at the others' midpoint."""
    faces = torch.tensor([[0, 1, 2]])
    verts = torch.tensor([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0],
                          [0.0, 1.0, 0.0]])
    edges = fit.unique_edges(faces)
    assert edges.tolist() == [[0, 1], [0, 2], [1, 2]]
    assert float(fit.edge_loss(verts, edges)) == \
        torch.tensor((2 + 2 ** 0.5) / 3).item()
    # Neighbour means minus the vertex: (0.5, 0.5), (-1, 0.5), (0.5, -1).
    lap = [0.5 * 2 ** 0.5, 1.25 ** 0.5, 1.25 ** 0.5]
    assert abs(float(fit.laplacian_loss(verts, edges)) - sum(lap) / 3) < 1e-6
    adam = fit.Adam(0.1, (0.9, 0.999), 1e-8)
    x = adam.step(torch.zeros(3), torch.tensor([1.0, -2.0, 0.0]))
    assert torch.allclose(x, torch.tensor([-0.1, 0.1, 0.0]), atol=1e-6)
