"""The hard renderer's diffuse shading on the CPU: the backward that the
shading kernels compute (`ops/shading.phong_diffuse_backward_torch`)
against autograd through the plain ops (`models/mesh_renderer._shade_torch`,
`phong_shader`), the dispatch that keeps the CPU on the plain ops, and
backend 'cuda' refusing the calls that the kernels do not shade.

The kernels themselves run only on the card (`tests/test_torch_cuda.py`).
The scenes are `utils/test_utils.SHADING_SCENES`: exact ties of n.l at 0
and 1, where clip's derivative is 1/2, and normals of zero length and
below normalize's eps, where autograd's gradient is NaN (0 / 0) and
~1e12, are among them.
"""

import numpy as np
import pytest
import torch

from pytorch_mesh_renderer_tpu_torch import config as config_lib
from pytorch_mesh_renderer_tpu_torch.models import mesh_renderer
from pytorch_mesh_renderer_tpu_torch.ops import shading
from pytorch_mesh_renderer_tpu_torch.ops.math_utils import normalize
from pytorch_mesh_renderer_tpu_torch.utils import profiling, test_utils


def _autograd_of_plain_ops(attrs, light_pos, light_int, ambient, d_images):
    x = attrs.clone().requires_grad_(True)
    images = mesh_renderer._shade_torch(x, light_pos, light_int, None, None,
                                        None, ambient)
    (images * d_images).sum().backward()
    return x.grad


@pytest.mark.parametrize("ambient", [False, True])
@pytest.mark.parametrize("lights", [1, 2, 3])
@pytest.mark.parametrize("scene", test_utils.SHADING_SCENES)
def test_written_out_backward_matches_autograd_of_the_plain_ops(
        scene, lights, ambient):
    attrs, light_pos, light_int, amb = test_utils.shading_scene(
        scene, lights, ambient, "cpu")
    d_images = test_utils.soft_cotangents(*attrs.shape[:3], "cpu")
    want = _autograd_of_plain_ops(attrs, light_pos, light_int, amb,
                                  d_images)
    got = shading.phong_diffuse_backward_torch(attrs, light_pos, light_int,
                                               amb, d_images)
    assert got.shape == attrs.shape
    gap = test_utils.shading_gradient_gap(got, want)
    assert gap <= test_utils.SHADING_GRAD_RTOL
    assert bool((got[..., 9:] == 0.0).all())
    assert bool(torch.isnan(want).any()) == (scene == "zero_normals")


def test_the_ties_scene_holds_exact_zeros_and_ones():
    attrs, light_pos, _, _ = test_utils.shading_scene("ties", 3, False,
                                                      "cpu")
    n_hat = normalize(attrs[:, 1:, :, None, 0:3], dim=-1)
    to_light = light_pos[:, None, None] - attrs[:, 1:, :, None, 3:6]
    n_dot_l = (n_hat * normalize(to_light, dim=-1)).sum(-1)
    assert bool((n_dot_l == 0.0).any()) and bool((n_dot_l == 1.0).any())
    assert bool(((n_dot_l == 0.0) | (n_dot_l.abs() == 1.0)).all())


def test_render_on_the_cpu_takes_the_plain_ops():
    """On the CPU every call shades with the plain ops: no kernel launch,
    and `shade.unfused` counts only calls on a card."""
    v = torch.tensor([[[-1.0, -1.0, 0.0], [1.0, -1.0, 0.0],
                       [0.0, 1.0, 0.0]]])
    args = (torch.tensor([[0, 2, 1]], dtype=torch.int32),
            torch.tensor([[[0.0, 0.0, 1.0]] * 3]), torch.full((1, 3, 3), 0.7),
            torch.tensor([0.0, 0.0, 3.0]), torch.zeros(3),
            torch.tensor([0.0, 1.0, 0.0]), torch.tensor([[[0.0, 0.0, 3.0]]]),
            torch.ones(1, 1, 3), 8, 8)
    names = ("shade.unfused", "launches.phong_shade_fwd",
             "launches.phong_shade_bwd")
    before = [profiling.counters().get(k, 0) for k in names]
    image = mesh_renderer.render(v, *args)
    specular = mesh_renderer.render(
        v, *args, specular_colors=torch.ones(1, 3, 3),
        shininess_coefficients=np.float32(4.0))
    assert [profiling.counters().get(k, 0) for k in names] == before
    assert float(image[..., 3].sum()) > 0.0
    assert bool((specular[..., :3] >= image[..., :3]).all())


@pytest.mark.parametrize("case", ["specular", "light_positions",
                                  "light_intensities", "ambient_color",
                                  "cpu_tensors"])
def test_cuda_backend_refuses_what_the_kernels_do_not_shade(case):
    """Under backend='cuda' the shading never falls back to the plain ops:
    specular terms and gradients wanted for the lights or the ambient
    colour raise before any kernel, and so do CPU tensors."""
    attrs, light_pos, light_int, amb = test_utils.shading_scene(
        "random", 2, True, "cpu")
    lighting = {"light_positions": light_pos, "light_intensities": light_int,
                "ambient_color": amb}
    specular = (None, None)
    if case == "specular":
        specular = (torch.ones(2, 1, 1, 3), torch.full((2, 1, 1), 4.0))
    elif case in lighting:
        lighting[case] = lighting[case].clone().requires_grad_(True)
    cuda = config_lib.HardRasterizerConfig(backend="cuda")
    match = "CUDA" if case == "cpu_tensors" else "backend='cuda'"
    with pytest.raises(ValueError, match=match):
        mesh_renderer._shade(attrs, lighting["light_positions"],
                             lighting["light_intensities"],
                             torch.zeros(2, 3), *specular,
                             lighting["ambient_color"], cuda)
