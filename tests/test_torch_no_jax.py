"""The PyTorch port runs where JAX is absent.

The machine with the card has no JAX, so the port must import neither jax
nor the JAX package (whose __init__ imports jax). A fresh interpreter with
`sys.modules["jax"] = None` makes any such import fail; in it, the port
must import, render a cube on the CPU with the hard and the soft renderer,
take their gradients, run the microbenchmarks' plain versions, a training
loop and the bench.
"""

import os
import subprocess
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError

import torch
import pytorch_mesh_renderer_tpu_torch as pmt
from pytorch_mesh_renderer_tpu_torch.ops import (  # noqa: F401
    losses, rasterize_barycentric_cuda, rasterize_cuda, soft_rasterize,
    soft_rasterize_cuda)
from pytorch_mesh_renderer_tpu_torch.utils import (  # noqa: F401
    capture, convert, cost, kernels, profiling, scenes, test_utils)
from pytorch_mesh_renderer_tpu_torch import bench, parallel
from pytorch_mesh_renderer_tpu_torch.microbench import (
    mxu_edge, mxu_full, patch_scatter)

v, t, n = pmt.shapes.cube(2.0)
rot = pmt.camera.euler_matrices(torch.tensor([[-20.0, 0.0, 60.0]]))[:, :3, :3]
vw = v[None] @ rot.transpose(1, 2)
nw = n[None] @ rot.transpose(1, 2)
vw.requires_grad_(True)
img = pmt.mesh_renderer.render(
    vw, t.flip(1).contiguous(), nw, torch.ones_like(vw),
    torch.tensor([0.0, 0.0, 6.0]), torch.zeros(3), torch.tensor([0.0, 1.0, 0.0]),
    torch.tensor([[[0.0, 0.0, 6.0]]]), torch.ones(1, 1, 3), 32, 24)
assert img.shape == (1, 24, 32, 4) and bool(torch.isfinite(img).all())
assert 0.05 < float(img[..., 3].mean()) < 0.95
(img[..., :3] ** 2).mean().backward()
assert bool(torch.isfinite(vw.grad).all()) and float(vw.grad.abs().max()) > 0

# The soft renderer (CCW triangles, scalar intensities) and the silhouette
# gradient through the plain versions of K5-K8.
vs = (v[None] @ rot.transpose(1, 2)).requires_grad_(True)
cam = (torch.tensor([0.0, 0.0, 6.0]), torch.zeros(3),
       torch.tensor([0.0, 1.0, 0.0]))
rgba = pmt.soft_mesh_renderer.render(
    vs, t, torch.ones_like(vs), *cam, torch.tensor([[[0.0, 0.0, 6.0]]]),
    torch.ones(1, 1), 32, 24)
assert rgba.shape == (1, 24, 32, 4) and bool(torch.isfinite(rgba).all())
alpha = pmt.soft_mesh_renderer.render_silhouette(vs, t, *cam, 32, 24)
assert torch.equal(alpha, rgba[..., 3].detach())
assert 0.05 < float(alpha.mean()) < 0.95
edges = pmt.mesh.compute_edges_list(t)
(pmt.losses.silhouette_mse_loss(alpha, torch.ones_like(alpha))
 + pmt.losses.edge_loss(vs[0], edges)).backward()
assert bool(torch.isfinite(vs.grad).all()) and float(vs.grad.abs().max()) > 0
# The microbenchmarks' plain versions and the bench scene.
assert mxu_edge.run(4, 8, 1, "cpu")["tc_tf32x3_relerr"] <= 1e-6
assert mxu_full.run(64, 8, 1, "cpu")["covered_px"] > 0
teapot = scenes.build_scene(1, "cpu")
rows, bbox = patch_scatter.pack(scenes.clip_vertices(teapot, 64),
                                teapot["triangles"])
assert patch_scatter.plan(rows, bbox, 64, (16, 8), 32, 4)[0].shape[1] > 0
# A training loop and the bench's pose mode on the CPU.
p = torch.zeros(3, requires_grad=True)
loop = parallel.make_train_loop(lambda params, b: ((params[0] - b) ** 2).sum(),
                                torch.optim.Adam([p], lr=0.1), 2)
assert loop(torch.ones(3)).shape == (2,) and float(p[0]) > 0
assert bench.main(["--pose", "--steps", "2", "--size", "16",
                   "--device", "cpu"])[0]["value"] > 0
leaked = sorted(m for m in sys.modules
                if m == "pytorch_mesh_renderer_tpu"
                or m.startswith("pytorch_mesh_renderer_tpu."))
assert not leaked, leaked
print("NO_JAX_OK")
"""


def test_port_imports_and_renders_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO_ROOT)
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO_ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "NO_JAX_OK" in proc.stdout
