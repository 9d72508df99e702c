"""The PyTorch port runs where JAX is absent.

The machine with the card has no JAX, so the port must import neither jax
nor the JAX package (whose __init__ imports jax). A fresh interpreter with
`sys.modules["jax"] = None` makes any such import fail; in it, the port
must import and render a cube on the CPU.
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
from pytorch_mesh_renderer_tpu_torch.ops import rasterize_cuda  # noqa: F401
from pytorch_mesh_renderer_tpu_torch.utils import (  # noqa: F401
    convert, kernels, test_utils)

v, t, n = pmt.shapes.cube(2.0)
rot = pmt.camera.euler_matrices(torch.tensor([[-20.0, 0.0, 60.0]]))[:, :3, :3]
vw = v[None] @ rot.transpose(1, 2)
nw = n[None] @ rot.transpose(1, 2)
img = pmt.mesh_renderer.render(
    vw, t.flip(1).contiguous(), nw, torch.ones_like(vw),
    torch.tensor([0.0, 0.0, 6.0]), torch.zeros(3), torch.tensor([0.0, 1.0, 0.0]),
    torch.tensor([[[0.0, 0.0, 6.0]]]), torch.ones(1, 1, 3), 32, 24)
assert img.shape == (1, 24, 32, 4) and bool(torch.isfinite(img).all())
assert 0.05 < float(img[..., 3].mean()) < 0.95
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
