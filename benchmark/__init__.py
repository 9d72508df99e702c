"""The benchmark of pytorch_mesh_renderer_tpu_torch on one NVIDIA card
(see README.md)."""
