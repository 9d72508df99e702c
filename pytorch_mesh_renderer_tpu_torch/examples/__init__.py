"""The example CLIs, ported from the repository's `examples/`.

Each runs as `python -m pytorch_mesh_renderer_tpu_torch.examples.<name>`
with the JAX example's arguments and defaults plus `--device cuda|cpu`
(default cuda, which raises without a card), and has `main(argv=None)`,
which returns what it computed:

  render_teapot_hard        the hard Phong render of the teapot (K1)
  render_teapot_soft        the soft render of the teapot (K7)
  optimize_cube_rotation    a cube's rotation from pixels, hard or --soft
  optimize_teapot_rotation  the teapot's rotation, hard or --soft
  optimize_camera_pose      the camera's eye and look rotation (hard)
  fit_shape_multiview       the flagship: a sphere fitted to four cow
                            silhouettes (K5, K6)

and `recon`, a module without a JAX twin: SoftRas's single-view mesh
reconstruction (a network trained through the silhouette kernels), its
network, loss, data loader and captured training step.
"""
