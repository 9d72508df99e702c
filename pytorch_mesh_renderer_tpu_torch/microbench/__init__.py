"""The three TPU design microbenchmarks of `scripts/`, ported to the card.

Each module is the counterpart of one JAX script, under the script's name,
and asks the script's question again on an NVIDIA H100:

  * `mxu_edge` (scripts/mxu_edge_microbench.py): do the edge and depth
    functions evaluate faster as fp32 arithmetic or as a matrix-unit
    contraction?
  * `mxu_full` (scripts/mxu_full_microbench.py): does that answer survive
    the whole per-visit pipeline (inside test, depth, winner, carry)?
  * `patch_scatter` (scripts/patch_scatter_microbench.py): do
    per-triangle patches with a winner merge through device memory beat
    the production per-pixel forward?

The TPU's matrix unit (MXU) becomes the tensor cores, driven by
`mma.sync`; its vector unit (VPU) becomes fp32 arithmetic on the CUDA
cores. Each module builds the script's inputs from the same numpy seed,
holds every CUDA kernel (`csrc/mxu_edge.cu`, `csrc/mxu_full.cu`,
`csrc/patch_eval.cu`) beside its plain PyTorch version, counts its
launches (`launches.<kernel>` in `utils/profiling.counters()`), and
prints the script's JSON line:

    python -m pytorch_mesh_renderer_tpu_torch.microbench.mxu_edge
    python -m pytorch_mesh_renderer_tpu_torch.microbench.mxu_full
    python -m pytorch_mesh_renderer_tpu_torch.microbench.patch_scatter \
        --config stress

`--device cuda` (the default) runs the kernels and raises without a card;
`--device cpu` runs the plain versions.
"""
