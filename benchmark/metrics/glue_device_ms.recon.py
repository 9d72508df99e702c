"""Device ms a step of every operation that is neither a renderer kernel
nor one of the network's convolution and GEMM kernels: BatchNorm, the
activations, the decoder's deformation, the camera, the packing, the
scatters, the losses, Adam and the batch's copies."""

from benchmark import net_kernels


def read(ctx):
    return net_kernels.glue_ms_per_step(ctx)
