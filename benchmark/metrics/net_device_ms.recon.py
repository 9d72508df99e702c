"""Device ms a step of the network's convolution and GEMM kernels (cuDNN,
cuBLAS, CUTLASS), matched by name (`net_kernels.py`)."""

from benchmark import net_kernels


def read(ctx):
    return net_kernels.network_ms_per_step(ctx)
