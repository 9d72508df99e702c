"""What the reconstruction cell's per-layer metrics read beyond
`readers.py` and `program.py`: the device time of the network's
convolution and GEMM kernels, which come from the libraries (cuDNN,
cuBLAS, CUTLASS) under names of their own and are matched by name here,
and of every other operation that is neither one of them nor a renderer
kernel; the host time of the loader's span and the host syncs a step.

Each function returns None where what it reads is absent, as a program
without the reconstruction step records nothing of it.
"""

from __future__ import annotations

import re

from . import readers
from .trace import label

# Convolutions (implicit GEMM, Winograd, FFT, their weight and data
# gradients and layout transforms) and GEMMs (with cuBLAS's split-K
# reductions, epilogues and scaling), by the libraries' names, read
# without the argument list.
NETWORK = re.compile(
    r"gemm|gemv|conv|xmma|cutlass|wgrad|dgrad|fprop|splitk|winograd|fft"
    r"|nchwtonhwc|nhwctonchw|tensortransform|cudnn|cublas|scal_kernel",
    re.IGNORECASE)
# cuDNN's BatchNorm kernels are no convolution, and PyTorch's own kernels
# (at::native) none of the libraries'.
NOT_NETWORK = re.compile(r"(^|[^a-z])bn_|batch_?norm|^at::native",
                         re.IGNORECASE)

BATCH_SPAN = "mr.recon.batch"
STEPS = "recon.steps"


def is_network(name):
    """Whether a device operation is one of the network's library
    kernels."""
    name = label(name)
    return bool(NETWORK.search(name)) and not NOT_NETWORK.search(name)


def split_ms_per_step(ctx):
    """(network ms, glue ms) a traced step: the device time of the
    network's library kernels, and of every operation that is neither one
    of them nor a renderer kernel (`kernels/`)."""
    net = glue = 0.0
    for name, seconds in ctx["trace"]["by_name"].items():
        if readers.kernel_of(ctx, name) is not None:
            continue
        if is_network(name):
            net += seconds
        else:
            glue += seconds
    steps = readers.traced_steps(ctx)
    return 1e3 * net / steps, 1e3 * glue / steps


def network_ms_per_step(ctx):
    net, _ = split_ms_per_step(ctx)
    return net if net > 0 else None


def glue_ms_per_step(ctx):
    net, glue = split_ms_per_step(ctx)
    return glue if net > 0 else None


def batch_ms_per_step(table):
    """1e3 x the host seconds of the loader's `mr.recon.batch` spans over
    their count; None where none was recorded."""
    count, host_s, _ = table.get(BATCH_SPAN, (0, 0.0, 0.0))
    return 1e3 * host_s / count if count else None


def host_syncs_per_step(counts, before):
    """The `host_syncs.*` counters' growth over the growth of
    `recon.steps`, from `before` (the counters when the window began) to
    `counts`: the syncs of the steady state, the set-up's left out. None
    where no step was counted."""
    if before is None:
        return None
    steps = counts.get(STEPS, 0) - before.get(STEPS, 0)
    if steps <= 0:
        return None

    def syncs(table):
        return sum(n for name, n in table.items()
                   if name.startswith("host_syncs."))

    return (syncs(counts) - syncs(before)) / steps
