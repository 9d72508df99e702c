"""What the microbenchmark modules share: the tile the first two evaluate,
the split of their visits over blocks, the plain versions' edge and depth
arithmetic, the TF32 rounding of the tensor-core variants, the kernels'
operand checks and launch, devices and timers."""

from __future__ import annotations

import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from ..ops import rasterize_cuda as rc
from ..utils import kernels

# The one tile that scripts/mxu_*_microbench.py evaluate: 16 rows of 128
# pixels at the pixel pitch of a 512x512 image.
TILE_H = 16
TILE_W = 128
N_PIX = TILE_H * TILE_W
PIXEL_SCALE = float(np.float32(2.0 / 512))

# The kernels of mxu_full split the visit loop over at most this many
# blocks per pixel block and merge the partial results in a second pass (a
# visit count with no such divisor runs in fewer splits).
MAX_SPLITS = 32


def visit_splits(visits: int) -> int:
    """The largest divisor of `visits` that is at most MAX_SPLITS: the
    number of blocks one pixel block's visits are split over."""
    return max(d for d in range(1, MAX_SPLITS + 1) if visits % d == 0)


def tile_pixel_coords(device):
    """(px, py), each [N_PIX] f32: the NDC pixel centres of the tile in
    row-major order (pixel r * TILE_W + c), as the scripts' iotas give
    them: (index + 0.5) * (2 / 512) - 1."""
    cols = torch.arange(TILE_W, dtype=torch.float32, device=device)
    rows = torch.arange(TILE_H, dtype=torch.float32, device=device)
    px = ((cols + 0.5) * PIXEL_SCALE - 1.0).repeat(TILE_H)
    py = ((rows + 0.5) * PIXEL_SCALE - 1.0).repeat_interleave(TILE_W)
    return px, py


def affine_values(rows, px, py):
    """(e0, e1, e2, num, den) of packed rows [..., >= 15] at pixel centres
    px, py that broadcast against [..., 1]: e_i = a_i px + b_i py + c_i
    (columns 3i..3i+2), num = sum e_i z_i (9-11), den = sum e_i w_i
    (12-14), in the kernels' operation order (rasterize_common.cuh)."""
    def col(k):
        return rows[..., k, None]

    e0 = col(0) * px + col(1) * py + col(2)
    e1 = col(3) * px + col(4) * py + col(5)
    e2 = col(6) * px + col(7) * py + col(8)
    num = e0 * col(9) + e1 * col(10) + e2 * col(11)
    den = e0 * col(12) + e1 * col(13) + e2 * col(14)
    return e0, e1, e2, num, den


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10 explicit mantissa bits), to nearest with ties
    away from zero, on the bit pattern: what `cvt.rna.tf32.f32` does, with
    the 13 low bits cleared as the kernels clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor):
    """(hi, lo): x's TF32 rounding and the TF32 rounding of the rest, the
    operands of a 3xTF32 product (hi*hi + hi*lo + lo*hi)."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def resolve_device(name: str) -> torch.device:
    """The device a microbenchmark runs on; `cuda` without a card raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs an NVIDIA GPU; --device cpu "
                           "runs the plain versions")
    return device


def device_name(device: torch.device) -> str:
    """The card's name, or `cpu`: the JSON lines' `device`."""
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def card_line() -> str:
    """The card's name and power limit as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` prints them (its first card)."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return proc.stdout.strip().splitlines()[0].strip()


def check_operands(device: torch.device, operands) -> None:
    """Raise unless every (name, tensor, shape) of `operands` is a
    contiguous f32 tensor on the CUDA `device`, of `shape` (None matches
    any extent), with 16-byte aligned data (the kernels read rows as
    float4)."""
    rc.check_kernel_operands(device, [(name, tensor, torch.float32)
                                      for name, tensor, _ in operands])
    for name, tensor, shape in operands:
        if tensor.dim() != len(shape) or any(
                want is not None and got != want
                for got, want in zip(tensor.shape, shape)):
            want = ", ".join("*" if s is None else str(s) for s in shape)
            raise ValueError(f"{name} has shape {tuple(tensor.shape)}; want "
                             f"[{want}]")
        if tensor.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def launch(entry: str, device: torch.device, *args) -> None:
    """Call the C entry point `entry` of the kernel library on the current
    stream of `device` (the stream is its last argument) and raise on a
    CUDA error."""
    lib = kernels.load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        error = getattr(lib, entry)(*args, stream)
    kernels.check_cuda_error(lib, error, f"{entry} launch")


def wall_ms(fn, device, iters, windows=5, warmup=3):
    """Median over `windows` of the mean time of `iters` back-to-back calls
    after `warmup` calls: CUDA events on a card (so the host's enqueueing
    counts when it is the slower), the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    per_call = []
    for _ in range(windows):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            per_call.append(start.elapsed_time(end) / iters)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            per_call.append((time.perf_counter() - t0) * 1e3 / iters)
    return statistics.median(per_call)


# device_profile's breakdown when the profiler recorded no kernel: the
# total by CUDA events, under this one key.
EVENTS_ONLY = "all kernels (CUDA events; the profiler recorded none)"


def held_events_ms(fn, iters):
    """Device ms per call of `iters` back-to-back calls of `fn`, by CUDA
    events recorded behind a spin kernel that holds the card until the
    host has queued every call, so the host's enqueueing does not count."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # 2e9 cycles per second is above the card's clock: the hold is long
    # enough at any clock.
    hold_s = min(2.0 * iters * enqueue_s + 1e-3, 2.0)
    torch.cuda._sleep(int(hold_s * 2e9))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(fn, iters, attempts=3):
    """torch.profiler over `iters` calls of `fn` on the card after one:
    (device ms per call by kernel name, total device ms per call, kernels
    per call), without host enqueueing or gaps. A profile that recorded
    no device kernel (the profiler drops a session's kernels now and then)
    is taken again; after `attempts` such, the total is held_events_ms's,
    the breakdown holds it under EVENTS_ONLY and the kernel count is nan."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        by_name = {}
        count = 0
        for event in prof.events():
            if event.device_type == torch.autograd.DeviceType.CUDA:
                by_name[event.name] = (by_name.get(event.name, 0.0)
                                       + event.time_range.elapsed_us() / 1e3)
                count += 1
        if by_name:
            by_name = {k: v / iters for k, v in by_name.items()}
            return by_name, sum(by_name.values()), count / iters
        print("torch.profiler recorded no device kernels; profiling again",
              file=sys.stderr, flush=True)
    total = held_events_ms(fn, iters)
    return {EVENTS_ONLY: total}, total, float("nan")


def device_ms(fn, device, iters):
    """Time per call on the device: device_profile's total on a card, the
    host clock (wall_ms, one window after one call) on the CPU."""
    if device.type != "cuda":
        return wall_ms(fn, device, iters, windows=1, warmup=1)
    return device_profile(fn, iters)[1]


def times_us(name, fn, device, iters):
    """A variant's times per call in µs, as the JSON lines key them:
    `<name>_us`, device_ms; on a card also `<name>_call_us`, wall_ms over
    three windows after one call."""
    times = {name + "_us": device_ms(fn, device, iters) * 1e3}
    if device.type == "cuda":
        times[name + "_call_us"] = wall_ms(fn, device, iters, windows=3,
                                           warmup=1) * 1e3
    return times
