"""Edge-function evaluation: CUDA-core fp32 arithmetic vs the tensor cores.

Port of scripts/mxu_edge_microbench.py (S1). The hard kernels evaluate
five affine functions of the pixel centre per (triangle, pixel) pair: the
three edge functions e0, e1, e2 and the depth numerator and denominator
(num = sum e_i vz_i, den = sum e_i vw_i, affine because the e_i are). All
five are one contraction per visit of C triangles,

    [5C, 3 -> 8] coefficient rows @ [8, 2048] homogeneous pixels (x, y, 1),

which on the TPU could run on the matrix unit (MXU) instead of the vector
unit (VPU). Here the MXU is the tensor cores and the VPU the CUDA cores.
Each variant folds every pair's five values into one sum per pixel (an
additive fold, so nothing is dead code), over `visits` visits of one
16x128 tile:

  * `fma` (the script's `vpu`): the production formulation, the five
    functions as fp32 products and sums per pair on the CUDA cores, pixel
    centres from the thread index (`csrc/mxu_edge.cu`, built with
    --fmad=false like every kernel here, so a*b + c stays a product and a
    sum, as in K1);
  * `tc_bf16` (`mxu_bf16`): one bf16 `mma.sync` m16n8k8 pass (K = 8, the
    contraction's depth). bf16 rounds the pixel coordinates to 8 mantissa
    bits, so it is not fit for coverage: timed as the upper bound of the
    lever;
  * `tc_tf32x3` (`mxu_bf16x6`): the parity-plausible route, the 3xTF32
    product hi*hi + hi*lo + lo*hi of operands split into a TF32 hi and lo
    part by `cvt.rna.tf32.f32`; the pixel centres are TF32-exact, so B's
    lo part and the hi*lo product are zero and the kernel runs two TF32
    `mma.sync` m16n8k8 products per tile (lo*hi, hi*hi).

The three variants share one decomposition (`csrc/mxu_edge.cu`): a CTA
of WARPS warps covers GROUP_PIX pixels, each warp one of
`edge_splits(visits)` contiguous visit ranges (`split_visits`), a
cluster of `edge_cluster(splits)` CTAs a group's splits, whose partial
sums it adds in split order through distributed shared memory; they
differ in the contraction only. Each kernel sits beside its plain PyTorch
version: `fold_fma_torch` sums in the kernel's order (bit for bit equal);
`fold_tc_torch` rounds the operands as the kernel does (bf16, or the TF32
hi/lo split) and accumulates in fp32, in its own order (a stated relative
tolerance, TC_RTOL).

    python -m pytorch_mesh_renderer_tpu_torch.microbench.mxu_edge \
        [--visits 512] [--chunk 8] [--iters 30] [--device cuda|cpu]

prints the script's JSON line: each variant's time per call (`*_us`, the
device time of its kernels by torch.profiler on a card, the host clock on
the CPU; `*_call_us`, back-to-back calls by CUDA events, host enqueueing
included), `*_relerr` against `fma` and `*_speedup` over `fma`.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..utils.device import resolve_device
from . import common

VARIANTS = ("fma", "tc_bf16", "tc_tf32x3")

# Launches of each variant's kernel in this process; each wrapper adds one
# per launch and nothing else touches them.
LAUNCHES = {name: 0 for name in VARIANTS}

# The kernels' decomposition (csrc/mxu_edge.cu): warps per CTA, each one
# split of the visits; pixels per CTA (fma: PIX_PER_LANE a lane; tc: TILES
# n8 tiles a warp); at most MAX_SPLITS splits, so that a cluster of CTAs
# holding a group's splits stays within the card's limit of 16.
WARPS = 4
GROUP_PIX = 64
PIX_PER_LANE = GROUP_PIX // 32
TILES = GROUP_PIX // 8
MAX_SPLITS = 16 * WARPS

# fp32 operations of one (triangle, pixel) pair in the fma body: the three
# edge functions (6 products, 6 sums), num and den (6 products, 4 sums),
# the four sums of the five values and the fold into the visit's sum.
FMA_OPS_PER_PAIR = 27

# Kernel vs plain version of a tensor-core variant, as max |difference| /
# max |plain|: both take the same rounded operands and exact products and
# differ only in how the tensor cores and torch.matmul order and round the
# fp32 sums of ~visits * 5C terms per pixel.
TC_RTOL = 1e-5


def edge_splits(visits: int) -> int:
    """The number of visit ranges the kernels split `visits` over: one a
    warp, up to MAX_SPLITS (at 512 visits, 64 splits of 8 visits in 512
    CTAs of 4 warps: 3.9 CTAs on each of the H100's 132 SMs)."""
    if visits < 1:
        raise ValueError(f"visits must be >= 1, got {visits}")
    return min(visits, MAX_SPLITS)


def edge_cluster(splits: int) -> int:
    """CTAs in the cluster that holds one pixel group's splits."""
    return -(-splits // WARPS)


def split_visits(visits: int):
    """[(first, end)] of each split's visits, in split order: split s of S
    covers visits [s V // S, (s + 1) V // S)."""
    splits = edge_splits(visits)
    return [(s * visits // splits, (s + 1) * visits // splits)
            for s in range(splits)]


def make_inputs(visits, chunk, device):
    """The script's inputs from np.random.default_rng(0)
    (mxu_edge_microbench.py:87-115): (data [visits*C, 16] packed rows,
    coeff [visits*5C, 8] contraction rows, pix [8, 2048] homogeneous
    pixels), f32 on `device`."""
    rng = np.random.default_rng(0)
    data = rng.uniform(-2.0, 2.0, size=(visits * chunk, 16)).astype(
        np.float32)
    m = data.reshape(visits, chunk, 16)
    a = m[:, :, 0:9].reshape(visits, chunk, 3, 3)
    vz = m[:, :, 9:12]
    vw = m[:, :, 12:15]
    num_c = np.einsum("vcek,vce->vck", a, vz)
    den_c = np.einsum("vcek,vce->vck", a, vw)
    coeff = np.concatenate(
        [a.reshape(visits, chunk * 3, 3), num_c, den_c], axis=1)
    coeff = np.pad(coeff, [(0, 0), (0, 0), (0, 5)])
    coeff = coeff.reshape(visits * 5 * chunk, 8).astype(np.float32)

    cols = np.arange(common.TILE_W, dtype=np.float32)
    rows = np.arange(common.TILE_H, dtype=np.float32)
    px = np.tile((cols + 0.5) * (2.0 / 512) - 1.0, common.TILE_H)
    py = np.repeat((rows + 0.5) * (2.0 / 512) - 1.0, common.TILE_W)
    pix = np.zeros((8, common.N_PIX), np.float32)
    pix[0], pix[1], pix[2] = px, py, 1.0
    return tuple(torch.from_numpy(x).to(device) for x in (data, coeff, pix))


def fold_fma_torch(data, visits, chunk):
    """Plain version of the fma kernel: [16, 128] f32, summed in its order.

    Per pixel and visit, the C pairs' values e0 + e1 + e2 + num + den are
    summed in triangle order; each split (`split_visits`) adds its visits'
    sums to 0 in visit order, and the splits' sums are added to 0 in split
    order.
    """
    px, py = common.tile_pixel_coords(data.device)
    e0, e1, e2, num, den = common.affine_values(  # each [V, C, N]
        data.view(visits, chunk, 16), px, py)
    terms = e0 + e1 + e2 + num + den
    visit_sum = terms[:, 0]
    for c in range(1, chunk):
        visit_sum = visit_sum + terms[:, c]
    bounds = split_visits(visits)
    first = torch.tensor([f for f, _ in bounds], device=data.device)
    size = torch.tensor([e - f for f, e in bounds], device=data.device)
    partial = torch.zeros(len(bounds), common.N_PIX, device=data.device)
    for i in range(int(size.max())):  # visit i of every split at once
        rows = visit_sum[(first + i).clamp(max=visits - 1)]
        partial = torch.where((i < size)[:, None], partial + rows, partial)
    out = torch.zeros(common.N_PIX, device=data.device)
    for j in range(len(bounds)):
        out = out + partial[j]
    return out.view(common.TILE_H, common.TILE_W)


def fold_tc_torch(coeff, pix, variant):
    """Plain version of a tensor-core kernel: [1, 2048] f32.

    The operands rounded as the kernel rounds them (bf16 to nearest even;
    or TF32 hi and lo parts), their exact products summed in fp32 by
    torch.matmul, the [visits*5C, 2048] product summed over its rows.
    """
    if variant == "tc_bf16":
        product = coeff.bfloat16().float() @ pix.bfloat16().float()
    elif variant == "tc_tf32x3":
        a_hi, a_lo = common.tf32_split(coeff)
        b_hi, b_lo = common.tf32_split(pix)
        product = a_hi @ b_hi + (a_hi @ b_lo + a_lo @ b_hi)
    else:
        raise ValueError(f"not a tensor-core variant: {variant!r}")
    return product.sum(0, keepdim=True)


def launch_fma(data, visits, chunk):
    """The fma kernel (csrc/mxu_edge.cu) on [visits*C, 16] CUDA rows;
    fold_fma_torch's contract."""
    common.check_operands(data.device, [("data", data, (visits * chunk, 16))])
    out = torch.empty(common.TILE_H, common.TILE_W, device=data.device)
    common.launch("mxu_edge_fma", data.device, data.data_ptr(),
                  out.data_ptr(), visits, chunk, edge_splits(visits),
                  common.PIXEL_SCALE)
    LAUNCHES["fma"] += 1
    return out


def launch_tc(coeff, pix, visits, chunk, variant):
    """A tensor-core kernel (csrc/mxu_edge.cu) on CUDA coeff
    [visits*5C, 8] and pix [8, 2048] whose values are TF32-exact
    (make_inputs'; 3xTF32 drops the product with B's lo part, zero then);
    fold_tc_torch's contract."""
    if variant not in ("tc_bf16", "tc_tf32x3"):
        raise ValueError(f"not a tensor-core variant: {variant!r}")
    common.check_operands(coeff.device, [
        ("coeff", coeff, (visits * 5 * chunk, 8)),
        ("pix", pix, (8, common.N_PIX))])
    out = torch.empty(1, common.N_PIX, device=coeff.device)
    common.launch("mxu_edge_tc", coeff.device, coeff.data_ptr(),
                  pix.data_ptr(), out.data_ptr(), visits, chunk,
                  edge_splits(visits), int(variant == "tc_bf16"))
    LAUNCHES[variant] += 1
    return out


def fold(variant, data, coeff, pix, visits, chunk):
    """One variant's fold: its kernel on CUDA tensors, its plain version on
    CPU tensors."""
    on_card = data.device.type == "cuda"
    if variant == "fma":
        return (launch_fma(data, visits, chunk) if on_card
                else fold_fma_torch(data, visits, chunk))
    return (launch_tc(coeff, pix, visits, chunk, variant) if on_card
            else fold_tc_torch(coeff, pix, variant))


def run(visits=512, chunk=8, iters=30, device="cuda"):
    """Evaluate and time the three variants; returns the JSON dict."""
    dev = resolve_device(device)
    data, coeff, pix = make_inputs(visits, chunk, dev)
    results = {}
    ref = None
    for name in VARIANTS:
        def call(name=name):
            return fold(name, data, coeff, pix, visits, chunk)

        flat = call().reshape(-1)
        if ref is None:
            ref = flat
        else:  # tf32x3 tracks fp32 closely; bf16 drifts: report both
            results[name + "_relerr"] = float(
                (flat - ref).abs().max()
                / max(1e-9, float(ref.abs().max())))
        results.update(common.times_us(name, call, dev, iters))
    results.update(chunk=chunk, visits=visits,
                   tile=[common.TILE_H, common.TILE_W],
                   device=common.device_name(dev))
    for name in VARIANTS[1:]:
        results[name + "_speedup"] = results["fma_us"] / results[name + "_us"]
    return results


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--visits", type=int, default=512,
                        help="table chunks visited per kernel call")
    parser.add_argument("--iters", type=int, default=30)
    parser.add_argument("--chunk", type=int, default=8,
                        help="triangles per visit (stress ships 8)")
    parser.add_argument("--device", default="cuda",
                        help="cuda: the kernels; cpu: the plain versions")
    args = parser.parse_args(argv)
    print(json.dumps(run(args.visits, args.chunk, args.iters, args.device)))


if __name__ == "__main__":
    main()
