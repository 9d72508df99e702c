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
  * `tc_bf16` (`mxu_bf16`): one bf16 `mma.sync` m16n8k16 pass, K padded
    8 -> 16. bf16 rounds the pixel coordinates to 8 mantissa bits, so it
    is not fit for coverage: timed as the upper bound of the lever;
  * `tc_tf32x3` (`mxu_bf16x6`): the parity-plausible route, three TF32
    `mma.sync` m16n8k8 products per tile (hi*hi + hi*lo + lo*hi, each
    operand split into a TF32 hi and lo part by `cvt.rna.tf32.f32`).

The three variants share one decomposition: a block of 256 threads covers
256 pixels, and the visits are split over `common.visit_splits(visits)`
blocks whose partial sums a second pass adds up; they differ in the
contraction only. Each kernel sits beside its plain PyTorch version:
`fold_fma_torch` sums in the kernel's order (bit for bit equal);
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

from . import common

VARIANTS = ("fma", "tc_bf16", "tc_tf32x3")

# Launches of each variant's kernel in this process; each wrapper adds one
# per launch (its two passes) and nothing else touches them.
LAUNCHES = {name: 0 for name in VARIANTS}

# fp32 operations of one (triangle, pixel) pair in the fma body: the three
# edge functions (6 products, 6 sums), num and den (6 products, 4 sums),
# the four sums of the five values and the fold into the visit's sum.
FMA_OPS_PER_PAIR = 27

# Kernel vs plain version of a tensor-core variant, as max |difference| /
# max |plain|: both take the same rounded operands and exact products and
# differ only in how the tensor cores and torch.matmul order and round the
# fp32 sums of ~visits * 5C terms per pixel.
TC_RTOL = 1e-5


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
    summed in triangle order; each split adds its visits' sums to 0 in
    visit order, and the splits' sums are added to 0 in split order.
    """
    px, py = common.tile_pixel_coords(data.device)
    e0, e1, e2, num, den = common.affine_values(  # each [V, C, N]
        data.view(visits, chunk, 16), px, py)
    terms = e0 + e1 + e2 + num + den
    visit_sum = terms[:, 0]
    for c in range(1, chunk):
        visit_sum = visit_sum + terms[:, c]
    splits = common.visit_splits(visits)
    per_split = visit_sum.view(splits, visits // splits, common.N_PIX)
    partial = torch.zeros(splits, common.N_PIX, device=data.device)
    for i in range(visits // splits):
        partial = partial + per_split[:, i]
    out = torch.zeros(common.N_PIX, device=data.device)
    for j in range(splits):
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
    splits = common.visit_splits(visits)
    partial = torch.empty(splits, common.N_PIX, device=data.device)
    out = torch.empty(common.TILE_H, common.TILE_W, device=data.device)
    common.launch("mxu_edge_fma", data.device, data.data_ptr(),
                  partial.data_ptr(), out.data_ptr(), visits, chunk, splits,
                  common.PIXEL_SCALE)
    LAUNCHES["fma"] += 1
    return out


def launch_tc(coeff, pix, visits, chunk, variant):
    """A tensor-core kernel (csrc/mxu_edge.cu) on CUDA coeff
    [visits*5C, 8] and pix [8, 2048]; fold_tc_torch's contract."""
    if variant not in ("tc_bf16", "tc_tf32x3"):
        raise ValueError(f"not a tensor-core variant: {variant!r}")
    common.check_operands(coeff.device, [
        ("coeff", coeff, (visits * 5 * chunk, 8)),
        ("pix", pix, (8, common.N_PIX))])
    splits = common.visit_splits(visits)
    partial = torch.empty(splits, common.N_PIX, device=coeff.device)
    out = torch.empty(1, common.N_PIX, device=coeff.device)
    common.launch("mxu_edge_tc", coeff.device, coeff.data_ptr(),
                  pix.data_ptr(), partial.data_ptr(), out.data_ptr(), visits,
                  chunk, splits, int(variant == "tc_bf16"))
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
    dev = common.resolve_device(device)
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
