"""PyTorch port of scripts/mxu_edge_microbench.py (S1) vs the JAX script.

The script's `main` runs in this process in interpret mode at 4 visits;
the arrays it hands to `jax.block_until_ready` are recorded and held
against the port's plain versions on the same seeded numpy inputs:

  * fma vs the script's `vpu`: the same fp32 functions folded in another
    order, within 1e-6 of max |value|;
  * tc_tf32x3 vs `mxu_bf16x6`: the script's HIGHEST dot is fp32 on the
    CPU, the port's 3xTF32 drops lo*lo (2^-22 relative per product): within
    1e-6 of max |value|;
  * tc_bf16 vs `mxu_bf16`: the script's DEFAULT dot is fp32 on the CPU too,
    the port rounds the operands to bf16 (8 mantissa bits): within 1e-2 of
    max |value|.

The fma plain version is also held bit for bit against a numpy loop in the
kernel's order, which is what makes the kernel equal to it on the card.
"""

import importlib.util
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from pytorch_mesh_renderer_tpu_torch.microbench import common
from pytorch_mesh_renderer_tpu_torch.microbench import mxu_edge as me

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_script(name, argv, monkeypatch, capsys):
    """Run scripts/<name>.py's main with argv; returns (the arrays passed to
    jax.block_until_ready in call order, as numpy trees; the JSON line it
    printed)."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO_ROOT, "scripts", name + ".py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    recorded = []
    block = jax.block_until_ready

    def record(tree):
        tree = block(tree)
        recorded.append(jax.tree_util.tree_map(np.asarray, tree))
        return tree

    monkeypatch.setattr(jax, "block_until_ready", record)
    monkeypatch.setattr(sys, "argv", [name] + argv)
    capsys.readouterr()
    script.main()
    return recorded, json.loads(capsys.readouterr().out.splitlines()[-1])


def _relative(port, ref):
    ref = np.asarray(ref).reshape(-1)
    return (float(np.abs(port.numpy().reshape(-1) - ref).max())
            / float(np.abs(ref).max()))


def test_plain_versions_match_the_script(monkeypatch, capsys):
    recorded, printed = run_script(
        "mxu_edge_microbench", ["--visits", "4", "--iters", "1",
                                "--interpret"], monkeypatch, capsys)
    # Per variant: the checked call, then the timed calls' last result.
    vpu, bf16, bf16x6 = recorded[0], recorded[2], recorded[4]
    assert printed["visits"] == 4 and printed["chunk"] == 8
    data, coeff, pix = me.make_inputs(4, 8, "cpu")
    fma = me.fold_fma_torch(data, 4, 8)
    assert fma.shape == vpu.shape == (16, 128)
    assert _relative(fma, vpu) <= 1e-6
    tf32x3 = me.fold_tc_torch(coeff, pix, "tc_tf32x3")
    assert tf32x3.shape == bf16x6.shape == (1, 2048)
    assert _relative(tf32x3, bf16x6) <= 1e-6
    port_bf16 = me.fold_tc_torch(coeff, pix, "tc_bf16")
    assert 1e-5 < _relative(port_bf16, bf16) <= 1e-2


def _fold_fma_loop(data, visits, chunk):
    """The fma kernel's order in a numpy loop: per split, per visit, per
    triangle; each value computed as the kernel computes it."""
    px, py = (t.numpy() for t in common.tile_pixel_coords("cpu"))
    rows = data.numpy().reshape(visits, chunk, 16)
    splits = me.edge_splits(visits)
    out = np.zeros(common.N_PIX, np.float32)
    for j in range(splits):
        acc = np.zeros(common.N_PIX, np.float32)
        for v in range(j * visits // splits, (j + 1) * visits // splits):
            for c in range(chunk):
                r = rows[v, c]
                e0 = r[0] * px + r[1] * py + r[2]
                e1 = r[3] * px + r[4] * py + r[5]
                e2 = r[6] * px + r[7] * py + r[8]
                num = e0 * r[9] + e1 * r[10] + e2 * r[11]
                den = e0 * r[12] + e1 * r[13] + e2 * r[14]
                term = e0 + e1 + e2 + num + den
                visit_sum = term if c == 0 else visit_sum + term
            acc = acc + visit_sum
        out = out + acc
    return out.reshape(common.TILE_H, common.TILE_W)


# (135, 2): splits of 2 and 3 visits; (45, 1): one visit a split.
@pytest.mark.parametrize("visits,chunk", [(64, 8), (7, 3), (135, 2), (45, 1)])
def test_fma_plain_version_sums_in_the_kernel_order(visits, chunk):
    data, _, _ = me.make_inputs(visits, chunk, "cpu")
    plain = me.fold_fma_torch(data, visits, chunk).numpy()
    np.testing.assert_array_equal(plain, _fold_fma_loop(data, visits, chunk))


def test_tf32_rounding_is_round_to_nearest_away():
    one = 1.0
    ulp = 2.0 ** -10  # TF32's spacing at 1
    x = torch.tensor([one + ulp / 2, one + ulp / 4, -(one + ulp / 2),
                      one + 3 * ulp / 4, 0.0, -0.0], dtype=torch.float32)
    want = [one + ulp, one, -(one + ulp), one + ulp, 0.0, -0.0]
    assert common.tf32_round(x).tolist() == want
    v = torch.from_numpy(np.random.default_rng(1).standard_normal(
        1000).astype(np.float32))
    hi, lo = common.tf32_split(v)
    assert bool((common.tf32_round(hi) == hi).all())
    assert bool(((hi + lo - v).abs() <= 2.0 ** -21 * v.abs()).all())


def test_edge_launch_rule():
    """The kernels' decomposition: one split of the visits a warp, up to
    64; a cluster of ceil(splits / 4) CTAs per 64-pixel group (16 at the
    script's 512 visits: 32 x 16 = 512 CTAs, at least two on each of an
    H100's 132 SMs); 2 pixels a lane (fma) and 8 n8 tiles a warp (tc)."""
    assert (me.WARPS, me.GROUP_PIX, me.PIX_PER_LANE, me.TILES) == (4, 64, 2,
                                                                   8)
    assert [me.edge_splits(v) for v in (1, 7, 45, 64, 135, 512)] == [
        1, 7, 45, 64, 64, 64]
    assert [me.edge_cluster(s) for s in (1, 4, 5, 45, 64)] == [1, 1, 2, 12,
                                                                16]
    assert common.N_PIX // me.GROUP_PIX * me.edge_cluster(
        me.edge_splits(512)) >= 2 * 132
    for visits in (1, 7, 45, 64, 135, 512):
        bounds = me.split_visits(visits)
        assert len(bounds) == me.edge_splits(visits)
        assert bounds[0][0] == 0 and bounds[-1][1] == visits
        assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
        sizes = [e - f for f, e in bounds]
        assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    with pytest.raises(ValueError, match="visits"):
        me.edge_splits(0)


def test_tc_pixel_operands_are_tf32_exact():
    """The pixel matrix's TF32 lo part is zero (centres on a 2^-9 grid in
    [-1, 1], and 1), so 3xTF32's hi*lo product, which tc_tf32x3 drops, is
    exactly zero."""
    pix = me.make_inputs(4, 8, "cpu")[2]
    hi, lo = common.tf32_split(pix)
    assert torch.equal(hi, pix) and not bool(lo.any())


def test_visit_splits():
    assert common.visit_splits(512) == 32
    assert common.visit_splits(64) == 32
    assert common.visit_splits(12) == 12
    assert common.visit_splits(7) == 7
    assert common.visit_splits(37) == 1


def test_main_on_the_cpu_prints_the_script_keys(capsys):
    me.main(["--device", "cpu", "--visits", "4", "--iters", "1"])
    printed = json.loads(capsys.readouterr().out)
    for name in me.VARIANTS:
        assert printed[name + "_us"] > 0.0
    assert printed["tc_tf32x3_relerr"] <= 1e-6
    assert printed["tc_bf16_relerr"] <= 1e-2
    assert {"tc_bf16_speedup", "tc_tf32x3_speedup"} <= printed.keys()
    assert printed["device"] == "cpu"


def test_the_kernels_need_a_card():
    data, coeff, pix = me.make_inputs(4, 8, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        me.launch_fma(data, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        me.launch_tc(coeff, pix, 4, 8, "tc_tf32x3")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            me.run(4, 8, 1, "cuda")
