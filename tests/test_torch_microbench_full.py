"""PyTorch port of scripts/mxu_full_microbench.py (S2) vs the JAX script.

The script's `main` runs in this process in interpret mode at 64 visits
(its synthetic table covers no pixel at 4 visits and every pixel at 64);
the arrays it hands to `jax.block_until_ready` are recorded and held
against the port's plain versions on the same seeded numpy inputs:

  * prod vs the script's `prod` (the production chunk core on the same
    fp32 rows): ids equal, edge values within 1e-6 of max |value|, z within
    Z_TOL = 1e-5. XLA on the CPU contracts products into FMAs, which moves
    the last bits of the edge values (2.4e-7 seen) and, through num / den,
    of z (1.0e-6 seen);
  * tc vs the script's `mxu` (a HIGHEST dot, fp32 on the CPU): the port
    rounds to TF32 hi and lo parts, so its five values move by ~1e-7
    relative: held by the port's own gate, mxu_full.check_tc (z within
    Z_TOL = 1e-5 of the plain best, the edge values those of the pair the
    id names; an id may differ only where it names another valid pair
    within Z_TOL of the plain best z).

The tc kernel culls triangles per warp region of 2x16 pixels before its
products; `mxu_full.tc_keeps` is the plain model of that cull. It must be
conservative: every pair the plain version counts inside and valid
(`tc_pairs`) belongs to a triangle kept for its region, on the seed-0
table and on a knife-edge table whose edges pass through the regions'
corner pixel centres (`make_knife_edge_inputs`), where the same cull
without its margin drops pairs.
"""

import json

import numpy as np
import pytest
import torch

from pytorch_mesh_renderer_tpu_torch.microbench import common
from pytorch_mesh_renderer_tpu_torch.microbench import mxu_full as mf
from pytorch_mesh_renderer_tpu_torch.ops import rasterize_barycentric_cuda as rb
from test_torch_microbench_edge import run_script

VISITS = 64


def test_plain_versions_match_the_script(monkeypatch, capsys):
    recorded, printed = run_script(
        "mxu_full_microbench", ["--visits", str(VISITS), "--iters", "1",
                                "--interpret"], monkeypatch, capsys)
    script_prod, script_mxu = recorded[0], recorded[1]
    assert printed["covered_px"] > 0
    data, coeff = mf.make_inputs(VISITS, 8, "cpu")
    prod = mf.zbuffer_prod_torch(data)
    np.testing.assert_array_equal(prod[1].numpy(), script_prod[1])
    assert prod[0].shape == script_prod[0].shape == (16, 128)
    assert float(np.abs(prod[0].numpy() - script_prod[0]).max()) <= mf.Z_TOL
    for port, ref in zip(prod[2:], script_prod[2:]):
        err = float(np.abs(port.numpy() - ref).max())
        assert err <= 1e-6 * float(np.abs(ref).max())
    pairs = mf.tc_pairs(coeff, VISITS, 8)
    tc = mf.zbuffer_tc_torch(coeff, VISITS, 8)
    assert tc[0].shape == script_mxu[0].shape == (1, 2048)
    assert mf.check_tc(tc, pairs) == (0, 0.0, 0.0)
    mf.check_tc([torch.from_numpy(np.array(a)) for a in script_mxu], pairs)
    # The printed finding, from the script's own two kernels.
    assert printed["id_mismatch_px"] == int(
        (script_prod[1].reshape(-1) != script_mxu[1].reshape(-1)).sum())


def test_plain_winner_is_the_carry_merge_over_visits():
    """The plain versions pick the winner over all pairs at once; the
    script merges a carry visit by visit. Both give the smallest z, ties to
    the larger id: a loop over visits reproduces the plain result."""
    data, _ = mf.make_inputs(16, 8, "cpu")
    plain = mf.zbuffer_prod_torch(data)
    best_z = torch.full((16, 128), 2.0)
    best_id = torch.full((16, 128), -1, dtype=torch.int32)
    for v in range(16):
        z, ids, *_ = mf.zbuffer_prod_torch(data[8 * v:8 * (v + 1)])
        ids = torch.where(ids >= 0, ids + 8 * v, ids)
        better = (z < best_z) | ((z == best_z) & (ids > best_id))
        best_z = torch.where(better, z, best_z)
        best_id = torch.where(better, ids, best_id)
    assert torch.equal(plain[0], best_z) and torch.equal(plain[1], best_id)


def test_main_on_the_cpu_prints_the_script_keys(capsys):
    mf.main(["--device", "cpu", "--visits", str(VISITS), "--iters", "1"])
    printed = json.loads(capsys.readouterr().out)
    assert printed["covered_px"] > 0
    assert printed["id_mismatch_px"] == 0
    assert printed["max_abs_z_gap"] <= mf.Z_TOL
    assert printed["prod_us"] > 0.0 and printed["tc_us"] > 0.0
    assert printed["speedup"] > 0.0 and printed["device"] == "cpu"
    assert 0.0 < printed["tc_kept_fraction"] <= printed[
        "tc_group_fraction"] <= 1.0
    assert printed["tc_busiest_groups"] >= 1


def test_tc_gate_refuses_a_moved_winner():
    _, coeff = mf.make_inputs(VISITS, 8, "cpu")
    pairs = mf.tc_pairs(coeff, VISITS, 8)
    tc = mf.zbuffer_tc_torch(coeff, VISITS, 8)
    with pytest.raises(AssertionError, match="z gap"):
        mf.check_tc((tc[0] - 1e-3,) + tc[1:], pairs)


@pytest.mark.parametrize("fault", ["id offset", "pixel offset", "uncovered"])
def test_tc_gate_refuses_a_wrong_id_with_the_right_z(fault):
    """An id the plain version does not pick, z and edge values left as
    they are: a wrong id offset (the next triangle), the next pixel's id (a
    wrong store index), an empty pixel's -1. A reversed tie rule cannot be
    told apart here (an exact tie lies within Z_TOL): prod, which shares the
    kernels' `better`, is held to it bit for bit."""
    _, coeff = mf.make_inputs(VISITS, 8, "cpu")
    pairs = mf.tc_pairs(coeff, VISITS, 8)
    z, ids, *w = mf.zbuffer_tc_torch(coeff, VISITS, 8)
    covered = ids >= 0
    if fault == "id offset":
        ids = torch.where(covered, ids + 1, ids)
    elif fault == "pixel offset":
        ids = ids.roll(1, -1)
    else:
        ids = torch.where(covered, -1, ids)
    with pytest.raises(AssertionError, match="the id differs"):
        mf.check_tc((z, ids, *w), pairs)


def test_tc_gate_lets_a_winner_move_between_near_depths():
    """Two valid pairs whose depths lie within Z_TOL: either may win."""
    e = torch.tensor([[1.0, 0.5], [2.0, 1.0]])
    z = torch.tensor([[0.25, 0.5], [0.25 + 4e-6, 0.75]])
    pairs = (e, e + 1.0, e + 2.0, z, torch.ones(2, 2, dtype=torch.bool))
    plain = mf._winner(*pairs)
    assert plain[1].tolist() == [0, 0]
    moved = (torch.tensor([0.25 + 4e-6, 0.5]), torch.tensor([1, 0]),
             torch.tensor([2.0, 0.5]), torch.tensor([3.0, 1.5]),
             torch.tensor([4.0, 2.5]))
    assert mf.check_tc(moved, pairs) == (1, pytest.approx(4e-6, rel=1e-2), 0.0)
    far = (moved[0], torch.tensor([0, 1]), *moved[2:])
    with pytest.raises(AssertionError, match="the id differs"):
        mf.check_tc(far, pairs)


def test_pair_counts_box_the_covered_pixels():
    data, _ = mf.make_inputs(VISITS, 8, "cpu")
    boxed, inside = mf.pair_counts(data)
    assert inside <= boxed <= data.shape[0] * 2048
    # The right triangle with corners at the centres of pixels (10, 2),
    # (14, 2) and (10, 4) (column, row) covers 5 + 3 + 1 pixel centres in
    # a 5 x 3 box; a dead copy of it counts nothing.
    scale = 2.0 / 512
    x_lo, x_hi = (10 + 0.5) * scale - 1.0, (14 + 0.5) * scale - 1.0
    y_lo, y_hi = (2 + 0.5) * scale - 1.0, (4 + 0.5) * scale - 1.0
    dx, dy, pad = x_hi - x_lo, y_hi - y_lo, 1e-3
    row = torch.zeros(16)
    row[0:9] = torch.tensor([1.0, 0.0, pad * scale - x_lo,
                             0.0, 1.0, pad * scale - y_lo,
                             -1.0 / dx, -1.0 / dy,
                             1.0 + pad + x_lo / dx + y_lo / dy])
    row[12:15] = 1.0
    row[15] = 1.0
    dead = row.clone()
    dead[15] = 0.0
    boxed, inside = mf.pair_counts(torch.stack([row, dead]))
    assert (boxed, inside) == (3 * 5, 9)


def test_prod_launch_rule():
    """prod's launch: K3's rule (group 1, split 8 on an H100's 132 SMs at
    any resident-slot count of 2 to 8 a SM) picks each visit split's
    clusters, 8 x 8 CTAs, and the fewest visit splits that divide the
    visits and give every SM a CTA: 4 at the script's 512 visits (256 CTAs,
    1.9 a SM), 3 at 12; one where 64 CTAs cover the card; the largest
    divisor up to 32 where none does. `launch_rule` is the plain model of
    the launcher's rule, held against it on the card."""
    assert mf.prod_splits(512, 132) == 4
    assert mf.prod_splits(12, 132) == 3
    assert mf.prod_splits(512, 64) == 1
    assert mf.prod_splits(37, 132) == common.visit_splits(37) == 1
    assert mf.prod_splits(2, 132) == common.visit_splits(2) == 2
    for visits, splits in ((512, 4), (12, 3), (37, 1)):
        rows = visits // splits * 8
        for per_sm in (2, 4, 8):
            assert rb.launch_rule(splits, rows, common.TILE_W,
                                  common.TILE_H, 132, 132 * per_sm) == (1, 8)
    # K3's rule elsewhere, at 4 slots a SM: one teapot image at 256^2
    # (group 1, split 8) and four (split 2: 1,024 clusters); sphere72 at
    # 512^2 (group 2); a grid too deep for split 8 or 4.
    assert rb.launch_rule(1, 2464, 256, 256, 132, 528) == (1, 8)
    assert rb.launch_rule(4, 2464, 256, 256, 132, 528) == (1, 2)
    assert rb.launch_rule(1, 10368, 512, 512, 132, 528) == (2, 8)
    assert rb.launch_rule(20000, 1, 16, 16, 132, 10 ** 6) == (1, 2)


def test_depth_tie_table_ties_across_visits():
    """make_depth_tie_inputs: every pixel's winner is a copy of a base
    triangle that is not its first, most are its last copy, and some win at
    z = 0 (ties of +0.0 and -0.0)."""
    data, _, visits, chunk = mf.make_depth_tie_inputs("cpu")
    z, ids, *_ = mf.zbuffer_prod_torch(data)
    won = ids[ids >= 0].long()
    assert won.numel() > 1000
    assert bool((won >= 61).all())
    last = (won % 61) + 61 * ((visits * chunk - 1 - won % 61) // 61)
    assert float((won == last).float().mean()) > 0.5
    assert int((z == 0.0).sum()) > 0


def test_the_kernels_need_a_card():
    data, coeff = mf.make_inputs(4, 8, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        mf.launch_prod(data, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        mf.launch_tc(coeff, 4, 8)


def _inputs(table):
    """(coeff, visits, chunk) of the seed-0 or the knife-edge table."""
    if table == "seed 0":
        return mf.make_inputs(VISITS, 8, "cpu")[1], VISITS, 8
    return mf.make_knife_edge_inputs("cpu")[1:]


def _dropped_inside_pairs(coeff, visits, chunk):
    """Pairs valid in the plain version whose triangle tc_keeps drops for
    the pixel's region, and the valid pairs."""
    valid = mf.tc_pairs(coeff, visits, chunk)[4]  # [T, 2048]
    keeps = mf.tc_keeps(coeff, visits, chunk)  # [8, 8, T]
    per_pixel = keeps.repeat_interleave(mf.REGION_H, 0).repeat_interleave(
        mf.REGION_W, 1).reshape(-1, keeps.shape[-1]).T
    return int((valid & ~per_pixel).sum()), int(valid.sum())


@pytest.mark.parametrize("table", ["seed 0", "knife edge"])
def test_tc_cull_keeps_every_inside_pair(table):
    coeff, visits, chunk = _inputs(table)
    dropped, valid = _dropped_inside_pairs(coeff, visits, chunk)
    assert valid > 0 and dropped == 0
    counts = mf.tc_cull_counts(coeff, visits, chunk)
    assert counts["pairs"] == visits * chunk * 2048
    assert valid <= counts["kept_pairs"] <= counts["group_pairs"] <= counts[
        "pairs"]
    assert counts["kept_fraction"] == counts["kept_pairs"] / counts["pairs"]
    # The cull drops most pairs: a triangle is kept for few regions.
    assert counts["kept_fraction"] < 0.5


def test_knife_edge_table_defeats_a_cull_without_margin(monkeypatch):
    coeff, visits, chunk = _inputs("knife edge")
    monkeypatch.setattr(mf, "CULL_MARGIN", 0.0)
    dropped, _ = _dropped_inside_pairs(coeff, visits, chunk)
    assert dropped > 0


def test_knife_edge_table_holds_both_plain_versions():
    data, coeff, visits, chunk = mf.make_knife_edge_inputs("cpu")
    assert coeff.shape == (visits * 5 * chunk, 8)
    prod = mf.zbuffer_prod_torch(data)
    assert bool((prod[1] >= 0).all())  # every pixel covered
    pairs = mf.tc_pairs(coeff, visits, chunk)
    assert mf.check_tc(mf.zbuffer_tc_torch(coeff, visits, chunk),
                       pairs) == (0, 0.0, 0.0)


def test_tc_groups_round_each_region_and_stage_up_to_8():
    # 37 visits of 8: one split of 296 triangles, staged as 128, 128 and 40.
    # Triangles 0-8, 128 and 256 have every edge +1 (kept everywhere); the
    # others have an edge of -1 (dropped everywhere). Per region: 9 kept in
    # stage 0 -> 2 groups, 1 in each later stage -> 1 group each.
    visits, chunk = 37, 8
    coeff = torch.zeros(visits, 5, chunk, 8)
    coeff[:, :3, :, 2] = 1.0
    kept = [*range(9), 128, 256]
    dropped = torch.ones(visits * chunk, dtype=torch.bool)
    dropped[kept] = False
    coeff[:, 0, :, 2][dropped.view(visits, chunk)] = -1.0  # edge e0's c
    coeff = coeff.reshape(-1, 8)
    keeps = mf.tc_keeps(coeff, visits, chunk)  # [8, 8, 296]
    assert keeps.nonzero()[:, 2].unique().tolist() == kept
    region_px = mf.REGION_H * mf.REGION_W
    counts = mf.tc_cull_counts(coeff, visits, chunk)
    assert counts["kept_pairs"] == 64 * 11 * region_px
    assert counts["group_pairs"] == 64 * 4 * 8 * region_px
    assert counts["busiest_groups"] == 2