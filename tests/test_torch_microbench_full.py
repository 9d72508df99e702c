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
"""

import json

import numpy as np
import pytest
import torch

from pytorch_mesh_renderer_tpu_torch.microbench import mxu_full as mf
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


def test_the_kernels_need_a_card():
    data, coeff = mf.make_inputs(4, 8, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        mf.launch_prod(data, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        mf.launch_tc(coeff, 4, 8)
