"""PyTorch port: `utils/soft_work.pair_counts`, the count of where the soft
backward kernel K8's work falls, on a hand-built table whose counts are
worked out by hand.

A 32x32 image is 2x2 pixel blocks of 16x16, each 8 warps of 16x2 pixels.
Two triangles, in pixel units (x right, y down; pixel (c, r) has its centre
at (c + 0.5, r + 0.5)), with a blur of 1e-4 that reaches no further pixel:

  * A: (16.3, 0.3), (16.3, 8.3), (24.3, 0.3). Its pixels have c >= 16,
    r >= 0 and c + r <= 23.6: rows 0-7 of block (x 1, y 0), so warps 0-3.
  * B: (20.3, 4.3), (20.3, 28.3), (28.3, 4.3). Its pixels have c >= 20,
    r >= 4 and 3c + r <= 87.2: rows 4-27, so warps 2-7 of block (1, 0)
    and warps 0-5 of block (1, 1).

Every pixel centre lies at least 0.06 pixel (0.004 in NDC) from an edge,
so f32 rounding decides none of them.
"""

import numpy as np
import torch

from pytorch_mesh_renderer_tpu_torch.ops import soft_rasterize_cuda as sc
from pytorch_mesh_renderer_tpu_torch.utils import soft_work

SIZE = 32
BLUR = 1e-4


def _table():
    pixels = np.float32([[16.3, 0.3], [16.3, 8.3], [24.3, 0.3],
                         [20.3, 4.3], [20.3, 28.3], [28.3, 4.3]])
    ndc = np.stack([2.0 * pixels[:, 0] / SIZE - 1.0,
                    1.0 - 2.0 * pixels[:, 1] / SIZE], axis=1)
    clip = np.concatenate([ndc, np.zeros([6, 1]), np.ones([6, 1])], axis=1)
    clip = torch.tensor(clip[None], dtype=torch.float32)
    zeros = torch.zeros(1, 6, 3)
    tris = torch.tensor([[0, 1, 2], [3, 4, 5]], dtype=torch.int32)
    return sc.pack_triangle_data(clip, tris, zeros, zeros, zeros, BLUR)


def test_pair_counts_on_a_hand_built_table():
    table = _table()
    assert table[0, :, 21].tolist() == [1.0, 1.0]  # both kept (CCW)
    sq_blur = float(np.float32(BLUR) ** 2)
    counts = soft_work.pair_counts(table, SIZE, SIZE, sq_blur, split=2)
    assert counts == {
        "blocks": 4,
        "busy_blocks": 2,  # (1, 0) and (1, 1)
        "staged": 3,  # A in (1, 0); B in (1, 0) and (1, 1)
        "block_items": 3,
        "busy_warps": 14,  # warps 0-7 of (1, 0), 0-5 of (1, 1)
        "warp_items": 16,  # A 4, B 6 + 6
        "staging_ctas": 3,  # (1, 0) parts 0 (A) and 1 (B); (1, 1) part 1
        "busiest_block": 2,
        "busiest_warp": 2,  # warps 2 and 3 of (1, 0) run A and B
        "busiest_split_warp": 1,
    }
    one_cta = soft_work.pair_counts(table, SIZE, SIZE, sq_blur, split=1)
    assert one_cta["staging_ctas"] == 2
    assert one_cta["busiest_split_warp"] == 1  # 2 rows over 8 warps
    # A alone: its block and its four warps.
    alone = soft_work.pair_counts(table[:, :1], SIZE, SIZE, sq_blur)
    assert (alone["busy_blocks"], alone["warp_items"],
            alone["busy_warps"]) == (1, 4, 4)
