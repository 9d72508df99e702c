"""The flagship fit's spread on the card, through the kernels and through
the plain route.

The kernels' silhouette gradient sums in a fixed order (K6 and its reduce
pass, `ops/mesh.py`'s vertex scatters), so two runs of one fit command
should end bit for bit equal; before that repair, float atomics changed a
gradient's last bits from run to run and Adam carried them apart. This
runs docs/flagship/README.md's command (`examples.fit_shape_multiview.
main`, in process) `--kernel-runs` times through the kernels (K5, K6) and
`--plain-runs` times through the plain route
(`SoftRasterizerConfig(backend="torch")`, the reference the kernels are
held to), prints each run's loss terms and IoU at epochs 99, 999 and 1999
beside docs/flagship/trajectory.log's, then for each route its range at
epoch 1999 and how many distinct end states its runs reached (vertices
and losses bit for bit): one, for a route that repeats. The TPU's log is
one run of a third.

Before the runs it takes the silhouette loss's gradient through the
kernels and through the plain route at points on the segment from the
fit's start to the first kernel run's end, each twice, and prints the
kernel-minus-plain difference (of max |plain|) beside each route's own
run-to-run difference, and that difference's projection on the plain
gradient and the norms' ratio: a systematic bias would show in these.

    python -m pytorch_mesh_renderer_tpu_torch.utils.fit_spread \
        [--kernel-runs 10] [--plain-runs 3]

One card. A plain run takes minutes (it evaluates every pixel against
every triangle in dense steps), a kernel run seconds.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import re
import tempfile
import time

import numpy as np
import torch

from .. import config as config_lib
from ..examples import fit_shape_multiview
from ..microbench import common

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TRAJECTORY_LOG = os.path.join(_REPO, "docs", "flagship", "trajectory.log")
FLAGSHIP_ARGS = ["--epochs", "2000", "--size", "128", "--resolution", "24",
                 "--scan-chunk", "100", "--preview-every", "100"]
EPOCHS = (99, 999, 1999)
SEGMENT_POINTS = (0.0, 0.25, 0.5, 1.0)
_LINE = re.compile(r"epoch (\d+): loss ([\d.]+) \(sil ([\d.]+) edge ([\d.]+) "
                   r"lap ([\d.]+)\) IoU ([\d.]+)")


def reference_lines(path=TRAJECTORY_LOG):
    """{epoch: {loss, sil, edge, lap, iou}} of the log's preview lines."""
    lines = {}
    with open(path) as f:
        for match in _LINE.finditer(f.read()):
            values = [float(v) for v in match.groups()[1:]]
            lines[int(match.group(1))] = dict(
                zip(("loss", "sil", "edge", "lap", "iou"), values))
    return lines


def describe(preview):
    return (f"loss {preview['loss']:.5f} (sil {preview['sil']:.5f} edge "
            f"{preview['edge']:.5f} lap {preview['lap']:.5f}) IoU "
            f"{preview['iou']:.4f}")


def fit(out_dir, label, config=None):
    """(main's result, seconds) of one run of the flagship command; its
    own output (previews, OBJs) goes to `out_dir`."""
    argv = FLAGSHIP_ARGS + ["--out-prefix", os.path.join(out_dir, label)]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        result = fit_shape_multiview.main(argv, config=config)
    torch.cuda.synchronize()
    return result, time.perf_counter() - t0


def gradient_report(device, plain, end_vertices):
    """The silhouette gradient through the kernels vs the plain route at
    SEGMENT_POINTS of the segment from the start to `end_vertices`."""
    args = fit_shape_multiview.parse_args(FLAGSHIP_ARGS)
    by_kernel = fit_shape_multiview.Problem(args, device)
    by_plain = fit_shape_multiview.Problem(args, device, plain)
    end = torch.from_numpy(end_vertices).to(device) - by_kernel.verts0

    def gradient(problem, offsets):
        leaf = offsets.clone().requires_grad_(True)
        sil, _, _ = problem.loss_terms(leaf, problem.targets)
        return torch.autograd.grad(sil, leaf)[0]

    for point in SEGMENT_POINTS:
        offsets = end * point
        k1, k2 = gradient(by_kernel, offsets), gradient(by_kernel, offsets)
        p1, p2 = gradient(by_plain, offsets), gradient(by_plain, offsets)
        scale = float(p1.abs().max())
        diff = k1 - p1
        print(f"gradient at {point} of the segment: kernels vs plain "
              f"{float(diff.abs().max()) / scale:.3g} of max |plain|; "
              f"kernels vs kernels {float((k1 - k2).abs().max()) / scale:.3g}"
              f", plain vs plain {float((p1 - p2).abs().max()) / scale:.3g}; "
              f"difference along the plain gradient "
              f"{float((diff * p1).sum() / (p1 * p1).sum()):.3g}, "
              f"|kernels| / |plain| - 1 "
              f"{float(k1.norm() / p1.norm()) - 1.0:.3g}", flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--kernel-runs", type=int, default=10)
    parser.add_argument("--plain-runs", type=int, default=3)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("fit_spread needs an NVIDIA GPU")
    device = torch.device("cuda", 0)
    plain = config_lib.SoftRasterizerConfig(backend="torch")
    reference = reference_lines()
    print(common.card_line(), flush=True)
    print("trajectory.log: " + "; ".join(
        f"epoch {e} {describe(reference[e])}" for e in EPOCHS), flush=True)

    ends = {"kernels": [], "plain": []}
    states = {"kernels": set(), "plain": set()}  # distinct end states
    with tempfile.TemporaryDirectory() as out_dir:
        runs = ([("kernels", None)] * args.kernel_runs
                + [("plain", plain)] * args.plain_runs)
        for i, (route, config) in enumerate(runs):
            result, seconds = fit(out_dir, f"run{i}", config)
            lines = {p["epoch"]: p for p in result["previews"]}
            ends[route].append(lines[EPOCHS[-1]])
            states[route].add((result["vertices"].tobytes(),
                               tuple(result["losses"])))
            print(f"{route} run {len(ends[route])} ({seconds:.2f} s): "
                  + "; ".join(f"epoch {e} {describe(lines[e])}"
                              for e in EPOCHS), flush=True)
            if i == 0 and route == "kernels":
                gradient_report(device, plain, result["vertices"])
    want = reference[EPOCHS[-1]]
    for route, finals in ends.items():
        if not finals:
            continue
        losses = np.array([p["loss"] for p in finals])
        ious = np.array([p["iou"] for p in finals])
        print(f"{route}, {len(finals)} runs, epoch {EPOCHS[-1]}: loss "
              f"{losses.min():.5f} to {losses.max():.5f} "
              f"({(losses.min() - want['loss']) / want['loss']:+.4f} to "
              f"{(losses.max() - want['loss']) / want['loss']:+.4f} of the "
              f"log's {want['loss']}), IoU {ious.min():.4f} to "
              f"{ious.max():.4f} (log {want['iou']}); "
              f"{len(states[route])} distinct end state(s) bit for bit",
              flush=True)


if __name__ == "__main__":
    main()
