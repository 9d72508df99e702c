"""Each cell end to end on the card, as the check runs it: one short run of
benchmark/run.py a cell, its last line the result, correct. Skips without
a card (decided inside the test); on the card host:

    python -m pytest -m cuda benchmark/tests/test_bench_card.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import env

CELLS = [w["name"] for w in env.benchmark_file()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; the benchmark runs there only")
    out = subprocess.run(
        [sys.executable, os.path.join("benchmark", "run.py"), "--workload",
         name, "--seed", "2147483649", "--seconds", "2", "--trace", "1"],
        cwd=env.ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], out.stderr[-4000:]
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["busy_s"] > 0
    assert out.stderr.strip().splitlines()[-1] == "correct: true"


def test_without_a_card_the_run_prints_no_result():
    """No card: exit code 2 and nothing on standard output."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, os.path.join("benchmark", "run.py"), "--workload",
         CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=env.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 2
    assert out.stdout == ""
