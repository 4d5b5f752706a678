"""One short run of a cell on the card, through the command the checks run
(needs a CUDA device; skips without one)."""

import json
import subprocess
import sys

import pytest

from benchmark.tests.tinyroot import REPO


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_on_the_card(trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "bistro-proxy-1080p.static", "--seed", str(2**33 + 1),
         "--seconds", "3", "--trace", str(trace)], cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["failed"] == 0, result["check"]
    assert list(result)[-1] == "check"
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    else:
        assert set(result["metrics"]) == {"frame_ms", "frame_p95_ms", "setup_s"}


def test_run_without_the_cells_cards_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "bistro-proxy-1080p.static", "--seed", "1",
         "--seconds", "1", "--trace", "0"], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
