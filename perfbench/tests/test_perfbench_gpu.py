"""One short run of each cell on the card, through the benchmark's command:
`python -m pytest perfbench/tests/test_perfbench_gpu.py -m gpu -q`. Skips
without a CUDA device (decided inside the test)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from perfbench import harness

CELLS = [w["name"] for w in json.loads((harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_is_correct(workload, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "-m", "perfbench", "--workload", workload, "--seed",
                          "2147483999", "--seconds", "5", "--trace", str(trace)],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], out.stderr[-4000:]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
