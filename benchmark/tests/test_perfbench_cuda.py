"""Each cell for a few seconds on the card, through the command the
benchmark is run by. Skips without a CUDA device (decided inside the test).

    python3 -m pytest benchmark/tests/test_perfbench_cuda.py -m cuda
"""

import json
import subprocess
import sys

import pytest
import torch

from benchmark.tests.tiny import ROOT

CELLS = [c["name"] for c in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_on_the_card(cell, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                          str(2 ** 31 + 4242), "--seconds", "4", "--trace", str(trace)],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert line["attempted"] > 0 and line["failed"] == 0
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert line["breakdown"]["device_ops"]
    else:
        assert "setup_s" in line["metrics"]
