"""A run of a cell on the card: the result line and its metrics (skips without one)."""
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_a_knapsack_cell_runs_on_the_card(trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "mknap.t25.dual", "--seed", "987654321",
         "--seconds", "2", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
    from portbench import spec

    kind = "per_layer" if trace else "end_to_end"
    assert set(r["metrics"]) == {m["name"] for m in spec.metrics_of(spec.benchmark(), "mknap.t25.dual", kind)}
