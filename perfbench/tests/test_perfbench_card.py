"""A 2-second cell on the card, through the benchmark's own command."""

import json
import subprocess
import sys

import pytest

from perfbench import registry


@pytest.mark.cuda
def test_two_second_cell_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          "cornell_box.interactive_orbit", "--seed", str(2**31 + 11),
                          "--seconds", "2", "--trace", "0"], cwd=registry.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {"frame_ms", "frame_p95_ms", "setup_s"}
