"""The port's denoising-quality benchmark (benchmarks/quality.py): one run
against the JAX package's on the CPU, and the six quality bars of
tests/test_quality.py on the card.

The file imports neither JAX nor the JAX package at module level (the JAX
benchmark imports them when it runs), so the bars run where JAX is not
installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_quality.py
"""

import json

import pytest
import torch

from benchmarks import quality as jax_quality
from real_time_path_tracing_with_spatiotemporal_filtering_torch.benchmarks import quality

torch.set_num_threads(1)


def test_quality_run_matches_jax(capsys):
    """48x32, a 4-spp truth, 3 frames, 8 bounces: both rMSE values agree;
    the command line prints the JAX benchmark's JSON line."""
    kw = dict(width=48, height=32, max_bounces=8)
    want = jax_quality.run(48, 4, 3, **kw)
    got = quality.run(48, 4, 3, device="cpu", **kw)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-4), k
    quality.main(["--device", "cpu", "--size", "16", "--spp", "2", "--frames", "2",
                  "--max-bounces", "4", "--skip-variance"])
    line = json.loads(capsys.readouterr().out)
    assert set(line) == {"metric", "value", "unit", "noisy_1spp_rmse", "improvement_factor"}
    assert line["metric"].endswith("16x16 Cornell (clamped [0,1]), reference parity (mb4)")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            quality.run(48, 4, 3, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("bar", quality.BARS, ids=[b.name for b in quality.BARS])
def test_quality_bar(bar):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the bars run on the card's kernels)")
    got = quality.run_bar(bar, "cuda")
    assert got["rmse_denoised"] <= bar.max_rmse, f"denoised rMSE regressed: {got}"
    assert got["improvement"] >= bar.min_improvement, f"improvement regressed: {got}"
