"""The port's measurement entry points against the JAX package's: the
benchmark suite's rows, bench_torch.py's one JSON line, and the timing and
device helpers of ``utils``."""

import json
import math

import pytest
import torch

import bench_torch
from benchmarks import suite as jax_suite
from real_time_path_tracing_with_spatiotemporal_filtering_torch.benchmarks import (
    mosaic_micro,
    suite,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.utils import device as dev_mod
from real_time_path_tracing_with_spatiotemporal_filtering_torch.utils.profiling import (
    FrameTimer,
    time_fn,
)

torch.set_num_threads(1)

BENCH_KEYS = {"metric", "value", "unit", "vs_baseline"}  # bench.py's line


def test_suite_rows_are_the_jax_rows():
    """The same rows under the same names, quick or not; building the
    entries runs none of them."""
    for quick in (False, True):
        want = [name for name, _ in jax_suite.suite_entries(quick)]
        got = [name for name, _ in suite.suite_entries(quick, device="cpu")]
        assert got == want
    assert len(want) == 13 and len(jax_suite.suite_entries(False)) == 17
    with pytest.raises(ValueError, match="card"):
        suite.suite_entries(True, device="cpu", device_time=True)


def test_bench_torch_prints_one_json_line(capsys):
    bench_torch.main(["--device", "cpu", "--width", "48", "--height", "32", "--frames", "2",
                      "--warmup", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == BENCH_KEYS and line["unit"] == "ms/frame"
    assert line["value"] > 0 and "48x32" in line["metric"] and line["metric"].endswith("cpu")
    assert math.isclose(line["vs_baseline"], round(16.7 / line["value"], 4), rel_tol=1e-3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            bench_torch.run_bench(48, 32, 1, 0)


def test_time_fn_timer_and_device_info(capsys):
    """As tests/test_input_and_utils.py and tests/test_extensions.py check
    the JAX package's time_fn, FrameTimer and device_info; and the
    micro-benchmark's command line on the CPU, timed through time_fn."""
    ms = time_fn(lambda x: x * 2.0, torch.ones(128), iters=3, warmup=1)
    assert ms >= 0.0
    assert time_fn(lambda x: x * 2.0, torch.ones(128), iters=2, pipelined=False) >= 0.0
    mosaic_micro.main(["--device", "cpu", "--which", "cond,dynwin", "--iters", "64"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "# device: cpu" and [ln.split()[0] for ln in lines[1:]] == ["cond", "dynwin"]
    assert all("ns/iter" in ln for ln in lines[1:])
    timer = FrameTimer(window=4)
    timer.tick()
    timer.tick()
    assert timer.ms_per_frame >= 0.0
    assert timer.fps > 0.0
    info = dev_mod.device_info(device="cpu")
    assert info["num_devices"] >= 1
    assert info["backend"] in ("cpu", "cuda")
    assert info["geometry_table_cap"] > 200 and info["trace_table_cap"] > 200
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            dev_mod.device_info()
